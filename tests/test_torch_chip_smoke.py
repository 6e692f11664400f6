"""chip_smoke.py's phase selector: `--only NAME[,NAME...]` names phases
of ONLY, each with libraries the build knows; anything else is refused
before the card is asked for, and without a card the script exits
non-zero and prints no result."""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [["--only"], ["--only", "bogus"],
                                  ["--only", "segment,bogus"],
                                  ["--phases", "segment"],
                                  ["--only", "segment", "election"]])
def test_only_refuses_other_arguments(argv, capsys):
    assert _chip_smoke().main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "usage" in out.err


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the script would run on it")
@pytest.mark.parametrize("argv", [[], ["--only", "segment"],
                                  ["--only", "election,segment"],
                                  ["--only", "mesh"], ["--only", "cluster"],
                                  ["--only", "mesh,cluster"],
                                  ["--only", "service_cluster"]])
def test_without_a_card_it_prints_no_result(argv, capsys):
    assert _chip_smoke().main(argv) == 2
    assert capsys.readouterr().out == ""


def test_only_phases_build_known_libraries():
    only = _chip_smoke().ONLY
    assert set(only) == {"segment", "election", "mesh", "cluster",
                         "service_cluster"}
    for libs, fn in only.values():
        assert libs and callable(fn)
        for lib in libs:
            assert lib in _build.SIGNATURES or lib in _build.VARIANTS


@pytest.mark.parametrize("argv", [["--only", "mesh,bogus"],
                                  ["--only", "cluster", "mesh"]])
def test_only_refuses_other_arguments_beside_the_new_names(argv, capsys):
    assert _chip_smoke().main(argv) == 2
    out = capsys.readouterr()
    assert out.out == "" and "usage" in out.err and "mesh" in out.err


def test_mesh_phases_build_b10():
    only = _chip_smoke().ONLY
    for name in ("mesh", "cluster"):
        libs, _ = only[name]
        assert set(libs) == {"dense_scan", "mask_scan", "sort_scan",
                             "verdict_counts", "dense_scan_count",
                             "mask_scan_count"}


def test_kernels_line_lists_verdict_counts():
    mod = _chip_smoke()
    source, replaces = mod.KERNELS["verdict_counts"]
    assert source == ("jepsen_jgroups_raft_tpu_torch/ops/csrc/"
                      "verdict_counts.cu")
    assert (ROOT / source).is_file()
    assert replaces == "jepsen_jgroups_raft_tpu/parallel/mesh.py:141"
    assert "sharded_batch_checker" in (ROOT / replaces.split(":")[0]) \
        .read_text().splitlines()[140]
    for name, (src, _) in mod.KERNELS.items():
        assert mod.KERNEL_LIBRARY.get(name, name) in _build.SIGNATURES
        assert (ROOT / src).is_file()
    assert 0 in mod.VERDICT_SIZES and (1 << 20) in mod.VERDICT_SIZES


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is present: the checks would pass on it")
def test_kernel_checks_failure_fails_the_run(tmp_path, monkeypatch):
    """The kernels' checks against their plain versions run in a second
    process; when they fail (here: no card), `finish_kernel_checks`
    raises with the process's traceback, and the process has ended."""
    mod = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", mod)
    monkeypatch.syspath_prepend(str(ROOT))
    proc, recv, out = mod.start_kernel_checks(str(tmp_path))
    try:
        with pytest.raises(AssertionError, match=r"(?s)plain versions "
                           r"failed.*in phase_kernel"):
            mod.finish_kernel_checks(proc, recv, out)
    finally:
        if proc.is_alive():
            proc.terminate()
        proc.join()
    assert proc.exitcode not in (0, None)
