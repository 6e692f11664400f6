"""chip_smoke.py's phase selector: `--only NAME[,NAME...]` names phases
of ONLY, each with libraries the build knows; anything else is refused
before the card is asked for, and without a card the script exits
non-zero and prints no result."""

import importlib.util
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
                                  ["--only", "election,segment"]])
def test_without_a_card_it_prints_no_result(argv, capsys):
    assert _chip_smoke().main(argv) == 2
    assert capsys.readouterr().out == ""


def test_only_phases_build_known_libraries():
    only = _chip_smoke().ONLY
    assert set(only) == {"segment", "election"}
    for libs, fn in only.values():
        assert libs and callable(fn)
        for lib in libs:
            assert lib in _build.SIGNATURES or lib in _build.VARIANTS
