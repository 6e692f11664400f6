"""The port's re-check of recorded runs against the reference's.

Stores of every `WORKLOAD_MODELS` workload are written with the port's
generators (`history/synth.py`, through the port's `core/store.save_test`)
and re-checked by both packages' `check_recorded`: the summaries must be
equal key for key but for the two timing keys (`time-s`,
`histories-per-sec`); `run-verdicts` is keyed by the run dir's string.
Counter UNKNOWNs take the interval tier (as tests/test_counter_bounds.py
:136 pins for the reference), an unknown workload raises, and the CLI
(`python -m jepsen_jgroups_raft_tpu_torch check`) exits 0 / 1 / 2 with
the reference's JSON (3 without the device it was asked for)."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import recorded as ref_recorded
from jepsen_jgroups_raft_tpu.cli import main as ref_cli
from jepsen_jgroups_raft_tpu.core.store import load_history as ref_load
from jepsen_jgroups_raft_tpu_torch import cli
from jepsen_jgroups_raft_tpu_torch.checker import recorded
from jepsen_jgroups_raft_tpu_torch.checker.base import UNKNOWN
from jepsen_jgroups_raft_tpu_torch.core.store import load_history
from jepsen_jgroups_raft_tpu_torch.history import synth

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMING = ("time-s", "histories-per-sec")


def _strip(summary):
    return {k: v for k, v in summary.items() if k not in TIMING}


def _write_all(root):
    """One run of every workload of WORKLOAD_MODELS under `root`; returns
    {workload: run dir}."""
    rng = random.Random(20260729 + 23)
    dirs = {
        "single-register": synth.write_run(
            root, "single-register", "single-register",
            synth.keyed_register_history(rng, n_keys=1, ops_per_key=40,
                                         n_wide=0)),
        "multi-register": synth.keyed_register_run(
            root, 7, n_keys=12, n_wide=1, nemesis_every=4),
        "counter": synth.counter_run(root, 8, n_ops=150),
        "election": synth.election_run(root, 9, n_ops=200),
    }
    for wl, kind in (("set", "set"), ("queue", "queue")):
        h = synth.random_valid_history(rng, kind, n_ops=120, n_procs=4,
                                       value_range=32, crash_p=0.1,
                                       max_crashes=3)
        dirs[wl] = synth.write_run(root, wl, wl, h)
    assert set(dirs) == set(recorded.WORKLOAD_MODELS)
    return dirs


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    return root, _write_all(root)


@pytest.mark.parametrize("workload", sorted(recorded.WORKLOAD_MODELS))
def test_each_workload_matches_reference(store, workload):
    _, dirs = store
    d = dirs[workload]
    ours = recorded.check_recorded([d], device="cpu")
    theirs = ref_recorded.check_recorded([d])
    assert _strip(ours) == _strip(theirs)
    assert ours["valid?"] is True and ours["runs"] == 1
    model, subs, wl = recorded.load_run_histories(d)
    rmodel, rsubs, rwl = ref_recorded.load_run_histories(d)
    assert (type(model).__name__, wl) == (type(rmodel).__name__, rwl)
    assert [s.to_dicts() for s in subs] == [s.to_dicts() for s in rsubs]


def test_all_runs_in_one_batch_match_reference(store):
    _, dirs = store
    runs = [dirs[w] for w in sorted(dirs)]
    ours = recorded.check_recorded(runs, device="cpu")
    theirs = ref_recorded.check_recorded(runs)
    assert _strip(ours) == _strip(theirs)
    assert ours["runs"] == 6 and ours["n-valid"] == ours["histories"]
    assert list(ours["run-verdicts"]) == [str(d) for d in runs]
    assert set(ours) == set(theirs)


def test_stores_load_identically_in_both_packages(store):
    _, dirs = store
    for d in dirs.values():
        assert load_history(d).to_dicts() == ref_load(d).to_dicts()
    # tuples survive the JSON round trip: (key, value) ops and inspect
    ops = load_history(dirs["multi-register"]).client_ops()
    assert all(isinstance(op.value, tuple) for op in ops)
    views = [op for op in load_history(dirs["election"])
             if op.type == "ok" and op.f == "views"]
    assert views and all(isinstance(op.value, tuple) for op in views)


def _corrupt_run(src, dst):
    """A copy of run dir `src` in `dst` with key 3's last ok read moved
    outside the register's domain."""
    dst.mkdir(parents=True)
    for name in ("test.json", "results.json"):
        (dst / name).write_text((Path(src) / name).read_text())
    ops = [json.loads(line) for line in
           (Path(src) / "history.jsonl").read_text().splitlines()]
    j = max(i for i, o in enumerate(ops) if o["type"] == "ok"
            and o["f"] == "read" and o["value"][0] == 3)
    v = ops[j]["value"][1]
    ops[j]["value"][1] = 17 if v is None else v + 11
    (dst / "history.jsonl").write_text(
        "".join(json.dumps(o) + "\n" for o in ops))
    return dst


def test_corrupted_store_is_invalid_in_both(store, tmp_path):
    _, dirs = store
    bad = _corrupt_run(dirs["multi-register"], tmp_path / "bad" / "r1")
    ours = recorded.check_recorded([bad, dirs["counter"]], device="cpu")
    theirs = ref_recorded.check_recorded([bad, dirs["counter"]])
    assert _strip(ours) == _strip(theirs)
    assert ours["valid?"] is False and ours["n-invalid"] == 1
    assert ours["run-verdicts"][str(bad)] is False


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_counter_unknowns_decided_at_interval_tier(pkg, monkeypatch,
                                                   tmp_path):
    """tests/test_counter_bounds.py:136 on both packages: exact-UNKNOWN
    counter histories are decided by the bounds tier."""
    mod = recorded if pkg == "port" else ref_recorded
    run = tmp_path / "run"
    run.mkdir()
    hist = [
        {"process": 0, "type": "invoke", "f": "add", "value": 3},
        {"process": 0, "type": "ok", "f": "add", "value": 3},
        {"process": 1, "type": "invoke", "f": "read", "value": None},
        {"process": 1, "type": "ok", "f": "read", "value": 3},
    ]
    (run / "history.jsonl").write_text(
        "\n".join(json.dumps(op) for op in hist))
    (run / "test.json").write_text(json.dumps({"workload": "counter"}))
    monkeypatch.setattr(
        mod, "check_histories",
        lambda hists, model, **kw: [{"valid?": UNKNOWN,
                                     "error": "budget"}] * len(hists))
    kw = {"device": "cpu"} if pkg == "port" else {}
    summary = mod.check_recorded([run], **kw)
    assert summary["valid?"] is True
    assert summary["n-unknown"] == 0
    [verdict] = summary["run-verdicts"].values()
    assert verdict is True


def test_unknown_workload_raises(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    (run / "history.jsonl").write_text("")
    for wl in ("bogus", "list-append"):
        (run / "test.json").write_text(json.dumps({"workload": wl}))
        with pytest.raises(ValueError, match="unknown workload"):
            recorded.load_run_histories(run)
        with pytest.raises(ValueError, match="unknown workload"):
            ref_recorded.load_run_histories(run)
    # the harness's nested opts are read too
    (run / "test.json").write_text(json.dumps({"opts": {"workload":
                                                        "counter"}}))
    assert recorded.load_run_histories(run)[2] == "counter"


def _cli_json(capsys, fn, argv):
    rc = fn(argv)
    out = capsys.readouterr().out
    return rc, (json.loads(out) if out.strip() else None)


def test_cli_matches_reference(store, tmp_path, capsys):
    root, dirs = store
    rc, ours = _cli_json(capsys, cli.main,
                         ["check", str(root), "--device", "cpu"])
    rrc, theirs = _cli_json(capsys, ref_cli,
                            ["check", str(root), "--platform", "cpu"])
    assert rc == rrc == 0
    assert _strip(ours) == _strip(theirs)
    # every run once: the `latest` symlinks are skipped
    assert ours["runs"] == len(dirs)
    # one run dir named directly, with the workload overridden
    rc, one = _cli_json(capsys, cli.main,
                        ["check", dirs["multi-register"], "--workload",
                         "single-register", "--device", "cpu"])
    assert rc == 0 and one["runs"] == 1
    bad = _corrupt_run(dirs["multi-register"], tmp_path / "s" / "x" / "r")
    rc, ours = _cli_json(capsys, cli.main,
                         ["check", str(tmp_path / "s"), "--device", "cpu"])
    rrc, theirs = _cli_json(capsys, ref_cli, ["check", str(tmp_path / "s")])
    assert rc == rrc == 1
    assert _strip(ours) == _strip(theirs)
    assert ours["run-verdicts"] == {str(bad): False}
    (tmp_path / "empty").mkdir()
    assert cli.main(["check", str(tmp_path / "empty"), "--device",
                     "cpu"]) == 2
    assert ref_cli(["check", str(tmp_path / "empty")]) == 2


def test_cli_refuses_without_card(store, monkeypatch, capsys):
    root, _ = store
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["check", str(root)]) == 3
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recorded.check_recorded([root])


def test_module_entry_point_runs_the_check(store):
    root, dirs = store
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_jgroups_raft_tpu_torch", "check",
         str(dirs["counter"]), "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout)
    assert summary["valid?"] is True and summary["histories"] == 1
