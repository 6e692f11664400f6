"""The port's per-key independent checker against the reference's.

`split_by_key` (its errors and key order), `check_keyed` on a small
keyed multi-register store with two wide keys (W > 12, which take the
reference's order: fast DFS, then the device, then the full-budget DFS)
— per key valid?, algorithm, decided-tier, kernel, op-count and window —,
a keyed INVALID's counterexample through `IndependentLinearizable`
(failing op, minimized ops and their indices, the HTML file), and
`check_keyed(..., consistency="sequential")` (as
tests/test_scenarios.py:280). The reference's device rows report
"jax" where the port's report "torch"; everything else is compared
exactly."""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.independent import (
    IndependentChecker as RefIndependentChecker,
    IndependentLinearizable as RefIndependentLinearizable,
    check_keyed as ref_check_keyed, split_by_key as ref_split)
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    LinearizableChecker as RefLinearizableChecker
from jepsen_jgroups_raft_tpu.core.store import load_history as ref_load
from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu_torch.checker import (IndependentChecker,
                                                   IndependentLinearizable,
                                                   split_by_key)
from jepsen_jgroups_raft_tpu_torch.checker.independent import check_keyed
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    LinearizableChecker
from jepsen_jgroups_raft_tpu_torch.core.store import load_history
from jepsen_jgroups_raft_tpu_torch.history import synth
from jepsen_jgroups_raft_tpu_torch.history.ops import History, Op
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister

torch.set_num_threads(1)

KEYS = ("valid?", "algorithm", "decided-tier", "kernel", "op-count",
        "concurrency-window", "consistency")


def _view(r):
    out = {k: r.get(k) for k in KEYS}
    if out["algorithm"] == "jax":
        out["algorithm"] = "torch"
    return out


def _both(rows):
    h, rh = History(), RefHistory()
    for r in rows:
        h.append(Op(*r))
        rh.append(RefOp(*r))
    return h, rh


def test_split_by_key_errors_and_order():
    rows = [(0, "invoke", "write", (5, 1)), (1, "invoke", "read", (2, None)),
            (0, "ok", "write", (5, 1)), (1, "ok", "read", (2, None)),
            (2, "invoke", "write", (9, 3)), (2, "ok", "write", (9, 3))]
    h, rh = _both(rows)
    ours, theirs = split_by_key(h), ref_split(rh)
    assert list(ours) == list(theirs) == [5, 2, 9]
    for k in ours:
        assert ours[k].to_dicts() == theirs[k].to_dicts()
    bad, rbad = _both(rows + [(3, "invoke", "read", None)])
    with pytest.raises(ValueError, match="untupled"):
        split_by_key(bad)
    with pytest.raises(ValueError, match="untupled"):
        ref_split(rbad)
    # a completion without a value is skipped, as in the reference
    odd, rodd = _both(rows + [(3, "invoke", "read", (1, None)),
                              (3, "info", "read", None)])
    assert [len(s) for s in split_by_key(odd).values()] == \
        [len(s) for s in ref_split(rodd).values()]


@pytest.fixture(scope="module")
def keyed_store(tmp_path_factory):
    root = tmp_path_factory.mktemp("keyed")
    return synth.keyed_register_run(root, 20260729 + 23, n_keys=24,
                                    n_wide=2, nemesis_every=8)


def test_check_keyed_matches_reference_per_key(keyed_store):
    subs = split_by_key(load_history(keyed_store).client_ops())
    rsubs = ref_split(ref_load(keyed_store).client_ops())
    assert list(subs) == list(rsubs) == list(range(24))
    ours = check_keyed(subs, CasRegister(), device="cpu")
    theirs = ref_check_keyed(rsubs, RefReg())
    assert list(ours) == list(theirs)
    assert {k: _view(r) for k, r in ours.items()} == \
        {k: _view(r) for k, r in theirs.items()}
    wide = [k for k, r in ours.items() if r["concurrency-window"] > 12]
    assert len(wide) == 2
    assert {ours[k]["decided-tier"] for k in wide} == {"host"}
    assert all(r["valid?"] is True for r in ours.values())


def _corrupt(history, key):
    """The key's last ok read, moved outside the register's domain."""
    ops = list(history)
    j = max(i for i, op in enumerate(ops) if op.type == "ok"
            and op.f == "read" and op.value[0] == key)
    k, v = ops[j].value
    ops[j] = ops[j].replace(value=(k, 17 if v is None else v + 11))
    return ops


def test_keyed_invalid_counterexample_matches_reference(keyed_store,
                                                        tmp_path):
    key = 5
    ours_h = _corrupt(load_history(keyed_store), key)
    theirs_h = _corrupt(ref_load(keyed_store), key)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = IndependentLinearizable(CasRegister, device="cpu").check(
        {"store_dir": str(tmp_path / "a")}, ours_h)
    theirs = RefIndependentLinearizable(RefReg).check(
        {"store_dir": str(tmp_path / "b")}, theirs_h)
    assert ours["valid?"] is False and theirs["valid?"] is False
    assert ours["key-count"] == theirs["key-count"] == 24
    bad = [k for k, r in ours["results"].items() if r["valid?"] is False]
    assert bad == [str(key)]
    r, t = ours["results"][str(key)], theirs["results"][str(key)]
    assert _view(r) == _view(t)
    assert r["failing-op-index"] == t["failing-op-index"]
    ce, tce = r["counterexample"], t["counterexample"]
    assert ce["minimal-ops"] == tce["minimal-ops"]
    assert ce["minimal-op-count"] == tce["minimal-op-count"]
    assert ce["failing-op"] == tce["failing-op"]
    assert ce.get("witness-prefix") == tce.get("witness-prefix")
    assert [o["index"] for o in ce["minimal-ops"]] == \
        [o["index"] for o in tce["minimal-ops"]]
    assert ce["file"].endswith(f"counterexample-{key}.html")
    assert (tmp_path / "a" / f"counterexample-{key}.html").exists()


def test_check_keyed_sequential_rung_matches_reference():
    rng = random.Random(23)
    hs = {k: synth.random_valid_history(rng, "register", n_ops=8,
                                        crash_p=0.0) for k in range(3)}
    rows = {k: [(op.process, op.type, op.f, op.value) for op in h]
            for k, h in hs.items()}
    subs = {k: _both(r)[0] for k, r in rows.items()}
    rsubs = {k: _both(r)[1] for k, r in rows.items()}
    ours = check_keyed(subs, CasRegister(), consistency="sequential",
                       device="cpu")
    theirs = ref_check_keyed(rsubs, RefReg(), consistency="sequential")
    assert set(ours) == set(subs)
    assert {k: _view(r) for k, r in ours.items()} == \
        {k: _view(r) for k, r in theirs.items()}
    for r in ours.values():
        assert r["valid?"] is True and r["consistency"] == "sequential"


def test_independent_checker_matches_reference():
    rng = random.Random(4)
    rows = []
    for k in range(4):
        h = synth.random_valid_history(rng, "register", n_ops=12,
                                       n_procs=3, crash_p=0.1)
        rows += [(op.process + 10 * k, op.type, op.f, (k, op.value))
                 for op in h]
    h, rh = _both(rows)
    ours = IndependentChecker(
        lambda: LinearizableChecker(CasRegister(), device="cpu")).check(
            {}, h)
    theirs = RefIndependentChecker(
        lambda: RefLinearizableChecker(RefReg())).check({}, rh)
    assert ours["valid?"] is theirs["valid?"] is True
    assert ours["key-count"] == theirs["key-count"] == 4
    assert {k: _view(r) for k, r in ours["results"].items()} == \
        {k: _view(r) for k, r in theirs["results"].items()}


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IndependentLinearizable(CasRegister)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_keyed({}, CasRegister())
    assert IndependentLinearizable(CasRegister, device="cpu").check(
        {}, History()) == {"valid?": True, "key-count": 0, "results": {}}


def test_config3_store_takes_the_reference_tiers(tmp_path):
    """The full recorded config-3 store (512 keys, 8 wide): per key the
    reference's verdict and tier, row for row — the 8 wide keys on the
    fast DFS, the one W = 11 key through the ladder to the host oracle,
    the rest on the dense plans."""
    d = synth.keyed_register_run(tmp_path, 20260729 + 23)
    subs = split_by_key(load_history(d).client_ops())
    ours = check_keyed(subs, CasRegister(), device="cpu")
    theirs = ref_check_keyed(ref_split(ref_load(d).client_ops()), RefReg())
    assert {k: _view(r) for k, r in ours.items()} == \
        {k: _view(r) for k, r in theirs.items()}
    tiers = {}
    for r in ours.values():
        key = (r["algorithm"], r["decided-tier"])
        tiers[key] = tiers.get(key, 0) + 1
    assert tiers == {("torch", "dense"): 503, ("dfs", "host"): 8,
                     ("cpu", "host"): 1}
