"""The port's harness end to end on the CPU, held to the reference.

For every entry of `WORKLOADS`: `compose_test` + `run_test` on the
port's seeded `InMemoryCluster`, checked with ``device="cpu"`` (the
kernels' plain versions), under a fault schedule. Each run verifies and
stores its run dir. Its history, loaded back with the reference's
`load_history`, is re-checked by the reference's checker for the same
workload (built by the reference's `WORKLOADS` constructor; JAX on the
CPU): the verdict and every per-key result are equal but for the
algorithm tag, which differs by rule ("torch" in the port, "jax" in
the reference). A copy with one observation corrupted is INVALID in
both, with the same failing op. The runner stamps `scan-stats` and
`decided-tiers`, and a check that raises (a kernel's failure on the
card) leaves the verdict unknown, with the error in the results."""

import copy
import json

import pytest
import torch

from jepsen_jgroups_raft_tpu.core.store import load_history as ref_load
from jepsen_jgroups_raft_tpu.workload import WORKLOADS as REF_WORKLOADS
from jepsen_jgroups_raft_tpu_torch.checker import independent
from jepsen_jgroups_raft_tpu_torch.core import compose, db, runner
from jepsen_jgroups_raft_tpu_torch.core.store import load_history
from jepsen_jgroups_raft_tpu_torch.history.ops import History, Op
from jepsen_jgroups_raft_tpu_torch.models.listappend import (MAX_ELEM,
                                                              MAX_LEN)
from jepsen_jgroups_raft_tpu_torch.sut import inmemory
from jepsen_jgroups_raft_tpu_torch.workload import WORKLOADS

torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]

#: workload → the fault schedule its run is under (None: the workload's
#: paired schedule, set-churn and queue-drain)
NEMESES = {"single-register": "partition", "multi-register": "kill",
           "counter": "pause", "set": None, "queue": None,
           "election": "partition", "list-append": "pause"}

OPTS = {"nodes": NODES, "rate": 60.0, "interval": 0.4, "time_limit": 1.5,
        "quiesce": 0.2, "concurrency": 4, "operation_timeout": 0.25,
        "ops_per_key": 30, "render_plots": False}

#: the result keys that carry times or paths, not verdicts
VOLATILE = ("time-s", "file", "html")


def _normal(x):
    """A result with its times and paths dropped and the kernel verdicts'
    algorithm tag read as the reference's ("torch" → "jax")."""
    if isinstance(x, dict):
        return {k: ("jax" if k == "algorithm" and v == "torch"
                    else _normal(v))
                for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, (list, tuple)):
        return [_normal(v) for v in x]
    return x


def _run(workload, root, seed):
    c = inmemory.InMemoryCluster(NODES, inmemory.LatencyPlan(seed=seed))
    try:
        test = compose.compose_test(
            {**OPTS, "workload": workload, "nemesis": NEMESES[workload],
             "conn_factory": c.conn, "store_root": str(root),
             "device": "cpu"},
            db=db.InMemoryDB(c), net=db.InMemoryNet(c), seed=seed)
        return runner.run_test(test)
    finally:
        c.shutdown()


def _checker(workloads, name, **extra):
    return workloads[name]({**OPTS, "conn_factory": None, **extra})[
        "checker"]


def _corrupt(workload, h):
    """A copy of `h` (op dicts) with one completed observation made
    impossible; returns (copy, index of the changed op)."""
    h = copy.deepcopy(h)
    for op in reversed(h):
        if op["type"] != "ok" or op["process"] == "nemesis":
            continue
        f, v = op["f"], op["value"]
        if workload.endswith("register") and f == "read":
            op["value"] = [v[0], 99]
        elif workload == "counter" and f == "read":
            op["value"] = v + 10**6
        elif workload == "set" and f == "read":
            # drop an element whose add completed before the read began
            # (not with element 31 in the read: its encoding hides the
            # others, models/setmodel.py)
            start = max(o["index"] for o in h if o["index"] < op["index"]
                        and o["process"] == op["process"]
                        and o["type"] == "invoke")
            done = {o["value"] for o in h if o["index"] < start
                    and o["f"] == "add" and o["type"] == "ok"}
            drop = sorted(set(v) & done)
            if 31 in v or not drop:
                continue
            op["value"] = [e for e in v if e != drop[0]]
        elif workload == "queue" and f == "dequeue" and v is not None:
            # deliver the first dequeued ticket a second time
            first = next(o["value"] for o in h if o["f"] == "dequeue"
                         and o["type"] == "ok" and o["value"] is not None)
            if first == v:
                continue
            op["value"] = first
        elif workload == "election" and f == "inspect" and v[0]:
            other = next(n for n in NODES if n != v[0])
            op["value"] = [other, v[1]]
            h.append({**op, "index": len(h) + 1, "process": 999,
                      "type": "invoke", "value": None, "time": op["time"]})
            h.append({**op, "index": len(h) + 1, "process": 999,
                      "value": [v[0], v[1]], "time": op["time"] + 1})
        elif workload == "list-append" and f == "read":
            # (not a full list: a 7th element leaves the packed domain,
            # and both packages' encoders raise instead of refuting)
            if len(v[1]) >= MAX_LEN:
                continue
            op["value"] = [v[0], [*v[1], MAX_ELEM]]
        else:
            continue
        return h, op["index"]
    raise AssertionError(f"no observation to corrupt in {workload}")


def _history(dicts, ref=False):
    from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
    from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp

    cls, op_cls = (RefHistory, RefOp) if ref else (History, Op)
    h = cls()
    for d in dicts:
        d = dict(d)
        if isinstance(d.get("value"), list):
            d["value"] = tuple(d["value"])
        h.append(op_cls.from_dict(d))
    return h


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_inmemory_run_rechecks_alike_in_the_reference(workload, tmp_path):
    test = _run(workload, tmp_path / "store", 7)
    res = test["results"]
    assert res["valid?"] is True, json.dumps(res, default=str)[:3000]
    d = test["store_dir"]
    saved = json.loads((tmp_path / "store" / test["name"] / "latest" /
                        "results.json").read_text())
    assert saved["valid?"] is True
    if workload != "election":
        assert "decided-tiers" in res
    assert sum(1 for op in test["history"] if op.type == "ok") > 10

    ref_res = _checker(REF_WORKLOADS, workload).check({}, ref_load(d))
    assert _normal(ref_res) == _normal(res["workload"])

    dicts = [op.to_dict() for op in load_history(d)]
    bad, changed = _corrupt(workload, dicts)
    mine = _checker(WORKLOADS, workload, device="cpu").check(
        {}, _history(bad))
    ref = _checker(REF_WORKLOADS, workload).check({}, _history(bad, True))
    assert mine["valid?"] is False and ref["valid?"] is False
    assert _normal(mine) == _normal(ref)
    if workload != "election":  # the election models name no op
        # the frontier may die at an op concurrent with the changed one
        fails = _failing_ops(mine["linear"])
        assert fails and fails == _failing_ops(ref["linear"])
        assert min(fails) <= changed + 1


def _failing_ops(result):
    """Every `failing-op-index` in a (per-key) result."""
    if not isinstance(result, dict):
        return []
    out = [result["failing-op-index"]] if "failing-op-index" in result \
        else []
    for v in result.values():
        out += _failing_ops(v)
    return out


def test_multi_register_per_key_verdicts(tmp_path):
    """The per-key split of a multi-register run: several keys, each
    verdict and tier the reference's."""
    test = _run("multi-register", tmp_path / "store", 8)
    keyed = test["results"]["workload"]["linear"]
    assert keyed["key-count"] >= 2
    ref = _checker(REF_WORKLOADS, "multi-register").check(
        {}, ref_load(test["store_dir"]))["linear"]
    assert {k: r["valid?"] for k, r in keyed["results"].items()} == \
        {k: r["valid?"] for k, r in ref["results"].items()}
    assert {k: r.get("decided-tier") for k, r in keyed["results"].items()} \
        == {k: r.get("decided-tier") for k, r in ref["results"].items()}


def test_a_check_that_raises_leaves_the_verdict_unknown(tmp_path,
                                                       monkeypatch):
    """A failure inside the post-run check (on the card: a kernel that
    does not build or launch) must fail the run, not weaken it: the
    composed verdict is not True and the error is in the results."""
    def boom(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(independent, "check_keyed", boom)
    test = _run("single-register", tmp_path / "store", 9)
    res = test["results"]
    assert res["valid?"] == "unknown"
    assert "illegal memory access" in res["workload"]["linear"]["error"]
    saved = json.loads((tmp_path / "store" / test["name"] / "latest" /
                        "results.json").read_text())
    assert saved["valid?"] == "unknown"


def test_workload_checkers_take_the_device_and_refuse_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in sorted(WORKLOADS):
        wl = WORKLOADS[name]({**OPTS, "conn_factory": None,
                              "device": "cpu"})
        assert wl["checker"] is not None
    for name in ("single-register", "counter", "set", "queue",
                 "list-append"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            WORKLOADS[name]({**OPTS, "conn_factory": None})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compose.compose_test({**OPTS, "conn_factory": None})
