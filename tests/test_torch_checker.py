"""The port's checker against the reference's `check_histories` on
register, counter and queue histories (the reference under the suite's pins:
JGRAFT_LIN_FASTPATH=0, JGRAFT_AUTOTUNE=0). Inside the dense caps every
result must agree on valid?, kernel, decided-tier, op-count and
concurrency-window; beyond them both take the reference's ladder (fast
DFS, device, host), and valid?, algorithm and decided-tier agree. Exact
equality."""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.models.counter import Counter as RefCounter
from jepsen_jgroups_raft_tpu.models.queuemodel import TicketQueue as RefQueue
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu_torch.checker import schedule
from jepsen_jgroups_raft_tpu_torch.checker.base import UNKNOWN
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
    LinearizableChecker, check_encoded, check_histories)
from jepsen_jgroups_raft_tpu_torch.history.ops import History
from jepsen_jgroups_raft_tpu_torch.history.packing import (encode_history,
                                                           pack_batch,
                                                           pack_macro_batch)
from jepsen_jgroups_raft_tpu_torch.history.synth import (build_history,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import Counter, TicketQueue
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_plan

torch.set_num_threads(1)

KEYS = ("valid?", "kernel", "decided-tier", "op-count", "concurrency-window")


def _batch(seed=5, n=40):
    rng = random.Random(seed)
    hs = []
    for i in range(n):
        h = random_valid_history(rng, "register",
                                 n_ops=rng.randint(100, 200),
                                 n_procs=rng.randint(2, 5), crash_p=0.1,
                                 max_crashes=3)
        if i % 2:
            ops = list(h)
            reads = [j for j, op in enumerate(ops) if op.type == "ok"
                     and op.f == "read" and op.value is not None]
            if reads:
                j = rng.choice(reads)
                ops[j] = ops[j].replace(value=ops[j].value + 1)
                h = ops
        hs.append(h)
    return hs


def _wide(valid):
    """A history beyond the dense caps: an initial write, then 12
    crashed CAS ops chained 0→1→…→12 (each one's value observed by the
    next, so the prune keeps them all: window 13), then a read of 12 —
    and, for the invalid twin, a later read of 5, which no op can bring
    back."""
    rows = [(0, "invoke", "write", 0), (0, "ok", "write", 0)]
    rows += [(k + 1, "invoke", "cas", (k, k + 1)) for k in range(12)]
    rows += [(20, "invoke", "read", None), (20, "ok", "read", 12)]
    if not valid:
        rows += [(21, "invoke", "read", None), (21, "ok", "read", 5)]
    return build_history(rows)


def _view(r):
    return {k: r.get(k) for k in KEYS}


def test_matches_reference_inside_dense_caps():
    hs = _batch()
    ours = check_histories(hs, CasRegister(), device="cpu")
    theirs = ref_check(hs, RefReg())
    assert [_view(r) for r in ours] == [_view(r) for r in theirs]
    verdicts = [r["valid?"] for r in ours]
    assert True in verdicts and False in verdicts
    assert {r["decided-tier"] for r in ours} == {"dense"}
    assert all(r["algorithm"] == "torch" for r in ours)


def test_beyond_caps_takes_host_tier_with_reference_verdict():
    """Beyond the dense caps both packages take the reference's ladder —
    the fast DFS first on a window above 12, then the device, then the
    host: verdict, algorithm and decided tier agree row for row."""
    hs = [_wide(True), _wide(False)] + _batch(seed=9, n=6)
    ours = check_histories(hs, CasRegister(), device="cpu")
    theirs = ref_check(hs, RefReg())
    assert [r["valid?"] for r in ours] == [r["valid?"] for r in theirs]
    assert [r["valid?"] for r in ours[:2]] == [True, False]
    for r, t in zip(ours[:2], theirs[:2]):
        assert r["concurrency-window"] == 13
        assert (r["algorithm"], r["decided-tier"]) == \
            (t["algorithm"], t["decided-tier"]) == ("dfs", "host")
    assert [_view(r) for r in ours[2:]] == [_view(r) for r in theirs[2:]]


def test_algorithms_dense_and_cpu():
    hs = [_wide(True)] + _batch(seed=3, n=4)
    dense = check_histories(hs, CasRegister(), algorithm="dense",
                            device="cpu")
    # 13 slots: beyond the dense kernels, inside the sort ladder
    assert (dense[0]["valid?"], dense[0]["decided-tier"]) == (True, "sort")
    # undecided at the top rung (one rung of 2 configurations): UNKNOWN
    [pinned] = check_histories(hs[:1], CasRegister(), algorithm="dense",
                               device="cpu", n_configs=2)
    assert pinned["valid?"] == UNKNOWN and "caps" in pinned["error"]
    host = check_histories(hs, CasRegister(), algorithm="cpu", device="cpu")
    assert {r["decided-tier"] for r in host} == {"host"}
    assert [r["valid?"] for r in host[1:]] == \
        [r["valid?"] for r in dense[1:]]
    with pytest.raises(ValueError, match="unknown algorithm"):
        check_histories(hs, CasRegister(), algorithm="jax", device="cpu")


def test_trivial_and_tier_counters():
    schedule.consume_tiers()
    schedule.consume_stats()
    with schedule.stats_scope("t") as scope:
        rs = check_encoded([], CasRegister(), device="cpu")
        assert rs == []
        [empty, one] = check_histories([History(), _batch(n=1)[0]],
                                       CasRegister(), device="cpu")
    ref_empty = ref_check([History()], RefReg())[0]
    assert _view(empty) == _view(ref_empty)
    assert empty["decided-tier"] == "trivial"
    assert scope["tiers"]["trivial"][0] == 1
    assert scope["tiers"]["dense"][0] == 1
    assert scope["groups_run"] == 1 and scope["rows_run"] == 1
    tiers = schedule.consume_tiers()
    assert tiers["dense"]["rows"] == 1 and tiers["trivial"]["rows"] == 1
    assert schedule.consume_stats()["groups_run"] == 1
    assert one["valid?"] is True


def test_linearizable_checker_protocol():
    good, bad = _wide(True), _wide(False)
    ck = LinearizableChecker(CasRegister(), device="cpu")
    assert ck.check({}, good)["valid?"] is True
    r = ck.check({}, bad)
    assert r["valid?"] is False and "failing-op-index" in r
    # plain lists of op dicts are accepted too
    assert ck.check({}, good.to_dicts())["valid?"] is True


def test_run_dense_groups_mixed_groups_match_reference():
    """Window groups that differ in W, S, row format and length, launched
    together through run_dense_groups on the CPU, give the reference
    checker's verdict for every history."""
    rng = random.Random(11)
    m = CasRegister()
    launches, hists = [], []
    for n_procs, crashes, vr, n_ops, macro in ((1, 0, 3, 30, False),
                                               (3, 1, 7, 60, True),
                                               (5, 3, 3, 90, True),
                                               (4, 2, 15, 40, False)):
        hs = []
        for i in range(6):
            h = random_valid_history(rng, "register", n_ops=n_ops,
                                     n_procs=n_procs, crash_p=0.4,
                                     max_crashes=crashes, value_range=vr)
            ops = list(h)
            reads = [j for j, op in enumerate(ops) if op.type == "ok"
                     and op.f == "read" and op.value is not None]
            if i % 2 and reads:
                j = rng.choice(reads)
                ops[j] = ops[j].replace(value=ops[j].value + 1)
            hs.append(ops)
        encs = [encode_history(h, m) for h in hs]
        plan = dense_plan(m, encs)
        batch = (pack_macro_batch if macro else pack_batch)(encs)
        launches.append(schedule.DenseLaunch(
            events=torch.from_numpy(batch["events"]),
            val_of=torch.from_numpy(plan.val_of),
            n_events=torch.from_numpy(batch["n_events"]),
            n_slots=plan.n_slots, macro_p=batch.get("macro_p")))
        hists += hs
    assert len({ln.n_slots for ln in launches}) == len(launches)
    run = schedule.run_dense_groups(launches, m)
    assert run.kernel_ms is None and run.span_ms is None  # CPU: untimed
    ours = [bool(v) for ok in run.ok for v in ok]
    theirs = [r["valid?"] for r in ref_check(hists, RefReg())]
    assert ours == theirs
    assert True in ours and False in ours


MASK_MODELS = {"counter": (Counter, RefCounter),
               "queue": (TicketQueue, RefQueue)}


def _mask_batch(kind, seed=21, n=30):
    """Counter or queue histories at the suite's shape (5 processes, at
    most 3 crashes), odd ones with one observation raised by 1000, and
    last one history beyond the mask cap: 13 crashed ops, then a read
    (window 14)."""
    rng = random.Random(seed)
    hs = []
    for i in range(n):
        h = list(random_valid_history(rng, kind, n_ops=rng.randint(80, 160),
                                      n_procs=5, crash_p=0.1,
                                      max_crashes=3))
        idx = [j for j, op in enumerate(h) if op.type == "ok"
               and op.value is not None
               and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
        if i % 2 and idx:
            j = rng.choice(idx)
            v = h[j].value
            h[j] = h[j].replace(value=(v[0], v[1] + 1000)
                                if isinstance(v, tuple) else v + 1000)
        hs.append(h)
    f, g, v = (("add", "read", 13) if kind == "counter"
               else ("enqueue", "dequeue", 0))
    hs.append(build_history(
        [(k, "invoke", f, 1 if kind == "counter" else None)
         for k in range(13)] + [(20, "invoke", g, None), (20, "ok", g, v)]))
    return hs


@pytest.mark.parametrize("kind", list(MASK_MODELS))
def test_counter_and_queue_match_reference(kind):
    port_m, ref_m = (c() for c in MASK_MODELS[kind])
    hs = _mask_batch(kind)
    ours = check_histories(hs, port_m, device="cpu")
    theirs = ref_check(hs, ref_m)
    assert [_view(r) for r in ours[:-1]] == [_view(r) for r in theirs[:-1]]
    verdicts = [r["valid?"] for r in ours[:-1]]
    assert True in verdicts and False in verdicts
    assert {(r["kernel"], r["decided-tier"], r["algorithm"])
            for r in ours[:-1]} == {("dense-mask", "mask", "torch")}
    # beyond the mask cap: both take the reference's ladder
    wide, ref_wide = ours[-1], theirs[-1]
    assert wide["concurrency-window"] == 14
    assert wide["valid?"] is ref_wide["valid?"] is True
    assert (wide["algorithm"], wide["decided-tier"]) == \
        (ref_wide["algorithm"], ref_wide["decided-tier"]) == ("dfs", "host")


@pytest.mark.parametrize("kind", list(MASK_MODELS))
def test_algorithm_dense_covers_mask_groups(kind):
    port_m, _ = (c() for c in MASK_MODELS[kind])
    hs = _mask_batch(kind, seed=8, n=6)
    dense = check_histories(hs, port_m, algorithm="dense", device="cpu")
    assert {r["decided-tier"] for r in dense[:-1]} == {"mask"}
    assert dense[-1]["valid?"] == UNKNOWN and "caps" in dense[-1]["error"]
    auto = check_histories(hs, port_m, device="cpu")
    assert [r["valid?"] for r in dense[:-1]] == \
        [r["valid?"] for r in auto[:-1]]
