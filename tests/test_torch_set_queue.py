"""The port's set and queue analyses against the reference's.

The cases of tests/test_scenarios.py (lost, stale, recovered and
duplicate adds; double delivery, phantoms, clean drains) and seeded set
and queue histories — valid, with a read that drops an element, with a
ticket dequeued twice or out of range — give the reference's result
dicts through `SetAnalysis` and `QueueConservation`. Exact equality."""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.set_queue import \
    QueueConservation as RefQueue
from jepsen_jgroups_raft_tpu.checker.set_queue import SetAnalysis as RefSet
from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu_torch.checker.set_queue import (
    QueueConservation, SetAnalysis)
from jepsen_jgroups_raft_tpu_torch.history.ops import History, Op
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history

torch.set_num_threads(1)


def _same(checker, ref_checker, rows):
    h, rh = History(), RefHistory()
    for r in rows:
        h.append(Op(*r))
        rh.append(RefOp(*r))
    ours = checker().check({}, h)
    assert ours == ref_checker().check({}, rh)
    return ours


SET_CASES = {
    "lost": ([(0, "invoke", "add", 3), (0, "ok", "add", 3),
              (1, "invoke", "read", None), (1, "ok", "read", [])],
             False),
    "stale": ([(0, "invoke", "add", 3), (0, "ok", "add", 3),
               (1, "invoke", "read", None), (1, "ok", "read", [3]),
               (1, "invoke", "read", None), (1, "ok", "read", [])], False),
    "recovered": ([(0, "invoke", "add", 3), (0, "info", "add", 3),
                   (1, "invoke", "read", None), (1, "ok", "read", [3])],
                  True),
    "duplicate": ([(0, "invoke", "add", 3),
                   (1, "invoke", "add", 3), (1, "ok", "add", 3),
                   (2, "invoke", "read", None), (2, "ok", "read", []),
                   (0, "ok", "add", 3)], False),
    "bitmask_read": ([(0, "invoke", "add", 1), (0, "ok", "add", 1),
                      (1, "invoke", "read", None), (1, "ok", "read", 0b10)],
                     True),
    "no_reads": ([(0, "invoke", "add", 1), (0, "ok", "add", 1)], True),
}

QUEUE_CASES = {
    "double": ([(0, "invoke", "enqueue", None), (0, "ok", "enqueue", 0),
                (1, "invoke", "dequeue", None), (1, "ok", "dequeue", 0),
                (2, "invoke", "dequeue", None), (2, "ok", "dequeue", 0)],
               False),
    "phantom": ([(0, "invoke", "dequeue", None), (0, "ok", "dequeue", 5)],
                False),
    "clean": ([(0, "invoke", "enqueue", None), (0, "ok", "enqueue", 0),
               (1, "invoke", "dequeue", None), (1, "ok", "dequeue", 0),
               (1, "invoke", "dequeue", None), (1, "ok", "dequeue", None)],
              True),
    "info_enqueue": ([(0, "invoke", "enqueue", None),
                      (0, "info", "enqueue", None),
                      (1, "invoke", "dequeue", None),
                      (1, "ok", "dequeue", 0)], True),
}


@pytest.mark.parametrize("name", sorted(SET_CASES))
def test_set_analysis_matches_reference(name):
    rows, want = SET_CASES[name]
    r = _same(SetAnalysis, RefSet, rows)
    assert r["valid?"] is want


def test_set_case_details():
    assert _same(SetAnalysis, RefSet, SET_CASES["lost"][0])["lost"] == [3]
    assert _same(SetAnalysis, RefSet, SET_CASES["stale"][0])["stale"] == [3]
    assert _same(SetAnalysis, RefSet,
                 SET_CASES["recovered"][0])["recovered"] == [3]


@pytest.mark.parametrize("name", sorted(QUEUE_CASES))
def test_queue_conservation_matches_reference(name):
    rows, want = QUEUE_CASES[name]
    r = _same(QueueConservation, RefQueue, rows)
    assert r["valid?"] is want


def _rows(h):
    return [(op.process, op.type, op.f, op.value) for op in h]


@pytest.mark.parametrize("seed", range(10))
def test_seeded_set_histories_match_reference(seed):
    rng = random.Random(seed)
    rows = _rows(random_valid_history(rng, "set", n_ops=rng.randint(30, 150),
                                      n_procs=rng.randint(2, 5),
                                      value_range=32, crash_p=0.1,
                                      max_crashes=3))
    assert _same(SetAnalysis, RefSet, rows)["valid?"] is True
    reads = [j for j, r in enumerate(rows) if r[1] == "ok" and r[2] == "read"
             and r[3]]
    j = reads[-1]
    p, typ, f, v = rows[j]
    rows[j] = (p, typ, f, v[1:])  # the final read drops an element
    _same(SetAnalysis, RefSet, rows)


@pytest.mark.parametrize("seed", range(10))
def test_seeded_queue_histories_match_reference(seed):
    rng = random.Random(100 + seed)
    rows = _rows(random_valid_history(rng, "queue",
                                      n_ops=rng.randint(30, 150),
                                      n_procs=rng.randint(2, 5),
                                      crash_p=0.1, max_crashes=3))
    assert _same(QueueConservation, RefQueue, rows)["valid?"] is True
    deqs = [j for j, r in enumerate(rows) if r[1] == "ok"
            and r[2] == "dequeue" and r[3] is not None]
    if len(deqs) >= 2:
        j, k = deqs[0], deqs[-1]
        p, typ, f, _ = rows[k]
        rows[k] = (p, typ, f, rows[j][3])  # a ticket delivered twice
        assert _same(QueueConservation, RefQueue, rows)["valid?"] is False
    rows += [(999, "invoke", "dequeue", None), (999, "ok", "dequeue", 10**6)]
    assert _same(QueueConservation, RefQueue, rows)["valid?"] is False
