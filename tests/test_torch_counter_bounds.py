"""The port's interval (bounds) counter tier against the reference's.

The cases of tests/test_counter_bounds.py run through both packages'
`interval_check` and `CounterChecker` (the exact checker stubbed, as
there), and seeded counter histories — valid, with a read moved out of
range, with crashed and failed adds, with decrements — give equal result
dicts, as does `decide_unknown_with_interval`. Exact equality."""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.counter_bounds import (
    CounterChecker as RefCounterChecker,
    decide_unknown_with_interval as ref_decide,
    interval_check as ref_interval)
from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu_torch.checker.base import UNKNOWN, Checker
from jepsen_jgroups_raft_tpu_torch.checker.counter_bounds import (
    CounterChecker, decide_unknown_with_interval, interval_check)
from jepsen_jgroups_raft_tpu_torch.history.ops import (FAIL, INFO, INVOKE,
                                                       OK, History, Op)
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history

torch.set_num_threads(1)


def _both(rows):
    h, rh = History(), RefHistory()
    for r in rows:
        h.append(Op(*r))
        rh.append(RefOp(*r))
    return h, rh


# the cases of tests/test_counter_bounds.py, with their verdicts
CASES = {
    "within_bounds": ([
        (0, INVOKE, "add", 3), (0, OK, "add", 3),
        (1, INVOKE, "read", None), (1, OK, "read", 3),
        (2, INVOKE, "decr", 1), (2, OK, "decr", 1),
        (1, INVOKE, "read", None), (1, OK, "read", 2),
    ], True),
    "outside_range": ([
        (0, INVOKE, "add", 3), (0, OK, "add", 3),
        (1, INVOKE, "read", None), (1, OK, "read", 7),
    ], False),
    "span_read": ([
        (1, INVOKE, "read", None),
        (0, INVOKE, "add", 5), (0, OK, "add", 5),
        (1, OK, "read", 0),
    ], True),
    "crashed_add": ([
        (0, INVOKE, "add", 4), (0, INFO, "add", 4),
        (1, INVOKE, "read", None), (1, OK, "read", 4),
        (1, INVOKE, "read", None), (1, OK, "read", 0),
    ], True),
    "failed_add": ([
        (0, INVOKE, "add", 4), (0, FAIL, "add", 4),
        (1, INVOKE, "read", None), (1, OK, "read", 4),
    ], False),
    "add_and_get": ([
        (0, INVOKE, "add-and-get", 2), (0, OK, "add-and-get", (2, 9)),
    ], False),
    "negative_deltas": ([
        (0, INVOKE, "decr", 5), (0, OK, "decr", 5),
        (1, INVOKE, "read", None), (1, OK, "read", -5),
        (1, INVOKE, "read", None), (1, OK, "read", -11),
    ], False),
    "decr_and_get": ([
        (0, INVOKE, "decr-and-get", 2), (0, OK, "decr-and-get", (2, -2)),
        (1, INVOKE, "read", None), (1, OK, "read", -2),
    ], True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_interval_check_matches_reference(name):
    rows, want = CASES[name]
    h, rh = _both(rows)
    r = interval_check(h)
    assert r == ref_interval(rh)
    assert r["valid?"] is want


def test_case_details():
    r = interval_check(_both(CASES["within_bounds"][0])[0])
    assert r["reads-checked"] == 2 and r["final-range"] == [2, 2]
    assert "outside possible range" in \
        interval_check(_both(CASES["outside_range"][0])[0])["error"]
    assert "pre-state 7" in \
        interval_check(_both(CASES["add_and_get"][0])[0])["error"]


class _Stub(Checker):
    def __init__(self, result):
        self.result = result

    def check(self, test, history, opts=None):
        return dict(self.result)


@pytest.mark.parametrize("exact", [
    {"valid?": True, "algorithm": "jax"},
    {"valid?": False, "algorithm": "jax"},
    {"valid?": UNKNOWN, "algorithm": "jax", "error": "window beyond budget"},
])
@pytest.mark.parametrize("name", ["within_bounds", "outside_range"])
def test_counter_checker_matches_reference(exact, name):
    rows, want = CASES[name]
    h, rh = _both(rows)
    ours = CounterChecker(_Stub(exact)).check({}, h)
    theirs = RefCounterChecker(_Stub(exact)).check({}, rh)
    assert ours == theirs
    if exact["valid?"] is UNKNOWN:
        assert ours["certificate"] == "interval"
        assert ours["valid?"] is want
        assert "window beyond budget" in ours["exact"]["error"]
    else:
        assert ours == exact


def _seeded(seed):
    rng = random.Random(seed)
    h = list(random_valid_history(rng, "counter", n_ops=rng.randint(20, 120),
                                  n_procs=rng.randint(2, 6), crash_p=0.15,
                                  max_crashes=4))
    kind = seed % 4
    reads = [j for j, op in enumerate(h) if op.type == OK and op.f == "read"]
    if kind == 1 and reads:  # a read beyond every possible sum
        j = rng.choice(reads)
        h[j] = h[j].replace(value=h[j].value + 1000)
    elif kind == 2:  # adds become decrements
        h = [op.replace(f="decr") if op.f == "add" else op for op in h]
    elif kind == 3:  # some ok adds fail instead
        h = [op.replace(type=FAIL) if op.f == "add" and op.type == OK
             and rng.random() < 0.3 else op for op in h]
    return [(op.process, op.type, op.f, op.value) for op in h]


@pytest.mark.parametrize("seed", range(16))
def test_seeded_histories_match_reference(seed):
    h, rh = _both(_seeded(seed))
    r = interval_check(h)
    assert r == ref_interval(rh)
    exact = {"valid?": UNKNOWN, "algorithm": "torch", "op-count": 7}
    assert decide_unknown_with_interval(exact, h) == ref_decide(exact, rh)
    if seed % 4 == 1:
        assert r["valid?"] is False
