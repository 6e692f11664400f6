"""The port's weak consistency rungs against the reference's.

`relax_encoded` re-encodes byte for byte as the reference does (every
model, both rungs); `apply_rung` gives the same (relaxed encodings,
certified, tiers); `check_histories(..., consistency="sequential" |
"session", device="cpu")` gives the reference's verdict, algorithm,
decided tier, cycle witness, exact-SC-refutation flag, sc-refuted
evidence and rung row for row — on the same-process stale read, the
reference's ablation matrix (tests/test_cycle.py) with
JGRAFT_GREEDY_CERTIFY, JGRAFT_CYCLE_TIER and JGRAFT_GREEDY_BACKTRACK on
and off, and the monotonic-writes history that passes the session rung
with sc-refuted evidence; and `LinearizableChecker(consistency=...)`
attaches the reference's counterexample at a weak rung. The reference
runs under the suite's pins (JGRAFT_LIN_FASTPATH=0, JGRAFT_AUTOTUNE=0);
its kernel rows report "jax" where the port's report "torch". Exact
equality throughout.
"""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import consistency as ref_cons
from jepsen_jgroups_raft_tpu.checker import counterexample as ref_ce
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    LinearizableChecker as RefChecker
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.history.synth import corrupt as ref_corrupt
from jepsen_jgroups_raft_tpu.history.synth import \
    random_valid_history as ref_random_history
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu_torch.checker import consistency as cons
from jepsen_jgroups_raft_tpu_torch.checker import counterexample as ce
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
    LinearizableChecker, check_encoded, check_histories, fastpath_counters)
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import build_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drain_reference_counters():
    """The reference's counters are process-wide, and its own tests read
    their totals: leave none of this file's reference calls in them."""
    yield
    ref_schedule.consume_stats()
    ref_schedule.consume_tiers()


KINDS = {"register": "cas-register", "counter": "counter", "queue": "queue",
         "set": "set", "list-append": "list-append"}
STALE_READ = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
              (0, "invoke", "read", None), (0, "ok", "read", None)]
MONOTONIC_WRITES = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
                    (0, "invoke", "write", 2), (0, "ok", "write", 2),
                    (1, "invoke", "read", None), (1, "ok", "read", 2),
                    (1, "invoke", "read", None), (1, "ok", "read", 1)]
#: the result keys a weak rung decides, compared row for row
KEYS = ("valid?", "algorithm", "decided-tier", "cycle",
        "exact-sc-refutation", "sc-refuted", "sc-cycle", "consistency",
        "cycle-skipped-size", "op-count", "concurrency-window")
ABLATION = ("JGRAFT_GREEDY_CERTIFY", "JGRAFT_CYCLE_TIER",
            "JGRAFT_GREEDY_BACKTRACK")


def _rows(h):
    return [(op.process, op.type, op.f, op.value) for op in h]


def _ref_history(rows):
    h = RefHistory()
    for i, (p, typ, f, v) in enumerate(rows):
        h.append(RefOp(process=p, type=typ, f=f, value=v, time=i))
    return h


def _view(r):
    out = {k: r.get(k) for k in KEYS}
    if out["algorithm"] == "jax":
        out["algorithm"] = "torch"
    return out


def _mixed(kind, seed, n, n_ops, n_procs=3, crash_p=0.15):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = ref_random_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                               crash_p=crash_p,
                               **({"value_range": 6} if kind == "set"
                                  else {}))
        if i % 3 == 0 and kind != "list-append":
            h = ref_corrupt(rng, h)
        out.append(_rows(h))
    return out


def _matrix():
    """The reference's ablation matrix (tests/test_cycle.py:180)."""
    rng = random.Random(31)
    out = []
    for i in range(14):
        h = ref_random_history(rng, "register", n_ops=14, n_procs=3,
                               crash_p=0.15)
        if i % 3 == 0:
            h = ref_corrupt(rng, h)
        out.append(_rows(h))
    return out


def test_rung_names_match_reference():
    assert cons.CONSISTENCY_LEVELS == ref_cons.CONSISTENCY_LEVELS
    for name in (None, "lin", "Linearizability", "seq", " sequential ",
                 "session", "monotonic-reads", "monotonic"):
        assert cons.normalize_consistency(name) == \
            ref_cons.normalize_consistency(name)
        assert cons.rung_index(name or "linearizable") == \
            ref_cons.rung_index(name or "linearizable")
    for bad in ("serializable", "", "strict"):
        with pytest.raises(ValueError):
            cons.normalize_consistency(bad)
    with pytest.raises(ValueError):
        check_histories([], MODELS["cas-register"](), device="cpu",
                        consistency="snapshot")


@pytest.mark.parametrize("rung", ["sequential", "session"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_relax_encoded_is_byte_identical(kind, rung):
    m, rm = MODELS[KINDS[kind]](), REF_MODELS[KINDS[kind]]()
    for rows in _mixed(kind, 7, 8, 30, n_procs=4, crash_p=0.25):
        ours = cons.relax_encoded(encode_history(build_history(rows), m), m,
                                  rung)
        theirs = ref_cons.relax_encoded(ref_enc(_ref_history(rows), rm),
                                        rm, rung)
        for f in ("events", "op_index", "proc"):
            assert getattr(ours, f).tobytes() == getattr(theirs, f).tobytes()
        assert (ours.n_slots, ours.n_ops) == (theirs.n_slots, theirs.n_ops)
    lin = encode_history(build_history(STALE_READ), m) \
        if kind == "register" else None
    if lin is not None:
        assert cons.relax_encoded(lin, m, "linearizable") is lin


@pytest.mark.parametrize("greedy", ["1", "0"])
@pytest.mark.parametrize("rung", ["sequential", "session"])
@pytest.mark.parametrize("kind", ["register", "counter", "queue"])
def test_apply_rung_matches_reference(kind, rung, greedy, monkeypatch):
    monkeypatch.setenv("JGRAFT_GREEDY_CERTIFY", greedy)
    m, rm = MODELS[KINDS[kind]](), REF_MODELS[KINDS[kind]]()
    rows = _mixed(kind, 13, 10, 40) + ([STALE_READ, MONOTONIC_WRITES]
                                      if kind == "register" else [])
    encs = [encode_history(build_history(r), m) for r in rows]
    ref_encs = [ref_enc(_ref_history(r), rm) for r in rows]
    out, certified, tiers = cons.apply_rung(encs, m, rung)
    r_out, r_cert, r_tiers = ref_cons.apply_rung(ref_encs, rm, rung)
    assert (certified, tiers) == (r_cert, r_tiers)
    for a, b in zip(out, r_out):
        assert a.events.tobytes() == b.events.tobytes()
    assert any(certified) == (greedy == "1")


def _compare(rows_list, model_name, rung, **kw):
    m, rm = MODELS[model_name](), REF_MODELS[model_name]()
    ours = check_histories([build_history(r) for r in rows_list], m,
                           device="cpu", consistency=rung, **kw)
    theirs = ref_check([_ref_history(r) for r in rows_list], rm,
                       consistency=rung, **kw)
    assert [_view(r) for r in ours] == [_view(r) for r in theirs]
    return ours


def test_same_process_stale_read_is_refuted_by_cycle():
    [r] = _compare([STALE_READ], "cas-register", "sequential")
    assert (r["valid?"], r["algorithm"], r["decided-tier"]) == \
        (False, "cycle", "cycle")
    assert r["exact-sc-refutation"] is True and len(r["cycle"]) >= 2


def test_stale_read_without_cheap_tiers(monkeypatch):
    monkeypatch.setenv("JGRAFT_CYCLE_TIER", "0")
    monkeypatch.setenv("JGRAFT_GREEDY_CERTIFY", "0")
    [r] = _compare([STALE_READ], "cas-register", "sequential")
    assert r["valid?"] is False and r["algorithm"] != "cycle"


def test_monotonic_writes_pass_session_with_sc_evidence():
    [ses] = _compare([MONOTONIC_WRITES], "cas-register", "session")
    assert ses["valid?"] is True and ses["sc-refuted"] is True
    [seq] = _compare([MONOTONIC_WRITES], "cas-register", "sequential")
    assert seq["valid?"] is False and seq["algorithm"] == "cycle"


@pytest.mark.parametrize("knobs", ["on", "off"])
@pytest.mark.parametrize("rung", ["sequential", "session"])
def test_ablation_matrix_matches_reference(rung, knobs, monkeypatch):
    if knobs == "off":
        for k in ABLATION:
            monkeypatch.setenv(k, "0")
    rs = _compare(_matrix() + [STALE_READ, MONOTONIC_WRITES],
                  "cas-register", rung)
    assert {r["valid?"] for r in rs} == {True, False}


def test_ablation_verdicts_identical_on_and_off(monkeypatch):
    m = MODELS["cas-register"]()
    hs = [build_history(r) for r in _matrix()]

    def verdicts():
        return [r["valid?"] for rung in ("sequential", "session")
                for r in check_histories(hs, m, device="cpu",
                                         consistency=rung)]

    on = verdicts()
    for k in ABLATION:
        monkeypatch.setenv(k, "0")
    assert verdicts() == on and True in on and False in on


@pytest.mark.parametrize("rung", ["sequential", "session"])
@pytest.mark.parametrize("kind", ["counter", "queue", "set",
                                  "list-append"])
def test_other_models_match_reference(kind, rung):
    _compare(_mixed(kind, 19, 8, 30), KINDS[kind], rung)


def test_cycle_skip_is_stamped_as_reference(monkeypatch):
    monkeypatch.setenv("JGRAFT_CYCLE_MAX_OPS", "2")
    monkeypatch.setenv("JGRAFT_GREEDY_CERTIFY", "0")
    rows = MONOTONIC_WRITES
    for rung in ("sequential", "session"):
        [r] = _compare([rows], "cas-register", rung)
        assert r["cycle-skipped-size"] == 4


def test_rung_rows_skip_the_lin_fast_path(monkeypatch):
    """Rows the rung certifier left undecided re-enter at the
    linearizable rung with the fast path off, and are counted."""
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "1")
    monkeypatch.setenv("JGRAFT_GREEDY_CERTIFY", "0")
    monkeypatch.setenv("JGRAFT_CYCLE_TIER", "0")
    m = MODELS["cas-register"]()
    before = fastpath_counters()
    encs = [encode_history(build_history(r), m) for r in _matrix()]
    rs = check_encoded(encs, m, device="cpu", consistency="sequential")
    after = fastpath_counters()
    assert after["rows_rung_skipped"] - before["rows_rung_skipped"] == \
        len(encs)
    assert after["rows_scanned"] == before["rows_scanned"]
    assert all(r["consistency"] == "sequential" for r in rs)


@pytest.mark.parametrize("rung", ["sequential", "session"])
def test_counterexample_at_a_weak_rung(rung):
    """An INVALID weak-rung verdict carries the reference's
    counterexample, searched on the rung's relaxed stream."""
    rows = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
            (1, "invoke", "read", None), (1, "ok", "read", 1),
            (1, "invoke", "read", None), (1, "ok", "read", 7)]
    m, rm = MODELS["cas-register"](), REF_MODELS["cas-register"]()
    ours = LinearizableChecker(m, device="cpu", consistency=rung).check(
        {}, build_history(rows))
    theirs = RefChecker(rm, consistency=rung).check({}, _ref_history(rows))
    assert ours["valid?"] is False
    for k in ("valid?", "decided-tier", "consistency", "failing-op-index",
              "witness", "counterexample", "minimal-ops"):
        assert ours.get(k) == theirs.get(k), k
    h = build_history(rows)
    assert ce._encode_at_rung(h, m, rung).events.tobytes() == \
        ref_ce._encode_at_rung(_ref_history(rows), rm,
                               rung).events.tobytes()
