"""The port's streaming carry against the reference's.

* `IncrementalEncoder`, for each model family and both settle paths
  (JGRAFT_ENCODE_VECTOR=1 and 0): at random cuts the emitted stream
  equals the reference's encoder's at the same cut; fed to the end it is
  byte-identical to `encode_history(prune=False)`; settlement waits for
  completion; a malformed segment raises ValueError and leaves the
  encoder as it was.
* `CarriedScan` on the plain version: after every feed the carry equals
  the reference's `CarriedScan` carry field for field
  (`interop.carry_fields` against `interop.reference_carry_fields`);
  after the last feed (ok, overflow) equals the one-shot sort scan of
  the whole stream; a corrupted history decides at the first feed whose
  prefix a one-shot scan finds dead and launches nothing after it; a
  backlog past STREAM_FEED_CHUNK events takes several launches; `fits`
  and the MAX_SLOTS bound as the reference's.
* `StreamingCertifier`: `carry_state()`, `certified` and `tier` after
  every feed equal the reference's at the same cuts; the final answer
  equals `certify_encoded` on the whole history; budget 0 and a dead
  certifier behave as the reference's.

Booleans and integers throughout: exact equality.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import consistency as ref_consistency
from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.history import packing as ref_packing
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker.consistency import (
    StreamingCertifier, certify_encoded)
from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
    STREAM_EVENTS_SENTINEL, STREAM_FEED_CHUNK, CarriedScan)
from jepsen_jgroups_raft_tpu_torch.history.ops import Op
from jepsen_jgroups_raft_tpu_torch.history.packing import (
    IncrementalEncoder, encode_history)
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

torch.set_num_threads(1)

KIND = {"register": "cas-register", "counter": "counter", "queue": "queue",
        "set": "set", "list-append": "list-append"}
#: the sort capacity of the carried scans here (the reference's default,
#: 256, is the service's; a smaller C keeps the plain version quick)
C = 64


def _models(kind):
    return MODELS[KIND[kind]](), REF_MODELS[KIND[kind]]()


def _rows(kind, seed, n_ops, n_procs=4, crash_p=0.15, max_crashes=2):
    """A random valid history of `kind` as op dicts (client ops only)."""
    kw = {"value_range": 32} if kind == "set" else {}
    h = random_valid_history(random.Random(seed), kind, n_ops=n_ops,
                             n_procs=n_procs, crash_p=crash_p,
                             max_crashes=max_crashes, **kw)
    return [op.to_dict() for op in h.client_ops()]


def _impossible_register_rows(n_writes=6, tail_writes=2):
    """Valid writes, an impossible read, more valid writes: the violation
    becomes decidable exactly when the read settles."""
    rows = []
    for j in range(n_writes):
        rows += [(0, "invoke", "write", j), (0, "ok", "write", j)]
    rows += [(1, "invoke", "read", None), (1, "ok", "read", -7)]
    for j in range(tail_writes):
        rows += [(2, "invoke", "write", 100 + j),
                 (2, "ok", "write", 100 + j)]
    return [{"process": p, "type": t, "f": f, "value": v}
            for p, t, f, v in rows]


def _corrupt_read(rows, rng):
    """One ok read's value raised by 1000 (outside every domain here)."""
    idx = [j for j, r in enumerate(rows) if r["type"] == "ok"
           and r["f"] == "read" and r["value"] is not None]
    rows = [dict(r) for r in rows]
    j = rng.choice(idx)
    rows[j]["value"] = rows[j]["value"] + 1000
    return rows


def _encode(rows, model):
    """The one-shot encode of op dicts, unpruned (the stream's twin)."""
    return encode_history([Op.from_dict(r) for r in rows], model,
                          prune=False)


def _cuts(n, rng, hi=7):
    lo = 0
    while lo < n:
        k = rng.randrange(1, hi)
        yield lo, min(n, lo + k)
        lo += k


# --------------------------------------------------- incremental encoder


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "scalar"])
@pytest.mark.parametrize("kind", sorted(KIND))
def test_encoder_matches_reference_and_one_shot(kind, vector, monkeypatch):
    """At every random cut the newly settled suffix (events, op_index,
    proc) equals the reference encoder's, and the stream so far is a
    prefix of the one-shot encode; fed to the end it is byte-identical
    to `encode_history(prune=False)` (events, op_index, proc, n_slots,
    n_ops)."""
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    rng = random.Random(len(kind) * 7 + int(vector))
    for trial in range(4):
        m, rm = _models(kind)
        rows = _rows(kind, rng.randrange(1 << 30), rng.randrange(1, 50),
                     n_procs=rng.randrange(1, 5),
                     crash_p=rng.choice([0.0, 0.25]))
        one = _encode(rows, m)
        enc, ref = IncrementalEncoder(m), ref_packing.IncrementalEncoder(rm)
        assert enc._vector == (vector == "1")
        parts = []
        for lo, hi in _cuts(len(rows), rng):
            got = enc.feed(rows[lo:hi])
            want = ref.feed(rows[lo:hi])
            for g, w in zip(got, want):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, w)
            parts.append(got)
            so_far = np.concatenate([p[0] for p in parts])
            np.testing.assert_array_equal(so_far,
                                          one.events[:so_far.shape[0]])
            assert (enc.unsettled, enc.n_slots, enc.n_ops, enc.n_events) \
                == (ref.unsettled, ref.n_slots, ref.n_ops, ref.n_events)
        got, want = enc.feed([], final=True), ref.feed([], final=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        parts.append(got)
        for j, field in enumerate(("events", "op_index", "proc")):
            np.testing.assert_array_equal(
                np.concatenate([p[j] for p in parts]), getattr(one, field),
                err_msg=field)
        assert (enc.n_slots, enc.n_ops, enc.n_events, enc.unsettled) == \
            (one.n_slots, one.n_ops, one.n_events, 0)


def test_settlement_waits_for_completion():
    """An invoke's OPEN is held until its completion is recorded (its
    event's content depends on the outcome), and the events behind an
    unsettled invoke wait with it."""
    m = MODELS["cas-register"]()
    rows = [{"process": 0, "type": "invoke", "f": "write", "value": 1},
            {"process": 1, "type": "invoke", "f": "write", "value": 2},
            {"process": 0, "type": "ok", "f": "write", "value": 1},
            {"process": 1, "type": "ok", "f": "write", "value": 2}]
    enc = IncrementalEncoder(m)
    ev, _, _ = enc.feed(rows[:1])
    assert ev.shape == (0, 5) and enc.unsettled == 1
    ev, _, _ = enc.feed(rows[1:2])
    assert ev.shape[0] == 0 and enc.unsettled == 2
    ev, _, _ = enc.feed(rows[2:3])  # the first OPEN; its FORCE waits
    assert ev.shape[0] == 1 and enc.unsettled == 2
    rest, _, _ = enc.feed(rows[3:])
    assert rest.shape[0] == 3 and enc.unsettled == 0
    np.testing.assert_array_equal(np.concatenate([ev, rest]),
                                  _encode(rows, m).events)


def _state(enc):
    return (enc.consumed, enc.cut, enc.n_ops, enc.n_slots, enc.n_events,
            list(enc._tail), dict(enc._pending), dict(enc._comp))


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "scalar"])
def test_malformed_segment_rejects_atomically(vector, monkeypatch):
    """A double invoke, a stray completion and an unknown op type each
    raise ValueError before anything is ingested — also when the bad row
    follows good ones in its segment — and the encoder takes the next
    good segment as if nothing had happened."""
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    enc = IncrementalEncoder(MODELS["cas-register"]())
    enc.feed([{"process": 0, "type": "invoke", "f": "write", "value": 1}])
    before = _state(enc)
    for bad in (
            [{"process": 0, "type": "invoke", "f": "write", "value": 2}],
            [{"process": 9, "type": "ok", "f": "write", "value": 2}],
            [{"process": 0, "type": "ok", "f": "write", "value": 1},
             {"process": 0, "type": "ok", "f": "write", "value": 1}],
            [{"process": 3, "type": "bogus", "f": "write", "value": 1}]):
        with pytest.raises(ValueError):
            enc.feed(bad)
        assert _state(enc) == before
    ev, _, _ = enc.feed([{"process": 0, "type": "ok", "f": "write",
                          "value": 1}])
    assert ev.shape[0] == 2


# ---------------------------------------------------------- carried scan


def _ref_carry_fields(cs, model):
    rc = cs.carry
    rcn = {"inner": [np.asarray(x) if not isinstance(x, tuple)
                     else tuple(np.asarray(y) for y in x)
                     for x in rc["inner"]],
           "left": np.asarray(rc["left"])}
    return interop.reference_carry_fields("sort", rcn, model)


def _one_shot(events, model, W):
    """(ok, overflow) of the plain one-shot sort scan over every row of
    `events` [B, E, 5] at (W, C), each row's first n_events[b]."""
    ev = torch.from_numpy(np.ascontiguousarray(events, dtype=np.int32))
    return ls.sort_scan_plain(ev, W, C, None, None, model=model)


#: name: (history kind, seed, ops, crash_p); every valid stream ends ok
#: at C
STREAMS = {
    "register": ("register", 11, 40, 0.05),
    "register-impossible": ("register", None, None, None),
    "set": ("set", 12, 30, 0.05),
    "list-append": ("list-append", 13, 24, 0.15),
}


def _stream(name):
    kind, seed, n_ops, crash_p = STREAMS[name]
    m, rm = _models(kind)
    rows = (_impossible_register_rows() if seed is None
            else _rows(kind, seed, n_ops, crash_p=crash_p))
    return m, rm, _encode(rows, m)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_carry_equals_reference_after_every_feed(name):
    """Feeds of 1..8 events: after each, the carry's every field
    (frontier, slot registers, ok, overflow, dirty, left from the
    sentinel) equals the reference's `CarriedScan` carry, and so do the
    flags, the launches and the events fed; after the last feed (ok,
    overflow) equals the one-shot plain sort scan of the whole stream."""
    m, rm, enc = _stream(name)
    cs = CarriedScan(m, enc.n_slots, n_configs=C, device="cpu")
    ref = ref_schedule.CarriedScan(rm, enc.n_slots, n_configs=C)
    assert cs.slots_cap == ref.slots_cap
    got = interop.carry_fields("sort", cs.carry, cs.slots_cap, C)
    assert int(got["left"][0]) == STREAM_EVENTS_SENTINEL
    rng = random.Random(len(name))
    for lo, hi in _cuts(enc.n_events, rng, 9):
        cs.feed(enc.events[lo:hi])
        ref.feed(enc.events[lo:hi])
        assert (cs.ok, cs.overflow, cs.launches, cs.fed) == \
            (ref.ok, ref.overflow, ref.launches, ref.fed)
        want = _ref_carry_fields(ref, m)
        got = interop.carry_fields("sort", cs.carry, cs.slots_cap, C)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    ok, of = _one_shot(enc.events[None], m, cs.slots_cap)
    assert (cs.ok, cs.overflow) == (bool(ok[0]), bool(of[0]))
    assert cs.ok == (name != "register-impossible")


def test_corrupted_history_decides_at_its_feed_and_stops():
    """A register history with one read out of its domain, fed in cuts:
    `ok` falls at the first feed whose prefix the one-shot scan finds
    dead, with no overflow, and no feed after it launches (the carry and
    the launch count stay as they were)."""
    rng = random.Random(5)
    m = MODELS["cas-register"]()
    rows = _corrupt_read(_rows("register", 21, 30), rng)
    enc = _encode(rows, m)
    cs = CarriedScan(m, enc.n_slots, n_configs=C, device="cpu")
    cuts = list(_cuts(enc.n_events, rng, 6))
    prefixes = np.zeros((len(cuts), enc.n_events, 5), dtype=np.int32)
    for j, (_, hi) in enumerate(cuts):
        prefixes[j, :hi] = enc.events[:hi]
    ok, of = _one_shot(prefixes, m, cs.slots_cap)
    first_dead = int(np.flatnonzero(~ok.numpy())[0])
    assert not bool(of[first_dead])
    fell, launches_then, carry_then = None, None, None
    for j, (lo, hi) in enumerate(cuts):
        cs.feed(enc.events[lo:hi])
        if fell is None and not cs.ok:
            fell, launches_then = j, cs.launches
            carry_then = cs.carry.clone()
    assert fell == first_dead and cs.decided and not cs.overflow
    assert cs.launches == launches_then
    assert torch.equal(cs.carry, carry_then)
    assert cs.fed == enc.n_events


def test_backlog_takes_several_launches():
    """A stream of more than STREAM_FEED_CHUNK events fed whole is
    scanned in launches of at most STREAM_FEED_CHUNK events, and ends
    with the one-shot scan's (ok, overflow)."""
    m = MODELS["counter"]()
    rows = _rows("counter", 31, 600, n_procs=3, crash_p=0.0)
    enc = _encode(rows, m)
    assert enc.n_events > STREAM_FEED_CHUNK
    cs = CarriedScan(m, enc.n_slots, n_configs=C, device="cpu")
    cs.feed(enc.events)
    assert cs.launches == -(-enc.n_events // STREAM_FEED_CHUNK) >= 2
    ok, of = _one_shot(enc.events[None], m, cs.slots_cap)
    assert (cs.ok, cs.overflow) == (bool(ok[0]), bool(of[0])) == (True,
                                                                   False)


def test_fits_and_max_slots():
    """`fits` and `slots_cap` follow the kernel window buckets as the
    reference's do; a window past MAX_SLOTS raises ValueError."""
    m, rm = _models("register")
    for n in (1, 5, 16, 17, 31, 32, 100, 127):
        cs = CarriedScan(m, n, n_configs=4, device="cpu")
        ref = ref_schedule.CarriedScan(rm, n, n_configs=4)
        assert cs.slots_cap == ref.slots_cap
        for k in (n, cs.slots_cap, cs.slots_cap + 1):
            assert cs.fits(k) == ref.fits(k) == (k <= cs.slots_cap)
    with pytest.raises(ValueError):
        CarriedScan(m, ls.MAX_SLOTS + 1, n_configs=4, device="cpu")
    with pytest.raises(ValueError):
        ref_schedule.CarriedScan(rm, ls.MAX_SLOTS + 1, n_configs=4)


# ---------------------------------------------------- streaming certifier


def _certifier_histories(kind, n=6):
    """Valid histories of `kind`, every third with one read corrupted
    where the history has one."""
    rng = random.Random(len(kind) + 40)
    m = MODELS[KIND[kind]]()
    out = []
    for i in range(n):
        rows = _rows(kind, rng.randrange(1 << 30), 40, crash_p=0.05)
        if i % 3 == 2 and kind in ("register", "counter") and any(
                r["type"] == "ok" and r["f"] == "read"
                and r["value"] is not None for r in rows):
            rows = _corrupt_read(rows, rng)
        out.append(_encode(rows, m))
    return out


@pytest.mark.parametrize("kind", sorted(KIND))
def test_certifier_equals_reference_and_one_shot(kind):
    """At random cuts, after every feed: the return value, `certified`,
    `tier` and `carry_state()` equal the reference's
    `StreamingCertifier`'s; at the end `certified` equals the port's
    `certify_encoded` on the whole history."""
    m, rm = _models(kind)
    rng = random.Random(len(kind))
    decided = set()
    for enc in _certifier_histories(kind):
        sc, ref = StreamingCertifier(m), ref_consistency.StreamingCertifier(rm)
        for lo, hi in _cuts(enc.n_events, rng, 16):
            assert sc.feed(enc.events[lo:hi]) == \
                ref.feed(enc.events[lo:hi])
            assert (sc.certified, sc.tier) == (ref.certified, ref.tier)
            assert sc.carry_state() == ref.carry_state()
        one = certify_encoded(enc, m)[0]
        assert sc.certified == one
        if one:
            assert sc.carry_state()["pos"] == enc.n_events
        decided.add(one)
    assert True in decided


def _backtracking_stream():
    """A register stream the one-shot certifies only by backtracking."""
    m = MODELS["cas-register"]()
    for seed in range(200):
        enc = _encode(_rows("register", seed, 60, crash_p=0.1), m)
        if certify_encoded(enc, m)[1] == "backtrack":
            return enc
    raise AssertionError("no backtracking register stream in 200 seeds")


def test_budget_zero_and_dead_stays_dead():
    """With budget 0 a stream that needs a flip kills the certifier as it
    kills the reference's, at the same feed and in the same carry; a
    dead certifier returns False to every later feed (an empty one too)
    and its carry no longer moves."""
    enc = _backtracking_stream()
    m, rm = _models("register")
    sc = StreamingCertifier(m, budget=0)
    ref = ref_consistency.StreamingCertifier(rm, budget=0)
    rng = random.Random(2)
    died = None
    for j, (lo, hi) in enumerate(_cuts(enc.n_events, rng, 8)):
        got = sc.feed(enc.events[lo:hi])
        assert got == ref.feed(enc.events[lo:hi])
        assert sc.carry_state() == ref.carry_state()
        if not got and died is None:
            died, frozen = j, sc.carry_state()
        if died is not None:
            assert not got and not sc.certified and sc.tier is None
            assert sc.carry_state() == frozen
    assert died is not None
    assert certify_encoded(enc, m, budget=0)[0] is False
    assert sc.feed(enc.events[:0]) is False
    # the default budget certifies the same stream, by backtracking
    full = StreamingCertifier(m)
    for lo, hi in _cuts(enc.n_events, random.Random(2), 8):
        full.feed(enc.events[lo:hi])
    assert full.certified and full.tier == "backtrack"
