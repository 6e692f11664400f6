"""The port's segmented long-history scan (B6) against the reference's
ops/segment_scan.py: the planner (cuts, plans, segment arrays), the
plain version's final frontiers against the reference's
`make_segment_kernel` bit for bit, `check_segmented_batch`'s verdicts,
segments and basis, the batch shed loop, and the routing through
`check_histories` under JGRAFT_SEGMENT=1. The port runs on
device="cpu", where the planner keeps the reference's CPU cell budget;
the reference on JAX's CPU. Exact equality."""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu.ops import segment_scan as ref_ss
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import check_histories
from jepsen_jgroups_raft_tpu_torch.checker.wgl_cpu import check_encoded_cpu
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import (build_history,
                                                         random_segment_rows,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss

torch.set_num_threads(1)


def _corrupt_read(rng, h, delta=1):
    """delta=1 may or may not break linearizability; delta=10 leaves the
    synthesizer's value range, so the history is INVALID."""
    ops = list(h)
    reads = [j for j, op in enumerate(ops) if op.type == "ok"
             and op.f == "read" and op.value is not None]
    if reads:
        j = rng.choice(reads)
        ops[j] = ops[j].replace(value=ops[j].value + delta)
    return ops


def _register_batch(seed=42, n=10, n_ops=300):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = random_valid_history(rng, "register", n_ops=n_ops, n_procs=4,
                                 crash_p=0.03, max_crashes=3)
        out.append(_corrupt_read(rng, h) if i % 2 else list(h))
    return out


def _crash_spanning(read):
    """A crashed write whose value is read far downstream, with 100
    quiescent single-op rounds between: the crashed slot spans every
    segment boundary."""
    rows = [(0, "invoke", "write", 7), (0, "info", "write", 7)]
    for _ in range(100):
        rows += [(1, "invoke", "write", 1), (1, "ok", "write", 1)]
    rows += [(2, "invoke", "read", None), (2, "ok", "read", read)]
    return build_history(rows)


def test_planner_equals_reference():
    m, rm = CasRegister(), RefReg()
    hs = _register_batch(seed=7, n=6) + [_crash_spanning(7)]
    for h in hs:
        enc, renc = encode_history(h, m), ref_enc(h, rm)
        assert ss.find_cuts(enc.events) == ref_ss.find_cuts(renc.events)
        assert np.array_equal(ss._live_opens(enc.events),
                              ref_ss._live_opens(renc.events))
        for block in (20, 40, 1536):
            p = ss.plan_segments(m, enc, block, 0, device="cpu")
            q = ref_ss.plan_segments(rm, renc, block, 0)
            assert (p is None) == (q is None)
            if p is None:
                continue
            assert np.array_equal(p.starts, q.starts)
            assert np.array_equal(p.ends, q.ends)
            assert (p.crash_sets, p.open_rows) == (q.crash_sets, q.open_rows)
            assert (p.n_slots, p.n_states) == (q.n_slots, q.n_states)
            assert np.array_equal(p.val_of, q.val_of)
            E = ss._pow2(int((p.ends - p.starts).max()) + 4)
            ours = ss._build_segment_arrays(enc, p, E, 64, 8)
            theirs = ref_ss._build_segment_arrays(renc, q, E, 64, 8)
            for a, b in zip(ours[:3], theirs[:3]):
                assert np.array_equal(a, b)
            assert ours[3] == theirs[3]


def test_cut_free_stream_falls_back():
    """Two processes whose ops always overlap: no quiescent boundary but
    the stream's ends, so no plan in either package."""
    m, rm = CasRegister(), RefReg()
    rows, open_val = [(0, "invoke", "write", 1)], {0: 1}
    for i in range(50):
        p, q = i % 2, 1 - i % 2
        v = (i + 1) % 3
        rows += [(q, "invoke", "write", v), (p, "ok", "write", open_val[p])]
        open_val[q] = v
    h = build_history(rows)
    enc = encode_history(h, m)
    positions, _, _ = ss.find_cuts(enc.events)
    assert positions == ref_ss.find_cuts(ref_enc(h, rm).events)[0]
    assert all(p in (0, enc.n_events) for p in positions)
    assert ss.plan_segments(m, enc, 10, 0, device="cpu") is None


def _reference_tables(W, S, events, val_of, seed_mask, seed_state):
    kernel = ref_ss._segment_kernel(RefReg(), W, S, events.shape[1])
    return np.asarray(kernel(events, val_of, seed_mask, seed_state))


@pytest.mark.parametrize("W,S,n_crashed", [(2, 4, 1), (4, 2, 3), (6, 4, 2),
                                           (5, 1, 0)])
def test_plain_tables_equal_the_reference_kernel(W, S, n_crashed):
    """Arbitrary segments (crashed slots OPENed in the prologue, strays),
    the full basis of their crash set, dead seeds (-1) and a seed mask
    beyond the frontier: every bit of F equal. The reference kernel has
    no real lengths (it scans every row), so a PAD tail carries them."""
    K, E = 5, 48
    rng = np.random.default_rng(W * 10 + n_crashed)
    vals = rng.integers(-2, 3, size=(K, S)).astype(np.int32)
    vals[:, S - S // 2:] = vals[:, :1]
    ev = random_segment_rows(rng, K, E, W, vals, n_crashed)
    n_ev = rng.integers(E // 2, E + 1, size=K).astype(np.int32)
    for k in range(K):
        ev[k, n_ev[k]:] = 0                      # EV_PAD tail
    basis = [(sub, s) for sub in range(1 << n_crashed) for s in range(S)]
    NB = len(basis) + 3
    sm = np.full((K, NB), -1, dtype=np.int32)
    st = np.zeros((K, NB), dtype=np.int32)
    for b, (mask, s) in enumerate(basis):
        sm[:, b], st[:, b] = mask, s
    sm[:, -1] = 1 << W
    theirs = _reference_tables(W, S, ev, vals, sm, st)
    stats: dict = {}
    ours = ss.segment_scan_plain(*(torch.from_numpy(a) for a in
                                   (ev, vals, sm, st)), W,
                                 torch.from_numpy(n_ev), stats=stats)
    assert ours.shape == (K, NB, 1 << W, S) and ours.dtype == torch.bool
    assert np.array_equal(ours.numpy(), theirs)
    assert theirs.any() and not theirs[:, -3:].any()
    assert stats["force_rows"] > 0 and stats["sweeps"] > 0
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(ss.segment_scan(*(torch.from_numpy(a) for a in
                                         (ev, vals, sm, st)), W,
                                       torch.from_numpy(n_ev)), ours)


# ------------------------------------------- the kernel's closure schedule
# ops/csrc/segment_scan.cu closes a frontier by Jacobi sweeps (every open
# slot's image of the frontier the sweep starts from), the reference by
# in-order sweeps (slot w from the frontier slots < w updated). The
# model below runs both on the same rows in numpy, holds each to the
# reference's tables and counts their sweeps.

def _image(X, T, w):
    """Slot w's image of frontiers X [B, M, S]: every mask m without bit w
    through T[w] into m | bit w."""
    M = X.shape[1]
    src = np.array([m for m in range(M) if not (m >> w) & 1])
    out = np.zeros_like(X)
    out[:, src | (1 << w)] = np.einsum("bms,st->bmt", X[:, src].astype(
        np.int64), T[w].astype(np.int64)) > 0
    return out


def _close(F, T, open_, W, schedule, stats, active):
    """Close F [B, M, S] under the open slots, at most W + 1 sweeps, a run
    sweeping while its last sweep changed it; count sweeps per run in
    `stats` (runs in `active` only)."""
    slots = [w for w in range(W) if (open_ >> w) & 1]
    cont = active.copy()
    for _ in range(W + 1):
        before = F.copy()
        if schedule == "jacobi":
            add = np.zeros_like(F)
            for w in slots:
                add |= _image(F, T, w)
            F |= add
        else:  # the reference's sweep: slot w from the updated frontier
            for w in slots:
                F |= _image(F, T, w)
        stats["sweeps"] += int(cont.sum())
        cont &= (F != before).reshape(len(F), -1).any(axis=1)
        if not cont.any():
            break
    return F


def _schedule_tables(W, S, ev, vals, sm, st, n_ev, schedule):
    """The seeded scan of every (segment, seed) with closures run by
    `schedule` ("jacobi" or "reference"): (F [K, NB, 2^W, S], stats:
    closures and sweeps over live runs)."""
    m = CasRegister()
    K, NB = sm.shape
    M = 1 << W
    out = np.zeros((K, NB, M, S), dtype=bool)
    stats = {"closures": 0, "sweeps": 0}
    for k in range(K):
        F = np.zeros((NB, M, S), dtype=bool)
        ok = (sm[k] >= 0) & (sm[k] < M) & (st[k] >= 0) & (st[k] < S)
        F[np.flatnonzero(ok), sm[k][ok], st[k][ok]] = True
        T = np.zeros((W, S, S), dtype=bool)
        vo = torch.from_numpy(vals[k][None].astype(np.int32))
        open_ = 0
        dirty = False
        for e in range(int(n_ev[k])):
            kind, slot, f, a, b = (int(x) for x in ev[k, e])
            if kind == 1:
                dirty = True
                if 0 <= slot < W:
                    ns, legal = m.torch_step(vo, *(torch.tensor([[x]])
                                                   for x in (f, a, b)))
                    T[slot] = ((ns[0][:, None] == vo[0][None, :])
                               & legal[0][:, None]).numpy()
                    open_ |= 1 << slot
            elif kind == 2:
                live = F.reshape(NB, -1).any(axis=1)
                if dirty:
                    stats["closures"] += int(live.sum())
                    F = _close(F, T, open_, W, schedule, stats, live)
                    dirty = False
                w = min(max(slot, 0), W - 1)
                has = (np.arange(M) >> w) & 1 == 1
                G = np.zeros_like(F)
                G[:, ~has] = F[:, np.arange(M)[~has] | (1 << w)]
                F = G
                if 0 <= slot < W:
                    open_ &= ~(1 << slot)
        out[k] = F
    return out, stats


@pytest.mark.parametrize("W,S,n_crashed", [(2, 4, 1), (4, 2, 3), (6, 4, 2),
                                           (5, 1, 0), (7, 4, 2)])
def test_closure_schedules_give_the_reference_tables(W, S, n_crashed):
    """The kernel's Jacobi sweeps and the reference's in-order sweeps
    reach the reference `make_segment_kernel`'s tables on seeded random
    segments (stray rows included: a FORCE on a clipped slot that stays
    open); in-order sweeps never need more of them than Jacobi's."""
    K, E = 5, 96
    rng = np.random.default_rng(W * 100 + S * 10 + n_crashed)
    from jepsen_jgroups_raft_tpu_torch.history.synth import \
        random_segment_inputs
    ev, vals, sm, st, n_ev = random_segment_inputs(
        rng, K, E, W, S, n_crashed, bad_read=0.002, stray=0.02)
    for k in range(K):
        ev[k, n_ev[k]:] = 0                      # EV_PAD tail
    theirs = _reference_tables(W, S, ev, vals, sm, st)
    stats = {}
    for schedule in ("jacobi", "reference"):
        ours, stats[schedule] = _schedule_tables(W, S, ev, vals, sm, st,
                                                 n_ev, schedule)
        assert np.array_equal(ours, theirs), schedule
    jac, ref = stats["jacobi"], stats["reference"]
    assert jac["closures"] == ref["closures"] > 0
    assert jac["sweeps"] >= ref["sweeps"] >= jac["closures"]
    assert theirs.any()


def test_segment_shape_is_a_function_of_the_shape():
    """Runs a warp from the frontier's width (32 lanes from 2^10 bits
    on), warps a CTA up to SEGMENT_MAX_WARPS, CTAs a segment to cover
    every seed — config 5's shape (W = 7, S = 4, NB = 16) is one CTA of 8
    warps holding two runs each."""
    f = ss.segment_shape
    assert f(7, 4, 16) == ss.SegmentShape(2, 8, 1)
    assert f(9, 4, 64) == (1, 8, 8)
    assert f(3, 1, 1) == (32, 1, 1)
    assert f(10, 8, 256) == (1, 8, 32)
    assert f(5, 4, 1) == (8, 1, 1)
    assert f(7, 4, 0) == (2, 1, 1)
    for W in range(1, 11):
        for S in (1, 2, 3, 4, 8, 16):
            if (1 << W) * S > 8192:
                continue
            for NB in (1, 5, 16, 64, 256):
                per, warps, ctas = f(W, S, NB)
                bits = W + ss.dense_layout(W, S).field_log2
                assert per * max(1 << max(bits - 5, 0), 1) == 32 \
                    if bits < 10 else per == 1
                assert 1 <= warps <= ss.SEGMENT_MAX_WARPS
                assert ctas * warps * per >= NB > (ctas - 1) * warps * per


def test_plain_tables_of_planned_histories_equal_the_reference():
    """Real plans: crash sets of 1-3 slots that span segment boundaries,
    the batch's padded basis and PAD tails, as check_segmented_batch
    lays them out."""
    m, rm = CasRegister(), RefReg()
    rng = random.Random(3)
    seen = set()
    for _ in range(12):
        h = random_valid_history(rng, "register", n_ops=200, n_procs=3,
                                 crash_p=0.1, max_crashes=3)
        enc = encode_history(h, m)
        p = ss.plan_segments(m, enc, 30, 0, device="cpu")
        if p is None:
            continue
        c = max(len(cs) for cs in p.crash_sets)
        seen.add(c)
        S, W = p.n_states, p.n_slots
        NB = ss._pow2((1 << c) * S)
        E = ss._pow2(int((p.ends - p.starts).max()) + c)
        ev, sm, st, _ = ss._build_segment_arrays(enc, p, E, NB, S)
        vals = np.tile(p.val_of[None], (len(ev), 1)).astype(np.int32)
        theirs = _reference_tables(W, S, ev, vals, sm, st)
        ours = ss.segment_scan_plain(
            *(torch.from_numpy(a) for a in (ev, vals, sm, st)), W,
            torch.from_numpy(ss.segment_lengths(p)))
        assert np.array_equal(ours.numpy(), theirs)
    assert {1, 2} <= seen


def test_segmented_batch_equals_reference():
    m, rm = CasRegister(), RefReg()
    hs = _register_batch()
    encs = [encode_history(h, m) for h in hs]
    ours = ss.check_segmented_batch(encs, m, block_events=40, min_events=0,
                                    device="cpu")
    theirs = ref_ss.check_segmented_batch([ref_enc(h, rm) for h in hs], rm,
                                          block_events=40, min_events=0)
    assert ours == theirs
    for enc, r in zip(encs, ours):
        assert r is not None and r["segments"] > 1
        assert r["valid"] is check_encoded_cpu(enc, m).valid
    assert {r["valid"] for r in ours} == {True, False}


@pytest.mark.parametrize("read,valid", [(7, True), (9, False)])
def test_crash_ambiguity_spans_segments(read, valid):
    m = CasRegister()
    enc = encode_history(_crash_spanning(read), m)
    r = ss.check_segmented(enc, m, block_events=20, min_events=0,
                           device="cpu")
    [t] = ref_ss.check_segmented_batch([ref_enc(_crash_spanning(read),
                                                RefReg())], RefReg(),
                                       block_events=20, min_events=0)
    assert r == t and r["segments"] > 2 and r["valid"] is valid


def test_batch_recheck_sheds_blown_bases():
    """A tiny-domain many-crash history passes its own gate, but at the
    batch S a wide-domain partner brings it past the CPU cell budget:
    both packages shed the same rows to the monolithic path."""
    m, rm = CasRegister(), RefReg()
    rng = random.Random(38)
    a = random_valid_history(rng, "register", n_ops=400, n_procs=4,
                             value_range=3, crash_p=0.25, max_crashes=3)
    b = random_valid_history(rng, "register", n_ops=400, n_procs=4,
                             value_range=14, crash_p=0.0)
    ours = ss.check_segmented_batch([encode_history(a, m),
                                     encode_history(b, m)], m,
                                    block_events=40, min_events=0,
                                    device="cpu")
    theirs = ref_ss.check_segmented_batch([ref_enc(a, rm), ref_enc(b, rm)],
                                          rm, block_events=40, min_events=0)
    assert ours == theirs
    assert any(r is None for r in ours)


def test_check_histories_routes_long_rows_under_the_knob(monkeypatch):
    """JGRAFT_SEGMENT=1: a long history and its corrupted twin report
    "dense-seg", their segments, and the reference's verdicts; unset, a
    CPU device routes nothing (the dense plans take them)."""
    rng = random.Random(9)
    h = random_valid_history(rng, "register", n_ops=5600, n_procs=3,
                             crash_p=0.01, max_crashes=1)
    hs = [list(h), _corrupt_read(rng, h, delta=10)]
    m = CasRegister()
    assert encode_history(hs[0], m).n_events >= ss.LONG_HISTORY_MIN_EVENTS
    monkeypatch.setenv("JGRAFT_SEGMENT", "1")
    ours = check_histories(hs, m, device="cpu")
    theirs = ref_check(hs, RefReg())
    assert [r["valid?"] for r in ours] == [r["valid?"] for r in theirs] \
        == [True, False]
    for r, t in zip(ours, theirs):
        assert (r["kernel"], r["decided-tier"], r["segments"]) == \
            (t["kernel"], t["decided-tier"], t["segments"])
        assert r["kernel"] == "dense-seg" and r["segments"] > 1
    monkeypatch.delenv("JGRAFT_SEGMENT")
    plain = check_histories(hs, m, device="cpu")
    assert [(r["valid?"], r["kernel"]) for r in plain] == \
        [(True, "dense"), (False, "dense")]


def test_routing_default_by_device_and_knob(monkeypatch):
    """Unset, the card routes up to SEGMENT_MAX_LONG_ROWS long rows (the
    measured default) and a CPU device none; JGRAFT_SEGMENT=1 / any other
    value forces it on / off, as in the reference."""
    from jepsen_jgroups_raft_tpu_torch.checker import linearizable as lin

    monkeypatch.delenv("JGRAFT_SEGMENT", raising=False)
    cap = lin.SEGMENT_MAX_LONG_ROWS
    assert lin._segment_routing_on(1, "cuda") is True
    assert lin._segment_routing_on(cap, "cuda") is True
    assert lin._segment_routing_on(cap + 1, "cuda") is False
    assert lin._segment_routing_on(1, "cpu") is False
    for value, want in (("1", True), ("0", False), ("yes", False)):
        monkeypatch.setenv("JGRAFT_SEGMENT", value)
        assert lin._segment_routing_on(cap + 1, "cuda") is want
        assert lin._segment_routing_on(1, "cpu") is want
