"""The CUDA mask kernel's lazy legality schedule, reproduced in numpy and
held to the plain version.

ops/csrc/mask_scan.cu keeps one history's frontier F[2^W] in one warp's
registers (`mask_layout`: bit m at lane (m >> 5) & 31, word m >> 10) and
builds the legality a closure reads lazily: before each sweep, the
32-mask groups (j, g) the frontier holds and that are not built yet in
this closure — named by a ballot over the non-empty frontier words, then
over each sweep's fresh masks — are built for the open slots whose op is
not `always_legal` (one model step per lane and one ballot per slot);
slots whose op is always legal take all-ones legality words, closed ones
zero words. These tests emulate that schedule at its (word,
group, lane) granularity — sums as W column totals, the clipped
columns, summed shared-slot latches, the three kinds of pass, the W + 1
sweep cap, FORCE and retirement — and hold its verdicts bitwise to
`mask_scan_plain`, and its ballots and closing FORCEs to the plain
version's `ballots_lazy` and `closures`, for W = 1..12, both models, both
row formats, arbitrary rows and a counter across 2^31 (the
`always_legal` predicate itself is held to `torch_step` in
tests/test_torch_counter_queue.py). Verdicts and counts are integers:
exact equality.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.history.packing import (encode_history,
                                                           pack_batch,
                                                           pack_macro_batch)
from jepsen_jgroups_raft_tpu_torch.history.synth import (
    offset_counter_history, random_mask_rows, random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import Counter, TicketQueue
from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (mask_layout,
                                                          mask_scan_plain)

torch.set_num_threads(1)

U32 = 0xFFFFFFFF
LOW_HALF = [0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF]
LANES = np.arange(32)
MODELS = {"counter": Counter, "queue": TicketQueue}

# ------------------------------------------------ the kernel's schedule


def _ballot(pred) -> int:
    """32 lanes' predicates as one word, lane i at bit i."""
    return int((np.asarray(pred, dtype=np.uint64)
                << np.arange(32, dtype=np.uint64)).sum())


def _bits(x: int):
    return [i for i in range(32) if x >> i & 1]


def _image(src, w):
    """Slot w's image of the source words [32 lanes, words]: masks
    without bit w moved to m | bit w, by a shift in each word (w < 5), an
    exchange between lanes (`__shfl_xor_sync`, w < 10) or a move between
    register words."""
    out = np.zeros_like(src)
    if w < 5:
        out = (src & np.uint32(LOW_HALF[w])) << np.uint32(1 << w)
    elif w < 10:
        d = 1 << (w - 5)
        dst = (LANES & d) != 0
        out[dst] = src[LANES ^ d][dst]
    else:
        d = 1 << (w - 10)
        for j in range(src.shape[1]):
            if not j & d:
                out[:, j | d] = src[:, j]
    return out


def _force(F, w):
    """FORCE of slot w: (F', some survivor)."""
    F = F.copy()
    if w < 5:
        lo = np.uint32(LOW_HALF[w])
        live = F & ~lo
        F = (F >> np.uint32(1 << w)) & lo
    elif w < 10:
        d = 1 << (w - 5)
        has = (LANES & d) != 0
        live = F[has]
        F = np.where(has[:, None], np.uint32(0), F[LANES ^ d])
    else:
        d = 1 << (w - 10)
        live = [np.zeros(32, np.uint32)]
        for j in range(F.shape[1]):
            if not j & d:
                live.append(F[:, j | d].copy())
                F[:, j] = F[:, j | d]
                F[:, j | d] = 0
        live = np.stack(live)
    return F, bool(live.any())


def _i32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x >> 31 else x


def emulate(rows, n_rows, W, macro_p, model):
    """One history through the kernel's schedule. Returns (ok, counts):
    closing FORCEs, sweeps, groups built and ballots while alive."""
    lay = mask_layout(W)
    M, words = 1 << W, lay.words
    P = int(macro_p or 0)
    first = 3 if P else 1
    rows = np.asarray(rows, dtype=np.int64)
    pay = rows[:, first:first + 4 * max(P, 1)].reshape(len(rows), -1, 4)
    deltas = model.mask_delta(*(torch.from_numpy(pay[:, :, k].astype(
        np.int32)) for k in (1, 2, 3))).to(torch.int64).numpy()
    F = np.zeros((32, words), np.uint32)
    F[0, 0] = 1
    sf, sa, sb = [0] * W, [0] * W, [0] * W
    sdelta, col, sopen = [0] * W, [0] * W, [False] * W
    base = int(model.init_state()) & U32
    dirty, ok = False, True
    counts = dict(closures=0, sweeps=0, groups=0, ballots=0)
    for e in range(n_rows):
        kind, fslot = int(rows[e, 0]), int(rows[e, 1])
        n = min(max(int(rows[e, 2]), 0), P) if P else int(kind == 1)
        if n > 0:  # latch, lane c < W
            dirty = True
            for c in range(W):
                dx = nd = nf = na = nb = 0
                hit = False
                for p in range(n):
                    q = int(pay[e, p, 0])
                    if min(max(q, 0), W - 1) != c:
                        continue
                    d = int(deltas[e, p]) & U32
                    if q == c:
                        hit = True
                        dx += d - sdelta[c]
                        nd += d
                        nf, na, nb = (nf + int(pay[e, p, 1]),
                                      na + int(pay[e, p, 2]),
                                      nb + int(pay[e, p, 3]))
                    else:
                        dx += d
                col[c] = (col[c] + dx) & U32
                if hit:
                    sf[c], sa[c], sb[c] = _i32(nf), _i32(na), _i32(nb)
                    sdelta[c], sopen[c] = nd & U32, True
        if kind != 2:
            continue
        if dirty:
            F = _closure(F, W, M, words, base, col, sf, sa, sb, sopen,
                         model, counts)
            dirty = False
        w = min(max(fslot, 0), W - 1)
        F, ok = _force(F, w)
        if 0 <= fslot < W:
            base = (base + sdelta[fslot]) & U32
            col[fslot] = (col[fslot] - sdelta[fslot]) & U32
            sdelta[fslot], sopen[fslot] = 0, False
        if not ok:
            break
    return ok, counts


def _closure(F, W, M, words, base, col, sf, sa, sb, sopen, model, counts):
    """A closing FORCE's closure with legality built lazily per group:
    words all ones for an always-legal slot, zero for a closed one, built
    for the others when their group first holds a mask."""
    f = torch.tensor(sf, dtype=torch.int32)
    always = (model.always_legal(f) & torch.tensor(sopen)).tolist()
    need = [w for w in range(W) if sopen[w] and not always[w]]
    lo = [(base + sum(col[c] for c in range(min(W, 5)) if lane >> c & 1))
          & U32 for lane in range(32)]
    hi = [sum(col[c] for c in range(10, W) if j >> (c - 10) & 1)
          for j in range(words)]
    L = np.zeros((W, 32, words), np.uint32)
    L[[w for w in range(W) if always[w]]] = np.uint32(U32)
    built = [0] * words
    grow = [_ballot(F[:, j] != 0) for j in range(words)]
    counts["closures"] += 1
    for _ in range(W + 1):
        for j in range(words):
            todo = grow[j] & ~built[j] if need else 0
            built[j] |= todo
            for g in _bits(todo):
                mid = sum(col[c] for c in range(5, min(W, 10))
                          if g >> (c - 5) & 1)
                st = torch.tensor([_i32(x + hi[j] + mid) for x in lo],
                                  dtype=torch.int32)[:, None]
                lg = model.torch_step(
                    st, f[need][None, :],
                    torch.tensor([sa[w] for w in need],
                                 dtype=torch.int32)[None, :],
                    torch.tensor([sb[w] for w in need],
                                 dtype=torch.int32)[None, :])[1]
                lg = lg & torch.from_numpy(LANES < M)[:, None]
                for k, w in enumerate(need):
                    L[w, g, j] = _ballot(lg[:, k].numpy())
                counts["groups"] += 1
                counts["ballots"] += len(need)
        add = np.zeros_like(F)
        for w in range(W):
            add |= _image(F & L[w], w)
        grow = [_ballot((add[:, j] & ~F[:, j]) != 0) for j in range(words)]
        F = F | add
        counts["sweeps"] += 1
        if not any(grow):
            break
    return F


def _check(ev, n_events, W, P, model):
    """Emulation vs plain version: verdicts bitwise, ballots and closing
    FORCEs equal to the plain version's counts. Returns the verdicts."""
    stats: dict = {}
    plain = mask_scan_plain(torch.from_numpy(ev), W, P,
                            torch.from_numpy(n_events), model=model,
                            stats=stats).tolist()
    oks, total = [], dict(closures=0, ballots=0, groups=0)
    for h in range(len(ev)):
        ok, c = emulate(ev[h], int(n_events[h]), W, P, model)
        oks.append(ok)
        for k in total:
            total[k] += c[k]
    assert oks == plain
    assert total["closures"] == stats["closures"]
    assert total["ballots"] == stats["ballots_lazy"]
    # the lazy build never exceeds the reference's full tables (one
    # ballot per 32 masks, or per slot below W = 5)
    assert total["ballots"] * min(1 << W, 32) <= stats["legal_steps"]
    return plain


def _bump(h, rng):
    """One ok observation raised by 1000 (beyond what crashed ops could
    explain)."""
    h = list(h)
    idx = [j for j, op in enumerate(h) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = h[j].value
        h[j] = h[j].replace(value=(v[0], v[1] + 1000)
                            if isinstance(v, tuple) else v + 1000)
    return h


def _window_histories(kind, W, n, n_ops, seed, n_procs=None, model=None):
    """n histories with windows up to W, the first exactly W (up to 5
    processes and crashed ops, or `n_procs` processes at crash_p 0.05 and
    at most 3 crashes); odd ones with one observation bumped."""
    rng = random.Random(seed)
    model = model or MODELS[kind]()
    if n_procs is None:
        n_procs, crashes = min(W, 5), max(W - 5, 0)
        crash_p = 0.5 if crashes else 0.0
    else:
        crashes, crash_p = 3, 0.05
    top, rest = None, []
    while top is None or len(rest) < n - 1:
        h = random_valid_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                                 crash_p=crash_p, max_crashes=crashes)
        w = encode_history(h, model).n_slots
        if w == W and top is None:
            top = h
        elif w <= W and len(rest) < n - 1:
            rest.append(h)
    return [_bump(h, rng) if i % 2 else h for i, h in enumerate([top] + rest)]


def _batch(hists, model, macro):
    encs = [encode_history(h, model) for h in hists]
    b = pack_macro_batch(encs) if macro else pack_batch(encs)
    return b["events"], b["n_events"], b.get("macro_p")


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", range(1, 13), ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind", list(MODELS))
def test_schedule_matches_plain_every_window(kind, W, macro):
    model = MODELS[kind]()
    ev, ne, P = _batch(_window_histories(kind, W, 6, 30, 40 * W + macro),
                       model, macro)
    ok = _check(ev, ne, W, P, model)
    assert 0 < sum(ok) < len(ok)  # both polarities


@pytest.mark.parametrize("W", [10, 11, 12], ids=lambda w: f"W{w}")
def test_schedule_matches_plain_ten_processes(W):
    """Upstream's documented concurrency (10 processes): the windows the
    mask cap's top end sees, with many always-legal adds open."""
    model = Counter()
    ev, ne, P = _batch(_window_histories("counter", W, 4, 60, 900 + W,
                                         n_procs=10), model, True)
    ok = _check(ev, ne, W, P, model)
    assert 0 < sum(ok) < len(ok)


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
def test_schedule_counter_across_int32_boundary(macro):
    """A counter started 40 below 2^31 crosses into negative states."""
    offset = 2**31 - 40
    model = Counter(offset)
    encs = [encode_history(offset_counter_history(h, offset), model)
            for h in _window_histories("counter", 7, 6, 60, 31)]
    assert any(((e.events[:, 2] == 0) & (e.events[:, 3] < 0)).any()
               for e in encs)  # a read observed a wrapped value
    b = pack_macro_batch(encs) if macro else pack_batch(encs)
    ok = _check(b["events"], b["n_events"], 7, b.get("macro_p"), model)
    assert 0 < sum(ok) < len(ok)


@pytest.mark.parametrize("P", [None, 3, 16], ids=["legacy", "P3", "P16"])
@pytest.mark.parametrize("W", [1, 6, 12], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind,init", [("counter", 0), ("queue", 0),
                                       ("counter", 2**31 - 3)],
                         ids=["counter", "queue", "counter_near_2^31"])
def test_schedule_matches_plain_on_arbitrary_rows(kind, init, W, P):
    """Rows the packer never emits: slots out of range (the clipped
    column), payloads sharing a slot (summed f, so the always-legal
    predicate reads summed opcodes), unknown opcodes, int32 edges."""
    model = Counter(init) if kind == "counter" else TicketQueue()
    rng = np.random.default_rng(1000 * W + (P or 0))
    B, E = 24, 24
    ev = random_mask_rows(rng, B, E, W, P, kind)
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0
    ok = _check(ev, n_events, W, P, model)
    assert any(ok) and not all(ok)


def test_emulated_passes_follow_the_mask_layout():
    """The emulation's images and FORCE move mask m to where
    `mask_layout` keeps m | bit w, and nothing else."""
    for W in (3, 7, 12):
        lay = mask_layout(W)
        for w in range(W):
            for m in (0, 5, (1 << W) - 1 - (1 << w)):
                if m >> w & 1:
                    continue
                F = np.zeros((32, lay.words), np.uint32)
                lane, word, bit = lay.locate(m)
                F[lane, word] = np.uint32(1 << bit)
                got = _image(F, w)
                lane2, word2, bit2 = lay.locate(m | 1 << w)
                want = np.zeros_like(F)
                want[lane2, word2] = np.uint32(1 << bit2)
                assert np.array_equal(got, want)
                back, alive = _force(got, w)
                assert alive and np.array_equal(back, F)
