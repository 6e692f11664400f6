"""The CUDA dense-scan kernel's register layout, reproduced in numpy and
held to the plain version.

ops/csrc/dense_scan.cu keeps one history's frontier F[2^W, S] in one
warp's registers, placed by `ops.dense_scan.dense_layout(W, S)` — the
function the wrapper itself uses to pick the kernel's template. These
tests pack a seeded random frontier into that layout (32 lanes ×
`words` uint32), run one closure sweep and one FORCE through the
kernel's three kinds of pass — a shift inside each word, an exchange
between lanes (what `__shfl_xor_sync` does), a move between register
words — with the kernel's bit-plane transform, and compare with the
plain version's `dense_sweep_fn` and `force_arith`, for every (W, S)
inside the caps. The kernel's closure — sweeps that OR in every open
slot's image of the same frontier — must reach the plain version's
`closure_fixpoint`. Exact equality: the frontier is bits.
"""

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (dense_layout,
                                                          dense_sweep_fn)
from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import (DENSE_MAX_CELLS,
                                                         DENSE_MAX_SLOTS,
                                                         DENSE_MAX_STATES,
                                                         closure_fixpoint,
                                                         force_arith)

torch.set_num_threads(1)

#: The kernel's constants: bits of a word whose position has bit p clear
#: (`low_half`), and bit 0 of every 2^LF-bit field (`field_unit`).
LOW_HALF = [0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF]
FIELD_UNIT = [0xFFFFFFFF, 0x55555555, 0x11111111, 0x01010101, 0x00010001]
LANES = np.arange(32)

CAPS = [(W, S) for W in range(1, DENSE_MAX_SLOTS + 1)
        for S in range(1, DENSE_MAX_STATES + 1)
        if (1 << W) * S <= DENSE_MAX_CELLS]


def _positions(layout, M, S):
    """(lane, word, bit) arrays of every frontier bit (m, s), [M, S]."""
    m, s = np.meshgrid(np.arange(M), np.arange(S), indexing="ij")
    b = (m << layout.field_log2) | s
    return (b >> 5) & 31, b >> 10, b & 31


def pack(layout, F):
    M, S = F.shape
    lane, word, bit = _positions(layout, M, S)
    regs = np.zeros((32, layout.words), np.uint32)
    np.bitwise_or.at(regs, (lane[F], word[F]),
                     (np.uint32(1) << bit[F].astype(np.uint32)))
    return regs


def unpack(layout, regs, M, S):
    lane, word, bit = _positions(layout, M, S)
    return ((regs[lane, word] >> bit.astype(np.uint32)) & 1).astype(bool)


def apply_rows(layout, x, t):
    """Every field of the words x mapped through one slot's rows t."""
    unit = np.uint32(FIELD_UNIT[layout.field_log2])
    y = np.zeros_like(x)
    for s in range(1 << layout.field_log2):
        y |= ((x >> np.uint32(s)) & unit) * np.uint32(t[s])
    return y


def slot_image(layout, regs, t, w):
    """Slot w's image of the frontier: T_w(F[m]) placed at m | bit w for
    every mask m without bit w, through the pass kind of bit w."""
    kind, d = layout.slot_pass(w)
    add = np.zeros_like(regs)
    if kind == "field":
        lo = np.uint32(LOW_HALF[d.bit_length() - 1])
        add = apply_rows(layout, regs & lo, t) << np.uint32(d)
    elif kind == "lane":
        y = apply_rows(layout, regs, t)[LANES ^ d]      # shfl_xor
        dst = (LANES & d) != 0
        add[dst] = y[dst]
    else:
        for j in range(layout.words):
            if not j & d:
                add[:, j | d] = apply_rows(layout, regs[:, j], t)
    return add


def closure_pass(layout, regs, t, w):
    return regs | slot_image(layout, regs, t, w)


def force_pass(layout, regs, w):
    kind, d = layout.slot_pass(w)
    regs = regs.copy()
    if kind == "field":
        lo = np.uint32(LOW_HALF[d.bit_length() - 1])
        live = regs & ~lo
        regs = (regs >> np.uint32(d)) & lo
    elif kind == "lane":
        has = (LANES & d) != 0
        live = regs[has]
        regs = np.where(has[:, None], np.uint32(0), regs[LANES ^ d])
    else:
        live = []
        for j in range(layout.words):
            if not j & d:
                live.append(regs[:, j | d].copy())
                regs[:, j] = regs[:, j | d]
                regs[:, j | d] = 0
        live = np.stack(live)
    return regs, bool((live != 0).any())


def _random_case(W, S):
    rng = np.random.default_rng(1000 * W + S)
    M = 1 << W
    F = rng.random((M, S)) < 0.08
    F[0, 0] = True
    T = rng.random((W, S, S)) < 0.3
    slot_open = rng.random(W) < 0.7
    return F, T, slot_open


def _rows(layout, T):
    """Packed rows t[w][s]: bit s' set iff T[w, s, s'] (0 past S)."""
    W, S, _ = T.shape
    t = np.zeros((W, 1 << layout.field_log2), np.uint64)
    t[:, :S] = (T.astype(np.uint64) << np.arange(S, dtype=np.uint64)).sum(-1)
    return t


@pytest.mark.parametrize("W,S", CAPS, ids=[f"W{w}_S{s}" for w, s in CAPS])
def test_layout_sweep_and_force_match_plain(W, S):
    layout = dense_layout(W, S)
    F, T, slot_open = _random_case(W, S)
    M = 1 << W
    regs = pack(layout, F)
    assert np.array_equal(unpack(layout, regs, M, S), F)

    # one sweep: a pass over every open slot, w = 0 .. W-1
    t = _rows(layout, T)
    swept = regs
    for w in range(W):
        if slot_open[w]:
            swept = closure_pass(layout, swept, t[w], w)
    plain = dense_sweep_fn(torch.from_numpy(T)[None],
                           torch.from_numpy(slot_open)[None])(
        torch.from_numpy(F)[None])[0].numpy()
    assert np.array_equal(unpack(layout, swept, M, S), plain)
    assert np.array_equal(pack(layout, plain), swept)  # no stray bits
    assert not swept[layout.lanes:].any()              # empty lanes stay 0

    # FORCE of every slot on the swept frontier
    for w in range(W):
        forced, alive = force_pass(layout, swept, w)
        F_p, alive_p = force_arith(torch.from_numpy(plain)[None],
                                   torch.tensor([w]))
        assert alive == bool(alive_p[0])
        assert np.array_equal(unpack(layout, forced, M, S), F_p[0].numpy())
        assert np.array_equal(pack(layout, F_p[0].numpy()), forced)


def closure_sweeps(layout, regs, t, open_):
    """The kernel's closure: each sweep ORs in every open slot's image of
    the frontier it starts from, until a sweep adds nothing, at most W + 1
    sweeps. Returns (regs, sweeps)."""
    W = layout.n_slots
    for sweeps in range(1, W + 2):
        add = np.zeros_like(regs)
        for w in range(W):
            if open_ >> w & 1:
                add |= slot_image(layout, regs, t[w], w)
        fresh = add & ~regs
        regs = regs | add
        if not fresh.any():
            break
    return regs, sweeps


@pytest.mark.parametrize("W,S", CAPS, ids=[f"W{w}_S{s}" for w, s in CAPS])
def test_closure_sweeps_reach_the_plain_fixpoint(W, S):
    """A frontier closed under the open slots, then new ops latched into
    some slots (fresh or already open): the kernel's sweeps, every open
    slot's image of the same frontier at once, reach the plain version's
    fixpoint (slot by slot, in order) within W + 1 sweeps."""
    layout = dense_layout(W, S)
    rng = np.random.default_rng(7000 + 100 * W + S)
    M = 1 << W
    F, T, old_open = _random_case(W, S)
    F = F & (rng.random(F.shape) < 0.3)
    F[0, 0] = True

    def plain_closure(F, T, open_):
        out, sweeps = closure_fixpoint(
            W, dense_sweep_fn(torch.from_numpy(T)[None],
                              torch.from_numpy(open_)[None]),
            torch.from_numpy(F)[None], torch.tensor([True]))
        assert int(sweeps[0]) <= W + 1
        return out[0].numpy()

    F = plain_closure(F, T, old_open)
    latched = rng.random(W) < 0.35
    latched[rng.integers(W)] = True
    T2 = np.where(latched[:, None, None], rng.random(T.shape) < 0.3, T)
    open2 = old_open | latched
    expected = plain_closure(F, T2, open2)
    got, sweeps = closure_sweeps(layout, pack(layout, F), _rows(layout, T2),
                                 sum(1 << w for w in range(W) if open2[w]))
    assert sweeps <= W + 1
    assert np.array_equal(unpack(layout, got, M, S), expected)
    assert np.array_equal(pack(layout, expected), got)


LAYOUTS = sorted({(W, (S - 1).bit_length()) for W, S in CAPS})


@pytest.mark.parametrize("W,LF", LAYOUTS,
                         ids=[f"W{w}_LF{lf}" for w, lf in LAYOUTS])
def test_layout_places_every_bit_once_and_passes_move_mask_bits(W, LF):
    layout = dense_layout(W, 1 << LF)
    assert (layout.n_slots, layout.field_log2) == (W, LF)
    nbits = 1 << (W + LF)
    assert layout.words * layout.lanes * min(32, nbits) == nbits
    assert layout.words <= 8
    seen = set()
    for m in range(1 << W):
        for s in range(1 << LF):
            lane, word, bit = layout.locate(m, s)
            assert lane < layout.lanes and word < layout.words
            assert bit < min(32, nbits)
            seen.add((lane, word, bit))
    assert len(seen) == nbits
    kinds = [layout.slot_pass(w)[0] for w in range(W)]
    # field bits first, then lane bits, then word bits
    assert kinds == sorted(kinds, key=["field", "lane", "word"].index)
    assert kinds.count("word") == max(W + LF - 10, 0)
    for w in range(W):
        kind, d = layout.slot_pass(w)
        for m in range(1 << W):
            if m >> w & 1:
                continue
            lane, word, bit = layout.locate(m)
            lane2, word2, bit2 = layout.locate(m | 1 << w)
            assert (lane2, word2, bit2) == {
                "field": (lane, word, bit + d),
                "lane": (lane ^ d, word, bit),
                "word": (lane, word ^ d, bit)}[kind]


def test_layout_refuses_beyond_the_caps():
    with pytest.raises(ValueError):
        dense_layout(11, 1)
    with pytest.raises(ValueError):
        dense_layout(10, 9)
    with pytest.raises(ValueError):
        dense_layout(3, 17)
    assert dense_layout(10, 8).words == 8
    assert dense_layout(1, 1).lanes == 1 and dense_layout(1, 1).words == 1
