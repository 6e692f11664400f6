"""The closure kernels' plain versions against the reference's programs.

`cycle_closure_plain` is held to the reference's `make_cycle_closure`
(B7) and `cycle_closure_tiled_plain` to `make_cycle_closure_tiled` (B8),
both run on CPU JAX as the reference's own tests run them, bitwise on
every entry of `closed` and on `has_cycle`: seeded random digraphs,
dense DAGs, a long chain, a planted Hamiltonian cycle and zero-padded
rows, at every node bucket from 4 to 512 and at 768 with T = 256 and
T = 128. The bit layout (`pack_bits`, `pack_adjacency`) and the
dispatcher's CPU routing are checked too. The CUDA kernels are held to
these plain versions on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py `cycle_kernel`).

The kernels' schedules (ops/csrc/cycle_closure.cu) are modelled here in
numpy over packed bits and held to the reference on more kinds (a dense
random digraph, the complete and the empty one): B7's warp form (one
row a lane, pivot rows broadcast), its panel form (`panel_warshall`:
32-pivot panels, the diagonal block closed by shuffles, the panel rows
through it, then every other row's broadcast fold), and B8's blocked
schedule (the panel routine on the diagonal tile, then the
dense broadcast fold on the row panel and on the rest: one tile row a
thread, 32-pivot words skipped when zero across a warp), with the last
launch's reads of C taken either before any of its writes or after the
column panel's. `closure_shape`'s
defaults and refusals are checked without a card.
"""

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.ops import kernel_ir as ref_ir
from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc
from jepsen_jgroups_raft_tpu_torch.ops import kernel_ir

torch.set_num_threads(1)

#: the node buckets the cycle tier emits up to the monolithic cap
BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


#: graph kinds beside the five above: a dense random digraph (p = 0.5),
#: the complete digraph and the empty one
NEW_KINDS = ("dense", "complete", "empty")


def graphs(N: int, seed: int, kinds=("random", "dag", "chain", "cycle",
                                     "padded")) -> np.ndarray:
    """[len(kinds), N, N] int32 0/1 graphs of bucket N (nodes shuffled)."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in kinds:
        n = max(2, N - N // 5) if kind == "padded" else N
        if kind in ("random", "padded"):
            g = (rng.random((n, n)) < 1.5 / n).astype(np.int32)
        elif kind == "dag":
            g = np.triu((rng.random((n, n)) < 0.3).astype(np.int32), 1)
        elif kind == "dense":
            g = (rng.random((n, n)) < 0.5).astype(np.int32)
        elif kind in ("complete", "empty"):
            g = np.full((n, n), int(kind == "complete"), np.int32)
        else:
            g = np.zeros((n, n), np.int32)
            g[np.arange(n - 1), np.arange(1, n)] = 1
            if kind == "cycle":
                g[n - 1, 0] = 1
        np.fill_diagonal(g, 0)
        p = rng.permutation(n)
        full = np.zeros((N, N), np.int32)
        full[:n, :n] = g[np.ix_(p, p)]
        out.append(full)
    return np.stack(out)


def _same(ours, theirs):
    has, closed = ours
    r_has, r_closed = (np.asarray(x) for x in theirs)
    assert has.dtype == torch.bool and closed.dtype == torch.int32
    assert has.numpy().tolist() == r_has.tolist()
    assert np.array_equal(closed.numpy(), r_closed)
    return has.numpy()


@pytest.mark.parametrize("N", BUCKETS)
def test_monolithic_closure_matches_reference(N):
    kinds = (("random", "chain", "cycle") if N >= 384 else
             ("random", "dag", "chain", "cycle", "padded"))
    adj = graphs(N, N, kinds)
    has = _same(cc.cycle_closure_plain(torch.from_numpy(adj)),
                ref_ir.make_cycle_closure(N)(adj))
    assert has[kinds.index("cycle")] and not has[kinds.index("chain")]


@pytest.mark.parametrize("N,T", [(768, 256), (768, 128), (96, 32),
                                 (64, 16)])
def test_tiled_closure_matches_reference(N, T):
    kinds = ("random", "chain", "cycle") if N == 768 else \
        ("random", "dag", "chain", "cycle", "padded")
    adj = graphs(N, 7 * N + T, kinds)
    ours = cc.cycle_closure_tiled_plain(torch.from_numpy(adj), T)
    has = _same(ours, ref_ir.make_cycle_closure_tiled(N, T)(adj))
    assert has[kinds.index("cycle")] and not has[kinds.index("chain")]
    if N < 768:  # the two schedules give one closure
        mono = cc.cycle_closure_plain(torch.from_numpy(adj))
        assert torch.equal(mono[1], ours[1])


@pytest.mark.parametrize("N,T", [(768, 512), (96, 0), (0, 4), (100, 64)])
def test_tile_that_does_not_divide_raises_as_reference(N, T):
    with pytest.raises(ValueError):
        ref_ir.make_cycle_closure_tiled(N, T)
    with pytest.raises(ValueError):
        cc.cycle_closure_tiled_plain(torch.zeros((1, N, N)), T)


def test_tile_helpers_and_caps_match_reference():
    for name in ("CYCLE_MAX_NODES", "CYCLE_MAX_NODES_TILED", "CYCLE_TILE"):
        assert getattr(kernel_ir, name) == getattr(ref_ir, name)
    for n in (4, 6, 96, 512, 768, 1024, 1536, 2048, 3072, 4096, 5000):
        for t in (0, 1, 3, 16, 100, 128, 256, 512, 1024, 9999):
            assert kernel_ir.cycle_closure_tile(n, t) == \
                ref_ir.cycle_closure_tile(n, t)
            assert kernel_ir.cycle_closure_tiles(n, max(t, 1)) == \
                ref_ir.cycle_closure_tiles(n, max(t, 1))
            assert kernel_ir.cycle_closure_tile_bytes(n, t) == \
                ref_ir.cycle_closure_tile_bytes(n, t)
        assert kernel_ir.cycle_adjacency_bytes(n) == \
            ref_ir.cycle_adjacency_bytes(n)


@pytest.mark.parametrize("N", [4, 6, 33, 48, 96, 100])
def test_bit_layout_round_trips(N):
    adj = graphs(N, N + 1)
    t = torch.from_numpy(adj)
    bits = cc.pack_bits(t)
    assert bits.shape == (adj.shape[0], N, (N + 31) // 32)
    assert torch.equal(cc.unpack_bits(bits, N), t)
    host = cc.pack_adjacency(list(adj.astype(np.uint8)), N)
    assert np.array_equal(host, bits.numpy())
    assert np.array_equal(cc.unpack_adjacency(host, N), adj)
    # graphs smaller than the bucket pack zero-padded
    small = cc.pack_adjacency([adj[0][:N // 2, :N // 2]], N)
    pad = np.zeros((N, N), np.int32)
    pad[:N // 2, :N // 2] = adj[0][:N // 2, :N // 2]
    assert np.array_equal(small, cc.pack_bits(torch.from_numpy(
        pad[None])).numpy())


@pytest.mark.parametrize("N", [6, 96, 768])
def test_dispatcher_takes_the_plain_versions_on_the_cpu(N):
    adj = graphs(N, 3 * N, ("random", "chain", "cycle"))
    t = torch.from_numpy(adj)
    has, closed = cc.cycle_closure(t)
    want = (cc.cycle_closure_plain(t) if N <= 512 else
            cc.cycle_closure_tiled_plain(t, 256))
    assert torch.equal(has, want[0]) and torch.equal(closed, want[1])
    b_has, b_closed = cc.cycle_closure_bits(cc.pack_bits(t), N)
    assert torch.equal(b_has, has)
    assert torch.equal(cc.unpack_bits(b_closed, N), closed)
    f_has, none = cc.cycle_closure_bits(cc.pack_bits(t), N,
                                        want_closed=False)
    assert none is None and torch.equal(f_has, has)
    assert cc.launch_counts() == {"cycle_closure": 0,
                                  "cycle_closure_tiled": 0}


def test_dispatcher_refuses_beyond_the_tiled_cap():
    with pytest.raises(ValueError):
        cc.cycle_closure(torch.zeros((1, 4097, 4097), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cc.cycle_closure_bits(torch.zeros((1, 4097, 129), dtype=torch.int32),
                              4097)


# ------------------------------------------- the kernels' schedules in numpy

_K = np.arange(32, dtype=np.uint32)


def _words(adj: np.ndarray) -> np.ndarray:
    """[B, N, N] 0/1 → [B, N, ⌈N/32⌉] uint32 bit rows."""
    N = adj.shape[-1]
    return cc.pack_adjacency(list(adj), N).view(np.uint32).copy()


def _unwords(M: np.ndarray, N: int) -> np.ndarray:
    return cc.unpack_adjacency(M.view(np.int32), N)


def _fold(c: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The dense broadcast fold of one 32-pivot word: for each row, the OR
    of rows[k] & -(bit k of c). c [B, R] uint32, rows [B, 32, m] →
    [B, R, m]."""
    bits = ((c[..., None] >> _K) & 1).astype(bool)          # [B, R, 32]
    sel = np.where(bits[..., None], rows[:, None], np.uint32(0))
    return np.bitwise_or.reduce(sel, axis=2)


def warp_form(M: np.ndarray, N: int) -> np.ndarray:
    """B7's warp form: every row in registers, for pivot k row k
    broadcast (its value at step k) and ORed into each row whose bit k
    is set, all rows in lockstep."""
    M = M.copy()
    for k in range(N):
        bit = ((M[:, :, k >> 5] >> np.uint32(k & 31)) & 1).astype(bool)
        M |= np.where(bit[..., None], M[:, k:k + 1], np.uint32(0))
    return M


def panel_warshall(M: np.ndarray, npanels: int, m: int) -> np.ndarray:
    """`panel_warshall`: rows of M [B, R, ≥ m] are the threads, pivot k
    is row k with its bit in word k >> 5. Per panel p: close the 32 × 32
    diagonal block by shuffles (lockstep Warshall on word p); the panel's
    rows take their paths through it (each of their first m words, in
    lockstep, masked by the closed block); then every other row ORs in
    the panel rows its word p selects."""
    M = M.copy()
    R = M.shape[1]
    for p in range(npanels):
        sl = slice(32 * p, 32 * p + 32)
        d = M[:, sl, p].copy()
        for k in range(32):
            bit = ((d >> np.uint32(k)) & 1).astype(bool)
            d |= np.where(bit, d[:, k:k + 1], np.uint32(0))
        P = M[:, sl, :m].copy()
        for k in range(32):
            bit = ((d >> np.uint32(k)) & 1).astype(bool)
            P |= np.where(bit[..., None], P[:, k:k + 1], np.uint32(0))
        M[:, sl, :m] = P
        others = np.r_[0:32 * p, 32 * p + 32:R]
        M[:, others, :m] |= _fold(M[:, others, p], P)
    return M


def panel_form(M: np.ndarray, N: int) -> np.ndarray:
    """B7's panel form: the matrix padded to 32·NW rows, one thread a
    row, `panel_warshall` over every pivot."""
    B, _, nw = M.shape
    pad = np.zeros((B, 32 * nw, nw), np.uint32)
    pad[:, :N] = M
    return panel_warshall(pad, nw, nw)[:, :N]


def tiled_form(M: np.ndarray, N: int, T: int,
               c_after_diag: bool) -> np.ndarray:
    """B8: per pivot block kb, `close_diagonal` (the panel routine on the
    diagonal tile), the row panel's `fold_tiles` (tile (kb, jb) ORs in
    D*·P, P as staged before the write), then the rest's (tile (ib, jb),
    ib ≠ kb, ORs in C·R with one tile row a thread: a 32-pivot word zero
    in a warp's 32 rows is skipped, as is a tile whose C is zero). C is read before any fold of
    the launch writes it or, with `c_after_diag`, after the column
    panel's tile (jb = kb) was folded."""
    M = M.copy()
    TW, nt = T // 32, N // T
    warp_rows = [np.arange(32 * w, 32 * w + 32) for w in range(TW)]

    def fold(C, R, acc):
        """`fold_tiles` on one row block: acc |= C·R, C [B, T, TW]."""
        acc = acc.copy()
        tile_live = C.any(axis=(1, 2))
        for wk in range(TW):
            c = C[:, :, wk]
            add = _fold(c, R[:, wk * 32:wk * 32 + 32])
            for wr in warp_rows:
                live = tile_live & c[:, wr].any(axis=1)
                acc[:, wr] |= np.where(live[:, None, None], add[:, wr],
                                       np.uint32(0))
        return acc

    for kb in range(nt):
        o, ow = kb * T, kb * TW
        dcols = slice(ow, ow + TW)
        M[:, o:o + T, dcols] = panel_warshall(M[:, o:o + T, dcols], TW, TW)
        rest = np.r_[0:ow, ow + TW:N // 32]
        if len(rest):
            P = M[:, o:o + T, rest]
            M[:, o:o + T, rest] = fold(M[:, o:o + T, dcols], P, P)
        A1 = M.copy()
        Rk = A1[:, o:o + T]                            # new pivot rows
        for ib in range(nt):
            if ib == kb:
                continue
            io = ib * T
            C0 = A1[:, io:io + T, dcols]
            new_col = fold(C0, Rk[:, :, dcols], C0)
            C = new_col if c_after_diag else C0
            if len(rest):
                M[:, io:io + T, rest] = fold(C, Rk[:, :, rest],
                                             A1[:, io:io + T, rest])
            M[:, io:io + T, dcols] = new_col
    return M


def _ref_mono(adj):
    return np.asarray(ref_ir.make_cycle_closure(adj.shape[-1])(adj)[1])


@pytest.mark.parametrize("N", BUCKETS)
def test_b7_schedules_match_reference(N):
    """The panel form at every bucket (and the warp form up to 128 nodes)
    against the reference's `make_cycle_closure`, on the earlier kinds and
    the dense, complete and empty digraphs."""
    base = (("random", "chain", "cycle") if N >= 384 else
            ("random", "dag", "chain", "cycle", "padded"))
    adj = graphs(N, 11 * N, base + NEW_KINDS)
    want = _ref_mono(adj)
    M = _words(adj)
    forms = [panel_form] + ([warp_form] if N <= cc.WARP_MAX_NODES else [])
    for form in forms:
        got = _unwords(form(M, N), N)
        assert np.array_equal(got, want), form.__name__


@pytest.mark.parametrize("N,T", [(N, T) for N in (768, 1024)
                                 for T in cc.KERNEL_TILES])
def test_b8_schedule_matches_reference(N, T):
    """B8's schedule at every tile and both read orders against the
    reference's `make_cycle_closure_tiled` at T."""
    adj = graphs(N, 13 * N + T, ("random", "chain", "cycle") + NEW_KINDS)
    r_has, r_closed = (np.asarray(x) for x in
                       ref_ir.make_cycle_closure_tiled(N, T)(adj))
    M = _words(adj)
    for after in (False, True):
        got = _unwords(tiled_form(M, N, T, after), N)
        assert np.array_equal(got, r_closed), after
        has = got[:, np.arange(N), np.arange(N)].any(axis=1)
        assert has.tolist() == r_has.tolist()


@pytest.mark.parametrize("N,want", [
    (4, ("warp", 4)), (64, ("warp", 4)), (96, ("warp", 4)),
    (128, ("warp", 4)), (192, ("panels", 6)), (256, ("panels", 8)),
    (384, ("panels", 12)), (512, ("panels", 16)), (768, ("tiled", 8)),
    (1024, ("tiled", 8)), (1536, ("tiled", 8)), (4096, ("tiled", 8)),
])
def test_closure_shape_defaults(N, want):
    assert tuple(cc.closure_shape(N)) == want


@pytest.mark.parametrize("N,T,want", [(768, 32, ("tiled", 1)),
                                      (1024, 64, ("tiled", 2)),
                                      (1024, 128, ("tiled", 4)),
                                      (2048, 4096, ("tiled", 8)),
                                      (96, 32, ("warp", 4))])
def test_closure_shape_follows_the_tile(N, T, want):
    assert tuple(cc.closure_shape(N, T)) == want
    if N > 512:
        assert want[1] == cc._kernel_tile(N, T) // 32


@pytest.mark.parametrize("N", (0, -1, 4097, 8192))
def test_closure_shape_refusals(N):
    with pytest.raises(ValueError):
        cc.closure_shape(N)
