"""Batched boolean transitive closure: the exact cycle tier's kernels.

The port of the reference's two closure programs (`jepsen_jgroups_raft_
tpu/ops/kernel_ir.py` `make_cycle_closure`, B7, and
`make_cycle_closure_tiled`, B8, both XLA programs). The contract is
theirs: ``closure(adj)`` over [B, N, N] 0/1 adjacency matrices returns
``(has_cycle [B] bool, closed [B, N, N])``, where ``closed`` holds every
path of length ≥ 1 — the transitive closure, which is unique, so any
correct algorithm gives the reference's matrix bit for bit, diagonal
included (a diagonal bit is set iff its node lies on a cycle) — and
``has_cycle`` is any diagonal bit.

This module holds:

  * the plain versions `cycle_closure_plain` (repeated squaring with the
    reference's early exit) and `cycle_closure_tiled_plain` (the
    reference's blocked Floyd–Warshall schedule, its ValueError when the
    tile does not divide N included). They compute in float32 and
    re-binarize after every product, which is exact: entries are 0/1 and
    row sums are ≤ N ≤ 4096 < 2^24. The CPU tests hold them to the
    reference; chip_smoke.py holds the kernels to them.
  * the bit layout: a row of N nodes is ⌈N/32⌉ uint32 words (stored as
    int32), bit j of word w is column 32·w + j; `pack_bits` /
    `unpack_bits` on tensors, `pack_adjacency` / `unpack_adjacency` for
    numpy on the host.
  * `cycle_closure_bits`, the wrapper of the hand-written CUDA kernels
    (ops/csrc/cycle_closure.cu): B7 (``cycle_closure``) for
    N ≤ CYCLE_MAX_NODES, B8 (``cycle_closure_tiled``, blocked
    Floyd–Warshall over T×T bit tiles in global memory) above, up to
    CYCLE_MAX_NODES_TILED; and `cycle_closure`, the same on unpacked
    matrices. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.
  * `closure_shape`, the launch shape the kernels take at a bucket:
    B7's form — ``warp`` (one warp per graph, the matrix in registers,
    N ≤ WARP_MAX_NODES) or ``panels`` (one CTA per graph, blocked
    Warshall over 32-pivot panels in shared memory) — or B8's
    (``tiled``), and its warps a block.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .dense_scan import _check_int32, _device_index
from .kernel_ir import (CYCLE_MAX_NODES, CYCLE_MAX_NODES_TILED, CYCLE_TILE,
                        cycle_closure_tile)

#: Tile edges the blocked kernel is instantiated for (32·TW bits, TW
#: words per tile row). The closure does not depend on the tile, so a
#: requested tile outside this range runs at the nearest one; every node
#: bucket above CYCLE_MAX_NODES is a multiple of 256, which each divides.
KERNEL_TILES = (32, 64, 128, 256)

#: B7's warp form holds a graph's matrix in one warp's registers up to
#: this many nodes (⌈N/32⌉² ≤ 16 words a lane).
WARP_MAX_NODES = 128

#: Graphs (one a warp) a block of the warp form holds.
WARP_GRAPHS_PER_BLOCK = 4

#: Launch counts of the wrapper: one is added per call that launches a
#: kernel on the card (B8's call is 3·N/T + 1 CUDA launches), and nowhere
#: else.
LAUNCHES = {"cycle_closure": 0, "cycle_closure_tiled": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def words_per_row(n_nodes: int) -> int:
    return (int(n_nodes) + 31) // 32


# ----------------------------------------------------------- plain versions


def _binarize(x):
    return (x > 0).to(torch.float32)


def cycle_closure_plain(adj):
    """The reference's `make_cycle_closure` in plain PyTorch: R ← R ∨ R·R
    at most ⌈log₂N⌉ times, stopping when a squaring changes nothing in
    the batch. adj [B, N, N] 0/1 (any dtype). Returns (has_cycle [B]
    bool, closed [B, N, N] int32) on adj's device."""
    n = int(adj.shape[-1])
    n_iter = max(1, (max(n, 2) - 1).bit_length())
    a = _binarize(adj)
    for _ in range(n_iter):
        nxt = _binarize(a + _binarize(torch.bmm(a, a)))
        changed = bool((nxt != a).any())
        a = nxt
        if not changed:
            break
    closed = a.to(torch.int32)
    return torch.diagonal(closed, dim1=1, dim2=2).any(dim=1), closed


def cycle_closure_tiled_plain(adj, tile: int = CYCLE_TILE):
    """The reference's `make_cycle_closure_tiled` in plain PyTorch: for
    each pivot block of T nodes, close the diagonal block by ⌈log₂T⌉
    squarings, fold it into its row panel (R ← R ∨ D·R) and column panel
    (C ← C ∨ C·D), then every row panel by A ← A ∨ C·R. Same contract
    as `cycle_closure_plain`; ValueError when T does not divide N."""
    n, t = int(adj.shape[-1]), int(tile)
    if n < 1 or t < 1 or n % t:
        raise ValueError(f"tile {t} does not divide node bucket {n}")
    nt = n // t
    diag_iters = max(1, (max(t, 2) - 1).bit_length())
    a = _binarize(adj).clone()
    for kb in range(nt):
        o = kb * t
        d = a[:, o:o + t, o:o + t]
        for _ in range(diag_iters):
            d = _binarize(d + _binarize(torch.bmm(d, d)))
        row = _binarize(a[:, o:o + t, :] + _binarize(
            torch.bmm(d, a[:, o:o + t, :])))
        a[:, o:o + t, :] = row
        col = _binarize(a[:, :, o:o + t] + _binarize(
            torch.bmm(a[:, :, o:o + t], d)))
        a[:, :, o:o + t] = col
        for ib in range(nt):
            io = ib * t
            ci = col[:, io:io + t, :]
            a[:, io:io + t, :] = _binarize(
                a[:, io:io + t, :] + _binarize(torch.bmm(ci, row)))
    closed = a.to(torch.int32)
    return torch.diagonal(closed, dim1=1, dim2=2).any(dim=1), closed


def closure_plain(adj, tile: Optional[int] = None):
    """The plain version for a bucket, as `cycle_closure` routes on a CPU
    tensor: monolithic up to CYCLE_MAX_NODES, blocked above at the
    effective tile (`cycle_closure_tile` of `tile`, default CYCLE_TILE)."""
    n = int(adj.shape[-1])
    if n <= CYCLE_MAX_NODES:
        return cycle_closure_plain(adj)
    return cycle_closure_tiled_plain(
        adj, cycle_closure_tile(n, CYCLE_TILE if tile is None else tile))


# --------------------------------------------------------------- bit layout


def pack_bits(adj):
    """[B, N, N] 0/1 tensor → [B, N, ⌈N/32⌉] int32 bit rows (bit j of
    word w is column 32·w + j), on adj's device."""
    B, n = int(adj.shape[0]), int(adj.shape[-1])
    nw = words_per_row(n)
    bits = torch.zeros((B, n, nw * 32), dtype=torch.int64,
                       device=adj.device)
    bits[:, :, :n] = (adj != 0).to(torch.int64)
    weights = torch.tensor([1 << j for j in range(32)], dtype=torch.int64,
                           device=adj.device)
    words = (bits.view(B, n, nw, 32) * weights).sum(dim=3)
    return (((words + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def unpack_bits(bits, n_nodes: int):
    """Inverse of `pack_bits`: [B, N, NW] int32 → [B, N, N] int32 0/1."""
    B, n = int(bits.shape[0]), int(n_nodes)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    out = (bits.to(torch.int64)[..., None] >> shifts) & 1
    return out.reshape(B, n, -1)[:, :, :n].to(torch.int32)


def pack_adjacency(graphs, n_nodes: int) -> np.ndarray:
    """Host packing of a bucket's graphs: each an [n, n] 0/1 numpy array
    with n ≤ n_nodes, zero-padded to N = n_nodes → [B, N, NW] int32."""
    N = int(n_nodes)
    nw = words_per_row(N)
    buf = np.zeros((len(graphs), N, nw * 4), dtype=np.uint8)
    for j, g in enumerate(graphs):
        n = int(g.shape[0])
        if n:
            pk = np.packbits(np.asarray(g, dtype=bool), axis=1,
                             bitorder="little")
            buf[j, :n, :pk.shape[1]] = pk
    return buf.view("<i4").reshape(len(graphs), N, nw)


def unpack_adjacency(bits: np.ndarray, n_nodes: int) -> np.ndarray:
    """Host inverse of `pack_adjacency`: [B, N, NW] → [B, N, N] uint8."""
    b = np.ascontiguousarray(bits, dtype="<i4")
    return np.unpackbits(b.view(np.uint8), axis=-1,
                         bitorder="little")[..., :int(n_nodes)]


# ------------------------------------------------------------ the kernels


def _kernel_tile(n: int, tile: Optional[int]) -> int:
    t = cycle_closure_tile(n, CYCLE_TILE if tile is None else tile)
    return min(max(t, KERNEL_TILES[0]), KERNEL_TILES[-1])


class ClosureShape(NamedTuple):
    """A closure launch's shape: `form` ("warp", "panels" or "tiled") and
    `warps` a block."""
    form: str
    warps: int


def closure_shape(n_nodes: int, tile: Optional[int] = None) -> ClosureShape:
    """The launch shape the kernels take at bucket N, from N alone (and,
    for B8, the effective tile T of `tile` as `cycle_closure_bits` reads
    it): the warp form with WARP_GRAPHS_PER_BLOCK graphs a block up to
    WARP_MAX_NODES, the panel form (one thread a row, ⌈N/32⌉ warps) up to
    CYCLE_MAX_NODES, B8 (one thread a tile row, T / 32 warps) above.
    ValueError beyond 1..CYCLE_MAX_NODES_TILED. Plain Python: runs
    without a card. PERF.md records the sweep of other shapes (warps a
    block, the panel form at N ≤ 128, 2 and 4 tile rows a thread) that
    chose these."""
    n = int(n_nodes)
    if not 1 <= n <= CYCLE_MAX_NODES_TILED:
        raise ValueError(f"cycle_closure: N={n} beyond "
                         f"1..{CYCLE_MAX_NODES_TILED}")
    if n <= WARP_MAX_NODES:
        return ClosureShape("warp", WARP_GRAPHS_PER_BLOCK)
    if n <= CYCLE_MAX_NODES:
        return ClosureShape("panels", words_per_row(n))
    return ClosureShape("tiled", _kernel_tile(n, tile) // 32)


def cycle_closure_bits(bits, n_nodes: int, tile: Optional[int] = None,
                       want_closed: bool = True):
    """The closure over bit rows: bits [B, N, ⌈N/32⌉] int32 (see
    `pack_bits`) → (has_cycle [B] bool, closed bits [B, N, NW] int32, or
    None without `want_closed`). N ≤ CYCLE_MAX_NODES launches B7, N up
    to CYCLE_MAX_NODES_TILED B8 at `tile` (default CYCLE_TILE, made a
    divisor of N by `cycle_closure_tile`). A CPU tensor takes the plain
    version; a CUDA tensor launches the hand-written kernel on the
    current stream without synchronising (at `closure_shape`), or
    raises."""
    n = int(n_nodes)
    if not 1 <= n <= CYCLE_MAX_NODES_TILED:
        raise ValueError(f"cycle_closure: N={n} beyond "
                         f"1..{CYCLE_MAX_NODES_TILED}")
    if bits.device.type == "cpu":
        has, closed = closure_plain(unpack_bits(bits, n), tile)
        return has, (pack_bits(closed) if want_closed else None)
    dev = bits.device
    _check_int32("bits", bits, 3, dev)
    B = int(bits.shape[0])
    if tuple(bits.shape[1:]) != (n, words_per_row(n)):
        raise ValueError(f"cycle_closure: bits must be [B, {n}, "
                         f"{words_per_row(n)}], got {tuple(bits.shape)}")
    if B > 65535:
        raise ValueError(f"cycle_closure: {B} graphs beyond one launch's "
                         f"65535")
    has = torch.empty((B,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev)
    if n <= CYCLE_MAX_NODES:
        name = "cycle_closure"
        out = torch.empty_like(bits)
        args = (bits.data_ptr(), out.data_ptr(), has.data_ptr(), B, n)
    else:
        name = "cycle_closure_tiled"
        out = bits.clone()  # B8 closes in place
        args = (out.data_ptr(), has.data_ptr(), B, n, _kernel_tile(n, tile))
    if B:
        lib = _build.load("cycle_closure")
        rc = getattr(lib, f"{name}_launch")(*args, _device_index(dev),
                                            stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: "
                               f"{_build.error_string('cycle_closure', rc)}")
        LAUNCHES[name] += 1
    return has, (out if want_closed else None)


def cycle_closure(adj, tile: Optional[int] = None):
    """The closure over [B, N, N] 0/1 matrices: (has_cycle [B] bool,
    closed [B, N, N] int32). A CPU tensor takes the plain version (the
    monolithic one up to CYCLE_MAX_NODES, the blocked one above); a CUDA
    tensor is packed to bit rows, launches B7 (N ≤ CYCLE_MAX_NODES) or
    B8 (N ≤ CYCLE_MAX_NODES_TILED) and is unpacked, or raises."""
    n = int(adj.shape[-1])
    if adj.device.type == "cpu":
        if not 1 <= n <= CYCLE_MAX_NODES_TILED:
            raise ValueError(f"cycle_closure: N={n} beyond "
                             f"1..{CYCLE_MAX_NODES_TILED}")
        return closure_plain(adj, tile)
    has, closed = cycle_closure_bits(pack_bits(adj), n, tile)
    return has, unpack_bits(closed, n)
