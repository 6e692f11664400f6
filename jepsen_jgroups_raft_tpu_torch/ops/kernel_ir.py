"""Kernel IR of the port: caps, the event-row layout, and the plain
PyTorch step parts that a dense kernel's plain version is built from.

The reference (`jepsen_jgroups_raft_tpu/ops/kernel_ir.py`) writes one
per-history step body and batches it with `vmap`; here the batch
dimension B is written out: every carry leaf is batch-leading and every
step part acts on all B rows at once. The hooks keep the reference's
contract:

  ``latch(carry, slot, f, a, b, is_open, upd) -> carry``
      latch ONE op per row (legacy [5]-lane rows); ``upd`` [B, W] is
      ``(slot_ids == slot) & is_open``.
  ``macro_latch(carry, pslot, pf, pa, pb, valid, n, eq, upd) -> carry``
      latch ≤ P opens per row at once (macro rows, history/packing.py
      macro_compact); ``eq`` [B, W, P] / ``upd`` [B, W] from
      :func:`macro_select`.
  ``force_tail(carry, is_force, slot) -> carry``
      closure + FORCE, identical for both row formats — the macro
      soundness argument: both latch phases reach the same registers,
      then run this same code.

These functions are the semantics the CUDA kernels (ops/csrc/
dense_scan.cu, ops/csrc/mask_scan.cu, ops/csrc/sort_scan.cu) are held
to; they are not on the card's main path.

The chunk-carry contract (the reference's `chunk_step_fns` and
`batch_chunk_checker`, kernel_ir.py:290-343): a chunk step takes
``(carry, events [B, span·chunk, R])`` and returns ``(carry', decided,
exhausted, ok, overflow)`` with ``decided = ~ok`` and ``exhausted =
left ≤ 0``, where ``left`` (the row's real events not yet scanned) drops
by the slice's width. Here a carry is one int32 tensor [B, L]: each row
holds the scan state's fields at the offsets of a `CarryLayout` (the
kernels read and write the same layout), the four scalars first
(`CARRY_HEAD`). Rows are independent, so the wavefront's recompaction
is one `index_select` over the carry. `chunk_scan` is the plain loop
of the contract. The reference's `shard_chunk_fns` (kernel_ir.py:346),
the chunk pair under `shard_map` over a mesh, has no counterpart: a
chunk launch is one launch a process on one card, and spreading its
rows over several local GPUs is a later item (ROADMAP, local multi-GPU
fan-out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from ..history.packing import EV_FORCE, EV_OPEN, EV_PAD, MACRO_MAX_OPENS

# --------------------------------------------------------------- caps

#: Dense-domain caps: frontier F[2^W, S] per history. Per-event work is
#: ~W · 2^W · S² (closure sweeps) plus 2^W · S (FORCE), so the dense
#: path is reserved for small windows and domains — which the
#: reference's workload shapes are.
DENSE_MAX_SLOTS = 10
DENSE_MAX_STATES = 16
DENSE_MAX_CELLS = 8192  # 2^W · S

#: Mask mode has no state dimension (S² → 1), so it affords a wider
#: window: F[2^12] bits per history.
MASK_DENSE_MAX_SLOTS = 12

#: Sort-frontier caps (ops/linear_scan.py): a configuration's mask is
#: K = W // 32 + 1 uint32 words with a spare top bit, so 4 words hold
#: 127 slots; C configurations per history at the top rung.
SORT_MAX_SLOTS = 127
SORT_DEFAULT_CONFIGS = 256


# ------------------------------------------------------- event-row layout


def macro_row_ints(macro_p: int = MACRO_MAX_OPENS) -> int:
    """int32 lanes of one macro-event row: [mtype, force_slot, n_opens]
    + macro_p × (slot, f, a, b)."""
    return 3 + 4 * macro_p


def macro_cols(rows, macro_p: int):
    """Split macro-event rows [B, 3 + 4·P] into (mtype [B], force_slot
    [B], n_opens [B], pslot [B, P], pf, pa, pb)."""
    pay = rows[:, 3:3 + 4 * macro_p].reshape(rows.shape[0], macro_p, 4)
    return (rows[:, 0], rows[:, 1], rows[:, 2],
            pay[:, :, 0], pay[:, :, 1], pay[:, :, 2], pay[:, :, 3])


def macro_select(slot_ids, pslot, valid):
    """eq [B, W, P] marks which payload lands in which slot register
    (slots within a macro are distinct, so at most one per slot); upd
    [B, W] which slots update at all."""
    eq = (slot_ids[None, :, None] == pslot[:, None, :]) & valid[:, None, :]
    return eq, eq.any(dim=2)


# --------------------------------------------------- shared FORCE/closure


def _rows_like(mask, x):
    """[B] bool mask viewed to broadcast against a batch-leading x."""
    return mask.view((-1,) + (1,) * (x.dim() - 1))


def closure_fixpoint(W: int, sweep, F, active):
    """Iterate `sweep` (one pass over all slots, all rows) to the
    reachability fixpoint, per row: a row keeps sweeping while its last
    sweep changed it and fewer than W+1 sweeps ran — the reference's
    `while_loop` condition `any(F != F0) & (it < W)`, row by row.
    `active` [B] selects the rows that close at all. Returns (F,
    sweeps [B] int64), the sweeps each row ran (work accounting)."""
    cont = active.clone()
    sweeps = torch.zeros(active.shape, dtype=torch.int64, device=F.device)
    it = 0
    while bool(cont.any()):
        F_new = sweep(F)
        changed = (F_new != F).flatten(1).any(dim=1)
        sweeps += cont
        F = torch.where(_rows_like(cont, F), F_new, F)
        cont = cont & changed & (it < W)
        it += 1
    return F, sweeps


def force_arith(F, slot_w):
    """FORCE over a batch of dense frontiers F [B, M, S] bool with
    per-row slot ids slot_w [B] (pre-clipped to [0, W)): kill
    configurations missing the slot's bit, then recycle the bit by
    moving the bit=1 half onto the bit=0 half. Returns (F', alive [B])."""
    B, M, S = F.shape
    ids = torch.arange(M, dtype=torch.int64, device=F.device)
    w = slot_w.to(torch.int64)
    has = ((ids[None, :] >> w[:, None]) & 1) == 1          # [B, M]
    Fk = F & has[:, :, None]
    alive = Fk.flatten(1).any(dim=1)
    src = ids[None, :] + (1 << w)[:, None]                 # m + bit
    inside = src < M
    gathered = torch.gather(
        Fk, 1, src.clamp(max=M - 1)[:, :, None].expand(B, M, S))
    shifted = gathered & inside[:, :, None]
    return shifted & ~has[:, :, None], alive


# ---------------------------------------------------------- stream step


def make_stream_step(n_slots: int, latch: Callable, macro_latch: Callable,
                     force_tail: Callable,
                     macro_p: Optional[int] = None) -> Callable:
    """The per-event body shared by every plain dense version: decode a
    batch of event rows ([B, 5] legacy or [B, 3 + 4·P] macro), compute
    the latch write masks, call the latch hook, then the closure+FORCE
    tail. Returns step(carry, rows) -> carry."""
    W = int(n_slots)

    if macro_p is None:
        def step(carry, rows):
            slot_ids = torch.arange(W, dtype=torch.int32,
                                    device=rows.device)
            etype, slot = rows[:, 0], rows[:, 1]
            f, a, b = rows[:, 2], rows[:, 3], rows[:, 4]
            is_open = etype == EV_OPEN
            is_force = etype == EV_FORCE
            upd = (slot_ids[None, :] == slot[:, None]) & is_open[:, None]
            carry = latch(carry, slot, f, a, b, is_open, upd)
            return force_tail(carry, is_force, slot)
    else:
        P = int(macro_p)

        def step(carry, rows):
            slot_ids = torch.arange(W, dtype=torch.int32,
                                    device=rows.device)
            mtype, fslot, n, pslot, pf, pa, pb = macro_cols(rows, P)
            is_force = mtype == EV_FORCE
            valid = (torch.arange(P, dtype=torch.int32,
                                  device=rows.device)[None, :]
                     < n[:, None])
            eq, upd = macro_select(slot_ids, pslot, valid)
            carry = macro_latch(carry, pslot, pf, pa, pb, valid, n, eq,
                                upd)
            return force_tail(carry, is_force, fslot)
    return step


# ------------------------------------------------------- chunk carry

#: The scalars every carry row starts with, in this order.
CARRY_HEAD = ("ok", "overflow", "dirty", "left")


@dataclass(frozen=True)
class CarryLayout:
    """The int32 fields of one carry row, in order: ((name, length),
    ...), CARRY_HEAD first. `view(carry, name)` is field `name` of every
    row, [B, length] (a view, no copy). `frontier` names the fields that
    hold the frontier: with "ok", "overflow" and "left" they are all a
    decided row's carry defines (`carry_mismatch`)."""

    kind: str
    fields: tuple
    frontier: tuple = ("F",)

    @property
    def length(self) -> int:
        return sum(n for _, n in self.fields)

    def offset(self, name: str) -> int:
        off = 0
        for f, n in self.fields:
            if f == name:
                return off
            off += n
        raise KeyError(name)

    def view(self, carry, name: str):
        off = self.offset(name)
        return carry[:, off:off + dict(self.fields)[name]]


def carry_layout(kind: str, fields: Sequence[tuple],
                 frontier: Sequence[str] = ("F",)) -> CarryLayout:
    """A layout with CARRY_HEAD's scalars before `fields`."""
    return CarryLayout(kind, tuple((h, 1) for h in CARRY_HEAD)
                       + tuple((str(f), int(n)) for f, n in fields),
                       tuple(frontier))


def carry_mismatch(layout: CarryLayout, a, b) -> int:
    """How many int32 entries of carries a and b [B, L] differ where
    they are defined: every field of a row that is ok in both; of a row
    decided (ok = 0) in both, its frontier (empty), "ok", "overflow" and
    "left" — a kernel stops a row at its first dead FORCE, the plain
    version runs on (the reference's schedule), and a decided row's slot
    state is never read again. A row ok in one and not the other counts
    every entry."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    ok_a = layout.view(a, "ok")[:, 0] != 0
    ok_b = layout.view(b, "ok")[:, 0] != 0
    diff = a != b
    dead = ~ok_a & ~ok_b
    if bool(dead.any()):
        keep = torch.zeros(layout.length, dtype=torch.bool, device=a.device)
        for name in ("ok", "overflow", "left") + layout.frontier:
            off = layout.offset(name)
            keep[off:off + dict(layout.fields)[name]] = True
        diff[dead] &= keep
    return int(diff.sum())


def new_carry(layout: CarryLayout, n_events) -> torch.Tensor:
    """A fresh carry [B, L] int32 on n_events' device: every field 0 but
    ok = 1 and left = n_events (the caller sets the scan's own initial
    fields)."""
    n_events = torch.as_tensor(n_events)
    c = torch.zeros((int(n_events.shape[0]), layout.length),
                    dtype=torch.int32, device=n_events.device)
    layout.view(c, "ok")[:] = 1
    layout.view(c, "left")[:, 0] = n_events.to(torch.int32)
    return c


def pack_bits(bits) -> torch.Tensor:
    """bool [B, N] → int32 [B, max(1, ⌈N/32⌉)]: bit i in word i // 32 at
    position i % 32 (the frontier words' order in the carry)."""
    B, N = int(bits.shape[0]), int(bits.shape[1])
    nw = max(1, -(-N // 32))
    pad = torch.zeros((B, nw * 32), dtype=torch.int64, device=bits.device)
    pad[:, :N] = bits.to(torch.int64)
    w = (pad.view(B, nw, 32)
         << torch.arange(32, dtype=torch.int64, device=bits.device)).sum(2)
    return (((w + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def unpack_bits(words, n: int) -> torch.Tensor:
    """`pack_bits`'s inverse: int32 [B, nw] → bool [B, n]."""
    sh = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[:, :, None] >> sh) & 1
    return bits.reshape(words.shape[0], -1)[:, :n].bool()


def chunk_flags(carry, layout: CarryLayout):
    """(decided, exhausted, ok, overflow) [B] bool of a carry."""
    ok = layout.view(carry, "ok")[:, 0] != 0
    return (~ok, layout.view(carry, "left")[:, 0] <= 0, ok,
            layout.view(carry, "overflow")[:, 0] != 0)


def chunk_scan(step: Callable, state, events, left,
               width: Optional[int] = None):
    """The plain loop of one chunk: apply `step` to the event rows of
    `events` [B, w, R] in order and return (state', left - width).
    `width` (default w) is the slice's length in the schedule; rows past
    w, and each row's rows past its own `left`, are EV_PAD no-ops, as in
    the reference (every row beyond a history's real length is EV_PAD),
    so the loop stops at the last row any history still reads."""
    width = int(events.shape[1]) if width is None else int(width)
    left = left.to(torch.int64)
    n = min(int(events.shape[1]), width,
            int(left.max()) if left.numel() else 0)
    for e in range(max(n, 0)):
        rows = events[:, e]
        state = step(state, torch.where((e < left)[:, None], rows,
                                        torch.full_like(rows, EV_PAD)))
    return state, left - width


# ------------------------------------------------------- cycle closure
# Caps and bookkeeping of the closure kernels (ops/cycle_closure.py,
# ops/csrc/cycle_closure.cu), with the reference's values and meanings.

#: Dependency graphs up to this many nodes take the monolithic closure
#: (B7: one CTA per graph, the whole bit-packed matrix in shared memory).
CYCLE_MAX_NODES = 512

#: Graphs above CYCLE_MAX_NODES and up to this many nodes take the
#: blocked closure (B8); rows beyond it skip the exact tier and say so
#: (the ``cycle-skipped-size`` annotation, checker/cycle.py).
CYCLE_MAX_NODES_TILED = 4096

#: Default closure tile edge. Every node bucket the pow2+midpoint series
#: emits above 512 (768, 1024, 1536, ...) is a multiple of 256, so the
#: default tile always divides the bucket.
CYCLE_TILE = 256


def cycle_closure_tile(n_nodes: int, tile: int) -> int:
    """Effective tile edge for a bucket: the largest power of two ≤
    ``tile`` that divides ``n_nodes`` (768 = 3·256 admits any power of
    two ≤ 256, not 512)."""
    n, t = int(n_nodes), int(tile)
    t = min(t, n)
    if t >= 1:
        t = 1 << (t.bit_length() - 1)  # largest pow2 ≤ t
    while t > 1 and n % t:
        t //= 2
    return max(t, 1)


def cycle_adjacency_bytes(n_nodes: int) -> int:
    """Per-row resident bytes of the reference's monolithic closure: the
    int32 adjacency/closure matrix plus the squared product (two [N, N]
    int32 slabs)."""
    return 2 * n_nodes * n_nodes * 4


def cycle_closure_tile_bytes(n_nodes: int, tile: int) -> int:
    """Per-row resident int32 bytes of one pivot step of the reference's
    blocked closure: the [T, N] row panel, the [N, T] column panel, the
    closed [T, T] diagonal block and one [T, N] product slab."""
    return (3 * tile * n_nodes + tile * tile) * 4


def cycle_closure_tiles(n_nodes: int, tile: int) -> int:
    """Tile-program count of one blocked-closure pass, the reference's
    bookkeeping for the ``cycle_tiles_run`` counter: per pivot block one
    diagonal closure, N/T row-panel products, N/T column-panel products
    and N/T fold products of N/T tiles each."""
    nt = max(1, n_nodes // max(1, tile))
    return nt * (1 + 2 * nt + nt * nt)
