"""Sort-frontier scan: the general linearizability kernel (the ladder).

The port of the reference's sort kernel (`jepsen_jgroups_raft_tpu/ops/
linear_scan.py` `sort_step_parts` and `_dedup_compact`, an XLA program).
It takes any model and any window W ≤ 127, where the dense kernels need
a small domain or an order-independent model and W ≤ 12:

  * A configuration is (K-word uint32 mask over the W window slots,
    int32 model state), K = W // 32 + 1, so the last word always keeps
    its top bit spare. The frontier holds at most C configurations; an
    empty entry has every mask word all-ones.
  * OPEN rows latch (f, a, b) into their slot's registers. At a FORCE
    after an OPEN, a closure: each round expands every live
    configuration by every open slot not in its mask whose step is
    legal, then deduplicates parents and candidates and keeps the C
    smallest distinct entries; rounds repeat while one finds a candidate
    distinct from every parent, at most W + 1 of them. The FORCE kills
    configurations without the slot's bit and clears the bit in the
    survivors; ``ok &= some survivor``.
  * More than C distinct configurations in a round set ``overflow``: a
    VALID verdict stays sound (configurations were only dropped), an
    INVALID one is unknown, and the caller escalates the row to a larger
    C or to the host oracle.

Which C entries are kept decides the flags of a row that overflowed, so
the order is the reference's exactly: its two stable sorts leave the
distinct live entries ordered by the last mask word, then words 0 ..
K−2, then the state (words unsigned, the state signed).

This module holds `bucket_slots` (the kernel windows), `sort_scan_plain`
(the plain PyTorch version, batched over B, which the CPU tests hold to
the reference and chip_smoke.py holds the CUDA kernel to) and
`sort_scan`, the wrapper of the hand-written CUDA kernel
(ops/csrc/sort_scan.cu: a round's candidates formed at once, deduplicated
by a hash table, ordered only when more than C are distinct; its launch
shape from `sort_shape`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..models.base import wrap_i32
from . import _build
from .dense_scan import (_card_rows, _chunk_out, _chunk_rows, _device_index,
                         _flags, _launch_fn)
from .kernel_ir import (SORT_DEFAULT_CONFIGS, SORT_MAX_SLOTS, CarryLayout,
                        carry_layout, chunk_flags, chunk_scan,
                        make_stream_step, new_carry)
from .verdict_counts import check_real, counts_out, scan_counts_plain

MAX_SLOTS = SORT_MAX_SLOTS
DEFAULT_N_CONFIGS = SORT_DEFAULT_CONFIGS

#: The largest C the CUDA kernel takes (one block per history, the
#: frontier, its hash table and a round's candidates in shared memory).
MAX_CONFIGS = 512

#: Windows ≤ SLOT_EXACT_MAX run at their exact size; wider ones at the
#: smallest SLOT_BUCKETS rung that holds them (32k − 1 slots for k words).
SLOT_EXACT_MAX = 16
SLOT_BUCKETS = (31, 63, 95, 127)

#: An empty entry's mask word.
_SENT = 0xFFFFFFFF


def bucket_slots(n: int) -> int:
    """Kernel window for a real window of n slots: exact when small, else
    the smallest SLOT_BUCKETS rung ≥ n."""
    if n <= SLOT_EXACT_MAX:
        return max(n, 1)
    for b in SLOT_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"window {n} exceeds MAX_SLOTS {MAX_SLOTS}")


def mask_words(n_slots: int) -> int:
    """K, the uint32 words of a configuration's mask at window W."""
    return int(n_slots) // 32 + 1


# ----------------------------------------------------------- plain version

#: The work counters `sort_scan_plain` accumulates into its `stats`.
SORT_STATS = ("closures", "rounds", "steps", "candidates")


def _gather_rows(x, idx):
    """x [B, N] or [B, N, K] reordered along dim 1 by idx [B, M]."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _dedup_compact(masks, states, tags, n_configs: int):
    """The reference's `_dedup_compact`, batched: masks [B, N, K] int64
    (uint32 words), states [B, N] int32, tags [B, N] int64 (0 parent, 1
    candidate). Returns (masks' [B, C, K], states' [B, C], count [B],
    grew [B]): the C first of the distinct live entries in the
    reference's order, their exact number, and whether one of them is a
    candidate equal to no parent."""
    B, N, K = masks.shape
    # the first sort: lexicographic on (w0 .. w_{K-1}, state, tag), as
    # stable sorts from the last key to the first
    order = torch.arange(N, device=masks.device).expand(B, N)
    for key in [tags, states] + [masks[:, :, j] for j in reversed(range(K))]:
        k = torch.gather(key, 1, order)
        order = torch.gather(order, 1,
                             torch.sort(k, dim=1, stable=True).indices)
    sm, ss, st = (_gather_rows(x, order) for x in (masks, states, tags))
    same = (sm[:, 1:] == sm[:, :-1]).all(dim=2) & (ss[:, 1:] == ss[:, :-1])
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                 device=masks.device), same], dim=1)
    keep = ~dup & (sm[:, :, K - 1] != _SENT)
    count = keep.sum(dim=1)
    grew = (keep & (st == 1)).any(dim=1)
    # the second sort, stable on the last word alone: dropped rows are
    # blanked to the empty entry, which sorts after every live one
    m2 = torch.where(keep[:, :, None], sm, _SENT)
    s2 = torch.where(keep, ss, 0)
    idx = torch.sort(m2[:, :, K - 1], dim=1, stable=True).indices[:, :n_configs]
    return _gather_rows(m2, idx), _gather_rows(s2, idx), count, grew


def _sort_step(model, W: int, C: int, macro_p: Optional[int], dev,
               acc: Optional[dict]):
    """The per-event body of the sort plain version, shared by the
    one-shot scan and the chunk form: step(state, rows) -> state over the
    reference's carry (masks [B, C, K] int64 words, states [B, C] int32,
    f, a, b [B, W] int32, slot_open [B, W], ok, overflow, dirty [B]).
    `acc`, when given, accumulates `SORT_STATS` (on the device)."""
    K = mask_words(W)
    i64 = torch.int64
    slot_ids = torch.arange(W, dtype=torch.int32, device=dev)
    slot_word = torch.arange(W, device=dev) // 32
    slot_bit = 1 << (torch.arange(W, dtype=i64, device=dev) % 32)     # [W]
    set_bits = torch.where(torch.arange(K, device=dev)[None, :]
                           == slot_word[:, None], slot_bit[:, None], 0)

    def expand_once(masks, states, sf, sa, sb, so):
        B = int(masks.shape[0])
        live = masks[:, :, K - 1] != _SENT                            # [B,C]
        m_w = masks[:, :, slot_word]                                  # [B,C,W]
        cand_open = so[:, None, :] & ((m_w & slot_bit) == 0)
        ns, legal = model.torch_step(states[:, :, None], sf[:, None, :],
                                     sa[:, None, :], sb[:, None, :])
        good = live[:, :, None] & cand_open & legal
        cand = masks[:, :, None, :] | set_bits[None, None]            # [B,C,W,K]
        cand_m = torch.where(good[..., None], cand, _SENT)
        cand_s = torch.where(good, ns, 0).to(torch.int32)
        nm, nst, count, grew = _dedup_compact(
            torch.cat([masks, cand_m.reshape(B, C * W, K)], dim=1),
            torch.cat([states, cand_s.reshape(B, C * W)], dim=1),
            torch.cat([torch.zeros((B, C), dtype=i64, device=dev),
                       torch.ones((B, C * W), dtype=i64, device=dev)],
                      dim=1), C)
        n_steps = (live.sum(dim=1) * so.sum(dim=1)).to(i64)
        return nm, nst, count, grew, n_steps, good.sum(dim=(1, 2))

    def latch(carry, slot, f, a, b, is_open, upd):
        masks, states, sf, sa, sb, so, ok, overflow, dirty = carry
        sf = torch.where(upd, f[:, None], sf)
        sa = torch.where(upd, a[:, None], sa)
        sb = torch.where(upd, b[:, None], sb)
        return (masks, states, sf, sa, sb, so | upd, ok, overflow,
                dirty | is_open)

    def macro_latch(carry, pslot, pf, pa, pb, valid, n, eq, upd):
        masks, states, sf, sa, sb, so, ok, overflow, dirty = carry
        sel = eq.to(i64)                                              # [B,W,P]

        def put(old, new):  # the reference's macro_latch_i32
            return torch.where(upd, wrap_i32(
                (sel * new.to(i64)[:, None, :]).sum(2)), old)

        return (masks, states, put(sf, pf), put(sa, pa), put(sb, pb),
                so | upd, ok, overflow, dirty | (n > 0))

    def force_tail(carry, is_force, slot):
        masks, states, sf, sa, sb, so, ok, overflow, dirty = carry
        active = is_force & dirty
        if bool(active.any()):
            # closure: rounds while one grew, at most W + 1, row by row
            cont = active.clone()
            if acc is not None:
                acc["closures"] += (active & ok).sum()
            it = 0
            while bool(cont.any()):
                nm, nst, count, grew, n_steps, n_cand = expand_once(
                    masks, states, sf, sa, sb, so)
                if acc is not None:
                    counted = (cont & ok).to(i64)
                    acc["rounds"] += counted.sum()
                    acc["steps"] += (counted * n_steps).sum()
                    acc["candidates"] += (counted * n_cand).sum()
                masks = torch.where(cont[:, None, None], nm, masks)
                states = torch.where(cont[:, None], nst, states)
                overflow = overflow | (cont & (count > C))
                cont = cont & grew & (it < W)
                it += 1
        dirty = dirty & ~is_force
        # FORCE: survivors hold the slot's bit, which is then cleared; a
        # slot outside [0, W) has no bit in any live mask
        in_range = (slot >= 0) & (slot < W)
        sc = slot.clamp(0, W - 1).to(i64)
        bitvec = torch.where((torch.arange(K, device=dev)[None, :]
                              == (sc // 32)[:, None]) & in_range[:, None],
                             (1 << (sc % 32))[:, None], 0)            # [B,K]
        live = masks[:, :, K - 1] != _SENT
        has = ((masks & bitvec[:, None, :]) != 0).any(dim=2) & live
        killed = torch.where((is_force[:, None] & live & ~has)[:, :, None],
                             _SENT, masks)
        masks = torch.where((is_force[:, None] & has)[:, :, None],
                            killed & ~bitvec[:, None, :], killed)
        alive = (masks[:, :, K - 1] != _SENT).any(dim=1)
        ok = ok & (~is_force | alive)
        so = so & ~((slot_ids[None, :] == slot[:, None]) & is_force[:, None])
        return (masks, states, sf, sa, sb, so, ok, overflow, dirty)

    return make_stream_step(W, latch, macro_latch, force_tail, macro_p)


def _check_shape(W: int, C: int) -> None:
    if not 1 <= W <= MAX_SLOTS:
        raise ValueError(f"sort_scan: W={W} beyond 1..{MAX_SLOTS}")
    if C < 1:
        raise ValueError(f"sort_scan: n_configs={C} < 1")


def sort_scan_plain(events, n_slots: int, n_configs: int,
                    macro_p: Optional[int] = None, n_events=None, *, model,
                    stats: Optional[dict] = None):
    """The sort-frontier scan in plain PyTorch: a Python loop over event
    rows, batched over B, following the reference's `sort_step_parts`
    and `_dedup_compact` step for step through the port's kernel_ir
    hooks.

    events [B, E, 5] int32 (legacy) or [B, E, 3 + 4·P] (macro_p=P);
    n_events [B] only bounds the loop (rows past a history's length are
    EV_PAD no-ops); W = n_slots ≤ MAX_SLOTS, C = n_configs. Returns (ok
    [B] bool, overflow [B] bool) on events' device. `stats`, when given,
    accumulates `SORT_STATS` over rows still alive: "closures" (closing
    FORCEs), "rounds" (closure rounds), "steps" (live
    configurations × open slots, per round: the model steps the round
    takes) and "candidates" (legal expansions, per round: each one
    dedup probe). They only count; the result does not depend on them."""
    W, C = int(n_slots), int(n_configs)
    _check_shape(W, C)
    B, E = int(events.shape[0]), int(events.shape[1])
    dev = events.device
    acc = ({k: torch.zeros((), dtype=torch.int64, device=dev)
            for k in SORT_STATS} if stats is not None else None)
    step = _sort_step(model, W, C, macro_p, dev, acc)
    state = _sort_fresh(B, W, C, model, dev)
    n_scan = E if n_events is None or B == 0 else \
        min(E, int(torch.as_tensor(n_events).max()))
    for e in range(n_scan):
        state = step(state, events[:, e])
    if stats is not None:
        for k, v in acc.items():
            stats[k] = stats.get(k, 0) + int(v)
    return state[6], state[7]


def _sort_fresh(B: int, W: int, C: int, model, dev):
    """The sort scan's initial state: one configuration (the empty mask,
    the model's initial state), the rest empty; ok, no overflow."""
    masks = torch.full((B, C, mask_words(W)), _SENT, dtype=torch.int64,
                       device=dev)
    masks[:, 0] = 0
    states = torch.zeros((B, C), dtype=torch.int32, device=dev)
    states[:, 0] = int(model.init_state())
    zw = torch.zeros((B, W), dtype=torch.int32, device=dev)
    return (masks, states, zw, zw, zw,
            torch.zeros((B, W), dtype=torch.bool, device=dev),
            torch.ones((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev))


# ------------------------------------------------------------ chunk form


def sort_carry_layout(n_slots: int, n_configs: int) -> CarryLayout:
    """The chunk carry of the sort scan at window W and capacity C
    (ops/csrc/sort_scan.cu reads and writes the same): after CARRY_HEAD,
    the slot registers "open", "f", "a", "b" [W], "states" [C] and
    "masks" [C·K] (configuration i's words at i·K .. i·K + K − 1). The
    frontier is canonical: the live configurations first, in the
    reference's order (which a FORCE keeps), then empty entries (every
    word all ones, state 0) — the reference's carry with the entries a
    FORCE killed squeezed out (`canonical_frontier`)."""
    W, C = int(n_slots), int(n_configs)
    _check_shape(W, C)
    return carry_layout("sort", [
        ("open", W), ("f", W), ("a", W), ("b", W), ("states", C),
        ("masks", C * mask_words(W))], frontier=("states", "masks"))


def sort_chunk_init(n_events, n_slots: int, n_configs: int,
                    model) -> torch.Tensor:
    """A fresh sort carry [B, L] int32 on n_events' device: one
    configuration (the empty mask, the model's initial state), `left` =
    n_events."""
    lay = sort_carry_layout(n_slots, n_configs)
    c = new_carry(lay, n_events)
    lay.view(c, "masks")[:] = -1
    lay.view(c, "masks")[:, :mask_words(n_slots)] = 0
    lay.view(c, "states")[:, 0] = int(model.init_state())
    return c


def canonical_frontier(masks, states):
    """(masks, states) with the live entries (last word not all ones)
    moved to the front in their order and the rest emptied (words all
    ones, state 0): masks [B, C, K] int64 words, states [B, C]."""
    K = int(masks.shape[2])
    live = masks[:, :, K - 1] != _SENT
    order = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
    live = torch.gather(live, 1, order)
    masks = torch.where(live[:, :, None], _gather_rows(masks, order), _SENT)
    states = torch.where(live, _gather_rows(states, order), 0)
    return masks, states.to(torch.int32)


def _sort_unpack(carry, lay: CarryLayout, W: int, C: int):
    B, K = int(carry.shape[0]), mask_words(W)
    v = lay.view
    masks = v(carry, "masks").to(torch.int64).reshape(B, C, K) & 0xFFFFFFFF
    return (masks, v(carry, "states").clone(), v(carry, "f").clone(),
            v(carry, "a").clone(), v(carry, "b").clone(),
            v(carry, "open") != 0, v(carry, "ok")[:, 0] != 0,
            v(carry, "overflow")[:, 0] != 0, v(carry, "dirty")[:, 0] != 0)


def _sort_pack(state, carry, lay: CarryLayout, left):
    masks, states, sf, sa, sb, so, ok, overflow, dirty = state
    B = int(carry.shape[0])
    masks, states = canonical_frontier(masks, states)
    out = carry.clone()
    v = lay.view
    v(out, "masks")[:] = wrap_i32(masks.reshape(B, -1))
    v(out, "states")[:] = states
    for name, x in (("f", sf), ("a", sa), ("b", sb), ("open", so)):
        v(out, name)[:] = x.to(torch.int32)
    for name, x in (("ok", ok), ("overflow", overflow), ("dirty", dirty),
                    ("left", left)):
        v(out, name)[:, 0] = x.to(torch.int32)
    return out


def sort_chunk_plain(carry, events, n_slots: int, n_configs: int,
                     macro_p: Optional[int] = None, *, model,
                     width: Optional[int] = None,
                     stats: Optional[dict] = None):
    """One chunk of the sort scan in plain PyTorch: the body of
    `sort_scan_plain` over the rows of `events` [B, w, R] (each row's
    first `left`; `width`, default w, the slice's length in the
    schedule) from the carry [B, L] of `sort_carry_layout`; the frontier
    written back canonical. Returns (carry', decided, exhausted, ok,
    overflow), the reference's `chunk_step_fns` contract; `stats` as
    `sort_scan_plain`'s."""
    W, C = int(n_slots), int(n_configs)
    lay = sort_carry_layout(W, C)
    acc = ({k: torch.zeros((), dtype=torch.int64, device=carry.device)
            for k in SORT_STATS} if stats is not None else None)
    step = _sort_step(model, W, C, macro_p, carry.device, acc)
    state, left = chunk_scan(step, _sort_unpack(carry, lay, W, C), events,
                             lay.view(carry, "left")[:, 0], width)
    out = _sort_pack(state, carry, lay, left)
    if stats is not None:
        for k, v in acc.items():
            stats[k] = stats.get(k, 0) + int(v)
    return (out,) + chunk_flags(out, lay)


# ------------------------------------------------------------ the kernel

#: Launch count of the sort kernel's wrapper: one is added where it
#: launches its kernel and nowhere else.
LAUNCHES = {"sort_scan": 0}
#: The same for the sort kernel's chunk entry point.
CHUNK_LAUNCHES = {"sort_scan_chunk": 0}
#: The same for the one-shot entry's counting instances (``counts=True``),
#: counted apart from LAUNCHES.
COUNT_LAUNCHES = {"sort_scan_count": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CHUNK_LAUNCHES, COUNT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def chunk_launch_counts() -> dict:
    return dict(CHUNK_LAUNCHES)


def count_launch_counts() -> dict:
    return dict(COUNT_LAUNCHES)


def sort_shape(n_slots: int, n_configs: int, threads: Optional[int] = None,
               smem_cap: Optional[int] = None) -> tuple:
    """The sort kernel's launch shape at (W, C), from the kernel's own
    rule (ops/csrc/sort_scan.cu `sort_shape`): (threads a block, tile —
    the candidates a round forms at once —, log2 of the hash table's
    slots, dynamic shared memory bytes). `threads` and `smem_cap` (bytes)
    override the defaults. Loads the library (card only)."""
    W, C = int(n_slots), int(n_configs)
    _check_caps(W, C)
    out = (ctypes.c_longlong * 4)()
    rc = _build.load("sort_scan").sort_scan_shape(
        W, C, int(threads or 0), int(smem_cap or 0), out)
    if rc != 0:
        raise ValueError(f"sort_scan: {_build.error_string('sort_scan', rc)}")
    return tuple(int(x) for x in out)


#: Threads a block of the sort kernel holds at most: its launch bound at
#: one mask word (K = 1); at more words, half of it (sort_scan.cu
#: kMaxThreads, `__launch_bounds__` of sort_scan_block).
SORT_MAX_THREADS = 1024

#: The default cap on a block's dynamic shared memory under which
#: `sort_shape`'s tile halves (sort_scan.cu kSmemCapDefault).
SORT_SMEM_CAP_DEFAULT = 96 * 1024


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p = p * 2
    return p


def sort_smem_plain(n_slots: int, n_configs: int, n_words: int, tile: int,
                    table_log2: int) -> int:
    """Dynamic shared memory bytes of one block of the sort kernel at (W,
    C, K mask words, tile, log2 of the table's slots): the C++ rule
    (ops/csrc/sort_scan.cu `sort_smem`) in plain Python — the frontier
    with a round's appended entries, the sort buffer, a tiled round's
    parents, K ≥ 2's staged candidates (keys of ⌈(K + 2) / 2⌉ 64-bit
    words), the hash table (64-bit slots at K = 1, else 32-bit) and
    K ≥ 2's claimed slots (two ints a candidate)."""
    W, C, K = n_slots, n_configs, n_words
    key_bytes = 8 * ((K + 2) // 2)
    p = _pow2_at_least(C)
    ent = C + tile if C + tile > p else p
    par = C if C * W > tile else 0
    cbuf = tile if K >= 2 else 0
    wslot = 2 * tile if K >= 2 else 0
    table = (1 << table_log2) * (8 if K == 1 else 4)
    return (ent + C + par + cbuf) * key_bytes + table + wslot * 4


def sort_shape_plain(n_slots: int, n_configs: int, threads=None,
                     smem_cap=None) -> tuple:
    """`sort_shape` without a card: the C++ rule (ops/csrc/sort_scan.cu
    `sort_shape`) in plain Python, for the same arguments the same
    (threads, tile, table log2, dynamic shared memory bytes). Threads
    default to a quarter of a round's most candidates (C·W rounded up to
    a power of two), cut to whole warps in [32, the kernel's bound]; the
    tile starts at a round's most candidates, at most 8 a thread, and
    halves (not below the block) until the block's shared memory fits
    `smem_cap` (default SORT_SMEM_CAP_DEFAULT). The lint's kernel
    contract runs it over the legal domain, and chip_smoke.py holds it to
    the library's `sort_scan_shape`."""
    W, C = int(n_slots), int(n_configs)
    threads, smem_cap = int(threads or 0), int(smem_cap or 0)
    K = W // 32 + 1
    want = _pow2_at_least(C * W)
    bound = SORT_MAX_THREADS if K == 1 else SORT_MAX_THREADS // 2
    t = threads // 32 * 32 if threads > 0 else want // 4
    t = max(32, min(bound, t))
    tile = min(want, 8 * t)
    cap = smem_cap if smem_cap > 0 else SORT_SMEM_CAP_DEFAULT
    while True:
        tlog = 0
        while (1 << tlog) < 2 * (C + tile):
            tlog += 1
        smem = sort_smem_plain(W, C, K, tile, tlog)
        if smem <= cap or tile <= t:
            return (t, tile, tlog, smem)
        tile = tile // 2


def _check_caps(W: int, C: int) -> None:
    if not 1 <= W <= MAX_SLOTS:
        raise ValueError(f"sort_scan: W={W} beyond 1..{MAX_SLOTS}")
    if not 1 <= C <= MAX_CONFIGS:
        raise ValueError(f"sort_scan: n_configs={C} beyond 1..{MAX_CONFIGS}")


def _kernel_model(model) -> int:
    code = getattr(model, "KERNEL_MODEL", None)
    if code is None:
        raise ValueError(f"sort_scan: model {type(model).__name__} has no "
                         f"device step in the CUDA kernel")
    return int(code)


def sort_scan(events, n_slots: int, n_configs: int,
              macro_p: Optional[int] = None, n_events=None, *, model,
              counts: bool = False, real=None):
    """The sort-frontier scan over a batch: (ok [B] bool, overflow [B]
    bool), and with `counts` (ok, overflow, counts): int64 [2] (n_valid =
    Σ ok & ~overflow & real, n_unknown = Σ overflow & real), B10's counts
    in sort mode, `real` [B] bool (default: every row) masking padding
    rows out.

    events [B, E, 5] int32 (legacy rows) or [B, E, 3 + 4·P] int32 (macro
    rows, macro_p=P); n_events [B] int32 real row counts (default: all E
    rows); W = n_slots ≤ MAX_SLOTS, C = n_configs ≤ MAX_CONFIGS; any
    model with a `KERNEL_MODEL`. A CPU tensor takes `sort_scan_plain`; a
    CUDA tensor launches the hand-written kernel (ops/csrc/sort_scan.cu,
    one block per history, `sort_shape`) on the current stream without
    synchronising, or raises; with `counts` the kernel's instance that
    counts in its epilogue (on the CPU `verdict_counts_plain` of the
    plain version's flags). A hash table that fills traps the kernel:
    the next synchronisation raises."""
    if events.device.type == "cpu":
        ok, overflow = sort_scan_plain(events, n_slots, n_configs, macro_p,
                                       n_events, model=model)
        return (ok, overflow, scan_counts_plain(ok, overflow, real, "sort")) \
            if counts else (ok, overflow)
    ready = sort_scan_launcher(events, n_slots, n_configs, macro_p, n_events,
                               model=model, counts=counts, real=real)
    ready[-1](torch.cuda.current_stream(events.device))
    return ready[:-1]


def sort_scan_launcher(events, n_slots: int, n_configs: int,
                       macro_p: Optional[int] = None, n_events=None, *,
                       model, shape: Optional[tuple] = None,
                       counts: bool = False, real=None):
    """Everything `sort_scan` does on the card before the launch: check
    the CUDA tensors and shape, allocate ok and overflow [B] bool (and
    with `counts` the int64 [2] counts), build or load the kernel.
    Returns (ok, overflow, launch), or (ok, overflow, counts, launch);
    launch(stream) launches the kernel on that `torch.cuda.Stream`
    without synchronising and counts it, or raises (a shape the kernel
    refuses too). `shape` (threads, tile, table log2) overrides
    `sort_shape`'s."""
    dev, B, E, R, P, n_events = _card_rows("sort_scan", events, macro_p,
                                           n_events)
    W, C = int(n_slots), int(n_configs)
    _check_caps(W, C)
    code = _kernel_model(model)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    overflow = torch.empty((B,), dtype=torch.bool, device=dev)
    check_real(real, B, dev)
    tally = counts_out(B, dev) if counts else None
    lib = _build.load("sort_scan")
    threads, tile, tlog = (shape or sort_shape(W, C))[:3]
    launch = _launch_fn(
        "sort_scan", lib, (events, n_events, ok, overflow, real, tally),
        (B, E, R, P, W, C, code, int(model.init_state()), threads, tile,
         tlog, _device_index(dev)), B,
        *((COUNT_LAUNCHES, "sort_scan_count") if counts else (LAUNCHES,)))
    return (ok, overflow, tally, launch) if counts else \
        (ok, overflow, launch)


def sort_chunk(carry, events, n_slots: int, n_configs: int,
               macro_p: Optional[int] = None, *, model,
               width: Optional[int] = None):
    """One chunk of the sort scan: (carry', decided, exhausted, ok,
    overflow), the contract of `sort_chunk_plain`. A CPU tensor takes the
    plain version; a CUDA tensor launches the chunk entry point of the sort
    kernel (ops/csrc/sort_scan.cu: the one-shot kernel's body, reading
    the carry's live entries at the start and writing the frontier back
    sorted, with the four flags, at the end) on the current stream, or
    raises."""
    if events.device.type == "cpu":
        return sort_chunk_plain(carry, events, n_slots, n_configs, macro_p,
                                model=model, width=width)
    out, flags, launch = sort_chunk_launcher(carry, events, n_slots,
                                             n_configs, macro_p, model=model,
                                             width=width)
    launch(torch.cuda.current_stream(events.device))
    return _flags(out, flags)


def sort_chunk_launcher(carry, events, n_slots: int, n_configs: int,
                        macro_p: Optional[int] = None, *, model,
                        width: Optional[int] = None):
    """Check the CUDA tensors, allocate carry' and flags [4, B] bool,
    build or load the kernel: (carry', flags, launch)."""
    W, C = int(n_slots), int(n_configs)
    _check_caps(W, C)
    lay = sort_carry_layout(W, C)
    dev, B, w, R, P, width, stride = _chunk_rows(
        "sort_scan_chunk", carry, events, macro_p, lay, width)
    code = _kernel_model(model)
    out, flags = _chunk_out(carry, B, dev)
    lib = _build.load("sort_scan")
    threads, tile, tlog = sort_shape(W, C)[:3]
    return out, flags, _launch_fn(
        "sort_scan_chunk", lib, (events, carry, out, flags),
        (stride, B, width, R, P, W, C, code, lay.length, threads, tile, tlog,
         _device_index(dev)), B, CHUNK_LAUNCHES)


def make_sort_chunk_checker(model, n_configs: int = DEFAULT_N_CONFIGS,
                            n_slots: int = MAX_SLOTS,
                            macro_p: Optional[int] = None):
    """The chunk pair of one sort rung, as the reference's
    `make_sort_chunk_checker` (ops/linear_scan.py:351): (init_fn,
    step_fn) with

      init_fn(n_events [B] int32) -> carry [B, L] int32
      step_fn(carry, events [B, w, R], width=None) -> (carry', decided
          [B], exhausted [B], ok [B], overflow [B])

    on the tensors' device (`sort_chunk`). Eviction is sound as in the
    reference: `ok` only falls, and once the frontier is empty nothing
    expands, so a decided row's (ok, overflow) pair is final."""
    W, C = int(n_slots), int(n_configs)

    def init_fn(n_events):
        return sort_chunk_init(n_events, W, C, model)

    def step_fn(carry, events, width=None):
        return sort_chunk(carry, events, W, C, macro_p, model=model,
                          width=width)
    return init_fn, step_fn
