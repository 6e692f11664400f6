"""Segmented scan: a long history checked as many short seeded scans.

The port of the reference's `ops/segment_scan.py`. A single 100k-op
history packs to a ~155k-event stream, which the dense scan walks one
row after another in one warp. But the stream has provable cut points:
at an event boundary where no live op is open (live = an op whose FORCE
is still coming; crashed ops never force), every surviving
configuration's mask is a subset of the currently open crashed slots.

So the stream is cut at such quiescent boundaries into K segments, and
every segment is scanned from each configuration of its seed basis

    basis(k) = { (mask m, state s) : m ⊆ C_k, s < S }

(C_k the crashed-open slots at cut k) at the same time. Each run yields
the segment's final frontier F[2^W, S] from that seed; every frontier
update distributes over union, so a segment's effect on any start
frontier is the union of its seeds' tables. The host composes the K
tables left to right: VALID iff a nonempty frontier survives to the end
— the monolithic scan's verdict exactly. A segment starts with a
prologue that re-emits the OPEN rows of its crash set, so the slots'
transition rows re-latch (an OPEN does not change the frontier).

This module holds:

  * the planner (`find_cuts`, `plan_segments`, `_build_segment_arrays`)
    and the batch entry `check_segmented_batch` with its host
    composition — numpy, identical to the reference's plans, arrays and
    verdicts;
  * `segment_scan`, the wrapper of the hand-written CUDA kernel
    (ops/csrc/segment_scan.cu: one warp per (segment, seed), the
    frontier in registers), and `segment_scan_plain`, the same function
    in plain PyTorch, which the CPU tests use and chip_smoke.py holds
    the kernel to on the card.

The reference shards the segment axis over its device mesh; here all
segments of a batch go to one launch on one card. Where the reference
asks whether its backend is a TPU, the port reads the device: a CPU
device keeps `CPU_STEP_CELL_BUDGET` (so CPU runs plan exactly what the
reference plans on its CPU backend), a CUDA device skips it, as the TPU
does. `MAX_BASIS` holds on both.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..history.packing import EV_FORCE, EV_OPEN, EV_PAD, EncodedHistory
from ..platform import resolve_device
from . import _build
from .dense_scan import (_call_launch, _check_int32, _device_index,
                         _pad_domains, dense_layout, dense_sweep_fn)
from .kernel_ir import (DENSE_MAX_CELLS, DENSE_MAX_SLOTS, DENSE_MAX_STATES,
                        closure_fixpoint, force_arith, make_stream_step)

#: Segment the stream only when it is long enough to be worth the basis
#: overhead; shorter histories take the plain dense kernel.
LONG_HISTORY_MIN_EVENTS = 8192

#: Target events per segment (the reference's depth/width balance).
DEFAULT_BLOCK_EVENTS = 1536

#: Cap on the per-segment seed basis (2^crashed · S). Beyond it a history
#: takes the monolithic kernel.
MAX_BASIS = 256

#: Host cost gate: on a CPU device, take the segmented path only when one
#: step's cell volume NB·2^W·S stays under this budget.
CPU_STEP_CELL_BUDGET = 1 << 16


@dataclass
class SegmentPlan:
    """Host-side plan for one long history's segmented run."""

    starts: np.ndarray          # [K] segment start event index
    ends: np.ndarray            # [K] segment end event index (exclusive)
    crash_sets: list            # [K] tuple of crashed-open slot ids at start
    open_rows: list             # [K] tuple of OPEN row indices for crash_sets
    n_slots: int
    n_states: int
    val_of: np.ndarray          # [S] id→value table


def _live_opens(events: np.ndarray) -> np.ndarray:
    """[E] bool per row: True for OPEN rows whose op is later FORCEd
    (live) — the next OPEN or FORCE row of the same slot is a FORCE;
    False for OPEN rows of crashed ops and for every other row."""
    E = events.shape[0]
    live = np.zeros((E,), dtype=bool)
    et, slot = events[:, 0], events[:, 1]
    idx = np.flatnonzero((et == EV_OPEN) | (et == EV_FORCE))
    if not len(idx):
        return live
    idx = idx[np.lexsort((idx, slot[idx]))]   # by slot, then position
    nxt_force = np.zeros(len(idx), dtype=bool)
    nxt_force[:-1] = ((slot[idx[1:]] == slot[idx[:-1]])
                      & (et[idx[1:]] == EV_FORCE))
    live[idx] = nxt_force & (et[idx] == EV_OPEN)
    return live


def find_cuts(events: np.ndarray):
    """Quiescent boundaries of an event stream.

    Returns (positions, crash_sets, open_rows): cut i is *before* event
    `positions[i]`; `crash_sets[i]` is the tuple of crashed-open slots
    there and `open_rows[i]` their original OPEN row indices. The stream
    start (position 0, empty crash set) is always cut 0.
    """
    live_open = _live_opens(events)
    et, slot = events[:, 0], events[:, 1]
    is_open = et == EV_OPEN
    delta = (is_open & live_open).astype(np.int64) - (et == EV_FORCE)
    after = np.flatnonzero(np.cumsum(delta) == 0)
    # the crashed-open table changes only at a crashed OPEN: one snapshot
    # after each, and every cut reads the last one before it
    crashed: dict = {}  # slot -> OPEN row
    snaps = [((), ())]
    rows = np.flatnonzero(is_open & ~live_open)
    for r in rows.tolist():
        crashed[int(slot[r])] = r
        cs = tuple(sorted(crashed))
        snaps.append((cs, tuple(crashed[c] for c in cs)))
    which = np.searchsorted(rows, after, side="right")
    positions = [0] + (after + 1).tolist()
    crash_sets = [()] + [snaps[j][0] for j in which.tolist()]
    open_rows = [()] + [snaps[j][1] for j in which.tolist()]
    return positions, crash_sets, open_rows


def _cell_budgeted(dev) -> bool:
    """Whether `CPU_STEP_CELL_BUDGET` applies on this device (everywhere
    but the card, as the reference applies it everywhere but the TPU)."""
    return torch.device(dev).type != "cuda"


def plan_segments(model, enc: EncodedHistory,
                  block_events: int = DEFAULT_BLOCK_EVENTS,
                  min_events: int = LONG_HISTORY_MIN_EVENTS,
                  device=None) -> Optional[SegmentPlan]:
    """Decide whether (and how) to run a history segmented. None → use
    the monolithic kernel (stream too short, no usable cuts, basis too
    wide, or model/domain not dense-eligible)."""
    dev = resolve_device(device)
    if enc.n_events < min_events:
        return None
    W = max(enc.n_slots, 1)
    domain = model.dense_domain(enc.events)
    if domain is None or W > DENSE_MAX_SLOTS or \
            len(domain) > DENSE_MAX_STATES or \
            (1 << W) * len(domain) > DENSE_MAX_CELLS:
        return None
    S, val_of = _pad_domains([np.asarray(domain, np.int32)], [0])
    positions, crash_sets, open_rows = find_cuts(enc.events)
    nb = 2 ** max(len(c) for c in crash_sets) * S
    if nb > MAX_BASIS:
        return None
    if _cell_budgeted(dev) and nb * (1 << W) * S > CPU_STEP_CELL_BUDGET:
        return None
    # Greedy: next cut ≥ block_events past the segment start.
    starts, ends, segs_cs, segs_or = [0], [], [()], [()]
    for p, cs, orow in zip(positions[1:], crash_sets[1:], open_rows[1:]):
        if p - starts[-1] >= block_events and p < enc.n_events:
            ends.append(p)
            starts.append(p)
            segs_cs.append(cs)
            segs_or.append(orow)
    ends.append(enc.n_events)
    if len(starts) < 2:
        return None
    return SegmentPlan(np.asarray(starts), np.asarray(ends), segs_cs,
                       segs_or, W, S, val_of[0])


def _build_segment_arrays(enc: EncodedHistory, plan: SegmentPlan,
                          E_seg: int, NB: int, S: int):
    """Materialize one history's segment/basis inputs.

    events [K,E_seg,5] (re-OPEN prologue + slice, EV_PAD tail),
    seed_mask/seed_state [K,NB] (padded -1), basis index maps for the
    host composition. `S` is the BATCH state count, not the history's
    own: state-table padding duplicates the id-0 value, so the kernel
    can land frontier bits on duplicate state ids — the basis (and the
    composition lookups) must cover them."""
    K = len(plan.starts)
    events = np.zeros((K, E_seg, 5), dtype=np.int32)
    seed_mask = np.full((K, NB), -1, dtype=np.int32)
    seed_state = np.zeros((K, NB), dtype=np.int32)
    basis_index: list = []  # per segment: {(mask, state): basis row}
    for k in range(K):
        s0, e0 = int(plan.starts[k]), int(plan.ends[k])
        pro = len(plan.open_rows[k])
        # Prologue: re-latch each crashed-open slot's registers.
        for j, row in enumerate(plan.open_rows[k]):
            events[k, j] = enc.events[row]
        events[k, pro:pro + (e0 - s0)] = enc.events[s0:e0]
        # Basis: every subset of the crashed set × every state id.
        cs = plan.crash_sets[k]
        idx: dict = {}
        b = 0
        for sub in range(1 << len(cs)):
            mask = 0
            for j, slot in enumerate(cs):
                if sub >> j & 1:
                    mask |= 1 << slot
            for st in range(S):
                seed_mask[k, b] = mask
                seed_state[k, b] = st
                idx[(mask, st)] = b
                b += 1
        basis_index.append(idx)
    return events, seed_mask, seed_state, basis_index


def segment_lengths(plan: SegmentPlan) -> np.ndarray:
    """[K] int32 real rows of each segment: its prologue plus its slice
    (the rest of the row is EV_PAD)."""
    pro = np.asarray([len(r) for r in plan.open_rows], dtype=np.int64)
    return (pro + plan.ends - plan.starts).astype(np.int32)


def check_segmented(enc: EncodedHistory, model,
                    block_events: int = DEFAULT_BLOCK_EVENTS,
                    min_events: int = LONG_HISTORY_MIN_EVENTS,
                    device=None) -> Optional[dict]:
    """Check one long history via the segmented scan. None → caller
    should use the monolithic path."""
    [r] = check_segmented_batch([enc], model, block_events, min_events,
                                device)
    return r


@dataclass
class SegmentBatch:
    """One launch's worth of segments: the planned histories (`live`,
    indices into the batch), the bucketed window W, states S, rows per
    segment E_seg and basis NB, the kernel inputs (numpy: events [K, E_seg,
    5], val_of [K, S], seed_mask / seed_state [K, NB], n_events [K]) and,
    per planned history, (segments, basis index maps, plan) for the host
    composition."""

    live: list
    W: int
    S: int
    E_seg: int
    NB: int
    events: np.ndarray
    val_of: np.ndarray
    seed_mask: np.ndarray
    seed_state: np.ndarray
    n_events: np.ndarray
    maps: list

    def tensors(self, dev) -> list:
        """The kernel inputs on `dev`, in `segment_scan`'s order."""
        return [torch.from_numpy(a).to(dev) for a in
                (self.events, self.val_of, self.seed_mask, self.seed_state,
                 self.n_events)]


def prepare_segment_batch(encs: Sequence[EncodedHistory], model,
                          block_events: int = DEFAULT_BLOCK_EVENTS,
                          min_events: int = LONG_HISTORY_MIN_EVENTS,
                          device=None) -> Optional[SegmentBatch]:
    """Plan every history, bucket the batch, re-check the gates at the
    batch's S and W, and lay out the segments; None when no history is
    planned."""
    dev = resolve_device(device)
    plans = [plan_segments(model, e, block_events, min_events, dev)
             for e in encs]
    live = [i for i, p in enumerate(plans) if p is not None]
    if not live:
        return None
    # One shape across histories: bucket everything — then RE-CHECK the
    # basis gates with the batch-bucketed S/W. plan_segments gated each
    # history against its OWN domain size; batching a small-domain
    # many-crash history with a wide-domain one multiplies the first's
    # basis by the batch S. Offenders fall back to the monolithic path
    # (result None); shrinking `live` can shrink S, so iterate to
    # stability.
    while True:
        W = max(plans[i].n_slots for i in live)
        S = max(plans[i].n_states for i in live)
        shed = []
        for i in live:
            p = plans[i]
            nb_i = max(1 << len(c) for c in p.crash_sets) * S
            if nb_i > MAX_BASIS or (
                    _cell_budgeted(dev) and
                    nb_i * (1 << W) * S > CPU_STEP_CELL_BUDGET):
                shed.append(i)
        if not shed:
            break
        live = [i for i in live if i not in shed]
        if not live:
            return None
    E_seg = 1
    NB = 1
    for i in live:
        p = plans[i]
        pro = max((len(c) for c in p.crash_sets), default=0)
        seg_len = int((p.ends - p.starts).max()) + pro
        E_seg = max(E_seg, seg_len)
        NB = max(NB, max(1 << len(c) for c in p.crash_sets) * S)
    E_seg = _pow2(E_seg)
    NB = _pow2(NB)
    rows = ([], [], [], [], [])
    maps = []
    for i in live:
        p = plans[i]
        ev, sm, ss_, bidx = _build_segment_arrays(encs[i], p, E_seg, NB, S)
        # Re-bucket this history's S up to the batch S (harmless pad:
        # duplicate id-0 values transition identically).
        val = np.full((len(ev), S), p.val_of[0], dtype=np.int32)
        val[:, :len(p.val_of)] = p.val_of
        for acc, x in zip(rows, (ev, val, sm, ss_, segment_lengths(p))):
            acc.append(x)
        maps.append((len(ev), bidx, p))
    return SegmentBatch(live, W, S, E_seg, NB,
                        *(np.concatenate(x) for x in rows), maps)


def compose_segment_tables(batch: SegmentBatch, F: np.ndarray) -> list:
    """Host composition: chain each planned history's segment relations
    through the final frontiers F [K, NB, 2^W, S] bool; one result dict
    per history of `batch.live`."""
    out = []
    row = 0
    for K, bidx, p in batch.maps:
        reach = {(0, 0)}
        for k in range(K):
            acc = None
            for (m, st) in reach:
                b = bidx[k].get((m, st))
                if b is None:
                    # A reachable config outside the planned basis would
                    # be a soundness bug (cut spaces are nested) — fail
                    # loudly rather than report a verdict.
                    raise AssertionError(
                        f"segment {k}: config ({m},{st}) outside basis")
                f = F[row + k, b]
                acc = f if acc is None else (acc | f)
            if acc is None or not acc.any():
                reach = set()
                break
            ms, sts = np.nonzero(acc)
            reach = set(zip(ms.tolist(), sts.tolist()))
        out.append({
            "valid": bool(reach),
            "segments": K,
            "basis": batch.NB,
            "n_slots": p.n_slots,
        })
        row += K
    return out


def check_segmented_batch(encs: Sequence[EncodedHistory], model,
                          block_events: int = DEFAULT_BLOCK_EVENTS,
                          min_events: int = LONG_HISTORY_MIN_EVENTS,
                          device=None, stats: Optional[dict] = None) -> list:
    """Batch form: all eligible histories' segments go to ONE kernel
    launch (the segment axis is the batch axis). Returns a result dict
    per history, or None per history that should take the monolithic
    path. `stats`, when given, accumulates the host and kernel seconds:
    "plan_s" (planning and layout), "kernel_s" (the launch, tables back
    to the host) and "compose_s"."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    batch = prepare_segment_batch(encs, model, block_events, min_events, dev)
    results: list = [None] * len(encs)
    t1 = time.perf_counter()
    if batch is None:
        _tally(stats, plan_s=t1 - t0)
        return results
    # every segment of the batch in one launch on the card
    ev, vo, sm, st, ne = batch.tensors(dev)
    F = segment_scan(ev, vo, sm, st, batch.W, ne, model).cpu().numpy()
    t2 = time.perf_counter()
    for i, r in zip(batch.live, compose_segment_tables(batch, F)):
        results[i] = r
    _tally(stats, plan_s=t1 - t0, kernel_s=t2 - t1,
           compose_s=time.perf_counter() - t2)
    return results


def _tally(stats: Optional[dict], **kw) -> None:
    if stats is not None:
        for k, v in kw.items():
            stats[k] = stats.get(k, 0.0) + v


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


# ----------------------------------------------------------- plain version

#: Work counters of `segment_scan_plain`, over (segment, seed) runs whose
#: frontier is still nonempty: event rows scanned, OPEN rows latched,
#: FORCE rows, closure sweeps, and sweeps × open slots.
SEGMENT_STATS = ("rows", "opens", "force_rows", "sweeps", "slot_passes")


def segment_scan_plain(events, val_of, seed_mask, seed_state, n_slots: int,
                       n_events=None, model=None,
                       stats: Optional[dict] = None):
    """B6 in plain PyTorch, following the reference's
    `make_segment_kernel` step for step, batched over every (segment,
    seed) pair: a frontier seeded at (seed_mask, seed_state) — empty for
    seed_mask < 0 —, transition rows latched per OPEN, closure to
    fixpoint only at a FORCE after an OPEN, FORCE kill and shift, EV_PAD
    rows as no-ops. A run whose frontier is empty drops out of the batch
    (it stays empty: its table is all zeros).

    events [K, E, 5] int32 (legacy rows), val_of [K, S] int32, seed_mask
    and seed_state [K, NB] int32, n_events [K] real rows per segment
    (rows at or past it are no-ops; default all E). Returns the final
    frontier F [K, NB, 2^W, S] bool on events' device. `stats`, when
    given, accumulates SEGMENT_STATS."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
    W, S = int(n_slots), int(val_of.shape[1])
    M = 1 << W
    K, E = int(events.shape[0]), int(events.shape[1])
    NB = int(seed_mask.shape[1])
    B = K * NB
    dev = events.device
    slot_ids = torch.arange(W, dtype=torch.int32, device=dev)
    sm = seed_mask.reshape(B).to(torch.int64)
    ss = seed_state.reshape(B).to(torch.int64)
    F0 = ((torch.arange(M, device=dev)[None, :, None] == sm[:, None, None])
          & (torch.arange(S, device=dev)[None, None, :]
             == ss[:, None, None])
          & (sm >= 0)[:, None, None])
    n_ev = (torch.full((K,), E, dtype=torch.int64, device=dev)
            if n_events is None else
            torch.as_tensor(n_events, device=dev).to(torch.int64))
    # the runs still in the batch: their run ids, segments, tables, ends
    ids = F0.flatten(1).any(dim=1).nonzero().squeeze(1)
    seg = ids // max(NB, 1)
    run = {"vo": val_of[seg], "n_ev": n_ev.clamp(0, E)[seg]}
    if stats is not None:
        for k in SEGMENT_STATS:
            stats.setdefault(k, 0)

    def latch(carry, slot, f, a, b, is_open, upd):
        F, T, slot_open, alive, dirty = carry
        vo = run["vo"]
        ns, legal = model.torch_step(vo, f[:, None], a[:, None], b[:, None])
        row = (ns[:, :, None] == vo[:, None, :]) & legal[:, :, None]
        T = torch.where(upd[:, :, None, None], row[:, None], T)
        if stats is not None:
            stats["opens"] += int(is_open.sum())
        return (F, T, slot_open | upd, alive, dirty | is_open)

    def force_tail(carry, is_force, slot):
        F, T, slot_open, alive, dirty = carry
        active = is_force & dirty
        if bool(active.any()):
            F, sweeps = closure_fixpoint(W, dense_sweep_fn(T, slot_open), F,
                                         active)
            if stats is not None:
                stats["sweeps"] += int(sweeps.sum())
                stats["slot_passes"] += int(
                    (sweeps * slot_open.sum(dim=1)).sum())
        dirty = dirty & ~is_force
        if stats is not None:
            stats["force_rows"] += int(is_force.sum())
        F_forced, nonempty = force_arith(F, slot.clamp(0, W - 1))
        F = torch.where(is_force[:, None, None], F_forced, F)
        alive = alive & (~is_force | nonempty)
        slot_open = slot_open & ~((slot_ids[None, :] == slot[:, None])
                                  & is_force[:, None])
        return (F, T, slot_open, alive, dirty)

    step = make_stream_step(W, latch, None, force_tail)
    n = len(ids)
    carry = (F0[ids], torch.zeros((n, W, S, S), dtype=torch.bool, device=dev),
             torch.zeros((n, W), dtype=torch.bool, device=dev),
             torch.ones((n,), dtype=torch.bool, device=dev),
             torch.zeros((n,), dtype=torch.bool, device=dev))
    n_scan = min(E, int(n_ev.max())) if K else 0
    for e in range(n_scan):
        alive = carry[3]
        if not bool(alive.all()):
            keep = alive.nonzero().squeeze(1)
            ids, seg = ids[keep], seg[keep]
            run = {k: v[keep] for k, v in run.items()}
            carry = tuple(x[keep] for x in carry)
        if not len(ids):
            break
        rows = events[seg, e]
        live_row = e < run["n_ev"]
        rows = torch.where(live_row[:, None], rows,
                           torch.full_like(rows, EV_PAD))
        if stats is not None:
            stats["rows"] += int(live_row.sum())
        carry = step(carry, rows)
    F = torch.zeros((B, M, S), dtype=torch.bool, device=dev)
    F[ids] = carry[0] & carry[3][:, None, None]
    return F.view(K, NB, M, S)


# ------------------------------------------------------------ the kernel

#: Launch count of the segment kernel (see ops.dense_scan.LAUNCHES).
LAUNCHES = {"segment_scan": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def segment_words(n_slots: int, field_log2: int) -> int:
    """32-bit words of one packed final frontier in the kernel's output
    (bit b = m·2^field_log2 + s; at least one word)."""
    return max(1 << (int(n_slots) + int(field_log2)), 32) // 32


def segment_scan(events, val_of, seed_mask, seed_state, n_slots: int,
                 n_events=None, model=None):
    """B6 over a batch of segments: the final frontier of every (segment,
    seed) pair, F [K, NB, 2^W, S] bool.

    events [K, E, 5] int32 (legacy rows), val_of [K, S] int32, seed_mask
    and seed_state [K, NB] int32, n_events [K] int32 real rows per
    segment (default all E). A CPU tensor takes `segment_scan_plain`; a
    CUDA tensor launches the hand-written kernel
    (ops/csrc/segment_scan.cu, one warp per (segment, seed), instantiated
    for `dense_layout(W, S)`) on the current stream, which writes each
    frontier bit-packed [K, NB, words]; the wrapper unpacks it. Raises on
    anything else."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
    if events.device.type == "cpu":
        return segment_scan_plain(events, val_of, seed_mask, seed_state,
                                  n_slots, n_events, model)
    if events.device.type != "cuda":
        raise ValueError(f"segment_scan: unsupported device {events.device}")
    dev = events.device
    _check_int32("events", events, 3, dev)
    K, E, R = (int(x) for x in events.shape)
    if R != 5:
        raise ValueError(f"segment_scan: rows must be legacy (5 ints), "
                         f"got {R}")
    for name, t in (("val_of", val_of), ("seed_mask", seed_mask),
                    ("seed_state", seed_state)):
        _check_int32(name, t, 2, dev)
        if t.shape[0] != K:
            raise ValueError(f"segment_scan: {name} rows differ from "
                             f"events rows")
    if seed_state.shape != seed_mask.shape:
        raise ValueError("segment_scan: seed_state and seed_mask differ "
                         "in shape")
    if n_events is None:
        n_events = torch.full((K,), E, dtype=torch.int32, device=dev)
    _check_int32("n_events", n_events, 1, dev)
    if n_events.shape[0] != K:
        raise ValueError("segment_scan: n_events must be [K]")
    W, S, NB = int(n_slots), int(val_of.shape[1]), int(seed_mask.shape[1])
    layout = dense_layout(W, S)
    code = getattr(model, "KERNEL_MODEL", None)
    if code is None:
        raise ValueError(f"segment_scan: model {type(model).__name__} has "
                         f"no device step in the CUDA kernel")
    n_words = segment_words(W, layout.field_log2)
    words = torch.empty((K, NB, n_words), dtype=torch.int32, device=dev)
    if K and NB:
        lib = _build.load("segment_scan")
        _call_launch("segment_scan", lib,
                     (events, val_of, seed_mask, seed_state, n_events,
                      words),
                     (K, NB, E, W, S, layout.field_log2, int(code),
                      _device_index(dev)),
                     torch.cuda.current_stream(dev))
        LAUNCHES["segment_scan"] += 1
    bits = (words[..., None] >> torch.arange(32, dtype=torch.int32,
                                             device=dev)) & 1
    FS = 1 << layout.field_log2
    F = bits.reshape(K, NB, n_words * 32)[:, :, :(1 << W) * FS]
    return F.reshape(K, NB, 1 << W, FS)[..., :S].to(torch.bool)

