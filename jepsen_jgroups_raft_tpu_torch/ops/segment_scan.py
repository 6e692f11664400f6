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
    (ops/csrc/segment_scan.cu: one CTA per segment or group of its
    seeds, the rows' descriptors and the OPENs' transition rows prepared
    once in shared memory for all of its runs, each run's frontier in
    registers, several runs a warp where a frontier is narrow; its launch
    shape is `segment_shape`), and `segment_scan_plain`, the same
    function in plain PyTorch, which the CPU tests use and chip_smoke.py
    holds the kernel to on the card.

The reference shards the segment axis over its device mesh
(`jepsen_jgroups_raft_tpu/ops/segment_scan.py:397`); here the segments
of a batch go to one launch on the process's device, or, when the check
fans out (the mesh its caller passes, `parallel.mesh.chunk_sharding`),
to one launch a placement over a contiguous block of segments, the
blocks' final tables joined in segment order before the host composes
them. Where
the reference asks whether its backend is a TPU, the port reads the
device: a CPU device keeps `CPU_STEP_CELL_BUDGET` (so CPU runs plan
exactly what the reference plans on its CPU backend), a CUDA device
skips it, as the TPU does. `MAX_BASIS` holds on both.
"""

from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..history.packing import EV_FORCE, EV_OPEN, EV_PAD, EncodedHistory
from ..platform import resolve_device
from . import _build
from .dense_scan import (_call_launch, _check_int32, _device_index,
                         _pad_domains, dense_layout, dense_sweep_fn)
from .kernel_ir import (DENSE_MAX_CELLS, DENSE_MAX_SLOTS, DENSE_MAX_STATES,
                        closure_fixpoint, force_arith, join_rows,
                        make_stream_step, over_shards)

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
        return [torch.from_numpy(a).to(dev) for a in  # lint: allow(host-sync) the segments' inputs go up once (pageable)
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
                          device=None, stats: Optional[dict] = None,
                          mesh=None) -> list:
    """Batch form: all eligible histories' segments go to ONE kernel
    launch on `device` (the segment axis is the batch axis), or, with the
    check's fan-out `mesh` (a `parallel.mesh.Mesh` of `device`'s kind,
    `parallel.mesh.chunk_sharding`), one launch a placement
    (`_segment_tables`). Returns a result dict
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
    F = _segment_tables(batch, model,
                        mesh.devices if mesh is not None else (dev,))
    t2 = time.perf_counter()
    for i, r in zip(batch.live, compose_segment_tables(batch, F)):
        results[i] = r
    _tally(stats, plan_s=t1 - t0, kernel_s=t2 - t1,
           compose_s=time.perf_counter() - t2)
    return results


def _segment_tables(batch: SegmentBatch, model, devices) -> np.ndarray:
    """The final tables F [K, NB, 2^W, S] of every segment of `batch`,
    in segment order, on the host: one B6 launch a placement of
    `devices` over a contiguous block of segments, each on its own
    stream (`kernel_ir.over_shards`; one device is one launch over every
    segment), the blocks' tables joined in segment order, as the
    reference shards the segment axis over its mesh."""
    def launch(ev, vo, sm, st, ne):
        return segment_scan(ev, vo, sm, st, batch.W, ne, model)

    return join_rows(over_shards(devices, launch, batch.events,
                                 batch.val_of, batch.seed_mask,
                                 batch.seed_state, batch.n_events))[0]


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
            torch.as_tensor(n_events, device=dev).to(torch.int64))  # lint: allow(host-sync) the plain version's row lengths
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
                stats["slot_passes"] += int(  # lint: allow(host-sync) the plain version's work counter
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
    n_scan = min(E, int(n_ev.max())) if K else 0  # lint: allow(host-sync) the plain version's loop bound
    for e in range(n_scan):
        alive = carry[3]
        if not bool(alive.all()):  # lint: allow(host-sync) the plain version's row eviction
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


#: Warps a CTA of the kernel holds at most (its launch bound). At 4 the
#: 101 segments of config 5 take 202 CTAs and reach the 31 SMs that 8
#: leave idle, but 70 SMs still hold 8 warps and every CTA prepares its
#: segment again: 4.8 % slower on the card (PERF.md §6).
SEGMENT_MAX_WARPS = 8

#: Rows a CTA prepares into shared memory at a time: a launch's tile is
#: min(E, SEGMENT_MAX_TILE_ROWS), so a segment of the planner's size
#: (DEFAULT_BLOCK_EVENTS plus its prologue, E = 2048) is one tile.
SEGMENT_MAX_TILE_ROWS = 2048


class SegmentShape(NamedTuple):
    """The kernel's launch shape for a batch: runs (seeds) a warp — the
    warp's lanes split among narrow frontiers —, warps a CTA, and CTAs a
    segment."""
    seeds_per_warp: int
    warps: int
    ctas_per_segment: int


def segment_shape(n_slots: int, n_states: int, n_seeds: int) -> SegmentShape:
    """The launch shape at window W, domain table S and NB seeds a
    segment, from those alone: a run's frontier of 2^(W + field_log2)
    bits fills max(1, bits / 32) lanes (all 32 from 2^10 bits on), so a
    warp holds 32 / lanes runs; a CTA holds the warps that cover NB runs,
    up to SEGMENT_MAX_WARPS, and more seeds take more CTAs of the same
    segment (each prepares the segment's rows itself). Plain Python: runs
    without a card; ops/csrc/segment_scan.cu computes the same runs a
    warp and CTAs a segment from the warps it is given."""
    field_log2 = dense_layout(n_slots, n_states).field_log2
    return segment_shape_at(n_slots, field_log2, n_seeds)


def segment_shape_at(n_slots: int, field_log2: int,
                     n_seeds: int) -> SegmentShape:
    """`segment_shape` at window W and state field width field_log2 (the
    layout's, `dense_layout(W, S).field_log2`)."""
    bits = int(n_slots) + int(field_log2)
    lanes = 32 if bits >= 10 else 1 << max(bits - 5, 0)
    per_warp = 32 // lanes
    nb = max(int(n_seeds), 1)
    warps = min(SEGMENT_MAX_WARPS, -(-nb // per_warp))
    return SegmentShape(per_warp, warps, -(-nb // (per_warp * warps)))


def segment_tile(n_rows: int) -> int:
    """Rows a CTA prepares into shared memory at a time for segments of
    E rows: min(E, SEGMENT_MAX_TILE_ROWS), at least one."""
    return max(1, min(int(n_rows), SEGMENT_MAX_TILE_ROWS))


def segment_smem_bytes(n_slots: int, field_log2: int, warps: int,
                       tile: int) -> int:
    """Dynamic shared memory bytes of one CTA of the kernel (the C++ rule,
    ops/csrc/segment_scan.cu `smem_bytes`, in plain Python): the tile's
    row descriptors and its OPENs' transition rows (2^field_log2 words a
    row), and each warp's latched rows T[W][2^field_log2]."""
    fs = 1 << int(field_log2)
    return 4 * (int(tile) * (1 + fs) + int(warps) * int(n_slots) * fs)


def segment_words(n_slots: int, field_log2: int) -> int:
    """32-bit words of one packed final frontier in the kernel's output
    (bit b = m·2^field_log2 + s; at least one word)."""
    return max(1 << (int(n_slots) + int(field_log2)), 32) // 32


def _unpack(words, n_slots: int, n_states: int, field_log2: int):
    """The kernel's packed frontiers words [K, NB, n_words] int32 as F [K,
    NB, 2^W, S] bool."""
    K, NB, n_words = (int(x) for x in words.shape)
    bits = (words[..., None] >> torch.arange(32, dtype=torch.int32,
                                             device=words.device)) & 1
    FS = 1 << field_log2
    F = bits.reshape(K, NB, n_words * 32)[:, :, :(1 << n_slots) * FS]
    return F.reshape(K, NB, 1 << n_slots, FS)[..., :n_states].to(torch.bool)


def segment_scan_launcher(events, val_of, seed_mask, seed_state,
                          n_slots: int, n_events=None, model=None,
                          library: str = "segment_scan", prof=None):
    """Check the CUDA tensors, allocate the packed output, build or load
    `library` (the kernel, or its instrumented build with `prof`): (words
    [K, NB, n_words] int32, launch(stream)). Nothing is counted here."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
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
    words = torch.empty((K, NB, segment_words(W, layout.field_log2)),
                        dtype=torch.int32, device=dev)
    lib = _build.load(library)
    tensors = (events, val_of, seed_mask, seed_state, n_events, words,
               *(() if prof is None else (prof,)))
    sizes = (K, NB, E, W, S, layout.field_log2, int(code),
             segment_shape(W, S, NB).warps, _device_index(dev))

    def launch(stream):
        _call_launch(library, lib, tensors, sizes, stream)

    return words, launch


def segment_scan(events, val_of, seed_mask, seed_state, n_slots: int,
                 n_events=None, model=None):
    """B6 over a batch of segments: the final frontier of every (segment,
    seed) pair, F [K, NB, 2^W, S] bool.

    events [K, E, 5] int32 (legacy rows), val_of [K, S] int32, seed_mask
    and seed_state [K, NB] int32, n_events [K] int32 real rows per
    segment (default all E). A CPU tensor takes `segment_scan_plain`; a
    CUDA tensor launches the hand-written kernel
    (ops/csrc/segment_scan.cu, instantiated for `dense_layout(W, S)`, at
    `segment_shape(W, S, NB)`) on the current stream, which writes each
    frontier bit-packed [K, NB, words]; the wrapper unpacks it. Raises on
    anything else."""
    if events.device.type == "cpu":
        return segment_scan_plain(events, val_of, seed_mask, seed_state,
                                  n_slots, n_events, model)
    words, launch = segment_scan_launcher(events, val_of, seed_mask,
                                          seed_state, n_slots, n_events,
                                          model)
    if words.numel():
        launch(torch.cuda.current_stream(events.device))
        LAUNCHES["segment_scan"] += 1
    return _unpack(words, int(n_slots), int(val_of.shape[1]),
                   dense_layout(n_slots, val_of.shape[1]).field_log2)


#: Columns of `segment_scan_profile`'s counters, one row per warp of the
#: launch: SM clock cycles spent preparing tiles (the rows' descriptors
#: and transition rows, read from global memory, and the block barrier
#: after), latching OPENs, in closures, in FORCEs, and waiting at a
#: tile's end for the CTA's other warps; then rows scanned, OPENs,
#: closures, closure sweeps and slot images computed.
SEGMENT_PROFILE_FIELDS = ("stage_cycles", "latch_cycles", "closure_cycles",
                          "force_cycles", "tail_cycles", "rows", "opens",
                          "closures", "sweeps", "images")


def segment_scan_profile(events, val_of, seed_mask, seed_state,
                         n_slots: int, n_events=None, model=None):
    """The kernel's instrumented build (ops/csrc/segment_scan.cu compiled
    with -DSEGMENT_SCAN_PROFILE into a library of its own) on the current
    stream: (F [K, NB, 2^W, S] bool, prof [warps of the launch,
    len(SEGMENT_PROFILE_FIELDS)] int64). Card only; for measurement,
    never on a main path, so it is not counted in LAUNCHES."""
    K, NB = int(seed_mask.shape[0]), int(seed_mask.shape[1])
    shape = segment_shape(n_slots, val_of.shape[1], NB)
    lib = _build.load("segment_scan_profile")
    n_fields = lib.segment_scan_profile_fields()
    if n_fields != len(SEGMENT_PROFILE_FIELDS):
        raise RuntimeError(f"segment_scan_profile writes {n_fields} "
                           f"counters per warp, SEGMENT_PROFILE_FIELDS names "
                           f"{len(SEGMENT_PROFILE_FIELDS)}")
    prof = torch.zeros((K * shape.ctas_per_segment * shape.warps,
                        n_fields), dtype=torch.int64, device=events.device)
    words, launch = segment_scan_launcher(
        events, val_of, seed_mask, seed_state, n_slots, n_events, model,
        library="segment_scan_profile", prof=prof)
    if words.numel():
        launch(torch.cuda.current_stream(events.device))
    return (_unpack(words, int(n_slots), int(val_of.shape[1]),
                    dense_layout(n_slots, val_of.shape[1]).field_log2), prof)


def segment_attributes(n_slots: int, n_states: int, n_segments: int,
                       n_seeds: int, n_rows: int) -> dict:
    """The kernel instantiation for `dense_layout(W, S)` as the card's
    runtime reports it, for a launch over K segments × NB seeds of E rows
    at `segment_shape`: registers a thread, local (stack and spill)
    bytes, static shared bytes, threads a block, blocks resident on one
    SM, the launch's blocks, runs a warp, and dynamic shared bytes a
    block."""
    layout = dense_layout(n_slots, n_states)
    out = (ctypes.c_longlong * 8)()
    lib = _build.load("segment_scan")
    rc = lib.segment_scan_attributes(
        int(n_slots), layout.field_log2, int(n_segments), int(n_seeds),
        int(n_rows), segment_shape(n_slots, n_states, n_seeds).warps, out)
    if rc != 0:
        raise RuntimeError(f"segment_scan_attributes: "
                           f"{_build.error_string('segment_scan', rc)}")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "threads", "blocks_per_sm", "blocks", "seeds_per_warp",
                     "dynamic_smem_bytes"), list(out)))
