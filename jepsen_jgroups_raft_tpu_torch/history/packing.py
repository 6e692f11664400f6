"""Pack an operation history into a fixed-shape int32 event tensor.

A copy of the reference's host encoder (`jepsen_jgroups_raft_tpu/history/
packing.py`), trimmed to what the port's paths run: the encode
(columnar path and dead-crashed-op prune included), batch packing (and
its per-process shard packers), macro compaction, the bucket series and
the streaming sessions' `IncrementalEncoder`.
Its output is byte-identical to the reference's (tests/test_torch_packing.py
and tests/test_torch_mesh.py pin it), so the port's kernels consume
exactly the streams the reference kernels do.

The event stream:

  OPEN  slot f a b   — an op becomes available for linearization, in a
                       slot of a sliding window of at most W concurrently
                       open ops. Slots of completed (ok) ops recycle;
                       crashed (info) ops hold theirs forever.
  FORCE slot         — the op in `slot` completed ok: every surviving
                       search configuration must have linearized it.

Closure only has to run at FORCE events (between two completions every
open op is mutually concurrent), which is what makes the macro
compaction below verdict-preserving: each run of OPENs coalesces into
the FORCE row that ends it. ``JGRAFT_MACRO_EVENTS=0`` keeps the
one-event-per-step stream.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from ..platform import env_int
from .ops import (NIL, History, Op, OpPair,  # noqa: F401  (NIL re-exported)
                  pair_ops_indexed)

# Event types.
EV_PAD = 0
EV_OPEN = 1
EV_FORCE = 2


def encode_vector_on() -> bool:
    """Whether encoding takes the columnar path (the reference's default).
    ``JGRAFT_ENCODE_VECTOR=0`` forces the per-pair loop; both give
    byte-identical output."""
    return env_int("JGRAFT_ENCODE_VECTOR", 1, minimum=0) != 0


#: Cap on opens carried by one macro-event row (row width 3 + 4·P int32
#: lanes). Dense-kernel runs (window ≤ 12) never spill at this cap.
MACRO_MAX_OPENS = 16


@dataclass
class EncodedHistory:
    """A packed history ready for the checker kernels.

    events:   [E, 5] int32 rows (etype, slot, f, a, b)
    op_index: [E]    int32 original history index of the op behind each
                     event (-1 for padding) — for counterexample reporting.
    n_slots:  width of the concurrency window actually used.
    n_ops:    number of encoded (non-dropped) ops.
    proc:     [E]    int32 dense process id of the op behind each event,
                     or None (hand-built encodings).
    """

    events: np.ndarray
    # counterexample attribution only; never read by a verdict path,
    # and derivable from the encode for identical event rows anyway
    op_index: np.ndarray  # lint: allow(fp-irrelevant)
    n_slots: int
    # recomputable from events (count of EV_OPEN rows): two histories
    # with identical hashed event bytes cannot differ in n_ops
    n_ops: int  # lint: allow(fp-irrelevant)
    proc: Optional[np.ndarray] = None

    @property
    def n_events(self) -> int:  # lint: allow(fp-irrelevant) derived: events.shape[0], and events is hashed
        return int(self.events.shape[0])


def encode_history(
    history: Union[History, Sequence[Op]],
    model,
    prune: bool = True,
) -> EncodedHistory:
    """Compile a history into the event-stream representation.

    The model provides per-pair encoding via ``model.encode_pair`` (or
    its columnar twin `encode_pairs_columnar`, the fast path); this
    function owns slot assignment and event ordering. `prune` enables
    the verdict-preserving dead-crashed-op pre-pass."""
    ops = list(history)
    pairs = pair_ops_indexed(ops)
    cols = (model.encode_pairs_columnar(pairs)
            if encode_vector_on() else None)
    if cols is not None:
        return _encode_history_columnar(ops, model, cols, prune)

    opens: dict = {}  # invoke position -> (pair, encoded)
    forces: dict = {}  # completion position -> invoke position
    for ip, cp, inv, comp in pairs:
        pair = OpPair(inv, comp)
        enc = model.encode_pair(pair)
        if enc is None:
            continue
        opens[ip] = (pair, enc)
        if enc.forced:
            # forced = "completed ok": a model claiming forced for a
            # crashed pair is inconsistent and must fail loudly.
            if cp < 0:
                raise ValueError(
                    f"model {type(model).__name__} encoded a pair with no "
                    f"completion as forced (invoke index {inv.index})")
            forces[cp] = ip
    if prune:
        _prune_dead_crashed(model, opens, forces)

    rows: List[tuple] = []
    op_idx: List[int] = []
    procs: List[int] = []
    pid_of: dict = {}
    free: List[int] = []  # min-heap of recyclable slots
    next_slot = 0
    slot_of: dict = {}  # invoke position -> slot
    for i, op in enumerate(ops):
        if i in opens:
            pair, enc = opens[i]
            if free:
                slot = heapq.heappop(free)
            else:
                slot = next_slot
                next_slot += 1
            slot_of[i] = slot
            rows.append((EV_OPEN, slot, enc.f, enc.a, enc.b))
            op_idx.append(op.index if op.index >= 0 else i)
            procs.append(pid_of.setdefault(op.process, len(pid_of)))
        elif i in forces:
            slot = slot_of[forces[i]]
            rows.append((EV_FORCE, slot, 0, 0, 0))
            op_idx.append(op.index if op.index >= 0 else i)
            procs.append(pid_of.setdefault(ops[forces[i]].process,
                                           len(pid_of)))
            heapq.heappush(free, slot)

    events = np.asarray(rows, dtype=np.int32).reshape(-1, 5)
    return EncodedHistory(
        events=events,
        op_index=np.asarray(op_idx, dtype=np.int32),
        n_slots=next_slot,
        n_ops=len(opens),
        proc=np.asarray(procs, dtype=np.int32),
    )


def _encode_history_columnar(ops, model, cols, prune: bool) -> EncodedHistory:
    """Columnar twin of the per-pair encode body: same prune fixpoint,
    same slot recycling, same event order, byte-identical output."""
    fs, as_, bs, forced, ips, cps = cols
    n = len(fs)
    forced_a = np.asarray(forced, dtype=bool)
    cps_a = np.asarray(cps, dtype=np.int64) if n else \
        np.empty(0, dtype=np.int64)
    bad = forced_a & (cps_a < 0)
    if bad.any():
        k = int(np.flatnonzero(bad)[0])
        raise ValueError(
            f"model {type(model).__name__} encoded a pair with no "
            f"completion as forced (invoke index {ops[ips[k]].index})")
    if prune and not forced_a.all():
        keep = _prune_dead_crashed_columnar(model, fs, as_, bs, forced,
                                            ips, cps)
        if keep is not None and not keep.all():
            fs = np.asarray(fs, dtype=np.int64)[keep]
            as_ = np.asarray(as_, dtype=np.int64)[keep]
            bs = np.asarray(bs, dtype=np.int64)[keep]
            forced = forced_a[keep]
            ips = np.asarray(ips, dtype=np.int64)[keep]
            cps = cps_a[keep]
            n = len(fs)

    # Event stream = OPENs at invoke positions merged with FORCEs at the
    # completion positions of forced ops, ascending by history position.
    forced_a = np.asarray(forced, dtype=bool)
    cps_a = np.asarray(cps, dtype=np.int64)
    force_ks = np.flatnonzero(forced_a)
    n_ev = n + len(force_ks)
    ev_pos = np.empty(n_ev, dtype=np.int64)
    ev_pos[:n] = ips
    ev_pos[n:] = cps_a[force_ks]
    ev_k = np.empty(n_ev, dtype=np.int64)
    ev_k[:n] = np.arange(n)
    ev_k[n:] = force_ks
    order = np.argsort(ev_pos, kind="stable")
    is_open = order < n
    which = ev_k[order]

    # Slot assignment walks events in order (recycling is
    # history-order-dependent).
    slot_of = [0] * n
    slots = [0] * n_ev
    free: List[int] = []
    next_slot = 0
    for j, (k, op_ev) in enumerate(zip(which.tolist(), is_open.tolist())):
        if op_ev:
            if free:
                s = heapq.heappop(free)
            else:
                s = next_slot
                next_slot += 1
            slot_of[k] = s
            slots[j] = s
        else:
            s = slot_of[k]
            slots[j] = s
            heapq.heappush(free, s)

    events = np.zeros((n_ev, 5), dtype=np.int32)
    events[:, 0] = np.where(is_open, EV_OPEN, EV_FORCE)
    events[:, 1] = slots
    fab = np.zeros((n, 3), dtype=np.int32)
    fab[:, 0] = fs
    fab[:, 1] = as_
    fab[:, 2] = bs
    events[is_open, 2:5] = fab[which[is_open]]

    pos_l = ev_pos[order].tolist()
    op_idx = np.fromiter(
        ((ops[p].index if ops[p].index >= 0 else p) for p in pos_l),
        dtype=np.int32, count=n_ev)
    pid_of: dict = {}
    proc = np.fromiter(
        (pid_of.setdefault(ops[p].process, len(pid_of)) for p in pos_l),
        dtype=np.int32, count=n_ev)
    return EncodedHistory(events=events, op_index=op_idx,
                          n_slots=next_slot, n_ops=n, proc=proc)


def _prune_dead_crashed_columnar(model, fs, as_, bs, forced, ips, cps):
    """Vectorized twin of `_prune_dead_crashed`: a keep mask over the
    kept-op columns, or None when the model's hooks disable pruning.
    Dropping an op only removes observers, so the fixpoint is
    order-independent."""
    tabs = model.prune_observe_enable(fs, as_, bs)
    if tabs is None:
        return None
    enable_val, enable_has, observe_val, observe_has = tabs
    n = len(fs)
    forced_a = np.asarray(forced, dtype=bool)
    ip_a = np.asarray(ips, dtype=np.int64)
    # Force position per op; unforced ops never retire (+inf sentinel).
    fpos = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    fpos[forced_a] = np.asarray(cps, dtype=np.int64)[forced_a]
    keep = np.ones(n, dtype=bool)
    candidates = np.flatnonzero(~forced_a)
    changed = True
    while changed:
        changed = False
        for c in candidates:
            if not keep[c]:
                continue
            if not enable_has[c]:
                # the op never changes state: an optional no-op
                # constrains nothing — drop
                keep[c] = False
                changed = True
                continue
            observers = (keep & observe_has & (fpos > ip_a[c])
                         & (observe_val == enable_val[c]))
            observers[c] = False
            if not observers.any():
                keep[c] = False
                changed = True
    return keep


def _prune_dead_crashed(model, opens: dict, forces: dict) -> None:
    """Drop crashed (optional) ops that provably cannot change the
    verdict, before slot assignment: if no op that could linearize after
    crashed op c observes any value c can expose, a witness with c
    re-converges without it and vice versa. Iterated to fixpoint. Models
    opt in via the enable/observe hooks; any None disables the pass."""
    if all(enc.forced for _, enc in opens.values()):
        return
    force_pos = {ip: cp for cp, ip in forces.items()}
    observers = []  # (invoke pos, force pos or None, frozenset(values))
    for ip, (pair, enc) in opens.items():
        ov = model.observe_values(enc)
        if ov is None:
            return
        observers.append((ip, force_pos.get(ip), frozenset(ov)))
    changed = True
    while changed:
        changed = False
        for ip, (pair, enc) in list(opens.items()):
            if enc.forced:
                continue
            ev = model.enable_values(enc)
            if ev is None or not set(ev):
                if ev is not None:
                    del opens[ip]
                    observers = [o for o in observers if o[0] != ip]
                    changed = True
                continue
            observed = set()
            for oip, fpos, vals in observers:
                if oip == ip:
                    continue
                if fpos is None or fpos > ip:
                    observed |= vals
            if not (set(ev) & observed):
                del opens[ip]
                observers = [o for o in observers if o[0] != ip]
                changed = True


def pad_batch_bucketed(events: np.ndarray, tables=(), floor_b: int = 8,
                       floor_e: Optional[int] = 32, multiple_b: int = 1):
    """Pad a packed [B, E, R] batch (and optional per-history [B, X]
    tables) to the pow2+midpoint bucket series: B from floor_b (then up
    to a multiple of multiple_b), E from floor_e (None keeps E exact).
    Pad rows are EV_PAD no-ops. Returns (events, tables_list,
    original_B)."""
    B, E = events.shape[0], events.shape[1]
    B2 = _bucket_pow2(B, floor_b)
    B2 = ((B2 + multiple_b - 1) // multiple_b) * multiple_b
    E2 = E if floor_e is None else _bucket_pow2(E, floor_e)
    if (B2, E2) != (B, E):
        padded = np.zeros((B2, E2) + events.shape[2:], dtype=events.dtype)
        padded[:B, :E] = events
        events = padded
    out_tables = []
    for t in tables:
        if t.shape[0] != B2:
            tp = np.zeros((B2,) + t.shape[1:], dtype=t.dtype)
            tp[:B] = t
            t = tp
        out_tables.append(t)
    return events, out_tables, B


def bucket_rows(n: int, floor: int = 8) -> int:
    """Public face of the pow2+midpoint bucket series for row counts."""
    return _bucket_pow2(n, floor)


def _bucket_pow2(n: int, floor: int) -> int:
    """Next bucket ≥ n from the series floor·{1, 1.5, 2, 3, 4, 6, 8…}."""
    b = floor
    while b < n:
        if b + b // 2 >= n:
            return b + b // 2
        b *= 2
    return b


def pack_batch(
    encoded: Iterable[EncodedHistory],
    n_events: Optional[int] = None,
) -> dict:
    """Pad a batch of encoded histories to a common event length.

    Returns numpy arrays: events [B, E, 5], op_index [B, E],
    n_events [B], n_slots [B]. Padding rows are EV_PAD no-ops."""
    encs = list(encoded)
    if not encs:
        raise ValueError("empty batch")
    E = n_events or max(e.n_events for e in encs)
    if any(e.n_events > E for e in encs):
        raise ValueError("n_events smaller than longest history")
    B = len(encs)
    events = np.zeros((B, E, 5), dtype=np.int32)
    op_index = np.full((B, E), -1, dtype=np.int32)
    ne = np.zeros((B,), dtype=np.int32)
    ns = np.zeros((B,), dtype=np.int32)
    for i, e in enumerate(encs):
        events[i, : e.n_events] = e.events
        op_index[i, : e.n_events] = e.op_index
        ne[i] = e.n_events
        ns[i] = e.n_slots
    return {
        "events": events,
        "op_index": op_index,
        "n_events": ne,
        "n_slots": ns,
    }


def macro_events_on() -> bool:
    """Whether kernels consume the macro-compacted event stream
    (`macro_compact`). ``JGRAFT_MACRO_EVENTS=0`` restores the legacy
    one-event-per-step stream; verdicts are identical either way."""
    return env_int("JGRAFT_MACRO_EVENTS", 1, minimum=0) != 0


def bucket_opens(n: int, cap: int = MACRO_MAX_OPENS) -> int:
    """Macro payload width P for a group whose longest open run is `n`:
    the pow2+midpoint series (1, 2, 3, 4, 6, 8, 12, 16) capped at
    MACRO_MAX_OPENS. Longer runs spill into latch-only macro rows."""
    return min(_bucket_pow2(max(int(n), 1), 1), cap)


def _macro_group_counts(events: np.ndarray):
    """(counts, nF, open_idx, force_idx, grp): counts[i] = opens in
    macro group i (group i's opens precede force i; group nF is the
    trailing never-forced run)."""
    events = np.asarray(events, dtype=np.int32)
    et = events[:, 0] if events.size else np.empty((0,), np.int32)
    open_idx = np.flatnonzero(et == EV_OPEN)
    force_idx = np.flatnonzero(et == EV_FORCE)
    grp = np.searchsorted(force_idx, open_idx, side="left")
    counts = np.bincount(grp, minlength=len(force_idx) + 1)
    return counts, len(force_idx), open_idx, force_idx, grp


def _macro_rows_from_counts(counts: np.ndarray, nF: int, macro_p: int) -> int:
    """Row-count half of the macro math given a history's (counts, nF):
    ⌈opens/P⌉ latch rows per group, at least one row per FORCE."""
    n_rows = -(-counts // int(macro_p))
    n_rows[:nF] = np.maximum(n_rows[:nF], 1)
    return int(n_rows.sum())


def macro_row_count(events: np.ndarray, macro_p: int) -> int:
    """Macro rows `macro_compact(events, macro_p)` would produce, without
    building them: the shard packers size the batch-global macro row
    count from this counting pass and compact only their own shard."""
    counts, nF, _, _, _ = _macro_group_counts(events)
    return _macro_rows_from_counts(counts, nF, macro_p)


def max_open_run(events: np.ndarray) -> int:
    """Longest run of consecutive OPEN events (the quantity P buckets);
    the trailing group of never-forced opens counts too."""
    counts, _, open_idx, _, _ = _macro_group_counts(events)
    if not len(open_idx):
        return 0
    return int(counts.max())


def macro_compact(events: np.ndarray, macro_p: int) -> np.ndarray:
    """Compact a packed [E, 5] event stream into macro-event rows
    [E_mac, 3 + 4·P] int32.

    Row = [mtype, force_slot, n_opens, (slot, f, a, b)·P]: each run of
    consecutive OPENs coalesces into the FORCE step that ends it. mtype
    is EV_FORCE for a macro ending in a FORCE, EV_OPEN for a latch-only
    macro (spill of a run longer than P, or the trailing run of crashed
    never-forced opens), EV_PAD for batch padding. Slots within a run
    are distinct (a slot only recycles at its FORCE), so a kernel can
    latch all payloads at once and reach the register state the legacy
    stream reaches one event at a time."""
    P = int(macro_p)
    events = np.asarray(events, dtype=np.int32)
    counts, nF, open_idx, force_idx, grp = _macro_group_counts(events)
    # Rows per group: ⌈opens/P⌉ latch rows, the last one carrying the
    # group's FORCE; a force with no fresh opens still needs its row.
    n_rows = -(-counts // P)
    n_rows[:nF] = np.maximum(n_rows[:nF], 1)
    row_base = np.concatenate([[0], np.cumsum(n_rows)])
    total = int(row_base[-1])
    rows = np.zeros((total, 3 + 4 * P), dtype=np.int32)
    if nF:
        frow = row_base[1:nF + 1] - 1
        rows[frow, 0] = EV_FORCE
        rows[frow, 1] = events[force_idx, 1]
    if len(open_idx):
        # rank of each open within its group
        starts = np.concatenate([[0], np.cumsum(counts)])
        j = np.arange(len(open_idx)) - starts[grp]
        mrow = row_base[grp] + j // P
        col = 3 + 4 * (j % P)
        for k in range(4):
            rows[mrow, col + k] = events[open_idx, 1 + k]
        rows[:, 2] = np.bincount(mrow, minlength=total)
    rows[rows[:, 0] == EV_PAD, 0] = EV_OPEN  # latch-only spill/trailing
    return rows


def pack_macro_batch(
    encoded: Iterable[EncodedHistory],
    n_events: Optional[int] = None,
    cap: int = MACRO_MAX_OPENS,
) -> dict:
    """Macro-stream twin of `pack_batch`: compact every history at one
    shared payload width P (`bucket_opens` of the batch's longest open
    run) and pad to a common macro-row count. Returns events
    [B, E_mac, 3+4·P], n_events [B] (macro row counts), n_slots [B],
    the scalar "macro_p" and "legacy_events" (the batch's longest
    one-event-per-step length)."""
    encs = list(encoded)
    if not encs:
        raise ValueError("empty batch")
    P = bucket_opens(max(max_open_run(e.events) for e in encs), cap)
    compacted = [macro_compact(e.events, P) for e in encs]
    E = n_events or max(max(c.shape[0] for c in compacted), 1)
    if any(c.shape[0] > E for c in compacted):
        raise ValueError("n_events smaller than longest macro stream")
    B = len(encs)
    events = np.zeros((B, E, 3 + 4 * P), dtype=np.int32)
    ne = np.zeros((B,), dtype=np.int32)
    ns = np.zeros((B,), dtype=np.int32)
    for i, (e, c) in enumerate(zip(encs, compacted)):
        events[i, : c.shape[0]] = c
        ne[i] = c.shape[0]
        ns[i] = e.n_slots
    return {
        "events": events,
        "n_events": ne,
        "n_slots": ns,
        "macro_p": P,
        "legacy_events": max(e.n_events for e in encs),
    }


def shard_bounds(n_rows: int, n_shards: int, index: int,
                 granularity: int = 1) -> tuple:
    """Contiguous [lo, hi) row range of shard `index` out of `n_shards`
    over `n_rows` rows, the reference's `parallel.distributed.
    shard_bounds`: the balanced cuts ``i·n_rows // n_shards`` rounded
    down to a multiple of `granularity` (the last cut stays `n_rows`),
    so with granularity the width of a process's local mesh every
    non-final shard splits evenly over its placements. Shards can be
    empty; callers tolerate a zero-row shard."""
    if not 0 <= index < n_shards:
        raise ValueError(f"shard index {index} out of range {n_shards}")
    g = max(1, int(granularity))

    def cut(i: int) -> int:
        if i >= n_shards:
            return n_rows
        return min(n_rows, (i * n_rows // n_shards) // g * g)

    return cut(index), cut(index + 1)


def _shard_slice(n_encs: int, process_index: int, process_count: int,
                 n_rows: Optional[int]) -> tuple:
    """(lo, hi, n_rows) of a per-process pack: the shard's row range over
    the global row count (≥ the batch; the rows past the batch are
    EV_PAD no-op histories of the trailing shards)."""
    n_rows = n_encs if n_rows is None else int(n_rows)
    if n_rows < n_encs:
        raise ValueError(f"n_rows {n_rows} smaller than batch {n_encs}")
    lo, hi = shard_bounds(n_rows, process_count, process_index)
    return lo, hi, n_rows


def pack_batch_shard(
    encoded: Sequence[EncodedHistory],
    process_index: int,
    process_count: int,
    n_rows: Optional[int] = None,
    n_events: Optional[int] = None,
) -> dict:
    """Per-process twin of `pack_batch`: fill only the row shard process
    `process_index` of `process_count` owns (`shard_bounds`), at the
    batch-global event length, so the shards of every process
    concatenated in process order equal `pack_batch` of the whole batch
    byte for byte. `n_rows` (≥ the batch) adds global EV_PAD
    rows. Extra keys: ``shard`` = (lo, hi) and ``n_rows_global``."""
    encs = list(encoded)
    if not encs:
        raise ValueError("empty batch")
    E = n_events or max(e.n_events for e in encs)
    if any(e.n_events > E for e in encs):
        raise ValueError("n_events smaller than longest history")
    lo, hi, n_rows = _shard_slice(len(encs), process_index, process_count,
                                  n_rows)
    B_local = hi - lo
    events = np.zeros((B_local, E, 5), dtype=np.int32)
    op_index = np.full((B_local, E), -1, dtype=np.int32)
    ne = np.zeros((B_local,), dtype=np.int32)
    ns = np.zeros((B_local,), dtype=np.int32)
    for j, e in enumerate(encs[lo:min(hi, len(encs))]):
        events[j, : e.n_events] = e.events
        op_index[j, : e.n_events] = e.op_index
        ne[j] = e.n_events
        ns[j] = e.n_slots
    return {
        "events": events,
        "op_index": op_index,
        "n_events": ne,
        "n_slots": ns,
        "shard": (lo, hi),
        "n_rows_global": n_rows,
    }


def pack_macro_batch_shard(
    encoded: Sequence[EncodedHistory],
    process_index: int,
    process_count: int,
    n_rows: Optional[int] = None,
    n_events: Optional[int] = None,
    cap: int = MACRO_MAX_OPENS,
) -> dict:
    """Per-process twin of `pack_macro_batch`: the batch-global shapes
    (payload width P from the longest open run anywhere, macro row count
    E) come from every history's counting pass (`_macro_group_counts`,
    no row assembly); only this process's shard is compacted and
    filled. The shards concatenated equal `pack_macro_batch` of the whole
    batch byte for byte. Extra keys: ``shard`` and ``n_rows_global``."""
    encs = list(encoded)
    if not encs:
        raise ValueError("empty batch")
    # one counting pass a history feeds both P and the row counts at P
    metas = [_macro_group_counts(e.events)[:2] for e in encs]
    P = bucket_opens(max(int(c.max()) if c.size else 0 for c, _ in metas),
                     cap)
    row_counts = [_macro_rows_from_counts(c, nF, P) for c, nF in metas]
    E = n_events or max(max(row_counts), 1)
    if any(c > E for c in row_counts):
        raise ValueError("n_events smaller than longest macro stream")
    lo, hi, n_rows = _shard_slice(len(encs), process_index, process_count,
                                  n_rows)
    B_local = hi - lo
    events = np.zeros((B_local, E, 3 + 4 * P), dtype=np.int32)
    ne = np.zeros((B_local,), dtype=np.int32)
    ns = np.zeros((B_local,), dtype=np.int32)
    for j, e in enumerate(encs[lo:min(hi, len(encs))]):
        c = macro_compact(e.events, P)
        events[j, : c.shape[0]] = c
        ne[j] = c.shape[0]
        ns[j] = e.n_slots
    return {
        "events": events,
        "n_events": ne,
        "n_slots": ns,
        "macro_p": P,
        "legacy_events": max(e.n_events for e in encs),
        "shard": (lo, hi),
        "n_rows_global": n_rows,
    }


# ----------------------------------------------------- streaming encoder


class IncrementalEncoder:
    """Append-only twin of ``encode_history(..., prune=False)`` for
    streaming sessions, the reference's `IncrementalEncoder`: history
    rows arrive in real-time order across segment boundaries, and each
    ``feed`` emits the newly SETTLED suffix of the event stream —
    exactly the rows `encode_history` produces for the complete history,
    in the same order, so a kernel carry advanced on the suffixes
    (`checker.schedule.CarriedScan`) reaches the same state as one
    uninterrupted scan.

    Settlement: an op's OPEN row content depends on its completion (an
    ok read encodes its observed value, a ``fail`` drops the op
    entirely), so the event at history position p can only be emitted
    once every invocation at position ≤ p has its completion RECORDED
    somewhere in the accumulated history. Jepsen's runner records an
    ``info`` row for crashed workers, so mid-run every invoke
    eventually settles; invokes still outstanding at ``feed(...,
    final=True)`` become crashed pairs — the same rule `pair_ops`
    applies to a finished history. Settled events are FINAL: appending
    rows appends events, never rewrites them (prefix stability:
    tests/test_torch_stream.py pins the emitted stream to the one-shot
    encode and to the reference's encoder at every cut).

    Pruning is off by design: `_prune_dead_crashed` keys on global
    observer structure that later appends can change. Pruning is
    verdict-preserving in both directions (its docstring), so streamed
    verdicts still match the pruned one-shot path.

    Memory: only the UNSETTLED tail of rows is retained (bounded by the
    live concurrency window in any real history); settled rows are
    dropped as their events are emitted.
    """

    def __init__(self, model):
        self.model = model
        #: columnar settle: the settled-suffix emit batch-encodes each
        #: settle's invokes through the model's columnar twin instead
        #: of per-op `encode_pair` calls. Fixed at construction
        #: (JGRAFT_ENCODE_VECTOR) and flipped off permanently if the
        #: model has no columnar hook — the two paths store different
        #: `_enc_of` payloads and must never mix mid-session. Emitted
        #: streams are byte-identical either way.
        self._vector = encode_vector_on()
        self.consumed = 0   # history rows ingested
        self.cut = 0        # rows settled (events emitted)
        self.n_ops = 0      # encoded (kept) ops
        self.n_slots = 0    # window high-water (= reference next_slot)
        self.n_events = 0   # events emitted so far
        self._tail: list = []      # Op rows at positions [cut, consumed)
        self._pending: dict = {}   # process -> invoke position
        self._comp: dict = {}      # invoke position -> completion Op
        self._inv_of: dict = {}    # completion position -> invoke position
        self._enc_of: dict = {}    # invoke position -> EncodedOp | None
        self._free: list = []      # recyclable slots (min-heap)
        self._slot_of: dict = {}   # invoke position -> slot
        self._pid_of: dict = {}    # raw process -> dense id

    @property
    def unsettled(self) -> int:
        """Rows ingested but not yet settled (the resident tail)."""
        return self.consumed - self.cut

    def validate(self, ops) -> list:
        """Parse rows and check pairing against a scratch copy of the
        pending set WITHOUT mutating the encoder — the same errors
        `pair_ops_indexed` raises (double invoke, stray completion),
        raised atomically so a rejected segment leaves the session
        re-appendable. Returns the parsed Op rows."""
        ops = [op if isinstance(op, Op) else Op.from_dict(op)
               for op in ops]
        scratch = set(self._pending)
        for op in ops:
            t = op.type
            if t == "invoke":
                if op.process in scratch:
                    raise ValueError(
                        f"process {op.process} invoked twice without "
                        f"completing")
                scratch.add(op.process)
            elif op.is_completion():
                if op.process not in scratch:
                    raise ValueError(
                        f"completion without invocation: process "
                        f"{op.process}")
                scratch.discard(op.process)
            else:
                raise ValueError(f"unknown op type: {t!r}")
        return ops

    def feed(self, ops, final: bool = False):
        """Ingest history rows and emit the newly settled events.

        Returns (events [n,5] int32, op_index [n] int32, proc [n]
        int32) — empty arrays when nothing new settled. Raises
        ValueError on malformed rows (see `validate`) without mutating
        the encoder. ``final=True`` settles everything: outstanding
        invokes become crashed pairs (`pair_ops`' end-of-history
        rule)."""
        ops = self.validate(ops)
        for op in ops:
            pos = self.consumed
            self.consumed += 1
            self._tail.append(op)
            if op.type == "invoke":
                self._pending[op.process] = pos
            else:
                ipos = self._pending.pop(op.process)
                self._comp[ipos] = op
                self._inv_of[pos] = ipos
        if self._vector:
            return self._settle_vector(final)
        return self._settle(final)

    def _settle_vector(self, final: bool):
        """Columnar twin of `_settle`: the settled prefix's invoke rows
        batch-encode through the model's
        `encode_pairs_columnar` — one tight columnar pass instead of a
        per-op `encode_pair` call with OpPair/EncodedOp construction —
        then the slot/heap emission loop runs exactly like the scalar
        path, so the emitted stream is byte-identical (differential-
        pinned at random cuts). `_enc_of` stores the bare forced flag
        here (True/False, None for dropped ops) — the only field the
        completion branch reads — where the scalar path stores the
        EncodedOp; the per-session `_vector` latch keeps the two
        representations from ever mixing."""
        advance = 0
        for op in self._tail:
            pos = self.cut + advance
            if op.type == "invoke" and pos not in self._comp \
                    and not final:
                break  # completion not recorded yet: unsettled
            advance += 1
        empty = (np.empty((0, 5), dtype=np.int32),
                 np.empty(0, dtype=np.int32),
                 np.empty(0, dtype=np.int32))
        if advance == 0:
            return empty
        pairs = []
        # completion stream position per invoke position (the
        # encode_pairs_columnar contract wants the COMPLETION's
        # position in the pair tuple, like pair_ops_indexed emits —
        # _inv_of maps completion pos -> invoke pos, so invert it;
        # every recorded completion has an entry until the completion
        # row itself settles, which is after this pass)
        cpos_of = {ip: cp for cp, ip in self._inv_of.items()}
        for j in range(advance):
            op = self._tail[j]
            if op.type == "invoke":
                pos = self.cut + j
                comp = self._comp.get(pos)
                pairs.append((pos,
                              -1 if comp is None else cpos_of[pos],
                              op, comp))
        cols = self.model.encode_pairs_columnar(pairs)
        if cols is None:
            # model without a columnar twin: latch the scalar path for
            # the session's lifetime (nothing was stored vector-style
            # yet — the scalar settle re-walks the untouched tail)
            self._vector = False
            return self._settle(final)
        fs, as_, bs, forced, ips, _cps = cols
        kept = {ip: (int(f), int(a), int(b), bool(fo))
                for ip, f, a, b, fo in zip(ips, fs, as_, bs, forced)}

        rows: list = []
        op_idx: list = []
        procs: list = []
        for j in range(advance):
            op = self._tail[j]
            pos = self.cut + j
            if op.type == "invoke":
                ent = kept.get(pos)
                self._enc_of[pos] = ent if ent is None else ent[3]
                if ent is not None:
                    f, a, b, fo = ent
                    if fo and pos not in self._comp:
                        raise ValueError(
                            f"model {type(self.model).__name__} encoded "
                            f"a pair with no completion as forced "
                            f"(invoke index {op.index})")
                    if self._free:
                        slot = heapq.heappop(self._free)
                    else:
                        slot = self.n_slots
                        self.n_slots += 1
                    self._slot_of[pos] = slot
                    rows.append((EV_OPEN, slot, f, a, b))
                    op_idx.append(op.index if op.index >= 0 else pos)
                    procs.append(self._pid_of.setdefault(
                        op.process, len(self._pid_of)))
                    self.n_ops += 1
            else:
                ipos = self._inv_of.pop(pos)
                self._comp.pop(ipos, None)
                encF = self._enc_of.pop(ipos, None)
                if encF is True:
                    slot = self._slot_of.pop(ipos)
                    rows.append((EV_FORCE, slot, 0, 0, 0))
                    op_idx.append(op.index if op.index >= 0 else pos)
                    procs.append(self._pid_of.setdefault(
                        op.process, len(self._pid_of)))
                    heapq.heappush(self._free, slot)
                elif encF is False:
                    # optional (info) op: the slot never recycles
                    self._slot_of.pop(ipos, None)
        del self._tail[:advance]
        self.cut += advance
        self.n_events += len(rows)
        events = np.asarray(rows, dtype=np.int32).reshape(-1, 5)
        return (events,
                np.asarray(op_idx, dtype=np.int32),
                np.asarray(procs, dtype=np.int32))

    def _settle(self, final: bool):
        rows: list = []
        op_idx: list = []
        procs: list = []
        advanced = 0
        for op in self._tail:
            pos = self.cut + advanced
            if op.type == "invoke":
                if pos not in self._comp and not final:
                    break  # completion not recorded yet: unsettled
                comp = self._comp.get(pos)
                enc = self.model.encode_pair(OpPair(op, comp))
                self._enc_of[pos] = enc
                if enc is not None:
                    if enc.forced and comp is None:
                        raise ValueError(
                            f"model {type(self.model).__name__} encoded "
                            f"a pair with no completion as forced "
                            f"(invoke index {op.index})")
                    if self._free:
                        slot = heapq.heappop(self._free)
                    else:
                        slot = self.n_slots
                        self.n_slots += 1
                    self._slot_of[pos] = slot
                    rows.append((EV_OPEN, slot, enc.f, enc.a, enc.b))
                    op_idx.append(op.index if op.index >= 0 else pos)
                    procs.append(self._pid_of.setdefault(
                        op.process, len(self._pid_of)))
                    self.n_ops += 1
            else:
                ipos = self._inv_of.pop(pos)
                self._comp.pop(ipos, None)
                enc = self._enc_of.pop(ipos, None)
                if enc is not None and enc.forced:
                    slot = self._slot_of.pop(ipos)
                    rows.append((EV_FORCE, slot, 0, 0, 0))
                    op_idx.append(op.index if op.index >= 0 else pos)
                    procs.append(self._pid_of.setdefault(
                        op.process, len(self._pid_of)))
                    heapq.heappush(self._free, slot)
                elif enc is not None:
                    # optional (info) op: the slot never recycles — the
                    # op stays a linearization candidate forever.
                    self._slot_of.pop(ipos, None)
            advanced += 1
        del self._tail[:advanced]
        self.cut += advanced
        self.n_events += len(rows)
        events = np.asarray(rows, dtype=np.int32).reshape(-1, 5)
        return (events,
                np.asarray(op_idx, dtype=np.int32),
                np.asarray(procs, dtype=np.int32))
