"""The chunked wavefront, the one-shot launches and the port's run
counters.

`run_chunked` is the reference's chunked wavefront (checker/schedule.py
:60-700), the main path at the default `JGRAFT_SCAN_CHUNK` (128): each
window group's event scan advances in chunks through the chunk forms of
the scan kernels (`ops.dense_scan.make_dense_chunk_checker`,
`ops.linear_scan.make_sort_chunk_checker`), which take and return the
carry with per-row `decided` / `exhausted` flags. Between launches the
flags come back to the host, finished rows are recorded and evicted, and
the survivors are recompacted into a smaller row bucket (the carry and
the remaining events gathered on the device with `index_select`); a
group stops once no row is left. A launch covers every chunk up to the
first boundary where a row can retire (`_span_chunks`). Verdicts equal
the one-shot scan's by construction: a decided row's (ok, overflow) is
frozen, an exhausted row has only EV_PAD rows left.

Placement follows the reference's: a group stays whole and spreads its
rows over the local mesh (`parallel.mesh.chunk_sharding`; one card, or
JGRAFT_GROUP_DEVICES=0, keeps it on the process's device). Each
placement takes a contiguous row shard (`ops.kernel_ir.
shard_chunk_fns`): its events go to that device once and every chunk is
a column slice of them there; each shard runs on a side stream of its
own, and a collect waits on an event recorded on that stream after the
flags' copy (never on a whole device), then reads the four flag
vectors. The span is chosen once for the group, so every shard launches
it and the counters are the one-device run's. What differs from the
reference: no host routing of small groups (TPU-specific); the first
launch runs at the shard's own row count (the reference pads the batch
to its row bucket, a multiple of the mesh, for its compile cache), and
recompaction follows the reference's bucket series per shard, on the
shard's own device (the reference rebalances the survivors over the
mesh; here no carry crosses placements).

`run_dense_groups` and `run_sort_rung` are the one-shot path
(`JGRAFT_SCAN_CHUNK=0`): every group's kernel launched at once, or one
rung of the sort ladder, then each shard's flags read after its own
event. Every launch path goes through one helper,
`ops.kernel_ir.over_shards`: a launch a placement over its contiguous
rows (one device: one launch over every row), everything of it queued
on the shard's side stream, the flags joined in row order and the
counts summed on the host.
`launch_dense_groups` is the launch half of `run_dense_groups`, which
`parallel.mesh.check_batch_sharded` finalizes later (``defer=True``).

A group's measured launch plan (checker/autotune.py) pins its launch's
chunk in `build_dense_launches`. `CarriedScan` keeps one streamed row's
sort carry across the appends of a streaming session, one B = 1 launch
of the sort kernel's chunk form a span.

The counters follow the reference's checker/schedule.py: per-tier
decided rows and wall (`note_tier`, `consume_tiers`) and run counters
(`consume_stats`, `snapshot_stats`; the wavefront's `chunks_run`,
`evicted_rows`, `groups_run`, `groups_early_exited`,
`pipeline_overlap_s`, the cycle tier's through `note_cycle`), both also
collected into any active `stats_scope`. `groups_run` counts wavefront
groups only, as the reference's; the port's `rows_run` and `wall_s`
count every launch path.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, List, Optional

import numpy as np
import torch

from ..history.packing import bucket_rows
from ..ops.dense_scan import (dense_scan, dense_scan_launcher, mask_scan,
                              mask_scan_launcher)
from ..ops.kernel_ir import (ChunkShard, ShardOut, join_rows, over_shards,
                             shard_chunk_fns, shard_rows)
from ..ops.linear_scan import sort_scan, sort_scan_launcher
from ..platform import env_int, resolve_device

#: Default events per chunk, the reference's (its calibration on the
#: north-star shape: most rows retire at the 1536-event boundary).
#: JGRAFT_SCAN_CHUNK overrides it; 0 selects the one-shot path.
DEFAULT_SCAN_CHUNK = 128


def scan_chunk() -> int:
    """Resolved chunk size: 0 selects the one-shot path. A non-integer
    value warns and keeps the default."""
    return env_int("JGRAFT_SCAN_CHUNK", DEFAULT_SCAN_CHUNK, minimum=0)


_STATS_LOCK = threading.Lock()
_STATS_ZERO = {"chunks_run": 0, "evicted_rows": 0, "groups_run": 0,
               "groups_early_exited": 0, "pipeline_overlap_s": 0.0,
               "rows_run": 0, "wall_s": 0.0,
               # the cycle tier's counters, as the reference keeps them:
               # rows that skipped the exact tier for size, graph nodes
               # before and after SCC condensation, non-trivial SCCs
               # hit, and blocked-closure tile programs run
               "cycle_size_skips": 0, "cycle_nodes_pre": 0,
               "cycle_nodes_post": 0, "cycle_scc_hits": 0,
               "cycle_tiles_run": 0}
_STATS = dict(_STATS_ZERO)
#: (scope dict, owner thread id), innermost last; guarded by _STATS_LOCK.
_SCOPES: List[tuple] = []
_TIERS: dict = {}  # tier -> [rows, wall_s]; guarded by _STATS_LOCK


def _targets() -> list:
    """Scopes a counter update lands in: those owned by this thread, or
    every active scope when the thread owns none (the reference's
    thread-affine rule)."""
    tid = threading.get_ident()
    owned = [s for s, o in _SCOPES if o == tid]
    return owned if owned else [s for s, _ in _SCOPES]


def _add_stats(**kw) -> None:
    with _STATS_LOCK:
        targets = _targets()
        for k, v in kw.items():
            _STATS[k] += v
            for scope in targets:
                scope[k] += v


def note_cycle(**kw) -> None:
    """Record cycle-tier counters (the ``cycle_*`` keys of the run
    counters) into the active scopes and the process totals. An unknown
    key is a programming error and raises KeyError before anything is
    recorded."""
    for k in kw:
        if k not in _STATS_ZERO:
            raise KeyError(f"unknown cycle counter {k!r}")
    _add_stats(**kw)


@contextlib.contextmanager
def stats_scope(label: Optional[str] = None):
    """Counters accumulated while the scope is active also land in the
    yielded dict (under ``"tiers"`` for tier counts), isolated from
    everything before it. Nesting- and thread-safe."""
    scope = dict(_STATS_ZERO)
    if label is not None:
        scope["label"] = label
    with _STATS_LOCK:
        _SCOPES.append((scope, threading.get_ident()))
    try:
        yield scope
    finally:
        with _STATS_LOCK:
            for i, (s, _) in enumerate(_SCOPES):
                if s is scope:  # by identity: equal dicts are not the same
                    del _SCOPES[i]
                    break


def snapshot_stats(scoped: bool = False) -> dict:
    """Copy of the run counters (non-destructive): the process totals,
    or with `scoped` the innermost active `stats_scope` this thread
    owns (the innermost of any thread's when it owns none)."""
    with _STATS_LOCK:
        if scoped and _SCOPES:
            tid = threading.get_ident()
            for s, o in reversed(_SCOPES):
                if o == tid:
                    return dict(s)
            return dict(_SCOPES[-1][0])
        return dict(_STATS)


def consume_stats() -> dict:
    """Return and reset the process-wide run counters."""
    global _STATS
    with _STATS_LOCK:
        out = dict(_STATS)
        _STATS = dict(_STATS_ZERO)
        return out


def note_tier(tier: str, rows: int = 1, wall_s: float = 0.0) -> None:
    """Record `rows` verdicts decided by `tier` and the wall seconds
    attributed to them."""
    with _STATS_LOCK:
        t = _TIERS.setdefault(tier, [0, 0.0])
        t[0] += rows
        t[1] += wall_s
        for scope in _targets():
            e = scope.setdefault("tiers", {}).setdefault(tier, [0, 0.0])
            e[0] += rows
            e[1] += wall_s


def _format_tiers(raw: dict) -> dict:
    return {k: {"rows": v[0], "wall_s": v[1]} for k, v in raw.items()}


def snapshot_tiers(scoped: bool = False) -> dict:
    """Copy of the per-tier decided counters, ``{tier: {"rows",
    "wall_s"}}`` (non-destructive). `scoped=True` reads the innermost
    scope owned by this thread, like `snapshot_stats`."""
    with _STATS_LOCK:
        if scoped and _SCOPES:
            tid = threading.get_ident()
            for s, o in reversed(_SCOPES):
                if o == tid:
                    return _format_tiers(s.get("tiers", {}))
            return _format_tiers(_SCOPES[-1][0].get("tiers", {}))
        return _format_tiers(_TIERS)


def consume_tiers() -> dict:
    """Return and reset the process-wide per-tier counters,
    ``{tier: {"rows", "wall_s"}}``."""
    global _TIERS
    with _STATS_LOCK:
        out = _format_tiers(_TIERS)
        _TIERS = {}
        return out


# ------------------------------------------------------------- launches


def _placements(device) -> tuple:
    """The devices a launch's rows spread over: a mesh's placements
    (`parallel.mesh.Mesh`), else the one device `resolve_device` gives;
    a card named without its index gets the current one's."""
    devices = getattr(device, "devices", None)
    if devices is None:
        devices = (resolve_device(device),)
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devices)


def _launch_devices(mesh, rows) -> tuple:
    """The placements a launch's rows spread over: a mesh's (one or
    several), else the one device the rows lie on."""
    return _placements(mesh) if mesh is not None else (rows.device,)


def _timed_launch(launch, stream, marks: Optional[list]) -> None:
    """launch(stream), bracketed by two CUDA events appended to `marks`
    with the stream's card, (start, end, device), when it is a list (a
    timed run)."""
    if marks is None:
        launch(stream)
        return
    a, b = _timer(), _timer()
    a.record(stream)
    launch(stream)
    b.record(stream)
    marks.append((a, b, stream.device))


def _span_ms(marks) -> Optional[float]:
    """The kernel span of (start, end, device) marks: per card from the
    earliest start to the latest end, the longest card's; None when
    there are none (untimed, or nothing on a card)."""
    by_dev: dict = {}
    for a, b, dev in marks:
        by_dev.setdefault(dev, []).append((a, b))
    spans = []
    for pairs in by_dev.values():
        ref = pairs[0][0]
        spans.append(max(ref.elapsed_time(b) for _, b in pairs)
                     - min(ref.elapsed_time(a) for a, _ in pairs))
    return max(spans) if spans else None


@dataclass
class DenseLaunch:
    """One window group ready for a dense kernel.

    events [B, E, R] int32, val_of [B, S] int32 (a [B, 1] dummy for mask
    groups, which the mask kernel does not read), n_events [B] int32
    (real row counts; None: all E), n_slots the group's window W,
    macro_p the macro payload width (None for legacy rows), tag the
    kernel label for results, kind the plan's kind: "domain"
    (`dense_scan`) or "mask" (`mask_scan`), model the group's own model
    where it differs from the run's (one launch can then mix groups of
    several models). The tensors lie on the launch device, or, with a
    `mesh` (a `parallel.mesh.Mesh`, or one device), anywhere: the rows
    are then cut into contiguous shards, one launch a placement."""

    events: torch.Tensor
    val_of: torch.Tensor
    n_events: Optional[torch.Tensor]
    n_slots: int
    macro_p: Optional[int] = None
    tag: str = "dense"
    kind: str = "domain"
    model: Optional[object] = None
    mesh: Optional[object] = None

    def scan(self, model, counts: bool = False):
        """The group's verdicts through its kernel's wrapper; with
        `counts`, (ok, counts) from the same launch."""
        m = model if self.model is None else self.model
        if self.kind == "mask":
            return mask_scan(self.events, self.n_slots, self.macro_p,
                             self.n_events, model=m, counts=counts)
        return dense_scan(self.events, self.val_of, self.n_slots,
                          self.macro_p, self.n_events, m, counts=counts)

    def launcher(self, model, counts: bool = False):
        """(ok, launch) from its kernel's launcher (card only); with
        `counts`, (ok, counts, launch) of the instance that counts."""
        m = model if self.model is None else self.model
        if self.kind == "mask":
            return mask_scan_launcher(self.events, self.n_slots,
                                      self.macro_p, self.n_events, model=m,
                                      counts=counts)
        return dense_scan_launcher(self.events, self.val_of, self.n_slots,
                                   self.macro_p, self.n_events, m,
                                   counts=counts)


@dataclass
class GroupRun:
    """Verdicts of `run_dense_groups`: ok[k] is launch k's [B] bool
    array. When timed (card only), kernel_ms[k] is launch k's kernel time
    on its own stream (summed over its shards) and span_ms the check's
    kernel span, from before the first launch to the end of the last, by
    CUDA events (over several cards, the longest card's). With counts,
    counts[k] is launch k's int64 (n_valid, n_unknown), B10's counts from
    the same kernel launch (summed over its shards on the host)."""

    ok: List[np.ndarray]
    wall_s: float
    kernel_ms: Optional[List[float]] = None
    span_ms: Optional[float] = None
    counts: Optional[List[np.ndarray]] = None


def _timer() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


def launch_dense_groups(launches: List[DenseLaunch], model,
                        timed: bool = False,
                        counts: bool = False) -> Callable[[], GroupRun]:
    """Launch every group's kernel (domain or mask, by `kind`) and return
    finalize() -> GroupRun, which blocks once and reads the verdicts.
    Each group is a launch a placement of its mesh over its contiguous
    rows (`kernel_ir.shard_rows`), or without a mesh one on its rows'
    device. On the card each shard has a side stream of its own, which
    first waits for its card's current stream (which carried the
    caller's earlier work): the shard's row copies, the launcher's
    checks, allocations and fills (`ChunkShard.call`), then the kernel,
    the copy of its verdicts to pinned host memory and an event
    (`ChunkShard.launch`) are all queued on it; every group's shards are
    prepared before the first kernel, so the kernels launch back to back
    and overlap. finalize blocks on those events, never on a whole device, and no
    current stream waits for a side stream, so the copies of a check
    launched after this one overlap this one's kernels. `counts`
    launches each group's counting instance instead (B10's counts in
    dense mode, every row real, from the kernel's epilogue), and copies
    its counts home beside its verdicts; a sharded group's counts are
    its shards' summed. `timed` brackets each kernel with CUDA events
    (card only) for per-group kernel times and the overlapped span, from
    the first kernel's start to the last one's end. A launch that fails
    on any placement raises."""
    t0 = time.perf_counter()
    marks: List[list] = [[] for _ in launches]

    def prepare(ln: DenseLaunch):
        # the launcher's checks and allocations (the CPU: the plain scan)
        def fn(events, val_of, n_events):
            part = replace(ln, events=events, val_of=val_of,
                           n_events=n_events, mesh=None)
            if events.device.type != "cuda":
                out = part.scan(model, counts=counts)
                return (out if counts else (out,)), None
            *outs, launch = part.launcher(model, counts=counts)
            return tuple(outs), launch
        return fn

    def fire(ms: list):
        def fn(ready):
            outs, launch = ready
            if launch is not None:
                _timed_launch(launch,
                              torch.cuda.current_stream(outs[0].device),
                              ms if timed else None)
            return outs
        return fn

    # every group's shards placed, checked and allocated first, then the
    # kernels launched back to back, so the groups overlap on the card
    ready = [[(s, s.call(prepare(ln), *parts)) for s, parts in
              shard_rows(_launch_devices(ln.mesh, ln.events), ln.events,
                         ln.val_of, ln.n_events)] for ln in launches]
    runs = [[(s, s.launch(fire(ms), r)) for s, r in grp]
            for grp, ms in zip(ready, marks)]

    def finalize() -> GroupRun:
        homes = [join_rows(r, sums=(1,)) for r in runs]
        wall = time.perf_counter() - t0
        _add_stats(rows_run=sum(int(ln.events.shape[0]) for ln in launches),
                   wall_s=wall)
        on_card = any(marks)
        return GroupRun(
            ok=[h[0] for h in homes], wall_s=wall,
            kernel_ms=[sum(a.elapsed_time(b) for a, b, _ in ms)
                       for ms in marks] if on_card else None,
            span_ms=_span_ms([m for ms in marks for m in ms])
            if on_card else None,
            counts=[h[1] for h in homes] if counts else None)

    return finalize


def run_dense_groups(launches: List[DenseLaunch], model,
                     timed: bool = False) -> GroupRun:
    """`launch_dense_groups`, finalized at once: every group's kernel
    launched, then one synchronisation."""
    return launch_dense_groups(launches, model, timed)()


@dataclass
class SortRun:
    """Flags of `run_sort_rung`: ok [B] and overflow [B] bool arrays.
    When timed (card only), kernel_ms is the kernel's time by CUDA
    events (summed over the shards of a mesh)."""

    ok: np.ndarray
    overflow: np.ndarray
    wall_s: float
    kernel_ms: Optional[float] = None


def run_sort_rung(events, n_events, n_slots: int, n_configs: int,
                  macro_p: Optional[int], model,
                  timed: bool = False, mesh=None) -> SortRun:
    """One rung of the sort ladder: the sort kernel at capacity
    `n_configs` over the rows `events` [B, E, R], one
    `kernel_ir.over_shards` launch — a launch a placement of `mesh` over
    its contiguous rows (`events` and `n_events` anywhere), or without
    a mesh one on the rows' device — then each shard's flags read once,
    after its own event. `timed` brackets each kernel with CUDA events
    (card only)."""
    t0 = time.perf_counter()
    marks: Optional[list] = [] if timed else None

    def fn(ev, ne):
        if ev.device.type != "cuda":
            return sort_scan(ev, n_slots, n_configs, macro_p, ne,
                             model=model)
        ok, overflow, launch = sort_scan_launcher(
            ev, n_slots, n_configs, macro_p, ne, model=model)
        _timed_launch(launch, torch.cuda.current_stream(ev.device), marks)
        return ok, overflow

    ok, overflow = join_rows(over_shards(_launch_devices(mesh, events), fn,
                                         events, n_events))
    wall = time.perf_counter() - t0
    _add_stats(rows_run=int(events.shape[0]), wall_s=wall)
    return SortRun(ok=ok, overflow=overflow, wall_s=wall,
                   kernel_ms=sum(a.elapsed_time(b) for a, b, _ in marks)
                   if marks else None)


# ------------------------------------------------------------- wavefront


@dataclass
class ChunkLaunch:
    """One window group queued for the wavefront.

    events [B, E, R] int32 and n_events [B] (host numpy; pack_batch or
    pack_macro_batch layout; with macro rows n_events counts them),
    init_fn / step_fn the chunk pair (`make_dense_chunk_checker`:
    init_fn(val_of, n_events); `make_sort_chunk_checker`:
    init_fn(n_events)), val_of [B, S] the dense group's domain tables
    (None for the sort pair), e_sched the event length the schedule
    covers (the bucketed length the one-shot path would scan; default
    E), device the torch device (None: the card, raising without one)
    or a `parallel.mesh.Mesh` whose placements the rows spread over
    (`parallel.mesh.chunk_sharding`), tag the kernel label for results.
    `exact_rows` (LONG merged groups) keeps the rows in place: no
    recompaction. `chunk` pins this launch's chunk (None: the run's); a
    whole-schedule value makes it one launch."""

    events: np.ndarray
    n_events: np.ndarray
    init_fn: Callable
    step_fn: Callable
    val_of: Optional[np.ndarray] = None
    e_sched: Optional[int] = None
    device: Optional[object] = None
    tag: str = "dense-chunk"
    exact_rows: bool = False
    chunk: Optional[int] = None


@dataclass
class GroupOutcome:
    """Per-group result of `run_chunked`; ok / overflow are [B] bool.
    `chunks_run` counts launches (a span of chunks is one, over every
    shard of a mesh). kernel_ms (timed runs on the card): the device time
    of the group's launches, each from before its kernel to after its
    flags' copy, by CUDA events on each shard's stream, summed."""

    ok: np.ndarray
    overflow: np.ndarray
    wall_s: float
    chunks_run: int
    evicted_rows: int
    early_exit: bool
    tag: str = ""
    kernel_ms: Optional[float] = None


@dataclass
class _Shard:
    """A group's rows on one placement: their events (copied once),
    carry, slot map and pending launch, all on the shard's device."""

    place: ChunkShard
    events: torch.Tensor               # [rows, cols, R]
    carry: torch.Tensor                # [rows, L]
    slot_rows: np.ndarray              # [rows] group row id or -1
    ev_base: int = 0                   # schedule column of events[:, 0]
    live: bool = True                  # False once no row of it is left
    pending: Optional[ShardOut] = None  # the launch in flight
    marks: Optional[list] = None       # timed: (start, end) per launch


@dataclass
class _GroupState:
    launch: ChunkLaunch
    chunk: int                         # this group's resolved chunk size
    scheduled: int                     # chunk units the schedule covers
    shards: List[_Shard]
    step_shards: Callable
    ok: np.ndarray                     # [B] final verdicts
    overflow: np.ndarray
    recorded: np.ndarray               # [B] bool
    cursor: int = 0                    # chunk units already scanned
    launches_run: int = 0
    evicted: int = 0
    done: bool = False
    early_exit: bool = False
    t_start: float = 0.0
    wall_s: float = 0.0
    pending: Optional[tuple] = None    # (dispatch time, span)
    intervals: List[tuple] = field(default_factory=list)


def build_dense_launches(model, groups, device=None):
    """The wavefront launch list of dense window groups, as the
    reference's `build_dense_launches`: groups are (rows, plan, batch)
    or (rows, plan, batch, tuned) with `rows` the caller's row ids,
    `plan` a DensePlan, `batch` the group's pack_batch or
    pack_macro_batch dict and `tuned` an optional checker/autotune.py
    TunedPlan (its macro cap acted at pack time, `autotune.pack_group`;
    its `scan_chunk` pins the launch's chunk here, 0 meaning one
    whole-schedule span). Largest group first; the schedule covers the
    group's event length bucketed from 32 (`bucket_rows(E, 32)`), or
    exactly E past MERGE_MAX_EVENTS legacy events, where the rows also
    stay in place (`exact_rows`) and a plan is ignored.

    Placement, as the reference's: each group stays whole, and every
    non-`exact_rows` group spreads its rows over the local mesh
    (`parallel.mesh.chunk_sharding`, or `chunk_sharding(tuned.
    mesh_fanout)` under a plan; JGRAFT_GROUP_DEVICES stays the outer
    bound); an `exact_rows` group, or any group when there is no mesh
    (one card, the knob at 0), runs on `device`. Returns (launches,
    subs): subs[k] the row ids behind launches[k]."""
    from ..ops.dense_scan import MERGE_MAX_EVENTS, make_dense_chunk_checker
    from ..parallel.mesh import chunk_sharding

    mesh = chunk_sharding(device=device)
    launches: list = []
    subs: list = []
    for grp in sorted(groups, key=lambda g: -len(g[0])):
        rows, plan, batch = grp[:3]
        tuned = grp[3] if len(grp) > 3 else None
        e_len = batch["events"].shape[1]
        exact = batch.get("legacy_events", e_len) > MERGE_MAX_EVENTS
        e_sched = e_len if exact else bucket_rows(e_len, 32)
        if exact:
            placement = device
        elif tuned is not None and tuned.mesh_fanout > 0:
            placement = chunk_sharding(tuned.mesh_fanout,
                                       device=device) or device
        else:
            placement = mesh or device
        init_fn, step_fn = make_dense_chunk_checker(
            model, plan.kind, plan.n_slots, plan.n_states,
            macro_p=batch.get("macro_p"))
        launches.append(ChunkLaunch(
            events=batch["events"], n_events=batch["n_events"],
            init_fn=init_fn, step_fn=step_fn, val_of=plan.val_of,
            e_sched=e_sched, device=placement, tag=plan.kernel_tag,
            exact_rows=exact,
            chunk=(tuned.scan_chunk or max(e_sched, 1))
            if tuned is not None and not exact else None))
        subs.append(list(rows))
    return launches, subs


def _init_group(launch: ChunkLaunch, chunk: int,
                timed: bool) -> _GroupState:
    """The group's rows cut into one shard a placement
    (`kernel_ir.shard_chunk_fns`; one shard on a single device), each
    shard's events copied to its device once and its fresh carry made
    there, on a card on the shard's own stream, which first waits for
    its card's current stream."""
    chunk = launch.chunk or chunk
    B, E = launch.events.shape[0], launch.events.shape[1]
    e_sched = max(launch.e_sched or E, E, 1)
    e_pad = -(-e_sched // chunk) * chunk
    init_shards, step_shards = shard_chunk_fns(
        launch.init_fn, launch.step_fn, _placements(launch.device))
    t0 = time.perf_counter()
    args = [np.ascontiguousarray(a, dtype=np.int32) for a in
            ((launch.n_events,) if launch.val_of is None
             else (launch.val_of, launch.n_events))]
    places, carries = init_shards(*args)
    events = np.ascontiguousarray(launch.events, dtype=np.int32)
    shards = [_Shard(place=p, events=p.put(events), carry=c,
                     slot_rows=np.arange(p.lo, p.hi, dtype=np.int32),
                     marks=[] if timed and p.stream is not None else None)
              for p, c in zip(places, carries)]
    return _GroupState(
        launch=launch, chunk=chunk, scheduled=e_pad // chunk,
        shards=shards, step_shards=step_shards,
        ok=np.zeros((B,), dtype=bool), overflow=np.zeros((B,), dtype=bool),
        recorded=np.zeros((B,), dtype=bool), t_start=t0)


def _span_chunks(g: _GroupState) -> int:
    """How many chunks the next launch covers, as the reference's: no
    live row can exhaust before min(live n_events) (host data), so the
    launch runs to the first boundary where one can retire, rounded down
    to a power-of-two multiple of the chunk. Chosen once for the whole
    group, over every shard's live rows (a row not yet recorded is live:
    every evicted row was recorded first), so each shard launches the
    same span. A row decided inside a span is recorded at its end: its
    verdict is frozen, only its eviction waits."""
    chunk = g.chunk
    live = np.flatnonzero(~g.recorded)
    lo = g.cursor * chunk
    first = int(g.launch.n_events[live].min()) if live.size else 0
    p = max(1, -(-(first - lo) // chunk))  # ceil, ≥1 once overdue
    p = min(p, g.scheduled - g.cursor)
    return 1 << (p.bit_length() - 1) if p > 1 else 1


def _dispatch(g: _GroupState) -> None:
    """Launch the group's next span on every shard with rows left, each
    on its own stream, which then copies the shard's four flag vectors
    to the host and records an event (`ChunkShard.launch`)."""
    span = _span_chunks(g)
    lo, width = g.cursor * g.chunk, span * g.chunk
    active = [s for s in g.shards if s.live]
    t0 = time.perf_counter()
    outs = g.step_shards(
        [s.place for s in active], [s.carry for s in active],
        [s.events[:, lo - s.ev_base:lo - s.ev_base + width] for s in active],
        width, home=lambda out: (torch.stack(out[1:]),),
        timed=any(s.marks is not None for s in active))
    for s, out in zip(active, outs):
        s.pending = out
        if s.marks is not None:
            s.marks.append((out.start, out.done))
    g.pending = (t0, span)


def _collect(g: _GroupState) -> None:
    """Wait for every shard's pending flags, record finished rows, evict,
    and recompact each shard's survivors, on its own device, when they
    fit a smaller row bucket (no carry crosses placements)."""
    t_disp, span = g.pending
    g.pending = None
    active = [s for s in g.shards if s.pending is not None]
    flags = [s.pending.wait()[0] for s in active]
    g.intervals.append((t_disp, time.perf_counter()))
    g.cursor += span
    g.launches_run += 1

    survivors = []
    for s, (decided, exhausted, ok, overflow) in zip(active, flags):
        s.carry = s.pending.out[0]
        s.pending = None
        real = s.slot_rows >= 0
        finished = (decided | exhausted) & real
        rows = s.slot_rows[finished]
        fresh = rows[~g.recorded[rows]]
        if fresh.size:
            pos = np.flatnonzero(finished)[~g.recorded[rows]]
            g.ok[fresh] = ok[pos]
            g.overflow[fresh] = overflow[pos]
            g.recorded[fresh] = True
            if g.cursor < g.scheduled:
                g.evicted += int(fresh.size)
        alive = np.flatnonzero(real & ~(decided | exhausted))
        alive = alive[~g.recorded[s.slot_rows[alive]]]
        if alive.size:
            survivors.append((s, alive, ok, overflow))
        else:
            s.live = False
            s.events = s.carry = None

    if not survivors or g.cursor >= g.scheduled:
        # every row's events fit the schedule, so a row still live at
        # its end cannot happen; were it to, its verdict is the
        # one-shot's (only EV_PAD rows remain)
        for s, alive, ok, overflow in survivors:
            for p in alive:
                r = s.slot_rows[p]
                g.ok[r], g.overflow[r] = ok[p], overflow[p]
                g.recorded[r] = True
        g.done = True
        g.early_exit = g.cursor < g.scheduled
        g.wall_s = time.perf_counter() - g.t_start
        return

    if g.launch.exact_rows:
        return
    lo = g.cursor * g.chunk
    for s, alive, _, _ in survivors:
        bucket = bucket_rows(int(alive.size))
        if bucket >= s.slot_rows.shape[0]:
            continue
        # pad slots repeat the first survivor (their flags are never read)
        idx = np.concatenate([alive, np.full(bucket - alive.size, alive[0])])
        with s.place.scope():
            idx_t = torch.from_numpy(idx.astype(np.int64)).to(s.place.device)  # lint: allow(host-sync) the survivors' row index, once a recompaction
            s.carry = s.carry.index_select(0, idx_t)
            s.events = s.events[:, lo - s.ev_base:].index_select(0, idx_t)
        s.ev_base = lo
        new_rows = np.full((bucket,), -1, dtype=np.int32)
        new_rows[:alive.size] = s.slot_rows[alive]
        s.slot_rows = new_rows


def _overlap_seconds(intervals: List[tuple]) -> float:
    """Wall time during which two or more groups had a launch in flight,
    from (dispatch, collect) spans: an upper-bound estimate."""
    events = sorted([(a, 1) for a, _ in intervals]
                    + [(b, -1) for _, b in intervals])
    depth, overlap, prev = 0, 0.0, None
    for t, d in events:
        if prev is not None and depth >= 2:
            overlap += t - prev
        depth += d
        prev = t
    return overlap


def run_chunked(launches: List[ChunkLaunch],
                chunk: Optional[int] = None, record_stats: bool = True,
                timer: Optional[dict] = None) -> List[GroupOutcome]:
    """Run window groups through the chunked wavefront; one GroupOutcome
    per launch, in order. Every group's first span is dispatched before
    any flags are read; then each collect refills its group's streams
    before the next group is collected. A launch's own `chunk` overrides
    the run's (`scan_chunk()` by default); a run needs a positive chunk.
    A launch on a mesh stays one group: its counters (`chunks_run`, one
    a span over all shards; `evicted_rows`, `groups_run`,
    `groups_early_exited`) are the one-device run's. A launch that fails
    on any placement raises. `record_stats=False` keeps the run out of
    the counters. `timer` (a dict, card only) gets "span_ms": from the
    start of the first launch to the end of the last, by CUDA events
    (over several cards, the longest card's), and each outcome its
    kernel_ms."""
    chunk = scan_chunk() if chunk is None else chunk
    if chunk <= 0 and not (launches and all(ln.chunk for ln in launches)):
        raise ValueError("run_chunked needs a positive chunk size "
                         "(JGRAFT_SCAN_CHUNK=0 selects the one-shot path "
                         "at the call site; ChunkLaunch.chunk may stand in "
                         "per launch)")
    starts: dict = {}
    if timer is not None:
        for ln in launches:
            for dev in _placements(ln.device):
                if dev.type == "cuda" and dev not in starts:
                    starts[dev] = _timer()
                    starts[dev].record(torch.cuda.current_stream(dev))
    t0 = time.perf_counter()
    groups = [_init_group(ln, chunk, bool(starts)) for ln in launches]
    for g in groups:
        _dispatch(g)
    while True:
        live = [g for g in groups if not g.done]
        if not live:
            break
        for g in live:
            _collect(g)
            if not g.done:
                _dispatch(g)
    if starts:
        # per card, from the first launch to the end of the last (the
        # groups' event copies, before their first launch, are not in
        # it); the longest card's
        spans = []
        for dev, start in starts.items():
            marks = [m for g in groups for s in g.shards
                     if s.marks and s.place.device == dev for m in s.marks]
            if marks:
                spans.append(max(start.elapsed_time(e) for _, e in marks)
                             - min(start.elapsed_time(b) for b, _ in marks))
        timer["span_ms"] = max(spans) if spans else 0.0
    if record_stats:
        _add_stats(chunks_run=sum(g.launches_run for g in groups),
                   evicted_rows=sum(g.evicted for g in groups),
                   groups_run=len(groups),
                   groups_early_exited=sum(1 for g in groups
                                           if g.early_exit),
                   pipeline_overlap_s=_overlap_seconds(
                       [iv for g in groups for iv in g.intervals]),
                   rows_run=sum(int(g.launch.events.shape[0])
                                for g in groups),
                   wall_s=time.perf_counter() - t0)
    return [GroupOutcome(ok=g.ok, overflow=g.overflow, wall_s=g.wall_s,
                         chunks_run=g.launches_run, evicted_rows=g.evicted,
                         early_exit=g.early_exit, tag=g.launch.tag,
                         kernel_ms=(sum(a.elapsed_time(b)
                                        for s in g.shards if s.marks
                                        for a, b in s.marks)
                                    if starts else None))
            for g in groups]


# ------------------------------------------------------- streaming carry


#: Sentinel event budget for a stream carry: the session does not know
#: its total event count, so `exhausted` (events left ≤ 0) must never
#: fire — retirement is decided by the session (decided flag / finish).
STREAM_EVENTS_SENTINEL = 1 << 30

#: Events per carried launch while catching a backlog up (the per-append
#: suffix is usually far smaller and rides one padded launch).
STREAM_FEED_CHUNK = 1024


class CarriedScan:
    """Re-entrant chunk carry of ONE streamed history row, the
    reference's `CarriedScan`.

    The sort kernel's chunk form (`ops.linear_scan.make_sort_chunk_checker`:
    a [1, L] int32 carry plus decided / exhausted / ok / overflow flags)
    makes the scan re-enterable at any chunk boundary; this class keeps
    that carry on its device ACROSS the appends of a streaming session.
    Each `feed` advances the same scan steps the one-shot kernel would
    run over the concatenated stream — a span's padding is EV_PAD rows,
    which move `left` as the reference's do and nothing else — so after
    the whole stream the (ok, overflow) pair equals the one-shot sort
    scan's. `left` starts at STREAM_EVENTS_SENTINEL, so a row never
    exhausts.

    `ok` only falls, so the moment it is False the verdict (INVALID, or
    with `overflow` escalate to the host) is final: `decided`, after
    which `feed` launches nothing.

    The kernel window is fixed at construction (`bucket_slots`, which
    raises ValueError past MAX_SLOTS); a session whose window outgrows
    it (`fits`) rebuilds a wider carry and re-feeds its stream.

    Each launch is one row on `device` (the card unless the caller
    passes the CPU, which runs the plain version): its span is copied
    to the device, the chunk launched, and `ok` and `overflow` read back
    — one host synchronisation a launch."""

    def __init__(self, model, n_slots: int,
                 n_configs: Optional[int] = None, device=None):
        from ..ops.linear_scan import (DEFAULT_N_CONFIGS, bucket_slots,
                                       make_sort_chunk_checker)

        self.model = model
        self.device = resolve_device(device)
        self.n_configs = int(n_configs or DEFAULT_N_CONFIGS)
        self.slots_cap = bucket_slots(max(int(n_slots), 1))
        init_fn, self._step = make_sort_chunk_checker(
            model, self.n_configs, self.slots_cap)
        self.carry = init_fn(torch.tensor([STREAM_EVENTS_SENTINEL],  # lint: allow(host-sync) the stream's initial carry, once a session
                                          dtype=torch.int32,
                                          device=self.device))
        self.fed = 0          # events consumed (before padding)
        self.launches = 0
        self.ok = True
        self.overflow = False

    @property
    def decided(self) -> bool:
        """Frozen-verdict retirement: ~ok is final mid-stream."""
        return not self.ok

    def fits(self, n_slots: int) -> bool:
        return int(n_slots) <= self.slots_cap

    def feed(self, events: np.ndarray) -> None:
        """Advance the carry over an event suffix ([n, 5] int32), in
        launches of at most STREAM_FEED_CHUNK events, each padded to
        its 32-row bucket. Stops (launches nothing more) the moment the
        row decides: the rest of the suffix cannot change a frozen
        verdict."""
        n = int(events.shape[0])
        lo = 0
        while lo < n and not self.decided:
            span = events[lo:lo + STREAM_FEED_CHUNK]
            lo += span.shape[0]
            padded = np.zeros((bucket_rows(span.shape[0], 32), 5),
                              dtype=np.int32)
            padded[:span.shape[0]] = span
            ev = torch.from_numpy(padded[None]).to(self.device)  # lint: allow(host-sync) the append's span goes up (pageable)
            self.carry, _dec, _exh, ok, overflow = self._step(self.carry,
                                                              ev)
            # the per-launch host synchronisation
            flags = torch.stack([ok, overflow]).cpu()  # lint: allow(host-sync) the per-append flag read: the stream's verdict
            self.ok = bool(flags[0, 0])
            self.overflow = bool(flags[1, 0])
            self.launches += 1
        self.fed += n
