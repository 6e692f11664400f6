"""Window-group launches and the port's run counters.

`run_sort_rung` launches one rung of the sort-frontier ladder (the sort
kernel at one capacity C over the rung's rows) and synchronises: the
ladder needs each rung's flags before it can pick the next rung's rows.

`run_dense_groups` is the port's launch loop for the dense kernels (the
dense-domain scan for domain groups, the mask-mode scan for mask
groups): it launches every window group's kernel at once, each on a
side stream of its own, joins them back to the current stream and
synchronises once — the reference's discipline for its monolithic path
(bench.py run(): launch every group, block once), with the groups
overlapped on the card instead of queued one after another. The
reference's chunked wavefront (decided-row eviction between chunks) is
not ported yet: each CUDA kernel exits a history's loop at its real
length or at its first dead FORCE on its own, which covers the
eviction's two cases inside one launch.

The counters follow the reference's checker/schedule.py: per-tier
decided rows and wall (`note_tier`, `consume_tiers`) and run counters
(`consume_stats`, the cycle tier's through `note_cycle`), both also
collected into any active `stats_scope`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops.dense_scan import (dense_scan, dense_scan_launcher, mask_scan,
                              mask_scan_launcher)
from ..ops.linear_scan import sort_scan, sort_scan_launcher

_STATS_LOCK = threading.Lock()
_STATS_ZERO = {"groups_run": 0, "rows_run": 0, "wall_s": 0.0,
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


def consume_tiers() -> dict:
    """Return and reset the process-wide per-tier counters,
    ``{tier: {"rows", "wall_s"}}``."""
    global _TIERS
    with _STATS_LOCK:
        out = {k: {"rows": v[0], "wall_s": v[1]} for k, v in _TIERS.items()}
        _TIERS = {}
        return out


# ------------------------------------------------------------- launches


@dataclass
class DenseLaunch:
    """One window group ready for a dense kernel, its tensors already on
    the launch device.

    events [B, E, R] int32, val_of [B, S] int32 (a [B, 1] dummy for mask
    groups, which the mask kernel does not read), n_events [B] int32
    (real row counts), n_slots the group's window W, macro_p the macro
    payload width (None for legacy rows), tag the kernel label for
    results, kind the plan's kind: "domain" (`dense_scan`) or "mask"
    (`mask_scan`), model the group's own model where it differs from the
    run's (one launch can then mix groups of several models)."""

    events: torch.Tensor
    val_of: torch.Tensor
    n_events: torch.Tensor
    n_slots: int
    macro_p: Optional[int] = None
    tag: str = "dense"
    kind: str = "domain"
    model: Optional[object] = None

    def scan(self, model):
        """The group's verdicts through its kernel's wrapper."""
        m = model if self.model is None else self.model
        if self.kind == "mask":
            return mask_scan(self.events, self.n_slots, self.macro_p,
                             self.n_events, model=m)
        return dense_scan(self.events, self.val_of, self.n_slots,
                          self.macro_p, self.n_events, m)

    def launcher(self, model):
        """(ok, launch) from its kernel's launcher (card only)."""
        m = model if self.model is None else self.model
        if self.kind == "mask":
            return mask_scan_launcher(self.events, self.n_slots,
                                      self.macro_p, self.n_events, model=m)
        return dense_scan_launcher(self.events, self.val_of, self.n_slots,
                                   self.macro_p, self.n_events, m)


@dataclass
class GroupRun:
    """Verdicts of `run_dense_groups`: ok[k] is launch k's [B] bool
    array. When timed (card only), kernel_ms[k] is launch k's kernel time
    on its own stream and span_ms the check's kernel span, from before
    the first launch to the join of the last, by CUDA events."""

    ok: List[np.ndarray]
    wall_s: float
    kernel_ms: Optional[List[float]] = None
    span_ms: Optional[float] = None


def _timer() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


def run_dense_groups(launches: List[DenseLaunch], model,
                     timed: bool = False) -> GroupRun:
    """Launch every group's kernel (domain or mask, by `kind`), then
    synchronise once and read the verdicts. On the card every group is
    checked and allocated first, then the kernels launch back to back,
    each on its own side stream:
    a side stream first waits for the current stream (which carried the
    inputs' host-to-device copies and allocated the verdicts), every
    tensor a side stream touches is recorded on it, and the current
    stream waits for all of them before the verdicts are read. `timed`
    adds CUDA events (card only) for per-group kernel times and the
    overlapped span."""
    t0 = time.perf_counter()
    on_card = any(ln.events.device.type == "cuda" for ln in launches)
    timed = timed and on_card
    oks, marks, span = [], [], None
    if not on_card:
        oks = [ln.scan(model) for ln in launches]
    else:
        dev = launches[0].events.device
        main = torch.cuda.current_stream(dev)
        # PyTorch hands out its pooled streams round-robin, so these are
        # distinct for up to 32 groups
        sides = [torch.cuda.Stream(device=dev) for _ in launches]
        ready = [ln.launcher(model) for ln in launches]
        if timed:
            span = (_timer(), _timer())
            marks = [(_timer(), _timer()) for _ in launches]
            span[0].record(main)
        for k, ((ok, launch), side) in enumerate(zip(ready, sides)):
            side.wait_stream(main)
            if timed:
                marks[k][0].record(side)
            launch(side)
            if timed:
                marks[k][1].record(side)
            oks.append(ok)
        for side in sides:
            main.wait_stream(side)
        if timed:
            span[1].record(main)
        for ln, ok, side in zip(launches, oks, sides):
            for t in (ln.events, ln.val_of, ln.n_events, ok):
                t.record_stream(side)
        main.synchronize()
    out = [o.cpu().numpy() for o in oks]
    wall = time.perf_counter() - t0
    _add_stats(groups_run=len(launches),
               rows_run=sum(int(ln.events.shape[0]) for ln in launches),
               wall_s=wall)
    return GroupRun(ok=out, wall_s=wall,
                    kernel_ms=[s.elapsed_time(e) for s, e in marks]
                    if timed else None,
                    span_ms=span[0].elapsed_time(span[1]) if timed else None)


@dataclass
class SortRun:
    """Flags of `run_sort_rung`: ok [B] and overflow [B] bool arrays.
    When timed (card only), kernel_ms is the kernel's time by CUDA
    events."""

    ok: np.ndarray
    overflow: np.ndarray
    wall_s: float
    kernel_ms: Optional[float] = None


def run_sort_rung(events, n_events, n_slots: int, n_configs: int,
                  macro_p: Optional[int], model,
                  timed: bool = False) -> SortRun:
    """One rung of the sort ladder: the sort kernel at capacity
    `n_configs` over the rows `events` [B, E, R] (on the launch device),
    then one synchronisation to read the flags. `timed` brackets the
    launch with CUDA events (card only)."""
    t0 = time.perf_counter()
    kernel_ms = None
    if events.device.type != "cuda":
        ok, overflow = sort_scan(events, n_slots, n_configs, macro_p,
                                 n_events, model=model)
    else:
        stream = torch.cuda.current_stream(events.device)
        ok, overflow, launch = sort_scan_launcher(
            events, n_slots, n_configs, macro_p, n_events, model=model)
        marks = (_timer(), _timer()) if timed else None
        if timed:
            marks[0].record(stream)
        launch(stream)
        if timed:
            marks[1].record(stream)
        stream.synchronize()
        if timed:
            kernel_ms = marks[0].elapsed_time(marks[1])
    out_ok, out_of = ok.cpu().numpy(), overflow.cpu().numpy()
    wall = time.perf_counter() - t0
    _add_stats(groups_run=1, rows_run=int(events.shape[0]), wall_s=wall)
    return SortRun(ok=out_ok, overflow=out_of, wall_s=wall,
                   kernel_ms=kernel_ms)
