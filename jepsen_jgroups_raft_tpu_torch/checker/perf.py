"""Performance checker: latency and throughput over time.

Equivalent of jepsen checker/perf (reference raft.clj:74): computes
latency quantiles and completion-rate series from the history, annotated
with nemesis activity windows (the reference shades nemesis intervals into
its gnuplot output, membership.clj:158-161). Renders SVG plots into the
store directory when one is available — no gnuplot dependency, just
generated SVG.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Tuple

from ..history.ops import INFO, OK, History
from .base import Checker


def _quantile(sorted_xs: List[float], q: float) -> float:
    if not sorted_xs:
        return 0.0
    i = min(len(sorted_xs) - 1, int(q * len(sorted_xs)))
    return sorted_xs[i]


class PerfChecker(Checker):
    def __init__(self, bucket_s: float = 1.0, render: bool = True,
                 nemeses: Optional[List[dict]] = None):
        """`nemeses`: perf annotations from nemesis packages —
        {"name", "start": set, "stop": set, "color"} — the reference's
        colored nemesis intervals (membership.clj:158-161). Defaults to
        the stock fault vocabulary (FAULT_HEALS)."""
        self.bucket_s = bucket_s
        self.render = render
        self.heals = dict(FAULT_HEALS)
        self.colors: dict = {}
        for spec in nemeses or []:
            for s in spec.get("start", ()):
                for e in spec.get("stop", ()):
                    self.heals[s] = e
                if spec.get("color"):
                    self.colors[s] = spec["color"]

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        pairs = history.client_ops().pairs()
        lat_by_f: dict = {}
        points: List[Tuple[float, float, str, str]] = []  # t, latency, f, type
        rate: dict = {}
        for p in pairs:
            if p.completion is None:
                continue
            t0, t1 = p.invoke.time, p.completion.time
            if t0 < 0 or t1 < 0:
                continue
            lat = (t1 - t0) / 1e9
            lat_by_f.setdefault(p.f, []).append(lat)
            points.append((t0 / 1e9, lat, p.f, p.completion.type))
            b = int(t1 / 1e9 / self.bucket_s)
            rate.setdefault(p.completion.type, {})
            rate[p.completion.type][b] = rate[p.completion.type].get(b, 0) + 1

        nemesis_windows = _nemesis_windows(history, self.heals)
        out = {"valid?": True, "latency": {}, "rate": {}}
        for f, lats in lat_by_f.items():
            lats.sort()
            out["latency"][f] = {
                "count": len(lats),
                "median": _quantile(lats, 0.5),
                "p95": _quantile(lats, 0.95),
                "p99": _quantile(lats, 0.99),
                "max": lats[-1],
            }
        for t, buckets in rate.items():
            # Mean over the elapsed span, not over occupied buckets — a
            # bursty history must not overstate its rate.
            span = (max(buckets) - min(buckets) + 1) * self.bucket_s
            out["rate"][t] = {"mean-hz": sum(buckets.values()) / span}
        out["nemesis-windows"] = nemesis_windows
        # Chunked event-scan counters (checker/schedule.py): how much
        # verification work the wavefront evicted/overlapped so far this
        # process — surfaced here so per-run stores carry the eviction
        # evidence next to the latency data.
        scan = scan_stats_summary()
        if scan is not None:
            out["scan-stats"] = scan
        # Autotune evidence: which per-bucket plans this process
        # has loaded/measured so far — absent when the autotuner never
        # engaged (off, or every group below the work gates).
        tune = autotune_summary()
        if tune is not None:
            out["autotune"] = tune
        # Tier attribution: which decision-ladder tier
        # decided this run's verdicts, with per-tier wall time — at
        # fleet scale the cheap-tier decided fraction IS the capacity
        # model, so the per-run store carries it next to the scan
        # counters. Lin-rung fast-path hits are namespaced
        # ``greedy@lin``/``backtrack@lin`` so the fleet view
        # never conflates the weak-rung certifier's hit-rate with the
        # linearizable fast path's.
        tiers = tier_summary()
        if tiers is not None:
            out["decided-tiers"] = tiers
        # Lin fast-path engagement: scanned/certified/gated
        # row counts + certify wall — the hit-rate evidence beside the
        # per-bucket gating store's persisted records.
        fp = lin_fastpath_summary()
        if fp is not None:
            out["lin-fastpath"] = fp
        # Exact-cycle tier counters: size skips (the
        # previously-invisible cap skip), condensation effectiveness
        # (nodes pre/post, SCC hits) and blocked-closure tile volume —
        # absent when the tier never touched a graph this run.
        cyc = cycle_stats_summary()
        if cyc is not None:
            out["cycle-stats"] = cyc
        store_dir = (test or {}).get("store_dir")
        if self.render and store_dir:
            try:
                path = Path(store_dir) / "latency.svg"
                path.write_text(
                    _latency_svg(points, nemesis_windows, colors=self.colors))
                out["plot"] = str(path)
            except Exception:  # plotting must never fail a run
                pass
        return out


def format_scan_stats(scan: dict):
    """Result-dict form of a raw schedule counter dict, or None when it
    holds no chunked work (absent beats all-zero in stored results).
    Shared by `scan_stats_summary` and the runner's post-check stamp."""
    if not scan.get("groups_run"):
        return None
    return {"chunks-run": scan["chunks_run"],
            "evicted-rows": scan["evicted_rows"],
            "groups-run": scan["groups_run"],
            "groups-early-exited": scan["groups_early_exited"],
            "pipeline-overlap-s": round(scan["pipeline_overlap_s"], 3)}


def scan_stats_summary():
    """Per-run chunked-scan wavefront counters (checker/schedule.py),
    or None when no chunked group has run — absent beats all-zero in
    stored results. Reads the innermost active `stats_scope` (the one
    `core/runner.run_test` opens around each test's checking phase), so
    back-to-back runs in one process store their OWN counters instead
    of a process-lifetime accumulation; outside any scope (direct
    checker use) it falls back to the process totals. NOTE the composed
    checker runs perf BEFORE the workload checker, so within run_test
    this block is usually absent from the perf sub-result — the
    authoritative per-run counters are stamped by the RUNNER after the
    whole composed check completes (`core/runner.run_test`)."""
    from .schedule import snapshot_stats

    return format_scan_stats(snapshot_stats(scoped=True))


def autotune_summary():
    """Process-level autotuner counters (checker/autotune.py), or None
    when the autotuner has not engaged — absent beats all-zero in
    stored results, same stance as the scan counters."""
    from .autotune import snapshot_counters

    c = snapshot_counters()
    if not any(c.values()):
        return None
    return {"plans-loaded": c["plans_loaded"],
            "plans-measured": c["plans_measured"],
            "plan-misses": c["plan_misses"]}


def lin_fastpath_summary():
    """Process-level lin-fastpath counters
    (checker/linearizable.fastpath_counters), or None when the fast
    path never engaged — absent beats all-zero in stored results, same
    stance as the autotune block."""
    from .linearizable import fastpath_counters

    c = fastpath_counters()
    if not any(c.values()):
        return None
    return {"rows-scanned": c["rows_scanned"],
            "rows-certified": c["rows_certified"],
            "rows-gated": c["rows_gated"],
            "rows-rung-skipped": c["rows_rung_skipped"],
            "certify-wall-s": round(c["certify_wall_s"], 4)}


def format_cycle_stats(scan: dict):
    """Result-dict form of the cycle-tier counters riding a raw
    schedule counter dict, or None when the tier never built a graph
    and never skipped one (absent beats all-zero in stored results).
    ``size-skipped-rows`` counts the rows whose required-op graph
    exceeded JGRAFT_CYCLE_MAX_OPS."""
    keys = ("cycle_size_skips", "cycle_nodes_pre", "cycle_nodes_post",
            "cycle_scc_hits", "cycle_tiles_run")
    if not any(scan.get(k) for k in keys):
        return None
    return {"size-skipped-rows": scan.get("cycle_size_skips", 0),
            "nodes-pre-condense": scan.get("cycle_nodes_pre", 0),
            "nodes-post-condense": scan.get("cycle_nodes_post", 0),
            "scc-hits": scan.get("cycle_scc_hits", 0),
            "tiles-run": scan.get("cycle_tiles_run", 0)}


def cycle_stats_summary():
    """Per-run cycle-tier counters (checker/schedule.note_cycle), or
    None when the tier never engaged. Scoped like
    `scan_stats_summary` — the innermost active `stats_scope` wins."""
    from .schedule import snapshot_stats

    return format_cycle_stats(snapshot_stats(scoped=True))


def format_tier_stats(tiers: dict):
    """Result-dict form of a raw per-tier counter dict ({tier: {"rows",
    "wall_s"}}), or None when nothing was decided. Reports decided row
    counts, the decided FRACTION per tier (the fleet capacity metric),
    and per-tier wall seconds."""
    total = sum(v["rows"] for v in tiers.values())
    if not total:
        return None
    return {
        "decided-rows": {k: v["rows"] for k, v in tiers.items()},
        "decided-fraction": {k: round(v["rows"] / total, 4)
                             for k, v in tiers.items()},
        "wall-s": {k: round(v["wall_s"], 4) for k, v in tiers.items()},
    }


def tier_summary():
    """Per-run tier-attribution counters (checker/schedule.note_tier),
    or None when nothing was decided. Scoped like
    `scan_stats_summary` — the innermost active `stats_scope` wins, so
    back-to-back runs store their own fractions."""
    from .schedule import snapshot_tiers

    return format_tier_stats(snapshot_tiers(scoped=True))


#: fault-op f → healing-op f (the start/stop convention nemesis packages
#: follow; the reference's packages shade exactly these spans into perf
#: plots, membership.clj:158-161).
FAULT_HEALS = {
    "start-partition": "stop-partition",
    "pause": "resume",
    "kill": "restart",
    "shrink": "grow",
}


def _nemesis_windows(history: History,
                     heals: Optional[dict] = None) -> List[dict]:
    """Fault activity windows: from the *completion* of a fault op to the
    completion of its healing op. The runner records each nemesis action
    twice (invocation then completion, both type info), so per f the 2nd,
    4th, ... occurrences are completions."""
    heals = FAULT_HEALS if heals is None else heals
    starters = set(heals)
    stoppers = {v: k for k, v in heals.items()}
    seen: dict = {}
    open_at: dict = {}  # fault f -> start time
    windows: List[dict] = []
    for op in history.nemesis_ops():
        f = op.f
        seen[f] = seen.get(f, 0) + 1
        if seen[f] % 2 == 1:
            continue  # invocation record; windows anchor on completions
        if f in starters and f not in open_at:
            # A refused/failed fault (guardrail refusal string, {"error"}
            # value, errored op) injected nothing: no window.
            failed = (op.error is not None
                      or isinstance(op.value, str)
                      or (isinstance(op.value, dict) and "error" in op.value))
            if failed:
                continue
            open_at[f] = op.time
        elif f in stoppers:
            started = open_at.pop(stoppers[f], None)
            if started is not None:
                windows.append({"f": stoppers[f], "start": started / 1e9,
                                "end": op.time / 1e9})
    for f, t in open_at.items():
        windows.append({"f": f, "start": t / 1e9, "end": None})
    return windows


_TYPE_COLOR = {OK: "#2a7", INFO: "#fa0", "fail": "#d33"}


def _latency_svg(points, windows, w: int = 900, h: int = 360,
                 colors: Optional[dict] = None) -> str:
    """Scatter of op latency over time, log-y, nemesis windows shaded."""
    colors = colors or {}
    if not points:
        return "<svg xmlns='http://www.w3.org/2000/svg'/>"
    tmax = max(p[0] for p in points) or 1.0
    lmin = max(1e-5, min(p[1] for p in points if p[1] > 0) if any(
        p[1] > 0 for p in points) else 1e-4)
    lmax = max(p[1] for p in points) or 1.0
    pad = 45

    def x(t):
        return pad + (w - 2 * pad) * t / tmax

    def y(lat):
        lat = max(lat, lmin)
        return h - pad - (h - 2 * pad) * (
            (math.log10(lat) - math.log10(lmin))
            / max(1e-9, math.log10(lmax) - math.log10(lmin)))

    parts = [
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{w}' height='{h}' "
        f"font-family='sans-serif' font-size='11'>",
        f"<rect width='{w}' height='{h}' fill='white'/>",
    ]
    for win in windows:
        end = win["end"] if win["end"] is not None else tmax
        fill = colors.get(win["f"], "#f6c")
        parts.append(
            f"<rect x='{x(win['start']):.1f}' y='{pad}' "
            f"width='{max(1.0, x(end) - x(win['start'])):.1f}' "
            f"height='{h - 2 * pad}' fill='{fill}' opacity='0.15'/>")
    for t, lat, f, typ in points:
        parts.append(
            f"<circle cx='{x(t):.1f}' cy='{y(lat):.1f}' r='1.6' "
            f"fill='{_TYPE_COLOR.get(typ, '#888')}' opacity='0.7'/>")
    parts.append(
        f"<line x1='{pad}' y1='{h - pad}' x2='{w - pad}' y2='{h - pad}' "
        f"stroke='#333'/>"
        f"<line x1='{pad}' y1='{pad}' x2='{pad}' y2='{h - pad}' stroke='#333'/>"
        f"<text x='{w // 2}' y='{h - 8}'>time (s)</text>"
        f"<text x='4' y='{h // 2}' transform='rotate(-90 10 {h // 2})'>"
        f"latency (s, log)</text></svg>")
    return "".join(parts)
