"""The port's perf and stats checkers (`checker/perf.py`,
`checker/stats.py`) against the reference's, on the CPU.

The same history (op rows with times, nemesis faults and heals, fail and
info completions, error annotations) goes through both packages'
`PerfChecker`, `StatsChecker` and `UnhandledExceptionsChecker`: equal
outputs, and byte-identical latency SVGs. The run-counter summaries
(scan, cycle and tier stats) read each package's own counters, so they
are held to the reference's on the same raw counter dicts, and inside a
`stats_scope` where the same tiers were noted (`snapshot_tiers`).

Tolerance: exact equality (floats are the same arithmetic on the same
integers).
"""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import perf as ref_perf
from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.checker import stats as ref_stats
from jepsen_jgroups_raft_tpu.history import ops as ref_ops
from jepsen_jgroups_raft_tpu_torch.checker import perf, schedule, stats
from jepsen_jgroups_raft_tpu_torch.history import ops

torch.set_num_threads(1)

#: the run-counter blocks: per-process state of each package
COUNTER_KEYS = ("scan-stats", "autotune", "decided-tiers", "lin-fastpath",
                "cycle-stats", "plot")


def _rows(seed: int, n: int = 60) -> list:
    """Op rows (process, type, f, value, time s, error): a client workload
    of reads and writes completing ok, fail and info, with errors on
    some, and nemesis partitions, a pause and a kill, each recorded twice
    (invocation, completion); one fault is refused."""
    rng = random.Random(seed)
    out = []
    t = 0.0
    for i in range(n):
        p = rng.randrange(4)
        f = rng.choice(["read", "write", "cas"])
        t += rng.random() * 0.3
        out.append((p, "invoke", f, None if f == "read" else i, t, None))
        t += rng.random() * 0.2
        typ = rng.choice(["ok", "ok", "ok", "fail", "info"])
        err = (rng.choice(["timeout: no leader", "refused: closed"])
               if typ != "ok" else None)
        out.append((p, typ, f, i % 3, t, err))
        if i in (10, 30):
            for name in ("start-partition", "start-partition"):
                out.append(("nemesis", "info", name, None, t + 0.01, None))
        if i in (20, 45):
            for name in ("stop-partition", "stop-partition"):
                out.append(("nemesis", "info", name, None, t + 0.02, None))
        if i == 25:
            out.append(("nemesis", "info", "pause", None, t, None))
            out.append(("nemesis", "info", "pause", "refused", t, None))
        if i == 50:
            out.append(("nemesis", "info", "kill", None, t, None))
            out.append(("nemesis", "info", "kill", None, t + 0.05, None))
    return out


def _history(mod, rows):
    h = mod.History()
    for process, typ, f, value, t, err in rows:
        h.append(mod.Op(process, typ, f, value, time=int(t * 1e9),
                        error=err))
    return h


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_perf_checker_equals_reference(seed, tmp_path):
    rows = _rows(seed)
    nem = [{"name": "partition", "start": {"start-partition"},
            "stop": {"stop-partition"}, "color": "#0af"}]
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
    ours = perf.PerfChecker(nemeses=nem).check(
        {"store_dir": str(tmp_path / "port")}, _history(ops, rows))
    theirs = ref_perf.PerfChecker(nemeses=nem).check(
        {"store_dir": str(tmp_path / "ref")}, _history(ref_ops, rows))
    strip = {k: v for k, v in ours.items() if k not in COUNTER_KEYS}
    assert strip == {k: v for k, v in theirs.items()
                     if k not in COUNTER_KEYS}
    assert ours["nemesis-windows"] and ours["latency"] and ours["rate"]
    assert (tmp_path / "port" / "latency.svg").read_text() == \
        (tmp_path / "ref" / "latency.svg").read_text()


def test_perf_checker_unrendered_and_empty_equal_reference():
    for rows in ([], _rows(4, 8)):
        ours = perf.PerfChecker(render=False).check({}, _history(ops, rows))
        theirs = ref_perf.PerfChecker(render=False).check(
            {}, _history(ref_ops, rows))
        assert {k: v for k, v in ours.items() if k not in COUNTER_KEYS} \
            == {k: v for k, v in theirs.items() if k not in COUNTER_KEYS}
    assert perf._latency_svg([], []) == ref_perf._latency_svg([], [])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_stats_and_exception_checkers_equal_reference(seed):
    rows = _rows(seed)
    h, rh = _history(ops, rows), _history(ref_ops, rows)
    assert stats.StatsChecker().check({}, h) == \
        ref_stats.StatsChecker().check({}, rh)
    ours = stats.UnhandledExceptionsChecker().check({}, h)
    assert ours == ref_stats.UnhandledExceptionsChecker().check({}, rh)
    assert ours["error-kinds"]


def test_stats_checker_fails_a_kind_with_no_ok():
    rows = [(0, "invoke", "write", 1, 0.0, None),
            (0, "fail", "write", 1, 0.1, None),
            (1, "invoke", "read", None, 0.2, None),
            (1, "ok", "read", 1, 0.3, None)]
    ours = stats.StatsChecker().check({}, _history(ops, rows))
    assert ours == ref_stats.StatsChecker().check({}, _history(ref_ops,
                                                               rows))
    assert ours["valid?"] is False and ours["read"]["valid?"] is True


def test_counter_formats_equal_reference():
    scan = {"chunks_run": 7, "evicted_rows": 3, "groups_run": 2,
            "groups_early_exited": 1, "pipeline_overlap_s": 0.12345,
            "rows_run": 9, "wall_s": 1.5, "cycle_size_skips": 1,
            "cycle_nodes_pre": 40, "cycle_nodes_post": 12,
            "cycle_scc_hits": 2, "cycle_tiles_run": 5}
    tiers = {"dense": {"rows": 6, "wall_s": 0.123456},
             "greedy@lin": {"rows": 3, "wall_s": 0.01},
             "host": {"rows": 1, "wall_s": 0.5}}
    assert perf.format_scan_stats(scan) == ref_perf.format_scan_stats(scan)
    assert perf.format_cycle_stats(scan) == \
        ref_perf.format_cycle_stats(scan)
    assert perf.format_tier_stats(tiers) == \
        ref_perf.format_tier_stats(tiers)
    empty = dict(scan, groups_run=0, cycle_size_skips=0, cycle_nodes_pre=0,
                 cycle_nodes_post=0, cycle_scc_hits=0, cycle_tiles_run=0)
    assert perf.format_scan_stats(empty) is None
    assert perf.format_cycle_stats(empty) is None
    assert perf.format_tier_stats({}) is None


def test_scoped_tiers_equal_reference():
    """The same tiers noted inside a `stats_scope` of each package:
    `snapshot_tiers(scoped=True)` and `tier_summary` agree, and the
    scope holds only what was noted inside it."""
    notes = [("dense", 4, 0.5), ("sort", 1, 0.25), ("dense", 2, 0.125),
             ("greedy@lin", 3, 0.0625)]
    with schedule.stats_scope(label="a"):
        for t, n, w in notes:
            schedule.note_tier(t, rows=n, wall_s=w)
        ours = schedule.snapshot_tiers(scoped=True)
        ours_summary = perf.tier_summary()
    with ref_schedule.stats_scope(label="a"):
        for t, n, w in notes:
            ref_schedule.note_tier(t, rows=n, wall_s=w)
        theirs = ref_schedule.snapshot_tiers(scoped=True)
        theirs_summary = ref_perf.tier_summary()
    assert ours == theirs == {"dense": {"rows": 6, "wall_s": 0.625},
                              "sort": {"rows": 1, "wall_s": 0.25},
                              "greedy@lin": {"rows": 3, "wall_s": 0.0625}}
    assert ours_summary == theirs_summary
    with schedule.stats_scope():
        assert schedule.snapshot_tiers(scoped=True) == {}
        assert perf.tier_summary() is None
    assert schedule.snapshot_tiers()["dense"]["rows"] >= 6
