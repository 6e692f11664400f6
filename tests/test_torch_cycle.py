"""The port's exact cycle tier against the reference's checker/cycle.py.

`build_sc_graph` gives the reference's graph (adjacency, edge planes,
op index) on register and list-append encodings; `find_cycles` gives the
reference's output row for row, witnesses included, under each arm —
condensation (the default), the closure kernel (`JGRAFT_CYCLE_KERNEL=1`:
the plain versions on device="cpu", the reference's XLA programs on CPU
JAX), the host DFS (`=0`) and the direct arm (`JGRAFT_CYCLE_CONDENSE=0`)
— with the same node-cap skip and the same `cycle_*` counters. The
autotuner's cycle-arm store round-trips, and a stale record forces a
re-measure. Exact equality throughout.
"""

import json
import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import cycle as ref_cycle
from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.history.synth import corrupt as ref_corrupt
from jepsen_jgroups_raft_tpu.history.synth import \
    random_valid_history as ref_random_history
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker import autotune, cycle, schedule
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import build_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drain_reference_counters():
    """The reference's counters are process-wide, and its own tests read
    their totals: leave none of this file's reference calls in them."""
    yield
    ref_schedule.consume_stats()
    ref_schedule.consume_tiers()


STALE_READ = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
              (0, "invoke", "read", None), (0, "ok", "read", None)]
MONOTONIC_WRITES = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
                    (0, "invoke", "write", 2), (0, "ok", "write", 2),
                    (1, "invoke", "read", None), (1, "ok", "read", 2),
                    (1, "invoke", "read", None), (1, "ok", "read", 1)]
ARMS = {"condense": {}, "kernel": {"JGRAFT_CYCLE_KERNEL": "1"},
        "dfs": {"JGRAFT_CYCLE_KERNEL": "0"},
        "direct": {"JGRAFT_CYCLE_CONDENSE": "0"},
        "direct-kernel": {"JGRAFT_CYCLE_CONDENSE": "0",
                          "JGRAFT_CYCLE_KERNEL": "1"}}


def _rows(h):
    return [(op.process, op.type, op.f, op.value) for op in h]


def _histories(kind, seed, n, n_ops, n_procs=3, crash_p=0.15, every=3):
    """The reference generator's histories (every `every`-th corrupted by
    the reference's `corrupt`) as rows, plus the planted fixtures."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = ref_random_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                               crash_p=crash_p)
        if kind == "register" and i % every == 0:
            h = ref_corrupt(rng, h)
        out.append(_rows(h))
    if kind == "register":
        out += [STALE_READ, MONOTONIC_WRITES]
    return out


def _encs(rows_list, name):
    m, rm = MODELS[name](), REF_MODELS[name]()
    hs = [build_history(r) for r in rows_list]
    ours = [encode_history(h, m) for h in hs]
    theirs = [ref_enc(h, rm) for h in hs]
    for a, b in zip(ours, theirs):
        assert a.events.tobytes() == b.events.tobytes()
    return m, rm, ours, theirs


def _graph_equal(g, r):
    r = interop.graph_from_reference(r)
    if r is None or "adj" not in r:
        assert g == r
        return
    assert (g["n"], g["op_index"]) == (r["n"], r["op_index"])
    assert g["adj"].dtype == r["adj"].dtype
    assert g["adj"].tobytes() == r["adj"].tobytes()
    assert ("planes" in g) == ("planes" in r)
    for k in r.get("planes", {}):
        assert g["planes"][k].tobytes() == r["planes"][k].tobytes()


@pytest.mark.parametrize("kind,name", [("register", "cas-register"),
                                       ("list-append", "list-append")])
@pytest.mark.parametrize("planes", [False, True])
def test_build_sc_graph_matches_reference(kind, name, planes):
    m, rm, ours, theirs = _encs(_histories(kind, 11, 14, 24), name)
    built = 0
    for e, r in zip(ours, theirs):
        g = cycle.build_sc_graph(e, m, want_planes=planes)
        _graph_equal(g, ref_cycle.build_sc_graph(r, rm, want_planes=planes))
        built += g is not None and g.get("n", 0) >= 2
    assert built >= 10


def test_models_without_roles_build_no_graph():
    m, rm, ours, theirs = _encs(
        [[(0, "invoke", "add", 1), (0, "ok", "add", 1)]], "counter")
    assert cycle.build_sc_graph(ours[0], m) is None
    assert ref_cycle.build_sc_graph(theirs[0], rm) is None


@pytest.mark.parametrize("arm", list(ARMS))
def test_find_cycles_matches_reference_under_each_arm(arm, monkeypatch):
    for k in ("JGRAFT_CYCLE_KERNEL", "JGRAFT_CYCLE_CONDENSE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ARMS[arm].items():
        monkeypatch.setenv(k, v)
    m, rm, ours, theirs = _encs(_histories("register", 41, 16, 14),
                                "cas-register")
    got = cycle.find_cycles(ours, m, device="cpu")
    want = ref_cycle.find_cycles(theirs, rm)
    assert got == want
    hits = [c for c in got if c is not None and "cycle" in c]
    assert len(hits) >= 2 and None in got


def test_find_cycles_list_append_matches_reference(monkeypatch):
    """List-append rows build graphs (APPEND is a CAS); crashed appends
    write a sentinel nobody reads, so they stay out."""
    rows = _histories("list-append", 5, 10, 30, n_procs=4, crash_p=0.3)
    m, rm, ours, theirs = _encs(rows, "list-append")
    for env in ({}, {"JGRAFT_CYCLE_KERNEL": "1"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert cycle.find_cycles(ours, m, device="cpu") == \
            ref_cycle.find_cycles(theirs, rm)


def test_node_cap_skip_matches_reference(monkeypatch):
    monkeypatch.setenv("JGRAFT_CYCLE_MAX_OPS", "2")
    rows = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
            (0, "invoke", "write", 2), (0, "ok", "write", 2),
            (0, "invoke", "read", None), (0, "ok", "read", 1)]
    m, rm, ours, theirs = _encs([rows], "cas-register")
    schedule.consume_stats()
    with schedule.stats_scope() as scope:
        got = cycle.find_cycles(ours, m, device="cpu")
    assert got == ref_cycle.find_cycles(theirs, rm) == \
        [{"skipped-size": 3}]
    assert scope["cycle_size_skips"] == 1
    monkeypatch.delenv("JGRAFT_CYCLE_MAX_OPS")
    [c] = cycle.find_cycles(ours, m, device="cpu")
    assert "cycle" in c


def _counters(scope):
    return {k: scope[k] for k in ("cycle_size_skips", "cycle_nodes_pre",
                                  "cycle_nodes_post", "cycle_scc_hits",
                                  "cycle_tiles_run")}


@pytest.mark.parametrize("env", [{}, {"JGRAFT_CYCLE_KERNEL": "1"}],
                         ids=["condense", "kernel"])
def test_cycle_counters_match_reference(env, monkeypatch):
    """The scope counters, a 768-node bucket included (its kernel arm
    counts the blocked closure's tile programs)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rows = _histories("register", 3, 4, 12)
    rng = random.Random(8)
    rows.append(_rows(ref_random_history(rng, "register", n_ops=760,
                                         n_procs=4, crash_p=0.0)))
    m, rm, ours, theirs = _encs(rows, "cas-register")
    schedule.consume_stats()
    ref_schedule.consume_stats()
    with schedule.stats_scope() as scope:
        got = cycle.find_cycles(ours, m, device="cpu")
    with ref_schedule.stats_scope() as ref_scope:
        want = ref_cycle.find_cycles(theirs, rm)
    assert got == want
    assert _counters(scope) == _counters(ref_scope)
    if env:
        assert scope["cycle_tiles_run"] == 48  # one 768-node launch, T 256
    assert scope["cycle_nodes_pre"] > 512


def test_note_cycle_rejects_unknown_keys():
    with pytest.raises(KeyError):
        schedule.note_cycle(cycle_made_up=1)
    with pytest.raises(KeyError):
        ref_schedule.note_cycle(cycle_made_up=1)


# ------------------------------------------------------- cycle-arm store


@pytest.fixture
def store(tmp_path, monkeypatch):
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(tmp_path))
    monkeypatch.setenv("JGRAFT_AUTOTUNE_SAMPLES", "1")
    for k in ("JGRAFT_CYCLE_KERNEL", "JGRAFT_CYCLE_CONDENSE"):
        monkeypatch.delenv(k, raising=False)
    autotune.reset_for_tests()
    yield tmp_path
    autotune.reset_for_tests()


def test_cycle_arm_round_trip(store):
    sig = autotune.cycle_arm_sig(96)
    assert sig == ("cycle-arm", 96)
    assert autotune.cycle_arm_for(sig) is None
    autotune.save_cycle_arm(sig, "dfs", {"dfs": [0.1]})
    autotune.reset_for_tests()  # a fresh process reads the file
    assert autotune.cycle_arm_for(sig) == "dfs"
    rec = json.loads(next(store.rglob("cycle-arm-n96.json")).read_text())
    assert (rec["version"], rec["signature"], rec["arm"]) == \
        (autotune.CYCLE_ARM_VERSION, ["cycle-arm", 96], "dfs")
    assert rec["fingerprint"] == autotune.host_fingerprint()


def test_buckets_measure_once_and_stale_records_remeasure(store,
                                                          monkeypatch):
    m, rm, ours, theirs = _encs(_histories("register", 41, 16, 14),
                                "cas-register")
    want = ref_cycle.find_cycles(theirs, rm)
    # below the work gate: the default arm, nothing measured
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_CELLS", str(1 << 30))
    assert cycle.find_cycles(ours, m, device="cpu") == want
    assert not list(store.rglob("cycle-arm-*.json"))
    # above it: every bucket measured once, verdicts unchanged
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_CELLS", "1")
    autotune.consume_counters()
    assert cycle.find_cycles(ours, m, device="cpu") == want
    files = sorted(store.rglob("cycle-arm-*.json"))
    measured = autotune.consume_counters()["plans_measured"]
    assert files and measured == len(files)
    for f in files:
        assert json.loads(f.read_text())["arm"] in autotune.CYCLE_ARMS
    assert cycle.find_cycles(ours, m, device="cpu") == want
    assert autotune.consume_counters()["plans_measured"] == 0
    # a record of another schema version is stale: re-measured
    rec = json.loads(files[0].read_text())
    rec["version"] = autotune.CYCLE_ARM_VERSION + 1
    files[0].write_text(json.dumps(rec))
    autotune.reset_for_tests()
    assert cycle.find_cycles(ours, m, device="cpu") == want
    assert autotune.consume_counters()["plans_measured"] == 1
    assert json.loads(files[0].read_text())["version"] == \
        autotune.CYCLE_ARM_VERSION
