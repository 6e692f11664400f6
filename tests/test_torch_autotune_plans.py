"""The port's launch-plan store against the reference's
checker/autotune.py.

* `bucket_signature` and `_sig_name` equal the reference's for the same
  inputs, under either macro setting.
* `pack_group` gives the reference's batches byte for byte under each
  macro setting (JGRAFT_MACRO_EVENTS=0 included) and each plan.
* The candidate lists of a dense group and of a sort rung equal the
  reference's at one card (`mesh_fanout` 1).
* The store, as the reference's own tests hold it: round trip and file
  schema (the reference's keys and file name), a stale fingerprint, a
  foreign fingerprint directory, schema drift, a corrupt plan file;
  resolve picks the minimum and persists with its samples; autotune off
  gives None; the knobs parse defensively; small groups never measure.
* End to end: `check_histories` on 24 small register histories, a
  quarter corrupted, with the gates lowered: the result dicts at
  JGRAFT_AUTOTUNE=1 (measuring, then loading in a fresh process) equal
  those at 0, and under one persisted plan (scan_chunk 0, macro_p 4 for
  every group) they equal the reference checker's under the same plan.
  The same for the sort ladder on 24 small list-append histories, a
  quarter with one read corrupted, under one persisted plan of its
  C = 64 rung.
"""

import json
import random
from dataclasses import asdict

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import autotune as ref_at
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.history.packing import \
    encode_history as ref_encode
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu_torch import platform
from jepsen_jgroups_raft_tpu_torch.checker import autotune
from jepsen_jgroups_raft_tpu_torch.checker.autotune import (
    TunedPlan, bucket_signature, default_plan, plan_for, resolve_plan,
    save_plan)
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.history.packing import (
    MACRO_MAX_OPENS, encode_history)
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (dense_plan,
                                                          dense_plans_grouped)

torch.set_num_threads(1)

SIG = bucket_signature("dense", 5, 4, 100, 1500)
PLAN = TunedPlan(family="dense", scan_chunk=256, macro_p=8, mesh_fanout=1)


@pytest.fixture
def store(tmp_path, monkeypatch):
    """Autotuning on, both packages' stores in fresh directories, their
    in-memory plans dropped before and after."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(tmp_path / "port"))
    monkeypatch.setattr(ref_at, "store_root", lambda: tmp_path / "ref")
    autotune.reset_for_tests()
    ref_at.reset_for_tests()
    yield tmp_path / "port"
    autotune.reset_for_tests()
    ref_at.reset_for_tests()


def _register_encs(n, n_ops, seed=1):
    rng = random.Random(seed)
    m = MODELS["cas-register"]()
    hs = [random_valid_history(rng, "register", n_ops=n_ops, n_procs=4)
          for _ in range(n)]
    return hs, [encode_history(h, m) for h in hs], \
        [ref_encode(h, REF_MODELS["cas-register"]()) for h in hs]


# ------------------------------------------------- against the reference


@pytest.mark.parametrize("macro", [None, "0"], ids=["macro", "legacy"])
def test_signature_and_name_equal_reference(macro, monkeypatch):
    if macro is None:
        monkeypatch.delenv("JGRAFT_MACRO_EVENTS", raising=False)
    else:
        monkeypatch.setenv("JGRAFT_MACRO_EVENTS", macro)
    rng = random.Random(3)
    for fam in ("dense", "dense-mask", "sort"):
        for _ in range(40):
            args = (fam, rng.randrange(1, 128), rng.randrange(1, 513),
                    rng.randrange(0, 5000), rng.randrange(0, 40000))
            sig = bucket_signature(*args)
            assert sig == ref_at.bucket_signature(*args)
            assert autotune._sig_name(sig) == ref_at._sig_name(sig)
    # two batches that pad to the same launch shapes share a plan (rows
    # 100 and 120 bucket to 128, events 1400 and 1500 to 1536)
    sig = bucket_signature("dense", 5, 4, 100, 1500)
    assert sig == ref_at.bucket_signature("dense", 5, 4, 120, 1400)
    assert sig != bucket_signature("dense", 6, 4, 120, 1400)


@pytest.mark.parametrize("macro", [None, "0"], ids=["macro", "legacy"])
def test_pack_group_equals_reference(macro, monkeypatch):
    """Byte-identical batches with no plan and under plans of macro_p 0,
    4 and the default cap; JGRAFT_MACRO_EVENTS=0 keeps legacy rows under
    every plan."""
    if macro is None:
        monkeypatch.delenv("JGRAFT_MACRO_EVENTS", raising=False)
    else:
        monkeypatch.setenv("JGRAFT_MACRO_EVENTS", macro)
    _, encs, ref_encs = _register_encs(6, 40)
    for p in (None, 0, 4, MACRO_MAX_OPENS):
        plan = None if p is None else TunedPlan("dense", 128, p, 1)
        ref_plan = None if p is None else ref_at.TunedPlan("dense", 128, p, 1)
        got = autotune.pack_group(encs, plan)
        want = ref_at.pack_group(ref_encs, ref_plan)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and got[k].tobytes() == \
                    v.tobytes(), k
            else:
                assert got[k] == v, k
        if macro == "0":
            assert got["events"].shape[2] == 5 and "macro_p" not in got


def _one_card(monkeypatch):
    """The reference at a single device: no mesh fan-out."""
    from jepsen_jgroups_raft_tpu.parallel import mesh as ref_mesh

    monkeypatch.setattr(ref_mesh, "chunk_sharding", lambda n=None: None)


def _captured(mod, monkeypatch):
    """Patch `mod.resolve_plan` to record its candidates and pick the
    first without measuring."""
    seen = []

    def resolve(sig, candidates, measure):
        seen.append([asdict(c) for c in candidates])
        return candidates[0]

    monkeypatch.setattr(mod, "resolve_plan", resolve)
    return seen


@pytest.mark.parametrize("width", [1, 8], ids=["one-card", "8-placements"])
@pytest.mark.parametrize("chunk", [None, "0", "64", "4096"])
@pytest.mark.parametrize("macro", [None, "0"], ids=["macro", "legacy"])
def test_candidates_equal_reference_at_one_card(chunk, macro, width, store,
                                                monkeypatch):
    """The dense star (`_coordinate_candidates`) at several schedules and
    the sort rung's candidates (through `tuned_sort_plan`) equal the
    reference's at one device (one card: the fan-out candidates are [1])
    and at 8 (8 CPU placements against the reference's 8 devices), at
    several JGRAFT_SCAN_CHUNK values, both macro settings."""
    if width == 1:
        _one_card(monkeypatch)
    else:
        # `platform.pin_placements(width)`, undone after the test
        monkeypatch.setattr(platform, "_PLACEMENTS",
                            (torch.device("cpu"),) * width)
    for name, v in (("JGRAFT_SCAN_CHUNK", chunk),
                    ("JGRAFT_MACRO_EVENTS", macro)):
        if v is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, v)
    assert autotune._fanout_candidates() == ref_at._fanout_candidates() \
        == ([1] if width == 1 else [8, 4, 2, 1])
    for fam in ("dense", "dense-mask"):
        assert asdict(default_plan(fam)) == asdict(ref_at.default_plan(fam))
        for e_sched in (32, 128, 192, 256, 1536, 8192):
            got = [asdict(c) for c in
                   autotune._coordinate_candidates(fam, e_sched)]
            want = [asdict(c) for c in
                    ref_at._coordinate_candidates(fam, e_sched)]
            assert got == want and got[0] == asdict(default_plan(fam))
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", "1")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_CELLS", "1")
    assert len(autotune._coordinate_candidates("dense", 8192)) >= 2
    ours, theirs = _captured(autotune, monkeypatch), \
        _captured(ref_at, monkeypatch)
    for n_ops in (10, 60, 300):
        _, encs, ref_encs = _register_encs(3, n_ops, seed=n_ops)
        autotune.tuned_sort_plan(None, encs, 64, 8, device="cpu")
        ref_at.tuned_sort_plan(None, ref_encs, 64, 8)
    assert ours == theirs and len(ours) == 3
    assert autotune.sort_rung_sharding(TunedPlan("sort", 0, 4, 1)) is None
    assert ref_at.sort_rung_sharding(ref_at.TunedPlan("sort", 0, 4, 1)) \
        is None


# ------------------------------------------------------------- the store


def test_round_trip_and_file_schema(store, tmp_path):
    save_plan(SIG, PLAN, samples={"a": [0.1]})
    autotune.reset_for_tests()  # a fresh process
    assert plan_for(SIG) == PLAN
    [path] = list(store.rglob("*.json"))
    raw = json.loads(path.read_text())
    assert raw["version"] == autotune.PLAN_VERSION == ref_at.PLAN_VERSION
    assert raw["fingerprint"] == autotune.host_fingerprint()
    assert raw["signature"] == list(SIG)
    assert raw["plan"] == asdict(PLAN)
    assert path.parent.name == autotune.host_fingerprint()
    assert path.name == ref_at._sig_name(SIG)
    assert autotune.snapshot_counters()["plans_loaded"] == 1
    assert [e["source"] for e in autotune.applied_log()] == ["disk"]
    # the reference writes the same keys, and the same plan keys
    ref_at.save_plan(SIG, ref_at.TunedPlan(**asdict(PLAN)), {"a": [0.1]})
    [ref_path] = list((tmp_path / "ref").rglob("*.json"))
    ref_raw = json.loads(ref_path.read_text())
    assert sorted(ref_raw) == sorted(raw)
    assert ref_raw["plan"] == raw["plan"]
    assert ref_path.relative_to(tmp_path / "ref").parent.name == \
        ref_at.host_fingerprint()


def _rewrite(store, **kw):
    [path] = list(store.rglob("*.json"))
    raw = json.loads(path.read_text())
    raw.update(kw)
    path.write_text(json.dumps(raw))
    return path


@pytest.mark.parametrize("fault", ["stale-fingerprint", "foreign-directory",
                                   "schema-drift", "corrupt", "signature"])
def test_bad_plan_files_are_misses(fault, store, monkeypatch):
    """A stale fingerprint, a fingerprint directory of another host, an
    unknown schema version, a file that is not JSON and a plan of another
    signature each read as a miss (re-measure, never mis-tune); a
    re-measure then overwrites the bad file."""
    save_plan(SIG, PLAN, samples={})
    if fault == "stale-fingerprint":
        _rewrite(store, fingerprint="deadbeefdeadbeef")
    elif fault == "schema-drift":
        _rewrite(store, version=999)
    elif fault == "signature":
        _rewrite(store, signature=list(bucket_signature("dense", 6, 4, 1, 1)))
    elif fault == "corrupt":
        [path] = list(store.rglob("*.json"))
        path.write_text("{ not json !!")
    autotune.reset_for_tests()
    if fault == "foreign-directory":
        monkeypatch.setattr(autotune, "host_fingerprint",
                            lambda: "0123456789abcdef")
    assert plan_for(SIG) is None
    assert autotune.snapshot_counters()["plan_misses"] == 1
    assert plan_for(SIG) is None  # negative-cached: no second disk read
    assert autotune.snapshot_counters()["plan_misses"] == 1
    better = TunedPlan("dense", 64, 16, 1)
    resolve_plan(SIG, [better], lambda c: 0.01)
    autotune.reset_for_tests()
    assert plan_for(SIG) == better


def test_picks_min_persists_and_records_samples(store, monkeypatch):
    monkeypatch.setenv("JGRAFT_AUTOTUNE_SAMPLES", "2")
    cands = [TunedPlan("dense", c, 16, 1) for c in (0, 128, 256)]
    cost = {0: 0.03, 128: 0.01, 256: 0.02}
    calls = []

    def measure(c):
        calls.append(c.scan_chunk)
        return cost[c.scan_chunk]

    best = resolve_plan(SIG, cands, measure)
    assert best.scan_chunk == 128
    # one warm-up, then 2 timed rounds, the order rotating
    assert calls == [0, 128, 256, 0, 128, 256, 128, 256, 0]
    c = autotune.snapshot_counters()
    assert c["plans_measured"] == 1 and c["plans_loaded"] == 0
    [entry] = autotune.applied_log()
    assert entry["source"] == "measured" and entry["plan"] == asdict(best)
    assert autotune.applied_since(entry["seq"] - 1) == [entry]
    assert autotune.applied_since(autotune.applied_seq()) == []
    [path] = list(store.rglob("*.json"))
    raw = json.loads(path.read_text())
    assert len(raw["samples"]) == 3
    assert raw["samples"][json.dumps(asdict(best))] == [0.01, 0.01]
    autotune.reset_for_tests()
    assert plan_for(SIG) == best  # persisted; no re-measure needed


def test_autotune_off_gives_none(store, monkeypatch):
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "0")
    assert autotune.tuned_group_plan(object(), object(), [1]) is None
    assert autotune.tuned_sort_plan(object(), [1], 64, 8) is None
    assert autotune.snapshot_counters() == {
        "plans_loaded": 0, "plans_measured": 0, "plan_misses": 0}


def test_knobs_parse_defensively(store, monkeypatch):
    """Garbage warns and keeps the default; values below a knob's minimum
    clamp; a blank store keeps the default root."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "garbage")
    assert autotune.autotune_on() is True
    for name, fn, default in (
            ("JGRAFT_AUTOTUNE_SAMPLES", autotune.sample_reps, 2),
            ("JGRAFT_AUTOTUNE_MIN_ROWS", autotune.min_rows, 64),
            ("JGRAFT_AUTOTUNE_MIN_CELLS", autotune.min_cells, 1 << 16),
            ("JGRAFT_AUTOTUNE_SAMPLE_ROWS", autotune.sample_rows_cap, 64)):
        monkeypatch.setenv(name, "x")
        assert fn() == default
        monkeypatch.setenv(name, "-5")
        assert fn() == 1
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", "   ")
    assert str(autotune.store_root()) == autotune.DEFAULT_STORE


def test_small_groups_never_measure(store, monkeypatch):
    """Below the row gate (and, separately, below the cell gate) a group
    and a rung miss once and measure nothing; a LONG group is never
    consulted."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", "64")
    m = MODELS["cas-register"]()
    _, encs, _ = _register_encs(4, 10)
    plan = dense_plan(m, encs)
    assert autotune.tuned_group_plan(m, plan, encs, device="cpu") is None
    assert autotune.tuned_sort_plan(m, encs, 64, 8, device="cpu") is None
    c = autotune.snapshot_counters()
    assert c["plans_measured"] == 0 and c["plan_misses"] == 2
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", "1")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_CELLS", str(10 ** 9))
    autotune.reset_for_tests()
    assert autotune.tuned_group_plan(m, plan, encs, device="cpu") is None
    assert autotune.snapshot_counters()["plans_measured"] == 0
    long = [type(encs[0])(events=np.zeros((5000, 5), np.int32),
                          op_index=np.zeros(5000, np.int32), n_slots=1,
                          n_ops=0)]
    autotune.reset_for_tests()
    assert autotune.tuned_group_plan(m, plan, long, device="cpu") is None
    assert autotune.snapshot_counters()["plan_misses"] == 0
    assert not list(store.rglob("*.json"))


# ------------------------------------------------------------ end to end


def _corrupt(h, rng):
    """One ok read's value moved outside the register's domain."""
    ops = list(h)
    idx = [j for j, op in enumerate(ops) if op.type == "ok"
           and op.f == "read" and op.value is not None]
    j = rng.choice(idx)
    ops[j] = ops[j].replace(value=ops[j].value + 1000)
    return ops


def _strip(r):
    return {k: v for k, v in r.items() if k not in ("time-s", "algorithm")}


def _histories():
    rng = random.Random(17)
    hs = []
    for i in range(24):
        h = random_valid_history(rng, "register", n_ops=16, n_procs=4,
                                 crash_p=0.05, max_crashes=2)
        hs.append(_corrupt(h, rng) if i % 4 == 0 else list(h))
    return hs


def test_end_to_end_tuned_equals_untuned_and_reference(store, monkeypatch):
    """With the gates lowered (8 rows, 64 cells, 8 sample rows, one rep)
    the first check measures and persists plans, a fresh process loads
    them, and both give the result dicts of JGRAFT_AUTOTUNE=0. Then,
    under a persisted plan of scan_chunk 0 and macro_p 4 for every
    window group (measurement gated off), the port's result dicts equal
    the reference checker's under the same plan, each loading every
    plan from disk."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", "8")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_CELLS", "64")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_SAMPLE_ROWS", "8")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_SAMPLES", "1")
    m, rm = MODELS["cas-register"](), REF_MODELS["cas-register"]()
    hs = _histories()

    monkeypatch.setenv("JGRAFT_AUTOTUNE", "0")
    base = [_strip(r) for r in check_histories(hs, m, device="cpu")]
    assert {r["valid?"] for r in base} == {True, False}
    assert all(r.get("chunked") for r in base)
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    tuned = [_strip(r) for r in check_histories(hs, m, device="cpu")]
    assert tuned == base
    c = autotune.snapshot_counters()
    assert c["plans_measured"] >= 1 and list(store.rglob("*.json"))
    autotune.reset_for_tests()  # a fresh process loads from disk
    again = [_strip(r) for r in check_histories(hs, m, device="cpu")]
    assert again == base
    c = autotune.snapshot_counters()
    assert c["plans_loaded"] >= 1 and c["plans_measured"] == 0
    assert any(e["source"] == "disk" for e in autotune.applied_log())

    # one persisted plan for every window group, in both stores
    encs = [encode_history(h, m) for h in hs]
    fits = [i for i, e in enumerate(encs) if e.n_events > 0]
    grouped, rest = dense_plans_grouped(m, [encs[i] for i in fits])
    assert not rest and len(grouped) >= 2
    for idxs, plan in grouped:
        sig = bucket_signature(plan.kernel_tag, plan.n_slots, plan.n_states,
                               len(idxs),
                               max(encs[fits[j]].n_events for j in idxs))
        save_plan(sig, TunedPlan(plan.kernel_tag, 0, 4, 1), {})
        ref_at.save_plan(sig, ref_at.TunedPlan(plan.kernel_tag, 0, 4, 1),
                         {})
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", str(10 ** 6))
    autotune.reset_for_tests()
    ref_at.reset_for_tests()
    ours = [_strip(r) for r in check_histories(hs, m, device="cpu")]
    theirs = [_strip(r) for r in ref_check(hs, rm)]
    assert ours == theirs == base
    for mod in (autotune, ref_at):
        c = mod.snapshot_counters()
        assert c["plans_loaded"] == len(grouped), mod.__name__
        assert c["plans_measured"] == 0
        log = mod.applied_log()
        assert [e["source"] for e in log] == ["disk"] * len(grouped)
        assert all(e["plan"]["scan_chunk"] == 0 and e["plan"]["macro_p"] == 4
                   for e in log)


def _list_histories():
    """24 small list-append histories (the sort ladder's rows), a
    quarter with one ok read made to observe a list it never held."""
    rng = random.Random(5)
    hs = []
    for i in range(24):
        h = list(random_valid_history(rng, "list-append", n_ops=20,
                                      n_procs=4, crash_p=0.05,
                                      max_crashes=2))
        if i % 4 == 0:
            reads = [j for j, op in enumerate(h) if op.type == "ok"
                     and op.f == "read"]
            j = rng.choice(reads)
            v = list(h[j].value)
            h[j] = h[j].replace(value=v[:-1] if v else [1])
        hs.append(h)
    return hs


def test_end_to_end_sort_ladder_tuned_equals_untuned_and_reference(
        store, monkeypatch):
    """The sort ladder's rungs under their plans: with the gates lowered
    the first check measures the C = 64 rung's plan, a fresh process
    loads it, and both give the result dicts of JGRAFT_AUTOTUNE=0; under
    one persisted plan of scan_chunk 0 and macro_p 4 for that rung the
    port's result dicts equal the reference checker's under the same
    plan, each loading it from disk."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", "8")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_CELLS", "64")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_SAMPLE_ROWS", "8")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_SAMPLES", "1")
    m, rm = MODELS["list-append"](), REF_MODELS["list-append"]()
    hs = _list_histories()

    monkeypatch.setenv("JGRAFT_AUTOTUNE", "0")
    base = [_strip(r) for r in check_histories(hs, m, device="cpu")]
    assert {r["valid?"] for r in base} == {True, False}
    assert {r.get("decided-tier") for r in base} == {"sort"}
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    assert [_strip(r) for r in check_histories(hs, m, device="cpu")] == base
    log = autotune.applied_log()
    assert autotune.snapshot_counters()["plans_measured"] == 1
    assert [e["signature"][0] for e in log] == ["sort"]
    autotune.reset_for_tests()
    assert [_strip(r) for r in check_histories(hs, m, device="cpu")] == base
    c = autotune.snapshot_counters()
    assert c["plans_loaded"] == 1 and c["plans_measured"] == 0

    sig = tuple(log[0]["signature"])
    save_plan(sig, TunedPlan("sort", 0, 4, 1), {})
    ref_at.save_plan(sig, ref_at.TunedPlan("sort", 0, 4, 1), {})
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", str(10 ** 6))
    autotune.reset_for_tests()
    ref_at.reset_for_tests()
    ours = [_strip(r) for r in check_histories(hs, m, device="cpu")]
    theirs = [_strip(r) for r in ref_check(hs, rm)]
    assert ours == theirs == base
    for mod in (autotune, ref_at):
        log = mod.applied_log()
        assert [(e["source"], e["plan"]["scan_chunk"], e["plan"]["macro_p"])
                for e in log] == [("disk", 0, 4)], mod.__name__
