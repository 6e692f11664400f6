"""The port's lin fast path against the reference's: tiers at the
default knobs, verdict identity with the path on and off, the batched
certifier's outcomes, the abort budget, and the measured per-bucket
gate with its fingerprinted store. tests/conftest.py pins
JGRAFT_LIN_FASTPATH=0 and JGRAFT_AUTOTUNE=0 for the kernel suites; each
test here sets what it needs with monkeypatch. Exact equality."""

import json
import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import autotune as ref_autotune
from jepsen_jgroups_raft_tpu.checker.certify_batch import \
    certify_many as ref_certify_many
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu_torch.checker import autotune
from jepsen_jgroups_raft_tpu_torch.checker.base import INVALID, VALID
from jepsen_jgroups_raft_tpu_torch.checker.certify_batch import certify_many
from jepsen_jgroups_raft_tpu_torch.checker.consistency import certify_encoded
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
    check_encoded, check_histories, consume_fastpath_counters)
from jepsen_jgroups_raft_tpu_torch.checker.schedule import consume_tiers
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import (build_history,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import MODELS

torch.set_num_threads(1)

KINDS = {"register": "cas-register", "counter": "counter", "queue": "queue",
         "set": "set"}


def _corrupt(h, rng):
    idx = [j for j, op in enumerate(h) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = h[j].value
        v = (sorted(set(v) ^ {30}) if isinstance(v, list) else
             (v[0], v[1] + 1000) if isinstance(v, tuple) else v + 1000)
        h[j] = h[j].replace(value=v)
    return h


def _mixed(kind, n=8, n_ops=40, seed=11):
    """Valid and corrupted histories of one family."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = list(random_valid_history(
            rng, kind, n_ops=n_ops, n_procs=4, crash_p=0.05, max_crashes=2,
            **({"value_range": 6} if kind == "set" else {})))
        out.append(_corrupt(h, rng) if i % 3 == 0 else h)
    return out


def _poisoned(h):
    """write w1; write w2; read w1 appended sequentially on a fresh
    process: INVALID, and the certifier scans the whole stream first."""
    ops = list(h)
    rows = [(9999, "invoke", "write", 777001), (9999, "ok", "write", 777001),
            (9999, "invoke", "write", 777002), (9999, "ok", "write", 777002),
            (9999, "invoke", "read", None), (9999, "ok", "read", 777001)]
    tail = list(build_history(rows))
    t = max((op.time for op in ops), default=0) + 1
    n = len(ops)
    return ops + [op.replace(time=t + k, index=n + k)
                  for k, op in enumerate(tail)]


def test_default_knobs_give_the_reference_tiers(monkeypatch):
    """ROADMAP Queue C's input: 16 register histories at the default
    knobs (the fast path on): the reference's tiers row for row — 12
    backtrack@lin, 1 greedy@lin, 3 dense — and its verdicts."""
    monkeypatch.delenv("JGRAFT_LIN_FASTPATH", raising=False)
    rng = random.Random(5)
    hs = [random_valid_history(rng, "register", n_ops=150, n_procs=5,
                               crash_p=0.1, max_crashes=3)
          for _ in range(16)]
    ours = check_histories(hs, MODELS["cas-register"](), device="cpu")
    theirs = ref_check(hs, REF_MODELS["cas-register"]())
    view = [(r["valid?"], r["decided-tier"]) for r in ours]
    assert view == [(r["valid?"], r["decided-tier"]) for r in theirs]
    tiers = [t for _, t in view]
    assert (tiers.count("backtrack@lin"), tiers.count("greedy@lin"),
            tiers.count("dense")) == (12, 1, 3)
    assert {r["algorithm"] for r in ours if "@lin" in r["decided-tier"]} \
        == {"greedy-witness"}


@pytest.mark.parametrize("kind", list(KINDS))
def test_verdicts_identical_with_the_path_on_and_off(kind, monkeypatch):
    m = MODELS[KINDS[kind]]()
    hs = _mixed(kind)
    verdicts = {}
    for fp in ("1", "0"):
        monkeypatch.setenv("JGRAFT_LIN_FASTPATH", fp)
        consume_fastpath_counters()
        verdicts[fp] = [r["valid?"] for r in
                        check_histories(hs, m, device="cpu")]
        c = consume_fastpath_counters()
        assert (c["rows_scanned"] > 0) == (fp == "1")
    assert verdicts["1"] == verdicts["0"]
    assert True in verdicts["1"] and False in verdicts["1"]


@pytest.mark.parametrize("batch_min", ["1", "96"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_certify_many_equals_reference(kind, batch_min, monkeypatch):
    """The batched core (forced on every row with a floor of 1) and the
    scalar engine (below the default floor): the reference's (ok, tier,
    flips) triples on both polarities, with and without abort budgets."""
    monkeypatch.setenv("JGRAFT_CERTIFY_BATCH_MIN", batch_min)
    m, rm = MODELS[KINDS[kind]](), REF_MODELS[KINDS[kind]]()
    hs = _mixed(kind, n=12, n_ops=60, seed=17)
    encs = [encode_history(h, m) for h in hs]
    ref_encs = [ref_enc(h, rm) for h in hs]
    for budget in (None, [32 * max(e.n_events, 1) for e in encs],
                   [2] * len(encs)):
        ours = certify_many(encs, m, max_steps=budget)
        theirs = ref_certify_many(ref_encs, rm, max_steps=budget)
        assert ours == theirs
    assert any(ok for ok, _, _ in certify_many(encs, m))


def test_abort_budget_returns_undecided_never_wrong(monkeypatch):
    m = MODELS["cas-register"]()
    h = random_valid_history(random.Random(7), "register", n_ops=40,
                             crash_p=0.05)
    enc = encode_history(h, m)
    assert certify_encoded(enc, m)[0] is True
    ok, tier, _ = certify_encoded(enc, m, max_steps=2)
    assert ok is False and tier is None
    # a one-step budget per event through the checker: same verdicts
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "1")
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH_ABORT", "1")
    hs = _mixed("register")
    rs = check_histories(hs, m, device="cpu")
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "0")
    ref = check_histories(hs, m, device="cpu")
    assert [r["valid?"] for r in rs] == [r["valid?"] for r in ref]


def test_trivial_rows_and_explicit_engines(monkeypatch):
    """Empty histories keep the trivial tier; "cpu" and "dfs" keep
    their engines; certified rows carry the @lin tiers."""
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "1")
    m = MODELS["cas-register"]()
    [r] = check_encoded([encode_history(build_history([]), m)], m,
                        device="cpu")
    assert r["decided-tier"] == "trivial"
    hs = _mixed("register", n=6)
    consume_tiers()
    for algorithm in ("cpu", "dfs"):
        rs = check_histories(hs, m, algorithm=algorithm, device="cpu")
        assert {r["algorithm"] for r in rs} == {algorithm}
    rs = check_histories(hs, m, device="cpu")
    certified = [r for r in rs if r["algorithm"] == "greedy-witness"]
    assert certified and all(r["decided-tier"] in ("greedy@lin",
                                                   "backtrack@lin")
                             for r in certified)
    assert set(consume_tiers()) & {"greedy@lin", "backtrack@lin"}


def test_gating_off_without_autotune(monkeypatch, tmp_path):
    """JGRAFT_AUTOTUNE=0: the fast path always tries and persists
    nothing."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "0")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(tmp_path))
    sig = autotune.lin_fastpath_sig("CasRegister", 40)
    autotune.lin_fastpath_observe(sig, rows=100, hits=0, wall_s=0.1)
    assert autotune.lin_fastpath_route(sig) is True
    assert not list(tmp_path.glob("**/linfp-*.json"))


def test_low_hit_bucket_routes_kernel_first(monkeypatch, tmp_path):
    """A bucket whose rows never certify trains the gate: later batches
    route kernel-first (rows_gated, nothing scanned) with the same
    verdicts, and the record lands in the fingerprinted store, from
    which a fresh process state reloads it."""
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "1")
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(tmp_path))
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH_MIN_OBS", "8")
    monkeypatch.delenv("JGRAFT_LINFP_DIR", raising=False)
    autotune.reset_for_tests()
    m = MODELS["cas-register"]()
    hs = [_poisoned(random_valid_history(random.Random(9), "register",
                                         n_ops=20, crash_p=0.0))] * 8
    consume_fastpath_counters()
    rs1 = check_histories(hs, m, device="cpu")
    c1 = consume_fastpath_counters()
    assert c1["rows_scanned"] == 8 and c1["rows_certified"] == 0
    files = list((tmp_path / autotune.host_fingerprint()).glob(
        "linfp-*.json"))
    assert files, "gating record was not persisted"
    sig = autotune.lin_fastpath_sig(
        "CasRegister", encode_history(hs[0], m).n_events)
    assert autotune.lin_fastpath_route(sig) is False
    rs2 = check_histories(hs, m, device="cpu")
    c2 = consume_fastpath_counters()
    assert c2["rows_gated"] == 8 and c2["rows_scanned"] == 0
    assert [r["valid?"] for r in rs1] == [r["valid?"] for r in rs2]
    assert all(r["valid?"] is INVALID for r in rs2)
    autotune.reset_for_tests()
    assert autotune.lin_fastpath_route(sig) is False
    autotune.reset_for_tests()


# (rows, hits, certify wall per row): rows below MIN_OBS = 8, then hit
# rates below, at and above the floor of 0.05 with large and small
# certify walls.
GATE_RECORDS = [
    (0, 0, 0.0), (4, 0, 0.010), (7, 7, 0.0001),
    (100, 0, 0.010), (100, 4, 0.0001), (100, 5, 0.010), (100, 5, 0.0001),
    (100, 6, 0.010), (100, 90, 0.010), (100, 90, 0.0001),
    (8, 1, 0.050), (8, 0, 0.0001),
]


def _fresh_gates(monkeypatch, store):
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(store))
    autotune.reset_for_tests()
    ref_autotune.reset_for_tests()


@pytest.mark.parametrize("rows, hits, certify_s", GATE_RECORDS)
def test_gate_routes_as_the_reference(monkeypatch, tmp_path, rows, hits,
                                      certify_s):
    """The same observations fed to both gates, each with its own store:
    the port routes as the reference, by hit rate alone, before and
    after the record reloads from the store."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH_MIN_OBS", "8")
    monkeypatch.delenv("JGRAFT_LINFP_DIR", raising=False)
    monkeypatch.delenv("JGRAFT_SERVICE_CLUSTER_DIR", raising=False)
    routes = []
    for gate, store in ((autotune, tmp_path / "port"),
                        (ref_autotune, tmp_path / "ref")):
        _fresh_gates(monkeypatch, store)
        sig = gate.lin_fastpath_sig("CasRegister", 200)
        # two batches, so the record accumulates as a check's would
        for part, share in ((rows // 2, hits // 2),
                            (rows - rows // 2, hits - hits // 2)):
            gate.lin_fastpath_observe(sig, rows=part, hits=share,
                                      wall_s=part * certify_s)
        first = gate.lin_fastpath_route(sig)
        _fresh_gates(monkeypatch, store)
        routes.append((first, gate.lin_fastpath_route(sig)))
    _fresh_gates(monkeypatch, tmp_path)
    assert routes[0] == routes[1]
    assert routes[0][0] == routes[0][1]
    assert routes[0][0] is (rows < 8 or hits / rows >= 0.05)


def test_record_with_a_device_wall_still_loads(monkeypatch, tmp_path):
    """A record written with the former `kernel_wall_per_row_s` field
    loads, and the gate ignores the field."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH_MIN_OBS", "8")
    monkeypatch.delenv("JGRAFT_LINFP_DIR", raising=False)
    _fresh_gates(monkeypatch, tmp_path)
    sig = autotune.lin_fastpath_sig("CasRegister", 200)
    autotune.lin_fastpath_observe(sig, rows=100, hits=90, wall_s=1.0)
    [path] = (tmp_path / autotune.host_fingerprint()).glob("linfp-*.json")
    raw = json.loads(path.read_text())
    raw["kernel_wall_per_row_s"] = 1e-6
    path.write_text(json.dumps(raw))
    autotune.reset_for_tests()
    rec = autotune._linfp_record(sig)
    assert (rec["rows"], rec["hits"]) == (100, 90)
    assert "kernel_wall_per_row_s" not in rec
    assert autotune.lin_fastpath_route(sig) is True
    autotune.reset_for_tests()


def test_second_check_keeps_the_reference_tiers(monkeypatch, tmp_path):
    """ROADMAP Queue C's close test: 32 register histories at the default
    knobs with the gate on (MIN_OBS 8), a fresh store per package, two
    checks: both checks give the reference's tiers row for row (29
    backtrack@lin, 3 dense) and its verdicts."""
    monkeypatch.delenv("JGRAFT_LIN_FASTPATH", raising=False)
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH_MIN_OBS", "8")
    monkeypatch.delenv("JGRAFT_LINFP_DIR", raising=False)
    monkeypatch.delenv("JGRAFT_SERVICE_CLUSTER_DIR", raising=False)
    rng = random.Random(5)
    hs = [random_valid_history(rng, "register", n_ops=400, n_procs=5,
                               crash_p=0.1, max_crashes=3)
          for _ in range(32)]
    views = {}
    for name, run in (
            ("port", lambda: check_histories(
                hs, MODELS["cas-register"](), device="cpu")),
            ("ref", lambda: ref_check(hs, REF_MODELS["cas-register"]()))):
        _fresh_gates(monkeypatch, tmp_path / name)
        views[name] = [[(r["valid?"], r["decided-tier"]) for r in run()]
                       for _ in range(2)]
    _fresh_gates(monkeypatch, tmp_path)
    assert views["port"] == views["ref"]
    for view in views["port"]:
        tiers = [t for _, t in view]
        assert (tiers.count("backtrack@lin"), tiers.count("dense")) \
            == (29, 3)


def test_shared_gate_dir_seeds_a_fresh_store(monkeypatch, tmp_path):
    """A record published into JGRAFT_LINFP_DIR by one store seeds the
    gate of a process with an empty store of its own."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH_MIN_OBS", "8")
    monkeypatch.setenv("JGRAFT_LINFP_DIR", str(tmp_path / "shared"))
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(tmp_path / "a"))
    autotune.reset_for_tests()
    sig = autotune.lin_fastpath_sig("CasRegister", 200)
    autotune.lin_fastpath_observe(sig, rows=16, hits=0, wall_s=0.01)
    assert list((tmp_path / "shared" / "linfp").glob("linfp-*.json"))
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(tmp_path / "b"))
    autotune.reset_for_tests()
    assert autotune.lin_fastpath_route(sig) is False
    monkeypatch.delenv("JGRAFT_LINFP_DIR")
    autotune.reset_for_tests()
    assert autotune.lin_fastpath_route(sig) is True
    autotune.reset_for_tests()


def test_fingerprint_names_the_device():
    info = autotune.fingerprint_info()
    assert info["torch"] == torch.__version__
    assert info["platform"] == ("cuda" if torch.cuda.is_available()
                                else "cpu")
    assert "jax" not in info and "jaxlib" not in info
    assert len(autotune.host_fingerprint()) == 16


def test_valid_rows_stay_valid_when_certified(monkeypatch):
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "1")
    m = MODELS["counter"]()
    rng = random.Random(3)
    hs = [random_valid_history(rng, "counter", n_ops=50, n_procs=4,
                               crash_p=0.05, max_crashes=2)
          for _ in range(6)]
    rs = check_histories(hs, m, device="cpu")
    assert all(r["valid?"] is VALID for r in rs)
