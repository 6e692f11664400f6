"""graftsearch in the port (`jepsen_jgroups_raft_tpu_torch/search/`, the
`search` subcommand), held against the reference's `search/` on the same
seeds, on the CPU.

Every registry operator, for every family it applies to and every edit
seed of a small edit space, materializes the reference's history op for
op; `corrupt_once`, `family_of`, `apply_history_op` and `synth.corrupt`
agree; scenario fingerprints (hashed under the shared name "auto") and
genome dicts are equal; the fitness functions give equal scores on equal
rows; `plant_violations` gives equal plants. A tiny `SearchDriver` run
on the port's service at ``device="cpu"`` and on the reference's service
gives equal reports (apart from `wall_s` and `cpu_s`) and equal corpora,
each package's corpus re-verifies in the other, and `run_recall` finds
and misses the same plants. The CLI resolves its device first (exit 3
without a card), runs at ``--device cpu`` and takes ``--arm random``;
a check request that fails makes the run raise instead of scoring the
candidate as empty rows. The reference's own cases (tests/test_search.py)
are carried over to the port below them.
"""

from __future__ import annotations

import contextlib
import json
import os
import random

import pytest
import torch

from jepsen_jgroups_raft_tpu import cli as ref_cli
from jepsen_jgroups_raft_tpu import search as ref_search
from jepsen_jgroups_raft_tpu.history import synth as ref_synth
from jepsen_jgroups_raft_tpu.search import corpus as ref_corpus
from jepsen_jgroups_raft_tpu.search import fitness as ref_fitness
from jepsen_jgroups_raft_tpu.search import operators as ref_operators
from jepsen_jgroups_raft_tpu.search import scenario as ref_scenario
from jepsen_jgroups_raft_tpu.service import CheckingService as RefService
from jepsen_jgroups_raft_tpu_torch import cli
from jepsen_jgroups_raft_tpu_torch.checker import linearizable as lin
from jepsen_jgroups_raft_tpu_torch.checker.base import INVALID, UNKNOWN, VALID
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import check_histories
from jepsen_jgroups_raft_tpu_torch.history import synth
from jepsen_jgroups_raft_tpu_torch.history.ops import History, Op
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.nemesis.package import schedule_pressure
from jepsen_jgroups_raft_tpu_torch.ops import _build
from jepsen_jgroups_raft_tpu_torch.search import (REGISTRY, Corpus, Scenario,
                                                  SearchConfig, SearchDriver,
                                                  corrupt_once, family_of,
                                                  materialize, operators_for,
                                                  plant_violations,
                                                  run_recall,
                                                  scenario_fingerprint,
                                                  score_candidate)
from jepsen_jgroups_raft_tpu_torch.search import corpus as port_corpus
from jepsen_jgroups_raft_tpu_torch.search import driver as port_driver
from jepsen_jgroups_raft_tpu_torch.search import fitness
from jepsen_jgroups_raft_tpu_torch.search import operators
from jepsen_jgroups_raft_tpu_torch.search.corpus import reverify_entry
from jepsen_jgroups_raft_tpu_torch.search.fitness import (TIER_DISTANCE,
                                                          score_result_row,
                                                          score_txn)
from jepsen_jgroups_raft_tpu_torch.search.operators import (FAMILIES,
                                                            apply_history_op)
from jepsen_jgroups_raft_tpu_torch.search.scenario import mutate
from jepsen_jgroups_raft_tpu_torch.service import (CheckingService,
                                                   serve_in_thread)
from jepsen_jgroups_raft_tpu_torch.service.request import build_units

torch.set_num_threads(1)

#: edit seeds each operator is held at against the reference
EDIT_SPACE = 6

#: the report keys that are clocks, not results
CLOCKS = ("wall_s", "cpu_s")


@pytest.fixture(scope="module")
def service():
    svc = CheckingService(store_root=None, batch_wait=0.0, device="cpu")
    yield svc
    svc.shutdown(wait=True)


@pytest.fixture(scope="module")
def ref_service():
    svc = RefService(store_root=None, batch_wait=0.0)
    yield svc
    svc.shutdown(wait=True)


def tiny_kw(**kw):
    """tests/test_search.py's `tiny_config`, as keyword arguments."""
    kw.setdefault("families", ("register", "queue"))
    kw.setdefault("population", 10)
    kw.setdefault("generations", 2)
    kw.setdefault("survivors", 4)
    kw.setdefault("edit_space", 8)
    kw.setdefault("seed", 0)
    kw.setdefault("n_ops", 10)
    kw.setdefault("bases_per_family", 2)
    return kw


def tiny_config(tmp_path, **kw):
    kw = tiny_kw(**kw)
    kw.setdefault("corpus_dir", str(tmp_path / "search"))
    return SearchConfig(device="cpu", **kw)


def base_scenario(family, seed=3, n_ops=14, cls=Scenario):
    return cls(family=family, seed=seed, n_ops=n_ops,
               n_keys=2 if family == "list-append" else 1)


def rows_of(hist) -> list:
    return [(o.process, o.type, o.f, o.value) for o in hist]


def without_clocks(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if k not in CLOCKS}


def corpus_entries(root) -> list:
    return list(Corpus(str(root)).entries())


# ---------------------------------------- the port against the reference

OPERATOR_CASES = [(op.name, fam) for op in operators._OPERATORS
                  for fam in op.families]


def test_registries_are_the_references():
    assert list(REGISTRY) == list(ref_operators.REGISTRY)
    assert FAMILIES == ref_operators.FAMILIES
    for name, op in REGISTRY.items():
        ref = ref_operators.REGISTRY[name]
        assert (op.target, op.families, op.can_invalidate) == \
            (ref.target, ref.families, ref.can_invalidate)
    for fam in FAMILIES:
        for target in (None, "history", "params"):
            assert [o.name for o in operators_for(fam, target)] == \
                [o.name for o in ref_operators.operators_for(fam, target)]


@pytest.mark.parametrize("name,family", OPERATOR_CASES)
def test_operator_materializes_the_references_history(name, family):
    """One operator on one family's base at every edit seed below
    EDIT_SPACE: the mutant genome, its materialized history and its
    admission fingerprint equal the reference's; a history operator
    applied directly under the same RNG gives the same rows (or is
    inapplicable alike)."""
    base = base_scenario(family)
    ref_base = base_scenario(family, cls=ref_scenario.Scenario)
    hist, ref_hist = materialize(base), ref_scenario.materialize(ref_base)
    assert rows_of(hist) == rows_of(ref_hist)
    op, ref_op = REGISTRY[name], ref_operators.REGISTRY[name]
    for es in range(EDIT_SPACE):
        child = mutate(base, op, es)
        ref_child = ref_scenario.mutate(ref_base, ref_op, es)
        assert child.to_dict() == ref_child.to_dict()
        assert rows_of(materialize(child)) == \
            rows_of(ref_scenario.materialize(ref_child))
        assert scenario_fingerprint(child) == \
            ref_scenario.scenario_fingerprint(ref_child)
        if op.target != "history":
            continue
        out = apply_history_op(op, random.Random(f"t:{name}:{es}"), hist)
        ref_out = ref_operators.apply_history_op(
            ref_op, random.Random(f"t:{name}:{es}"), ref_hist)
        assert (out is None) == (ref_out is None)
        if out is not None:
            assert rows_of(out) == rows_of(ref_out)


@pytest.mark.parametrize("family", FAMILIES)
def test_edit_chains_match_the_reference(family):
    """Four-deep chains of seeded edits (history and params operators
    mixed) replay to the reference's genome, history and fingerprint,
    at the linearizable and the sequential rung."""
    rng = random.Random(f"chain:{family}")
    g = base_scenario(family, seed=5, n_ops=20)
    ref_g = base_scenario(family, seed=5, n_ops=20,
                          cls=ref_scenario.Scenario)
    ops = operators_for(family)
    for _ in range(4):
        op = ops[rng.randrange(len(ops))]
        es = rng.randrange(24)
        g = mutate(g, op, es)
        ref_g = ref_scenario.mutate(ref_g, ref_operators.REGISTRY[op.name],
                                    es)
        assert g.to_dict() == ref_g.to_dict()
        assert rows_of(materialize(g)) == \
            rows_of(ref_scenario.materialize(ref_g))
        for rung in ("linearizable", "sequential"):
            assert scenario_fingerprint(g, rung) == \
                ref_scenario.scenario_fingerprint(ref_g, rung)
    assert Scenario.from_dict(ref_g.to_dict()) == g


@pytest.mark.parametrize("family", FAMILIES)
def test_corrupt_and_family_of_match_the_reference(family):
    hist = materialize(base_scenario(family, seed=7, n_ops=16))
    ref_hist = ref_scenario.materialize(
        base_scenario(family, seed=7, n_ops=16, cls=ref_scenario.Scenario))
    assert family_of(hist) == ref_operators.family_of(ref_hist)
    for s in range(8):
        assert rows_of(corrupt_once(random.Random(s), hist)) == \
            rows_of(ref_operators.corrupt_once(random.Random(s), ref_hist))
        assert rows_of(corrupt_once(random.Random(s), hist, family)) == \
            rows_of(ref_operators.corrupt_once(random.Random(s), ref_hist,
                                               family))
        assert rows_of(synth.corrupt(random.Random(s), hist)) == \
            rows_of(ref_synth.corrupt(random.Random(s), ref_hist))


def test_corrupt_of_a_writes_only_history_matches_the_reference():
    rows = []
    for i in range(6):
        rows += [(0, "invoke", "write", i), (0, "ok", "write", i)]
    hist, ref_hist = synth.build_history(rows), ref_synth.build_history(rows)
    assert family_of(hist) == ref_operators.family_of(ref_hist) == "register"
    for s in range(8):
        assert rows_of(synth.corrupt(random.Random(s), hist)) == \
            rows_of(ref_synth.corrupt(random.Random(s), ref_hist))


SCORED_ROWS = [
    {"decided-tier": "greedy", "valid?": VALID},
    {"decided-tier": "greedy@lin", "valid?": VALID},
    {"decided-tier": "backtrack@lin", "valid?": VALID, "sc-refuted": True},
    {"decided-tier": "cycle", "valid?": VALID, "cycle-skipped-size": 12},
    {"decided-tier": "dense", "valid?": UNKNOWN},
    {"decided-tier": "mask", "valid?": INVALID, "op-count": 9},
    {"decided-tier": "sort", "valid?": INVALID,
     "counterexample": {"minimal-op-count": 4}},
    {"decided-tier": "host", "valid?": INVALID, "counterexample": {}},
    {"decided-tier": "unheard-of", "valid?": VALID,
     "decided-at-segment": 3, "segments": 4},
    {"valid?": VALID, "decided-at-segment": 1, "segment-count": 8},
]

SCORED_TXNS = [
    None, {},
    {"valid?": True, "histories": [{"anomalies": {}}]},
    {"valid?": INVALID, "histories": [
        {"anomalies": {"G1c": {"cycle": [1, 2]}, "G0": None}}]},
    {"valid?": UNKNOWN, "histories": [
        {"anomalies": {}, "cycle-skipped-size": 300}]},
    {"valid?": INVALID, "histories": [
        {"anomalies": {"G1c": {"cycle": [1]}, "G-single": {"cycle": [3]}}},
        {"anomalies": {"G0": {"cycle": [2]}}}]},
]


def test_fitness_scores_equal_the_references():
    assert TIER_DISTANCE == ref_fitness.TIER_DISTANCE
    for row in SCORED_ROWS:
        assert score_result_row(row) == ref_fitness.score_result_row(row)
    for txn in SCORED_TXNS:
        assert score_txn(txn) == ref_fitness.score_txn(txn)
    for i in range(len(SCORED_ROWS)):
        rows = SCORED_ROWS[:i]
        for txn in SCORED_TXNS:
            assert score_candidate(rows, txn) == \
                ref_fitness.score_candidate(rows, txn)


def test_fitness_of_service_rows_equals_the_references(service,
                                                       ref_service):
    """Rows the two services give for the same mutants score alike."""
    for family in ("register", "set", "queue", "list-append"):
        sc = base_scenario(family, seed=2)
        for name in ("crash-op", "reorder-completion",
                     *(o.name for o in operators_for(family, "history")
                       if o.can_invalidate)):
            child = mutate(sc, REGISTRY[name], 1)
            hist = materialize(child)
            req = service.submit([hist], workload=family)
            ref_req = ref_service.submit(
                [ref_scenario.materialize(ref_scenario.Scenario.from_dict(
                    child.to_dict()))], workload=family)
            assert req.wait(60) and ref_req.wait(60)
            assert score_candidate(req.results, req.txn_anomalies) == \
                ref_fitness.score_candidate(ref_req.results,
                                            ref_req.txn_anomalies)


def test_plants_equal_the_references():
    kw = tiny_kw(families=("register", "set", "queue", "list-append"),
                 edit_space=12, n_ops=12)
    plants = plant_violations(SearchConfig(**kw), 6)
    ref_plants = ref_search.plant_violations(ref_search.SearchConfig(**kw),
                                             6)
    assert [(p.base.to_dict(), p.edit) for p in plants] == \
        [(p.base.to_dict(), p.edit) for p in ref_plants]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory, service, ref_service):
    """The tiny search on both packages' services, guided and random."""
    root = tmp_path_factory.mktemp("both")
    out = {}
    for arm, guided in (("guided", True), ("random", False)):
        port_dir, ref_dir = root / f"port-{arm}", root / f"ref-{arm}"
        rep = SearchDriver(SearchConfig(
            device="cpu", corpus_dir=str(port_dir), guided=guided,
            **tiny_kw()), service=service).run()
        ref_rep = ref_search.SearchDriver(ref_search.SearchConfig(
            corpus_dir=str(ref_dir), guided=guided, **tiny_kw()),
            service=ref_service).run()
        out[arm] = (rep, ref_rep, port_dir, ref_dir)
    return out


@pytest.mark.parametrize("arm", ["guided", "random"])
def test_tiny_search_reports_equal_the_references(both_runs, arm):
    rep, ref_rep, _, _ = both_runs[arm]
    assert without_clocks(rep) == without_clocks(ref_rep)
    assert rep["arm"] == arm
    assert rep["candidates"] > 0 and rep["per-generation"]
    if arm == "guided":
        assert rep["corpus"] >= 1 and rep["found-regions"]


@pytest.mark.parametrize("arm", ["guided", "random"])
def test_tiny_search_corpora_equal_the_references(both_runs, arm):
    _, _, port_dir, ref_dir = both_runs[arm]
    entries = corpus_entries(port_dir)
    ref_entries = list(ref_search.Corpus(str(ref_dir)).entries())
    assert entries == ref_entries
    # the files themselves, byte for byte
    for e in entries:
        fp = e["fingerprint"]
        rel = f"corpus/{fp[:2]}/{fp}.json"
        assert (port_dir / rel).read_bytes() == (ref_dir / rel).read_bytes()


@pytest.mark.parametrize("arm", ["guided", "random"])
def test_each_packages_corpus_reverifies_in_the_other(both_runs, arm):
    _, _, port_dir, ref_dir = both_runs[arm]
    ref_loaded = Corpus(str(ref_dir))
    port_loaded = ref_search.Corpus(str(port_dir))
    assert ref_loaded.fingerprints() == port_loaded.fingerprints()
    for e in ref_loaded.entries():
        assert reverify_entry(e), e["fingerprint"]
    for e in port_loaded.entries():
        assert ref_corpus.reverify_entry(e), e["fingerprint"]


def test_recall_equals_the_references(tmp_path, service, ref_service):
    kw = tiny_kw(families=("register", "set", "queue"), population=24,
                 generations=4, survivors=8, edit_space=12, n_ops=12)
    rep = run_recall(SearchConfig(corpus_dir=str(tmp_path / "p"),
                                  device="cpu", **kw), k=3,
                     service=service)
    ref_rep = ref_search.run_recall(ref_search.SearchConfig(
        corpus_dir=str(tmp_path / "r"), **kw), k=3, service=ref_service)
    assert rep.planted == ref_rep.planted == 3
    assert rep.found == ref_rep.found and rep.missed == ref_rep.missed
    assert rep.found
    assert without_clocks(rep.report) == without_clocks(ref_rep.report)


def test_list_append_search_equals_the_references(tmp_path, service,
                                                  ref_service):
    """The transactional tier: multi-key list-append bases, whose
    anomaly overlay rides outside the per-key rows."""
    kw = tiny_kw(families=("list-append",), population=12, n_ops=14)
    rep = SearchDriver(SearchConfig(corpus_dir=str(tmp_path / "p"),
                                    device="cpu", **kw),
                       service=service).run()
    ref_rep = ref_search.SearchDriver(ref_search.SearchConfig(
        corpus_dir=str(tmp_path / "r"), **kw), service=ref_service).run()
    assert without_clocks(rep) == without_clocks(ref_rep)
    assert corpus_entries(tmp_path / "p") == \
        list(ref_search.Corpus(str(tmp_path / "r")).entries())


# ------------------------------------------------------------ the CLI

SEARCH_FLAGS = ["--families", "register", "--population", "8",
                "--generations", "1", "--survivors", "4",
                "--edit-space", "8", "--n-ops", "10", "--seed", "0"]


def test_cli_without_a_card_exits_3_and_runs_nothing(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*a, **kw):
        raise AssertionError("a search was started")

    monkeypatch.setattr(port_driver, "SearchDriver", refuse)
    for extra in ([], ["--recall", "2"]):
        rc = cli.main(["search", *SEARCH_FLAGS, *extra,
                       "--corpus-dir", str(tmp_path / "corpus")])
        assert rc == 3
        assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "corpus").exists()


@pytest.mark.parametrize("arm", ["guided", "random"])
def test_cli_search_on_the_cpu_equals_the_references(tmp_path, capsys, arm):
    rc = cli.main(["search", *SEARCH_FLAGS, "--arm", arm, "--device", "cpu",
                   "--corpus-dir", str(tmp_path / "p")])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert ref_cli.main(["search", *SEARCH_FLAGS, "--arm", arm,
                         "--corpus-dir", str(tmp_path / "r")]) == 0
    ref_rep = json.loads(capsys.readouterr().out)
    assert without_clocks(rep) == without_clocks(ref_rep)
    assert rep["arm"] == arm and rep["families"] == ["register"]


def test_cli_recall_on_the_cpu_equals_the_references(tmp_path, capsys):
    flags = ["--families", "register,queue", "--population", "12",
             "--generations", "2", "--survivors", "4", "--edit-space",
             "12", "--n-ops", "12", "--recall", "2"]
    assert cli.main(["search", *flags, "--device", "cpu",
                     "--corpus-dir", str(tmp_path / "p")]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert ref_cli.main(["search", *flags,
                         "--corpus-dir", str(tmp_path / "r")]) == 0
    ref_rep = json.loads(capsys.readouterr().out)
    assert rep["planted"] == ref_rep["planted"] == 2
    assert (rep["found"], rep["missed"]) == \
        (ref_rep["found"], ref_rep["missed"])


# ------------------------------------------ a failed check is not a score


def _card_service(monkeypatch, check):
    """A service on the card's default check path, on a host without a
    card (tests/test_torch_service.py's): the start-time build is
    stubbed and the path's `check_encoded` is `check`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda names: 0.0)
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(lin, "check_encoded", check)
    svc = CheckingService(store_root=None, batch_wait=0.0, device="cuda")
    monkeypatch.setattr(svc.scheduler, "launch_scope",
                        contextlib.nullcontext)
    return svc


def _broken(encs, model, **kw):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def test_a_failed_check_makes_the_run_raise(tmp_path, monkeypatch):
    svc = _card_service(monkeypatch, _broken)
    assert svc.scheduler.host_degrade is False
    try:
        with pytest.raises(RuntimeError, match="ended failed.*illegal "
                                               "memory access"):
            SearchDriver(tiny_config(tmp_path), service=svc).run()
    finally:
        svc.shutdown(wait=True)
    assert len(Corpus(str(tmp_path / "search"))) == 0


def test_a_failed_check_over_http_makes_the_run_raise(tmp_path,
                                                      monkeypatch):
    svc = _card_service(monkeypatch, _broken)
    httpd, port, _ = serve_in_thread(svc)
    try:
        cfg = tiny_config(tmp_path,
                          service_url=f"http://127.0.0.1:{port}")
        with pytest.raises(RuntimeError, match="ended failed"):
            SearchDriver(cfg).run()
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown(wait=True)


def test_a_request_still_running_at_the_timeout_raises(tmp_path,
                                                       monkeypatch,
                                                       service):
    monkeypatch.setattr(port_driver, "_EVAL_TIMEOUT_S", 0.0)
    monkeypatch.setattr(service, "submit",
                        lambda *a, **kw: _Pending())
    with pytest.raises(RuntimeError, match="ended queued"):
        SearchDriver(tiny_config(tmp_path), service=service).run()


class _Pending:
    id = "never-run"
    status = "queued"
    error = None
    results = None
    txn_anomalies = None

    def wait(self, timeout=None):
        return False


def _search_over_http(svc, root, serve, **kw) -> dict:
    httpd, port, _ = serve(svc)
    try:
        return SearchDriver(SearchConfig(
            corpus_dir=str(root), service_url=f"http://127.0.0.1:{port}",
            **kw)).run()
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown(wait=True)


def test_search_over_http_equals_the_references(tmp_path, monkeypatch):
    """A port daemon reached over HTTP (binary frames; JSON for
    list-append) gives the reference daemon's report. It need not give
    the in-process service's: the binary lane ships encodings only, so
    its rows carry no minimized counterexample and score by `op-count`
    (the reference's own behaviour), and the fitness steers the
    selection. The reference's driver scores a submit
    answer that says "done" without results as empty rows (a race with
    the check); its client is made to fetch them here, as the port's
    driver does, so the comparison does not depend on the race."""
    from jepsen_jgroups_raft_tpu.service import \
        serve_in_thread as ref_serve_in_thread
    from jepsen_jgroups_raft_tpu.service.client import \
        ServiceClient as RefClient

    ref_submit = RefClient.submit

    def submit_with_results(self, *a, **kw):
        rec = ref_submit(self, *a, **kw)
        if rec["status"] == "done" and "results" not in rec:
            rec = self.result(rec["id"], wait_s=10.0)
        return rec

    monkeypatch.setattr(RefClient, "submit", submit_with_results)

    kw = tiny_kw(families=("register", "queue", "list-append"))
    over_http = _search_over_http(
        CheckingService(store_root=None, batch_wait=0.0, device="cpu"),
        tmp_path / "h", serve_in_thread, **kw)
    ref_over_http = _search_over_http(
        RefService(store_root=None, batch_wait=0.0), tmp_path / "r",
        ref_serve_in_thread, **kw)
    assert without_clocks(over_http) == without_clocks(ref_over_http)
    assert over_http["corpus"] >= 1 and over_http["unconfirmed"] == 0


# ------------------------------------- the reference's cases, on the port


class TestOperators:
    def test_every_family_has_invalidating_operator(self):
        for family in FAMILIES:
            flipped = False
            for seed in range(6):
                sc = base_scenario(family, seed=seed)
                hist = materialize(sc)
                model, units = build_units([hist], family)
                assert all(
                    check_histories([uh], model, algorithm="cpu",
                                    device="cpu")[0]["valid?"]
                    is VALID for _, uh in units), \
                    f"{family} base seed {seed} must start valid"
                for op in operators_for(family, "history"):
                    if not op.can_invalidate:
                        continue
                    for es in range(12):
                        out = apply_history_op(
                            op, random.Random(f"t:{op.name}:{es}"), hist)
                        if out is None:
                            continue
                        model2, units2 = build_units([out], family)
                        if any(check_histories(
                                [uh], model2, algorithm="cpu",
                                device="cpu")[0]["valid?"] is INVALID
                                for _, uh in units2):
                            flipped = True
                            break
                    if flipped:
                        break
                if flipped:
                    break
            assert flipped, f"no invalidating operator fired for {family}"

    def test_operators_never_break_encode(self):
        for family in FAMILIES:
            sc = base_scenario(family)
            ops = operators_for(family, "history")
            for op in ops:
                for es in range(6):
                    out = apply_history_op(
                        op, random.Random(f"enc:{op.name}:{es}"),
                        materialize(sc))
                    if out is None:
                        continue
                    model, units = build_units([out], family)
                    for _, uh in units:
                        encode_history(uh, model)  # must not raise
            rng = random.Random(f"chain:{family}")
            g = sc
            for _ in range(3):
                op = ops[rng.randrange(len(ops))]
                g = mutate(g, op, rng.randrange(16))
            model, units = build_units([materialize(g)], family)
            for _, uh in units:
                encode_history(uh, model)

    def test_params_operators_stay_in_domain(self):
        sc = base_scenario("register")
        for op in operators_for("register", "params"):
            g = sc
            for es in range(8):
                g = mutate(g, op, es)
            assert 2 <= g.n_procs <= 8
            assert 0.0 < g.crash_p <= 0.6
            assert 2 <= g.value_range <= 8
            assert 0.5 <= g.interval <= 20.0
            materialize(g)

    def test_registry_covers_each_family(self):
        for family in FAMILIES:
            ops = operators_for(family)
            assert any(o.can_invalidate for o in ops), family
            assert any(o.target == "params" for o in ops), family

    def test_crash_injection_is_capped(self):
        sc = base_scenario("register", n_ops=20)
        g = sc
        for es in range(40):
            g = mutate(g, REGISTRY["crash-op"], es)
        hist = materialize(g)
        n_inv = sum(1 for o in hist if o.type == "invoke")
        n_done = sum(1 for o in hist if o.type in ("ok", "fail"))
        assert n_inv - n_done <= 5 + sc.n_procs


class TestCorruptCompat:
    def test_write_arm_mutates(self):
        h = History()
        for i in range(6):
            h.append(Op(process=0, type="invoke", f="write", value=i))
            h.append(Op(process=0, type="ok", f="write", value=i))
        changed = any(rows_of(synth.corrupt(random.Random(s), h))
                      != rows_of(h) for s in range(8))
        assert changed, "corrupt() write arm is a silent no-op"

    def test_list_append_arm_exists(self):
        hist = materialize(base_scenario("list-append"))
        assert family_of(hist) == "list-append"
        assert any([o.value for o in corrupt_once(random.Random(s), hist)]
                   != [o.value for o in hist] for s in range(8))

    def test_family_dispatch(self):
        assert family_of(materialize(base_scenario("queue"))) == "queue"
        assert family_of(materialize(base_scenario("set"))) == "set"
        assert family_of(materialize(base_scenario("counter"))) == "counter"


class TestFitness:
    def test_tier_distance_orders_the_ladder(self):
        assert TIER_DISTANCE["greedy"] < TIER_DISTANCE["backtrack"] \
            < TIER_DISTANCE["cycle"] < TIER_DISTANCE["host"]
        assert TIER_DISTANCE["mask"] == TIER_DISTANCE["dense"] \
            == TIER_DISTANCE["sort"] == TIER_DISTANCE["host"]

    def test_invalid_beats_valid_beats_nothing(self):
        valid = {"decided-tier": "greedy", "valid?": VALID}
        deep = {"decided-tier": "host", "valid?": VALID}
        unk = {"decided-tier": "host", "valid?": UNKNOWN}
        inv = {"decided-tier": "host", "valid?": INVALID,
               "counterexample": {"minimal-op-count": 4}}
        assert score_result_row(valid) < score_result_row(deep) \
            < score_result_row(unk) < score_result_row(inv)

    def test_smaller_witness_scores_higher(self):
        small = {"decided-tier": "host", "valid?": INVALID,
                 "counterexample": {"minimal-op-count": 3}}
        big = {"decided-tier": "host", "valid?": INVALID,
               "counterexample": {"minimal-op-count": 30}}
        assert score_result_row(small) > score_result_row(big)

    def test_annotation_bonuses(self):
        base = {"decided-tier": "cycle", "valid?": VALID}
        assert score_result_row({**base, "sc-refuted": True}) \
            == pytest.approx(score_result_row(base) + 0.5)
        assert score_result_row({**base, "cycle-skipped-size": 12}) \
            == pytest.approx(score_result_row(base) + 0.3)
        late = {**base, "decided-at-segment": 3, "segments": 4}
        early = {**base, "decided-at-segment": 0, "segments": 4}
        assert score_result_row(late) > score_result_row(early)

    def test_txn_overlay_counts_anomaly_classes(self):
        one = {"valid?": INVALID, "histories": [
            {"anomalies": {"G1c": {"cycle": [1, 2]}}}]}
        two = {"valid?": INVALID, "histories": [
            {"anomalies": {"G1c": {"cycle": [1, 2]},
                           "G-single": {"cycle": [3]}}}]}
        assert score_txn(None) == 0.0
        assert 0.0 < score_txn(one) < score_txn(two)

    def test_candidate_mean_not_sum(self):
        row = {"decided-tier": "greedy", "valid?": VALID}
        assert score_candidate([row]) == pytest.approx(
            score_candidate([row, dict(row)]))


class TestCorpus:
    def test_dedup_and_roundtrip(self, tmp_path):
        corpus = Corpus(str(tmp_path / "c"))
        entry = {"fingerprint": "ab" + "0" * 14, "family": "register",
                 "region": ["register", 3], "kind": "lin", "units": []}
        assert corpus.add(entry) is True
        assert corpus.add(dict(entry)) is False
        assert len(corpus) == 1
        assert entry["fingerprint"] in corpus
        again = Corpus(str(tmp_path / "c"))
        assert again.fingerprints() == {entry["fingerprint"]}
        assert again.load(entry["fingerprint"])["family"] == "register"

    def test_entries_are_json_clean(self, tmp_path):
        corpus = Corpus(str(tmp_path / "c"))
        corpus.add({"fingerprint": "cd" + "1" * 14, "kind": "lin",
                    "units": [{"ops": [{"value": (1, 2)}]}]})
        for e in corpus.entries():
            json.dumps(e)

    def test_reverify_runs_on_the_host_without_a_card(self, monkeypatch,
                                                      both_runs):
        """Corpus replay is the host's by design: with no card visible,
        every archived entry still re-verifies (no device is asked)."""
        _, _, port_dir, _ = both_runs["guided"]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        entries = corpus_entries(port_dir)
        assert entries
        assert all(port_corpus.reverify_entry(e) for e in entries)


class TestDriver:
    def test_seed_determinism_identical_corpus(self, tmp_path, service):
        reports = []
        for rep in range(2):
            cfg = tiny_config(tmp_path / f"rep{rep}")
            reports.append(SearchDriver(cfg, service=service).run())
        assert reports[0]["corpus-fingerprints"] == \
            reports[1]["corpus-fingerprints"]
        assert reports[0]["candidates"] == reports[1]["candidates"]
        assert reports[0]["corpus"] >= 1

    def test_archive_minimizes_and_reverifies(self, tmp_path, service):
        driver = SearchDriver(tiny_config(tmp_path), service=service)
        rep = driver.run()
        assert rep["unconfirmed"] == 0
        n = 0
        for entry in driver.corpus.entries():
            assert reverify_entry(entry)
            for unit in entry.get("units", []):
                n += 1
                assert unit["minimized"] is True
                assert unit["ops"]
        assert n >= 1

    def test_guided_vs_random_smoke(self, tmp_path, service):
        g = SearchDriver(tiny_config(tmp_path / "g", guided=True),
                         service=service).run()
        r = SearchDriver(tiny_config(tmp_path / "r", guided=False),
                         service=service).run()
        assert g["arm"] == "guided" and r["arm"] == "random"
        assert g["corpus"] >= 1
        assert r["found-regions"] == []
        for rep in (g, r):
            assert rep["per-generation"], rep["arm"]
            for gen in rep["per-generation"]:
                assert gen["candidates"] <= tiny_config(tmp_path).population

    def test_recall_finds_planted_violation(self, tmp_path, service):
        cfg = tiny_config(tmp_path, families=("register", "set", "queue"),
                          population=24, generations=4, survivors=8,
                          edit_space=12, n_ops=12)
        plants = plant_violations(cfg, 3)
        assert len(plants) == 3
        assert {p.base.family for p in plants} == {"register", "set",
                                                   "queue"}
        for p in plants:
            name, es = p.edit
            assert name in REGISTRY and 0 <= es < cfg.edit_space
        report = run_recall(cfg, plants=plants, service=service)
        assert report.planted == 3
        assert len(report.found) >= 1, report.to_dict()
        assert report.recall == pytest.approx(len(report.found) / 3)
        assert report.cpu_s > 0 and report.recall_per_cpu_min >= 0

    def test_run_pins_autotune_off_and_restores_it(self, tmp_path, service,
                                                   monkeypatch):
        monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
        seen = []
        real = service.submit

        def spy(*a, **kw):
            seen.append(os.environ.get("JGRAFT_AUTOTUNE"))
            return real(*a, **kw)

        monkeypatch.setattr(service, "submit", spy)
        SearchDriver(tiny_config(tmp_path), service=service).run()
        assert seen and set(seen) == {"0"}
        assert os.environ["JGRAFT_AUTOTUNE"] == "1"


def test_schedule_pressure_deterministic():
    assert schedule_pressure("none", 5.0) == {"crash_bias": 0.0,
                                              "crash_burst": 0}
    p = schedule_pressure("kill,partition", 5.0)
    assert p == schedule_pressure("kill,partition", 5.0)
    assert 0.0 < p["crash_bias"] <= 0.4
    assert p["crash_burst"] == 2
    assert schedule_pressure("all", 0.5)["crash_bias"] == 0.4
    assert schedule_pressure("kill", 20.0)["crash_bias"] < \
        schedule_pressure("kill", 1.0)["crash_bias"]


def test_scenario_fingerprint_stable_and_content_addressed():
    a = base_scenario("register")
    assert scenario_fingerprint(a) == scenario_fingerprint(a)
    b = base_scenario("register", seed=4)
    assert scenario_fingerprint(a) != scenario_fingerprint(b)
    edited = mutate(a, REGISTRY["perturb-read"], 0)
    assert edited.edits == (("perturb-read", 0),)
    assert scenario_fingerprint(edited) != scenario_fingerprint(a)


def test_scenario_roundtrips_through_dict():
    sc = mutate(base_scenario("queue"), REGISTRY["perturb-ticket"], 5)
    assert Scenario.from_dict(sc.to_dict()) == sc


def test_search_config_from_env_reads_the_references_knobs(monkeypatch):
    for name, value in (("JGRAFT_SEARCH_POP", "20"),
                        ("JGRAFT_SEARCH_GENERATIONS", "3"),
                        ("JGRAFT_SEARCH_SURVIVORS", "5"),
                        ("JGRAFT_SEARCH_EDIT_SPACE", "9"),
                        ("JGRAFT_SEARCH_SEED", "4"),
                        ("JGRAFT_SEARCH_GUIDED", "0"),
                        ("JGRAFT_SEARCH_DIR", "/nowhere")):
        monkeypatch.setenv(name, value)
    cfg = port_driver.search_config_from_env(n_ops=12)
    ref = ref_search.driver.search_config_from_env(n_ops=12)
    assert {k: getattr(cfg, k) for k in vars(ref)} == vars(ref)
    assert cfg.device is None
    assert fitness.INVALID_BONUS == ref_fitness.INVALID_BONUS
