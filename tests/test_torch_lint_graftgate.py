"""graftgate (verdict-integrity dataflow tier) on the port.

The JAX package's ``tests/test_lint_graftgate.py``, case for case, on
the port's lint and sources: every rule is proven to FIRE on a seeded
violation and to stay QUIET on the shipped tree with an EMPTY baseline;
each rule gets a MUTATION test against the port's real sources — stop
hashing ``proc`` in the port's ``fingerprint_encodings``, drop the
daemon's degraded-cache guard, cut the ResultStore's degraded self-gate,
drift one copy of the duplicated commit rules, un-stamp the distributed
demux stub. Plus the pragmas restored on the port's ``EncodedHistory``
(load-bearing: strip them and 39 reads fire), the knob-class registry
columns over the port's knobs, and the SARIF / --timing CLI workflow.
CPU-only; the analyzers import neither jax nor torch.
"""

import json
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.lint import cli, report
from jepsen_jgroups_raft_tpu_torch.lint.base import SourceFile
from test_torch_lint_twins import twin_of

# the copied analyzers, each call held to the JAX package's on the same
# input (test_torch_lint_twins.py)
degraded = twin_of("degraded")
envknobs = twin_of("envknobs")
fingerprint = twin_of("fingerprint")
knobclass = twin_of("knobclass")
lockstep = twin_of("lockstep")
tierstamp = twin_of("tierstamp")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "jepsen_jgroups_raft_tpu_torch"

GRAFTGATE = ("fingerprint", "degraded", "knobclass", "tierstamp",
             "lockstep")


def rules_of(findings):
    return {f.rule for f in findings}


def src_of(text, path="mod.py"):
    return SourceFile.from_text(path, text)


def real(rel):
    return (PKG / rel).read_text()


@pytest.fixture(scope="module")
def repo_findings():
    """Every analyzer over the port and native/src, once for the
    module."""
    return cli.run([str(PKG), str(REPO / "native" / "src")],
                   list(cli.ANALYZERS))


def _surface(rels, overrides):
    out = {rel: SourceFile.load(PKG / rel) for rel in rels}
    for rel, text in overrides.items():
        out[rel] = src_of(text, rel)
    return out


def fp_surface(overrides):
    """The real fingerprint-completeness surface, with text overrides
    keyed by pkg-relative path."""
    return _surface((fingerprint.PACKING, fingerprint.ANCHOR)
                    + fingerprint.SCAN, overrides)


def degraded_surface(overrides):
    return _surface(degraded.SCAN, overrides)


def tier_surface(overrides):
    return _surface(tierstamp.SCAN, overrides)


# -------------------------------------------------- fingerprint (rule a)


PACK_FIX = (
    "from dataclasses import dataclass\n"
    "from typing import Optional\n"
    "@dataclass\n"
    "class EncodedHistory:\n"
    "    events: object\n"
    "    proc: Optional[object] = None\n")

#: hashes events always, proc never
REQ_ALWAYS_ONLY = (
    "def fingerprint_encodings(model, algorithm, encs,\n"
    "                          consistency='linearizable'):\n"
    "    h = new_hash()\n"
    "    for e in encs:\n"
    "        h.update(e.events)\n"
    "    return h.hexdigest()\n")

#: rung-conditional hashing — the fixture that must pass
REQ_RUNG = (
    "def fingerprint_encodings(model, algorithm, encs,\n"
    "                          consistency='linearizable'):\n"
    "    h = new_hash()\n"
    "    weak = consistency != 'linearizable'\n"
    "    for e in encs:\n"
    "        h.update(e.events)\n"
    "        if weak:\n"
    "            h.update(e.proc)\n"
    "    return h.hexdigest()\n")

SCAN_WEAK_READ = (
    "def relax(enc, consistency):\n"
    "    if consistency != 'linearizable':\n"
    "        return enc.proc\n"
    "    return None\n")

SCAN_BARE_READ = (
    "def relax(enc):\n"
    "    return enc.proc\n")


class TestFingerprint:
    def test_rung_conditional_hash_fixture_passes(self):
        f = fingerprint.analyze_sources(fp_surface(
            {"history/packing.py": PACK_FIX,
             "service/request.py": REQ_RUNG,
             "checker/cycle.py": SCAN_WEAK_READ}))
        assert not f, f

    def test_unhashed_field_read_fires(self):
        f = fingerprint.analyze_sources(fp_surface(
            {"history/packing.py": PACK_FIX,
             "service/request.py": REQ_ALWAYS_ONLY,
             "checker/cycle.py": SCAN_WEAK_READ}))
        assert fingerprint.RULE_UNHASHED in rules_of(f)

    def test_weak_hashed_bare_read_fires_rung_mismatch(self):
        f = fingerprint.analyze_sources(fp_surface(
            {"history/packing.py": PACK_FIX,
             "service/request.py": REQ_RUNG,
             "checker/cycle.py": SCAN_BARE_READ}))
        assert fingerprint.RULE_RUNG in rules_of(f)

    def test_weak_callee_fixpoint_discharges_the_read(self):
        # the read sits in a helper whose only call site is weak-guarded
        helper = (
            "def helper(enc):\n"
            "    return enc.proc\n"
            "def outer(enc, consistency):\n"
            "    if consistency != 'linearizable':\n"
            "        return helper(enc)\n"
            "    return None\n")
        f = fingerprint.analyze_sources(fp_surface(
            {"history/packing.py": PACK_FIX,
             "service/request.py": REQ_RUNG,
             "checker/cycle.py": helper}))
        assert not f, f

    def test_anchor_drift_is_loud(self):
        f = fingerprint.analyze_sources(fp_surface(
            {"service/request.py": "def other():\n    pass\n"}))
        assert f and "fingerprint_encodings" in f[0].message

    def test_shipped_surface_is_clean(self):
        assert not fingerprint.analyze_file(PKG / fingerprint.ANCHOR)

    def test_mutation_proc_hash_dropped_fires_on_real_sources(self):
        # fingerprint_encodings stops hashing proc entirely — every
        # weak-relaxation proc read on the port's verdict surface must
        # fire
        text = real("service/request.py")
        block = (
            "        if weak:\n"
            '            h.update(b"\\x01" if e.proc is not None'
            ' else b"\\x00")\n'
            "            if e.proc is not None:\n"
            "                h.update(memoryview(np.ascontiguousarray(\n"
            "                    np.asarray(e.proc, dtype=np.int32))))\n")
        assert block in text
        f = fingerprint.analyze_sources(fp_surface(
            {"service/request.py": text.replace(block, "")}))
        assert fingerprint.RULE_UNHASHED in rules_of(f)
        paths = {x.path for x in f}
        assert any(p.endswith("checker/consistency.py") for p in paths)
        assert any(p.endswith("checker/cycle.py") for p in paths)

    def test_packing_pragmas_are_load_bearing(self):
        # op_index / n_ops / n_events are exempt only because their
        # declarations carry a reasoned fp-irrelevant pragma
        text = real("history/packing.py")
        assert "# lint: allow(fp-irrelevant)" in text
        stripped = text.replace("# lint: allow(fp-irrelevant)", "#")
        f = fingerprint.analyze_sources(fp_surface(
            {"history/packing.py": stripped}))
        assert fingerprint.RULE_UNHASHED in rules_of(f)
        fields = " ".join(x.message for x in f)
        assert "n_ops" in fields and "n_events" in fields
        # the three pragmas clear every read the verdict paths make
        assert len(f) >= 39


# ----------------------------------------------------- degraded (rule b)


class TestDegraded:
    def test_unguarded_cache_put_fires(self):
        f = degraded.analyze_sources({"service/daemon.py": src_of(
            "def account(self, req, results):\n"
            "    self.cache.put(req.fingerprint, results)\n",
            "service/daemon.py")})
        assert rules_of(f) == {degraded.RULE}

    def test_clean_guard_dominating_is_quiet(self):
        f = degraded.analyze_sources({"service/daemon.py": src_of(
            "def account(self, req, results):\n"
            "    if not any('platform-degraded' in r for r in results):\n"
            "        self.cache.put(req.fingerprint, results)\n",
            "service/daemon.py")})
        assert not f, f

    def test_early_return_guard_is_quiet(self):
        f = degraded.analyze_sources({"service/daemon.py": src_of(
            "def account(self, req, results):\n"
            "    if is_degraded(results):\n"
            "        return\n"
            "    self.cache.put(req.fingerprint, results)\n",
            "service/daemon.py")})
        assert not f, f

    def test_store_readback_is_a_clean_source(self):
        f = degraded.analyze_sources({"service/daemon.py": src_of(
            "def warm(self, req):\n"
            "    stored = self.cluster.store.get(req.fingerprint)\n"
            "    self.cache.put(req.fingerprint, stored)\n",
            "service/daemon.py")})
        assert not f, f

    def test_journal_results_field_needs_guard(self):
        hot = degraded.analyze_sources({"service/journal.py": src_of(
            "def encode(rec, results):\n"
            "    rec['results'] = results\n"
            "    return rec\n", "service/journal.py")})
        assert rules_of(hot) == {degraded.RULE}
        cold = degraded.analyze_sources({"service/journal.py": src_of(
            "def encode(rec, results):\n"
            "    if results is not None and not any(\n"
            "            'platform-degraded' in r for r in results):\n"
            "        rec['results'] = results\n"
            "    return rec\n", "service/journal.py")})
        assert not cold, cold

    def test_shipped_tier_is_clean(self):
        assert not degraded.analyze_file(PKG / degraded.ANCHOR)

    def test_mutation_dropped_guard_fires_on_real_daemon(self):
        # drop _account_requests' never-persist guard: the LRU warm of
        # fresh verdicts goes unguarded
        text = real("service/daemon.py")
        guard = (
            '                if not r.stats.get("degraded") and not any(\n'
            '                        "platform-degraded" in res'
            ' for res in r.results):\n')
        assert guard in text
        f = degraded.analyze_sources(degraded_surface(
            {"service/daemon.py":
             text.replace(guard, "                if True:\n")}))
        assert degraded.RULE in rules_of(f)
        assert any("LRU cache put" in x.message for x in f)

    def test_mutation_cut_store_gate_fires_gate_and_leaning_sites(self):
        # delete ResultStore's own degraded gates: the store's raw
        # publishes fire AND the distributed detail-exchange call site
        # that leaned on the put_detail gate fires with them
        text = real("service/store.py")
        for gate in ("        if is_degraded(results):\n"
                     "            return False\n",
                     "        if is_degraded([result]):\n"
                     "            return False\n"):
            assert gate in text
            text = text.replace(gate, "")
        f = degraded.analyze_sources(degraded_surface(
            {"service/store.py": text}))
        paths = {x.path for x in f if x.rule == degraded.RULE}
        assert any(p.endswith("service/store.py") for p in paths), f
        assert any(p.endswith("parallel/distributed.py")
                   for p in paths), f

    def test_daemon_replay_pragma_is_load_bearing(self):
        text = real("service/daemon.py")
        assert "# lint: allow(degraded)" in text
        f = degraded.analyze_sources(degraded_surface(
            {"service/daemon.py":
             text.replace("  # lint: allow(degraded)", "")}))
        assert rules_of(f) == {degraded.RULE}


# ---------------------------------------------------- knobclass (rule c)


class TestKnobClass:
    def test_unclassified_knob_fires(self):
        f = knobclass.analyze_sources({"mod.py": src_of(
            "N = env_int('JGRAFT_BRAND_NEW_KNOB', 1)\n")})
        assert knobclass.RULE_UNCLASS in rules_of(f)

    def test_routing_knob_local_into_verdict_fires(self):
        f = knobclass.analyze_sources({"mod.py": src_of(
            "def check(n):\n"
            "    thr = env_int('JGRAFT_SCAN_CHUNK', 512)\n"
            "    return {'valid?': n < thr}\n")})
        assert knobclass.RULE_VERDICT in rules_of(f)

    def test_accessor_function_conduit_fires(self):
        f = knobclass.analyze_sources({"mod.py": src_of(
            "def scan_chunk():\n"
            "    return env_int('JGRAFT_SCAN_CHUNK', 512)\n"
            "def check(n):\n"
            "    return {'valid?': n < scan_chunk()}\n")})
        assert knobclass.RULE_VERDICT in rules_of(f)

    def test_module_constant_conduit_fires_cross_module(self):
        f = knobclass.analyze_sources({
            "a.py": src_of("CHUNK = env_int('JGRAFT_SCAN_CHUNK', 512)\n",
                           "a.py"),
            "b.py": src_of("from a import CHUNK\n"
                           "def check(n):\n"
                           "    d = {}\n"
                           "    d['valid?'] = n < CHUNK\n"
                           "    return d\n", "b.py")})
        assert knobclass.RULE_VERDICT in rules_of(f)

    def test_control_dependence_is_not_taint(self):
        # engine choice IS what routing knobs are for
        f = knobclass.analyze_sources({"mod.py": src_of(
            "def check(h):\n"
            "    if env_int('JGRAFT_LIN_FASTPATH', 1):\n"
            "        return {'valid?': fast(h), 'decided-tier': 'greedy'}\n"
            "    return {'valid?': slow(h), 'decided-tier': 'dense'}\n")})
        assert not f, f

    def test_method_calls_do_not_conflate_with_accessors(self):
        # regression for the taint-explosion fix: r.chunk() must not
        # inherit the bare accessor chunk()'s taint by name
        f = knobclass.analyze_sources({"mod.py": src_of(
            "def chunk():\n"
            "    return env_int('JGRAFT_SCAN_CHUNK', 512)\n"
            "def check(r):\n"
            "    return {'valid?': r.chunk()}\n")})
        assert not f, f

    def test_nonrouting_knob_exempt_but_verdict_taint_sees_it(self):
        src = {"mod.py": src_of(
            "def check(n):\n"
            "    thr = env_int('JGRAFT_SERVICE_WORKERS', 4)\n"
            "    return {'valid?': n < thr}\n")}
        assert not knobclass.analyze_sources(src)  # ops class: no rule
        assert knobclass.verdict_taint(src) == \
            {"JGRAFT_SERVICE_WORKERS": True}

    def test_pragma_is_load_bearing(self):
        text = ("def check(n):\n"
                "    thr = env_int('JGRAFT_SCAN_CHUNK', 512)\n"
                "    return {'valid?': n < thr"
                "}  # lint: allow(knob-verdict)\n")
        assert not knobclass.analyze_sources({"mod.py": src_of(text)})
        stripped = text.replace("  # lint: allow(knob-verdict)", "")
        f = knobclass.analyze_sources({"mod.py": src_of(stripped)})
        assert knobclass.RULE_VERDICT in rules_of(f)

    def test_semantic_class_is_empty(self):
        # the routing contract in writing: adding a semantic knob is a
        # reviewed decision, not a default
        assert knobclass.SEMANTIC not in set(knobclass.KNOB_CLASS.values())

    def test_shipped_package_is_clean(self):
        assert not knobclass.analyze_file(PKG / "platform.py")

    def test_registry_class_columns(self):
        registry, findings = envknobs.build_registry(REPO)
        assert not findings, findings
        knobs = registry["knobs"]
        assert registry["version"] == 2
        classes = {k: v["class"] for k, v in knobs.items()}
        assert "unclassified" not in set(classes.values()), classes
        assert classes["JGRAFT_SCAN_CHUNK"] == knobclass.ROUTING
        assert classes["JGRAFT_SERVICE_JOURNAL"] == knobclass.DURABILITY
        assert classes["JGRAFT_SERVICE_WORKERS"] == knobclass.OPS
        # the table covers exactly the knobs the port reads
        assert set(classes) == set(knobclass.KNOB_CLASS)
        assert not any(v["verdict_reachable"] for v in knobs.values()), \
            [k for k, v in knobs.items() if v["verdict_reachable"]]


# ---------------------------------------------------- tierstamp (rule d)


def _tier_fix(body):
    return tierstamp.analyze_sources({"service/scheduler.py": src_of(
        body, "service/scheduler.py")})


class TestTierStamp:
    def test_unstamped_literal_fires(self):
        f = _tier_fix("def f(ok):\n"
                      "    return {'valid?': ok}\n")
        assert rules_of(f) == {tierstamp.RULE}

    def test_inline_tier_key_is_quiet(self):
        assert not _tier_fix(
            "def f(ok):\n"
            "    return {'valid?': ok, 'decided-tier': 'greedy'}\n")

    def test_error_record_is_exempt(self):
        assert not _tier_fix(
            "def f(exc):\n"
            "    return {'valid?': None, 'error': str(exc)}\n")

    def test_results_envelope_is_exempt(self):
        assert not _tier_fix(
            "def f(ok, rows):\n"
            "    return {'valid?': ok, 'results': rows}\n")

    def test_stamp_on_all_paths_is_quiet(self):
        assert not _tier_fix(
            "def f(ok, tier):\n"
            "    d = {'valid?': ok}\n"
            "    d['decided-tier'] = tier\n"
            "    return d\n")

    def test_stamp_missing_on_one_branch_fires(self):
        f = _tier_fix("def f(ok, fast):\n"
                      "    d = {'valid?': ok}\n"
                      "    if fast:\n"
                      "        d['decided-tier'] = 'greedy'\n"
                      "    return d\n")
        assert rules_of(f) == {tierstamp.RULE}

    def test_raise_path_is_exempt(self):
        assert not _tier_fix(
            "def f(ok, fast):\n"
            "    d = {'valid?': ok}\n"
            "    if not fast:\n"
            "        raise RuntimeError('no tier decided')\n"
            "    d['decided-tier'] = 'greedy'\n"
            "    return d\n")

    def test_pragma_is_load_bearing(self):
        text = ("def f(ok):\n"
                "    return {'valid?': ok}  # lint: allow(no-tier)\n")
        assert not _tier_fix(text)
        f = _tier_fix(text.replace("  # lint: allow(no-tier)", ""))
        assert rules_of(f) == {tierstamp.RULE}

    def test_shipped_surface_is_clean(self):
        assert not tierstamp.analyze_file(PKG / tierstamp.ANCHOR)

    def test_mutation_unstamped_remote_stub_fires_on_real_demux(self):
        # the remote-shard stub must stamp its tier: without it a
        # wire-exact verdict carries no attribution
        text = real("parallel/distributed.py")
        stamp = '\n            "decided-tier": "remote-shard"}'
        assert stamp in text
        f = tierstamp.analyze_sources(tier_surface(
            {"parallel/distributed.py": text.replace(stamp, "}")}))
        assert tierstamp.RULE in rules_of(f)
        assert all(x.path.endswith("parallel/distributed.py")
                   for x in f), f


# ------------------------------------------------- lockstep (satellite 2)


CONS = PKG / "checker" / "consistency.py"


class TestLockstep:
    def test_shipped_certifiers_are_in_lockstep(self):
        assert not lockstep.analyze_file(CONS)

    def test_non_anchor_file_is_quiet(self):
        # the CLI analyzes explicit file args with every analyzer; the
        # anchored rule must not report missing twins there — not even
        # in chip_smoke.py, which names StreamingCertifier without
        # defining it
        assert "StreamingCertifier" in (REPO / "chip_smoke.py").read_text()
        assert not lockstep.analyze_file(REPO / "chip_smoke.py")

    def test_mutation_sort_key_drift_fires(self):
        text = CONS.read_text()
        key = "out.sort(key=lambda t: t[:4])"
        assert text.count(key) == 2
        mutated = text.replace(key, "out.sort(key=lambda t: t[:3])", 1)
        f = lockstep.analyze_source(
            src_of(mutated, "checker/consistency.py"))
        assert rules_of(f) == {lockstep.RULE_DRIFT}
        assert any("candidates" in x.message for x in f)

    def test_mutation_commit_row_drift_fires(self):
        text = CONS.read_text()
        row = "out.append((-1, 0, 0, -1, None))"
        assert text.count(row) == 2
        mutated = text.replace(row, "out.append((-1, 0, 0, 0, None))", 1)
        f = lockstep.analyze_source(
            src_of(mutated, "checker/consistency.py"))
        assert lockstep.RULE_DRIFT in rules_of(f)

    def test_mutation_dropped_element_fires_count_drift(self):
        text = CONS.read_text()
        key = "out.sort(key=lambda t: t[:4])"
        lines = text.splitlines(keepends=True)
        # drop only the streaming copy's sort line
        for i in reversed(range(len(lines))):
            if key in lines[i]:
                del lines[i]
                break
        f = lockstep.analyze_source(
            src_of("".join(lines), "checker/consistency.py"))
        assert lockstep.RULE_DRIFT in rules_of(f)

    def test_missing_twin_is_loud_anchor(self):
        f = lockstep.analyze_source(src_of(
            "def certify_encoded(model, encs):\n"
            "    return []\n", "checker/consistency.py"))
        assert rules_of(f) == {lockstep.RULE_ANCHOR}


# ------------------------------------------------------ CLI workflow


class TestCliGraftgate:
    def test_rules_registered_with_verdict_integrity_help(self):
        listed = {r for rules in cli.RULES.values() for r in rules}
        for rule in (fingerprint.RULE_UNHASHED, fingerprint.RULE_RUNG,
                     degraded.RULE, knobclass.RULE_UNCLASS,
                     knobclass.RULE_VERDICT, tierstamp.RULE,
                     lockstep.RULE_DRIFT, lockstep.RULE_ANCHOR):
            assert rule in listed, rule
            assert cli.RULE_HELP[rule].endswith("-verdict-integrity"), rule

    def test_sarif_help_uris_point_at_verdict_integrity(self):
        rule_ids = [r for a in GRAFTGATE for r in cli.RULES[a]]
        sarif = report.to_sarif([], [], rule_ids,
                                rule_help=cli.RULE_HELP)
        rules = sarif["runs"][0]["tool"]["driver"]["rules"]
        assert rules
        for r in rules:
            assert r["helpUri"].startswith("README.md#graftlint-on-the-port")
            assert "verdict-integrity" in r["helpUri"], r

    def test_repo_clean_under_all_graftgate_rules(self, repo_findings):
        gate = {r for a in GRAFTGATE for r in cli.RULES[a]}
        findings = [f for f in repo_findings if f.rule in gate]
        assert not findings, findings
        # chip_smoke.py, given explicitly, is clean under them too
        assert not cli.run([str(REPO / "chip_smoke.py")], ["lockstep",
                                                           "tierstamp"])

    def test_repo_clean_under_all_fifteen_analyzers(self, repo_findings):
        assert len(cli.ANALYZERS) == 15
        assert not repo_findings, repo_findings

    def test_shipped_baseline_is_empty(self):
        base = json.loads((PKG / "lint" / "baseline.json").read_text())
        assert base["findings"] == []

    def test_timing_flag_emits_per_analyzer_walls(self, capsys):
        rc = cli.main(["--rules", "lockstep,tierstamp", "--timing",
                       str(CONS)])
        err = capsys.readouterr().err
        assert rc == 0
        assert "lint-timing: lockstep" in err
        assert "lint-timing: tierstamp" in err
        assert "lint-timing: total" in err
