"""graftsync (lint/flow concurrency + crash-consistency tier) on the
port.

The JAX package's ``tests/test_lint_graftsync.py``, case for case, on
the port's lint and the port's service sources: every rule is proven to
FIRE on a seeded violation and to stay QUIET on the shipped tree; each
rule gets a MUTATION test against the port's real service sources
(demote a guarded access out of its ``with``, move a compact() call
inside the journal lock, drop an fsync, drop the atomic-replace publish,
revert a knob parse to raw float()). Plus lock-region CFG fixtures,
pragma load-bearing checks, the port's env_str/env_float knob parsing,
and the --knob-registry / SARIF helpUri CLI workflow. CPU-only; the
analyzers import neither jax nor torch.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.lint import cli, report
from jepsen_jgroups_raft_tpu_torch.lint.base import SourceFile
from jepsen_jgroups_raft_tpu_torch.lint.flow.cfg import cfg_for
from jepsen_jgroups_raft_tpu_torch.lint.flow.locks import lock_regions
from jepsen_jgroups_raft_tpu_torch.platform import env_str
from test_torch_lint_twins import twin_of

# the copied analyzers, each call held to the JAX package's on the same
# input (test_torch_lint_twins.py)
crashproto = twin_of("crashproto")
envknobs = twin_of("envknobs")
guarded = twin_of("guarded")
lockorder = twin_of("lockorder")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "jepsen_jgroups_raft_tpu_torch"
SERVICE = PKG / "service"


@pytest.fixture(scope="module")
def repo_findings():
    """Every analyzer over the port and native/src, once for the
    module."""
    return cli.run([str(PKG), str(REPO / "native" / "src")],
                   list(cli.ANALYZERS))


def rules_of(findings):
    return {f.rule for f in findings}


def src_of(text, path="service/mod.py"):
    return SourceFile.from_text(path, text)


def held_lines(source, func):
    """line -> set of held lock names, unioned over the CFG nodes."""
    g = cfg_for(source, func)
    held = lock_regions(g)
    out = {}
    for n in g.nodes:
        if n.line is not None:
            out.setdefault(n.line, set()).update(held[n.idx])
    return out


# ------------------------------------------------------- lock regions


class TestLockRegions:
    def test_with_lock_region_covers_body_not_tail(self):
        h = held_lines(
            "def f(self):\n"
            "    with self._lock:\n"
            "        touch(self)\n"      # line 3
            "    after(self)\n", "f")    # line 4
        assert "self._lock" in h[3]
        assert "self._lock" not in h[4]

    def test_try_finally_inside_with_stays_held(self):
        h = held_lines(
            "def f(self):\n"
            "    with self._lock:\n"
            "        try:\n"
            "            risky(self)\n"       # line 4
            "        finally:\n"
            "            cleanup(self)\n"     # line 6
            "    after(self)\n", "f")         # line 7
        assert "self._lock" in h[4]
        assert "self._lock" in h[6]
        assert "self._lock" not in h[7]

    def test_early_return_does_not_leak_region(self):
        h = held_lines(
            "def f(self):\n"
            "    with self._lock:\n"
            "        if self.done:\n"
            "            return None\n"
            "        work(self)\n"        # line 5
            "    after(self)\n", "f")     # line 6
        assert "self._lock" in h[5]
        assert "self._lock" not in h[6]

    def test_exception_path_ends_region_at_exit_marker(self):
        # the handler runs AFTER __exit__ released the lock
        h = held_lines(
            "def f(self):\n"
            "    try:\n"
            "        with self._lock:\n"
            "            risky(self)\n"       # line 4
            "    except ValueError:\n"
            "        handle(self)\n", "f")    # line 6
        assert "self._lock" in h[4]
        assert "self._lock" not in h[6]

    def test_nested_locks_accumulate(self):
        h = held_lines(
            "def f(self):\n"
            "    with self._lock:\n"
            "        with self._gcond:\n"
            "            both(self)\n"        # line 4
            "        one(self)\n", "f")       # line 5
        assert {"self._lock", "self._gcond"} <= h[4]
        assert "self._gcond" not in h[5]


# ------------------------------------------------------------ guarded


GUARDED_FIXTURE = (
    "import threading\n"
    "\n"
    "class Reg:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self._entries = {{}}  # guarded_by(_lock)\n"
    "\n"
    "    def touch(self):\n"
    "{body}")


class TestGuarded:
    def test_unguarded_write_fires(self):
        f = guarded.analyze_source(src_of(GUARDED_FIXTURE.format(
            body="        self._entries['k'] = 1\n")))
        assert rules_of(f) == {guarded.RULE}

    def test_with_lock_is_quiet(self):
        f = guarded.analyze_source(src_of(GUARDED_FIXTURE.format(
            body="        with self._lock:\n"
                 "            self._entries['k'] = 1\n")))
        assert not f

    def test_requires_comment_satisfies(self):
        text = GUARDED_FIXTURE.format(
            body="        self._entries['k'] = 1\n").replace(
            "def touch(self):", "def touch(self):  # requires(_lock)")
        assert not guarded.analyze_source(src_of(text))

    def test_pragma_is_load_bearing(self):
        text = GUARDED_FIXTURE.format(
            body="        return len(self._entries)"
                 "  # lint: allow(unguarded)\n")
        assert not guarded.analyze_source(src_of(text))
        stripped = text.replace("  # lint: allow(unguarded)", "")
        assert rules_of(guarded.analyze_source(src_of(stripped))) == \
            {guarded.RULE}

    def test_init_is_exempt(self):
        text = (
            "import threading\n"
            "class Reg:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._entries = {}  # guarded_by(_lock)\n"
            "        self._entries['seed'] = 1\n")
        assert not guarded.analyze_source(src_of(text))

    def test_cross_object_access_fires_and_lock_satisfies(self):
        base = (
            "import threading\n"
            "class Reg:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._entries = {{}}  # guarded_by(_lock)\n"
            "def peek(reg):\n"
            "{body}")
        hot = base.format(body="    return reg._entries.get('k')\n")
        assert rules_of(guarded.analyze_source(src_of(hot))) == \
            {guarded.RULE}
        cold = base.format(
            body="    with reg._lock:\n"
                 "        return reg._entries.get('k')\n")
        assert not guarded.analyze_source(src_of(cold))

    def test_shipped_service_tier_clean(self):
        for mod in ("daemon.py", "journal.py", "stream.py",
                    "admission.py", "scheduler.py", "store.py"):
            f = guarded.analyze_file(SERVICE / mod)
            assert not f, (mod, f)

    def test_mutation_demoted_lock_fires_on_real_daemon(self):
        # drop every CheckingService critical section: its annotated
        # registries (_requests, _stats, ...) are now touched bare
        text = (SERVICE / "daemon.py").read_text()
        assert "with self._lock:" in text
        mutated = text.replace("with self._lock:",
                               "if True:  # lock dropped")
        f = guarded.analyze_source(src_of(mutated, "service/daemon.py"))
        assert guarded.RULE in rules_of(f)
        assert len(f) > 3  # a whole tier of registries went bare

    def test_stream_pragmas_are_load_bearing(self):
        text = (SERVICE / "stream.py").read_text()
        assert "# lint: allow(unguarded)" in text
        stripped = text.replace("  # lint: allow(unguarded)", "")
        f = guarded.analyze_source(src_of(stripped, "service/stream.py"))
        assert rules_of(f) == {guarded.RULE}


# ---------------------------------------------------------- lockorder


CYCLE_FIXTURE = (
    "import threading\n"
    "class A:\n"
    "    def __init__(self):\n"
    "        self.a_lock = threading.Lock()\n"
    "        self.peer = B()\n"
    "    def fwd(self):\n"
    "        with self.a_lock:\n"
    "            self.peer.back(self)\n"
    "class B:\n"
    "    def __init__(self):\n"
    "        self.b_lock = threading.Lock()\n"
    "    def back(self, other: 'A'):\n"
    "        with self.b_lock:\n"
    "            other.poke()\n")


class TestLockOrder:
    def test_two_lock_cycle_fires(self):
        text = CYCLE_FIXTURE.replace(
            "            other.poke()\n",
            "            with other.a_lock:\n"
            "                pass\n")
        f = lockorder.analyze_sources(
            {"mod.py": src_of(text, "service/mod.py")},
            hierarchy=None)
        assert lockorder.RULE_CYCLE in rules_of(f)

    def test_consistent_order_is_quiet(self):
        f = lockorder.analyze_sources(
            {"mod.py": src_of(CYCLE_FIXTURE, "service/mod.py")},
            hierarchy=["A.a_lock", "B.b_lock"])
        assert not f

    def test_inverted_hierarchy_pair_fires_order(self):
        # the code acquires a_lock -> b_lock; pin the OPPOSITE order
        f = lockorder.analyze_sources(
            {"mod.py": src_of(CYCLE_FIXTURE, "service/mod.py")},
            hierarchy=["B.b_lock", "A.a_lock"])
        assert lockorder.RULE_ORDER in rules_of(f)

    def test_declared_but_unranked_lock_fires_rank(self):
        f = lockorder.analyze_sources(
            {"mod.py": src_of(CYCLE_FIXTURE, "service/mod.py")},
            hierarchy=["A.a_lock"])
        assert lockorder.RULE_RANK in rules_of(f)

    def test_nonreentrant_self_acquire_fires(self):
        text = (
            "import threading\n"
            "class J:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "    def inner(self):\n"
            "        with self._lock:\n"
            "            pass\n"
            "    def outer(self):\n"
            "        with self._lock:\n"
            "            self.inner()\n")
        f = lockorder.analyze_sources(
            {"mod.py": src_of(text, "service/mod.py")}, hierarchy=None)
        assert lockorder.RULE_CYCLE in rules_of(f)

    def test_rlock_self_acquire_is_quiet(self):
        text = (
            "import threading\n"
            "class J:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.RLock()\n"
            "    def inner(self):\n"
            "        with self._lock:\n"
            "            pass\n"
            "    def outer(self):\n"
            "        with self._lock:\n"
            "            self.inner()\n")
        f = lockorder.analyze_sources(
            {"mod.py": src_of(text, "service/mod.py")}, hierarchy=None)
        assert lockorder.RULE_CYCLE not in rules_of(f)

    def test_shipped_service_tier_clean(self):
        assert not lockorder.analyze_file(SERVICE / "daemon.py")

    def test_every_hierarchy_lock_is_a_real_declaration(self):
        # the pinned order must not drift from the code: each ranked
        # lock (module-qualified or Class.attr) exists in service/
        tier = "".join((SERVICE / m).read_text()
                       for m in os.listdir(SERVICE) if m.endswith(".py"))
        for entry in lockorder.HIERARCHY:
            cls, attr = entry.rsplit(".", 1)
            assert attr in tier, entry
            if not entry.startswith(("store.", "daemon.", "journal.")):
                assert f"class {cls}" in tier, entry

    def test_mutation_compact_inside_journal_lock_fires_cycle(self):
        # move append_terminal's compact() call INSIDE `with
        # self._lock:` — compact() itself takes the (non-reentrant)
        # lock, so the mutation is a guaranteed self-deadlock
        text = (SERVICE / "journal.py").read_text()
        before = ("            should = self._finished_since_compact"
                  " > 2 * self.retain\n"
                  "        if should:\n"
                  "            self.compact()\n")
        assert before in text
        mutated = text.replace(before, (
            "            should = self._finished_since_compact"
            " > 2 * self.retain\n"
            "            if should:\n"
            "                self.compact()\n"))
        f = lockorder.analyze_sources(
            {"journal.py": src_of(mutated, "service/journal.py")},
            hierarchy=None)
        assert lockorder.RULE_CYCLE in rules_of(f)


# --------------------------------------------------------- crashproto


class TestCrashProto:
    def test_missing_fsync_before_return_fires(self):
        text = (
            "import os\n"
            "def append(path, line):\n"
            "    fh = open(path, 'ab')\n"
            "    fh.write(line)\n"
            "    fh.flush()\n"
            "    return True\n")
        f = crashproto.analyze_source(src_of(text))
        assert rules_of(f) == {crashproto.RULE_FSYNC}

    def test_fsync_dominating_return_is_quiet(self):
        text = (
            "import os\n"
            "def append(path, line):\n"
            "    fh = open(path, 'ab')\n"
            "    fh.write(line)\n"
            "    fh.flush()\n"
            "    os.fsync(fh.fileno())\n"
            "    return True\n")
        assert not crashproto.analyze_source(src_of(text))

    def test_fsync_optout_guard_is_quiet(self):
        # the caller opted out of durability on the else arm — that is
        # the journal's documented fsync=False contract, not a bug
        text = (
            "import os\n"
            "def append(path, line, fsync):\n"
            "    fh = open(path, 'ab')\n"
            "    fh.write(line)\n"
            "    if fsync:\n"
            "        os.fsync(fh.fileno())\n"
            "    return True\n")
        assert not crashproto.analyze_source(src_of(text))

    def test_exception_path_is_not_an_ack(self):
        text = (
            "import os\n"
            "def append(path, line):\n"
            "    fh = open(path, 'ab')\n"
            "    fh.write(line)\n"
            "    raise RuntimeError('disk gone')\n")
        assert not crashproto.analyze_source(src_of(text))

    def test_inplace_publish_fires_and_replace_is_quiet(self):
        hot = (
            "import json, os\n"
            "def publish(path, rec):\n"
            "    with open(path, 'w') as fh:\n"
            "        json.dump(rec, fh)\n")
        f = crashproto.analyze_source(src_of(hot))
        assert rules_of(f) == {crashproto.RULE_INPLACE}
        cold = (
            "import json, os\n"
            "def publish(path, tmp, rec):\n"
            "    with open(tmp, 'w') as fh:\n"
            "        json.dump(rec, fh)\n"
            "    os.replace(tmp, path)\n")
        assert not crashproto.analyze_source(src_of(cold))

    def test_append_mode_is_wal_family_not_publish(self):
        text = (
            "import os\n"
            "def log(path, line):\n"
            "    with open(path, 'ab') as fh:\n"
            "        fh.write(line)\n"
            "        os.fsync(fh.fileno())\n")
        assert not crashproto.analyze_source(src_of(text))

    def test_shutil_move_fires_and_pragma_suppresses(self):
        text = (
            "import shutil\n"
            "def adopt(src, dst):\n"
            "    shutil.move(src, dst)\n")
        f = crashproto.analyze_source(src_of(text))
        assert rules_of(f) == {crashproto.RULE_SHUTIL}
        allowed = text.replace(
            "shutil.move(src, dst)",
            "shutil.move(src, dst)  # lint: allow(nonatomic-publish)")
        assert not crashproto.analyze_source(src_of(allowed))

    def test_shipped_service_tier_clean(self):
        for mod in os.listdir(SERVICE):
            if mod.endswith(".py"):
                f = crashproto.analyze_file(SERVICE / mod)
                assert not f, (mod, f)

    def test_mutation_dropped_fsync_fires_on_real_journal(self):
        text = (SERVICE / "journal.py").read_text()
        assert "os.fsync(fh.fileno())" in text
        mutated = text.replace("os.fsync(fh.fileno())", "pass")
        f = crashproto.analyze_source(
            src_of(mutated, "service/journal.py"))
        lines = {x.line for x in f if x.rule == crashproto.RULE_FSYNC}
        # every write site the fsyncs used to dominate: _append,
        # _append_grouped's leader, compact's temp rewrite
        assert len(lines) >= 3, f

    def test_mutation_dropped_replace_fires_on_real_store(self):
        text = (SERVICE / "store.py").read_text()
        assert "os.replace(tmp, path)" in text
        mutated = text.replace("os.replace(tmp, path)",
                               "pass  # publish dropped")
        f = crashproto.analyze_source(src_of(mutated, "service/store.py"))
        assert crashproto.RULE_INPLACE in rules_of(f)

    def test_mutation_daemon_trace_inplace_fires(self):
        # revert the _write_trace atomic publish to in-place writes
        # (both replaces: the rule tracks the temp NAME per function,
        # and _write_trace reuses `tmp` for both files)
        text = (SERVICE / "daemon.py").read_text()
        assert 'os.replace(tmp, d / "results.json")' in text
        mutated = text.replace(
            'os.replace(tmp, d / "results.json")', "pass").replace(
            'os.replace(tmp, d / "history.jsonl")', "pass")
        f = crashproto.analyze_source(src_of(mutated, "service/daemon.py"))
        assert crashproto.RULE_INPLACE in rules_of(f)


# ----------------------------------------------------------- envknobs


class TestEnvKnobs:
    def test_raw_parse_fires(self):
        text = ("import os\n"
                "N = int(os.environ.get('JGRAFT_FOO', '3'))\n")
        f = envknobs.analyze_source(src_of(text, "mod.py"),
                                    doc_names={"JGRAFT_FOO"})
        assert rules_of(f) == {envknobs.RULE_RAW}

    def test_typed_helper_is_quiet(self):
        text = ("from jepsen_jgroups_raft_tpu_torch.platform import env_int\n"
                "N = env_int('JGRAFT_FOO', 3)\n")
        assert not envknobs.analyze_source(src_of(text, "mod.py"),
                                           doc_names={"JGRAFT_FOO"})

    def test_undocumented_knob_fires(self):
        text = ("from jepsen_jgroups_raft_tpu_torch.platform import env_int\n"
                "N = env_int('JGRAFT_FOO', 3)\n")
        f = envknobs.analyze_source(src_of(text, "mod.py"),
                                    doc_names=set())
        assert rules_of(f) == {envknobs.RULE_DOC}

    def test_doc_brace_groups_expand(self):
        names = envknobs.doc_knob_names(
            "| `JGRAFT_SERVICE_BENCH_{REQUESTS,HISTORIES}` | shape |\n")
        assert {"JGRAFT_SERVICE_BENCH_REQUESTS",
                "JGRAFT_SERVICE_BENCH_HISTORIES"} <= names

    def test_registry_harvests_the_repo_clean(self):
        registry, findings = envknobs.build_registry(REPO)
        assert not findings, findings
        knobs = registry["knobs"]
        assert registry["version"] == 2  # with the class columns
        # the port's knobs, across its tiers, are present, typed and
        # documented (doc/running.md, or the README's port section)
        for name in ("JGRAFT_SERVICE_WATCHDOG_S", "JGRAFT_SCAN_CHUNK",
                     "JGRAFT_JOURNAL_GROUP_MS", "JGRAFT_SEARCH_POP",
                     "JGRAFT_STREAM_SESSIONS"):
            assert name in knobs, name
            assert knobs[name]["documented"], name
            assert knobs[name]["sites"], name
        via = {s["via"] for s in knobs["JGRAFT_SERVICE_WATCHDOG_S"]["sites"]}
        assert via == {"env_float"}
        # the harvest reads the port (and chip_smoke.py), not the JAX
        # package: its bench-only knobs are absent
        assert "JGRAFT_BENCH_REPS" not in knobs
        assert all(s["path"].startswith(("jepsen_jgroups_raft_tpu_torch/",
                                         "chip_smoke.py"))
                   for k in knobs.values() for s in k["sites"])

    def test_mutation_reverted_daemon_parse_fires(self):
        text = (SERVICE / "daemon.py").read_text()
        good = 'env_float("JGRAFT_SERVICE_WATCHDOG_S", 30.0, minimum=0.0)'
        assert good in text
        mutated = text.replace(
            good, 'float(os.environ.get("JGRAFT_SERVICE_WATCHDOG_S",'
                  ' "30"))')
        f = envknobs.analyze_source(src_of(mutated, "service/daemon.py"),
                                    doc_names=None)
        raw = [x for x in f if x.rule == envknobs.RULE_RAW]
        assert raw and "JGRAFT_SERVICE_WATCHDOG_S" in raw[0].message


# ------------------------------------------- knob-parse regressions


class TestKnobParsing:
    def test_env_str_blank_means_unset(self, monkeypatch):
        monkeypatch.setenv("JGRAFT_SERVICE_CLUSTER_DIR", "   ")
        assert env_str("JGRAFT_SERVICE_CLUSTER_DIR") == ""
        monkeypatch.setenv("JGRAFT_SERVICE_CLUSTER_DIR", " /shared ")
        assert env_str("JGRAFT_SERVICE_CLUSTER_DIR") == "/shared"
        monkeypatch.delenv("JGRAFT_SERVICE_CLUSTER_DIR")
        assert env_str("JGRAFT_SERVICE_CLUSTER_DIR", "dflt") == "dflt"

    def test_cluster_dir_blank_is_inert(self, monkeypatch):
        from jepsen_jgroups_raft_tpu_torch.service import store
        monkeypatch.setenv("JGRAFT_SERVICE_CLUSTER_DIR", "  ")
        assert store.cluster_dir() is None

    def test_watchdog_margin_keeps_fractional_seconds(self, monkeypatch):
        # float(env_int(...)) would silently discard "0.5"
        from jepsen_jgroups_raft_tpu_torch.service import daemon
        monkeypatch.setenv("JGRAFT_SERVICE_WATCHDOG_S", "0.5")
        assert daemon.default_watchdog_margin() == 0.5
        monkeypatch.setenv("JGRAFT_SERVICE_WATCHDOG_S", "banana")
        assert daemon.default_watchdog_margin() == 30.0

    def test_port_imports_with_garbage_knobs(self):
        # a blank or garbage knob must never crash an importer: the
        # port's readers warn and fall back to their defaults
        code = ("from jepsen_jgroups_raft_tpu_torch.service import daemon\n"
                "from jepsen_jgroups_raft_tpu_torch.checker.schedule "
                "import scan_chunk\n"
                "print(daemon.default_watchdog_margin(), scan_chunk())")
        knobs = ("JGRAFT_SERVICE_WATCHDOG_S", "JGRAFT_SCAN_CHUNK")
        clean = {k: v for k, v in os.environ.items() if k not in knobs}
        runs = []
        for env in (clean, dict(clean, JGRAFT_SERVICE_WATCHDOG_S="garbage",
                                JGRAFT_SCAN_CHUNK=" ")):
            out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                                 env=env, capture_output=True, text=True,
                                 timeout=120)
            assert out.returncode == 0, out.stderr
            runs.append(out.stdout.split())
        assert runs[0] == runs[1] and runs[0][0] == "30.0", runs


# ------------------------------------------------------ CLI workflow


class TestCliWorkflow:
    def test_knob_registry_artifact(self, tmp_path, capsys):
        reg_file = tmp_path / "knob_registry.json"
        rc = cli.main(["--rules", "envknobs",
                       "--knob-registry", str(reg_file)])
        capsys.readouterr()
        assert rc == 0
        reg = json.loads(reg_file.read_text())
        assert reg["version"] == 2 and reg["knobs"]
        site = reg["knobs"]["JGRAFT_SERVICE_WATCHDOG_S"]["sites"][0]
        assert site["via"] == "env_float"
        assert site["path"].endswith("service/daemon.py")

    def test_sarif_help_uris_point_at_the_concurrency_section(self):
        sarif = report.to_sarif([], [], list(cli.RULES["guarded"]) +
                                list(cli.RULES["crashproto"]),
                                rule_help=cli.RULE_HELP)
        rules = sarif["runs"][0]["tool"]["driver"]["rules"]
        assert rules
        for r in rules:
            assert r["helpUri"].startswith("README.md#graftlint-on-the-port")
            assert "concurrency" in r["helpUri"], r

    def test_repo_clean_under_all_analyzers(self, repo_findings):
        assert not repo_findings, repo_findings

    def test_shipped_baseline_is_empty(self):
        base = json.loads(
            (PKG / "lint" / "baseline.json").read_text())
        assert base["findings"] == []

    def test_graftsync_rules_are_registered(self):
        listed = {r for rules in cli.RULES.values() for r in rules}
        for rule in (guarded.RULE, lockorder.RULE_CYCLE,
                     lockorder.RULE_ORDER, lockorder.RULE_RANK,
                     crashproto.RULE_FSYNC, crashproto.RULE_INPLACE,
                     crashproto.RULE_SHUTIL, envknobs.RULE_RAW,
                     envknobs.RULE_DOC, envknobs.RULE_DUP):
            assert rule in listed, rule
            assert rule in cli.RULE_HELP, rule
