"""graftlint on the port: self-hosting, the pattern analyzers, and the
redesigned host-sync analyzer.

The JAX package's ``tests/test_lint.py``, case for case, on the port's
own lint (``jepsen_jgroups_raft_tpu_torch.lint``) and the port's
sources:

* **Self-hosting**: the analyzers run over the port and ``native/src``
  and report nothing; ``python -m jepsen_jgroups_raft_tpu_torch.lint``
  exits 0 on the checkout (one whole run a module, a module fixture).
* **Seeded violations**: each rule fires on a minimal bad snippet and
  its pragma suppresses it. The JAX package's jit cases become
  host-sync cases on torch code (``.item()`` of a card tensor, a
  branch on one, a blocking upload).
* **Non-vacuity**: each of the fifteen analyzers' scopes visits at
  least one real port file, and its anchor file and anchor function
  exist — the JAX package's lint, whose scopes name only its own
  package, passes the port without reading a line of it.

The lint imports neither jax nor torch; these tests import torch only
to pin its threads.
"""

import ast
import contextlib
import io
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.lint import cli
from jepsen_jgroups_raft_tpu_torch.lint import jit_hygiene
from jepsen_jgroups_raft_tpu_torch.lint.base import SourceFile, collect_files, \
    rel
from test_torch_lint_twins import twin_of

# the copied analyzers, each call held to the JAX package's on the same
# input (test_torch_lint_twins.py)
lock_discipline = twin_of("lock")
taxonomy = twin_of("taxonomy")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "jepsen_jgroups_raft_tpu_torch"


def rules_of(findings):
    return {f.rule for f in findings}


@pytest.fixture(scope="module")
def full_run():
    """`python -m jepsen_jgroups_raft_tpu_torch.lint` with no arguments,
    once for the module: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([])
    return rc, out.getvalue(), err.getvalue()


# --------------------------------------------------------------- self-host


class TestSelfHosting:
    def test_repo_is_clean(self):
        findings = cli.run([str(PKG), str(REPO / "native" / "src")],
                           ["taxonomy", "sync", "lock"])
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_cli_clean_exit(self, full_run):
        rc, out, err = full_run
        assert rc == 0, out + err
        assert "clean" in out
        # all fifteen analyzers ran
        for name in cli.ANALYZERS:
            assert name in out, name

    def test_list_rules(self, capsys):
        assert cli.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in ("taxonomy-indefinite-fail", "host-sync",
                     "lock-guarded-field", "kernel-cap-drift"):
            assert rule in out
        # it says what was redesigned and what has no counterpart
        assert "redesigned: sync (the JAX package's `jit`)" in out
        assert "redesigned: kernel" in out
        assert "jit-python-branch" in out and "kernel-vmem-budget" in out

    def test_unknown_analyzer_is_usage_error(self):
        assert cli.main(["--rules", "nonsense"]) == 2
        # the JAX package's `jit` analyzer is `sync` here
        assert cli.main(["--rules", "jit"]) == 2

    def test_taxonomy_scope_covers_service_tier(self):
        for r in ("core/serve.py", "service/daemon.py",
                  "service/http.py", "service/client.py"):
            assert taxonomy.applies_to(
                f"jepsen_jgroups_raft_tpu_torch/{r}"), r

    def test_taxonomy_scope_covers_distributed_tier(self):
        # the distributed runtime's degrade paths are broad-except-shaped
        # by design and must stay VISIBLE
        for r in ("parallel/distributed.py", "parallel/launch.py"):
            assert taxonomy.applies_to(
                f"jepsen_jgroups_raft_tpu_torch/{r}"), r

    def test_taxonomy_scope_covers_durability_tier(self):
        assert taxonomy.applies_to(
            "jepsen_jgroups_raft_tpu_torch/service/journal.py")
        # the JAX package's chaos harness has no port; its scope entry
        # went with it
        assert "scripts/chaos_graftd.py" not in taxonomy.SCAN_FILES

    def test_taxonomy_scope_covers_cluster_tier(self):
        for r in ("service/store.py", "service/cluster.py"):
            assert taxonomy.applies_to(
                f"jepsen_jgroups_raft_tpu_torch/{r}"), r
        # ... and not the JAX package's files of the same names: each
        # package's lint reads its own
        assert not taxonomy.applies_to(
            "jepsen_jgroups_raft_tpu/service/store.py")

    def test_serve_verdict_broad_except_would_fire(self):
        bad = ("def _verdict(run):\n"
               "    try:\n"
               "        with open(run / 'results.json') as f:\n"
               "            return json.load(f).get('valid?')\n"
               "    except Exception:\n"
               "        return None\n")
        assert "taxonomy-silent-swallow" in rules_of(tax(bad))
        good = bad.replace("except Exception:",
                           "except (OSError, json.JSONDecodeError):")
        assert tax(good) == []

    def test_native_headers_carry_annotations(self):
        text = (REPO / "native" / "src" / "raft.h").read_text()
        assert text.count("GUARDED_BY(mu_)") >= 10
        assert text.count("GUARDED_BY(fwd_mu_)") == 2
        assert "REQUIRES(mu_)" in text


# --------------------------------------------------------------- taxonomy


def tax(snippet):
    return taxonomy.analyze_source(SourceFile.from_text("seed.py", snippet))


class TestTaxonomyRules:
    def test_fail_on_indefinite_fires(self):
        snippet = (
            "def invoke(op):\n"
            "    try:\n"
            "        return do(op)\n"
            "    except ClientTimeout:\n"
            "        return op.replace(type=FAIL, error='timeout')\n")
        assert "taxonomy-indefinite-fail" in rules_of(tax(snippet))

    def test_bare_except_fail_fires(self):
        snippet = (
            "def invoke(op):\n"
            "    try:\n"
            "        return do(op)\n"
            "    except Exception:\n"
            "        return op.replace(type='fail')\n")
        assert "taxonomy-bare-except-fail" in rules_of(tax(snippet))

    def test_broad_oserror_spelling_still_fires(self):
        for exc_name in ("OSError", "ConnectionError", "BrokenPipeError"):
            snippet = (
                "def invoke(op):\n"
                "    try:\n"
                "        return do(op)\n"
                f"    except {exc_name}:\n"
                "        return op.replace(type=FAIL)\n")
            assert "taxonomy-indefinite-fail" in rules_of(tax(snippet)), \
                exc_name

    def test_idempotent_guard_exempts(self):
        snippet = (
            "def invoke(op, idempotent):\n"
            "    try:\n"
            "        return do(op)\n"
            "    except SocketBroken:\n"
            "        if op.f in idempotent:\n"
            "            return op.replace(type=FAIL)\n"
            "        return op.replace(type=INFO)\n")
        assert "taxonomy-indefinite-fail" not in rules_of(tax(snippet))

    def test_classify_error_exempts(self):
        snippet = (
            "def invoke(op):\n"
            "    try:\n"
            "        return do(op)\n"
            "    except BaseException as exc:\n"
            "        definite, kind, desc = classify_error(exc)\n"
            "        return op.replace(type=FAIL if definite else INFO)\n")
        assert rules_of(tax(snippet)) == set()

    def test_silent_swallow_fires_and_narrows_clean(self):
        bad = ("def probe(n):\n"
               "    try:\n"
               "        return conn.probe()\n"
               "    except Exception:\n"
               "        return None\n")
        good = bad.replace("except Exception:", "except CONN_ERRORS:")
        assert "taxonomy-silent-swallow" in rules_of(tax(bad))
        assert rules_of(tax(good)) == set()

    def test_logging_makes_swallow_visible(self):
        snippet = ("def teardown(c):\n"
                   "    try:\n"
                   "        c.close()\n"
                   "    except Exception:\n"
                   "        LOG.debug('close failed', exc_info=True)\n")
        assert rules_of(tax(snippet)) == set()
        # the distributed tier's `_degrade` logs a warning: a sink too
        helper = snippet.replace("LOG.debug('close failed', exc_info=True)",
                                 "_degrade('close failed')")
        assert rules_of(tax(helper)) == set()

    def test_pragma_suppresses(self):
        snippet = (
            "def probe(n):\n"
            "    try:\n"
            "        return conn.probe()\n"
            "    except Exception:  # lint: allow(taxonomy-silent-swallow)\n"
            "        return None\n")
        assert rules_of(tax(snippet)) == set()

    def test_info_record_is_never_flagged(self):
        snippet = ("def invoke(op):\n"
                   "    try:\n"
                   "        return do(op)\n"
                   "    except Exception:\n"
                   "        return op.replace(type=INFO, error='x')\n")
        assert rules_of(tax(snippet)) == set()


# --------------------------------------------------------------- host-sync


def sync(snippet):
    return jit_hygiene.analyze_source(
        SourceFile.from_text("seed.py", snippet))


class TestHostSyncRules:
    def test_item_of_card_tensor_fires(self):
        # the acceptance-named case on torch code
        snippet = ("def count(ok, dev):\n"
                   "    flags = torch.zeros(4, device=dev)\n"
                   "    return flags.sum().item()\n")
        [f] = sync(snippet)
        assert f.rule == "host-sync" and f.line == 3

    def test_cpu_of_kernel_result_fires(self):
        # a wrapper's result is a card tensor the analyzer cannot see
        # through: .cpu() on it fires
        snippet = ("def run(events, model):\n"
                   "    ok, overflow = sort_scan(events, 8, 64, model=model)\n"
                   "    return ok.cpu()\n")
        assert rules_of(sync(snippet)) == {"host-sync"}

    def test_python_branch_on_card_tensor_fires(self):
        snippet = ("def step(x, dev):\n"
                   "    alive = torch.ones(3, dtype=torch.bool, device=dev)\n"
                   "    if alive.any():\n"
                   "        return 1\n"
                   "    return int(alive.sum())\n")
        assert [f.line for f in sync(snippet)] == [3, 5]

    def test_synchronize_fires(self):
        snippet = ("def wait(dev, done, stream):\n"
                   "    torch.cuda.synchronize(dev)\n"
                   "    done.synchronize()\n"
                   "    stream.synchronize()\n")
        assert [f.line for f in sync(snippet)] == [2, 3, 4]

    def test_shape_access_breaks_taint(self):
        snippet = ("def plan(dev):\n"
                   "    x = torch.zeros((8, 4), device=dev)\n"
                   "    n = x.shape[0]\n"
                   "    if n > 4 and x.numel():\n"
                   "        return int(x.dim()) + int(n)\n"
                   "    return x.dtype\n")
        assert rules_of(sync(snippet)) == set()

    def test_blocking_upload_fires_and_non_blocking_is_quiet(self):
        bad = ("def up(a, dev):\n"
               "    return torch.from_numpy(a).to(dev)\n")
        assert rules_of(sync(bad)) == {"host-sync"}
        good = bad.replace(".to(dev)", ".to(dev, non_blocking=True)")
        assert rules_of(sync(good)) == set()
        # a dtype cast is no copy to the card
        assert rules_of(sync(bad.replace(".to(dev)",
                                         ".to(torch.int64)"))) == set()

    def test_launch_host_sync_needs_pragma(self):
        bad = ("def run(events, model):\n"
               "    ok, overflow = sort_scan(events, 8, 64, model=model)\n"
               "    return ok.cpu().numpy()\n")
        good = bad.replace(
            "ok.cpu().numpy()",
            "ok.cpu().numpy()  # lint: allow(host-sync) the verdicts")
        assert "host-sync" in rules_of(sync(bad))
        assert rules_of(sync(good)) == set()

    def test_host_tensors_are_not_device_values(self):
        # torch.from_numpy / torch.tensor without a device are host
        # memory: reading them is no sync
        snippet = ("def pack(a, rows):\n"
                   "    t = torch.from_numpy(a)\n"
                   "    w = torch.tensor([1, 2, 3])\n"
                   "    if t.any():\n"
                   "        return t.tolist() + [int(w.sum()), w.item()]\n"
                   "    return np.asarray(rows).tolist()\n")
        assert rules_of(sync(snippet)) == set()


# --------------------------------------------------------------- lock


def lock(snippet, name="seed.h"):
    return lock_discipline.analyze_source(SourceFile.from_text(name, snippet))


GUARDED_CLASS = """
class Node {
 public:
  void locked_write() {
    std::lock_guard<std::mutex> g(mu_);
    state_ = 1;
  }
  void unlocked_write() {
    state_ = 2;
  }
  void helper() {  // REQUIRES(mu_)
    state_ = 3;
  }
  Node() { state_ = 0; }
 private:
  std::mutex mu_;
  int state_ = 0;  // GUARDED_BY(mu_)
};
"""


class TestLockRules:
    def test_guarded_field_without_mutex_fires(self):
        findings = lock(GUARDED_CLASS)
        assert ["lock-guarded-field"] == [f.rule for f in findings]
        [f] = findings
        assert "unlocked_write" in f.message

    def test_lock_and_requires_and_ctor_exempt(self):
        findings = lock(GUARDED_CLASS)
        msgs = " ".join(f.message for f in findings)
        assert "Node::locked_write" not in msgs
        assert "helper" not in msgs
        assert "Node()" not in msgs

    def test_ctad_lock_forms_are_recognized(self):
        snippet = GUARDED_CLASS.replace(
            "std::lock_guard<std::mutex> g(mu_);",
            "std::scoped_lock g(mu_);")
        assert ["lock-guarded-field"] == [f.rule for f in lock(snippet)]

    def test_unknown_mutex_fires_at_declaration_line(self):
        snippet = ("class C {\n"
                   " private:\n"
                   "  int x_ = 0;  // GUARDED_BY(ghost_mu_)\n"
                   "};\n")
        [f] = [f for f in lock(snippet) if f.rule == "lock-unknown-mutex"]
        assert f.line == 3

    def test_pragma_suppresses(self):
        snippet = GUARDED_CLASS.replace(
            "    state_ = 2;",
            "    state_ = 2;  // lint: allow(lock-guarded-field)")
        assert lock(snippet) == []

    def test_real_raft_header_is_tracked_not_vacuous(self):
        text = (REPO / "native" / "src" / "raft.h").read_text()
        marker = "void maybe_win_locked() {  // REQUIRES(mu_)"
        assert marker in text
        mutated = text.replace(marker, "void maybe_win_locked() {")
        findings = lock(mutated, name="raft.h")
        assert any(f.rule == "lock-guarded-field" and
                   "maybe_win_locked" in f.message for f in findings)
        assert lock(text, name="raft.h") == []

    def test_real_sm_header_is_tracked(self):
        text = (REPO / "native" / "src" / "sm.h").read_text()
        marker = "Bytes encode_get(uint64_t key) {  // REQUIRES(mu_)"
        assert marker in text
        findings = lock(text.replace(
            marker, "Bytes encode_get(uint64_t key) {"), name="sm.h")
        assert any("encode_get" in f.message for f in findings)


# --------------------------------------------------------------- CLI


class TestCli:
    def test_explicit_file_bypasses_scan_set(self, tmp_path, capsys):
        bad = tmp_path / "snippet.py"
        bad.write_text(
            "def invoke(op):\n"
            "    try:\n"
            "        return do(op)\n"
            "    except SocketBroken:\n"
            "        return op.replace(type=FAIL)\n")
        assert cli.main([str(bad)]) == 1
        assert "taxonomy-indefinite-fail" in capsys.readouterr().out

    def test_clean_file_exits_zero(self, tmp_path):
        good = tmp_path / "snippet.py"
        good.write_text("x = 1\n")
        assert cli.main([str(good)]) == 0

    def test_missing_path_is_usage_error(self, tmp_path, capsys):
        assert cli.main([str(tmp_path / "no_such_file.py")]) == 2
        assert "no such path" in capsys.readouterr().err


# ------------------------------------------------------------ non-vacuity


#: per analyzer: a port file its anchor (or its rule's subject) lives in,
#: and a name that file must define (a function, class or C++ text)
ANCHORS = {
    "taxonomy": ("client/errors.py", "classify_error"),
    "sync": ("checker/schedule.py", "run_chunked"),
    "lock": ("../native/src/raft.h", "GUARDED_BY(mu_)"),
    "kernel": ("ops/linear_scan.py", "sort_shape_plain"),
    "heal": ("nemesis/faults.py", "teardown"),
    "resource": ("deploy/local.py", "start_node"),
    "guarded": ("service/daemon.py", "CheckingService"),
    "lockorder": ("service/daemon.py", "CheckingService"),
    "crashproto": ("service/journal.py", "append_terminal"),
    "envknobs": ("platform.py", "env_int"),
    "fingerprint": ("service/request.py", "fingerprint_encodings"),
    "degraded": ("service/daemon.py", "_account_requests"),
    "knobclass": ("platform.py", "env_float"),
    "tierstamp": ("checker/linearizable.py", "check_encoded"),
    "lockstep": ("checker/consistency.py", "StreamingCertifier"),
}


def _defines(path: Path, name: str) -> bool:
    text = path.read_text()
    if path.suffix != ".py":
        return name in text
    return any(isinstance(n, (ast.FunctionDef, ast.ClassDef)) and
               n.name == name for n in ast.walk(ast.parse(text)))


@pytest.mark.parametrize("analyzer", sorted(cli.ANALYZERS))
def test_scope_reads_the_port_and_anchor_exists(analyzer):
    mod, suffixes = cli.ANALYZERS[analyzer]
    visited = [f for f in collect_files([str(PKG),
                                         str(REPO / "native" / "src")],
                                        suffixes)
               if mod.applies_to(rel(f, REPO))]
    assert visited, f"{analyzer} reads no file of the port"
    anchor_file, name = ANCHORS[analyzer]
    path = (PKG / anchor_file).resolve()
    assert path.exists(), path
    assert _defines(path, name), (path, name)
    # the module's own ANCHOR, where it has one, is a real port file
    anchor = getattr(mod, "ANCHOR", None)
    if anchor is not None:
        assert (PKG / anchor).exists(), anchor
        assert any(rel(f, REPO).endswith(anchor) for f in visited)


def test_the_lint_is_stdlib_only():
    """The port's lint reads sources as text and ASTs: it imports
    neither jax, torch, numpy nor either package's code outside it."""
    lint_dir = PKG / "lint"
    allowed = {"__future__", "argparse", "ast", "dataclasses", "hashlib",
               "itertools", "json", "pathlib", "re", "sys", "time",
               "typing", "collections"}
    for path in sorted(lint_dir.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert roots <= allowed, (path, roots)


def test_the_contract_twins_at_known_points():
    """The plain twins the kernel contract evaluates, at points worked
    by hand from the C++ rules. The card holds each to its C++ rule over
    the whole grid (chip_smoke.py phase 2b): the sort shape and B6's
    bytes to the libraries' queries, the closure's dynamic bytes and the
    election's threads to the launchers' own rules, the closure's static
    bytes to ptxas's."""
    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc
    from jepsen_jgroups_raft_tpu_torch.ops import election_safety as es
    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls
    from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_layout

    # K = 4 at W = 127: 512 threads, the tile halved to the block
    assert ls.sort_shape_plain(127, 512) == (512, 512, 11, 73728)
    assert ls.sort_shape_plain(5, 512) == (1024, 2048, 13, 94208)
    assert ls.sort_shape_plain(8, 64, 32, 1) == (32, 32, 8, 3840)
    for W, S, NB in ((1, 1, 1), (5, 4, 33), (9, 16, 256), (10, 8, 7)):
        assert ss.segment_shape(W, S, NB) == ss.segment_shape_at(
            W, dense_layout(W, S).field_log2, NB)
    assert ss.segment_smem_bytes(9, 4, 8, 2048) == 143872
    assert ss.segment_tile(5000) == ss.SEGMENT_MAX_TILE_ROWS
    assert cc.closure_smem_bytes(512) == 36864
    assert cc.closure_smem_bytes(128) == cc.closure_smem_bytes(513) == 0
    assert cc.closure_static_smem_bytes(128) == 10240
    assert cc.closure_static_smem_bytes(4096) == 25600
    assert [es.election_threads(n) for n in (1, 33, 512, 8192)] == \
        [32, 64, 512, 512]
