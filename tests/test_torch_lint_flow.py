"""graftcheck (lint/flow) on the port: the CFG, the redesigned kernel
contract, the heal and resource analyzers, and the CLI's SARIF and
baseline round trip.

The JAX package's ``tests/test_lint_flow.py``, case for case, on the
port's lint and sources: every rule is proven to FIRE on a seeded
violation and to stay QUIET on the shipped tree; the CFG fixtures; the
in-memory mutation tests against the port's real nemesis, deploy and
service sources. The Pallas cases become CUDA-source and plain-twin
fixtures of the Hopper contract (``kernel-cap-drift``,
``kernel-smem-budget``, ``kernel-threads``, ``kernel-unresolved``).
CPU-only; the analyzers import neither jax nor torch.
"""

import json
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.lint import cli, report
from jepsen_jgroups_raft_tpu_torch.lint.base import SourceFile
from jepsen_jgroups_raft_tpu_torch.lint.flow import kernel_contract
from jepsen_jgroups_raft_tpu_torch.lint.flow.cfg import EXC, FALSE, TRUE, \
    cfg_for
from test_torch_lint_twins import twin_of

# the copied analyzers, each call held to the JAX package's on the same
# input (test_torch_lint_twins.py)
heal = twin_of("heal")
resource = twin_of("resource")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "jepsen_jgroups_raft_tpu_torch"
CSRC = PKG / "ops" / "csrc"


def rules_of(findings):
    return {f.rule for f in findings}


@pytest.fixture(scope="module")
def repo_findings():
    """Every analyzer over the port and native/src, once for the
    module."""
    return cli.run([str(PKG), str(REPO / "native" / "src")],
                   list(cli.ANALYZERS))


# ------------------------------------------------------------------- CFG


def succ_kinds(node):
    return {k for _, k in node.succs}


def reaches(cfg, start, target, kinds=None):
    seen, stack = set(), [start]
    while stack:
        n = stack.pop()
        if n is target:
            return True
        if n.idx in seen:
            continue
        seen.add(n.idx)
        stack.extend(s for s, k in n.succs if kinds is None or k in kinds)
    return False


class TestCfgConstruction:
    def test_if_has_branch_arms_and_exception_edge(self):
        g = cfg_for("def f(x):\n"
                    "    if check(x):\n"
                    "        return 1\n"
                    "    return 2\n", "f")
        [cond] = g.find("if")
        assert {TRUE, FALSE, EXC} <= succ_kinds(cond)

    def test_try_finally_duplicates_finally_per_continuation(self):
        g = cfg_for("def f(x):\n"
                    "    try:\n"
                    "        risky(x)\n"
                    "        return 1\n"
                    "    finally:\n"
                    "        cleanup(x)\n", "f")
        # separate instances: exception path, return path, normal path
        assert len(g.find("finally")) == 3
        # the exception edge of risky() reaches raise_exit THROUGH a
        # cleanup node, never directly
        risky = next(n for n in g.stmt_nodes() if n.line == 3)
        direct = [d for d, k in risky.succs if d is g.raise_exit]
        assert not direct
        assert reaches(g, risky, g.raise_exit)

    def test_early_return_routes_through_finally(self):
        g = cfg_for("def f(x):\n"
                    "    try:\n"
                    "        if x:\n"
                    "            return early()\n"
                    "    finally:\n"
                    "        cleanup(x)\n"
                    "    return late()\n", "f")
        [ret] = [n for n in g.find("return") if n.line == 4]
        # the return's continuation is a finally instance, not exit
        succs = [d for d, k in ret.succs if k != EXC]
        assert all(d.label == "finally" for d in succs)
        assert reaches(g, ret, g.exit)

    def test_with_exception_routes_through_exit_marker(self):
        g = cfg_for("def f():\n"
                    "    with open('x') as fh:\n"
                    "        risky(fh)\n"
                    "    return 1\n", "f")
        risky = next(n for n in g.stmt_nodes() if n.line == 3)
        exc_succ = [d for d, k in risky.succs if k == EXC]
        assert exc_succ and all(d.label == "with-exit" for d in exc_succ)
        assert reaches(g, risky, g.raise_exit)

    def test_while_true_only_leaves_via_break(self):
        g = cfg_for("def f(q):\n"
                    "    while True:\n"
                    "        v = q.get()\n"
                    "        if v is None:\n"
                    "            break\n", "f")
        [loop] = g.find("while")
        assert FALSE not in succ_kinds(loop)
        [brk] = g.find("break")
        assert reaches(g, brk, g.exit)

    def test_non_catchall_handler_keeps_propagate_edge(self):
        g = cfg_for("def f(x):\n"
                    "    try:\n"
                    "        risky(x)\n"
                    "    except ValueError:\n"
                    "        handle(x)\n"
                    "    return 1\n", "f")
        [dispatch] = g.find("except-dispatch")
        assert any(d is g.raise_exit for d, _ in dispatch.succs)
        # with a catch-all instead, the propagate edge disappears
        g2 = cfg_for("def f(x):\n"
                     "    try:\n"
                     "        risky(x)\n"
                     "    except Exception:\n"
                     "        handle(x)\n"
                     "    return 1\n", "f")
        [dispatch2] = g2.find("except-dispatch")
        assert not any(d is g2.raise_exit for d, _ in dispatch2.succs)


# -------------------------------------------------------- kernel contract


def kc(snippet, path="fixture.cu", **kw):
    return kernel_contract.analyze_source(SourceFile.from_text(path, snippet),
                                          **kw)


FIXTURE_CU = """
#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int kSlots = 10;   // DENSE_MAX_SLOTS
constexpr int kThreads = 128;
}

__global__ void __launch_bounds__(kThreads)
    scan(int32_t* out, int n) {
  if (threadIdx.x == 0) out[blockIdx.x] = n + kSlots;
}

int launch(int32_t* out, int B, int n, cudaStream_t s) {
  scan<<<B, kThreads, 0, s>>>(out, n);
  return 0;
}
"""


def twin(rel):
    return (PKG / rel).read_text()


class TestKernelContract:
    def test_production_cuda_sources_resolve_and_pass(self):
        # every CUDA source of the port is read — not vacuously: its
        # kernels, bounds and launches are found and evaluated
        n_kernels = n_launches = 0
        for path in sorted(CSRC.glob("*.cu*")):
            src = SourceFile.load(path)
            cu = kernel_contract.CudaSource.parse(str(path), src.text, CSRC)
            n_kernels += len(cu.kernels)
            n_launches += len(cu.launches)
            assert kernel_contract.analyze_source(src) == [], path.name
        assert n_kernels >= 12 and n_launches >= 12

    def test_production_twin_files_clean(self):
        # each twin's contract runs over its domain and proves facts
        for rel, contract in kernel_contract.PY_CONTRACTS.items():
            src = SourceFile.load(PKG / rel)
            assert kernel_contract.analyze_source(src) == [], rel
            ctx = kernel_contract._py_ctx(str(PKG / rel), None, PKG)
            contract(ctx)
            assert ctx.facts and not ctx.findings, rel

    def test_sort_contract_fires_on_inflated_smem(self):
        # B5: 64-byte keys in place of 8 push a block past 227 KB at the
        # caps, where the tile cannot halve below the block
        text = twin("ops/linear_scan.py")
        assert "key_bytes = 8 * ((K + 2) // 2)" in text
        mutated = text.replace("key_bytes = 8 * ((K + 2) // 2)",
                               "key_bytes = 64 * ((K + 2) // 2)")
        found = kc(mutated, path="ops/linear_scan.py")
        assert "kernel-smem-budget" in rules_of(found)

    def test_segment_contract_fires_on_inflated_smem(self):
        # B6's CTA bytes at the dense caps and SEGMENT_MAX_WARPS
        text = twin("ops/segment_scan.py")
        marker = "return 4 * (int(tile) * (1 + fs)"
        assert marker in text
        found = kc(text.replace(marker, "return 64 * (int(tile) * (1 + fs)"),
                   path="ops/segment_scan.py")
        assert "kernel-smem-budget" in rules_of(found)

    def test_closure_contract_fires_on_inflated_panel(self):
        # B7's panel form opts in to nothing: 48 KB is its budget
        text = twin("ops/cycle_closure.py")
        assert "mw = 8 if nw <= 8 else 16" in text
        found = kc(text.replace("mw = 8 if nw <= 8 else 16",
                                "mw = 8 if nw <= 8 else 400"),
                   path="ops/cycle_closure.py")
        assert "kernel-smem-budget" in rules_of(found)
        assert any("49152" in f.message for f in found)

    def test_contract_binding_is_loud_when_fn_vanishes(self):
        # renaming a twin must FAIL the gate (loud), not drop the
        # contract silently — and under kernel-unresolved, so a
        # baselined budget rule can never swallow it
        for rel, fn in (("ops/linear_scan.py", "sort_shape_plain"),
                        ("ops/segment_scan.py", "segment_smem_bytes"),
                        ("ops/cycle_closure.py", "closure_smem_bytes"),
                        ("ops/election_safety.py", "election_threads")):
            mutated = twin(rel).replace(f"def {fn}(", "def renamed_twin(")
            found = kc(mutated, path=rel)
            assert any(f.rule == "kernel-unresolved" and fn in f.message
                       for f in found), (rel, found)

    def test_well_formed_fixture_is_clean(self):
        assert kc(FIXTURE_CU) == []

    def test_cap_drift_rejected(self):
        # the acceptance-named case: a C++ cap restated from a Python
        # constant drifts from it
        bad = FIXTURE_CU.replace("kSlots = 10;", "kSlots = 11;")
        [f] = kc(bad)
        assert f.rule == "kernel-cap-drift" and f.line == 6
        assert "DENSE_MAX_SLOTS" in f.message and "10" in f.message

    def test_launch_bound_over_1024_rejected(self):
        bad = FIXTURE_CU.replace("constexpr int kThreads = 128;",
                                 "constexpr int kThreads = 2048;")
        assert "kernel-threads" in rules_of(kc(bad))

    def test_launch_block_over_bound_rejected(self):
        # blocks of 256 threads for a kernel bounded at 128
        bad = FIXTURE_CU.replace("scan<<<B, kThreads, 0, s>>>",
                                 "scan<<<B, 2 * kThreads, 0, s>>>")
        [f] = kc(bad)
        assert f.rule == "kernel-threads" and "bound is 128" in f.message

    def test_election_table_over_budget_rejected(self):
        # B9: a shared table of 2^15 64-bit slots is 256 KB
        text = twin("ops/election_safety.py")
        assert "SHARED_MAX_LOG2 = 14" in text
        mutated = text.replace("SHARED_MAX_LOG2 = 14", "SHARED_MAX_LOG2 = 15")
        found = kc(mutated, path="ops/election_safety.py")
        assert "kernel-smem-budget" in rules_of(found)

    def test_opt_in_is_per_kernel(self):
        # election_safety.cu opts its shared form in above 48 KB and not
        # its global form; cycle_closure.cu opts in none of its kernels;
        # the sort and segment sources (one kernel each) opt in through a
        # pointer
        cu = kernel_contract.cuda_source(PKG, "ops/csrc/election_safety.cu")
        assert cu.opted == {"election_shared"} and not cu.opt_unresolved
        assert kernel_contract.smem_limit(cu, "election_shared") == 232448
        assert kernel_contract.smem_limit(cu, "election_global") == 49152
        rows = {r["kernel"]: r["functions"]
                for r in kernel_contract.contract_table()}
        opted = {k for fns in rows.values() for k, v in fns.items()
                 if v["opts_in"]}
        assert opted == {"election_shared", "sort_scan_block",
                         "segment_scan_cta"}
        assert all(v["smem_limit"] == (232448 if k in opted else 49152)
                   for fns in rows.values() for k, v in fns.items())

    def test_opt_in_through_an_unknown_pointer_is_loud(self):
        # two kernels, and the opt-in names neither: which one it raises
        # cannot be read, so the limit of both stays 48 KB and the
        # analyzer says so
        two = FIXTURE_CU.replace(
            "int launch(",
            "__global__ void other(int32_t* out) { out[0] = 0; }\n\n"
            "int launch(").replace(
            "  return 0;",
            "  cudaFuncSetAttribute(fn, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, 1 << 16);\n"
            "  return 0;")
        found = kc(two)
        assert [f.rule for f in found] == ["kernel-unresolved"]
        assert "fn" in found[0].message
        cu = kernel_contract.CudaSource.parse("fixture.cu", two)
        assert cu.opted == set() and len(cu.kernels) == 2

    def test_unresolved_is_loud_not_silent(self):
        # a cap comment naming no constant of the port, and a block
        # computed at run time that no contract row covers
        bad = FIXTURE_CU.replace("kThreads = 128;",
                                 "kThreads = 128;  // NO_SUCH_CAP") \
                        .replace("scan<<<B, kThreads, 0, s>>>",
                                 "scan<<<B, n * 32, 0, s>>>")
        found = kc(bad)
        assert [f.rule for f in found] == ["kernel-unresolved"] * 2
        assert "NO_SUCH_CAP" in found[0].message
        assert "n * 32" in found[1].message

    def test_real_cap_mutation_fires(self):
        # the mask kernel's window cap, raised on the C++ side only
        text = (CSRC / "mask_scan.cu").read_text()
        marker = "constexpr int kMaskMaxSlots = 12;"
        assert marker in text
        found = kc(text.replace(marker, "constexpr int kMaskMaxSlots = 13;"),
                   path="ops/csrc/mask_scan.cu")
        [f] = found
        assert f.rule == "kernel-cap-drift"
        assert "MASK_DENSE_MAX_SLOTS" in f.message


# ------------------------------------------------------------------ heal


def hl(snippet):
    return heal.analyze_source(SourceFile.from_text("seed.py", snippet))


class TestHealPairing:
    def test_nemesis_tier_clean(self):
        for f in ("faults.py", "membership.py", "package.py", "base.py"):
            src = SourceFile.load(PKG / "nemesis" / f)
            assert heal.analyze_source(src) == [], f

    def test_seeded_unhealed_fires(self):
        snippet = ("class Nem:\n"
                   "    def invoke(self, test, node):\n"
                   "        self.db.kill(test, node)\n"
                   "        return 'done'\n")
        [f] = hl(snippet)
        assert f.rule == "flow-unhealed-fault" and f.line == 3

    def test_finally_heal_alone_is_not_enough(self):
        # the heal lives in a finally — but the heal call itself can
        # raise, and then the affliction is live with nothing tracking
        # it (exactly the membership rollback bug). Strict by design.
        snippet = ("class Nem:\n"
                   "    def invoke(self, test, node):\n"
                   "        self.db.kill(test, node)\n"
                   "        try:\n"
                   "            probe(test)\n"
                   "        finally:\n"
                   "            self.db.start(test, node)\n"
                   "        return 'done'\n")
        [f] = hl(snippet)
        assert f.rule == "flow-unhealed-fault"
        # registration right after the fault makes the same shape sound:
        # teardown owns whatever the heal failed to undo
        fixed = snippet.replace(
            "        try:\n",
            "        self.afflicted.add(node)\n        try:\n")
        assert hl(fixed) == []

    def test_exception_path_skipping_heal_fires(self):
        # heal only on the normal path: the exception edge of probe()
        # escapes un-healed
        snippet = ("class Nem:\n"
                   "    def invoke(self, test, node):\n"
                   "        self.db.kill(test, node)\n"
                   "        probe(test)\n"
                   "        self.db.start(test, node)\n"
                   "        return 'done'\n")
        [f] = hl(snippet)
        assert "exception path" in f.message

    def test_raising_heal_does_not_discharge(self):
        # the membership bug shape: the rollback heal itself raises and
        # is swallowed — the fault is still live
        snippet = ("class Nem:\n"
                   "    def invoke(self, test, node):\n"
                   "        self.db.kill(test, node)\n"
                   "        try:\n"
                   "            self.db.start(test, node)\n"
                   "        except Exception:\n"
                   "            pass\n")
        [f] = hl(snippet)
        assert f.rule == "flow-unhealed-fault"

    def test_registration_discharges(self):
        snippet = ("class Nem:\n"
                   "    def invoke(self, test, node):\n"
                   "        self.db.kill(test, node)\n"
                   "        self.afflicted.add(node)\n"
                   "        return 'done'\n")
        assert hl(snippet) == []

    def test_blanket_teardown_discharges_but_registry_loop_does_not(self):
        blanket = ("class Nem:\n"
                   "    def invoke(self, test, g):\n"
                   "        self.net.partition(test, g)\n"
                   "        return 'cut'\n"
                   "    def teardown(self, test):\n"
                   "        self.net.heal(test)\n")
        assert hl(blanket) == []
        registry = ("class Nem:\n"
                    "    def invoke(self, test, node):\n"
                    "        self.db.kill(test, node)\n"
                    "        return 'done'\n"
                    "    def teardown(self, test):\n"
                    "        for n in sorted(self.afflicted):\n"
                    "            self.db.start(test, n)\n")
        # a registry-driven teardown only covers REGISTERED afflictions
        assert rules_of(hl(registry)) == {"flow-unhealed-fault"}

    def test_inherited_teardown_counts(self):
        snippet = ("class Base:\n"
                   "    def teardown(self, test):\n"
                   "        self.net.heal(test)\n"
                   "class Nem(Base):\n"
                   "    def invoke(self, test, g):\n"
                   "        self.net.partition(test, g)\n"
                   "        return 'cut'\n")
        assert hl(snippet) == []
        # and without the inherited teardown it fires
        alone = snippet.replace("class Base:\n"
                                "    def teardown(self, test):\n"
                                "        self.net.heal(test)\n", "")
        assert rules_of(hl(alone)) == {"flow-unhealed-fault"}

    def test_pragma_suppresses(self):
        snippet = ("class Nem:\n"
                   "    def invoke(self, test, node):\n"
                   "        self.db.kill(test, node)  # lint: "
                   "allow(unhealed)\n"
                   "        return 'killed'\n")
        assert hl(snippet) == []
        # pragma removed -> fires (it is load-bearing, not decoration)
        assert rules_of(hl(snippet.replace(
            "  # lint: allow(unhealed)", ""))) == {"flow-unhealed-fault"}

    def test_delegating_wrapper_is_the_primitive(self):
        snippet = ("class Nem:\n"
                   "    def _do(self, test, node):\n"
                   "        self.db.kill(test, node)\n")
        assert hl(snippet) == []

    # --- mutation tests against the REAL nemesis sources -------------

    def test_mutation_teardown_heal_deleted_from_faults(self):
        text = (PKG / "nemesis" / "faults.py").read_text()
        marker = ("    def teardown(self, test):\n"
                  "        # Never leave the network cut after a run.\n"
                  "        try:\n"
                  "            self.net.heal(test)\n"
                  "        except Exception:\n"
                  "            pass")
        assert marker in text
        mutated = text.replace(marker,
                               "    def teardown(self, test):\n"
                               "        pass")
        found = heal.analyze_source(
            SourceFile.from_text("faults.py", mutated))
        assert any(f.rule == "flow-unhealed-fault" and
                   "`partition`" in f.message for f in found)

    def test_mutation_registration_deleted_from_faults(self):
        text = (PKG / "nemesis" / "faults.py").read_text()
        assert "self.afflicted.add(n)" in text
        mutated = text.replace("self.afflicted.add(n)", "pass")
        found = heal.analyze_source(
            SourceFile.from_text("faults.py", mutated))
        assert any(f.rule == "flow-unhealed-fault" and "`_do`" in f.message
                   for f in found)

    def test_membership_pragmas_are_load_bearing(self):
        # the allow(unhealed) inventory: exactly the two deliberate
        # sites, and removing one re-arms the analyzer
        text = (PKG / "nemesis" / "membership.py").read_text()
        assert text.count("lint: allow(unhealed)") == 2
        mutated = text.replace(
            "self.db.kill(test, node)  # lint: allow(unhealed)",
            "self.db.kill(test, node)")
        found = heal.analyze_source(
            SourceFile.from_text("membership.py", mutated))
        assert any(f.rule == "flow-unhealed-fault" and "`kill`" in f.message
                   for f in found)


# --------------------------------------------------------------- resource


def rl(snippet):
    return resource.analyze_source(SourceFile.from_text("seed.py", snippet))


class TestResourceLeak:
    def test_deploy_runner_tier_clean(self):
        for f in ("deploy/ssh.py", "deploy/local.py", "core/runner.py",
                  "core/db.py"):
            src = SourceFile.load(PKG / Path(f))
            assert resource.analyze_source(src) == [], f

    # regression fixtures: each FIXED bug's pre-fix shape must fire and
    # its fixed shape must stay quiet.

    def test_log_handle_leak_shape(self):
        # deploy/local.py start_node pre-fix: Popen raises -> open log
        # handle leaks (Popen is not an adopting callee)
        bad = ("def start_node(self, name):\n"
               "    log = open(self.log_path(name), 'ab')\n"
               "    self.procs[name] = Popen(['bin'], stdout=log)\n"
               "    log.close()\n")
        [f] = rl(bad)
        assert f.rule == "flow-resource-leak" and f.line == 2
        good = ("def start_node(self, name):\n"
                "    with open(self.log_path(name), 'ab') as log:\n"
                "        self.procs[name] = Popen(['bin'], stdout=log)\n")
        assert rl(good) == []

    def test_half_open_client_shape(self):
        # core/runner.py pre-fix: setup raises -> handler drops the open
        # connection by reassigning None
        bad = ("def worker(proto, test, node):\n"
               "    try:\n"
               "        client = proto.open(test, node)\n"
               "        client.setup(test)\n"
               "    except Exception:\n"
               "        client = None\n"
               "    return client\n")
        [f] = rl(bad)
        assert "reassigns" in f.message
        good = ("def worker(proto, test, node):\n"
                "    client = proto.open(test, node)\n"
                "    try:\n"
                "        client.setup(test)\n"
                "    except BaseException:\n"
                "        try:\n"
                "            client.close(test)\n"
                "        except Exception:\n"
                "            LOG.debug('half-open close failed')\n"
                "        raise\n"
                "    return client\n")
        assert rl(good) == []

    def test_teardown_then_close_shape(self):
        # core/runner.py pre-fix finally: a raising teardown skips close
        bad = ("def worker(proto, test, node):\n"
               "    client = proto.open(test, node)\n"
               "    try:\n"
               "        use(client)\n"
               "    finally:\n"
               "        try:\n"
               "            client.teardown(test)\n"
               "            client.close(test)\n"
               "        except Exception:\n"
               "            LOG.exception('teardown failed')\n")
        [f] = rl(bad)
        assert f.rule == "flow-resource-leak"
        good = bad.replace(
            "            client.teardown(test)\n"
            "            client.close(test)\n"
            "        except Exception:\n"
            "            LOG.exception('teardown failed')\n",
            "            client.teardown(test)\n"
            "        finally:\n"
            "            client.close(test)\n")
        assert rl(good) == []

    def test_bind_before_adoption_shape(self):
        # deploy/local.py _free_ports pre-fix: bind raises before append
        bad = ("def free_ports(n):\n"
               "    socks = []\n"
               "    try:\n"
               "        for _ in range(n):\n"
               "            s = socket.socket()\n"
               "            s.bind(('127.0.0.1', 0))\n"
               "            socks.append(s)\n"
               "        return [s.getsockname()[1] for s in socks]\n"
               "    finally:\n"
               "        for s in socks:\n"
               "            s.close()\n")
        [f] = rl(bad)
        assert f.line == 5
        good = bad.replace("            s.bind(('127.0.0.1', 0))\n"
                           "            socks.append(s)\n",
                           "            socks.append(s)\n"
                           "            s.bind(('127.0.0.1', 0))\n")
        assert rl(good) == []

    def test_close_in_finally_with_none_guard_is_quiet(self):
        snippet = ("def probe(name):\n"
                   "    conn = None\n"
                   "    try:\n"
                   "        conn = NativeConn(name, 9000)\n"
                   "        return conn.probe()\n"
                   "    except CONN_ERRORS:\n"
                   "        return None\n"
                   "    finally:\n"
                   "        if conn is not None:\n"
                   "            conn.close()\n")
        assert rl(snippet) == []

    def test_return_transfers_ownership(self):
        snippet = ("def admin(name):\n"
                   "    conn = NativeConn(name, 9000)\n"
                   "    return conn\n")
        assert rl(snippet) == []

    def test_attempted_release_discharges(self):
        # a close that raises still counts as released (attempted)
        snippet = ("def shut(name):\n"
                   "    conn = NativeConn(name, 9000)\n"
                   "    try:\n"
                   "        conn.close()\n"
                   "    except Exception:\n"
                   "        LOG.debug('close failed')\n")
        assert rl(snippet) == []

    def test_pragma_suppresses(self):
        snippet = ("def leak(name):\n"
                   "    conn = NativeConn(name, 9000)  # lint: "
                   "allow(resource-leak)\n"
                   "    ping(conn)\n")
        assert rl(snippet) == []


class TestServiceResourceScope:
    """The analyzer's scan set covers the service
    tier (graftd holds queue entries, per-call client sockets, trace
    file handles, and worker threads across exception paths — and it is
    long-lived, so a per-request leak exhausts the daemon's fds where a
    one-shot run never notices). Scope + shipped-clean + the mutation
    proving the analyzer FIRES on the real service source."""

    SERVICE_FILES = ("service/request.py", "service/admission.py",
                     "service/scheduler.py", "service/daemon.py",
                     "service/http.py", "service/client.py")

    def test_scope_covers_service_package(self):
        for f in self.SERVICE_FILES:
            assert resource.applies_to(f"jepsen_jgroups_raft_tpu_torch/{f}"), f
        assert not resource.applies_to(
            "jepsen_jgroups_raft_tpu_torch/checker/linearizable.py")

    def test_service_tier_clean(self):
        for f in self.SERVICE_FILES:
            src = SourceFile.load(PKG / Path(f))
            assert resource.analyze_source(src) == [], f

    def test_trace_handle_mutation_fires(self):
        # daemon._write_trace holds the results.json temp-file handle
        # in a `with` (the publish is temp-write + os.replace since the
        # crash-consistency pass); demoting it to a bare open() must
        # re-arm the analyzer on the REAL source (the exception edge
        # out of json.dump then escapes without a close).
        text = (PKG / "service" / "daemon.py").read_text()
        managed = ('tmp = d / "results.json.tmp"\n'
                   '            with open(tmp, "w") as f:\n'
                   '                json.dump(payload, f, indent=2)')
        assert managed in text  # the mutation target must exist
        mutated = text.replace(
            managed,
            'tmp = d / "results.json.tmp"\n'
            '            f = open(tmp, "w")\n'
            '            json.dump(payload, f, indent=2)')
        assert mutated != text
        found = resource.analyze_source(
            SourceFile.from_text("daemon.py", mutated))
        assert any(f.rule == "flow-resource-leak" and "`f`" in f.message
                   for f in found)

    def test_submit_socket_leak_shape(self):
        # the client-socket-per-submission shape: a raising request()
        # path escapes with the socket open
        bad = ("def push(netloc, payload):\n"
               "    sock = create_connection(netloc)\n"
               "    sock.sendall(payload)\n"
               "    sock.close()\n")
        [f] = rl(bad)
        assert f.rule == "flow-resource-leak" and f.line == 2
        good = ("def push(netloc, payload):\n"
                "    sock = create_connection(netloc)\n"
                "    try:\n"
                "        sock.sendall(payload)\n"
                "    finally:\n"
                "        sock.close()\n")
        assert rl(good) == []

    def test_queue_entry_trace_handle_shape(self):
        # queue-entry bookkeeping that opens a per-request trace file
        # and loses it when the write raises mid-loop
        bad = ("def drain(entries, root):\n"
               "    for e in entries:\n"
               "        trace = open(root / e.id, 'w')\n"
               "        trace.write(e.payload)\n"
               "        trace.close()\n")
        [f] = rl(bad)
        assert f.rule == "flow-resource-leak"
        good = bad.replace(
            "        trace = open(root / e.id, 'w')\n"
            "        trace.write(e.payload)\n"
            "        trace.close()\n",
            "        with open(root / e.id, 'w') as trace:\n"
            "            trace.write(e.payload)\n")
        assert rl(good) == []


# ------------------------------------------------------- CLI + baseline


BAD_NEMESIS = ("class Nem:\n"
               "    def invoke(self, test, node):\n"
               "        self.db.kill(test, node)\n"
               "        return 'done'\n")


class TestDistributedTierResourceScope:
    """The multi-process launcher holds Popen
    handles and the coordinator-port socket across exception paths —
    a leaked child is a whole wedged interpreter, not just an fd."""

    FILES = ("parallel/distributed.py", "parallel/launch.py")

    def test_scope_covers_distributed_tier(self):
        for f in self.FILES:
            assert resource.applies_to(f"jepsen_jgroups_raft_tpu_torch/{f}"), f

    def test_distributed_tier_clean(self):
        for f in self.FILES:
            src = SourceFile.load(PKG / Path(f))
            assert resource.analyze_source(src) == [], f

    def test_scope_covers_durability_tier(self):
        # the journal rides the service/ prefix and must be CLEAN
        # (shipped baseline stays empty); the JAX package's chaos
        # harness has no port, and its scope entry went with it
        assert resource.applies_to(
            "jepsen_jgroups_raft_tpu_torch/service/journal.py")
        assert not resource.applies_to("scripts/chaos_graftd.py")
        src = SourceFile.load(PKG / "service" / "journal.py")
        assert resource.analyze_source(src) == []

    def test_scope_covers_cluster_tier(self):
        # the result store publishes via temp
        # files + os.replace and the cluster manager holds lease and
        # claimed-journal handles — a leaked temp or handle on an
        # exception path would accrete forever in a shared dir every
        # replica scans. Both ride the service/ prefix and must be
        # CLEAN (shipped baseline stays empty).
        for f in ("service/store.py", "service/cluster.py"):
            assert resource.applies_to(f"jepsen_jgroups_raft_tpu_torch/{f}"), f
            src = SourceFile.load(PKG / Path(f))
            assert resource.analyze_source(src) == [], f

    def test_launcher_unkilled_popen_shape_fires(self):
        # launch_local_cluster adopts every child into `procs` inside
        # a try whose finally kills survivors; a bare spawn whose
        # readiness check can raise is exactly the leak shape the
        # widened scope exists to catch — proves it is not vacuous.
        bad = ("import subprocess\n"
               "def spawn(cmd, env, check):\n"
               "    p = subprocess.Popen(cmd, env=env)\n"
               "    check(p)\n"
               "    return p.pid\n")
        src = SourceFile.from_text(
            "jepsen_jgroups_raft_tpu_torch/parallel/launch.py", bad)
        assert any(f.rule == "flow-resource-leak"
                   for f in resource.analyze_source(src))


class TestCliFlow:
    def test_repo_is_clean_under_all_six(self, repo_findings):
        six = {r for a in ("taxonomy", "sync", "lock", "kernel", "heal",
                           "resource") for r in cli.RULES[a]}
        findings = [f for f in repo_findings if f.rule in six]
        assert findings == [], "\n".join(f.render() for f in findings)

    def test_list_rules_includes_flow_tier(self, capsys):
        assert cli.main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for rule in ("kernel-cap-drift", "kernel-smem-budget",
                     "kernel-threads", "flow-unhealed-fault",
                     "flow-resource-leak"):
            assert rule in out

    def test_sarif_output_shape(self, tmp_path, capsys):
        bad = tmp_path / "seed.py"
        bad.write_text(BAD_NEMESIS)
        rc = cli.main([str(bad), "--format", "json",
                       "--baseline", str(tmp_path / "none.json")])
        out = capsys.readouterr().out
        sarif = json.loads(out)
        assert rc == 1
        assert sarif["version"] == "2.1.0"
        [run] = sarif["runs"]
        assert run["tool"]["driver"]["name"] == "graftlint"
        assert run["tool"]["driver"]["informationUri"].startswith(
            "README.md#")
        assert any(r["ruleId"] == "flow-unhealed-fault"
                   for r in run["results"])
        loc = run["results"][0]["locations"][0]["physicalLocation"]
        assert loc["region"]["startLine"] >= 1

    def test_baseline_gates_only_regressions(self, tmp_path, capsys):
        bad = tmp_path / "seed.py"
        bad.write_text(BAD_NEMESIS)
        bp = tmp_path / "baseline.json"
        assert cli.main([str(bad), "--baseline", str(bp),
                         "--update-baseline"]) == 0
        assert bp.exists()
        assert cli.main([str(bad), "--baseline", str(bp)]) == 0
        assert "baselined" in capsys.readouterr().out
        bad.write_text(BAD_NEMESIS +
                       "    def stop(self, test, node):\n"
                       "        self.db.pause(test, node)\n"
                       "        return 'paused'\n")
        assert cli.main([str(bad), "--baseline", str(bp)]) == 1
        out = capsys.readouterr().out
        assert "`pause`" in out and "`kill`" not in out
        rc = cli.main([str(bad), "--format", "json",
                       "--baseline", str(bp)])
        assert rc == 1
        sarif = json.loads(capsys.readouterr().out)
        sup = [bool(r["suppressions"])
               for r in sarif["runs"][0]["results"]]
        assert sorted(sup) == [False, True]

    def test_shipped_baseline_is_empty(self):
        data = json.loads((PKG / "lint" / "baseline.json").read_text())
        assert data["findings"] == []

    def test_fingerprints_survive_line_drift(self, tmp_path):
        f1 = tmp_path / "a.py"
        f1.write_text(BAD_NEMESIS)
        [finding] = heal.analyze_file(f1)
        finding = finding.__class__("a.py", finding.line, finding.rule,
                                    finding.message)
        [(_, fp1)] = report.fingerprints([finding], tmp_path)
        f1.write_text("# header\n# header\n" + BAD_NEMESIS)
        [finding2] = heal.analyze_file(f1)
        finding2 = finding2.__class__("a.py", finding2.line, finding2.rule,
                                      finding2.message)
        [(_, fp2)] = report.fingerprints([finding2], tmp_path)
        assert fp1 == fp2


class TestReviewFixes:
    """Regressions for the contract's own edges."""

    def test_interpreter_abort_degrades_to_unresolved_not_crash(self):
        # a loop past the interpreter's iteration ceiling in a twin must
        # not crash the lint run: the twin is unresolved, loudly
        text = twin("ops/linear_scan.py")
        marker = "    want = _pow2_at_least(C * W)\n"
        assert text.count(marker) == 1
        hot = text.replace(marker, "    for i in range(200001):\n"
                                   "        W = W + 0\n" + marker)
        found = kc(hot, path="ops/linear_scan.py")  # must not raise
        assert rules_of(found) == {"kernel-unresolved"}

    def test_kernel_without_launch_bounds_is_bounded_by_the_card(self):
        # no __launch_bounds__: the card's 1024 threads bound the
        # launch, which is no unresolved finding
        open_bound = FIXTURE_CU.replace("__launch_bounds__(kThreads)", "")
        assert kc(open_bound) == []
        assert "kernel-threads" in rules_of(kc(open_bound.replace(
            "scan<<<B, kThreads, 0, s>>>", "scan<<<B, 2048, 0, s>>>")))

    def test_partial_update_baseline_merges_not_clobbers(self, tmp_path):
        bad = tmp_path / "seed.py"
        bad.write_text(BAD_NEMESIS)
        leak = tmp_path / "leak.py"
        leak.write_text("def f(name):\n"
                        "    conn = NativeConn(name, 9000)\n"
                        "    ping(conn)\n")
        bp = tmp_path / "bl.json"
        assert cli.main([str(bad), "--rules", "heal",
                         "--baseline", str(bp), "--update-baseline"]) == 0
        n1 = len(report.load_baseline(bp))
        assert n1 == 1
        assert cli.main([str(leak), "--rules", "resource",
                         "--baseline", str(bp), "--update-baseline"]) == 0
        assert len(report.load_baseline(bp)) == n1 + 1
        assert cli.main([str(bad), "--rules", "heal",
                         "--baseline", str(bp)]) == 0
        assert cli.main([str(leak), "--rules", "resource",
                         "--baseline", str(bp)]) == 0
