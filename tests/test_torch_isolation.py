"""The PyTorch port stands alone: it imports neither jax nor the JAX
reference package, runs a check with both blocked, and its entry points
refuse to run on the host unless asked to by name."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
    LinearizableChecker, check_encoded, check_histories)
from jepsen_jgroups_raft_tpu_torch.history.synth import build_history
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
from jepsen_jgroups_raft_tpu_torch.platform import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "jepsen_jgroups_raft_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "jepsen_jgroups_raft_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "jepsen_jgroups_raft_tpu"):
        del sys.modules[name]
for name in ("jax", "jaxlib", "jepsen_jgroups_raft_tpu"):
    sys.modules[name] = None          # any import of these now fails
import jepsen_jgroups_raft_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import check_histories
from jepsen_jgroups_raft_tpu_torch.history.synth import build_history
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
hs = [build_history([(0, "invoke", "write", 1), (0, "ok", "write", 1),
                     (1, "invoke", "read", None), (1, "ok", "read", v)])
      for v in (1, 2)]
rs = check_histories(hs, CasRegister(), device="cpu")
assert [r["valid?"] for r in rs] == [True, False], rs
assert all(r["kernel"] == "dense" for r in rs), rs
assert not any(n.split(".")[0] in ("jax", "jaxlib") and sys.modules[n] is not None
               for n in sys.modules)
print("BLOCKED_OK", len(mods))
"""


def test_imports_and_checks_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BLOCKED_OK" in out.stdout
    assert int(out.stdout.split()[-1]) >= 12  # every module was imported


def _two():
    return [build_history([(0, "invoke", "write", 1), (0, "ok", "write", 1),
                           (1, "invoke", "read", None),
                           (1, "ok", "read", 1)])]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["check_histories", "check_encoded",
                                   "LinearizableChecker", "resolve_device"])
def test_entry_points_raise_without_card(no_card, entry):
    m = CasRegister()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "check_histories":
            check_histories(_two(), m)
        elif entry == "check_encoded":
            check_encoded([], m)
        elif entry == "LinearizableChecker":
            LinearizableChecker(m)
        else:
            resolve_device("cuda")


def test_explicit_cpu_runs_without_card(no_card):
    [r] = check_histories(_two(), CasRegister(), device="cpu")
    assert r["valid?"] is True and r["decided-tier"] == "dense"
    r = LinearizableChecker(CasRegister(), device="cpu").check({}, _two()[0])
    assert r["valid?"] is True


#: the checking service (its cluster tier too) and the perf and stats
#: checkers, by name
SERVICE_MODULES = (
    "checker.perf", "checker.stats", "service", "service.admission",
    "service.client", "service.cluster", "service.daemon", "service.frame",
    "service.http", "service.journal", "service.request",
    "service.scheduler", "service.store", "service.stream")

_BLOCKED_SERVICE = r"""
import importlib, sys
for name in ("jax", "jaxlib", "jepsen_jgroups_raft_tpu"):
    sys.modules[name] = None          # any import of these now fails
for m in sys.argv[1:]:
    importlib.import_module("jepsen_jgroups_raft_tpu_torch." + m)
from jepsen_jgroups_raft_tpu_torch.checker.perf import PerfChecker
from jepsen_jgroups_raft_tpu_torch.checker.stats import StatsChecker
from jepsen_jgroups_raft_tpu_torch.history.synth import build_history
from jepsen_jgroups_raft_tpu_torch.service import (CheckingService,
                                                   ServiceClient,
                                                   serve_in_thread)
import tempfile
rows = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
        (1, "invoke", "read", None), (1, "ok", "read", 2)]
svc = CheckingService(device="cpu", batch_wait=0.0,
                      cluster_dir=tempfile.mkdtemp(), replica_id="r0")
assert svc.stats()["cluster_enabled"] is True
httpd, port, _ = serve_in_thread(svc)
cl = ServiceClient(f"http://127.0.0.1:{port}")
rec = cl.check([build_history(rows).to_dicts()], workload="register",
               timeout_s=60)
httpd.shutdown(); httpd.server_close(); svc.shutdown()
assert rec["valid?"] is False, rec
h = build_history(rows)
assert StatsChecker().check({}, h)["valid?"] is True
assert PerfChecker(render=False).check({}, h)["valid?"] is True
assert not any(n.split(".")[0] in ("jax", "jaxlib") and sys.modules[n] is not None
               for n in sys.modules)
print("SERVICE_BLOCKED_OK")
"""


def test_service_runs_with_jax_blocked():
    """Every module of the service (the cluster tier's among them) and
    the perf and stats checkers imports with jax and the reference
    blocked, and a replica of a cluster on the CPU answers a submission
    over HTTP."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_SERVICE,
                          *SERVICE_MODULES], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SERVICE_BLOCKED_OK" in out.stdout
