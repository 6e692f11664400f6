"""The port's sanitizer builds of the native tier (`native.ensure_built(
san=...)`, `native.SAN_MARKERS`).

``ensure_built(san="tsan"|"asan")`` runs ``make -C native
BUILD=build-torch-<san> SAN=<san>`` under the same `fcntl` lock as the
port's normal build, so it never writes the reference's
``native/build-<san>/``; its markers are the reference's. The `slow`
test is the reference's tests/test_tsan.py on the port's `LocalCluster`:
a faulted workload on a sanitizer build, every node log free of reports.
"""

from __future__ import annotations

import fcntl
import os
import threading
import time

import pytest

from jepsen_jgroups_raft_tpu import native as ref_native
from jepsen_jgroups_raft_tpu_torch import native
from jepsen_jgroups_raft_tpu_torch.deploy.local import (BlockNet,
                                                        LocalCluster,
                                                        wait_for_port)
from jepsen_jgroups_raft_tpu_torch.native.client import (NativeConn,
                                                         NativeRsmConn)


class _Done:
    def __init__(self, returncode=0):
        self.returncode = returncode
        self.stdout = "make output"
        self.stderr = "make errors"


def test_san_markers_are_the_references():
    assert native.SAN_MARKERS == ref_native.SAN_MARKERS


@pytest.mark.parametrize("san", ["tsan", "asan"])
def test_san_build_runs_make_into_build_torch_san(monkeypatch, san):
    calls = []

    def run(argv, **kw):
        # the build holds the port's build lock: a second open of the
        # lock file cannot take it
        with open(native.BUILD_DIR / ".build.lock") as other:
            with pytest.raises(BlockingIOError):
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
        calls.append(list(argv))
        return _Done()

    monkeypatch.setattr(native, "_stale", lambda targets: True)
    monkeypatch.setattr(native.subprocess, "run", run)
    native.ensure_built(san=san)
    assert calls == [["make", "-C", str(native.NATIVE_DIR),
                      f"BUILD=build-torch-{san}", f"SAN={san}"]]
    assert native.san_build_dir(san) == \
        native.NATIVE_DIR / f"build-torch-{san}"
    assert native.san_build_dir(san).name != f"build-{san}"


def test_san_build_is_staleness_checked_on_its_own_server(monkeypatch):
    seen = []
    monkeypatch.setattr(native, "_stale",
                        lambda targets: seen.append(tuple(targets)))
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **kw: pytest.fail("built a fresh tree"))
    native.ensure_built(san="tsan")
    assert seen == [(native.san_build_dir("tsan") / "raft_server",)]


def test_san_build_failure_raises_with_makes_output(monkeypatch):
    monkeypatch.setattr(native, "_stale", lambda targets: True)
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **kw: _Done(returncode=2))
    with pytest.raises(RuntimeError, match="native asan build failed"):
        native.ensure_built(san="asan")


def test_unknown_sanitizer_is_refused(monkeypatch):
    monkeypatch.setattr(native.subprocess, "run",
                        lambda *a, **kw: pytest.fail("make ran"))
    with pytest.raises(ValueError, match="unknown sanitizer"):
        native.ensure_built(san="msan")


# ------------------------------------------------ tests/test_tsan.py's run

NODES = ["n1", "n2", "n3"]


def _admin_retry(fn, deadline_s=15.0):
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return fn()
        except Exception:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.3)


def _run_faulted_workload(cluster):
    for n in NODES:
        cluster.start_node(n, NODES, wait=False)
    for n in NODES:
        wait_for_port(*cluster.resolve(n), timeout=30.0)
    stop = time.monotonic() + 6.0

    def worker(node, k):
        conn = NativeRsmConn(*cluster.resolve(node), timeout=2.0)
        try:
            i = 0
            while time.monotonic() < stop:
                i += 1
                try:
                    conn.put(k, i)
                    conn.get(k, quorum=(i % 2 == 0))
                    conn.cas(k, i, i + 1)
                except Exception:
                    time.sleep(0.05)
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, args=(n, k))
               for k, n in enumerate(NODES * 2)]
    for t in threads:
        t.start()
    time.sleep(1.0)
    net = BlockNet(cluster)
    test = {"nodes": NODES, "members": set(NODES)}
    net.partition(test, {"n1": {"n2", "n3"}, "n2": {"n1"}, "n3": {"n1"}})
    time.sleep(1.0)
    net.heal(test)
    time.sleep(0.5)
    cluster.kill_node("n2")
    time.sleep(1.0)
    cluster.start_node("n2", NODES)
    cluster.kill_node("n3")
    admin = NativeConn(*cluster.resolve("n1"), timeout=3.0)
    try:
        _admin_retry(lambda: admin.admin_remove("n3"))
        cluster.ports.pop("n3", None)
        _admin_retry(lambda: admin.admin_add(cluster.spec("n3")))
    finally:
        admin.close()
    cluster.start_node("n3", NODES)
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("SKIP_TSAN") == "1",
                    reason="SKIP_TSAN=1")
@pytest.mark.parametrize("san", ["tsan", "asan"])
def test_native_server_is_clean_under_sanitizer(tmp_path, san):
    native.ensure_built(san=san)
    cluster = LocalCluster(
        NODES, sm="map", workdir=str(tmp_path / "sut"),
        election_ms=300, heartbeat_ms=100, repl_timeout_ms=5000,
        compact_every=8,
        server_bin=str(native.san_build_dir(san) / "raft_server"))
    try:
        _run_faulted_workload(cluster)
    finally:
        cluster.shutdown()
    reports = []
    for n in NODES:
        text = cluster.log_path(n).read_text(errors="replace")
        for marker in native.SAN_MARKERS[san]:
            if marker in text:
                reports += [ln for ln in text.splitlines()
                            if marker in ln][:5]
    assert not reports, f"{san} reports in server logs: {reports}"
