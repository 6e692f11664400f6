"""The port's local tier: real raft_server processes on localhost.

The native tier builds from the repository's `native/src` with its own
Makefile into ``native/build-torch/`` (never the reference's
``native/build/``), under a lock that holds across processes. A 3-node
`test --deploy local` runs under each of kill, pause, partition and
member (and all four at once), checked on the CPU, and must verify; no
raft_server it started may outlive it, also when the run fails after
the nodes are up. Multi-second by nature, so marked `slow`, as the
reference's tests/test_native_cluster.py and tests/test_cli.py are."""

import json
import os
import threading
import time
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch import cli, native
from jepsen_jgroups_raft_tpu_torch.client.errors import NotLeader
from jepsen_jgroups_raft_tpu_torch.core import runner
from jepsen_jgroups_raft_tpu_torch.core.serve import _run_dirs
from jepsen_jgroups_raft_tpu_torch.deploy.local import (BlockNet,
                                                        LocalCluster,
                                                        LocalRaftDB,
                                                        wait_for_port)
from jepsen_jgroups_raft_tpu_torch.native.client import NativeRsmConn

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

NODES = ["n1", "n2", "n3"]


def servers() -> set:
    """Pids of live processes running the port's raft_server."""
    out = set()
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            argv0 = (d / "cmdline").read_bytes().split(b"\0")[0]
        except OSError:
            continue
        if argv0.decode(errors="replace") == str(native.SERVER_BIN):
            out.add(int(d.name))
    return out


def test_builds_into_build_torch_under_a_process_lock():
    native.ensure_built()
    assert native.BUILD_DIR == native.NATIVE_DIR / "build-torch"
    for t in native.TARGETS:
        assert t.exists() and t.parent == native.BUILD_DIR
    assert (native.BUILD_DIR / ".build.lock").exists()
    # a second call in the process is a no-op, and concurrent callers
    # serialize
    errs = []

    def again():
        try:
            native.ensure_built()
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    ts = [threading.Thread(target=again) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs


def test_map_ops_and_a_partition_through_the_block_hook(tmp_path):
    before = servers()
    c = LocalCluster(NODES, sm="map", workdir=str(tmp_path / "sut"),
                     election_ms=150, heartbeat_ms=50,
                     repl_timeout_ms=3000)
    try:
        for n in NODES:
            c.start_node(n, NODES, wait=False)
        for n in NODES:
            wait_for_port(*c.resolve(n))
        assert len(servers() - before) == 3
        conn = NativeRsmConn(*c.resolve("n2"), 2.0)  # a follower or not
        for _ in range(100):
            try:
                conn.put(1, 7)
                break
            except (OSError, NotLeader):  # the first election
                time.sleep(0.1)
        assert conn.get(1) == 7
        assert conn.cas(1, 7, 8) and not conn.cas(1, 7, 9)
        conn.close()
        test = {"nodes": NODES, "members": set(NODES)}
        BlockNet(c).partition(test, {"n1": {"n2", "n3"},
                                     "n2": {"n1"}, "n3": {"n1"}})
        BlockNet(c).heal(test)
        assert LocalRaftDB(c).primaries(test)
    finally:
        c.shutdown()
    assert not (servers() - before)


@pytest.mark.parametrize("workload,nemesis", [
    ("single-register", "kill"), ("single-register", "pause"),
    ("single-register", "partition"), ("single-register", "member"),
    ("counter", "hell")])
def test_cli_local_run_verifies_and_leaves_no_server(workload, nemesis,
                                                     tmp_path, capsys):
    """The stats checker wants an ok of every op kind (jepsen's rule):
    the first fault waits an interval, so the start of the run is
    clean."""
    before = servers()
    store = tmp_path / "store"
    rc = cli.main([
        "test", "--workload", workload, "--deploy", "local",
        "--nemesis", nemesis, "--device", "cpu", "--seed", "3",
        "--node", "n1", "--node", "n2", "--node", "n3",
        "--time-limit", "4", "--quiesce", "0.5", "--rate", "30",
        "--interval", "1", "--concurrency", "4",
        "--operation-timeout", "2", "--election-ms", "150",
        "--heartbeat-ms", "50", "--repl-timeout-ms", "3000",
        "--store", str(store)])
    out = capsys.readouterr().out
    runs = _run_dirs(store)
    res = json.loads((runs[0] / "results.json").read_text()) if runs else {}
    assert rc == 0, json.dumps(res, default=str)[:3000] + out[-2000:]
    assert len(runs) == 1 and res["valid?"] is True
    hist = [json.loads(x) for x in
            (runs[0] / "history.jsonl").read_text().splitlines()]
    assert any(op["process"] == "nemesis" for op in hist)
    assert any(op["type"] == "ok" and op["process"] != "nemesis"
               for op in hist)
    assert not (servers() - before)


def test_a_failing_run_still_kills_its_servers(tmp_path, monkeypatch):
    before = servers()
    started = []

    def fail_after_setup(test):
        for n in test["nodes"]:
            test["db"].setup(test, n)
        started.extend(servers() - before)
        raise RuntimeError("the run failed after the nodes were up")

    monkeypatch.setattr(runner, "run_test", fail_after_setup)
    with pytest.raises(RuntimeError, match="nodes were up"):
        cli.main(["test", "--deploy", "local", "--device", "cpu",
                  "--node", "n1", "--node", "n2", "--node", "n3",
                  "--election-ms", "150", "--heartbeat-ms", "50",
                  "--store", str(tmp_path / "store")])
    assert len(started) == 3
    assert not (servers() - before)
    assert all(not os.path.exists(f"/proc/{p}") or
               Path(f"/proc/{p}/stat").read_text().split()[2] == "Z"
               for p in started)
