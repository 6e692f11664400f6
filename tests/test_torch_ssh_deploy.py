"""The port's ssh deployment tier (`jepsen_jgroups_raft_tpu_torch/deploy/
ssh.py`, ``test --deploy ssh``), held against the reference's
`deploy/ssh.py`.

Every pure command builder returns the reference's string byte for
byte; `SshRemote` hands `subprocess.run` the reference's ssh and scp
argv; `IptablesNet` sends each node the reference's lines for the same
grudge; `RemoteRaftCluster`'s install, start, kill, pause and resume and
`RemoteRaftDB`'s teardown send the reference's lines (the uploaded
binary is the port's own, ``native/build-torch/raft_server``), and
`log_files` gives the reference's path. The `slow` lifecycle tests run
the generated lines for real through `ssh`, `scp` and `iptables` shims on
PATH (the `iptables` shim only records its argv: the real firewall is
never touched): the reference's lifecycle on one node, then a whole
`compose_test`/`run_test` run whose history is checked on the CPU.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import time
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu.deploy import ssh as ref_ssh
from jepsen_jgroups_raft_tpu_torch import native
from jepsen_jgroups_raft_tpu_torch.deploy import ssh
from jepsen_jgroups_raft_tpu_torch.deploy.local import wait_for_port
from jepsen_jgroups_raft_tpu_torch.native.client import NativeRsmConn

from util import free_port

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

REMOTE_DIRS = [None, "/srv/jgraft raft"]
ENEMY_SETS = [set(), {"n2"}, {"n3", "n2"}, {"10.0.0.7", "n5", "n4"},
              {"host with space", "n1;rm -rf /"}]


def _dir_kw(remote_dir):
    return {} if remote_dir is None else {"remote_dir": remote_dir}


# ------------------------------------------------- the command builders


def test_constants_are_the_references():
    for name in ("REMOTE_DIR", "REMOTE_BIN", "REMOTE_LOG", "REMOTE_PID",
                 "CLIENT_PORT", "PEER_PORT", "CHAIN"):
        assert getattr(ssh, name) == getattr(ref_ssh, name), name


@pytest.mark.parametrize("compact_every", [0, 512])
@pytest.mark.parametrize("remote_dir", REMOTE_DIRS)
@pytest.mark.parametrize("members", ["n1=n1:9000:9100",
                                     "n1=n1:9000:9100,n2=n2:9000:9100"])
def test_start_daemon_cmd_is_the_references(compact_every, remote_dir,
                                            members):
    args = ("n1", members, "map", 300, 100, 30000)
    kw = dict(compact_every=compact_every, **_dir_kw(remote_dir))
    cmd = ssh.start_daemon_cmd(*args, **kw)
    assert cmd == ref_ssh.start_daemon_cmd(*args, **kw)
    assert ("--compact-every 512" in cmd) == (compact_every == 512)


@pytest.mark.parametrize("builder", ["kill_cmd", "pause_cmd", "resume_cmd",
                                     "teardown_cmd"])
@pytest.mark.parametrize("remote_dir", REMOTE_DIRS)
def test_lifecycle_cmds_are_the_references(builder, remote_dir):
    kw = _dir_kw(remote_dir)
    assert getattr(ssh, builder)(**kw) == getattr(ref_ssh, builder)(**kw)


@pytest.mark.parametrize("enemies", ENEMY_SETS, ids=range(len(ENEMY_SETS)))
def test_iptables_cmds_are_the_references(enemies):
    assert ssh.iptables_partition_cmds(enemies) == \
        ref_ssh.iptables_partition_cmds(enemies)
    assert ssh.iptables_setup_cmds() == ref_ssh.iptables_setup_cmds()
    assert ssh.iptables_heal_cmds() == ref_ssh.iptables_heal_cmds()


def test_builders_keep_the_references_shape():
    """tests/test_ssh_deploy.py's assertions, on the port."""
    cmd = ssh.start_daemon_cmd("n1", "n1=n1:9000:9100,n2=n2:9000:9100",
                               "map", 300, 100, 30000)
    assert "kill -0 $(cat " + ssh.REMOTE_PID + ")" in cmd
    assert "already-running" in cmd
    assert "nohup" in cmd and ssh.REMOTE_BIN in cmd
    assert "--sm map" in cmd and "--compact-every" not in cmd
    assert "echo $! > " + ssh.REMOTE_PID in cmd
    kill = ssh.kill_cmd()
    assert "kill -9" in kill and "seq 1 50" in kill
    assert "rm -f " + ssh.REMOTE_PID in kill
    assert "-STOP" in ssh.pause_cmd() and "-CONT" in ssh.resume_cmd()
    cmds = ssh.iptables_partition_cmds({"n2", "n3"})
    assert len(cmds) == 2
    assert all(ssh.CHAIN in c and "-j DROP" in c for c in cmds)
    assert ssh.iptables_heal_cmds() == [
        f"iptables -F {ssh.CHAIN} 2>/dev/null || true"]


# --------------------------------------------------------- the executor


class _Proc:
    def __init__(self, returncode=0):
        self.returncode = returncode
        self.stdout = "started\n"
        self.stderr = ""


def _record_runs(monkeypatch, calls, returncode=0):
    """`subprocess.run` faked: each call's argv and keywords recorded."""
    def run(argv, **kw):
        calls.append((list(argv), kw))
        return _Proc(returncode)

    monkeypatch.setattr(subprocess, "run", run)


@pytest.mark.parametrize("user,key", [("root", None), ("admin", "/k/id"),
                                      ("ops", "/keys/with space")])
def test_ssh_remote_argv_is_the_references(monkeypatch, user, key):
    runs = {}
    for name, mod in (("port", ssh), ("ref", ref_ssh)):
        calls = []
        _record_runs(monkeypatch, calls)
        r = mod.SshRemote("host1", user=user, key=key, connect_timeout=7)
        r.exec("echo hi; ls /opt/raft", check=True, timeout=12.0)
        r.upload("/tmp/raft_server", "/opt/raft/raft_server", timeout=30.0)
        assert r.download("/opt/raft/server.log", "/tmp/x.log") is True
        runs[name] = (r._ssh_base(), calls)
    assert runs["port"] == runs["ref"]
    base = runs["port"][0]
    assert base[0] == "ssh" and base[-1] == f"{user}@host1"
    assert ("-i" in base) == (key is not None)


def test_ssh_remote_failures_are_the_references(monkeypatch):
    calls = []
    _record_runs(monkeypatch, calls, returncode=5)
    r = ssh.SshRemote("h")
    with pytest.raises(RuntimeError, match="ssh h: 'false' failed"):
        r.exec("false")
    assert r.exec("false", check=False).returncode == 5
    with pytest.raises(RuntimeError, match="scp to h failed"):
        r.upload("/a", "/b")
    assert r.download("/a", "/b") is False


class _FakeRemote:
    """Records the lines and files an SshRemote would send."""

    def __init__(self, host, log):
        self.host = host
        self.log = log
        self.user, self.key = "root", None

    def exec(self, line, check=True, timeout=60.0):
        self.log.append((self.host, "exec", line, check))
        return _Proc()

    def upload(self, local, remote, timeout=120.0):
        self.log.append((self.host, "upload", Path(local).name, remote))

    def download(self, remote, local, timeout=120.0):
        self.log.append((self.host, "download", remote))
        Path(local).write_text("log")
        return True


class _FakeCluster:
    def __init__(self, mod, log, remote_dir=None, download_dir="dl"):
        self.remote_dir = remote_dir or mod.REMOTE_DIR
        self.log_download_dir = Path(download_dir)
        self.client_port = mod.CLIENT_PORT
        self.installed = set()
        self.log = log

    def remote(self, node):
        return _FakeRemote(node, self.log)

    def kill_node(self, node):
        self.log.append((node, "kill"))


GRUDGES = [{"n1": {"n2", "n3"}, "n2": {"n1"}, "n3": {"n1"}},
           {"n1": set(), "n2": {"n4"}},
           {"n5": {"n1", "n2", "n3", "n4"}}]


@pytest.mark.parametrize("grudge", GRUDGES, ids=range(len(GRUDGES)))
def test_iptables_net_sends_the_references_lines(grudge):
    test = {"nodes": ["n1", "n2", "n3", "n4", "n5"],
            "members": {"n1", "n2", "n6"}}
    sent = {}
    for name, mod in (("port", ssh), ("ref", ref_ssh)):
        log = []
        net = mod.IptablesNet(_FakeCluster(mod, log))
        net.partition(test, grudge)
        net.heal(test)
        sent[name] = log
    assert sent["port"] == sent["ref"]
    assert ("n6", "exec", ssh.iptables_heal_cmds()[0], False) in \
        sent["port"]


@pytest.mark.parametrize("remote_dir", REMOTE_DIRS)
@pytest.mark.parametrize("store_dir", [None, "run"])
def test_log_files_and_teardown_are_the_references(tmp_path, remote_dir,
                                                   store_dir):
    out = {}
    for name, mod in (("port", ssh), ("ref", ref_ssh)):
        log = []
        root = tmp_path / name
        cluster = _FakeCluster(mod, log, remote_dir,
                               download_dir=str(root / "dl"))
        db = mod.RemoteRaftDB(cluster)
        test = {"store_dir": str(root / store_dir) if store_dir else None}
        files = [str(Path(f).relative_to(root))
                 for f in db.log_files(test, "n1")]
        db.teardown(test, "n1")
        out[name] = (files, log)
    assert out["port"] == out["ref"]
    assert out["port"][0] == [
        str(Path(store_dir or "dl") / "node-logs" / "n1-server.log")]


def _cluster(mod, monkeypatch, log, **kw):
    monkeypatch.setattr(mod, "ensure_built", lambda: None)
    monkeypatch.setattr(mod, "SshRemote",
                        lambda host, user="root", key=None: _FakeRemote(
                            host, log))
    return mod.RemoteRaftCluster(["n1", "n2", "n3"], **kw)


@pytest.mark.parametrize("kw", [{}, {"sm": "counter", "compact_every": 512,
                                     "remote_dir": "/srv/r",
                                     "client_port": 9300,
                                     "peer_port": 9400,
                                     "election_ms": 150,
                                     "heartbeat_ms": 50,
                                     "repl_timeout_ms": 3000}])
def test_cluster_sends_the_references_lines(monkeypatch, kw):
    out = {}
    for name, mod in (("port", ssh), ("ref", ref_ssh)):
        log = []
        c = _cluster(mod, monkeypatch, log, **kw)
        got = [c.start_node("n1", ["n1", "n2"]),
               c.start_node("n2", ["n1", "n2", "n3"]),
               c.members_arg(["n3", "n1", "n1"]), c.resolve("n2"),
               c.spec("n3")]
        c.pause_node("n1")
        c.resume_node("n1")
        c.kill_node("n2")
        c.shutdown()
        out[name] = (got, log)
    assert out["port"] == out["ref"]


def test_install_uploads_the_ports_binary(monkeypatch):
    log = []
    c = _cluster(ssh, monkeypatch, log)
    uploads = []
    monkeypatch.setattr(_FakeRemote, "upload",
                        lambda self, local, remote, timeout=120.0:
                        uploads.append((local, remote)))
    c.install("n1")
    c.install("n1")  # once a node
    assert uploads == [(str(native.SERVER_BIN), f"{ssh.REMOTE_DIR}/"
                        "raft_server")]
    assert native.SERVER_BIN.parent.name == "build-torch"


# ----------------------------------------- the lifecycle, through shims


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _load(ROOT / "chip_smoke.py", "chip_smoke")


def test_chip_smokes_shims_are_the_references(chip_smoke):
    """The ssh and scp shims of chip_smoke.py's ssh arm are those of
    tests/test_ssh_integration.py; its iptables shim records argv and
    runs nothing."""
    ref = _load(ROOT / "tests" / "test_ssh_integration.py",
                "ref_ssh_integration")
    assert chip_smoke.SSH_SHIM == ref.SSH_SHIM
    assert chip_smoke.SCP_SHIM == ref.SCP_SHIM
    body = chip_smoke.iptables_shim("/x/log")
    assert "subprocess" not in body and "os.system" not in body


def test_iptables_lines_follow_the_builders(chip_smoke):
    """What the shim records for a builder's line: its first command's
    argv (the shim exits 0, so an ``||`` branch never runs)."""
    assert [chip_smoke.iptables_argv(c) for c in
            ssh.iptables_setup_cmds()] == [
        ["-N", ssh.CHAIN], ["-C", "INPUT", "-j", ssh.CHAIN]]
    assert chip_smoke.iptables_argv(
        ssh.iptables_partition_cmds({"h 2"})[0]) == \
        ["-A", ssh.CHAIN, "-s", "h 2", "-j", "DROP"]


@pytest.fixture
def shimmed(tmp_path, monkeypatch, chip_smoke):
    shim_dir = tmp_path / "shims"
    log = tmp_path / "iptables.log"
    chip_smoke.write_shims(shim_dir, log)
    monkeypatch.setenv("PATH", f"{shim_dir}:{os.environ['PATH']}")
    return log


@pytest.mark.slow
def test_ssh_tier_full_lifecycle_executes(tmp_path, shimmed, chip_smoke):
    """tests/test_ssh_integration.py's lifecycle on the port: install,
    daemonized start, client traffic, pause and resume, loop-kill and a
    crash-recovery restart, log download, teardown; the iptables lines
    the install sent are the builders'."""
    remote_dir = str(tmp_path / "opt-raft")
    cluster = ssh.RemoteRaftCluster(
        ["127.0.0.1"], sm="map", remote_dir=remote_dir,
        client_port=free_port(), peer_port=free_port(),
        election_ms=150, heartbeat_ms=50, repl_timeout_ms=3000,
        log_download_dir=str(tmp_path / "logs"))
    node = "127.0.0.1"
    db = ssh.RemoteRaftDB(cluster)
    test = {"nodes": [node], "members": {node},
            "store_dir": str(tmp_path / "store")}
    os.makedirs(test["store_dir"])

    def await_leader(timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            v = cluster.probe(node, timeout=1.0)
            if v is not None and v[0]:
                return
            time.sleep(0.05)
        raise TimeoutError("no leader elected")

    try:
        assert db.setup(test, node) is None
        assert (tmp_path / "opt-raft" / "server.pid").exists()
        assert cluster.start_node(node, [node]) == "already-running"
        await_leader()
        conn = NativeRsmConn(*cluster.resolve(node), timeout=3.0)
        try:
            conn.put(1, 42)
            assert conn.get(1) == 42
            db.pause(test, node)
            with pytest.raises(Exception):
                NativeRsmConn(*cluster.resolve(node), timeout=0.6).get(1)
            db.resume(test, node)
            assert conn.get(1) == 42
        finally:
            conn.close()
        db.kill(test, node)
        time.sleep(0.2)
        assert cluster.start_node(node, [node]) == "started"
        wait_for_port(*cluster.resolve(node), timeout=15.0)
        conn = NativeRsmConn(*cluster.resolve(node), timeout=3.0)
        try:
            deadline = time.monotonic() + 10.0
            val = None
            while time.monotonic() < deadline:
                try:
                    val = conn.get(1)
                    break
                except Exception:
                    time.sleep(0.2)
            assert val == 42
        finally:
            conn.close()
        files = db.log_files(test, node)
        assert files and os.path.getsize(files[0]) > 0
        ssh.IptablesNet(cluster).partition(test, {node: {"10.255.0.1"}})
        ssh.IptablesNet(cluster).heal(test)
        db.teardown(test, node)
        assert not (tmp_path / "opt-raft").exists()
    finally:
        cluster.shutdown()
    recorded = [json.loads(x) for x in shimmed.read_text().splitlines()]
    assert recorded == [chip_smoke.iptables_argv(c) for c in (
        *ssh.iptables_setup_cmds(),
        *ssh.iptables_partition_cmds({"10.255.0.1"}),
        *ssh.iptables_heal_cmds())]


@pytest.mark.slow
def test_ssh_tier_runs_a_test_checked_on_the_cpu(tmp_path, shimmed,
                                                 chip_smoke):
    """chip_smoke.py's ssh arm on the CPU: one node through `compose_test`
    and `run_test` under kill and pause; VALID, a node log downloaded,
    the iptables lines the builders', no raft_server left."""
    res = chip_smoke.run_ssh_arm(tmp_path, device="cpu", time_limit=4.0)
    assert res["valid?"] is True
    assert res["log_bytes"] > 0
    assert res["iptables_match"] is True
    assert res["left"] == 0
    assert (Path(res["run"]) / "history.jsonl").stat().st_size > 0
