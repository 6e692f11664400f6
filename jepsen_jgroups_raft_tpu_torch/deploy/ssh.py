"""SSH deployment tier: run the native SUT on real remote hosts (a copy
of the reference's `deploy/ssh.py` over the port's native tier, whose
server binary is built into ``native/build-torch/``).

Capability equivalent of the reference's remote-control surface
(jepsen.control + control.util, SURVEY.md §2.3): exec/upload over
ssh/scp subprocesses, daemonized server start with pid files
(cu/start-daemon! analogue, server.clj:147-156), loop-kill
(definitely-stop!, server.clj:119-127), SIGSTOP pause (grepkill!,
server.clj:221-222), and iptables partitions (jepsen.net's grudge
strategy) — management of a dedicated chain so healing never disturbs
other firewall rules.

Command construction is pure (module-level functions) so the control
logic is unit-testable without hosts; SshRemote is the thin executor.
Nodes are hostnames; the client port is fixed at 9000 like the
reference's hardcoded endpoint (server.clj:124,143,160), peers on 9100.
"""

from __future__ import annotations

import shlex
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from ..core.db import Net
from ..native import SERVER_BIN, ensure_built
from ..native.client import CONN_ERRORS, NativeConn, make_conn_factory
from .base import RaftDB

REMOTE_DIR = "/opt/raft"          # install dir (server.clj:25-32)
REMOTE_BIN = f"{REMOTE_DIR}/raft_server"
REMOTE_LOG = f"{REMOTE_DIR}/server.log"
REMOTE_PID = f"{REMOTE_DIR}/server.pid"
CLIENT_PORT = 9000
PEER_PORT = 9100
CHAIN = "JGRAFT_NEMESIS"          # dedicated iptables chain


def _paths(remote_dir: str):
    """(bin, log, pid) under a remote install dir — parameterized so a
    test tier can point nodes at a scratch dir instead of /opt/raft."""
    return (f"{remote_dir}/raft_server", f"{remote_dir}/server.log",
            f"{remote_dir}/server.pid")


# ---------------------------------------------------------------- commands
# Pure builders: each returns a shell line to run ON THE NODE.

def start_daemon_cmd(name: str, members_arg: str, sm: str,
                     election_ms: int, heartbeat_ms: int,
                     repl_timeout_ms: int,
                     remote_dir: str = REMOTE_DIR,
                     compact_every: int = 0) -> str:
    """Daemonize with nohup + pid file + log redirect (start-daemon!
    analogue). Idempotent: refuses if the pid file points at a live
    process (server.clj:143-146)."""
    rbin, rlog, rpid = _paths(remote_dir)
    argv = [
        rbin, "--name", name, "--members", members_arg, "--sm", sm,
        "--log-dir", f"{remote_dir}/raftlog",
        "--election-ms", str(election_ms),
        "--heartbeat-ms", str(heartbeat_ms),
        "--repl-timeout-ms", str(repl_timeout_ms)]
    if compact_every:
        argv += ["--compact-every", str(compact_every)]
    args = " ".join(shlex.quote(a) for a in argv)
    return (f"mkdir -p {remote_dir}/raftlog; "
            f"if [ -f {rpid} ] && kill -0 $(cat {rpid}) "
            f"2>/dev/null; then echo already-running; else "
            f"nohup {args} >> {rlog} 2>&1 & echo $! > {rpid}; "
            f"echo started; fi")


def kill_cmd(remote_dir: str = REMOTE_DIR) -> str:
    """SIGKILL until gone (definitely-stop! loop, server.clj:119-127)."""
    rpid = _paths(remote_dir)[2]
    return (f"if [ -f {rpid} ]; then "
            f"for i in $(seq 1 50); do "
            f"kill -0 $(cat {rpid}) 2>/dev/null || break; "
            f"kill -9 $(cat {rpid}) 2>/dev/null; sleep 0.1; done; "
            f"rm -f {rpid}; fi; echo killed")


def pause_cmd(remote_dir: str = REMOTE_DIR) -> str:
    return f"kill -STOP $(cat {_paths(remote_dir)[2]}); echo paused"


def resume_cmd(remote_dir: str = REMOTE_DIR) -> str:
    return f"kill -CONT $(cat {_paths(remote_dir)[2]}); echo resumed"


def teardown_cmd(remote_dir: str = REMOTE_DIR) -> str:
    """Remove binary + logs (server.clj:175-179)."""
    return f"rm -rf {remote_dir}; echo cleaned"


def iptables_setup_cmds() -> List[str]:
    """Create the dedicated chain and hook it into INPUT (idempotent)."""
    return [
        f"iptables -N {CHAIN} 2>/dev/null || true",
        f"iptables -C INPUT -j {CHAIN} 2>/dev/null || "
        f"iptables -I INPUT -j {CHAIN}",
    ]


def iptables_partition_cmds(enemies: Iterable[str]) -> List[str]:
    """DROP all packets from each enemy host — run on the grudge-holding
    node; with the same grudge mirrored on the enemy side this is the
    bidirectional cut jepsen's partitioner produces."""
    return [f"iptables -A {CHAIN} -s {shlex.quote(e)} -j DROP"
            for e in sorted(set(enemies))]


def iptables_heal_cmds() -> List[str]:
    return [f"iptables -F {CHAIN} 2>/dev/null || true"]


# ---------------------------------------------------------------- executor

class SshRemote:
    """Thin ssh/scp wrapper (jepsen.control's exec/upload)."""

    def __init__(self, host: str, user: str = "root",
                 key: Optional[str] = None, connect_timeout: int = 10):
        self.host = host
        self.user = user
        self.key = key
        self.connect_timeout = connect_timeout

    def _ssh_base(self) -> List[str]:
        cmd = ["ssh", "-o", "StrictHostKeyChecking=no",
               "-o", "UserKnownHostsFile=/dev/null",
               "-o", f"ConnectTimeout={self.connect_timeout}"]
        if self.key:
            cmd += ["-i", self.key]
        cmd.append(f"{self.user}@{self.host}")
        return cmd

    def exec(self, shell_line: str, check: bool = True,
             timeout: float = 60.0) -> subprocess.CompletedProcess:
        proc = subprocess.run(self._ssh_base() + [shell_line],
                              capture_output=True, text=True,
                              timeout=timeout)
        if check and proc.returncode != 0:
            raise RuntimeError(
                f"ssh {self.host}: {shell_line!r} failed "
                f"({proc.returncode}): {proc.stderr.strip()}")
        return proc

    def upload(self, local: str, remote: str, timeout: float = 120.0) -> None:
        cmd = ["scp", "-o", "StrictHostKeyChecking=no",
               "-o", "UserKnownHostsFile=/dev/null"]
        if self.key:
            cmd += ["-i", self.key]
        cmd += [local, f"{self.user}@{self.host}:{remote}"]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"scp to {self.host} failed: "
                               f"{proc.stderr.strip()}")

    def download(self, remote: str, local: str,
                 timeout: float = 120.0) -> bool:
        cmd = ["scp", "-o", "StrictHostKeyChecking=no",
               "-o", "UserKnownHostsFile=/dev/null"]
        if self.key:
            cmd += ["-i", self.key]
        cmd += [f"{self.user}@{self.host}:{remote}", local]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        return proc.returncode == 0


# ---------------------------------------------------------------- cluster

class RemoteRaftCluster:
    """Remote-host cluster: node names ARE hostnames (the reference's
    --nodes-file model, doc/running.md:88)."""

    def __init__(self, nodes: Iterable[str], sm: str = "map",
                 ssh_user: str = "root", ssh_key: Optional[str] = None,
                 election_ms: int = 300, heartbeat_ms: int = 100,
                 repl_timeout_ms: int = 30000,
                 log_download_dir: Optional[str] = None,
                 remote_dir: str = REMOTE_DIR,
                 client_port: int = CLIENT_PORT,
                 peer_port: int = PEER_PORT,
                 compact_every: int = 0):
        ensure_built()
        self.nodes = list(nodes)
        self.sm = sm
        self.remote_dir = remote_dir
        self.client_port = client_port
        self.peer_port = peer_port
        self.election_ms = election_ms
        self.heartbeat_ms = heartbeat_ms
        self.repl_timeout_ms = repl_timeout_ms
        self.compact_every = compact_every
        self.remotes: Dict[str, SshRemote] = {
            n: SshRemote(n, user=ssh_user, key=ssh_key) for n in self.nodes}
        self.installed: set = set()
        self.log_download_dir = Path(log_download_dir or "store/node-logs")

    def remote(self, node: str) -> SshRemote:
        if node not in self.remotes:
            r0 = next(iter(self.remotes.values()))
            self.remotes[node] = SshRemote(node, user=r0.user, key=r0.key)
        return self.remotes[node]

    def spec(self, name: str) -> str:
        return f"{name}={name}:{self.client_port}:{self.peer_port}"

    def members_arg(self, names: Iterable[str]) -> str:
        return ",".join(self.spec(n) for n in sorted(set(names)))

    def resolve(self, name: str) -> Tuple[str, int]:
        return name, self.client_port

    def install(self, node: str) -> None:
        """Upload the server binary (install-server!, server.clj:60-65).
        The binary is built once on the control node (build-server!
        analogue — ensure_built in __init__)."""
        if node in self.installed:
            return
        r = self.remote(node)
        rbin = _paths(self.remote_dir)[0]
        r.exec(f"mkdir -p {self.remote_dir}")
        r.upload(str(SERVER_BIN), rbin)
        r.exec(f"chmod +x {rbin}")
        for cmd in iptables_setup_cmds():
            r.exec(cmd, check=False)
        self.installed.add(node)

    def start_node(self, name: str, members: Iterable[str]) -> str:
        self.install(name)
        out = self.remote(name).exec(start_daemon_cmd(
            name, self.members_arg(set(members) | {name}), self.sm,
            self.election_ms, self.heartbeat_ms, self.repl_timeout_ms,
            remote_dir=self.remote_dir,
            compact_every=self.compact_every))
        return out.stdout.strip()

    def kill_node(self, name: str) -> None:
        self.remote(name).exec(kill_cmd(self.remote_dir), check=False)

    def pause_node(self, name: str) -> None:
        self.remote(name).exec(pause_cmd(self.remote_dir), check=False)

    def resume_node(self, name: str) -> None:
        self.remote(name).exec(resume_cmd(self.remote_dir), check=False)

    def probe(self, name: str, timeout: float = 2.0):
        conn = None
        try:
            conn = NativeConn(name, self.client_port, timeout)
            return conn.probe()
        except CONN_ERRORS:
            return None  # unreachable/rebooting node: no local view
        finally:
            if conn is not None:
                conn.close()

    def views_probe(self):
        from .base import collect_views
        return collect_views(self.probe, self.nodes)

    def admin(self, name: str, timeout: float = 15.0) -> NativeConn:
        return NativeConn(name, self.client_port, timeout)

    def conn_factory(self):
        return make_conn_factory(self.resolve)

    def shutdown(self) -> None:
        for n in self.nodes:
            try:
                self.kill_node(n)
            except (OSError, subprocess.SubprocessError):
                pass  # ssh unreachable/timed out: node is dying anyway


class RemoteRaftDB(RaftDB):
    """Same protocol surface as LocalRaftDB, over SSH. Aliveness for
    membership routing is probe reachability (the base default)."""

    def setup(self, test, node):
        super().setup(test, node)
        from .local import wait_for_port
        wait_for_port(node, self.cluster.client_port, timeout=30.0)

    def teardown(self, test, node):
        self.cluster.kill_node(node)
        self.cluster.remote(node).exec(teardown_cmd(self.cluster.remote_dir),
                                       check=False)
        self.cluster.installed.discard(node)

    def log_files(self, test, node):
        """Download the node's server.log (db/LogFiles, server.clj:181-183)
        into this run's store directory when one exists."""
        root = Path(test.get("store_dir") or self.cluster.log_download_dir)
        dest = root / "node-logs" / f"{node}-server.log"
        dest.parent.mkdir(parents=True, exist_ok=True)
        rlog = _paths(self.cluster.remote_dir)[1]
        if self.cluster.remote(node).download(rlog, str(dest)):
            return [str(dest)]
        return []


class IptablesNet(Net):
    """Real-packet partitions: DROP rules in the dedicated chain on both
    sides of the grudge (jepsen.net's bidirectional cut)."""

    def __init__(self, cluster: RemoteRaftCluster):
        self.cluster = cluster

    def partition(self, test, grudge: dict) -> None:
        for node, enemies in grudge.items():
            if not enemies:
                continue
            r = self.cluster.remote(node)
            for cmd in iptables_partition_cmds(enemies):
                try:
                    r.exec(cmd, check=False)
                except (OSError, subprocess.SubprocessError):
                    pass  # dead node is already cut off

    def heal(self, test) -> None:
        # Flush EVERY node, not just current members: a node removed from
        # membership while DROP rules were active would otherwise come back
        # permanently partitioned when re-added.
        nodes = set(test["nodes"]) | set(test.get("members") or ())
        for node in sorted(nodes):
            r = self.cluster.remote(node)
            for cmd in iptables_heal_cmds():
                try:
                    r.exec(cmd, check=False)
                except (OSError, subprocess.SubprocessError):
                    pass  # unreachable node heals when it returns
