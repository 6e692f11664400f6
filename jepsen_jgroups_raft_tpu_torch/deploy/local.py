"""Localhost multi-process cluster: the native SUT under real-fault tests.

Capability equivalent of the reference's Server DB record
(server.clj:164-222) with the docker/LXC node replaced by a local process:
  setup      → spawn raft_server with the member list (start-daemon
               analogue, server.clj:147-156), block on the client port
               (server.clj:158-161)
  kill       → SIGKILL until dead (definitely-stop!, server.clj:119-127)
  pause      → SIGSTOP / SIGCONT (grepkill! :stop/:cont, server.clj:221-222)
  primaries  → probe every member's local leader view, dedupe
               (server.clj:188-196); may return 2+ during partitions
  log files  → per-node server.log (server.clj:181-183)
  membership → consensus add/remove through an alive member — what the
               reference does by shelling the jgroups-raft CLI over SSH
               (membership.clj:22-35,57-60,96-98)

Partitions use the server's transport-level block hook (BlockNet): the same
bidirectional packet cut an iptables grudge produces, injectable without
root. (The reference's deploy.ssh, with its iptables path for real
multi-host clusters, is not ported yet.) A copy of the reference's
module over the port's native build (``native/build-torch/``).
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from ..core.db import Net
from ..native import SERVER_BIN, ensure_built
from ..native.client import CONN_ERRORS, NativeConn, make_conn_factory
from .base import RaftDB


def _free_ports(n: int) -> list:
    """`n` distinct free ports. All probe sockets stay OPEN until every
    port is collected: closing each probe before the next bind lets the
    kernel recycle a just-freed port into a later probe of the SAME
    allocation — a 120-run hell campaign dealt one 7-node cluster
    duplicate client ports exactly that way (the node
    died at bind and setup timed out)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            # adopt into the cleanup list BEFORE bind: a bind that
            # raises used to leak the just-created socket (created but
            # not yet listed — graftcheck flow-resource-leak finding).
            socks.append(s)
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()




def wait_for_port(host: str, port: int, timeout: float = 20.0) -> None:
    """Block until the node's client port accepts — the harness's
    "port bound implies the channel connected" liveness gate
    (server.clj:158-161, await 20 s server.clj:92-101)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((host, port), timeout=0.5):
                return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"port {host}:{port} not up after {timeout}s")


class LocalCluster:
    """Allocates ports, spawns/kills raft_server processes, and resolves
    node names for clients."""

    def __init__(self, names: Iterable[str], sm: str = "map",
                 workdir: Optional[str] = None, election_ms: int = 150,
                 heartbeat_ms: int = 50, repl_timeout_ms: int = 10000,
                 host: str = "127.0.0.1", server_bin: Optional[str] = None,
                 compact_every: int = 0):
        ensure_built()
        self.server_bin = str(server_bin or SERVER_BIN)
        self.host = host
        self.sm = sm
        self.election_ms = election_ms
        self.heartbeat_ms = heartbeat_ms
        self.repl_timeout_ms = repl_timeout_ms
        self.compact_every = compact_every
        self.workdir = Path(workdir or tempfile.mkdtemp(prefix="raft-sut-"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.ports: Dict[str, Tuple[int, int]] = {}
        self.procs: Dict[str, subprocess.Popen] = {}
        names = list(names)
        # One batched allocation: every probe socket held open until all
        # ports are dealt, so no two nodes of THIS batch can receive the
        # same port. Later batches (grow-added members) re-check against
        # the recorded ports in _alloc.
        ports = _free_ports(2 * len(names))
        for i, n in enumerate(names):
            self.ports[n] = (ports[2 * i], ports[2 * i + 1])

    def _alloc(self, name: str) -> None:
        if name in self.ports:
            return
        # Late-added member (grow nemesis): a fresh batch can be dealt a
        # port RECORDED for a currently-dead node (its sockets are
        # unbound, so the kernel may reuse them) — colliding the moment
        # the kill nemesis restarts that node. Retry until disjoint.
        taken = {p for pair in self.ports.values() for p in pair}
        for _ in range(64):
            pair = tuple(_free_ports(2))
            if not taken & set(pair):
                self.ports[name] = pair
                return
        raise RuntimeError(f"no ports disjoint from {sorted(taken)}")

    def spec(self, name: str) -> str:
        self._alloc(name)
        cport, pport = self.ports[name]
        return f"{name}={self.host}:{cport}:{pport}"

    def resolve(self, name: str) -> Tuple[str, int]:
        self._alloc(name)
        return self.host, self.ports[name][0]

    def log_path(self, name: str) -> Path:
        return self.workdir / f"{name}.log"

    # ---- lifecycle ------------------------------------------------------

    def running(self, name: str) -> bool:
        p = self.procs.get(name)
        return p is not None and p.poll() is None

    def start_node(self, name: str, members: Iterable[str],
                   wait: bool = True) -> str:
        """Idempotent start (skip if already running, server.clj:143-146).
        `members` is the node-name set; the member list passed to the
        daemon is members ∪ {self} (server.clj:136-140). Returns
        :already-running / :started for the Kill-protocol's restart
        classification (server.clj:199-214)."""
        if self.running(name):
            return "already-running"
        names = sorted(set(members) | {name})
        members_arg = ",".join(self.spec(n) for n in names)
        # `with`: a Popen that raises (missing/denied binary) used to
        # leak the log handle (graftcheck flow-resource-leak finding);
        # the spawned child keeps its own dup of the fd.
        with open(self.log_path(name), "ab") as log:
            self.procs[name] = subprocess.Popen(
                [self.server_bin, "--name", name, "--members", members_arg,
                 "--sm", self.sm, "--log-dir", str(self.workdir / "raftlog"),
                 "--election-ms", str(self.election_ms),
                 "--heartbeat-ms", str(self.heartbeat_ms),
                 "--repl-timeout-ms", str(self.repl_timeout_ms)]
                + (["--compact-every", str(self.compact_every)]
                   if self.compact_every else []),
                stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)
        if wait:
            wait_for_port(*((self.resolve(name))))
        return "started"

    def _signal(self, name: str, sig: int) -> None:
        p = self.procs.get(name)
        if p is not None and p.poll() is None:
            try:
                os.kill(p.pid, sig)
            except ProcessLookupError:
                pass

    def kill_node(self, name: str) -> None:
        """SIGKILL until the process is gone (definitely-stop! loop,
        server.clj:119-127)."""
        p = self.procs.get(name)
        if p is None:
            return
        for _ in range(50):
            if p.poll() is not None:
                break
            try:
                os.kill(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                break
            time.sleep(0.02)
        p.wait()

    def pause_node(self, name: str) -> None:
        self._signal(name, signal.SIGSTOP)

    def resume_node(self, name: str) -> None:
        self._signal(name, signal.SIGCONT)

    def shutdown(self) -> None:
        for n in list(self.procs):
            self.kill_node(n)

    # ---- admin plane ----------------------------------------------------

    def admin(self, name: str, timeout: float = 3.0) -> NativeConn:
        host, port = self.resolve(name)
        return NativeConn(host, port, timeout)

    def probe(self, name: str, timeout: float = 2.0):
        """(leader, term) as seen by `name`; None if unreachable."""
        conn = None
        try:
            conn = self.admin(name, timeout)
            return conn.probe()
        except CONN_ERRORS:
            return None  # unreachable/restarting node: no local view
        finally:
            if conn is not None:
                conn.close()

    def views_probe(self):
        from .base import collect_views
        return collect_views(self.probe, self.procs)

    def conn_factory(self):
        return make_conn_factory(self.resolve)


class LocalRaftDB(RaftDB):
    """DB/Kill/Pause/Primary/LogFiles protocols over a LocalCluster."""

    def _alive(self, node):
        return self.cluster.running(node)

    def teardown(self, test, node):
        self.cluster.kill_node(node)
        # remove jar+logs analogue (server.clj:175-179): drop the raft log so
        # the next test starts clean
        logdir = self.cluster.workdir / "raftlog" / node
        if logdir.exists():
            for p in logdir.iterdir():
                p.unlink()

    def log_files(self, test, node):
        p = self.cluster.log_path(node)
        return [str(p)] if p.exists() else []


class BlockNet(Net):
    """Partition via the servers' transport-level block hook — the
    observable equivalent of jepsen.net's iptables grudge (bidirectional
    packet drop between the grudge's node sets)."""

    def __init__(self, cluster: LocalCluster):
        self.cluster = cluster

    def partition(self, test, grudge: dict) -> None:
        for node, enemies in grudge.items():
            if not enemies:
                continue
            try:
                conn = self.cluster.admin(node)
            except CONN_ERRORS:
                continue  # dead node: already cut off
            try:
                conn.admin_block(enemies)
            except CONN_ERRORS:
                pass  # mid-fault node: its transport is already cut
            finally:
                conn.close()

    def heal(self, test) -> None:
        nodes = set(test.get("members") or test["nodes"]) | set(
            self.cluster.procs)
        for node in sorted(nodes):
            try:
                conn = self.cluster.admin(node)
            except CONN_ERRORS:
                continue  # dead node: nothing to heal
            try:
                conn.admin_unblock()
            except CONN_ERRORS:
                pass  # node died mid-heal; restart clears blocks
            finally:
                conn.close()
