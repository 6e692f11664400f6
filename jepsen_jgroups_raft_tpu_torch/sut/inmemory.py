"""In-process linearizable SUT with fault injection.

A single-copy state machine (register map / counter / leadership record)
applied under one lock — trivially linearizable, so any checker failure
against it is a checker bug, and any injected fault produces an *honest*
history (a timed-out op really may apply later: it keeps executing on the
server executor after the client gives up — the same indefinite semantics
the reference gets from real networks, workload/client.clj:52-63).

Connection API is shaped like the reference's sync clients
(SyncReplicatedStateMachineClient / SyncReplicatedCounterClient /
SyncLeaderInspectionClient — SURVEY.md §2.2 J7-J9), so workloads run
unchanged against this or the native TCP tier.

Fault hooks (driven by nemeses or latency plans):
  * kill(node)/restart(node)  — connections to killed nodes refuse
    (definite errors).
  * pause(node)/resume(node)  — ops through paused nodes block until
    resume (client times out; op applies on resume → indefinite).
  * partition(grudge)/heal()  — ops through nodes that cannot reach a
    quorum block until heal (client times out; op applies on heal →
    indefinite); leadership moves to the quorum side; isolated nodes
    report a stale leader/term view until healed.
  * add_node/remove_node      — runtime membership change (the member
    nemesis, reference nemesis/membership.clj).
  * latency spikes            — LatencyPlan.slow_prob makes ops exceed the
    client timeout while still applying.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeout
from dataclasses import dataclass
from typing import Optional, Tuple

from ..client.errors import ClientTimeout, ConnectFailed


@dataclass
class LatencyPlan:
    base: float = 0.0002       # fixed per-op latency (s)
    jitter: float = 0.0003     # mean of added exponential jitter
    slow_prob: float = 0.0     # chance of a timeout-inducing stall
    slow_s: float = 0.5        # stall duration
    seed: Optional[int] = None


class InMemoryCluster:
    def __init__(self, nodes, latency: Optional[LatencyPlan] = None,
                 initial_leader: Optional[str] = None):
        self.nodes = list(nodes)
        self.plan = latency or LatencyPlan()
        self.rng = random.Random(self.plan.seed)
        self.lock = threading.Lock()
        self.map: dict = {}
        self.counters: dict = {}
        self.term = 1
        self.leader = initial_leader or self.nodes[0]
        self.killed: set = set()
        self.resume_events = {n: threading.Event() for n in self.nodes}
        for e in self.resume_events.values():
            e.set()  # not paused
        #: node -> set of nodes it cannot talk to (symmetric by contract).
        self.grudge: dict = {}
        #: isolated node -> (leader, term) snapshot from partition time.
        self.stale_views: dict = {}
        self.heal_event = threading.Event()
        self.heal_event.set()  # not partitioned
        self.pool = ThreadPoolExecutor(max_workers=64,
                                       thread_name_prefix="sut")
        self.closed = False

    # ---- fault hooks (the nemesis side) ---------------------------------

    def kill(self, node: str) -> None:
        with self.lock:
            self.killed.add(node)
            if self.leader == node:
                self._elect_locked()

    def restart(self, node: str) -> None:
        with self.lock:
            self.killed.discard(node)
            if self.leader is None:
                self._elect_locked()

    def pause(self, node: str) -> None:
        self.resume_events[node].clear()
        if self.leader == node:
            with self.lock:
                self._elect_locked()

    def resume(self, node: str) -> None:
        self.resume_events[node].set()

    def partition(self, grudge: dict) -> None:
        """Install a grudge map (node -> unreachable peers). A node that can
        no longer see a quorum cannot commit: its ops block until heal. If
        the leader lost quorum, the quorum side elects a new leader; nodes
        without quorum keep serving their pre-partition leader/term view
        (stale, but election-safe: old term -> old leader)."""
        with self.lock:
            snapshot = (self.leader, self.term)
            self.grudge = {n: set(g) for n, g in grudge.items()}
            self.stale_views = {
                n: snapshot for n in self.nodes if not self._quorum_locked(n)
            }
            if self.leader is not None and self.leader in self.stale_views:
                self._elect_locked()
            if self.stale_views:
                self.heal_event.clear()
            elif self.grudge:
                # Every node retains quorum (e.g. majorities-ring): no
                # availability change, but the disruption still triggers
                # an election round, like a real view change would.
                self._elect_locked()

    def heal(self) -> None:
        with self.lock:
            self.grudge = {}
            self.stale_views = {}
            if self.leader is None:
                self._elect_locked()
        self.heal_event.set()

    def add_node(self, node: str) -> None:
        with self.lock:
            if node in self.nodes:
                return
            self.nodes.append(node)
            # Reuse any prior Event: a server thread from the node's
            # earlier life may still be blocked on it, and replacing the
            # object would strand that thread beyond resume/shutdown.
            ev = self.resume_events.setdefault(node, threading.Event())
            ev.set()

    def remove_node(self, node: str) -> None:
        with self.lock:
            if node not in self.nodes:
                return
            self.nodes.remove(node)
            self.killed.discard(node)
            self.stale_views.pop(node, None)
            if self.leader == node:
                self._elect_locked()

    def _quorum_locked(self, node: str) -> bool:
        """Can `node` reach a strict majority of the current membership
        (itself included) under the installed grudge?"""
        n = len(self.nodes)
        visible = [m for m in self.nodes
                   if m == node or m not in self.grudge.get(node, ())]
        return len(visible) > n // 2

    def _elect_locked(self) -> None:
        alive = [n for n in self.nodes
                 if n not in self.killed and self.resume_events[n].is_set()
                 and self._quorum_locked(n)]
        self.term += 1
        self.leader = self.rng.choice(alive) if alive else None

    def elect(self, node: Optional[str] = None) -> None:
        with self.lock:
            if node is None:
                self._elect_locked()
            else:
                self.term += 1
                self.leader = node

    def shutdown(self) -> None:
        self.closed = True
        for e in self.resume_events.values():
            e.set()
        self.heal_event.set()
        self.pool.shutdown(wait=False, cancel_futures=True)

    # ---- server side ----------------------------------------------------

    def _apply(self, node: str, fn, local: bool):
        """Simulated server-side execution: latency, pause gate, partition
        gate (consensus ops only), then the linearization point under the
        cluster lock. `local` ops (leader inspection, dirty reads) skip the
        quorum requirement — they answer from node-local state, like the
        reference's LeaderElection SM (SURVEY.md J5) and dirty reads."""
        d = self.plan.base + self.rng.expovariate(1.0 / self.plan.jitter) \
            if self.plan.jitter > 0 else self.plan.base
        if self.plan.slow_prob and self.rng.random() < self.plan.slow_prob:
            d += self.plan.slow_s
        time.sleep(d)
        ev = self.resume_events.get(node)
        if ev is not None:
            ev.wait()
        while True:
            if self.closed:
                raise ConnectFailed("cluster shut down")
            with self.lock:
                if node in self.killed:
                    raise ConnectFailed(f"{node} is down")
                if node not in self.nodes:
                    raise ConnectFailed(f"{node} is not a member")
                if local or self._quorum_locked(node):
                    return fn()
            # No quorum: the op waits out the partition (the client will
            # time out; the op applies on heal — honest indefiniteness).
            self.heal_event.wait(timeout=0.05)

    def submit(self, node: str, fn, timeout: float, local: bool = False):
        if self.closed:
            raise ConnectFailed("cluster shut down")
        if node in self.killed:
            raise ConnectFailed(f"{node} is down")
        fut = self.pool.submit(self._apply, node, fn, local)
        try:
            return fut.result(timeout)
        except FutTimeout:
            # The op keeps running server-side: honest indefiniteness.
            raise ClientTimeout(f"no response from {node} in {timeout}s")

    # ---- client connections (J7/J8/J9-shaped) ---------------------------

    def conn(self, node: str, kind: str, timeout: float = 5.0):
        if kind == "register":
            return RsmConn(self, node, timeout)
        if kind == "counter":
            return CounterConn(self, node, timeout)
        if kind == "election":
            return LeaderConn(self, node, timeout)
        raise ValueError(f"unknown connection kind {kind!r}")


class _Conn:
    def __init__(self, cluster: InMemoryCluster, node: str, timeout: float):
        self.cluster = cluster
        self.node = node
        self.timeout = timeout

    def _do(self, fn, local: bool = False):
        return self.cluster.submit(self.node, fn, self.timeout, local=local)

    def close(self) -> None:
        pass


class RsmConn(_Conn):
    """Replicated-map connection: put / quorum-or-dirty get / cas."""

    def put(self, key, value) -> None:
        self._do(lambda: self.cluster.map.__setitem__(key, value))

    def get(self, key, quorum: bool = True):
        # Single-copy: a dirty read returns the same value as a quorum
        # read, but it skips the quorum gate — so it still answers from a
        # partition-isolated node, like the native tier's local reads.
        return self._do(lambda: self.cluster.map.get(key), local=not quorum)

    def cas(self, key, frm, to) -> bool:
        def go():
            if self.cluster.map.get(key) == frm:
                self.cluster.map[key] = to
                return True
            return False
        return self._do(go)


class CounterConn(_Conn):
    """Counter connection; one named counter, like the reference client's
    fixed "mtc" (SyncReplicatedCounterClient, SURVEY.md J8)."""

    name = "mtc"

    def get(self) -> int:
        return self._do(lambda: self.cluster.counters.get(self.name, 0))

    def add(self, delta: int) -> None:
        def go():
            self.cluster.counters[self.name] = (
                self.cluster.counters.get(self.name, 0) + delta)
        self._do(go)

    def add_and_get(self, delta: int) -> int:
        def go():
            v = self.cluster.counters.get(self.name, 0) + delta
            self.cluster.counters[self.name] = v
            return v
        return self._do(go)

    def cas(self, expect: int, update: int) -> bool:
        def go():
            if self.cluster.counters.get(self.name, 0) == expect:
                self.cluster.counters[self.name] = update
                return True
            return False
        return self._do(go)


class LeaderConn(_Conn):
    """Leadership inspection: (leader, term) as observed from this node —
    a local metadata read (reference LeaderElection.java:35-44), so an
    isolated node answers with its stale pre-partition view."""

    def inspect(self) -> Tuple[Optional[str], int]:
        def go():
            view = self.cluster.stale_views.get(self.node)
            return view if view is not None else (self.cluster.leader,
                                                  self.cluster.term)
        return self._do(go, local=True)
