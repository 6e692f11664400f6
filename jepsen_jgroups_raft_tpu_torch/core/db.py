"""Node-lifecycle (DB) and network protocols.

Equivalent of the jepsen.db protocol family the reference's Server record
implements (reference src/jepsen/jgroups/server.clj:164-222): DB
setup/teardown, LogFiles, Primary (leader probe), Kill (crash/restart),
Pause (SIGSTOP/SIGCONT) — plus the network-manipulation boundary
(jepsen.net's role) used by the partition nemesis.

Implementations:
  * InMemoryDB / InMemoryNet — over sut/inmemory.InMemoryCluster fault
    hooks, for in-process tests (SURVEY.md §4 implication (b)).
  * the localhost/process tier (deploy/) drives real OS processes with
    signals; its DB speaks the same protocol.
"""

from __future__ import annotations

from typing import List


class DB:
    """Install/start the SUT on a node; reference db/DB."""

    def setup(self, test: dict, node: str) -> None:
        return None

    def teardown(self, test: dict, node: str) -> None:
        return None

    # LogFiles (reference server.clj:181-183)
    def log_files(self, test: dict, node: str) -> List[str]:
        return []

    # Primary (reference server.clj:188-196): every node's view of the
    # leader, deduped — may legitimately return 2+ during partitions.
    def primaries(self, test: dict) -> List[str]:
        return []

    # Kill (reference server.clj:198-218)
    def kill(self, test: dict, node: str) -> None:
        raise NotImplementedError

    def start(self, test: dict, node: str) -> None:
        raise NotImplementedError

    # Pause (reference server.clj:221-222)
    def pause(self, test: dict, node: str) -> None:
        raise NotImplementedError

    def resume(self, test: dict, node: str) -> None:
        raise NotImplementedError


class Net:
    """Network manipulation boundary (jepsen.net equivalent). A grudge is
    a map node -> set of nodes it cannot exchange packets with."""

    def partition(self, test: dict, grudge: dict) -> None:
        raise NotImplementedError

    def heal(self, test: dict) -> None:
        raise NotImplementedError


class InMemoryDB(DB):
    """DB protocol over the in-process cluster's fault hooks."""

    def __init__(self, cluster):
        self.cluster = cluster

    def primaries(self, test):
        # Ask every node's local view, dedupe non-null — mirroring the
        # reference's probe-every-member strategy (server.clj:188-196).
        views = []
        for n in list(self.cluster.nodes):
            view = self.cluster.stale_views.get(n)
            leader = view[0] if view is not None else self.cluster.leader
            if leader is not None and leader not in views:
                views.append(leader)
        return views

    def kill(self, test, node):
        self.cluster.kill(node)

    def start(self, test, node):
        self.cluster.restart(node)

    def pause(self, test, node):
        self.cluster.pause(node)

    def resume(self, test, node):
        self.cluster.resume(node)

    # membership hooks (consensus add/remove in the native tier; direct
    # mutation here)
    def add_member(self, test, node):
        self.cluster.add_node(node)

    def remove_member(self, test, node):
        self.cluster.remove_node(node)


class InMemoryNet(Net):
    def __init__(self, cluster):
        self.cluster = cluster

    def partition(self, test, grudge):
        self.cluster.partition(grudge)

    def heal(self, test):
        self.cluster.heal()
