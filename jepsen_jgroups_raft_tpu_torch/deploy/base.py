"""Shared DB-protocol implementation over a raft cluster object.

Both deployment tiers (local processes, ssh remote hosts) expose the same
cluster contract — start_node/kill_node/pause_node/resume_node, probe,
admin, spec — so the jepsen.db protocol family (reference
server.clj:164-222) is implemented once here and parameterized by the
cluster. Tier subclasses override only what genuinely differs: readiness
waits, teardown cleanup, and log collection.
"""

from __future__ import annotations

import inspect
import random
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from ..core.db import DB


def collect_views(probe, members, timeout: float = 0.75) -> list:
    """[(node, leader, term)] for every reachable member — the snapshot
    the opt-in majority election checker consumes. Shared by both
    cluster tiers (`views_probe` on LocalCluster / RemoteRaftCluster);
    unreachable or leaderless nodes are absent, which is the tolerated
    staleness case.

    Probes run CONCURRENTLY with a sub-second per-node timeout: a views
    op runs inside a worker's operation slot, and sequential 2 s-default
    probes of a 5-node partitioned cluster would block that worker ~10 s
    — past the workloads' operation timeout, skewing op mix and latency
    stats during faults.

    `probe` contract: ``probe(node) -> (leader, term) | None``; a
    ``timeout=`` keyword is passed when the callable accepts one (both
    in-repo cluster probes do), otherwise the probe's own default
    timeout applies (external probes without the kwarg must
    not TypeError)."""
    members = list(members)
    if not members:
        return []
    try:
        sig = inspect.signature(probe)
        takes_timeout = "timeout" in sig.parameters or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values())
    except (TypeError, ValueError):  # signature-opaque (C/builtin):
        takes_timeout = True         # optimistic, with call-time retry

    def call(n, _tt=takes_timeout):
        if _tt:
            try:
                return probe(n, timeout=timeout)
            except TypeError:
                # Signature-opaque callable that turned out not to take
                # the kwarg (introspection alone still
                # crashed exactly the case the fix targets). A genuine
                # TypeError from inside a timeout-taking probe re-raises
                # below on the retry.
                pass
        return probe(n)

    with ThreadPoolExecutor(max_workers=len(members)) as pool:
        views = pool.map(call, members)
    out = []
    for n, v in zip(members, views):
        if v is not None and v[0] is not None:
            out.append((n, v[0], int(v[1])))
    return out


class RaftDB(DB):
    def __init__(self, cluster, seed: Optional[int] = None):
        self.cluster = cluster
        self.rng = random.Random(seed)

    def _members(self, test) -> List[str]:
        ms = test.get("members")
        return sorted(ms) if ms else list(test["nodes"])

    def _alive(self, node: str) -> bool:
        """Is the node worth routing an admin op through? Overridden per
        tier (process liveness locally; probe reachability remotely)."""
        return self.cluster.probe(node) is not None

    # ---- lifecycle -------------------------------------------------------

    def setup(self, test, node):
        self.cluster.start_node(node, set(self._members(test)) | {node})

    def kill(self, test, node):
        self.cluster.kill_node(node)

    def start(self, test, node):
        self.cluster.start_node(node, set(self._members(test)) | {node})

    def pause(self, test, node):
        self.cluster.pause_node(node)

    def resume(self, test, node):
        self.cluster.resume_node(node)

    # ---- Primary ---------------------------------------------------------

    def primaries(self, test):
        """Every member's local leader view, deduped non-null — may
        legitimately return 2+ during partitions (server.clj:188-196)."""
        views = []
        for n in self._members(test):
            view = self.cluster.probe(n)
            if view is not None and view[0] and view[0] not in views:
                views.append(view[0])
        return views

    # ---- membership via consensus through an alive member ---------------
    # (the CLI-over-SSH path, membership.clj:22-35; kill-before-remove and
    # majority guards live in the nemesis)

    def _via(self, test, exclude=()) -> Optional[str]:
        candidates = [n for n in self._members(test)
                      if n not in exclude and self._alive(n)]
        return self.rng.choice(candidates) if candidates else None

    def add_member(self, test, node):
        via = self._via(test, exclude={node})
        if via is None:
            raise RuntimeError("no alive member to run add through")
        conn = self.cluster.admin(via, timeout=15.0)
        try:
            conn.admin_add(self.cluster.spec(node))
        finally:
            conn.close()

    def remove_member(self, test, node):
        via = self._via(test, exclude={node})
        if via is None:
            raise RuntimeError("no alive member to run remove through")
        conn = self.cluster.admin(via, timeout=15.0)
        try:
            conn.admin_remove(node)
        finally:
            conn.close()
