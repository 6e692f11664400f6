"""Victim-class selection for fault targeting.

Equivalent of jepsen.nemesis.combined's target specs as configured by the
reference (nemesis.clj:48-58): partitions target
[:primaries :majority :majorities-ring :one]; kill/pause target
[:primaries :minority :one]. Node-set targets return a list of victim
nodes; partition targets return a *grudge* (node -> unreachable peers).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Set

PARTITION_TARGETS = ("primaries", "majority", "majorities-ring", "one")
NODE_TARGETS = ("primaries", "minority", "one")


def pick_nodes(kind: str, nodes: Sequence[str], primaries: Sequence[str],
               rng: random.Random) -> List[str]:
    """Choose victim nodes for kill/pause faults."""
    nodes = list(nodes)
    if not nodes:
        return []
    if kind == "one":
        return [rng.choice(nodes)]
    if kind == "primaries":
        return [p for p in primaries if p in nodes] or [rng.choice(nodes)]
    if kind == "minority":
        k = max(1, (len(nodes) - 1) // 2)
        return rng.sample(nodes, k)
    if kind == "all":
        return nodes
    raise ValueError(f"unknown node target {kind!r}")


def complete_grudge(components: Sequence[Set[str]]) -> Dict[str, Set[str]]:
    """Components (disjoint node sets) -> symmetric grudge: every node
    refuses packets from every node outside its component."""
    grudge: Dict[str, Set[str]] = {}
    all_nodes = set().union(*components) if components else set()
    for comp in components:
        others = all_nodes - set(comp)
        for n in comp:
            grudge[n] = set(others)
    return grudge


def partition_grudge(kind: str, nodes: Sequence[str],
                     primaries: Sequence[str],
                     rng: random.Random) -> Dict[str, Set[str]]:
    """Build the grudge for a partition target kind."""
    nodes = list(nodes)
    if len(nodes) < 2:
        return {}
    if kind == "one":
        iso = rng.choice(nodes)
        return complete_grudge([{iso}, set(nodes) - {iso}])
    if kind == "primaries":
        iso = {p for p in primaries if p in nodes}
        if not iso or iso == set(nodes):
            iso = {rng.choice(nodes)}
        return complete_grudge([iso, set(nodes) - iso])
    if kind == "majority":
        shuffled = rng.sample(nodes, len(nodes))
        k = len(nodes) // 2 + 1
        return complete_grudge([set(shuffled[:k]), set(shuffled[k:])])
    if kind == "majorities-ring":
        return majorities_ring_grudge(nodes, rng)
    raise ValueError(f"unknown partition target {kind!r}")


def majorities_ring_grudge(nodes: Sequence[str],
                           rng: random.Random) -> Dict[str, Set[str]]:
    """Overlapping-majorities ring (jepsen nemesis/partition-majorities-ring):
    arrange nodes in a random ring; each node talks only to itself and the
    ⌊n/2⌋ nearest ring neighbors — every node sees a majority, but no two
    nodes see the same one. The nastiest partition for leader elections."""
    ring = rng.sample(list(nodes), len(nodes))
    n = len(ring)
    half = n // 2
    grudge: Dict[str, Set[str]] = {}
    for i, node in enumerate(ring):
        visible = {ring[(i + d) % n] for d in range(-(half // 2 + half % 2),
                                                    half // 2 + 1)}
        # ensure a strict majority including self
        j = 1
        while len(visible) <= n // 2:
            visible.add(ring[(i + j) % n])
            j += 1
        grudge[node] = set(ring) - visible
    return grudge
