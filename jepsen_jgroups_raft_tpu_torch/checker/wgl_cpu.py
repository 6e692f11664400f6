"""CPU reference implementation of the frontier linearizability search.

A copy of the reference's host oracle. It is the host-side twin of the
frontier kernels: the same algorithm — scan the packed event stream, expand the frontier of
(linearized-bitmask, model-state) configurations to a fixed point at each
FORCE event, kill configurations that missed a forced op — implemented with
python sets and unbounded ints. It serves three roles:

  1. differential oracle for the device kernels (same events in, same verdict
     out — pinned by tests);
  2. fallback when a history exceeds the kernel's window/frontier capacity
     (masks here are arbitrary-precision, frontiers grow unbounded);
  3. counterexample reporting: on failure, the index of the op whose
     completion emptied the frontier, plus a witness linearization prefix.

Algorithm lineage: Wing & Gong linear search with Lowe's memoization
(what knossos' :linear algorithm does, reference register.clj:110-111),
reshaped from DFS-with-undo into a breadth/frontier form whose per-event
work is a pure set-expansion — the shape that maps onto SIMD.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..history.packing import EV_FORCE, EV_OPEN, EncodedHistory


@dataclass
class CpuCheckResult:
    valid: bool
    configs_explored: int = 0
    max_frontier: int = 0
    #: history index of the op whose ok-completion emptied the frontier.
    failing_op_index: Optional[int] = None
    #: op indices (history order) of one maximal linearization prefix —
    #: a witness order on success, the longest surviving prefix on failure.
    witness: Optional[list] = None


class FrontierOverflow(Exception):
    """Frontier exceeded the configured capacity."""

    def __init__(self, size: int):
        super().__init__(f"frontier overflow: {size} configurations")
        self.size = size


def check_encoded_cpu(
    enc: EncodedHistory,
    model,
    max_configs: Optional[int] = None,
    witness: bool = False,
) -> CpuCheckResult:
    """Run the frontier search on one encoded history.

    max_configs bounds the frontier (None = unbounded); exceeding it raises
    FrontierOverflow so callers can escalate rather than mis-report.
    """

    # frontier: (mask, state) -> node id into `nodes`;
    # nodes[i] = (parent node id, op index linearized on that edge).
    nodes: list = [(-1, -1)]
    frontier: dict = {(0, model.init_state()): 0}
    slot_ops: dict = {}
    open_slots: set = set()
    explored = 0
    max_front = 1
    events = enc.events
    step = model.step

    for ei in range(enc.n_events):
        etype, slot = int(events[ei, 0]), int(events[ei, 1])
        if etype == EV_OPEN:
            slot_ops[slot] = (
                int(events[ei, 2]),
                int(events[ei, 3]),
                int(events[ei, 4]),
                int(enc.op_index[ei]),
            )
            open_slots.add(slot)
        elif etype == EV_FORCE:
            # Closure: expand until no new configurations appear.
            stack = list(frontier.items())
            while stack:
                (mask, state), node = stack.pop()
                for j in open_slots:
                    if (mask >> j) & 1:
                        continue
                    fj, aj, bj, oi = slot_ops[j]
                    state2, legal = step(state, fj, aj, bj)
                    if not legal:
                        continue
                    cfg2 = (mask | (1 << j), state2)
                    if cfg2 not in frontier:
                        nodes.append((node, oi))
                        frontier[cfg2] = len(nodes) - 1
                        stack.append((cfg2, len(nodes) - 1))
                        explored += 1
                        if max_configs and len(frontier) > max_configs:
                            raise FrontierOverflow(len(frontier))
            max_front = max(max_front, len(frontier))
            # Survivors linearized the forced op; recycle its slot bit.
            # Clearing the bit can merge configs; keep either witness chain.
            bit = 1 << slot
            survivors: dict = {}
            for (mask, state), node in frontier.items():
                if mask & bit:
                    survivors.setdefault((mask & ~bit, state), node)
            if not survivors:
                return CpuCheckResult(
                    valid=False,
                    configs_explored=explored,
                    max_frontier=max_front,
                    failing_op_index=int(enc.op_index[ei]),
                    witness=_walk(nodes, _deepest(nodes, frontier))
                    if witness
                    else None,
                )
            frontier = survivors
            open_slots.discard(slot)

    return CpuCheckResult(
        valid=True,
        configs_explored=explored,
        max_frontier=max_front,
        witness=_walk(nodes, _deepest(nodes, frontier)) if witness else None,
    )


def _deepest(nodes, frontier) -> int:
    """Node whose linearization chain is longest (best witness)."""
    depth: dict = {-1: 0}

    def d(n: int) -> int:
        path = []
        while n not in depth:
            path.append(n)
            n = nodes[n][0]
        base = depth[n]
        for m in reversed(path):
            base += 1
            depth[m] = base
        return base if path else depth[n]

    return max(frontier.values(), key=d, default=0)


def _walk(nodes, node: int) -> list:
    chain = []
    while node > 0:
        parent, oi = nodes[node]
        chain.append(oi)
        node = parent
    return list(reversed(chain))
