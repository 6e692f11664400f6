"""Membership nemesis: grow/shrink the cluster at runtime.

Equivalent of the reference's nemesis/membership.clj — resize the cluster
"as a human operator would": issue a consensus add/remove through a live
member, update the shared membership set, and start/stop the node's
process. Guardrails mirrored from the reference:

  * never shrink below a majority of the full node set (membership.clj:37-40,
    80-81) — removing more would let the remnant lose quorum forever;
  * kill the node BEFORE removing it (membership.clj:87-92): a live node
    that processes its own removal can restart and fail to rejoin;
  * 15 s timeouts around both operations, converted into op values rather
    than harness crashes (membership.clj:50-51, 75-76, 118-135).

The generator is a staggered shrink/grow flip-flop (membership.clj:105-111);
the final generator grows the cluster back to full strength
(membership.clj:142-157).
"""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Optional

from ..generator.base import Generator
from ..history.ops import Op
from .base import Nemesis

GROW = "grow"
SHRINK = "shrink"


class MemberNemesis(Nemesis):
    fs = (GROW, SHRINK)

    def __init__(self, db, seed: Optional[int] = None,
                 op_timeout: float = 15.0):
        self.db = db
        self.rng = random.Random(seed)
        self.op_timeout = op_timeout
        # one worker: membership ops are serial anyway, and an abandoned
        # (timed-out) op must finish before the next one starts
        self._pool = ThreadPoolExecutor(1)
        #: nodes killed for a shrink whose remove AND rollback-start both
        #: failed: still listed in the members set (so GrowUntilFull sees
        #: a full membership and never re-grows them) but dead — teardown
        #: retries the restart so a run cannot end with a permanently
        #: dead voting member.
        self.unhealed: set = set()

    def invoke(self, test, op: Op) -> Op:
        if op.f == GROW:
            task = self._grow
        elif op.f == SHRINK:
            task = self._shrink
        else:
            raise ValueError(f"member nemesis: unknown f {op.f!r}")
        # Bounded like the reference's util/timeout wrappers
        # (membership.clj:50-51,75-76): a wedged consensus op becomes an
        # op value, never a stuck nemesis thread.
        fut = self._pool.submit(task, test)
        try:
            return op.replace(value=fut.result(self.op_timeout))
        except FutureTimeout:
            return op.replace(value={"error": f"timed out after "
                                              f"{self.op_timeout}s"})
        except Exception as e:  # convert failures into op values
            return op.replace(value={"error": repr(e)})

    def _grow(self, test):
        members = test["members"]
        spare = sorted(set(test["nodes"]) - set(members))
        if not spare:
            return "cluster is already full"
        node = self.rng.choice(spare)
        # Consensus add through a live member, then start the process
        # (membership.clj:47-70: add first so the joiner is a voting
        # member by the time it boots). The shared set is only updated
        # once the add committed; if the subsequent start fails the node
        # is still a (dead) voting member, so keep it in the set — the
        # final generator / kill-teardown restarts whatever is listed.
        self.db.add_member(test, node)
        members.add(node)
        self.db.start(test, node)
        return {"added": node, "members": sorted(members)}

    def _shrink(self, test):
        members = test["members"]
        majority = len(test["nodes"]) // 2 + 1
        if len(members) - 1 < majority:
            # membership.clj:37-40: refuse; the remnant could lose quorum.
            return "will not shrink below majority"
        node = self.rng.choice(sorted(members))
        # Kill BEFORE removing (membership.clj:87-92). Deliberately NOT
        # restarted on the success path: the node is leaving the cluster
        # dead, and the final generator (GrowUntilFull → grow → db.start)
        # is the healing side of the shrink/grow flip-flop.
        self.db.kill(test, node)  # lint: allow(unhealed)
        try:
            # Removal is healed by regrowth, not by an inline add_member:
            # GrowUntilFull re-adds removed nodes until the membership is
            # full again (the reference's final generator).
            self.db.remove_member(test, node)  # lint: allow(unhealed)
        except Exception:
            # Roll back the kill: without this, a failed remove leaves a
            # permanently-dead voting member that no healing path restarts
            # (GrowUntilFull sees the membership as full).
            try:
                self.db.start(test, node)
            except Exception:
                # Rollback failed too. Register the orphan so teardown
                # retries the restart — before this (graftcheck
                # flow-unhealed-fault finding) the node stayed a dead
                # voting member forever: still in `members`, so the
                # final generator never regrew it.
                self.unhealed.add(node)
            raise
        members.discard(node)
        return {"removed": node, "members": sorted(members)}

    def teardown(self, test):
        # wait=True: an abandoned (timed-out) op may still be running and
        # can register into self.unhealed at its end — retrying before it
        # finishes would miss that node (the op's own db calls are
        # timeout-bounded, so this terminates; same assumption as the
        # one-worker serialization note in __init__).
        self._pool.shutdown(wait=True)
        for node in sorted(self.unhealed):
            try:
                self.db.start(test, node)
                self.unhealed.discard(node)
            except Exception:
                pass  # node unreachable; nothing left to drive it with


class GrowUntilFull(Generator):
    """Generator: emit grow ops until the membership set is full
    (membership.clj final generator, bounded by the caller's time limit)."""

    def op(self, test, ctx):
        if set(test["members"]) >= set(test["nodes"]):
            return None
        return {"f": GROW, "value": None}, self

    def update(self, test, ctx, event):
        return self
