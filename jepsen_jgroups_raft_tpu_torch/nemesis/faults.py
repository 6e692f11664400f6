"""Partition / kill / pause nemeses.

Equivalents of the jepsen.nemesis.combined partition-package and db-package
nemeses the reference composes (nemesis.clj:31-46). Each nemesis resolves
its victim class at invoke time (op.value carries the target kind) using
the DB's current primaries — matching how the combined packages re-probe
leaders per fault.
"""

from __future__ import annotations

import random
from typing import Optional

from ..history.ops import Op
from .base import Nemesis
from .targets import partition_grudge, pick_nodes


def _member_nodes(test) -> list:
    """Current live membership — fault targeting follows the shared
    membership set, not the static node list (raft.clj:70)."""
    if test.get("members"):
        return sorted(test["members"])
    return list(test["nodes"])


class PartitionNemesis(Nemesis):
    """start-partition / stop-partition via the Net boundary."""

    fs = ("start-partition", "stop-partition")

    def __init__(self, net, db=None, seed: Optional[int] = None):
        self.net = net
        self.db = db
        self.rng = random.Random(seed)

    def invoke(self, test, op: Op) -> Op:
        if op.f == "start-partition":
            kind = op.value or "majority"
            nodes = _member_nodes(test)
            primaries = self.db.primaries(test) if self.db else []
            grudge = partition_grudge(kind, nodes, primaries, self.rng)
            self.net.partition(test, grudge)
            cut = {n: sorted(g) for n, g in grudge.items() if g}
            return op.replace(value={"kind": kind, "grudge": cut})
        if op.f == "stop-partition":
            self.net.heal(test)
            return op.replace(value="healed")
        raise ValueError(f"partition nemesis: unknown f {op.f!r}")

    def teardown(self, test):
        # Never leave the network cut after a run.
        try:
            self.net.heal(test)
        except Exception:
            pass


class _DbToggleNemesis(Nemesis):
    """Shared shape of the DB-protocol fault pairs: a `start_f` op picks
    victims by target kind and applies `do`; a `stop_f` op applies `undo`
    to everything still afflicted (or every node, with value "all" — the
    final-generator heal); teardown undoes any leftovers."""

    start_f = ""
    stop_f = ""
    done_key = ""    # op-value key listing newly afflicted nodes
    undone_key = ""  # op-value key listing healed nodes

    def __init__(self, db, seed: Optional[int] = None):
        self.db = db
        self.rng = random.Random(seed)
        self.afflicted: set = set()

    @property
    def fs(self):  # type: ignore[override]
        return (self.start_f, self.stop_f)

    def _do(self, test, node):
        raise NotImplementedError

    def _undo(self, test, node):
        raise NotImplementedError

    def invoke(self, test, op: Op) -> Op:
        nodes = _member_nodes(test)
        if op.f == self.start_f:
            kind = op.value or "one"
            victims = pick_nodes(kind, nodes, self.db.primaries(test),
                                 self.rng)
            for n in victims:
                self._do(test, n)
                self.afflicted.add(n)
            return op.replace(value={"kind": kind, self.done_key: victims})
        if op.f == self.stop_f:
            targets = nodes if op.value == "all" else sorted(self.afflicted)
            undone = []
            for n in targets:
                self._undo(test, n)
                self.afflicted.discard(n)
                undone.append(n)
            return op.replace(value={self.undone_key: undone})
        raise ValueError(f"{self.start_f} nemesis: unknown f {op.f!r}")

    def teardown(self, test):
        for n in sorted(self.afflicted):
            try:
                self._undo(test, n)
            except Exception:
                pass
        self.afflicted.clear()


class KillNemesis(_DbToggleNemesis):
    """kill / restart via the DB's Kill protocol (db/kill! + db/start!,
    reference server.clj:198-218)."""

    start_f = "kill"
    stop_f = "restart"
    done_key = "killed"
    undone_key = "restarted"

    def _do(self, test, node):
        self.db.kill(test, node)

    def _undo(self, test, node):
        self.db.start(test, node)


class PauseNemesis(_DbToggleNemesis):
    """pause / resume via the DB's Pause protocol (SIGSTOP/SIGCONT,
    reference server.clj:221-222)."""

    start_f = "pause"
    stop_f = "resume"
    done_key = "paused"
    undone_key = "resumed"

    def _do(self, test, node):
        self.db.pause(test, node)

    def _undo(self, test, node):
        self.db.resume(test, node)
