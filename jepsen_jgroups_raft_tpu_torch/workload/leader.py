"""Leader-election workload: inspect leadership, check election safety.

Equivalent of the reference's election workload (workload/leader.clj):
a single `inspect` op (leader.clj:14-17) observing (leader, term) tuples,
checked for election safety — no two leaders in one term (leader.clj:63-75).
Unlike the reference (which deliberately skips cross-node agreement,
leader.clj:58-62), the DEFAULT checker here is the cross-node majority
model (pooled per-term safety + per-node term monotonicity) fed by an
every-node `views` probe; pass ``weak_election`` for reference parity.

The port's copy seeds the `Mix` from the test's ``seed``. The election
checkers run on the host, as the reference's do.
"""

from __future__ import annotations

import random

from ..checker.base import Checker, compose
from ..checker.stats import StatsChecker
from ..checker.timeline import TimelineChecker
from ..client.base import Client
from ..generator.base import Limit, Mix
from ..history.ops import History, OK, Op
from ..models.leader import LeaderModel, MajorityLeaderModel


def inspect(test, ctx):
    return {"f": "inspect", "value": None}


def views(test, ctx):
    return {"f": "views", "value": None}


class LeaderInspectionClient(Client):
    def __init__(self, conn_factory, timeout: float = 10.0,
                 views_probe=None):
        self.conn_factory = conn_factory
        self.timeout = timeout
        self.views_probe = views_probe
        self.conn = None

    def open(self, test, node):
        c = LeaderInspectionClient(self.conn_factory, self.timeout,
                                   self.views_probe)
        c.conn = self.conn_factory(node, "election", self.timeout)
        return c

    def invoke(self, test, op: Op) -> Op:
        if op.f == "views":
            # Every node's local (leader, term) — the primaries-probe
            # data the majority checker consumes. Unreachable nodes are
            # simply absent (their staleness is the tolerated case).
            return op.replace(type=OK, value=self.views_probe())
        if op.f != "inspect":
            raise ValueError(f"election: unknown op {op.f!r}")
        leader, term = self.conn.inspect()
        return op.replace(type=OK, value=(leader, term))

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


class ElectionSafetyChecker(Checker):
    def __init__(self, majority: bool = False):
        self.majority = majority

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        model = MajorityLeaderModel() if self.majority else LeaderModel()
        return model.check(history.client_ops())


def leader_workload(opts: dict) -> dict:
    total_ops = opts.get("total_ops")
    weak = bool(opts.get("weak_election"))
    views_probe = None if weak else opts.get("views_probe")
    # Default-on strengthening: with a views probe wired
    # (every local/ssh deployment has one), every 4th op snapshots all
    # nodes' views and the checker runs the cross-node majority model —
    # pooled per-term safety + per-node term monotonicity — on top of
    # the parity check. `weak_election` is the escape hatch back to the
    # reference-parity single-client model (leader.clj:58-62 checks no
    # cross-node agreement at all).
    rng = random.Random(opts.get("seed"))
    gen = Mix([inspect, inspect, inspect, views] if views_probe
              else [inspect], seed=rng.randrange(2**31))
    if total_ops:
        gen = Limit(total_ops, gen)
    return {
        "client": LeaderInspectionClient(
            opts["conn_factory"], opts.get("operation_timeout", 10.0),
            views_probe=views_probe),
        "checker": compose({
            "timeline": TimelineChecker(),
            "stats": StatsChecker(),
            "linear": ElectionSafetyChecker(majority=not weak),
        }),
        "generator": gen,
        "idempotent": {"inspect", "views"},  # leader.clj:39
        "model": LeaderModel,
    }
