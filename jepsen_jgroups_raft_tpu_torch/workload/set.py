"""Set workload: concurrent element adds + membership reads over a
replicated grow-only set.

The scenario-tier twin of Jepsen's set workload: clients add small
integer elements (a global sequence modulo the 32-element width, so
churn-induced retries and duplicates occur naturally) and occasionally
read the full membership; a final whole-set read closes the run. The
checker composes the cheap derived analysis (lost/stale elements —
checker/set_queue.py) with the exact frontier check over the GSet model
(models/setmodel.py), both over the SAME history.

SUT mapping: the set lives in one register of the replicated map as a
32-bit membership mask, mutated by CAS retry loops — so the workload
runs unchanged on every deployment tier that serves the register conn
(inmemory fake, local native cluster, ssh). The linearization point of
an add is its winning CAS (or the read that proved the element already
present); a timeout mid-loop is honestly indefinite (the CAS may have
landed), while a loop that exhausts its CAS budget never mutated
anything — a definite fail.

Paired nemesis: membership churn during the fill —
`suggested_nemesis` "set-churn" (nemesis/package.py) shrinks and
re-grows the cluster at twice the default fault rate while adds are in
flight, the schedule that actually loses acknowledged elements on a
buggy SUT.

The port's copy seeds the `Mix` from the test's ``seed`` and builds the
linear checker on the test's ``device``.
"""

from __future__ import annotations

import itertools
import random

from ..checker.base import compose
from ..checker.linearizable import LinearizableChecker
from ..checker.set_queue import SetAnalysis
from ..checker.stats import StatsChecker
from ..checker.timeline import TimelineChecker
from ..client.base import Client
from ..generator.base import Limit, Mix, Seq
from ..history.ops import FAIL, OK, Op
from ..models.setmodel import SET_WIDTH, GSet

#: The one replicated-map key holding the membership mask.
SET_KEY = "gset"

#: CAS rounds before an add reports definite contention failure: the
#: loop never mutated anything, so FAIL ("did not apply") is sound.
MAX_CAS_ROUNDS = 64


class SetClient(Client):
    """Grow-only set over the register conn (put/get/cas)."""

    def __init__(self, conn_factory, timeout: float = 10.0):
        self.conn_factory = conn_factory
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        c = SetClient(self.conn_factory, self.timeout)
        c.conn = self.conn_factory(node, "register", self.timeout)
        return c

    def invoke(self, test, op: Op) -> Op:
        if op.f == "add":
            e = int(op.value)
            for _ in range(MAX_CAS_ROUNDS):
                cur = self.conn.get(SET_KEY, quorum=True)
                mask = int(cur or 0)
                if (mask >> e) & 1:
                    # Already present: the get IS the linearization
                    # point (adding an existing element is a no-op).
                    return op.replace(type=OK)
                if self.conn.cas(SET_KEY, cur, mask | (1 << e)):
                    return op.replace(type=OK)
            return op.replace(type=FAIL, error="cas-contention")
        if op.f == "read":
            cur = self.conn.get(SET_KEY,
                                quorum=test.get("quorum_reads", True))
            mask = int(cur or 0)
            return op.replace(
                type=OK,
                value=[i for i in range(SET_WIDTH) if (mask >> i) & 1])
        raise ValueError(f"set: unknown op {op.f!r}")

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def set_workload(opts: dict) -> dict:
    n_elements = min(SET_WIDTH, int(opts.get("set_elements", SET_WIDTH)))
    counter = itertools.count()

    # Stateful by design (the element sequence); safe because the
    # interpreter calls op() under the scheduler lock — the same stance
    # as generator/independent.py's group bookkeeping.
    def add(test, ctx):
        return {"f": "add", "value": next(counter) % n_elements}

    def read(test, ctx):
        return {"f": "read", "value": None}

    total_ops = opts.get("total_ops")
    rng = random.Random(opts.get("seed"))
    # fill-heavy, reads keep it honest
    mix = Mix([add, add, add, add, read], seed=rng.randrange(2**31))
    gen = Limit(int(total_ops), mix) if total_ops else mix
    consistency = opts.get("consistency", "linearizable")
    return {
        "client": SetClient(opts["conn_factory"],
                            opts.get("operation_timeout", 10.0)),
        "checker": compose({
            "timeline": TimelineChecker(),
            "stats": StatsChecker(),
            "set": SetAnalysis(),
            "linear": LinearizableChecker(
                GSet(), algorithm=opts.get("algorithm", "auto"),
                consistency=consistency, device=opts.get("device")),
        }),
        "generator": gen,
        # Final whole-set read AFTER the heal phases: the read the
        # lost-element analysis anchors on.
        "final_generator": Seq([{"f": "read", "value": None}]),
        "idempotent": {"read"},
        "model": GSet,
        "suggested_nemesis": "set-churn",
    }
