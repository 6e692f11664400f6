"""Counter workload: concurrent add/decr/read over a replicated counter.

Equivalent of the reference's counter workload (workload/counter.clj):
ops get'/add/add-and-get/decr/decr-and-get (counter.clj:15-38), a client
over the counter connection API (decrements negate the delta at the
client, counter.clj:56-59), and a {timeline, linear} checker over the
Counter model (counter.clj:129-138). Generation is a plain mix — no key
independence, matching the reference.

The port's copy draws the deltas from a `random.Random` of the test's
``seed`` (the reference: an unseeded module-level generator), which also
seeds the `Mix`, and builds the linear checker on the test's ``device``.
"""

from __future__ import annotations

import random

from ..checker.base import compose
from ..checker.counter_bounds import CounterChecker
from ..checker.linearizable import LinearizableChecker
from ..checker.stats import StatsChecker
from ..checker.timeline import TimelineChecker
from ..client.base import Client
from ..generator.base import Limit, Mix
from ..history.ops import OK, Op
from ..models.counter import Counter

def op_fns(rng: random.Random) -> tuple:
    """get' / add / add-and-get / decr / decr-and-get (counter.clj:15-38),
    deltas in [1, 6) drawn from `rng`."""

    def get_(test, ctx):
        return {"f": "read", "value": None}

    def add(test, ctx):
        return {"f": "add", "value": rng.randrange(1, 6)}

    def add_and_get(test, ctx):
        return {"f": "add-and-get", "value": rng.randrange(1, 6)}

    def decr(test, ctx):
        return {"f": "decr", "value": rng.randrange(1, 6)}

    def decr_and_get(test, ctx):
        return {"f": "decr-and-get", "value": rng.randrange(1, 6)}

    return get_, add, add_and_get, decr, decr_and_get


class CounterClient(Client):
    def __init__(self, conn_factory, timeout: float = 10.0):
        self.conn_factory = conn_factory
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        c = CounterClient(self.conn_factory, self.timeout)
        c.conn = self.conn_factory(node, "counter", self.timeout)
        return c

    def invoke(self, test, op: Op) -> Op:
        f, v = op.f, op.value
        if f == "read":
            return op.replace(type=OK, value=self.conn.get())
        if f == "add":
            self.conn.add(v)
            return op.replace(type=OK)
        if f == "decr":
            self.conn.add(-v)  # negated add (counter.clj:56-59)
            return op.replace(type=OK)
        if f == "add-and-get":
            new = self.conn.add_and_get(v)
            return op.replace(type=OK, value=(v, new))
        if f == "decr-and-get":
            new = self.conn.add_and_get(-v)
            return op.replace(type=OK, value=(v, new))
        raise ValueError(f"counter: unknown op {f!r}")

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def counter_workload(opts: dict) -> dict:
    total_ops = opts.get("total_ops")
    rng = random.Random(opts.get("seed"))
    mix = Mix(list(op_fns(rng)), seed=rng.randrange(2**31))
    gen = Limit(total_ops, mix) if total_ops else mix
    return {
        "client": CounterClient(opts["conn_factory"],
                                opts.get("operation_timeout", 10.0)),
        "checker": compose({
            "timeline": TimelineChecker(),
            "stats": StatsChecker(),
            # Exact linearizability (the reference's CounterModel
            # semantics) with the jepsen checker/counter interval tier
            # deciding what the exact engines cannot budget — canonical-
            # envelope runs (concurrency 100 hell) pile up thousands of
            # crashed adds and blow the window past every engine.
            "linear": CounterChecker(LinearizableChecker(
                Counter(0), algorithm=opts.get("algorithm", "auto"),
                consistency=opts.get("consistency", "linearizable"),
                device=opts.get("device"))),
        }),
        "generator": gen,
        "idempotent": {"read"},  # counter.clj:80
        "model": Counter,
    }
