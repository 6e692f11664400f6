"""Register workload: concurrent read/write/cas over independent keys.

Equivalent of the reference's register workload (workload/register.clj):
op generators r/w/cas with values in [0,5) (register.clj:21-34), a client
speaking the RSM connection API, per-key independent decomposition with
`min(2n, concurrency)` threads per key (register.clj:112-117), and a
composed {timeline, linear} checker over the cas-register model
(register.clj:106-111) — with the linear checker batching all keys into
one batched check on the test's device.

Divergence from the reference, on purpose: the reference's ops-per-key cap
is inert (`maybe-limit` compares two literal keywords, register.clj:91-97 —
noted in SURVEY.md §2.1 C3); here `ops_per_key` actually limits, honoring
the CLI flag's documented intent (raft.clj:24-27).

The port's copy differs in two ways: the op values come from a
`random.Random` of the test's ``seed`` (the reference draws from an
unseeded module-level generator), which also seeds each key's `Mix`; and
the linear checker is built on the test's ``device`` (`compose_test`
resolves it), so a CPU run reaches the plain versions only by asking for
``"cpu"``.
"""

from __future__ import annotations

import random

from ..checker.base import compose
from ..checker.independent import IndependentLinearizable
from ..checker.stats import StatsChecker
from ..checker.timeline import TimelineChecker
from ..client.base import Client
from ..generator.base import Limit, Mix
from ..generator.independent import ConcurrentGenerator
from ..history.ops import FAIL, OK, Op
from ..models.register import CasRegister

def op_fns(rng: random.Random) -> tuple:
    """The r / w / cas op functions, values drawn from `rng`
    (register.clj:21-34: values in [0, 5))."""

    def r(test, ctx):
        return {"f": "read", "value": None}

    def w(test, ctx):
        return {"f": "write", "value": rng.randrange(5)}

    def cas(test, ctx):
        return {"f": "cas", "value": (rng.randrange(5), rng.randrange(5))}

    return r, w, cas


class RegisterClient(Client):
    """Client over an RSM connection (the reference's
    ReplicatedStateMachineClient, register.clj:53-89). Values are
    independent (key, v) tuples; reads honor quorum_reads
    (register.clj:36-41 / raft.clj:92)."""

    def __init__(self, conn_factory, timeout: float = 10.0):
        self.conn_factory = conn_factory
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        c = RegisterClient(self.conn_factory, self.timeout)
        c.conn = self.conn_factory(node, "register", self.timeout)
        return c

    def invoke(self, test, op: Op) -> Op:
        key, v = op.value
        if op.f == "read":
            out = self.conn.get(key, quorum=test.get("quorum_reads", True))
            return op.replace(type=OK, value=(key, out))
        if op.f == "write":
            self.conn.put(key, v)
            return op.replace(type=OK)
        if op.f == "cas":
            frm, to = v
            ok = self.conn.cas(key, frm, to)
            if ok:
                return op.replace(type=OK)
            # definite: the CAS executed and returned false
            # (register.clj:82-84's :fail :cas-fail)
            return op.replace(type=FAIL, error="cas-fail")
        raise ValueError(f"register: unknown op {op.f!r}")

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def register_workload(opts: dict) -> dict:
    n = len(opts.get("nodes", [])) or 5
    concurrency = int(opts.get("concurrency", 5))
    threads_per_key = max(1, min(2 * n, concurrency))
    ops_per_key = int(opts.get("ops_per_key", 100))
    keys = opts.get("keys", range(1))
    rng = random.Random(opts.get("seed"))
    fns = list(op_fns(rng))
    gen = ConcurrentGenerator(
        threads_per_key, keys,
        lambda k: Limit(ops_per_key,
                        Mix(fns, seed=rng.randrange(2**31))))
    return {
        "client": RegisterClient(opts["conn_factory"],
                                 opts.get("operation_timeout", 10.0)),
        "checker": compose({
            "timeline": TimelineChecker(),
            "stats": StatsChecker(),
            "linear": IndependentLinearizable(
                CasRegister,
                algorithm=opts.get("algorithm", "auto"),
                consistency=opts.get("consistency", "linearizable"),
                device=opts.get("device")),
        }),
        "generator": gen,
        "idempotent": {"read"},  # register.clj:72
        "model": CasRegister,
    }
