"""Queue workload: ticket-FIFO enqueue/dequeue over the replicated map.

The scenario-tier twin of Jepsen's queue workload, shaped for the
raft-log substrate: a log-backed FIFO hands each enqueued element a
dense *ticket* (its sequence index — what a raft log does for appended
entries), and dequeues pop tickets in order. The whole queue state is
the (head, tail) pair, packed into one register of the replicated map
and mutated by CAS retry loops — so the workload runs on every
deployment tier serving the register conn, and the recorded history
checks against the TicketQueue frontier model (models/queuemodel.py)
plus the order-free conservation analysis (checker/set_queue.py).

Schedule shape: the main phase FILLS (enqueue-heavy mix), then DRAINS
(dequeue-only) — both inside the nemesis window, so the paired
`suggested_nemesis` "queue-drain" (nemesis/package.py) partitions the
cluster WHILE the drain is running: the schedule that actually loses or
double-delivers elements on a buggy SUT. A short post-heal drain rides
the workload final generator.

Op/value conventions (service + store wire format): ``enqueue`` invokes
with value None and completes ok with the assigned ticket; ``dequeue``
completes ok with the popped ticket, or ok with value None when the
queue was empty (a real observation — legal only against an empty
queue); timeouts are honestly indefinite (the CAS may have landed).

The port's copy seeds its three `Mix`es from the test's ``seed`` (in
the order they are built) and builds the linear checker on the test's
``device``.
"""

from __future__ import annotations

import random

from ..checker.base import compose
from ..checker.linearizable import LinearizableChecker
from ..checker.set_queue import QueueConservation
from ..checker.stats import StatsChecker
from ..checker.timeline import TimelineChecker
from ..client.base import Client
from ..generator.base import Limit, Mix, Seq
from ..history.ops import FAIL, OK, Op
from ..models.queuemodel import TicketQueue, pack_state, unpack_state

#: The one replicated-map key holding the packed (head, tail) state.
QUEUE_KEY = "fifo"

#: CAS rounds before an op reports definite contention failure (the
#: loop never mutated anything, so FAIL is sound — same stance as the
#: set workload's budget).
MAX_CAS_ROUNDS = 64


def _unpack(cur) -> tuple:
    # The MODEL's bit layout (models/queuemodel.py) is the single
    # source of truth — the client only adds the None-is-empty rule.
    return unpack_state(int(cur or 0))


_pack = pack_state


class QueueClient(Client):
    """Ticket FIFO over the register conn (get/cas retry loops)."""

    def __init__(self, conn_factory, timeout: float = 10.0):
        self.conn_factory = conn_factory
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        c = QueueClient(self.conn_factory, self.timeout)
        c.conn = self.conn_factory(node, "register", self.timeout)
        return c

    def invoke(self, test, op: Op) -> Op:
        if op.f == "enqueue":
            for _ in range(MAX_CAS_ROUNDS):
                cur = self.conn.get(QUEUE_KEY, quorum=True)
                h, t = _unpack(cur)
                if self.conn.cas(QUEUE_KEY, cur, _pack(h, t + 1)):
                    return op.replace(type=OK, value=t)  # ticket = t
            return op.replace(type=FAIL, error="cas-contention")
        if op.f == "dequeue":
            for _ in range(MAX_CAS_ROUNDS):
                cur = self.conn.get(QUEUE_KEY, quorum=True)
                h, t = _unpack(cur)
                if h == t:
                    # Empty observation: the get is the linearization
                    # point (legal only against head == tail).
                    return op.replace(type=OK, value=None)
                if self.conn.cas(QUEUE_KEY, cur, _pack(h + 1, t)):
                    return op.replace(type=OK, value=h)
            return op.replace(type=FAIL, error="cas-contention")
        raise ValueError(f"queue: unknown op {op.f!r}")

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def queue_workload(opts: dict) -> dict:
    def enq(test, ctx):
        return {"f": "enqueue", "value": None}

    def deq(test, ctx):
        return {"f": "dequeue", "value": None}

    fill = int(opts.get("queue_fill", 120))
    drain = int(opts.get("queue_drain", 120))
    rng = random.Random(opts.get("seed"))
    gen = Seq([
        Limit(fill, Mix([enq, enq, enq, deq],
                        seed=rng.randrange(2**31))),  # fill-heavy
        Limit(drain, Mix([deq], seed=rng.randrange(2**31))),  # drain
    ])
    consistency = opts.get("consistency", "linearizable")
    return {
        "client": QueueClient(opts["conn_factory"],
                              opts.get("operation_timeout", 10.0)),
        "checker": compose({
            "timeline": TimelineChecker(),
            "stats": StatsChecker(),
            "queue": QueueConservation(),
            "linear": LinearizableChecker(
                TicketQueue(), algorithm=opts.get("algorithm", "auto"),
                consistency=consistency, device=opts.get("device")),
        }),
        "generator": gen,
        # Post-heal drain: pull whatever survived the faults so the
        # conservation analysis sees the delivered tail.
        "final_generator": Limit(drain, Mix([deq],
                                            seed=rng.randrange(2**31))),
        "idempotent": set(),  # even "empty" dequeues observe state
        "model": TicketQueue,
        "suggested_nemesis": "queue-drain",
    }
