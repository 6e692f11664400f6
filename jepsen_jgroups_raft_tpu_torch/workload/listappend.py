"""List-append workload: Elle's transactional shape over the map.

Per key, clients append unique elements to an append-only list and
read the whole list back; SESSIONS deliberately hop across keys, so
the recorded history carries the cross-key program-order edges the
transactional anomaly rung (checker/anomaly.py) needs — the per-key
relaxation rungs literally cannot see a cross-key cycle (independent
decomposition throws the po edges away), which is the whole point of
running this workload beside them.

Substrate: each key's list lives as a base-32 packed int
(models/listappend.py) in one register-conn key ``la-<k>``, mutated by
the CAS retry loop every scenario workload uses — so it runs on every
deployment tier serving the register conn. A completed append records
the RESULTING list (the CAS's to-value, unpacked): that observation is
the version-order evidence both checkers feed on. Timeouts are
honestly indefinite (the CAS may have landed).

Checker stack: per-key linearizability over the ListAppend frontier
model (one cross-key batched launch, checker/independent.py) PLUS the
multi-key TxnAnomalyChecker on the undecomposed history — G0 / G1c /
G-single certification via the cycle tier's condensation + blocked
closure arms.

The port's copy builds both checkers on the test's ``device``.
"""

from __future__ import annotations

import random

from ..checker.anomaly import TxnAnomalyChecker
from ..checker.base import compose
from ..checker.independent import IndependentLinearizable
from ..checker.stats import StatsChecker
from ..checker.timeline import TimelineChecker
from ..client.base import Client
from ..generator.base import Limit
from ..history.ops import FAIL, OK, Op
from ..models.listappend import (MAX_ELEM, MAX_LEN, ListAppend, pack_list,
                                 unpack_list)

#: register-conn key prefix; one packed list per workload key.
KEY_PREFIX = "la-"

#: CAS rounds before an append reports definite contention failure
#: (the loop never mutated anything, so FAIL is sound).
MAX_CAS_ROUNDS = 64


class ListAppendClient(Client):
    """Append-only lists over the register conn (get/cas retry)."""

    def __init__(self, conn_factory, timeout: float = 10.0):
        self.conn_factory = conn_factory
        self.timeout = timeout
        self.conn = None

    def open(self, test, node):
        c = ListAppendClient(self.conn_factory, self.timeout)
        c.conn = self.conn_factory(node, "register", self.timeout)
        return c

    def invoke(self, test, op: Op) -> Op:
        key, v = op.value
        store_key = f"{KEY_PREFIX}{key}"
        if op.f == "read":
            cur = self.conn.get(store_key,
                                quorum=test.get("quorum_reads", True))
            return op.replace(type=OK, value=(key, unpack_list(int(cur or 0))))
        if op.f == "append":
            e = int(v)
            for _ in range(MAX_CAS_ROUNDS):
                cur = int(self.conn.get(store_key, quorum=True) or 0)
                lst = unpack_list(cur)
                if len(lst) >= MAX_LEN:
                    # definite: the list is full, the append never ran
                    return op.replace(type=FAIL, error="list-full")
                if self.conn.cas(store_key, cur or None, pack_list(lst + [e])):
                    return op.replace(type=OK, value=(key, lst + [e]))
            return op.replace(type=FAIL, error="cas-contention")
        raise ValueError(f"list-append: unknown op {op.f!r}")

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def _keyhop_generator(n_keys: int, seed=None):
    """Op generator hopping keys WITHIN each session (the cross-key po
    edges live or die here): every op picks a random key; appends drain
    a per-key unique-element budget (1..MAX_ELEM, at most MAX_LEN per
    key so lists stay packable), reads keep flowing after the budget is
    spent."""
    rng = random.Random(seed)
    remaining = {k: list(range(1, min(MAX_LEN, MAX_ELEM) + 1))
                 for k in range(n_keys)}

    def gen(test, ctx):
        k = rng.randrange(n_keys)
        budget = remaining[k]
        if budget and rng.random() < 0.6:
            return {"f": "append", "value": (k, budget.pop(0))}
        return {"f": "read", "value": (k, None)}

    return gen


def listappend_workload(opts: dict) -> dict:
    n_keys = int(opts.get("listappend_keys", 4))
    n_ops = int(opts.get("listappend_ops", n_keys * 2 * MAX_LEN))
    return {
        "client": ListAppendClient(opts["conn_factory"],
                                   opts.get("operation_timeout", 10.0)),
        "checker": compose({
            "timeline": TimelineChecker(),
            "stats": StatsChecker(),
            # the undecomposed multi-key history — cross-key anomalies
            "txn": TxnAnomalyChecker(device=opts.get("device")),
            "linear": IndependentLinearizable(
                ListAppend,
                algorithm=opts.get("algorithm", "auto"),
                consistency=opts.get("consistency", "linearizable"),
                device=opts.get("device")),
        }),
        "generator": Limit(n_ops, _keyhop_generator(n_keys,
                                                    opts.get("seed"))),
        "idempotent": {"read"},
        "model": ListAppend,
    }
