"""Workloads.

Equivalent of the reference's workload registry (workload/workload.clj:7-15):
name → constructor; each constructor takes the options map and returns a
dict with client / checker / generator / idempotent keys (the
`{:client :checker :generator}` shape of register.clj:100-117).
"""

from .register import register_workload
from .counter import counter_workload
from .leader import leader_workload
from .set import set_workload
from .queue import queue_workload
from .listappend import listappend_workload


def single_register(opts):
    return register_workload({**opts, "keys": range(1)})


def multi_register(opts):
    """Independent multi-key registers (generator/independent.py
    concurrent generator; checker: one cross-key batched kernel launch
    via checker/independent.check_keyed)."""
    import itertools

    return register_workload({**opts, "keys": itertools.count()})


#: name → constructor (reference workload.clj:10-15; set/queue are the
#: scenario tier).
WORKLOADS = {
    "single-register": single_register,
    "multi-register": multi_register,
    "counter": counter_workload,
    "election": leader_workload,
    "set": set_workload,
    "queue": queue_workload,
    "list-append": listappend_workload,
}
