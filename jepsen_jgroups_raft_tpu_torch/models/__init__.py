"""Consistency models of the port: the model protocol, the CAS register
(the north-star workload), the counter, the ticket queue, the grow-only
set and the list-append model. A model's device step is `torch_step`, a
branch-free function on tensors; the counter, the queue and the set also
give `mask_delta` for the mask-mode scan. The election-safety models
(`leader.py`) are invariant checkers with a direct host check; their
batched device form is `leader.check_election_safety`."""

from .base import Model, NIL  # noqa: F401
from .counter import Counter  # noqa: F401
from .leader import LeaderModel, MajorityLeaderModel  # noqa: F401
from .listappend import ListAppend  # noqa: F401
from .queuemodel import TicketQueue  # noqa: F401
from .register import CasRegister  # noqa: F401
from .setmodel import GSet  # noqa: F401

#: name → constructor (the reference's names).
MODELS = {
    "cas-register": CasRegister,
    "counter": Counter,
    "leader": LeaderModel,
    "queue": TicketQueue,
    "set": GSet,
    "list-append": ListAppend,
}
