"""Consistency models of the port: the model protocol and the CAS
register (the north-star workload). A model's device step is
`torch_step`, a branch-free function on tensors."""

from .base import Model, NIL  # noqa: F401
from .register import CasRegister  # noqa: F401

#: name → constructor.
MODELS = {
    "cas-register": CasRegister,
}
