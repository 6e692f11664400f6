"""Operation history: op records, pairing, encoding and packing (a copy
of the reference's jax-free history layer, trimmed to what the port's
main path uses)."""

from .ops import (  # noqa: F401
    INVOKE,
    OK,
    FAIL,
    INFO,
    NEMESIS,
    Op,
    History,
    invoke_op,
    pair_ops,
)
from .packing import (  # noqa: F401
    EV_PAD,
    EV_OPEN,
    EV_FORCE,
    NIL,
    EncodedHistory,
    encode_history,
    pack_batch,
    pack_macro_batch,
)
