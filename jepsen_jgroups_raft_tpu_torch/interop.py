"""State carried across from the reference package.

The checker has no weights: its state is the models, the encoded
histories, the per-group domain tables and the cycle tier's dependency
graphs. These helpers read the fields of a reference model (the
list-append model included), `EncodedHistory`, `DensePlan` or graph dict
by attribute or key (duck typing — nothing of the reference is imported)
and return the port's own objects, so a test can feed the reference's
encodings and graphs straight into the port and never depend on the
port's encoder or graph builder.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .history.packing import EncodedHistory
from .models import MODELS
from .ops.dense_scan import DensePlan


def encoding_from_arrays(events, n_slots: int, n_ops: int,
                         op_index=None, proc=None) -> EncodedHistory:
    """An `EncodedHistory` from plain arrays: events [E, 5] int32;
    op_index defaults to the row positions, proc to None."""
    ev = np.ascontiguousarray(np.asarray(events, dtype=np.int32)
                              .reshape(-1, 5))
    oi = (np.arange(ev.shape[0], dtype=np.int32) if op_index is None
          else np.asarray(op_index, dtype=np.int32).copy())
    pr: Optional[np.ndarray] = (None if proc is None
                                else np.asarray(proc, dtype=np.int32).copy())
    return EncodedHistory(events=ev, op_index=oi, n_slots=int(n_slots),
                          n_ops=int(n_ops), proc=pr)


def encoding_from_reference(obj) -> EncodedHistory:
    """The port's `EncodedHistory` with the fields of a reference one."""
    return encoding_from_arrays(obj.events, obj.n_slots, obj.n_ops,
                                op_index=obj.op_index,
                                proc=getattr(obj, "proc", None))


def plan_from_reference(obj) -> DensePlan:
    """The port's `DensePlan` with the fields of a reference one."""
    return DensePlan(str(obj.kind), int(obj.n_slots), int(obj.n_states),
                     np.ascontiguousarray(np.asarray(obj.val_of,
                                                     dtype=np.int32)))


def model_from_reference(obj):
    """The port's model with a reference model's name and initial state
    (`obj.initial` where the model has one)."""
    cls = MODELS.get(getattr(obj, "name", None))
    if cls is None:
        raise ValueError(f"no port model named {getattr(obj, 'name', None)!r}")
    model = cls()
    if hasattr(obj, "initial"):
        model.initial = int(obj.initial)
    if model.init_state() != int(obj.init_state()):
        raise ValueError(f"{cls.__name__}: initial state "
                         f"{model.init_state()} != {obj.init_state()}")
    return model


def graph_from_reference(g: Optional[dict]) -> Optional[dict]:
    """The port's copy of a reference dependency graph
    (`checker.cycle.build_sc_graph`, `checker.anomaly.build_txn_graph`):
    {"n", "adj" [n, n] uint8, "op_index", and "planes" {po, ww, wr, rw}
    when present}; the skip marker {"skipped-nodes": n} and None pass
    through."""
    if g is None:
        return None
    if "adj" not in g:
        return {"skipped-nodes": int(g["skipped-nodes"])}
    out = {"n": int(g["n"]),
           "adj": np.array(g["adj"], dtype=np.uint8, copy=True),
           "op_index": [int(x) for x in g["op_index"]]}
    if "planes" in g:
        out["planes"] = {k: np.array(v, dtype=np.uint8, copy=True)
                         for k, v in g["planes"].items()}
    return out
