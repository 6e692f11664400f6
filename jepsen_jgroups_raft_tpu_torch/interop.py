"""State carried across from the reference package.

The checker has no weights: its state is the models, the encoded
histories, the per-group domain tables, the cycle tier's dependency
graphs and the chunked scan's carry (`carry_from_reference`: a scan
stopped in the reference after k chunks finishes in the port). These helpers read the fields of a reference model (the
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


# ------------------------------------------------------------ chunk carry


def _tensor(x, dtype=None):
    import torch

    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x) if dtype is None else np.asarray(x).astype(dtype)))


def reference_carry_fields(kind: str, carry, model=None) -> dict:
    """The fields of a reference chunk carry ({"inner": the scan carry,
    "left"} as numpy arrays, batch-leading; `kind` "domain", "mask" or
    "sort") by the names of the port's carry view (`carry_fields`), as
    numpy arrays:

      domain: F [B, 2^W, S], T [B, W, S, S'] bool, open, val_of, ok,
          dirty, left — T read from a hoisted carry, or built from the
          slot registers (f, a, b) with `model` (the port's);
      mask:   F [B, 2^W], base, sums [B, 2^W], delta, f, a, b, open, ok,
          dirty, left;
      sort:   masks [B, C, K] uint32 and states [B, C] canonical (live
          entries first, in order; empty ones all ones and 0), f, a, b,
          open, ok, overflow, dirty, left."""
    inner, left = carry["inner"], np.asarray(carry["left"]).astype(np.int32)
    if kind == "domain":
        F, extra, so, ok, dirty, val_of = inner
        val_of = np.asarray(val_of).astype(np.int32)
        if len(extra) == 1:
            T = np.asarray(extra[0]).astype(bool)
        else:
            if model is None:
                raise ValueError("a register-style domain carry needs the "
                                 "model to build its transition rows")
            sf, sa, sb = (_tensor(x, np.int32) for x in extra)
            vo = _tensor(val_of)
            ns, legal = model.torch_step(vo[:, None, :], sf[:, :, None],
                                         sa[:, :, None], sb[:, :, None])
            T = ((ns[..., None] == vo[:, None, None, :])
                 & legal[..., None]).numpy()
        return {"F": np.asarray(F).astype(bool), "T": T,
                "open": np.asarray(so).astype(bool), "val_of": val_of,
                "ok": np.asarray(ok).astype(bool), "dirty": np.asarray(dirty).astype(bool),
                "left": left}
    if kind == "mask":
        F, base, sums, delta, sf, sa, sb, so, ok, dirty = inner
        F = np.asarray(F).astype(bool)
        return {"F": F.reshape(F.shape[0], -1),
                "base": np.asarray(base).astype(np.int32),
                "sums": np.asarray(sums).astype(np.int32),
                "delta": np.asarray(delta).astype(np.int32),
                "f": np.asarray(sf).astype(np.int32), "a": np.asarray(sa).astype(np.int32),
                "b": np.asarray(sb).astype(np.int32), "open": np.asarray(so).astype(bool),
                "ok": np.asarray(ok).astype(bool), "dirty": np.asarray(dirty).astype(bool),
                "left": left}
    if kind == "sort":
        from .ops.linear_scan import canonical_frontier

        masks, states, sf, sa, sb, so, ok, overflow, dirty = inner
        m, st = canonical_frontier(_tensor(masks, np.int64),
                                   _tensor(states, np.int32))
        return {"masks": m.numpy().astype(np.uint32),
                "states": st.numpy().astype(np.int32),
                "f": np.asarray(sf).astype(np.int32), "a": np.asarray(sa).astype(np.int32),
                "b": np.asarray(sb).astype(np.int32), "open": np.asarray(so).astype(bool),
                "ok": np.asarray(ok).astype(bool),
                "overflow": np.asarray(overflow).astype(bool),
                "dirty": np.asarray(dirty).astype(bool), "left": left}
    raise ValueError(f"unknown carry kind {kind!r}")


def carry_fields(kind: str, carry, n_slots: int, size: int = 1) -> dict:
    """The port's chunk carry [B, L] (ops.dense_scan.dense_carry_layout /
    mask_carry_layout, ops.linear_scan.sort_carry_layout) by field, in
    `reference_carry_fields`' names and shapes; `size` is S (domain) or
    C (sort). A mask carry also gives "col", the column totals it
    stores, and "sums" rebuilt from them."""
    import torch

    from .ops import dense_scan as ds
    from .ops import linear_scan as ls
    from .ops.kernel_ir import unpack_bits

    carry = torch.as_tensor(carry).cpu()
    B, W = int(carry.shape[0]), int(n_slots)
    if kind == "domain":
        lay = ds.dense_carry_layout(W, size)
        F, T, so, ok, dirty = ds._dense_unpack(carry, lay, W, size)
        out = {"F": F.numpy(), "T": T.numpy(), "open": so.numpy(),
               "val_of": lay.view(carry, "val_of").numpy()}
    elif kind == "mask":
        lay = ds.mask_carry_layout(W)
        v = lay.view
        out = {"F": unpack_bits(v(carry, "F"), 1 << W).numpy(),
               "base": v(carry, "base")[:, 0].numpy(),
               "col": v(carry, "col").numpy(),
               "sums": ds.mask_sums(v(carry, "col")).numpy(),
               "open": (v(carry, "open") != 0).numpy()}
        out.update({k: v(carry, k).numpy() for k in ("delta", "f", "a", "b")})
    elif kind == "sort":
        lay = ls.sort_carry_layout(W, size)
        v = lay.view
        K = ls.mask_words(W)
        out = {"masks": v(carry, "masks").numpy().reshape(B, size, K)
               .astype(np.uint32),
               "states": v(carry, "states").numpy(),
               "open": (v(carry, "open") != 0).numpy(),
               "overflow": (v(carry, "overflow")[:, 0] != 0).numpy()}
        out.update({k: v(carry, k).numpy() for k in ("f", "a", "b")})
    else:
        raise ValueError(f"unknown carry kind {kind!r}")
    out["ok"] = (lay.view(carry, "ok")[:, 0] != 0).numpy()
    out["dirty"] = (lay.view(carry, "dirty")[:, 0] != 0).numpy()
    out["left"] = lay.view(carry, "left")[:, 0].numpy()
    return out


def carry_from_reference(kind: str, carry, model=None):
    """The port's chunk carry [B, L] int32 (on the CPU) holding a
    reference chunk carry's state: `kind` "domain", "mask" or "sort",
    `carry` the reference's {"inner", "left"} as numpy arrays (`model`,
    the port's, builds a domain carry's transition rows from slot
    registers). A scan resumed from it in the port reaches the
    reference's verdict: the state is the same, field for field (the
    sort frontier squeezed to its live entries, in order; a mask
    carry's sums kept as their column totals, sums[1 << c])."""
    import torch

    from .ops import dense_scan as ds
    from .ops import linear_scan as ls

    f = reference_carry_fields(kind, carry, model)
    B = int(f["left"].shape[0])
    t = {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.int64) if v.dtype == np.uint32 else v))
        for k, v in f.items()}
    if kind == "domain":
        W, S = int(t["open"].shape[1]), int(t["val_of"].shape[1])
        lay = ds.dense_carry_layout(W, S)
        state = (t["F"], t["T"], t["open"], t["ok"], t["dirty"])
        c = torch.zeros((B, lay.length), dtype=torch.int32)
        lay.view(c, "val_of")[:] = t["val_of"]
        return ds._dense_pack(state, c, lay, W, S, t["left"])
    if kind == "mask":
        W = int(t["open"].shape[1])
        lay = ds.mask_carry_layout(W)
        state = (t["F"].view(B, 1 << W, 1), t["base"], t["sums"], t["delta"],
                 t["f"], t["a"], t["b"], t["open"], t["ok"], t["dirty"])
        c = torch.zeros((B, lay.length), dtype=torch.int32)
        return ds._mask_pack(state, c, lay, W, t["left"])
    W = int(t["open"].shape[1])
    C = int(t["states"].shape[1])
    lay = ls.sort_carry_layout(W, C)
    state = (t["masks"], t["states"], t["f"], t["a"], t["b"], t["open"],
             t["ok"], t["overflow"], t["dirty"])
    c = torch.zeros((B, lay.length), dtype=torch.int32)
    return ls._sort_pack(state, c, lay, t["left"])
