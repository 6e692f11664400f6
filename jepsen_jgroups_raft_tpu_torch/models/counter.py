"""Replicated counter model (the port's copy of the reference's
models/counter.py, with `torch_step` in place of `jax_step`).

Equivalent of the upstream workload's hand-written CounterModel
(workload/counter.clj:100-127): ops are read ("get"), add (delta,
including negative deltas — the client maps decrement onto a negated
add, counter.clj:56-59), and add-and-get (delta plus the observed new
value).

Semantics:
  * a completed add-and-get requires ``state + delta == observed``
    (counter.clj:113-127);
  * an ``info`` add/add-and-get may or may not have applied: info ops
    are *optional* linearization candidates, and an info add-and-get's
    return value is unconstrained, i.e. it degrades to a plain add.

The state after a set of linearized ops is initial + Σ deltas in any
order (`mask_determined`), so the counter rides the mask-mode scan
(ops/dense_scan.py `mask_scan`). `KERNEL_MODEL` is its id in the CUDA
kernels' model switch (ops/csrc/models.cuh).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..history.ops import FAIL, INFO, OK, OpPair
from .base import EncodedOp, Model, _i32, add_i32

READ = 0
ADD = 1
ADD_AND_GET = 2


class Counter(Model):
    name = "counter"
    n_fcodes = 3
    readonly_fcodes = (READ,)
    #: model id in the CUDA kernels' switch (ops/csrc/models.cuh)
    KERNEL_MODEL = 1

    def __init__(self, initial: int = 0):
        self.initial = _i32(initial)

    def init_state(self) -> int:
        return self.initial

    def step(self, state, f, a, b):
        if f == READ:
            return state, state == a
        if f == ADD:
            return _wrap32(state + a), True
        if f == ADD_AND_GET:
            new = _wrap32(state + a)
            return new, new == b
        raise ValueError(f"bad opcode {f}")

    def torch_step(self, state, f, a, b):
        """Branch-free step on int32 tensors (broadcasting) -> (state',
        legal); the addition wraps like `_wrap32`."""
        import torch

        added = add_i32(state, a)
        legal = (f == ADD) | ((f == READ) & (state == a)) | (
            (f == ADD_AND_GET) & (added == b)
        )
        return torch.where(f == READ, state, added), legal

    def step_columnar(self, state, f, a, b):
        """Numpy batch twin of `step`: int32 array addition wraps exactly
        like `_wrap32`."""
        added = (state + a).astype(np.int32)
        legal = (f == ADD) | ((f == READ) & (state == a)) | (
            (f == ADD_AND_GET) & (added == b)
        )
        new_state = np.where(f == READ, state, added).astype(np.int32)
        return new_state, legal

    mask_determined = True

    def mask_delta(self, f, a, b):
        """The delta op (f, a, b) adds to the state: 0 for a read."""
        import torch

        return torch.where(f == READ, 0, a)

    def always_legal(self, f):
        """An add is legal in every state (the unconditional term of
        `torch_step`); bool tensor of f's shape."""
        return f == ADD

    def _encode(self, pair: OpPair) -> Optional[EncodedOp]:
        f = pair.f
        forced = pair.ctype == OK
        # decrement ops are adds of the negated delta (counter.clj:56-59)
        sign = -1 if f in ("decr", "decr-and-get") else 1
        if f in ("read", "get"):
            if not forced:
                return None
            return EncodedOp(READ, _i32(pair.completion.value), 0, True)
        if f in ("add", "decr"):
            return EncodedOp(ADD, sign * _i32(pair.invoke.value), 0, forced)
        if f in ("add-and-get", "decr-and-get"):
            if forced:
                # completed value is [delta, new] (counter.clj:113-127)
                delta, new = pair.completion.value
                return EncodedOp(
                    ADD_AND_GET, sign * _i32(delta), _i32(new), True
                )
            # unknown result: constrains nothing beyond the delta
            return EncodedOp(ADD, sign * _i32(pair.invoke.value), 0, False)
        raise ValueError(f"counter: unknown op f={f!r}")

    def encode_pairs_columnar(self, pairs):
        """Tight-loop twin of `_encode` (byte-identical output). No prune
        hooks, so `prune_observe_enable` stays None on both paths."""
        fs, as_, bs = [], [], []
        forced, ips, cps = [], [], []
        i32 = _i32
        for ip, cp, inv, comp in pairs:
            ctype = comp.type if comp is not None else INFO
            if ctype == FAIL:
                continue
            fo = ctype == OK
            f = inv.f
            sign = -1 if f in ("decr", "decr-and-get") else 1
            if f in ("read", "get"):
                if not fo:
                    continue
                fs.append(READ)
                as_.append(i32(comp.value))
                bs.append(0)
            elif f in ("add", "decr"):
                fs.append(ADD)
                as_.append(sign * i32(inv.value))
                bs.append(0)
            elif f in ("add-and-get", "decr-and-get"):
                if fo:
                    delta, new = comp.value
                    fs.append(ADD_AND_GET)
                    as_.append(sign * i32(delta))
                    bs.append(i32(new))
                else:
                    fs.append(ADD)
                    as_.append(sign * i32(inv.value))
                    bs.append(0)
            else:
                raise ValueError(f"counter: unknown op f={f!r}")
            forced.append(fo)
            ips.append(ip)
            cps.append(cp)
        return fs, as_, bs, forced, ips, cps


def _wrap32(x: int) -> int:
    """Two's-complement int32 wraparound."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x
