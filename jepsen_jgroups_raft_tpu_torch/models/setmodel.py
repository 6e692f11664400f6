"""Grow-only set model over a 32-wide membership bitmask (the port's copy
of the reference's models/setmodel.py, with `torch_step` in place of
`jax_step`).

Jepsen's set workload: clients ``add`` small integer elements and
``read`` the whole membership; the checker asks whether some
linearization of the adds explains every observed membership. State is
one int32 — bit ``e`` set ⇔ element ``e`` is a member.

Op encoding (``f``, ``a``, ``b``):
  * ``ADD e``      — state' = state | (1 << e); always legal.
  * ``READ mask``  — legal iff state == mask (a read pins every bit).

``fail`` adds are dropped, ``info`` adds are optional forever, ``info``
reads constrain nothing and are dropped.

Kernel routing: OR is order-independent but not additive, so the
class-level ``mask_determined`` stays False. Per history, a set with at
most 4 distinct adds has an enumerable domain (`dense_domain`: the
dense-domain scan); one whose adds hit distinct bits absent from the
initial mask is the additive special case (`mask_eligible`: subset sums
of single-bit deltas equal the OR, the mask-mode scan); every other
history takes the sort-frontier ladder (ops/linear_scan.py).
`KERNEL_MODEL` is the model's id in the CUDA kernels' switch
(ops/csrc/models.cuh).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..history.ops import FAIL, INFO, OK, OpPair
from .base import EncodedOp, Model, _i32

ADD = 0
READ = 1

#: Membership width: elements live in [0, 32) so the mask fits int32.
SET_WIDTH = 32


def element_mask(value) -> int:
    """Element collection (or pre-packed int mask) → int32 bitmask."""
    if value is None:
        return 0
    if isinstance(value, int):
        if value >> SET_WIDTH:
            raise ValueError(f"set mask {value:#x} exceeds {SET_WIDTH} bits")
        return _i32(value & 0xFFFFFFFF)
    mask = 0
    for e in value:
        e = int(e)
        if not 0 <= e < SET_WIDTH:
            raise ValueError(f"set element {e} outside [0, {SET_WIDTH})")
        mask |= 1 << e
    return _i32(mask)


class GSet(Model):
    name = "set"
    n_fcodes = 2
    readonly_fcodes = (READ,)
    #: model id in the CUDA kernels' switch (ops/csrc/models.cuh)
    KERNEL_MODEL = 3

    def __init__(self, initial: int = 0):
        self.initial = element_mask(initial)

    def init_state(self) -> int:
        return self.initial

    def step(self, state, f, a, b):
        if f == ADD:
            return _or32(state, a), True
        if f == READ:
            return state, state == a
        raise ValueError(f"bad opcode {f}")

    def torch_step(self, state, f, a, b):
        """Branch-free step on int32 tensors (broadcasting) -> (state',
        legal): any opcode but ADD acts as a READ."""
        import torch

        is_add = f == ADD
        legal = is_add | (state == a)
        return torch.where(is_add, state | a, state), legal

    def step_columnar(self, state, f, a, b):
        """Numpy batch twin of `step`: int32 bitwise OR matches `_or32`
        bit for bit."""
        is_add = f == ADD
        legal = is_add | (state == a)
        new_state = np.where(is_add, state | a, state).astype(np.int32)
        return new_state, legal

    def mask_delta(self, f, a, b):
        """The delta op (f, a, b) adds in the mask-mode scan: its element
        bit for an ADD, 0 otherwise. Equal to the OR only under
        `mask_eligible`'s distinct-bit proof."""
        import torch

        return torch.where(f == ADD, a, 0)

    def always_legal(self, f):
        """An add is legal in every state (the unconditional term of
        `torch_step`); bool tensor of f's shape."""
        return f == ADD

    def mask_eligible(self, events) -> bool:
        """Additive special case: every ADD in the history carries a
        distinct element bit not present in the initial mask (then
        subset sums of the deltas equal the OR the step computes)."""
        from ..history.packing import EV_OPEN

        ev = np.asarray(events)
        opens = ev[(ev[:, 0] == EV_OPEN) & (ev[:, 2] == ADD)]
        adds = opens[:, 3].astype(np.int64) & 0xFFFFFFFF
        if adds.size == 0:
            return True
        combined = np.bitwise_or.reduce(adds)
        if combined & (np.int64(self.initial) & 0xFFFFFFFF):
            return False
        one_bit = np.all(adds & (adds - 1) == 0) and np.all(adds != 0)
        return bool(one_bit and
                    int(combined).bit_count() == int(adds.size))

    def dense_domain(self, events) -> Optional[list]:
        """Reachable states = initial ∪ {initial | OR(S)} over subsets S
        of the distinct add masks, when at most 4 distinct adds occur;
        None otherwise."""
        from ..history.packing import EV_OPEN

        ev = np.asarray(events)
        opens = ev[(ev[:, 0] == EV_OPEN) & (ev[:, 2] == ADD)]
        distinct = sorted({int(a) & 0xFFFFFFFF for a in opens[:, 3]})
        if len(distinct) > 4:  # 2^k states; DENSE_MAX_STATES is 16
            return None
        base = int(self.initial) & 0xFFFFFFFF
        states = {base}
        for m in distinct:
            states |= {s | m for s in states}
        return [_u2i(base)] + sorted(_u2i(s) for s in states - {base})

    def _encode(self, pair: OpPair) -> Optional[EncodedOp]:
        f = pair.f
        forced = pair.ctype == OK
        if f == "add":
            elem = int(pair.invoke.value)
            if not 0 <= elem < SET_WIDTH:
                raise ValueError(
                    f"set: element {elem} outside [0, {SET_WIDTH})")
            return EncodedOp(ADD, _i32(1 << elem), 0, forced)
        if f == "read":
            if not forced:
                return None  # unknown read constrains nothing
            return EncodedOp(READ, element_mask(pair.completion.value),
                             0, True)
        raise ValueError(f"set: unknown op f={f!r}")

    def encode_pairs_columnar(self, pairs):
        """Tight-loop twin of `_encode` (byte-identical output). No prune
        hooks: an add's enable set depends on the current state (OR)."""
        fs, as_, bs = [], [], []
        forced, ips, cps = [], [], []
        for ip, cp, inv, comp in pairs:
            ctype = comp.type if comp is not None else INFO
            if ctype == FAIL:
                continue
            fo = ctype == OK
            f = inv.f
            if f == "add":
                elem = int(inv.value)
                if not 0 <= elem < SET_WIDTH:
                    raise ValueError(
                        f"set: element {elem} outside [0, {SET_WIDTH})")
                fs.append(ADD)
                as_.append(_i32(1 << elem))
                bs.append(0)
            elif f == "read":
                if not fo:
                    continue
                fs.append(READ)
                as_.append(element_mask(comp.value))
                bs.append(0)
            else:
                raise ValueError(f"set: unknown op f={f!r}")
            forced.append(fo)
            ips.append(ip)
            cps.append(cp)
        return fs, as_, bs, forced, ips, cps


def _or32(state: int, mask: int) -> int:
    """int32 OR (negative masks = high bit)."""
    v = (state & 0xFFFFFFFF) | (mask & 0xFFFFFFFF)
    return v - (1 << 32) if v >= (1 << 31) else v


def _u2i(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v
