"""Append-only list model packed into base-32 int32 digits (the port's
copy of the reference's models/listappend.py, with `torch_step` in place
of `jax_step`).

Elle's list-append workload: per key, clients append unique elements
and read the whole list, and the OBSERVED element order is the write
order (a list never reorders or drops). The transactional anomaly rung
(checker/anomaly.py) feeds on that; this model is the per-key
linearizability face of the same workload, so one history serves both
checkers.

State packing: a list [e₀, …, eₖ] with elements in 1..31 packs as the
base-32 integer ((e₀·32 + e₁)·32 + …) + eₖ — most recent element in the
LOWEST digit, so append is ``state·32 + e``. Element 0 is reserved as
"no digit", which makes the encoding prefix-free: MAX_LEN = 6 elements
stay under 32⁶ = 2³⁰ < int32. The encoder rejects out-of-range
elements and over-long lists loudly.

Ops (``f``, ``a``, ``b``):
  * ``READ a``        — completed read observed packed list ``a``: legal
                        iff state == a (the state IS the list).
  * ``APPEND a b``    — completed append of element ``b`` that observed
                        resulting list with packed prefix ``a``:
                        CAS-shaped — legal iff state == a; state' =
                        a·32 + b.
  * ``APPEND_ANY a``  — crashed append of element ``a``: if it
                        linearizes it appends at whatever the state is;
                        legal iff state < 32⁵ (a signed int32 compare);
                        state' = state·32 + a. Optional.

The step is elementwise in int32 and wraps on overflow, as the
reference's int32 arithmetic does, so illegal transitions agree too.
`rw_classify` marks APPEND as the CAS it is — read a, write a·32+b — and
APPEND_ANY as a write of the NEGATIVE sentinel −a−1: packed lists are
non-negative, so the sentinel is never observed and the crashed op is
never pulled into the cycle tier's required graph.

The model has no dense domain and no mask-mode step, so its rows take
the sort-frontier ladder; `KERNEL_MODEL` is its id in the CUDA kernels'
switch (ops/csrc/models.cuh).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..history.ops import FAIL, INFO, OK, OpPair
from .base import EncodedOp, Model, wrap_i32

READ = 0
APPEND = 1
APPEND_ANY = 2

#: base-32 digits: elements in 1..31, 0 reserved as "no digit".
BASE = 32
MAX_ELEM = BASE - 1
#: 32^6 = 2^30 < int32; the packed-prefix bound is 32^(MAX_LEN-1).
MAX_LEN = 6
_PREFIX_MAX = BASE ** (MAX_LEN - 1)


def pack_list(lst) -> int:
    """Pack an element list (ints in 1..31, ≤ MAX_LEN long) into one
    int32; loud rejection outside the encodable domain."""
    if len(lst) > MAX_LEN:
        raise ValueError(
            f"list-append: {len(lst)} elements exceed MAX_LEN={MAX_LEN} "
            "(packed base-32 int32 state)")
    s = 0
    for e in lst:
        e = int(e)
        if not 1 <= e <= MAX_ELEM:
            raise ValueError(
                f"list-append: element {e} outside [1, {MAX_ELEM}]")
        s = s * BASE + e
    return s


def unpack_list(state: int) -> List[int]:
    """Inverse of pack_list (0 digits never occur, so unambiguous)."""
    out: List[int] = []
    s = int(state)
    while s > 0:
        out.append(s % BASE)
        s //= BASE
    out.reverse()
    return out


class ListAppend(Model):
    name = "list-append"
    n_fcodes = 3
    readonly_fcodes = (READ,)
    #: a history of this model is certifiable by checker/anomaly.py
    txn_anomaly_capable = True
    #: model id in the CUDA kernels' switch (ops/csrc/models.cuh)
    KERNEL_MODEL = 4

    def init_state(self) -> int:
        return 0

    def step(self, state, f, a, b):
        # legality bounds every APPLIED transition under 32^MAX_LEN, but
        # the step is elementwise: illegal transitions wrap like int32
        if f == READ:
            return state, state == a
        if f == APPEND:
            return _wrap32(a * BASE + b), state == a
        if f == APPEND_ANY:
            return _wrap32(state * BASE + a), state < _PREFIX_MAX
        raise ValueError(f"bad opcode {f}")

    def torch_step(self, state, f, a, b):
        """Branch-free step on int32 tensors (broadcasting) -> (state',
        legal); products and sums are taken in int64 and wrapped back to
        int32."""
        import torch

        legal = (((f == READ) & (state == a))
                 | ((f == APPEND) & (state == a))
                 | ((f == APPEND_ANY) & (state < _PREFIX_MAX)))
        s64 = state.to(torch.int64)
        a64 = torch.as_tensor(a).to(torch.int64)
        new_state = torch.where(
            f == APPEND, wrap_i32(a64 * BASE + b),
            torch.where(f == APPEND_ANY, wrap_i32(s64 * BASE + a64),
                        state))
        return new_state, legal

    def step_columnar(self, state, f, a, b):
        """Numpy batch twin of `step`: int64 math and an int32 cast,
        the two's-complement wrap of the scalar step."""
        legal = (((f == READ) & (state == a))
                 | ((f == APPEND) & (state == a))
                 | ((f == APPEND_ANY) & (state < _PREFIX_MAX)))
        a64 = a.astype(np.int64)
        s64 = state.astype(np.int64)
        new_state = np.where(f == APPEND, a64 * BASE + b,
                             np.where(f == APPEND_ANY,
                                      s64 * BASE + a,
                                      s64)).astype(np.int32)
        return new_state, legal

    def rw_classify(self, f: int, a: int, b: int):
        if f == READ:
            return ("r", int(a))
        if f == APPEND:
            return ("rw", int(a), int(a) * BASE + int(b))
        if f == APPEND_ANY:
            # negative sentinel: never observed, never pulled into the
            # required graph (module docstring)
            return ("w", -int(a) - 1)
        return None

    def _encode(self, pair: OpPair) -> Optional[EncodedOp]:
        f = pair.f
        forced = pair.ctype == OK
        if f == "append":
            e = _elem(pair.invoke.value)
            if not forced:
                return EncodedOp(APPEND_ANY, e, 0, False)
            return EncodedOp(APPEND, _prefix(pair.completion.value, e),
                             e, True)
        if f == "read":
            if not forced:
                # an unobserved read constrains nothing — drop it
                return None
            return EncodedOp(READ, pack_list(_lst(pair.completion.value)),
                             0, True)
        raise ValueError(f"list-append: unknown op f={f!r}")

    def encode_pairs_columnar(self, pairs):
        """Tight-loop twin of `_encode` (see Model.encode_pairs_columnar).
        No prune hooks — APPEND_ANY's enable set is state-dependent, so
        the conservative None default stands on both paths."""
        fs, as_, bs = [], [], []
        forced, ips, cps = [], [], []
        for ip, cp, inv, comp in pairs:
            ctype = comp.type if comp is not None else INFO
            if ctype == FAIL:
                continue
            fo = ctype == OK
            f = inv.f
            if f == "append":
                e = _elem(inv.value)
                if fo:
                    fs.append(APPEND)
                    as_.append(_prefix(comp.value, e))
                    bs.append(e)
                else:
                    fs.append(APPEND_ANY)
                    as_.append(e)
                    bs.append(0)
            elif f == "read":
                if not fo:
                    continue
                fs.append(READ)
                as_.append(pack_list(_lst(comp.value)))
                bs.append(0)
            else:
                raise ValueError(f"list-append: unknown op f={f!r}")
            forced.append(fo)
            ips.append(ip)
            cps.append(cp)
        return fs, as_, bs, forced, ips, cps


def _wrap32(x: int) -> int:
    """Two's-complement int32 wrap."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _elem(v) -> int:
    e = int(v)
    if not 1 <= e <= MAX_ELEM:
        raise ValueError(
            f"list-append: element {e} outside [1, {MAX_ELEM}]")
    return e


def _lst(v) -> list:
    if not isinstance(v, (list, tuple)):
        raise ValueError(f"list-append: read observed non-list {v!r}")
    return list(v)


def _prefix(completion_value, elem: int) -> int:
    """Packed prefix of a completed append's recorded result, which
    must be a list ending in the appended element."""
    lst = _lst(completion_value)
    if not lst or int(lst[-1]) != elem:
        raise ValueError(
            f"list-append: completed append of {elem} recorded result "
            f"{lst!r} not ending in it")
    return pack_list(lst[:-1])
