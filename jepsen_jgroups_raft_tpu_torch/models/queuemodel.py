"""Ticket-FIFO queue model packed into an int32 head/tail state (the
port's copy of the reference's models/queuemodel.py, with `torch_step`
in place of `jax_step`).

A log-backed queue assigns each enqueued element a dense ticket (its
sequence index, as a raft log does for appended entries); dequeues pop
tickets in order, so the whole queue state is the pair (head, tail):

    state = head | (tail << 15)        # 15-bit fields, int32-positive
    queue contents ≡ the ticket interval [head, tail)

Ops (``f``, ``a``):
  * ``ENQ t``      — completed enqueue observed ticket ``t``: legal iff
                     ``t == tail``; tail += 1.
  * ``ENQ_ANY``    — crashed enqueue (ticket unknown): always legal;
                     tail += 1. Optional, like every info op.
  * ``DEQ t``      — completed dequeue observed ticket ``t``: legal iff
                     the queue is non-empty and ``t == head``; head += 1.
  * ``DEQ_EMPTY``  — dequeue observed an empty queue: legal iff
                     head == tail.
  * ``DEQ_ANY``    — crashed dequeue: legal iff non-empty; head += 1.

Every mutating op adds a fixed delta (+1 head-units or +1<<15
tail-units) whatever the order, so the model is `mask_determined` and
rides the mask-mode scan (ops/dense_scan.py `mask_scan`), which
evaluates `torch_step`'s legality at each subset-sum state. The field
width bounds histories to < 2^15 enqueues / dequeues; the encoder
rejects longer ones. `KERNEL_MODEL` is the model's id in the CUDA
kernels' switch (ops/csrc/models.cuh).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..history.ops import FAIL, INFO, OK, OpPair
from .base import EncodedOp, Model, add_i32

ENQ = 0
ENQ_ANY = 1
DEQ = 2
DEQ_EMPTY = 3
DEQ_ANY = 4

#: head/tail field width; tickets live in [0, 2^15).
TICKET_BITS = 15
TICKET_MAX = (1 << TICKET_BITS) - 1


def pack_state(head: int, tail: int) -> int:
    return (head & TICKET_MAX) | ((tail & TICKET_MAX) << TICKET_BITS)


def unpack_state(state: int):
    return state & TICKET_MAX, (state >> TICKET_BITS) & TICKET_MAX


class TicketQueue(Model):
    name = "queue"
    n_fcodes = 5
    readonly_fcodes = (DEQ_EMPTY,)
    mask_determined = True
    #: model id in the CUDA kernels' switch (ops/csrc/models.cuh)
    KERNEL_MODEL = 2

    def init_state(self) -> int:
        return 0

    def step(self, state, f, a, b):
        h, t = unpack_state(state)
        if f in (ENQ, ENQ_ANY):
            legal = True if f == ENQ_ANY else a == t
            return pack_state(h, t + 1), legal
        if f in (DEQ, DEQ_ANY):
            legal = h < t if f == DEQ_ANY else (h < t and a == h)
            return pack_state(h + 1, t), legal
        if f == DEQ_EMPTY:
            return state, h == t
        raise ValueError(f"bad opcode {f}")

    def torch_step(self, state, f, a, b):
        """Branch-free step on int32 tensors (broadcasting) -> (state',
        legal). The fields are read with an arithmetic shift, and the
        state advances additively (wrapping), as the reference's
        `jax_step` does."""
        import torch

        h = state & TICKET_MAX
        t = (state >> TICKET_BITS) & TICKET_MAX
        enq = (f == ENQ) | (f == ENQ_ANY)
        deq = (f == DEQ) | (f == DEQ_ANY)
        nonempty = h < t
        legal = ((f == ENQ_ANY)
                 | ((f == ENQ) & (a == t))
                 | ((f == DEQ_ANY) & nonempty)
                 | ((f == DEQ) & nonempty & (a == h))
                 | ((f == DEQ_EMPTY) & (h == t)))
        inc = torch.where(deq, 1, 0) + torch.where(enq, 1 << TICKET_BITS, 0)
        return add_i32(state, inc), legal

    def step_columnar(self, state, f, a, b):
        """Numpy batch twin of the scalar `step`, including `pack_state`'s
        per-field masking at the 2^15 boundary (where `torch_step`'s
        additive form would carry across fields; the encoder rejects
        histories long enough to reach it)."""
        h = state & TICKET_MAX
        t = (state >> TICKET_BITS) & TICKET_MAX
        enq = (f == ENQ) | (f == ENQ_ANY)
        deq = (f == DEQ) | (f == DEQ_ANY)
        nonempty = h < t
        legal = ((f == ENQ_ANY)
                 | ((f == ENQ) & (a == t))
                 | ((f == DEQ_ANY) & nonempty)
                 | ((f == DEQ) & nonempty & (a == h))
                 | ((f == DEQ_EMPTY) & (h == t)))
        nh = np.where(deq, (h + 1) & TICKET_MAX, h)
        nt = np.where(enq, (t + 1) & TICKET_MAX, t)
        new_state = np.where(enq | deq, nh | (nt << TICKET_BITS),
                             state).astype(np.int32)
        return new_state, legal

    def mask_delta(self, f, a, b):
        """The delta op (f, a, b) adds to the state: 1 << 15 for an
        enqueue, 1 for a dequeue, 0 otherwise (int32)."""
        import torch

        enq = (f == ENQ) | (f == ENQ_ANY)
        deq = (f == DEQ) | (f == DEQ_ANY)
        return torch.where(enq, 1 << TICKET_BITS,
                           torch.where(deq, 1, 0)).to(torch.int32)

    def always_legal(self, f):
        """A crashed enqueue (ENQ_ANY) is legal in every state (the
        unconditional term of `torch_step`); bool tensor of f's shape."""
        return f == ENQ_ANY

    def _encode(self, pair: OpPair) -> Optional[EncodedOp]:
        f = pair.f
        forced = pair.ctype == OK
        if f == "enqueue":
            if not forced:
                return EncodedOp(ENQ_ANY, 0, 0, False)
            return EncodedOp(ENQ, _ticket(pair.completion.value), 0, True)
        if f == "dequeue":
            if not forced:
                return EncodedOp(DEQ_ANY, 0, 0, False)
            v = pair.completion.value
            if v is None:
                return EncodedOp(DEQ_EMPTY, 0, 0, True)
            return EncodedOp(DEQ, _ticket(v), 0, True)
        raise ValueError(f"queue: unknown op f={f!r}")

    def encode_pairs_columnar(self, pairs):
        """Tight-loop twin of `_encode` (byte-identical output). No prune
        hooks: an optional enqueue's enable set is state-dependent."""
        fs, as_, bs = [], [], []
        forced, ips, cps = [], [], []
        for ip, cp, inv, comp in pairs:
            ctype = comp.type if comp is not None else INFO
            if ctype == FAIL:
                continue
            fo = ctype == OK
            f = inv.f
            if f == "enqueue":
                if fo:
                    fs.append(ENQ)
                    as_.append(_ticket(comp.value))
                else:
                    fs.append(ENQ_ANY)
                    as_.append(0)
            elif f == "dequeue":
                if not fo:
                    fs.append(DEQ_ANY)
                    as_.append(0)
                elif comp.value is None:
                    fs.append(DEQ_EMPTY)
                    as_.append(0)
                else:
                    fs.append(DEQ)
                    as_.append(_ticket(comp.value))
            else:
                raise ValueError(f"queue: unknown op f={f!r}")
            bs.append(0)
            forced.append(fo)
            ips.append(ip)
            cps.append(cp)
        # Un-ticketed ops too: > 2^15 crashed enqueues / dequeues would
        # let the kernels wrap the packed head/tail fields silently.
        n_enq = sum(1 for f in fs if f in (ENQ, ENQ_ANY))
        n_deq = sum(1 for f in fs if f in (DEQ, DEQ_ANY))
        if n_enq > TICKET_MAX or n_deq > TICKET_MAX:
            raise ValueError(
                f"queue: {max(n_enq, n_deq)} enqueue/dequeue ops exceed "
                f"the packed head/tail field (2^{TICKET_BITS} - 1)")
        return fs, as_, bs, forced, ips, cps


def _ticket(v) -> int:
    t = int(v)
    if not 0 <= t <= TICKET_MAX:
        raise ValueError(
            f"queue: ticket {t} outside [0, {TICKET_MAX}] — histories "
            f"longer than 2^{TICKET_BITS} enqueues exceed the packed "
            "head/tail state")
    return t
