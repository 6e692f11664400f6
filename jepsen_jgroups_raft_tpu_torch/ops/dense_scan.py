"""Dense-bitset frontier scan: exact linearizability for small domains.

The port of the reference's dense-domain scan (`jepsen_jgroups_raft_tpu/
ops/dense_scan.py` `dense_step_parts` and its Pallas twin
`ops/pallas_scan.py` `_build_kernel`). A CAS register over a handful of
values has a reachable state domain enumerable from the history (the
initial value plus every written / cas-to value), so with a small
concurrency window W and domain S the whole powerset-of-window × domain
fits a dense boolean frontier F[2^W, S]: F[m, s] = "some linearization
of exactly the ops in mask m ends in state s".

Per event (packing.py's stream):

  OPEN w:  latch (f, a, b) of slot w — here as the slot's transition row
           T_w[s, s'] = legal(s) & (step(s) == s').
  closure: at a FORCE after an OPEN, repeat sweeps until fixpoint: for
           each open slot w, configurations without bit w flow through
           T_w into the bit-w half.
  FORCE w: survivors must hold bit w; the bit is recycled by moving the
           bit-w half onto the other; ok &= "some survivor".

Mask mode (the reference's `mask_step_parts`) serves models whose state
after a set of ops does not depend on their order (`mask_determined`:
the counter, the ticket queue): the frontier is a bare bitset F[2^W],
config m's state is base + sums[m] (subset sums of the open slots'
deltas, base holding the retired ones), and legality of every open slot
at every mask is one table per closing FORCE. W ≤ 12.

This module holds:

  * the window grouping (`dense_plan`, `dense_plans_grouped`) — numpy,
    identical groups, kinds and `rest` to the reference's;
  * `dense_scan` and `mask_scan`, the wrappers of the hand-written CUDA
    kernels (ops/csrc/dense_scan.cu, ops/csrc/mask_scan.cu);
  * `dense_scan_plain` and `mask_scan_plain`, the same functions in
    plain PyTorch, which the CPU tests use and chip_smoke.py holds the
    kernels to on the card.

`val_of[S]` is a per-history input (id 0 = initial state); padding
repeats id 0, so duplicate ids are expected and must all light up.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..history.packing import EncodedHistory
from ..models.base import Model, wrap_i32
from . import _build
from .kernel_ir import (DENSE_MAX_CELLS, DENSE_MAX_SLOTS, DENSE_MAX_STATES,
                        MASK_DENSE_MAX_SLOTS, CarryLayout, carry_layout,
                        chunk_flags, chunk_scan, closure_fixpoint,
                        force_arith, macro_row_ints, make_stream_step,
                        new_carry, pack_bits, unpack_bits)
from .verdict_counts import check_real, counts_out, scan_counts_plain


@dataclass(frozen=True)
class DensePlan:
    """How to run a window group on a dense kernel.

    kind "domain": frontier F[2^W, S] over an enumerated value domain;
    `val_of` [B, S] is the per-history id→value table (kernel input).
    kind "mask": frontier F[2^W] for order-independent models
    (`model.mask_determined`), per-mask states from subset sums; `val_of`
    is a [B, 1] dummy, as in the reference, which the mask kernel does
    not read."""

    kind: str
    n_slots: int
    n_states: int
    val_of: np.ndarray

    @property
    def kernel_tag(self) -> str:
        """Reporting label (checker results)."""
        return "dense" if self.kind == "domain" else "dense-mask"


def _fits(W: int, S: int) -> bool:
    return (W <= DENSE_MAX_SLOTS and S <= DENSE_MAX_STATES
            and (1 << W) * S <= DENSE_MAX_CELLS)


def _mask_plan(W: int, B: int) -> DensePlan:
    return DensePlan("mask", W, 1, np.zeros((B, 1), dtype=np.int32))


def dense_plan(model, encs: Sequence[EncodedHistory]) -> Optional[DensePlan]:
    """One plan for a whole batch at its widest window — domain mode
    first, mask mode second — or None when neither fits. Domain tables
    are padded with their own id-0 value."""
    if not encs:
        return None
    W = max((e.n_slots for e in encs), default=0)
    domains = []
    for e in encs:
        d = model.dense_domain(e.events)
        if d is None:
            domains = None
            break
        domains.append(np.asarray(d, dtype=np.int32))
    if domains is not None:
        S = max((len(d) for d in domains), default=1)
        if _fits(W, S):
            S_b, val_of = _pad_domains(domains, range(len(domains)))
            return DensePlan("domain", max(W, 1), S_b, val_of)
    if W <= MASK_DENSE_MAX_SLOTS and \
            all(model.mask_eligible(e.events) for e in encs):
        return _mask_plan(max(W, 1), len(encs))
    return None


#: Don't launch a group for fewer histories than this — merge the
#: stragglers into the next-wider window group instead.
DENSE_MIN_GROUP = 16

#: Past this legacy event count a history counts as LONG.
MERGE_MAX_EVENTS = 4096

#: Merged histories share one launch only while the group's window
#: spread stays within this many slots of the widest member.
MERGE_LONG_MAX_SPREAD = 3


def _merge_long_groups() -> bool:
    """Whether LONG histories merge into window-proximate cluster
    launches. Off unless ``JGRAFT_MERGE_LONG=1`` (the reference's
    default off the TPU; the port asks no backend)."""
    return os.environ.get("JGRAFT_MERGE_LONG") == "1"


def _merge_all_groups() -> bool:
    """Whether SHORT histories merge into cluster launches too
    (``JGRAFT_MERGE_ALL=1``, off by default, as in the reference).
    ``JGRAFT_MERGE_LONG=0`` forbids it as well."""
    return (os.environ.get("JGRAFT_MERGE_ALL", "0") == "1"
            and os.environ.get("JGRAFT_MERGE_LONG") != "0")


def _pad_domains(domains, idxs):
    """[len(idxs), S] id→value table from per-history domains, S bucketed
    to a power of two, rows padded with their own id-0 (initial)
    value."""
    ds = [domains[i] for i in idxs]
    S = max(len(d) for d in ds)
    S_b = 1
    while S_b < S:
        S_b *= 2
    val_of = np.empty((len(ds), S_b), dtype=np.int32)
    for r, d in enumerate(ds):
        val_of[r, : len(d)] = d
        val_of[r, len(d):] = d[0]
    return S_b, val_of


def dense_plans_grouped(model, encs: Sequence[EncodedHistory]):
    """Route each history of a batch to its dense window group.

    Returns (groups, rest): `groups` is [(indices, DensePlan)] over the
    dense-eligible histories, partitioned by kernel kind (domain first,
    then mask) and concurrency window (kernel cost is exponential in W,
    and a real batch's windows spread with per-history crash counts);
    `rest` holds the indices beyond both kinds' caps. Groups of fewer
    than DENSE_MIN_GROUP histories merge into the next-wider window; a
    merged domain group whose padded cells exceed the cap sheds its
    widest members to `rest`. With ``JGRAFT_MERGE_LONG=1`` long
    histories, and with ``JGRAFT_MERGE_ALL=1`` short ones too, pool into
    spread-capped cluster launches. Each history's domain is scanned
    once. Same groups, kinds, `rest` and `val_of` as the reference."""
    domains = [model.dense_domain(e.events) for e in encs]
    buckets: dict = {}
    rest: list = []
    for i, (e, d) in enumerate(zip(encs, domains)):
        W = max(e.n_slots, 1)
        if d is not None and _fits(W, len(d)):
            buckets.setdefault(("domain", W), []).append(i)
        elif W <= MASK_DENSE_MAX_SLOTS and model.mask_eligible(e.events):
            buckets.setdefault(("mask", W), []).append(i)
        else:
            rest.append(i)
    groups: list = []

    def flush(kind, pending):
        """(indices, plan) for one group at the group's own widest
        window, or None when the whole group sheds."""
        w_eff = max(max(encs[i].n_slots for i in pending), 1)
        if kind == "mask":
            return (pending, _mask_plan(w_eff, len(pending)))
        S, val_of = _pad_domains(domains, pending)
        while (1 << w_eff) * S > DENSE_MAX_CELLS and pending:
            widest = max(pending, key=lambda i: encs[i].n_slots)
            pending.remove(widest)
            rest.append(widest)
            if pending:
                S, val_of = _pad_domains(domains, pending)
                w_eff = max(max(encs[i].n_slots for i in pending), 1)
        if not pending:
            return None
        return (pending, DensePlan("domain", w_eff, S, val_of))

    merge_long, merge_all = _merge_long_groups(), _merge_all_groups()
    for kind in ("domain", "mask"):
        windows = sorted(w for k, w in buckets if k == kind)
        if merge_long or merge_all:
            # one pool of long histories, and under MERGE_ALL one of
            # short ones: a short history merged into a long launch would
            # be padded to the long length
            pools = [[i for w in windows for i in buckets[(kind, w)]
                      if (encs[i].n_events > MERGE_MAX_EVENTS) == is_long]
                     for is_long in ((True, False) if merge_all
                                     else (True,))]
            pools = [p for p in pools if p]
            pooled = set(i for p in pools for i in p)
            if pooled:
                for w in windows:
                    buckets[(kind, w)] = [i for i in buckets[(kind, w)]
                                          if i not in pooled]
                windows = [w for w in windows if buckets[(kind, w)]]
            for pool in pools:
                by_w = sorted(pool, key=lambda i: encs[i].n_slots,
                              reverse=True)
                while by_w:
                    w_top = encs[by_w[0]].n_slots
                    cut = w_top - MERGE_LONG_MAX_SPREAD
                    # greedy take, re-checking the padded cell envelope
                    # as members join; a member that would overflow it
                    # waits for a later, narrower cluster
                    take, rest_pool, s_run = [], [], 1
                    for i in by_w:
                        if encs[i].n_slots < cut:
                            rest_pool.append(i)
                            continue
                        s_new = max(s_run, len(domains[i])
                                    if kind == "domain" else 1)
                        s_pad = 1
                        while s_pad < s_new:
                            s_pad *= 2
                        if take and (1 << w_top) * s_pad > DENSE_MAX_CELLS:
                            rest_pool.append(i)
                            continue
                        take.append(i)
                        s_run = s_new
                    by_w = rest_pool
                    g = flush(kind, take)
                    if g is not None:
                        groups.append(g)
        pending: list = []
        for w in windows:
            bucket = buckets[(kind, w)]
            long_bucket = any(encs[i].n_events > MERGE_MAX_EVENTS
                              for i in bucket)
            if long_bucket and pending:
                # short stragglers flush first: merging them into a long
                # launch would pad their streams to the long length
                g = flush(kind, pending)
                if g is not None:
                    groups.append(g)
                pending = []
            pending += bucket
            min_group = 1 if long_bucket else DENSE_MIN_GROUP
            if len(pending) >= min_group or w == windows[-1]:
                g = flush(kind, pending)
                if g is not None:
                    groups.append(g)
                pending = []
    return groups, rest


# ----------------------------------------------------------- plain version


def dense_sweep_fn(T, slot_open):
    """One closure sweep of the plain version, as a function F -> F'.

    T [B, W, S, S'] bool transition rows, slot_open [B, W] bool; F [B,
    2^W, S] bool. Slots w = 0 .. W-1 in turn: every mask m without bit w
    flows through open slot w's rows into m | bit w (closed slots
    contribute nothing)."""
    B, W, S = int(T.shape[0]), int(T.shape[1]), int(T.shape[2])
    Te = (T & slot_open[:, :, None, None]).to(torch.float32)

    def sweep(F):
        M = int(F.shape[1])
        for w in range(W):
            Fb = F.view(B, M >> (w + 1), 2, 1 << w, S)
            src = Fb[:, :, 0].reshape(B, -1, S).to(torch.float32)
            contrib = (torch.bmm(src, Te[:, w]) > 0).view(
                B, M >> (w + 1), 1 << w, S)
            F = torch.stack([Fb[:, :, 0], Fb[:, :, 1] | contrib],
                            dim=2).reshape(B, M, S)
        return F

    return sweep


def _dense_step(model, W: int, vo, macro_p: Optional[int],
                stats: Optional[dict]):
    """The per-event body of the dense-domain plain version, shared by
    the one-shot scan and the chunk form: step(state, rows) -> state over
    the state (F [B, 2^W, S] bool, T [B, W, S, S'] bool, slot_open [B, W],
    ok [B], dirty [B]), with the transition rows latched at OPEN (as the
    kernel builds them) from the domain tables vo [B, S]."""
    dev = vo.device
    slot_ids = torch.arange(W, dtype=torch.int32, device=dev)
    if stats is not None:
        for k in ("force_rows", "sweeps", "slot_passes"):
            stats.setdefault(k, 0)

    def t_rows(f, a, b):
        """Transition rows for ops (f, a, b) [B, K] -> [B, K, S, S']."""
        ns, legal = model.torch_step(vo[:, None, :], f[:, :, None],
                                     a[:, :, None], b[:, :, None])
        return (ns[..., None] == vo[:, None, None, :]) & legal[..., None]

    def latch(carry, slot, f, a, b, is_open, upd):
        F, T, slot_open, ok, dirty = carry
        row = t_rows(f[:, None], a[:, None], b[:, None])[:, 0]  # [B,S,S']
        T = torch.where(upd[:, :, None, None], row[:, None], T)
        return (F, T, slot_open | upd, ok, dirty | is_open)

    def macro_latch(carry, pslot, pf, pa, pb, valid, n, eq, upd):
        F, T, slot_open, ok, dirty = carry
        rows = t_rows(pf, pa, pb)                               # [B,P,S,S']
        picked = (eq[:, :, :, None, None] & rows[:, None]).any(dim=2)
        T = torch.where(upd[:, :, None, None], picked, T)
        return (F, T, slot_open | upd, ok, dirty | (n > 0))

    def force_tail(carry, is_force, slot):
        F, T, slot_open, ok, dirty = carry
        active = is_force & dirty
        if bool(active.any()):
            F, sweeps = closure_fixpoint(W, dense_sweep_fn(T, slot_open), F,
                                         active)
            if stats is not None:
                live = ok.to(torch.int64)
                stats["sweeps"] += int((sweeps * live).sum())
                stats["slot_passes"] += int(
                    (sweeps * live * slot_open.sum(dim=1)).sum())
        dirty = dirty & ~is_force
        if stats is not None:
            stats["force_rows"] += int((is_force & ok).sum())
        F_forced, alive = force_arith(F, slot.clamp(0, W - 1))
        F = torch.where(is_force[:, None, None], F_forced, F)
        ok = ok & (~is_force | alive)
        slot_open = slot_open & ~((slot_ids[None, :] == slot[:, None])
                                  & is_force[:, None])
        return (F, T, slot_open, ok, dirty)

    return make_stream_step(W, latch, macro_latch, force_tail, macro_p)


def dense_scan_plain(events, val_of, n_slots: int,
                     macro_p: Optional[int] = None, n_events=None,
                     model=None, stats: Optional[dict] = None):
    """The dense-domain scan in plain PyTorch: a Python loop over event
    rows, batched over B, following the reference's `dense_step_parts`
    (transition rows hoisted to OPEN, as the kernel builds them).

    events [B, E, 5] int32 (legacy) or [B, E, 3 + 4·P] (macro_p=P);
    val_of [B, S] int32; n_events [B] (rows past a history's length are
    EV_PAD no-ops, so it only bounds the loop). Returns ok [B] bool on
    events' device. `stats`, when given, accumulates the work the
    data needed over rows still alive: "force_rows" (FORCE events),
    "sweeps" (closure sweeps) and "slot_passes" (sweeps × open slots)."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
    W, S = int(n_slots), int(val_of.shape[1])
    B, E = int(events.shape[0]), int(events.shape[1])
    step = _dense_step(model, W, val_of, macro_p, stats)
    state = _dense_fresh(B, W, S, events.device)
    n_scan = E if n_events is None or B == 0 else \
        min(E, int(torch.as_tensor(n_events).max()))
    for e in range(n_scan):
        state = step(state, events[:, e])
    return state[3]


def _dense_fresh(B: int, W: int, S: int, dev):
    """The dense-domain scan's initial state: the empty mask in state id
    0, no slot latched, ok, not dirty."""
    F = torch.zeros((B, 1 << W, S), dtype=torch.bool, device=dev)
    F[:, 0, 0] = True
    return (F, torch.zeros((B, W, S, S), dtype=torch.bool, device=dev),
            torch.zeros((B, W), dtype=torch.bool, device=dev),
            torch.ones((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev))


# ----------------------------------------------------------- chunk forms


def dense_carry_layout(n_slots: int, n_states: int) -> CarryLayout:
    """The chunk carry of the dense-domain scan at window W and table
    size S (ops/csrc/dense_scan.cu reads and writes the same): after
    CARRY_HEAD, "open" [W] (0/1), "val_of" [S] (the domain table),
    "T" [W·FS] (transition rows: bit s' of T[w·FS + s] = slot w's op
    takes state id s to s'; zero for s ≥ S), "F" (the frontier, bit m·FS
    + s of the packed words; FS = 2^field_log2 of `dense_layout`)."""
    W, S = int(n_slots), int(n_states)
    lf = dense_layout(W, S).field_log2
    return carry_layout("domain", [
        ("open", W), ("val_of", S), ("T", W << lf),
        ("F", max(1, (1 << (W + lf)) // 32))])


def mask_carry_layout(n_slots: int) -> CarryLayout:
    """The chunk carry of the mask-mode scan at window W (ops/csrc/
    mask_scan.cu reads and writes the same): after CARRY_HEAD, "base",
    the slot registers "open", "f", "a", "b", "delta" [W], "col" [W] —
    the running total added to column c of the reference's sums[2^W], so
    sums[m] = Σ_{c in m} col[c] mod 2^32 and col[c] = sums[1 << c] — and
    "F" (bit m of the packed words)."""
    W = mask_layout(n_slots).n_slots
    return carry_layout("mask", [
        ("base", 1), ("open", W), ("f", W), ("a", W), ("b", W),
        ("delta", W), ("col", W), ("F", max(1, (1 << W) // 32))])


def dense_chunk_init(val_of, n_events, n_slots: int) -> torch.Tensor:
    """A fresh dense-domain carry [B, L] int32 on n_events' device: the
    empty mask in state id 0, `left` = n_events, the domain tables."""
    S = int(val_of.shape[1])
    lay = dense_carry_layout(n_slots, S)
    c = new_carry(lay, n_events)
    lay.view(c, "val_of")[:] = val_of.to(torch.int32)
    lay.view(c, "F")[:, 0] = 1
    return c


def mask_chunk_init(n_events, n_slots: int, model) -> torch.Tensor:
    """A fresh mask-mode carry: the empty mask, base = the model's
    initial state, `left` = n_events."""
    lay = mask_carry_layout(n_slots)
    c = new_carry(lay, n_events)
    lay.view(c, "base")[:] = int(model.init_state())
    lay.view(c, "F")[:, 0] = 1
    return c


def _dense_unpack(carry, lay: CarryLayout, W: int, S: int):
    B = int(carry.shape[0])
    FS = lay.view(carry, "T").shape[1] // W
    F = unpack_bits(lay.view(carry, "F"), (1 << W) * FS)
    T = unpack_bits(lay.view(carry, "T").reshape(B * W * FS, 1), S)
    return (F.view(B, 1 << W, FS)[:, :, :S].contiguous(),
            T.view(B, W, FS, S)[:, :, :S].contiguous(),
            lay.view(carry, "open") != 0, lay.view(carry, "ok")[:, 0] != 0,
            lay.view(carry, "dirty")[:, 0] != 0)


def _dense_pack(state, carry, lay: CarryLayout, W: int, S: int, left):
    F, T, so, ok, dirty = state
    B = int(carry.shape[0])
    FS = lay.view(carry, "T").shape[1] // W
    out = carry.clone()
    Fp = torch.zeros((B, 1 << W, FS), dtype=torch.bool, device=F.device)
    Fp[:, :, :S] = F
    lay.view(out, "F")[:] = pack_bits(Fp.view(B, -1))
    Tw = (T.to(torch.int64) << torch.arange(S, device=T.device)).sum(3)
    Tp = torch.zeros((B, W, FS), dtype=torch.int64, device=T.device)
    Tp[:, :, :S] = Tw
    lay.view(out, "T")[:] = wrap_i32(Tp.view(B, -1))
    lay.view(out, "open")[:] = so.to(torch.int32)
    lay.view(out, "ok")[:, 0] = ok.to(torch.int32)
    lay.view(out, "dirty")[:, 0] = dirty.to(torch.int32)
    lay.view(out, "left")[:, 0] = left.to(torch.int32)
    return out


def dense_chunk_plain(carry, events, n_slots: int, n_states: int,
                      macro_p: Optional[int] = None, model=None,
                      width: Optional[int] = None,
                      stats: Optional[dict] = None):
    """One chunk of the dense-domain scan in plain PyTorch: the body of
    `dense_scan_plain` over the rows of `events` [B, w, R] (each row's
    first `left` ones; `width`, default w, is the slice's length in the
    schedule), from the carry [B, L] of `dense_carry_layout`. Returns
    (carry', decided, exhausted, ok, overflow), the reference's
    `chunk_step_fns` contract (overflow is always False). `stats` as
    `dense_scan_plain`'s."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
    W, S = int(n_slots), int(n_states)
    lay = dense_carry_layout(W, S)
    step = _dense_step(model, W, lay.view(carry, "val_of"), macro_p, stats)
    state, left = chunk_scan(step, _dense_unpack(carry, lay, W, S), events,
                             lay.view(carry, "left")[:, 0], width)
    out = _dense_pack(state, carry, lay, W, S, left)
    return (out,) + chunk_flags(out, lay)


def mask_sweep_fn(legal):
    """One closure sweep of the mask-mode plain version, as F -> F'.

    legal [B, W, M] bool: slot w's op is legal in mask m's state (closed
    slots all False); F [B, M, 1] bool. Slots w = 0 .. W-1 in turn, each
    pass seeing the ones before: F[m | bit w] |= F[m] & legal[w, m] for
    every mask m without bit w."""
    B, W, M = (int(x) for x in legal.shape)

    def sweep(F):
        for w in range(W):
            Fb = F.view(B, M >> (w + 1), 2, 1 << w)
            Lb = legal[:, w].reshape(B, M >> (w + 1), 2, 1 << w)
            grown = Fb[:, :, 1] | (Fb[:, :, 0] & Lb[:, :, 0])
            F = torch.stack([Fb[:, :, 0], grown], dim=2).reshape(B, M, 1)
        return F

    return sweep


#: The work counters `mask_scan_plain` accumulates into its `stats`.
MASK_STATS = ("force_rows", "closures", "sweeps", "slot_passes",
              "legal_steps", "legal_needed", "ballots_lazy")


def _mask_step(model, W: int, macro_p: Optional[int], dev,
               acc: Optional[dict]):
    """The per-event body of the mask-mode plain version, shared by the
    one-shot scan and the chunk form: step(state, rows) -> state over the
    reference's carry (F [B, 2^W, 1] bool, base [B], sums [B, 2^W],
    delta, f, a, b [B, W] int32, slot_open [B, W], ok, dirty [B]).
    `acc`, when given, accumulates `MASK_STATS` (on the device)."""
    M = 1 << W
    i64 = torch.int64
    slot_ids = torch.arange(W, dtype=torch.int32, device=dev)
    bit = ((torch.arange(M, device=dev)[:, None]
            >> torch.arange(W, device=dev)[None, :]) & 1)      # [M, W]

    def cols(slot):
        """[B, M] (or [B, M, P]) column of each row's clipped slot."""
        return bit[:, slot.clamp(0, W - 1)].movedim(0, 1)

    def latch(carry, slot, f, a, b, is_open, upd):
        F, base, sums, delta, sf, sa, sb, so, ok, dirty = carry
        onehot = slot_ids[None, :] == slot[:, None]
        old_d = (delta.to(i64) * onehot).sum(1)
        new_d = model.mask_delta(f, a, b).to(i64)
        sums = torch.where(is_open[:, None],
                           wrap_i32(sums + cols(slot) * (new_d - old_d)
                                    [:, None]), sums)
        sf = torch.where(upd, f[:, None], sf)
        sa = torch.where(upd, a[:, None], sa)
        sb = torch.where(upd, b[:, None], sb)
        delta = torch.where(upd, wrap_i32(new_d)[:, None], delta)
        return (F, base, sums, delta, sf, sa, sb, so | upd, ok,
                dirty | is_open)

    def macro_latch(carry, pslot, pf, pa, pb, valid, n, eq, upd):
        F, base, sums, delta, sf, sa, sb, so, ok, dirty = carry
        sel = eq.to(i64)                                        # [B,W,P]
        old_d = (sel * delta.to(i64)[:, :, None]).sum(1)       # [B, P]
        new_d = model.mask_delta(pf, pa, pb).to(i64)           # [B, P]

        def put(old, new):  # the reference's macro_latch_i32
            return torch.where(upd, wrap_i32(
                (sel * new.to(i64)[:, None, :]).sum(2)), old)

        d = torch.where(valid, new_d - old_d, 0)
        sums = wrap_i32(sums + (cols(pslot) * d[:, None, :]).sum(2))
        return (F, base, sums, put(delta, new_d), put(sf, pf), put(sa, pa),
                put(sb, pb), so | upd, ok, dirty | (n > 0))

    def force_tail(carry, is_force, slot):
        F, base, sums, delta, sf, sa, sb, so, ok, dirty = carry
        B = int(F.shape[0])
        active = is_force & dirty
        if bool(active.any()):
            state = wrap_i32(base[:, None].to(i64) + sums)     # [B, M]
            legal = model.torch_step(state[:, None, :], sf[:, :, None],
                                     sa[:, :, None], sb[:, :, None])[1]
            legal = legal & so[:, :, None]                      # [B, W, M]
            F, sweeps = closure_fixpoint(W, mask_sweep_fn(legal), F, active)
            if acc is not None:
                live = ok.to(i64)
                closing = active.to(i64) * live
                n_open = so.sum(dim=1)
                # open slots whose op is not legal in every state, and the
                # masks and 32-mask ballot groups of the closed frontier
                # (the kernel's sweeps start from growing frontiers, and
                # its last one from the closed one: the groups it builds,
                # each once, are the closed frontier's)
                n_need = (so & ~model.always_legal(sf)).sum(dim=1)
                n_masks = F.view(B, M).sum(dim=1)
                n_groups = F.view(B, max(M >> 5, 1), -1).any(dim=2).sum(dim=1)
                acc["closures"] += closing.sum()
                acc["sweeps"] += (sweeps * live).sum()
                acc["slot_passes"] += (sweeps * live * n_open).sum()
                acc["legal_steps"] += (closing * n_open).sum() * M
                acc["legal_needed"] += (closing * n_need * n_masks).sum()
                acc["ballots_lazy"] += (closing * n_need * n_groups).sum()
        dirty = dirty & ~is_force
        if acc is not None:
            acc["force_rows"] += (is_force & ok).sum()
        F_forced, alive = force_arith(F, slot.clamp(0, W - 1))
        F = torch.where(is_force[:, None, None], F_forced, F)
        ok = ok & (~is_force | alive)
        # retire the forced op: its delta joins every survivor's base
        onehot = (slot_ids[None, :] == slot[:, None]) & is_force[:, None]
        old_d = (delta.to(i64) * onehot).sum(1)
        base = wrap_i32(base + old_d)
        sums = wrap_i32(sums - cols(slot) * old_d[:, None])
        delta = torch.where(onehot, 0, delta)
        return (F, base, sums, delta, sf, sa, sb, so & ~onehot, ok, dirty)

    return make_stream_step(W, latch, macro_latch, force_tail, macro_p)


def mask_scan_plain(events, n_slots: int, macro_p: Optional[int] = None,
                    n_events=None, *, model, stats: Optional[dict] = None):
    """The mask-mode scan in plain PyTorch: a Python loop over event
    rows, batched over B, following the reference's `mask_step_parts`
    step for step — `sums[2^W]` kept incrementally at latch and FORCE
    with the reference's clipped slot columns, legality hoisted to one
    [W, M] table per closing FORCE, the W + 1 sweep cap of
    `closure_fixpoint`, and `force_arith`.

    events [B, E, 5] int32 (legacy) or [B, E, 3 + 4·P] (macro_p=P);
    n_events [B] only bounds the loop; `model` has a mask-mode step (its
    `torch_step`, `mask_delta`, `always_legal` and initial state are
    used). Returns ok
    [B] bool on events' device. `stats`, when given, accumulates
    `MASK_STATS` over rows still alive: "force_rows", "closures"
    (closing FORCEs), "sweeps", "slot_passes" (sweeps × open slots),
    "legal_steps" (the reference's full legality tables: open slots ×
    2^W per closure), "legal_needed" (the table entries the closure can
    read: masks of the closed frontier × open slots whose op is not
    `always_legal`) and "ballots_lazy" (what the CUDA kernel builds:
    32-mask groups holding a closed-frontier mask × those slots). These
    only count; the result does not depend on them."""
    W = int(n_slots)
    B, E = int(events.shape[0]), int(events.shape[1])
    dev = events.device
    # the counters accumulate on the device and are read once at the end
    acc = ({k: torch.zeros((), dtype=torch.int64, device=dev)
            for k in MASK_STATS} if stats is not None else None)
    step = _mask_step(model, W, macro_p, dev, acc)
    state = _mask_fresh(B, W, model, dev)
    n_scan = E if n_events is None or B == 0 else \
        min(E, int(torch.as_tensor(n_events).max()))
    for e in range(n_scan):
        state = step(state, events[:, e])
    if stats is not None:
        for k, v in acc.items():
            stats[k] = stats.get(k, 0) + int(v)
    return state[8]


def _mask_fresh(B: int, W: int, model, dev):
    """The mask-mode scan's initial state: the empty mask, base = the
    model's initial state, no slot latched, ok, not dirty."""
    F = torch.zeros((B, 1 << W, 1), dtype=torch.bool, device=dev)
    F[:, 0, 0] = True
    zw = torch.zeros((B, W), dtype=torch.int32, device=dev)
    return (F, torch.full((B,), int(model.init_state()), dtype=torch.int32,
                          device=dev),
            torch.zeros((B, 1 << W), dtype=torch.int32, device=dev),
            zw, zw, zw, zw, torch.zeros((B, W), dtype=torch.bool, device=dev),
            torch.ones((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev))


def mask_sums(col) -> torch.Tensor:
    """sums [B, 2^W] int32 of the reference's mask carry from the column
    totals col [B, W]: sums[m] = Σ_{c in m} col[c] mod 2^32."""
    W = int(col.shape[1])
    bit = ((torch.arange(1 << W, device=col.device)[:, None]
            >> torch.arange(W, device=col.device)[None, :]) & 1)
    return wrap_i32((bit[None] * col.to(torch.int64)[:, None, :]).sum(2))


def _mask_unpack(carry, lay: CarryLayout, W: int):
    B = int(carry.shape[0])
    v = lay.view
    F = unpack_bits(v(carry, "F"), 1 << W).view(B, 1 << W, 1)
    return (F, v(carry, "base")[:, 0].clone(), mask_sums(v(carry, "col")),
            v(carry, "delta").clone(), v(carry, "f").clone(),
            v(carry, "a").clone(), v(carry, "b").clone(),
            v(carry, "open") != 0, v(carry, "ok")[:, 0] != 0,
            v(carry, "dirty")[:, 0] != 0)


def _mask_pack(state, carry, lay: CarryLayout, W: int, left):
    F, base, sums, delta, sf, sa, sb, so, ok, dirty = state
    B = int(carry.shape[0])
    out = carry.clone()
    v = lay.view
    v(out, "F")[:] = pack_bits(F.view(B, -1))
    v(out, "base")[:, 0] = base
    v(out, "col")[:] = sums[:, [1 << c for c in range(W)]]
    for name, x in (("delta", delta), ("f", sf), ("a", sa), ("b", sb),
                    ("open", so)):
        v(out, name)[:] = x.to(torch.int32)
    v(out, "ok")[:, 0] = ok.to(torch.int32)
    v(out, "dirty")[:, 0] = dirty.to(torch.int32)
    v(out, "left")[:, 0] = left.to(torch.int32)
    return out


def mask_chunk_plain(carry, events, n_slots: int,
                     macro_p: Optional[int] = None, *, model,
                     width: Optional[int] = None,
                     stats: Optional[dict] = None):
    """One chunk of the mask-mode scan in plain PyTorch: the body of
    `mask_scan_plain` from the carry [B, L] of `mask_carry_layout` (sums
    rebuilt from "col", and "col" read back from sums[1 << c]). Returns
    (carry', decided, exhausted, ok, overflow) as `dense_chunk_plain`;
    `stats` as `mask_scan_plain`'s."""
    W = int(n_slots)
    lay = mask_carry_layout(W)
    acc = ({k: torch.zeros((), dtype=torch.int64, device=carry.device)
            for k in MASK_STATS} if stats is not None else None)
    step = _mask_step(model, W, macro_p, carry.device, acc)
    state, left = chunk_scan(step, _mask_unpack(carry, lay, W), events,
                             lay.view(carry, "left")[:, 0], width)
    out = _mask_pack(state, carry, lay, W, left)
    if stats is not None:
        for k, v in acc.items():
            stats[k] = stats.get(k, 0) + int(v)
    return (out,) + chunk_flags(out, lay)


# ------------------------------------------------------------ the kernel

#: Launch counts of the port's kernels, one plain integer per wrapper:
#: a wrapper adds one where it launches its kernel and nowhere else, so
#: a run can show that its main path went through the card's kernels.
LAUNCHES = {"dense_scan": 0, "mask_scan": 0}
#: The same for the chunk entry points of the two kernels.
CHUNK_LAUNCHES = {"dense_scan_chunk": 0, "mask_scan_chunk": 0}
#: The same for the one-shot entries' counting instances (``counts=True``,
#: B10's counts in the epilogue), counted apart from LAUNCHES so that a
#: run shows which instance it launched.
COUNT_LAUNCHES = {"dense_scan_count": 0, "mask_scan_count": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CHUNK_LAUNCHES, COUNT_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def chunk_launch_counts() -> dict:
    return dict(CHUNK_LAUNCHES)


def count_launch_counts() -> dict:
    return dict(COUNT_LAUNCHES)


@dataclass(frozen=True)
class DenseLayout:
    """Where the CUDA kernel (one warp per history) keeps frontier bit
    (m, s) of F[2^W, S] in its registers.

    S is padded to a field of 2^field_log2 bits, so bit b = m·2^LF + s
    spans 2^(W+LF) ≤ 8192 bits: b[0..4] is the bit in a 32-bit word,
    b[5..9] the lane, b[10..12] the word in the lane's register array.
    Mask bit w sits at b[LF + w], which makes a closure pass or FORCE
    over slot w one of three kinds (`slot_pass`). The wrapper launches
    the kernel instantiated for (n_slots, field_log2)."""

    n_slots: int
    field_log2: int

    @property
    def bits_log2(self) -> int:
        return self.n_slots + self.field_log2

    @property
    def words(self) -> int:
        """32-bit frontier words per lane."""
        return 1 << max(self.bits_log2 - 10, 0)

    @property
    def lanes(self) -> int:
        """Lanes that hold frontier bits; the others hold zero words."""
        return 1 << min(max(self.bits_log2 - 5, 0), 5)

    def locate(self, m: int, s: int = 0):
        """(lane, word, bit) of frontier bit (m, s)."""
        b = (m << self.field_log2) | s
        return (b >> 5) & 31, b >> 10, b & 31

    def slot_pass(self, w: int):
        """How mask bit w is reached: ("field", d) — a shift by d bits
        inside each word; ("lane", x) — `__shfl_xor_sync` with lane mask
        x; ("word", x) — a move between register words j and j ^ x."""
        p = self.field_log2 + w
        if p < 5:
            return "field", 1 << p
        if p < 10:
            return "lane", 1 << (p - 5)
        return "word", 1 << (p - 10)


def dense_layout(n_slots: int, n_states: int) -> DenseLayout:
    """The kernel's frontier layout for window W and domain table size S
    (the field is S rounded up to a power of two)."""
    W, S = int(n_slots), int(n_states)
    if not (1 <= W and 1 <= S and _fits(W, S)):
        raise ValueError(f"dense_scan: (W={W}, S={S}) beyond the dense "
                         f"caps")
    return DenseLayout(W, (S - 1).bit_length())


def mask_layout(n_slots: int) -> DenseLayout:
    """The mask kernel's frontier layout for window W: `DenseLayout` at
    field width 0 (bit b = mask m), for 1 ≤ W ≤ MASK_DENSE_MAX_SLOTS."""
    W = int(n_slots)
    if not 1 <= W <= MASK_DENSE_MAX_SLOTS:
        raise ValueError(f"mask_scan: W={W} beyond the mask caps "
                         f"(1..{MASK_DENSE_MAX_SLOTS})")
    return DenseLayout(W, 0)


def _check_int32(name, t, dims, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != dims:
        raise ValueError(f"{name} must have {dims} dims, got {t.dim()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dense_scan(events, val_of, n_slots: int,
               macro_p: Optional[int] = None, n_events=None, model=None, *,
               counts: bool = False, real=None):
    """The dense-domain scan over a window group: ok [B] bool, and with
    `counts` (ok, counts): int64 [2] (n_valid = Σ ok & real, n_unknown =
    0), B10's counts in dense mode, `real` [B] bool (default: every row)
    masking padding rows out.

    events [B, E, 5] int32 (legacy rows) or [B, E, 3 + 4·P] int32 (macro
    rows, macro_p=P); val_of [B, S] int32; n_events [B] int32 real row
    counts (default: all E rows). A CPU tensor takes `dense_scan_plain`
    (and `verdict_counts_plain` of its flags); a CUDA tensor launches the
    hand-written kernel (ops/csrc/dense_scan.cu, one warp per history,
    instantiated for `dense_layout(W, S)`; with `counts`, the instance
    that counts in its epilogue) on the current stream without
    synchronising, or raises."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
    if events.device.type == "cpu":
        ok = dense_scan_plain(events, val_of, n_slots, macro_p, n_events,
                              model)
        return (ok, scan_counts_plain(ok, None, real, "dense")) if counts \
            else ok
    ready = dense_scan_launcher(events, val_of, n_slots, macro_p, n_events,
                                model, counts=counts, real=real)
    ready[-1](torch.cuda.current_stream(events.device))
    return ready[:-1] if counts else ready[0]


def _card_rows(name: str, events, macro_p, n_events):
    """Check a group's CUDA event rows for a launcher: (device, B, E, R,
    P, n_events), with n_events [B] int32 made (all E rows) when None."""
    if events.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {events.device}")
    dev = events.device
    _check_int32("events", events, 3, dev)
    B, E, R = (int(x) for x in events.shape)
    P = int(macro_p or 0)
    if R != (5 if not P else macro_row_ints(P)):
        raise ValueError(f"{name}: row width {R} does not match "
                         f"macro_p={macro_p}")
    if n_events is None:
        n_events = torch.full((B,), E, dtype=torch.int32, device=dev)
    _check_int32("n_events", n_events, 1, dev)
    if n_events.shape[0] != B:
        raise ValueError(f"{name}: n_events must be [B]")
    return dev, B, E, R, P, n_events


def _call_launch(name: str, lib, tensors, sizes, stream) -> None:
    """Call library `name`'s C launch entry point on the tensors'
    addresses (None: a null pointer), the sizes and the stream; raise on
    a refused or failed launch."""
    rc = getattr(lib, f"{name}_launch")(
        *(ctypes.c_void_p(None if t is None else t.data_ptr())
          for t in tensors), *sizes, ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{_build.error_string(name, rc)}")


def _chunk_rows(name: str, carry, events, macro_p, lay: CarryLayout,
                width: Optional[int]):
    """Check a chunk launch's CUDA carry and event slice: (device, B, w,
    R, P, width, row stride in ints). `events` [B, w, R] may be a column
    slice of a longer batch (each row's R ints contiguous, rows `row
    stride` ints apart); `width` ≥ w is the slice's length in the
    schedule."""
    if events.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {events.device}")
    dev = events.device
    if events.dtype != torch.int32 or events.dim() != 3:
        raise TypeError(f"{name}: events must be [B, w, R] int32")
    B, w, R = (int(x) for x in events.shape)
    if events.stride(2) != 1 or (w > 1 and events.stride(1) != R):
        raise ValueError(f"{name}: each row's event rows must be "
                         f"contiguous")
    P = int(macro_p or 0)
    if R != (5 if not P else macro_row_ints(P)):
        raise ValueError(f"{name}: row width {R} does not match "
                         f"macro_p={macro_p}")
    _check_int32("carry", carry, 2, dev)
    if tuple(carry.shape) != (B, lay.length):
        raise ValueError(f"{name}: carry must be [{B}, {lay.length}], got "
                         f"{tuple(carry.shape)}")
    width = w if width is None else int(width)
    if width < w:
        raise ValueError(f"{name}: width {width} < the slice's {w} rows")
    return dev, B, w, R, P, width, int(events.stride(0)) if B else 0


def _chunk_out(carry, B: int, dev):
    """The chunk launch's outputs: carry' like carry, flags [4, B] bool
    (decided, exhausted, ok, overflow)."""
    return (torch.empty_like(carry),
            torch.empty((4, B), dtype=torch.bool, device=dev))


def _flags(out, flags):
    return (out, flags[0], flags[1], flags[2], flags[3])


def _launch_fn(name: str, lib, tensors, sizes, B: int, counts=None,
               key: Optional[str] = None):
    """launch(stream): launch library `name`'s kernel (`_call_launch`) and
    count it in `counts` (default: this module's LAUNCHES) under `key`
    (default: `name`). The closure holds the tensors, not only their
    addresses, so a default n_events made by the launcher outlives the
    launch."""
    counts = LAUNCHES if counts is None else counts
    key = name if key is None else key

    def launch(stream) -> None:
        if B == 0:
            return
        _call_launch(name, lib, tensors, sizes, stream)
        counts[key] += 1

    return launch


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def dense_scan_launcher(events, val_of, n_slots: int,
                        macro_p: Optional[int] = None, n_events=None,
                        model=None, *, counts: bool = False, real=None):
    """Everything `dense_scan` does on the card before the launch: check
    the CUDA tensors, allocate ok [B] bool (and with `counts` the int64
    [2] counts), build or load the kernel. Returns (ok, launch), or with
    `counts` (ok, counts, launch); launch(stream) launches the kernel on
    that `torch.cuda.Stream` without synchronising and counts it, or
    raises. Splitting the two lets `run_dense_groups` launch several
    window groups back to back."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
    dev, B, E, R, P, n_events = _card_rows("dense_scan", events, macro_p,
                                           n_events)
    _check_int32("val_of", val_of, 2, dev)
    W, S = int(n_slots), int(val_of.shape[1])
    if val_of.shape[0] != B:
        raise ValueError("dense_scan: val_of rows differ from events rows")
    layout = dense_layout(W, S)
    code = getattr(model, "KERNEL_MODEL", None)
    if code is None:
        raise ValueError(f"dense_scan: model {type(model).__name__} has no "
                         f"device step in the CUDA kernel")
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    check_real(real, B, dev)
    tally = counts_out(B, dev) if counts else None
    lib = _build.load("dense_scan_count" if counts else "dense_scan")
    launch = _launch_fn(
        "dense_scan", lib, (events, val_of, n_events, ok, real, tally),
        (B, E, R, P, W, S, layout.field_log2, int(code), _device_index(dev)),
        B, *((COUNT_LAUNCHES, "dense_scan_count") if counts else ()))
    return (ok, tally, launch) if counts else (ok, launch)


def mask_scan(events, n_slots: int, macro_p: Optional[int] = None,
              n_events=None, *, model, counts: bool = False, real=None):
    """The mask-mode scan over a window group: ok [B] bool, and with
    `counts` (ok, counts) as `dense_scan`'s (dense mode).

    events [B, E, 5] int32 (legacy rows) or [B, E, 3 + 4·P] int32 (macro
    rows, macro_p=P); n_events [B] int32 real row counts (default: all E
    rows); `model` a model with a mask-mode step (the counter, the
    queue, the set on histories `GSet.mask_eligible` accepts). A
    CPU tensor takes `mask_scan_plain`; a CUDA tensor launches the
    hand-written kernel (ops/csrc/mask_scan.cu, one warp per history,
    instantiated for (W, model), and counting in its epilogue with
    `counts`) on the current stream without synchronising, or raises."""
    if events.device.type == "cpu":
        ok = mask_scan_plain(events, n_slots, macro_p, n_events, model=model)
        return (ok, scan_counts_plain(ok, None, real, "dense")) if counts \
            else ok
    ready = mask_scan_launcher(events, n_slots, macro_p, n_events,
                               model=model, counts=counts, real=real)
    ready[-1](torch.cuda.current_stream(events.device))
    return ready[:-1] if counts else ready[0]


def mask_scan_launcher(events, n_slots: int, macro_p: Optional[int] = None,
                       n_events=None, *, model, counts: bool = False,
                       real=None):
    """`dense_scan_launcher`'s counterpart for the mask kernel: check the
    CUDA tensors, allocate ok [B] bool (and the counts), build or load
    the kernel; returns (ok, launch), or (ok, counts, launch)."""
    dev, B, n_events, sizes = _mask_args(events, n_slots, macro_p, n_events,
                                         model)
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    check_real(real, B, dev)
    tally = counts_out(B, dev) if counts else None
    lib = _build.load("mask_scan_count" if counts else "mask_scan")
    launch = _launch_fn("mask_scan", lib,
                        (events, n_events, ok, real, tally), sizes, B,
                        *((COUNT_LAUNCHES, "mask_scan_count") if counts
                          else ()))
    return (ok, tally, launch) if counts else (ok, launch)


def _mask_args(events, n_slots, macro_p, n_events, model):
    """Check a mask group's CUDA tensors and model: (device, B, n_events,
    the launch's integer arguments)."""
    dev, B, E, R, P, n_events = _card_rows("mask_scan", events, macro_p,
                                           n_events)
    W = mask_layout(n_slots).n_slots
    code = getattr(model, "KERNEL_MODEL", None)
    if code is None or type(model).mask_delta is Model.mask_delta:
        raise ValueError(f"mask_scan: model {type(model).__name__} has no "
                         f"mask-mode step in the CUDA kernel")
    return dev, B, n_events, (B, E, R, P, W, int(code),
                              int(model.init_state()), _device_index(dev))


#: Columns of `mask_scan_profile`'s per-history counters: SM clock
#: cycles spent waiting for the row, latching, building legality, in
#: closure sweeps and in the FORCE; then event rows scanned, closing
#: FORCEs, closure sweeps, 32-mask legality groups built, ballots (one
#: per group and slot evaluated) and model steps (ballots × the lanes
#: holding a real mask).
MASK_PROFILE_FIELDS = ("ring_cycles", "latch_cycles", "legality_cycles",
                       "sweep_cycles", "force_cycles", "rows", "closures",
                       "sweeps", "groups_built", "ballots", "model_steps")


def mask_scan_profile(events, n_slots: int, macro_p: Optional[int] = None,
                      n_events=None, *, model):
    """The mask kernel's instrumented build (ops/csrc/mask_scan.cu
    compiled with -DMASK_SCAN_PROFILE into a library of its own) on the
    current stream: (ok [B] bool, prof [B, len(MASK_PROFILE_FIELDS)]
    int64). Card only; for measurement, never on a main path, so it is
    not counted in LAUNCHES. Raises if the library's counters per history
    are not MASK_PROFILE_FIELDS' columns."""
    dev, B, n_events, sizes = _mask_args(events, n_slots, macro_p, n_events,
                                         model)
    lib = _build.load("mask_scan_profile")
    n_fields = lib.mask_scan_profile_fields()
    if n_fields != len(MASK_PROFILE_FIELDS):
        raise RuntimeError(f"mask_scan_profile writes {n_fields} counters "
                           f"per history, MASK_PROFILE_FIELDS names "
                           f"{len(MASK_PROFILE_FIELDS)}")
    ok = torch.empty((B,), dtype=torch.bool, device=dev)
    prof = torch.zeros((B, n_fields), dtype=torch.int64, device=dev)
    if B:
        _call_launch("mask_scan_profile", lib, (events, n_events, ok, prof),
                     sizes, torch.cuda.current_stream(dev))
    return ok, prof


# ------------------------------------------------- the chunk kernels


def dense_chunk(carry, events, n_slots: int, n_states: int,
                macro_p: Optional[int] = None, model=None,
                width: Optional[int] = None):
    """One chunk of the dense-domain scan: (carry', decided, exhausted,
    ok, overflow), the contract of `dense_chunk_plain`. A CPU tensor
    takes the plain version; a CUDA tensor launches the chunk entry point of
    the dense kernel (ops/csrc/dense_scan.cu: the one-shot kernel's body,
    reading the carry at the start and writing it and the four flags at
    the end) on the current stream without synchronising, or raises."""
    if events.device.type == "cpu":
        return dense_chunk_plain(carry, events, n_slots, n_states, macro_p,
                                 model, width)
    out, flags, launch = dense_chunk_launcher(carry, events, n_slots,
                                              n_states, macro_p, model,
                                              width)
    launch(torch.cuda.current_stream(events.device))
    return _flags(out, flags)


def dense_chunk_launcher(carry, events, n_slots: int, n_states: int,
                         macro_p: Optional[int] = None, model=None,
                         width: Optional[int] = None):
    """Check the CUDA tensors, allocate carry' and flags [4, B] bool,
    build or load the kernel: (carry', flags, launch)."""
    if model is None:
        from ..models.register import CasRegister
        model = CasRegister()
    W, S = int(n_slots), int(n_states)
    lay = dense_carry_layout(W, S)
    dev, B, w, R, P, width, stride = _chunk_rows(
        "dense_scan_chunk", carry, events, macro_p, lay, width)
    code = getattr(model, "KERNEL_MODEL", None)
    if code is None:
        raise ValueError(f"dense_scan: model {type(model).__name__} has no "
                         f"device step in the CUDA kernel")
    out, flags = _chunk_out(carry, B, dev)
    lib = _build.load("dense_scan")
    return out, flags, _launch_fn(
        "dense_scan_chunk", lib, (events, carry, out, flags),
        (stride, B, width, R, P, W, S, dense_layout(W, S).field_log2,
         int(code), lay.length, _device_index(dev)), B, CHUNK_LAUNCHES)


def mask_chunk(carry, events, n_slots: int, macro_p: Optional[int] = None,
               *, model, width: Optional[int] = None):
    """One chunk of the mask-mode scan: the contract of
    `mask_chunk_plain`; a CUDA tensor launches the chunk entry point of
    ops/csrc/mask_scan.cu on the current stream, or raises."""
    if events.device.type == "cpu":
        return mask_chunk_plain(carry, events, n_slots, macro_p, model=model,
                                width=width)
    out, flags, launch = mask_chunk_launcher(carry, events, n_slots,
                                             macro_p, model=model,
                                             width=width)
    launch(torch.cuda.current_stream(events.device))
    return _flags(out, flags)


def mask_chunk_launcher(carry, events, n_slots: int,
                        macro_p: Optional[int] = None, *, model,
                        width: Optional[int] = None):
    """`dense_chunk_launcher`'s counterpart for the mask kernel."""
    W = mask_layout(n_slots).n_slots
    lay = mask_carry_layout(W)
    dev, B, w, R, P, width, stride = _chunk_rows(
        "mask_scan_chunk", carry, events, macro_p, lay, width)
    code = getattr(model, "KERNEL_MODEL", None)
    if code is None or type(model).mask_delta is Model.mask_delta:
        raise ValueError(f"mask_scan: model {type(model).__name__} has no "
                         f"mask-mode step in the CUDA kernel")
    out, flags = _chunk_out(carry, B, dev)
    lib = _build.load("mask_scan")
    return out, flags, _launch_fn(
        "mask_scan_chunk", lib, (events, carry, out, flags),
        (stride, B, width, R, P, W, int(code), lay.length,
         _device_index(dev)), B, CHUNK_LAUNCHES)


def make_dense_chunk_checker(model, kind: str, n_slots: int, n_states: int,
                             macro_p: Optional[int] = None):
    """The chunk pair of a dense window group, as the reference's
    `make_dense_chunk_checker` (ops/dense_scan.py:755): (init_fn,
    step_fn) with

      init_fn(val_of [B, S], n_events [B] int32) -> carry [B, L] int32
          (a mask group ignores val_of);
      step_fn(carry, events [B, w, R], width=None) -> (carry', decided
          [B], exhausted [B], ok [B], overflow [B])

    on the tensors' device: the plain versions on the CPU, the chunk
    kernels (`dense_chunk`, `mask_chunk`) on a card. `macro_p` selects
    macro rows; `n_events` and `left` then count macro rows."""
    W = int(n_slots)
    if kind == "mask":
        def init_fn(val_of, n_events):
            return mask_chunk_init(n_events, W, model)

        def step_fn(carry, events, width=None):
            return mask_chunk(carry, events, W, macro_p, model=model,
                              width=width)
    else:
        def init_fn(val_of, n_events):
            return dense_chunk_init(val_of, n_events, W)

        def step_fn(carry, events, width=None):
            return dense_chunk(carry, events, W, n_states, macro_p, model,
                               width)
    return init_fn, step_fn
