"""Linearizability checker of the port: the north-star check on the card.

Equivalent of the reference's checker/linearizable.py at its
linearizable rung with the lin fast path off (``JGRAFT_LIN_FASTPATH=0``,
which the reference's test suite pins): histories are encoded and
macro-packed on the host, grouped by kernel kind and concurrency window
(`ops.dense_scan.dense_plans_grouped`), and every window group runs a
hand-written CUDA kernel: the dense-domain scan
(`ops.dense_scan.dense_scan`) for enumerable domains (the register, a
set with few distinct adds), the mask-mode scan (`ops.dense_scan.
mask_scan`) for order-independent models (the counter, the queue, a set
whose adds hit distinct fresh bits), whose rows report ``"kernel":
"dense-mask"`` and ``"decided-tier": "mask"``. The rows beyond the dense
plans take the sort-frontier ladder, as the reference's `_jax_pass` runs
it: one batch at `bucket_slots` of its widest window through the sort
kernel (`ops.linear_scan.sort_scan`) at C = 64, the rows that overflow
again at C = 256; ``ok`` is VALID at any rung, ``~ok & ~overflow``
INVALID, and a row that overflows at the top rung is undecided. Ladder
rows report ``"kernel": "sort"``, ``"decided-tier": "sort"``.

Algorithms:
  * ``"auto"``  — dense kernels for the rows inside the dense caps; the
                  ladder for the other rows with a window ≤
                  MASK_DENSE_MAX_SLOTS (12), as the reference sends
                  exactly those there; the rest, and the rows undecided
                  at the top rung, take the host frontier oracle
                  (`wgl_cpu.check_encoded_cpu`), stamped ``"algorithm":
                  "cpu"``, ``"decided-tier": "host"``. (The reference
                  tries a budgeted DFS on windows above 12 first, then
                  the ladder; the port has no DFS tier yet: the same
                  verdict, another tier.)
  * ``"dense"`` — the device only (the reference's ``"jax"``): dense
                  kernels, then the ladder for every other row with a
                  window ≤ SORT_MAX_SLOTS (127); a row beyond it, or
                  undecided at the top rung, reports UNKNOWN with an
                  error.
  * ``"cpu"``   — the host oracle for every history.

``n_configs`` / ``n_slots`` pin the sort kernel's shape, as in the
reference: a pin skips the dense plans and runs every row through the
ladder at that shape (``n_configs``: one rung of that capacity;
``n_slots``: that kernel window, and rows wider than it are beyond the
ladder).

Device: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions on the
host. With no CUDA device and no explicit CPU request they raise.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from ..history.ops import History
from ..history.packing import (EncodedHistory, encode_history,
                               macro_events_on, pack_batch, pack_macro_batch)
from ..ops.dense_scan import dense_plans_grouped
from ..ops.kernel_ir import MASK_DENSE_MAX_SLOTS
from ..ops.linear_scan import DEFAULT_N_CONFIGS, MAX_SLOTS, bucket_slots
from ..platform import resolve_device
from .base import Checker, INVALID, UNKNOWN, VALID
from .schedule import DenseLaunch, note_tier, run_dense_groups, run_sort_rung
from .wgl_cpu import FrontierOverflow, check_encoded_cpu

#: Default host-oracle frontier cap: the search is worst-case
#: exponential in the window, so beyond this it reports UNKNOWN.
DEFAULT_MAX_CPU_CONFIGS = 1 << 18

ALGORITHMS = ("auto", "dense", "cpu")

#: Capacities of the sort ladder's rungs, smallest first.
SORT_LADDER = (64, DEFAULT_N_CONFIGS)


def check_histories(
    histories: Sequence[History],
    model,
    algorithm: str = "auto",
    device=None,
    witness: bool = False,
    max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
    n_configs: Optional[int] = None,
    n_slots: Optional[int] = None,
) -> list[dict]:
    """Check a batch of histories; one result dict per history. The
    batch is the unit of device work: histories are encoded, grouped
    by window, and each group is one kernel launch."""
    dev = resolve_device(device)
    encs = [encode_history(h, model) for h in histories]
    return check_encoded(encs, model, algorithm, dev, witness,
                         max_cpu_configs, n_configs, n_slots)


def check_encoded(
    encs: Sequence[EncodedHistory],
    model,
    algorithm: str = "auto",
    device=None,
    witness: bool = False,
    max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
    n_configs: Optional[int] = None,
    n_slots: Optional[int] = None,
) -> list[dict]:
    """Check already-encoded histories (`history.packing.encode_history`),
    one result dict each."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"expected one of {ALGORITHMS}")
    dev = resolve_device(device)
    if algorithm == "cpu":
        return [_check_cpu(e, model, witness, max_cpu_configs)
                for e in encs]
    pinned = n_configs is not None or n_slots is not None
    results, rest = (_dense_pass(encs, model, dev) if not pinned
                     else _trivial_pass(encs))
    # the ladder's window cap: the sort kernel's, or under auto the
    # rows the reference sends to the ladder without its DFS tier first
    cap = n_slots or MAX_SLOTS
    if algorithm == "auto":
        cap = min(cap, MASK_DENSE_MAX_SLOTS)
    _sort_pass(encs, model, dev, [i for i in rest if encs[i].n_slots <= cap],
               results, n_configs, n_slots)
    for i, r in enumerate(results):
        if r is not None:
            continue
        if algorithm == "dense":
            results[i] = {
                "valid?": UNKNOWN,
                "algorithm": "torch",
                "error": "beyond the kernels' caps (window "
                         f"{encs[i].n_slots} slots, or a frontier overflow "
                         "at the top rung); use algorithm='auto' or 'cpu'",
            }
        else:
            results[i] = _check_cpu(encs[i], model, witness,
                                    max_cpu_configs)
    return results


def _trivial_pass(encs):
    """(results, rest): VALID for the empty histories, None and an entry
    in `rest` for every other."""
    results: list = [None] * len(encs)
    rest = []
    for i, e in enumerate(encs):
        if e.n_events == 0:
            note_tier("trivial")
            results[i] = {"valid?": VALID, "algorithm": "trivial",
                          "op-count": 0, "decided-tier": "trivial"}
        else:
            rest.append(i)
    return results, rest


def _dense_pass(encs, model, dev):
    """Run every dense-eligible history through its group's CUDA kernel,
    domain or mask (or the kernel's plain version on a CPU device).
    Returns (results, rest): None in results and an index in `rest` for
    the histories beyond both kinds' caps."""
    results, fits = _trivial_pass(encs)
    if not fits:
        return results, []
    grouped, rest = dense_plans_grouped(model, [encs[i] for i in fits])
    pack = pack_macro_batch if macro_events_on() else pack_batch
    subs, launches = [], []
    for idxs, plan in grouped:
        sub = [fits[j] for j in idxs]
        batch = pack([encs[i] for i in sub])
        launches.append(DenseLaunch(
            events=torch.from_numpy(batch["events"]).to(dev),
            val_of=torch.from_numpy(plan.val_of).to(dev),
            n_events=torch.from_numpy(batch["n_events"]).to(dev),
            n_slots=plan.n_slots, macro_p=batch.get("macro_p"),
            tag=plan.kernel_tag, kind=plan.kind))
        subs.append(sub)
    rest = [fits[j] for j in rest]
    if not launches:
        return results, rest
    run = run_dense_groups(launches, model)
    dt = run.wall_s / max(sum(len(s) for s in subs), 1)
    for sub, ok, ln in zip(subs, run.ok, launches):
        for j, i in enumerate(sub):
            results[i] = _jx(VALID if ok[j] else INVALID, encs[i], dt,
                             kernel=ln.tag)
    return results, rest


def _sort_pass(encs, model, dev, rows, results, n_configs=None,
               n_slots=None) -> None:
    """The sort-frontier ladder over `rows` (indices into encs), as the
    reference's `_jax_pass` runs it: one batch at the widest window's
    bucket (or the pinned `n_slots`), rungs SORT_LADDER (or the pinned
    `n_configs` alone); the rows that overflow go up a rung. Fills
    `results` for the rows it decides."""
    if not rows:
        return
    W = n_slots or bucket_slots(max(encs[i].n_slots for i in rows))
    ladder = [n_configs] if n_configs else list(SORT_LADDER)
    pack = pack_macro_batch if macro_events_on() else pack_batch
    remaining = rows
    for rung, C in enumerate(ladder):
        batch = pack([encs[i] for i in remaining])
        run = run_sort_rung(torch.from_numpy(batch["events"]).to(dev),
                            torch.from_numpy(batch["n_events"]).to(dev),
                            W, C, batch.get("macro_p"), model)
        dt = run.wall_s / len(remaining)
        escalate = []
        for j, i in enumerate(remaining):
            if run.ok[j]:
                results[i] = _jx(VALID, encs[i], dt, kernel="sort")
            elif not run.overflow[j]:
                results[i] = _jx(INVALID, encs[i], dt, kernel="sort")
            elif rung + 1 < len(ladder):
                escalate.append(i)
            # else: overflowed at the top rung, undecided
        remaining = escalate
        if not remaining:
            break


def kernel_tier(tag: str) -> str:
    """Decided-tier name of a kernel tag (the reference's attribution):
    the mask kernel is its own tier, the sort ladder "sort", every other
    dense-family kernel "dense"."""
    if "mask" in tag:
        return "mask"
    if "sort" in tag:
        return "sort"
    return "dense"


def _jx(valid, enc: EncodedHistory, secs: float,
        kernel: str = "dense", note: bool = True) -> dict:
    tier = kernel_tier(kernel)
    if note:
        note_tier(tier, wall_s=secs)
    return {
        "valid?": valid,
        "algorithm": "torch",
        "kernel": kernel,
        "op-count": enc.n_ops,
        "concurrency-window": enc.n_slots,
        "time-s": secs,
        "decided-tier": tier,
    }


def _check_cpu(enc: EncodedHistory, model, witness: bool,
               max_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
               note: bool = True) -> dict:
    t0 = time.perf_counter()
    try:
        r = check_encoded_cpu(enc, model, max_configs=max_configs,
                              witness=witness)
    except FrontierOverflow as e:
        return {"valid?": UNKNOWN, "algorithm": "cpu", "error": str(e)}
    if note:
        note_tier("host", wall_s=time.perf_counter() - t0)
    out = {
        "valid?": VALID if r.valid else INVALID,
        "algorithm": "cpu",
        "op-count": enc.n_ops,
        "concurrency-window": enc.n_slots,
        "configs-explored": r.configs_explored,
        "max-frontier": r.max_frontier,
        "decided-tier": "host",
    }
    if not r.valid:
        out["failing-op-index"] = r.failing_op_index
    if r.witness is not None:
        out["witness"] = r.witness
    return out


class LinearizableChecker(Checker):
    """Checker-protocol wrapper around `check_histories` for one
    history (client ops only)."""

    def __init__(self, model, algorithm: str = "auto", device=None,
                 max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS):
        self.model = model
        self.algorithm = algorithm
        self.device = resolve_device(device)
        self.max_cpu_configs = max_cpu_configs

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        [result] = check_histories(
            [history.client_ops()], self.model, self.algorithm,
            self.device, witness=True,
            max_cpu_configs=self.max_cpu_configs)
        return result
