"""Linearizability checker of the port: the north-star check on the card.

Equivalent of the reference's checker/linearizable.py at its
linearizable rung with the lin fast path off (``JGRAFT_LIN_FASTPATH=0``,
which the reference's test suite pins): histories are encoded and
macro-packed on the host, grouped by kernel kind and concurrency window
(`ops.dense_scan.dense_plans_grouped`), and every window group runs a
hand-written CUDA kernel: the dense-domain scan
(`ops.dense_scan.dense_scan`) for models with an enumerable domain (the
register), the mask-mode scan (`ops.dense_scan.mask_scan`) for
order-independent models (the counter, the queue), whose rows report
``"kernel": "dense-mask"`` and ``"decided-tier": "mask"``.

Algorithms:
  * ``"auto"``  — dense kernel for every history inside the dense caps;
                  the rest take the host frontier oracle
                  (`wgl_cpu.check_encoded_cpu`), stamped
                  ``"algorithm": "cpu"``, ``"decided-tier": "host"``,
                  as the reference's `_check_cpu` stamps them. That is
                  the reference's own escalation tier, visible in every
                  result (where the reference first tries its sort
                  ladder, which is not ported yet).
  * ``"dense"`` — dense kernels only (domain and mask groups);
                  histories beyond the caps report UNKNOWN with an
                  error, like the reference's "jax".
  * ``"cpu"``   — the host oracle for every history.

Device: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, which runs the kernel's plain PyTorch version on the
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
from ..platform import resolve_device
from .base import Checker, INVALID, UNKNOWN, VALID
from .schedule import DenseLaunch, note_tier, run_dense_groups
from .wgl_cpu import FrontierOverflow, check_encoded_cpu

#: Default host-oracle frontier cap: the search is worst-case
#: exponential in the window, so beyond this it reports UNKNOWN.
DEFAULT_MAX_CPU_CONFIGS = 1 << 18

ALGORITHMS = ("auto", "dense", "cpu")


def check_histories(
    histories: Sequence[History],
    model,
    algorithm: str = "auto",
    device=None,
    witness: bool = False,
    max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
) -> list[dict]:
    """Check a batch of histories; one result dict per history. The
    batch is the unit of device work: histories are encoded, grouped
    by window, and each group is one kernel launch."""
    dev = resolve_device(device)
    encs = [encode_history(h, model) for h in histories]
    return check_encoded(encs, model, algorithm, dev, witness,
                         max_cpu_configs)


def check_encoded(
    encs: Sequence[EncodedHistory],
    model,
    algorithm: str = "auto",
    device=None,
    witness: bool = False,
    max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
) -> list[dict]:
    """Check already-encoded histories (`history.packing.encode_history`),
    one result dict each."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"expected one of {ALGORITHMS}")
    dev = resolve_device(device)
    if algorithm == "cpu":
        results = [_check_cpu(e, model, witness, max_cpu_configs)
                   for e in encs]
    else:
        results = _dense_pass(encs, model, dev)
        for i, r in enumerate(results):
            if r is not None:
                continue
            if algorithm == "dense":
                results[i] = {
                    "valid?": UNKNOWN,
                    "algorithm": "torch",
                    "error": "beyond the dense kernel's caps (window "
                             f"{encs[i].n_slots} slots); use "
                             "algorithm='auto' or 'cpu'",
                }
            else:
                results[i] = _check_cpu(encs[i], model, witness,
                                        max_cpu_configs)
    return results


def _dense_pass(encs, model, dev) -> list:
    """Run every dense-eligible history through its group's CUDA kernel,
    domain or mask (or the kernel's plain version on a CPU device); None
    where a history is beyond both kinds' caps."""
    results: list = [None] * len(encs)
    fits = []
    for i, e in enumerate(encs):
        if e.n_events == 0:
            note_tier("trivial")
            results[i] = {"valid?": VALID, "algorithm": "trivial",
                          "op-count": 0, "decided-tier": "trivial"}
        else:
            fits.append(i)
    if not fits:
        return results
    grouped, _rest = dense_plans_grouped(model, [encs[i] for i in fits])
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
    if not launches:
        return results
    run = run_dense_groups(launches, model)
    dt = run.wall_s / max(sum(len(s) for s in subs), 1)
    for sub, ok, ln in zip(subs, run.ok, launches):
        for j, i in enumerate(sub):
            results[i] = _jx(VALID if ok[j] else INVALID, encs[i], dt,
                             kernel=ln.tag)
    return results


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
