"""Batch checks on this process's device: the port of the reference's
`jepsen_jgroups_raft_tpu/parallel/mesh.py` (B10).

The reference shards a batch over a 1-D `jax.sharding.Mesh` with
`shard_map`: every device scans its row shard with the vmapped scan
kernel, and a `psum` over the mesh axis sums the verdict counts. On the
H100 a process owns one card, so its shard is the whole batch it is
given: one launch of the ported scan kernel (B5 `sort_scan`, or B1
`dense_scan` / B4 `mask_scan`) over every row, whose epilogue also makes
B10's two counts (the kernels' counting option,
ops/csrc/verdict_counts.cuh). Across processes the counts are summed by
torch.distributed (`distributed.check_batch_global`), the verdicts
exchanged through the store (`distributed.run_sharded`).

  * `make_mesh` — a `Mesh` of this process's device (the rank's card,
    `distributed.rank_device`, or the CPU by name).
  * `sharded_batch_checker` / `sharded_dense_checker` — callables with the
    reference's call signatures returning (ok[B], overflow[B], n_valid,
    n_unknown) as tensors on the mesh's device.
  * `check_batch_sharded` — the reference's entry: the capacity ladder,
    `dense=` plans, `macro_p`, `defer=`. The first launch runs at the
    batch's own row count (the reference pads it to its compile-cache
    bucket; a hand kernel has no compile cache to hit).

Fan-out of one process's launches over several local GPUs is a later
item (ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..checker.schedule import DenseLaunch, launch_dense_groups, run_sort_rung
from ..ops.dense_scan import dense_scan, mask_scan
from ..ops.linear_scan import DEFAULT_N_CONFIGS, MAX_SLOTS, sort_scan
from ..platform import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This process's device: the one the checkers launch on."""

    device: torch.device


def make_mesh(device=None) -> Mesh:
    """The mesh of this process: `device` as `resolve_device` takes it
    (the CPU by name, ``"cpu"``), else this process's device
    (`distributed.rank_device`: the rank's card inside a cluster, the
    current card outside one). The reference's default spans every device
    of every process; in the port a process checks on its own device and
    the cross-process sums ride torch.distributed."""
    from .distributed import rank_device

    if device is None:
        return Mesh(rank_device())
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dev)


def _on_device(name: str, dev: torch.device, *tensors) -> None:
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name}: inputs must be tensors on the "
                             f"mesh's device {dev}")


def sharded_batch_checker(model, mesh: Mesh,
                          n_configs: int = DEFAULT_N_CONFIGS,
                          n_slots: int = MAX_SLOTS,
                          macro_p: Optional[int] = None):
    """fn(events [B, E, R] int32, real [B] bool) -> (ok [B], overflow [B],
    n_valid, n_unknown), all tensors on the mesh's device: one launch of
    B5 (`sort_scan` at capacity `n_configs`, window `n_slots`; macro rows
    with `macro_p`) over the batch, which counts B10's counts in sort
    mode in its epilogue (n_valid = Σ ok & ~overflow & real, n_unknown =
    Σ overflow & real). `real` masks padding rows out of the counts."""
    dev = mesh.device

    def fn(events, real):
        _on_device("sharded_batch_checker", dev, events, real)
        ok, overflow, counts = sort_scan(events, n_slots, n_configs, macro_p,
                                         model=model, counts=True, real=real)
        return ok, overflow, counts[0], counts[1]

    return fn


def sharded_dense_checker(model, mesh: Mesh, kind: str, n_slots: int,
                          n_states: int, macro_p: Optional[int] = None):
    """fn(events [B, E, R] int32, val_of [B, S] int32, real [B] bool) ->
    (ok [B], overflow [B], n_valid, n_unknown) on the mesh's device: one
    launch of B1 (`dense_scan`, kind "domain", S = `n_states`) or B4
    (`mask_scan`, kind "mask", val_of unread), which counts B10's counts
    in dense mode in its epilogue (n_valid = Σ ok & real, n_unknown = 0:
    the dense kernels never overflow; the zero overflow [B] is returned
    for the reference's signature)."""
    if kind not in ("domain", "mask"):
        raise ValueError(f"sharded_dense_checker: kind {kind!r} is not "
                         "'domain' or 'mask'")
    dev = mesh.device

    def fn(events, val_of, real):
        _on_device("sharded_dense_checker", dev, events, val_of, real)
        if kind == "mask":
            ok, counts = mask_scan(events, n_slots, macro_p, model=model,
                                   counts=True, real=real)
        else:
            if int(val_of.shape[-1]) != int(n_states):
                raise ValueError(f"sharded_dense_checker: val_of has "
                                 f"{val_of.shape[-1]} states, the plan "
                                 f"{n_states}")
            ok, counts = dense_scan(events, val_of, n_slots, macro_p, None,
                                    model, counts=True, real=real)
        return ok, torch.zeros_like(ok), counts[0], counts[1]

    return fn


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(x, dtype=dtype)


def check_batch_sharded(model, events, mesh: Optional[Mesh] = None,
                        n_configs: Optional[int] = None,
                        n_slots: int = MAX_SLOTS,
                        dense: Optional[object] = None,
                        defer: bool = False,
                        macro_p: Optional[int] = None,
                        device=None):
    """Check a packed event batch on this process's device.

    events: [B, E, 5] int32 (history/packing.py layout), or a macro batch
    [B, E_mac, 3+4·P] with `macro_p=P`, as numpy or a tensor. Returns
    (ok [B], overflow [B] numpy bool, n_valid, n_unknown ints). `mesh`
    defaults to `make_mesh(device)`: the card unless `device` names the
    CPU.

    `dense` — an `ops.dense_scan.DensePlan` — routes the batch to B1
    (domain) or B4 (mask), whose launch also counts B10's counts, as one
    group of `checker.schedule.launch_dense_groups`: exact, ladder-free;
    overflow is all False and n_unknown 0, as in the reference. Otherwise
    the capacity ladder of B5 (unless `n_configs` pins one rung), each rung
    one `checker.schedule.run_sort_rung`: the whole batch at C = 64, then
    only the rows that overflowed and are not ok at C =
    DEFAULT_N_CONFIGS ("valid" at a small capacity is final); the counts
    are taken on the host from the ladder's flags.

    `defer=True` returns a zero-argument finalizer instead: a dense check
    is left pending (`launch_dense_groups`' finalizer blocks on an event,
    never on the device), so callers launch every window group and block
    once; the ladder blocks per rung, so its finalizer is already
    resolved."""
    dev = (mesh or make_mesh(device)).device
    events = _host(events, np.int32)
    B = events.shape[0]
    if dense is not None:
        pending = launch_dense_groups([DenseLaunch(
            events=torch.from_numpy(events).to(dev),
            val_of=torch.from_numpy(_host(dense.val_of, np.int32)).to(dev),
            n_events=None, n_slots=dense.n_slots, macro_p=macro_p,
            tag=dense.kernel_tag, kind=dense.kind)], model, counts=True)

        def finalize():
            run = pending()
            n_valid, n_unknown = (int(c) for c in run.counts[0])
            return run.ok[0], np.zeros((B,), bool), n_valid, n_unknown

        return finalize if defer else finalize()
    ladder = ([n_configs] if n_configs else
              [64, DEFAULT_N_CONFIGS] if DEFAULT_N_CONFIGS > 64
              else [DEFAULT_N_CONFIGS])
    ok = np.zeros((B,), dtype=bool)
    overflow = np.zeros((B,), dtype=bool)
    remaining = np.arange(B)
    for rung, C in enumerate(ladder):
        run = run_sort_rung(torch.from_numpy(events[remaining]).to(dev),
                            None, n_slots, C, macro_p, model)
        ok[remaining] = run.ok
        overflow[remaining] = run.overflow
        # escalate only undecided rows: overflowed and not proven valid
        escalate = remaining[run.overflow & ~run.ok]
        if rung + 1 >= len(ladder) or escalate.size == 0:
            break
        remaining = escalate
    # ok counts as valid even when the frontier overflowed: the witnessed
    # linearization is real; only overflowed-and-not-ok is undecided
    out = (ok, overflow, int(np.sum(ok)), int(np.sum(overflow & ~ok)))
    return (lambda: out) if defer else out
