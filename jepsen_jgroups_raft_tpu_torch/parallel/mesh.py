"""Batch checks over a mesh of this process's devices: the port of the
reference's `jepsen_jgroups_raft_tpu/parallel/mesh.py` (B10) and of its
local fan-out.

The reference shards a batch over a 1-D `jax.sharding.Mesh` with
`shard_map`: every device scans its row shard with the vmapped scan
kernel, and a `psum` over the mesh axis sums the verdict counts. Here a
`Mesh` is an ordered tuple of placements (`torch.device`s). On each
placement its contiguous row shard is one launch of the ported scan
kernel (B5 `sort_scan`, or B1 `dense_scan` / B4 `mask_scan`), on a
stream of its own, whose epilogue also makes B10's two counts (the
kernels' counting option, ops/csrc/verdict_counts.cuh); the shards'
counts are summed on the host, the reference's `psum`. A one-device
mesh is one launch over every row. Across processes the counts are
summed by torch.distributed (`distributed.check_batch_global`), the
verdicts exchanged through the store (`distributed.run_sharded`).

  * `local_devices` / `local_mesh` — the placements this process owns:
    the host's cards outside a cluster (this process's card first), the
    cards of this rank inside one (`local_cards`), or the placements
    `platform.pin_placements` set (several of the CPU or of one card).
  * `launch_fan_out` / `chunk_sharding` — the reference's gate: whether,
    and over which mesh, a launch spreads its rows (the wavefront's
    groups, checker/schedule.py; the segment batch,
    ops/segment_scan.py; a tuned sort rung, checker/autotune.py).
  * `make_mesh` — with no argument the mesh of this process's device
    (`distributed.rank_device`), as before; `n_devices` / `devices`
    take placements as the reference's does.
  * `sharded_batch_checker` / `sharded_dense_checker` — callables with
    the reference's call signatures returning (ok[B], overflow[B],
    n_valid, n_unknown) as tensors on the mesh's first device.
  * `check_batch_sharded` — the reference's entry: the capacity ladder,
    `dense=` plans, `macro_p`, `defer=`. A launch runs at its shard's
    own row count (the reference pads the batch to a multiple of the
    mesh in its compile-cache bucket; a hand kernel has no compile
    cache to hit).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..checker.schedule import DenseLaunch, launch_dense_groups, run_sort_rung
from ..ops.dense_scan import dense_scan, mask_scan
from ..ops.kernel_ir import join_rows, over_shards
from ..ops.linear_scan import DEFAULT_N_CONFIGS, MAX_SLOTS, sort_scan
from ..platform import env_int, pinned_placements, resolve_device


def _indexed(dev) -> torch.device:
    """`dev` as a torch.device, a card with its index."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of placements (torch devices; a placement may
    repeat a device, each then launching on a stream of its own). A
    single device is the one-device mesh: the process's device that the
    checkers launch on."""

    devices: tuple

    def __post_init__(self):
        devs = self.devices
        if isinstance(devs, (str, torch.device)):
            devs = (devs,)
        devs = tuple(torch.device(d) for d in devs)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first placement: where results are joined."""
        return self.devices[0]


def local_cards(device_count: int, local_rank: Optional[int] = None,
                local_world_size: Optional[int] = None,
                current: int = 0) -> List[int]:
    """The card indices a process owns. Outside a cluster
    (`local_world_size` None) every card, `current` first. Inside one,
    when every rank of the host has a card of its own
    (``LOCAL_WORLD_SIZE ≤ device_count``, `distributed.choose_backend`'s
    nccl rule), the cards c with ``c % LOCAL_WORLD_SIZE == LOCAL_RANK``,
    the first ``device_count // LOCAL_WORLD_SIZE`` of them so that every
    rank fans out as wide (the rank's own card, ``cuda:LOCAL_RANK``,
    first); ranks that share cards (gloo) own card 0 alone, and never
    fan out."""
    n = int(device_count)
    if n <= 0:
        return []
    if local_world_size is None:
        return [current] + [c for c in range(n) if c != current]
    lws = int(local_world_size)
    if lws > n:
        return [0]
    return [c for c in range(n) if c % lws == int(local_rank)][:n // lws]


def local_devices() -> tuple:
    """This process's local placements: `platform.pin_placements`' when
    set, else its cards (`local_cards`: inside a torchrun cluster this
    rank's, never another rank's), else none (a host with no card)."""
    pinned = pinned_placements()
    if pinned is not None:
        return pinned
    if not torch.cuda.is_available():
        return ()
    from .distributed import local_rank_world

    where = local_rank_world()
    if where is None:
        cards = local_cards(torch.cuda.device_count(),
                            current=torch.cuda.current_device())
    else:
        cards = local_cards(torch.cuda.device_count(), *where)
    return tuple(torch.device("cuda", c) for c in cards)


def make_mesh(device=None, *, n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """With no argument, the mesh of this process's device
    (`distributed.rank_device`: the rank's card inside a cluster, the
    current card outside one); `device` as `resolve_device` takes it
    (the CPU by name, ``"cpu"``) for a one-device mesh of that device.
    With `devices` and / or `n_devices`, as the reference's: the first
    `n_devices` (default all) of `devices` (default this process's
    `local_devices`); asking for more than there are raises. The
    reference's default spans every process's devices; in the port the
    cross-process sums ride torch.distributed."""
    if devices is not None or n_devices is not None:
        devs = list(local_devices() if devices is None else devices)
        n = len(devs) if n_devices is None else int(n_devices)
        if n > len(devs) or n < 1:
            raise ValueError(f"requested {n} devices, have {len(devs)}")
        return Mesh(tuple(devs[:n]))
    if device is None:
        from .distributed import rank_device

        return Mesh(rank_device())
    return Mesh(_indexed(resolve_device(device)))


def local_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of this process's `local_devices` (the first
    `n_devices`); this process's device alone when it has none listed
    (which raises without a card)."""
    devs = local_devices()
    if not devs:
        return make_mesh()
    return make_mesh(n_devices=n_devices, devices=devs)


def launch_fan_out() -> bool:
    """Whether a launch may spread its rows over the local mesh
    (`chunk_sharding`): the default. ``JGRAFT_GROUP_DEVICES=0`` forbids
    fan-out (whole-group, one-device launches); ``=N`` caps the mesh at
    N placements."""
    return os.environ.get("JGRAFT_GROUP_DEVICES") != "0"


def chunk_sharding(n_devices: Optional[int] = None,
                   device=None) -> Optional[Mesh]:
    """The mesh a launch spreads its rows over, as the reference's: the
    local placements (`local_devices`), capped at
    ``JGRAFT_GROUP_DEVICES=N`` and at the per-call `n_devices` (the
    autotuner's `mesh_fanout`; the env knob stays the outer bound, so an
    operator's 0 is never overridden by a stored plan), or None — one
    device — when `launch_fan_out` is off, the knob is 1, or fewer than
    two placements remain. `device`, when given, is the check's device:
    a check on another device than the mesh's first (the CPU beside the
    cards, another card than this process's) does not fan out."""
    if not launch_fan_out():
        return None
    if device is not None and torch.device(device).type != "cuda" \
            and pinned_placements() is None:
        return None  # a check on the host beside the cards
    devs = local_devices()
    cap = env_int("JGRAFT_GROUP_DEVICES", len(devs), minimum=0)
    if n_devices is not None:
        cap = min(cap, max(int(n_devices), 0))
    devs = devs[:max(cap, 1)]
    if len(devs) < 2:
        return None
    if device is not None and _indexed(resolve_device(device)) != devs[0]:
        return None
    return Mesh(devs)


def _on_device(name: str, dev: torch.device, *tensors) -> None:
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name}: inputs must be tensors on the "
                             f"mesh's device {dev}")


def _over_mesh(mesh: Mesh, fn, *tensors):
    """fn's outputs over a mesh (`kernel_ir.over_shards`: one launch a
    placement over its contiguous rows, on its own stream; one device is
    one launch over every row), joined on the mesh's first device: the
    per-row outputs in row order, the counts (the last output) summed
    over the shards."""
    runs = over_shards(mesh.devices, fn, *tensors)
    homes = join_rows(runs, sums=(len(runs[0][1].host) - 1,))
    return tuple(torch.from_numpy(np.asarray(h)).to(mesh.device)  # lint: allow(host-sync) the joined flags and counts go to the mesh's first device once
                 for h in homes)


def sharded_batch_checker(model, mesh: Mesh,
                          n_configs: int = DEFAULT_N_CONFIGS,
                          n_slots: int = MAX_SLOTS,
                          macro_p: Optional[int] = None):
    """fn(events [B, E, R] int32, real [B] bool) -> (ok [B], overflow [B],
    n_valid, n_unknown), all tensors on the mesh's first device: one
    launch of B5 (`sort_scan` at capacity `n_configs`, window `n_slots`;
    macro rows with `macro_p`) a placement over its contiguous rows,
    which counts B10's counts in sort mode in its epilogue (n_valid = Σ
    ok & ~overflow & real, n_unknown = Σ overflow & real), summed over
    the shards. `real` masks padding rows out of the counts. On a
    one-device mesh the inputs must lie on its device; on a larger one
    anywhere."""
    def one(events, real):
        ok, overflow, counts = sort_scan(events, n_slots, n_configs, macro_p,
                                         model=model, counts=True, real=real)
        return ok, overflow, counts

    def fn(events, real):
        if mesh.size == 1:
            _on_device("sharded_batch_checker", mesh.device, events, real)
        ok, overflow, counts = _over_mesh(mesh, one, events, real)
        return ok, overflow, counts[0], counts[1]

    return fn


def sharded_dense_checker(model, mesh: Mesh, kind: str, n_slots: int,
                          n_states: int, macro_p: Optional[int] = None):
    """fn(events [B, E, R] int32, val_of [B, S] int32, real [B] bool) ->
    (ok [B], overflow [B], n_valid, n_unknown) on the mesh's first
    device: one launch of B1 (`dense_scan`, kind "domain", S =
    `n_states`) or B4 (`mask_scan`, kind "mask", val_of unread) a
    placement over its contiguous rows, which counts B10's counts in
    dense mode in its epilogue (n_valid = Σ ok & real, n_unknown = 0:
    the dense kernels never overflow; the zero overflow [B] is returned
    for the reference's signature), summed over the shards."""
    if kind not in ("domain", "mask"):
        raise ValueError(f"sharded_dense_checker: kind {kind!r} is not "
                         "'domain' or 'mask'")

    def one(events, val_of, real):
        if kind == "mask":
            ok, counts = mask_scan(events, n_slots, macro_p, model=model,
                                   counts=True, real=real)
        else:
            ok, counts = dense_scan(events, val_of, n_slots, macro_p, None,
                                    model, counts=True, real=real)
        return ok, counts

    def fn(events, val_of, real):
        if mesh.size == 1:
            _on_device("sharded_dense_checker", mesh.device, events, val_of,
                       real)
        if kind == "domain" and int(val_of.shape[-1]) != int(n_states):
            raise ValueError(f"sharded_dense_checker: val_of has "
                             f"{val_of.shape[-1]} states, the plan "
                             f"{n_states}")
        ok, counts = _over_mesh(mesh, one, events, val_of, real)
        return ok, torch.zeros_like(ok), counts[0], counts[1]

    return fn


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()  # lint: allow(host-sync) the verdict flags leave the card here
    return np.ascontiguousarray(x, dtype=dtype)


def check_batch_sharded(model, events, mesh: Optional[Mesh] = None,
                        n_configs: Optional[int] = None,
                        n_slots: int = MAX_SLOTS,
                        dense: Optional[object] = None,
                        defer: bool = False,
                        macro_p: Optional[int] = None,
                        device=None):
    """Check a packed event batch over a mesh.

    events: [B, E, 5] int32 (history/packing.py layout), or a macro batch
    [B, E_mac, 3+4·P] with `macro_p=P`, as numpy or a tensor. Returns
    (ok [B], overflow [B] numpy bool, n_valid, n_unknown ints). `mesh`
    defaults to `make_mesh(device)`: this process's device (the card
    unless `device` names the CPU); a mesh of several placements spreads
    every launch's rows over them (one launch a placement over its
    contiguous rows).

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
    mesh = mesh or make_mesh(device)
    events = _host(events, np.int32)
    B = events.shape[0]

    # the launches take their rows from the host, shard by shard
    if dense is not None:
        pending = launch_dense_groups([DenseLaunch(
            events=torch.from_numpy(events),
            val_of=torch.from_numpy(_host(dense.val_of, np.int32)),
            n_events=None, n_slots=dense.n_slots, macro_p=macro_p,
            tag=dense.kernel_tag, kind=dense.kind, mesh=mesh)],
            model, counts=True)

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
        run = run_sort_rung(torch.from_numpy(events[remaining]), None,
                            n_slots, C, macro_p, model, mesh=mesh)
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
