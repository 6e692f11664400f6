"""B10's verdict counts: the wrapper of the hand-written kernel
ops/csrc/verdict_counts.cu, its plain version, and what the scan
kernels' counting option shares with it.

The reference's batch mesh (`jepsen_jgroups_raft_tpu/parallel/mesh.py`
`sharded_batch_checker` :141, `sharded_dense_checker` :191) reduces each
shard's (ok, overflow) flags with `jnp.sum` and sums the shards with
`jax.lax.psum`. In the port a process's shard is one launch of the scan
kernel on its card, and that launch counts its own verdicts in its
epilogue (`dense_scan`, `mask_scan`, `sort_scan` with ``counts=True``;
ops/csrc/verdict_counts.cuh):

  mode "dense": n_valid = Σ ok & real
  mode "sort":  n_valid = Σ ok & ~overflow & real
  both modes:   n_unknown = Σ overflow & real

``verdict_counts(ok, overflow, real, mode)`` counts flags that are
already in memory: three [B] bool tensors (each may be a slice of a
larger one) in, an int64 [2] tensor (n_valid, n_unknown) on their device
out. A CPU tensor takes `verdict_counts_plain`; a CUDA tensor launches
the kernel on the current stream without synchronising, or raises. Up to
16384 rows the launch is one block that stores the counts itself: one
launch, no memset.
"""

from __future__ import annotations

import torch

from . import _build

#: Launch counts of the wrapper: one is added per call that launches the
#: kernel on the card, and nowhere else.
LAUNCHES = {"verdict_counts": 0}

#: The C entry point's mode codes.
MODES = {"dense": 0, "sort": 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _check(ok, overflow, real, mode) -> int:
    """Refuse what the kernel does not take; returns B."""
    if mode not in MODES:
        raise ValueError(f"verdict_counts: mode {mode!r} is not one of "
                         f"{sorted(MODES)}")
    for name, t in (("ok", ok), ("overflow", overflow), ("real", real)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"verdict_counts: {name} must be a torch.Tensor")
        if t.dtype is not torch.bool or t.dim() != 1:
            raise TypeError(f"verdict_counts: {name} must be a [B] bool "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
    B = ok.shape[0]
    where = ok.get_device()
    for name, t in (("overflow", overflow), ("real", real)):
        if t.get_device() != where or (where < 0 and t.device != ok.device):
            raise ValueError(f"verdict_counts: {name} is on {t.device}, "
                             f"ok on {ok.device}")
        if t.shape[0] != B:
            raise ValueError(f"verdict_counts: {name} has {t.shape[0]} rows, "
                             f"ok {B}")
    if B > 1 and (ok.stride(0) != 1 or overflow.stride(0) != 1 or
                  real.stride(0) != 1):
        raise ValueError("verdict_counts: every flag tensor must be "
                         "contiguous")
    return B


def verdict_counts_plain(ok, overflow, real, mode: str = "sort"):
    """The counts in plain PyTorch: int64 [2] (n_valid, n_unknown) on the
    flags' device (the reference's `jnp.sum` lines, mesh.py:171-172 in
    sort mode, :211-212 in dense mode)."""
    _check(ok, overflow, real, mode)
    valid = ok & real
    if mode == "sort":
        valid = valid & ~overflow
    return torch.stack([valid.sum(dtype=torch.int64),
                        (overflow & real).sum(dtype=torch.int64)])


def scan_counts_plain(ok, overflow, real, mode: str):
    """The counting option of a scan's plain version: its own flags'
    counts (`verdict_counts_plain`), a missing overflow read as all
    False and a missing `real` as every row real (`check_real`)."""
    check_real(real, int(ok.shape[0]), ok.device)
    return verdict_counts_plain(
        ok, torch.zeros_like(ok) if overflow is None else overflow,
        torch.ones_like(ok) if real is None else real, mode)


def check_real(real, B: int, dev) -> None:
    """Refuse a scan's `real` mask unless it is a contiguous [B] bool
    tensor on the scan's device (None: every row real)."""
    if real is None:
        return
    if not isinstance(real, torch.Tensor) or real.dtype is not torch.bool \
            or real.dim() != 1 or real.shape[0] != B:
        raise TypeError(f"real must be a [{B}] bool tensor")
    if real.device != dev:
        raise ValueError(f"real is on {real.device}, the scan on {dev}")
    if B > 1 and real.stride(0) != 1:
        raise ValueError("real must be contiguous")


def counts_out(B: int, dev) -> torch.Tensor:
    """The int64 [2] counts a counting launch writes (zeros when B = 0,
    where no kernel runs)."""
    if B == 0:
        return torch.zeros((2,), dtype=torch.int64, device=dev)
    return torch.empty((2,), dtype=torch.int64, device=dev)


def _stream_handle(index: int) -> int:
    """The current CUDA stream of card `index`, as its raw handle (what
    `torch.cuda.current_stream(index).cuda_stream` gives, without making
    a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(index)


def _launch(ok, overflow, real, out, B: int, mode: int, index: int,
            stream: int) -> None:
    """Call the C entry point on the tensors' addresses (they outlive the
    call in the caller's hands) and count the launch, or raise."""
    rc = _build.load("verdict_counts").verdict_counts_launch(
        ok.data_ptr(), overflow.data_ptr(), real.data_ptr(), out.data_ptr(),
        B, mode, index, stream)
    if rc != 0:
        raise RuntimeError("verdict_counts kernel launch failed: "
                           f"{_build.error_string('verdict_counts', rc)}")
    LAUNCHES["verdict_counts"] += 1


def verdict_counts_launcher(ok, overflow, real, mode: str = "sort"):
    """Everything `verdict_counts` does on the card before the launch:
    check the CUDA tensors, allocate the int64 [2] output, build or load
    the kernel. Returns (out, launch); launch(stream) launches on that
    `torch.cuda.Stream` without synchronising and counts the launch, or
    raises (the kernel refuses B ≥ 2^32: its per-thread and block sums
    are 32-bit)."""
    B = _check(ok, overflow, real, mode)
    if not ok.is_cuda:
        raise ValueError(f"verdict_counts: unsupported device {ok.device} "
                         "(the plain version takes CPU tensors)")
    out = torch.empty((2,), dtype=torch.int64, device=ok.device)
    _build.load("verdict_counts")
    args = (ok, overflow, real, out, B, MODES[mode], ok.get_device())

    def launch(stream) -> None:
        _launch(*args, stream.cuda_stream)

    return out, launch


def verdict_counts(ok, overflow, real, mode: str = "sort"):
    """int64 [2] (n_valid, n_unknown) of [B] bool flags (see the module
    docstring). A CPU tensor takes `verdict_counts_plain`; a CUDA tensor
    launches the kernel on the current stream and counts the launch, or
    raises."""
    if not isinstance(ok, torch.Tensor) or ok.is_cpu:
        return verdict_counts_plain(ok, overflow, real, mode)
    B = _check(ok, overflow, real, mode)
    if not ok.is_cuda:
        raise ValueError(f"verdict_counts: unsupported device {ok.device} "
                         "(the plain version takes CPU tensors)")
    index = ok.get_device()
    out = torch.empty((2,), dtype=torch.int64, device=ok.device)
    _launch(ok, overflow, real, out, B, MODES[mode], index,
            _stream_handle(index))
    return out

