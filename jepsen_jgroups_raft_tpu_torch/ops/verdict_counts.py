"""B10's verdict counts: the wrapper of the hand-written kernel
ops/csrc/verdict_counts.cu and its plain version.

The reference's batch mesh (`jepsen_jgroups_raft_tpu/parallel/mesh.py`
`sharded_batch_checker` :141, `sharded_dense_checker` :191) reduces each
shard's (ok, overflow) flags with `jnp.sum` and sums the shards with
`jax.lax.psum`. In the port a process's shard is one launch of the scan
kernel on its card, and this kernel makes the shard's two counts:

  mode "dense": n_valid = Σ ok & real
  mode "sort":  n_valid = Σ ok & ~overflow & real
  both modes:   n_unknown = Σ overflow & real

``verdict_counts(ok, overflow, real, mode)`` takes three [B] bool tensors
(each may be a slice of a larger one) and returns an int64 [2] tensor
(n_valid, n_unknown) on their device. A CPU tensor takes
`verdict_counts_plain`; a CUDA tensor launches the kernel on the current
stream without synchronising, or raises.
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


def _check(ok, overflow, real, mode):
    if mode not in MODES:
        raise ValueError(f"verdict_counts: mode {mode!r} is not one of "
                         f"{sorted(MODES)}")
    for name, t in (("ok", ok), ("overflow", overflow), ("real", real)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"verdict_counts: {name} must be a torch.Tensor")
        if t.dtype != torch.bool or t.dim() != 1:
            raise TypeError(f"verdict_counts: {name} must be a [B] bool "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != ok.device:
            raise ValueError(f"verdict_counts: {name} is on {t.device}, "
                             f"ok on {ok.device}")
        if t.shape[0] != ok.shape[0]:
            raise ValueError(f"verdict_counts: {name} has {t.shape[0]} rows, "
                             f"ok {ok.shape[0]}")
        if t.shape[0] > 1 and t.stride(0) != 1:
            raise ValueError(f"verdict_counts: {name} must be contiguous")


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


def verdict_counts_launcher(ok, overflow, real, mode: str = "sort"):
    """Everything `verdict_counts` does on the card before the launch:
    check the CUDA tensors, allocate the int64 [2] output, build or load
    the kernel. Returns (out, launch); launch(stream) zeroes out,
    launches the kernel on that `torch.cuda.Stream` without
    synchronising and counts the launch, or raises (the kernel refuses
    B ≥ 2^32: its per-thread and warp sums are 32-bit)."""
    _check(ok, overflow, real, mode)
    dev = ok.device
    if dev.type != "cuda":
        raise ValueError(f"verdict_counts: unsupported device {dev} (the "
                         "plain version takes CPU tensors)")
    B = int(ok.shape[0])
    out = torch.empty((2,), dtype=torch.int64, device=dev)
    lib = _build.load("verdict_counts")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    # the tensors live as long as the closure: the launch reads them
    args = (ok, overflow, real, out)

    def launch(stream) -> None:
        rc = lib.verdict_counts_launch(
            *(t.data_ptr() for t in args), B, MODES[mode], index,
            stream.cuda_stream)
        if rc != 0:
            raise RuntimeError("verdict_counts kernel launch failed: "
                               f"{_build.error_string('verdict_counts', rc)}")
        LAUNCHES["verdict_counts"] += 1

    return out, launch


def verdict_counts(ok, overflow, real, mode: str = "sort"):
    """int64 [2] (n_valid, n_unknown) of [B] bool flags (see the module
    docstring). A CPU tensor takes `verdict_counts_plain`; a CUDA tensor
    launches the kernel on the current stream and counts the launch, or
    raises."""
    if not isinstance(ok, torch.Tensor) or ok.device.type == "cpu":
        return verdict_counts_plain(ok, overflow, real, mode)
    out, launch = verdict_counts_launcher(ok, overflow, real, mode)
    launch(torch.cuda.current_stream(ok.device))
    return out
