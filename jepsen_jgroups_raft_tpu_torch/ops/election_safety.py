"""Election safety on the card: the wrapper of the hand-written kernel
ops/csrc/election_safety.cu, the port of the reference's
`check_election_safety_jax` (`jepsen_jgroups_raft_tpu/models/leader.py:163`,
B9's last kernel).

``election_safety(obs, valid_len)`` takes obs [B, N, 2] int32 (term,
leader) rows on a CUDA device — padded rows (-1, -1), or rows cut by
valid_len [B] int32 — and returns [B] bool, True where no term ≥ 0 has
two leaders. Its plain version is `models.leader.check_election_safety_plain`
(a CPU tensor goes there through `models.leader.check_election_safety`);
here a CUDA tensor launches the kernel or raises, and a CPU tensor is
refused. The kernel keeps one open-addressing table of `table_log2(N)`
64-bit slots a row as scratch (allocated here, filled by the launch).
"""

from __future__ import annotations

import torch

from . import _build
from .dense_scan import _check_int32, _device_index

#: Launch counts of the wrapper: one is added per call that launches the
#: kernel on the card, and nowhere else.
LAUNCHES = {"election_safety": 0}

#: The largest row the kernel's table takes: 2N slots ≤ 2^27.
MAX_OBSERVATIONS = 1 << 26


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def table_log2(n: int) -> int:
    """log2 of a row's table size: the power of two ≥ 2N (≥ 2)."""
    return max(1, (2 * int(n) - 1).bit_length())


def election_safety(obs, valid_len=None):
    """[B] bool safety verdicts of obs [B, N, 2] int32 on a CUDA device
    (see the module docstring). Launches on the current stream without
    synchronising, or raises."""
    if not isinstance(obs, torch.Tensor) or obs.device.type != "cuda":
        raise ValueError("election_safety: obs must be a CUDA tensor (the "
                         "plain version takes CPU tensors)")
    dev = obs.device
    _check_int32("obs", obs, 3, dev)
    B, n = int(obs.shape[0]), int(obs.shape[1])
    if int(obs.shape[2]) != 2:
        raise ValueError(f"election_safety: obs must be [B, N, 2], got "
                         f"{tuple(obs.shape)}")
    if obs.data_ptr() % 8:
        raise ValueError("election_safety: obs must be 8-byte aligned")
    if n > MAX_OBSERVATIONS:
        raise ValueError(f"election_safety: N={n} beyond "
                         f"{MAX_OBSERVATIONS}")
    if valid_len is not None:
        _check_int32("valid_len", valid_len, 1, dev)
        if int(valid_len.shape[0]) != B:
            raise ValueError(f"election_safety: valid_len must be [{B}], "
                             f"got {tuple(valid_len.shape)}")
    if n == 0 or B == 0:
        return torch.ones((B,), dtype=torch.bool, device=dev)
    log2cap = table_log2(n)
    table = torch.empty((B, 1 << log2cap), dtype=torch.int64, device=dev)
    safe = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = _build.load("election_safety")
    rc = lib.election_safety_launch(
        obs.data_ptr(), None if valid_len is None else valid_len.data_ptr(),
        table.data_ptr(), safe.data_ptr(), B, n, log2cap, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("election_safety kernel launch failed: "
                           f"{_build.error_string('election_safety', rc)}")
    LAUNCHES["election_safety"] += 1
    return safe
