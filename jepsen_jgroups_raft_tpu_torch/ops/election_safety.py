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
refused. Each row's open-addressing table holds `table_log2(N)` 64-bit
slots. The kernel's form follows from N alone (`election_form`): up to
SHARED_MAX_OBSERVATIONS the table lives in one CTA's shared memory, and
nothing but the verdicts is allocated here; above, each row's table is
global scratch, allocated here and filled by the launch.
"""

from __future__ import annotations

import torch

from . import _build
from .dense_scan import _check_int32

#: Launch counts of the wrapper: one is added per call that launches the
#: kernel on the card, and nowhere else.
LAUNCHES = {"election_safety": 0}

#: The largest row the kernel's table takes: 2N slots ≤ 2^27.
MAX_OBSERVATIONS = 1 << 26

#: The shared form's largest table, log2 of its 64-bit slots: 2^14
#: slots (128 KB) fit one CTA's 227 KB of shared memory; the next power
#: of two does not.
SHARED_MAX_LOG2 = 14

#: The longest row the shared form takes (2N ≤ 2^SHARED_MAX_LOG2).
SHARED_MAX_OBSERVATIONS = 1 << (SHARED_MAX_LOG2 - 1)

#: The shared form's largest block (its launch bound): one thread an
#: observation up to this many.
SHARED_MAX_THREADS = 512


def election_threads(n: int) -> int:
    """The shared form's threads a block for rows of N observations (the
    C++ rule, ops/csrc/election_safety.cu `shared_threads`, in plain
    Python): a warp at least, one thread an observation up to
    SHARED_MAX_THREADS, in powers of two."""
    t = 32
    while t < n and t < SHARED_MAX_THREADS:
        t = t * 2
    return t


def launch_threads(n: int) -> int:
    """The shared form's threads a block for rows of N, from the
    launcher's own rule (ops/csrc/election_safety.cu `shared_threads`):
    what `election_threads` restates. Loads the library (card only)."""
    got = _build.load("election_safety").election_safety_shared_threads(
        int(n))
    if got < 0:
        raise ValueError(f"election_safety: N={n} must be at least 1")
    return int(got)


#: The C entry point's form codes.
FORMS = {"shared": 0, "global": 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def table_log2(n: int) -> int:
    """log2 of a row's table size: the power of two ≥ 2N (≥ 2)."""
    return max(1, (2 * int(n) - 1).bit_length())


def election_form(n: int) -> str:
    """The kernel's form for rows of N observations, from N alone:
    "shared" (one CTA a row, the table in its shared memory) while the
    table fits, N ≤ SHARED_MAX_OBSERVATIONS; "global" (a thread an
    observation, each row's table in global scratch) above, up to
    MAX_OBSERVATIONS. Plain Python: runs without a card."""
    return "shared" if table_log2(n) <= SHARED_MAX_LOG2 else "global"


def _prepare(obs, valid_len, form):
    """Check the CUDA tensors and allocate the verdicts and, for the
    global form, the table scratch: (safe [B] bool, the C entry point's
    arguments but the stream, or None when there is nothing to launch)."""
    if not isinstance(obs, torch.Tensor) or obs.device.type != "cuda":
        raise ValueError("election_safety: obs must be a CUDA tensor (the "
                         "plain version takes CPU tensors)")
    dev = obs.device
    _check_int32("obs", obs, 3, dev)
    B, n, two = obs.shape
    if two != 2:
        raise ValueError(f"election_safety: obs must be [B, N, 2], got "
                         f"{tuple(obs.shape)}")
    ptr = obs.data_ptr()
    if ptr % 8:
        raise ValueError("election_safety: obs must be 8-byte aligned")
    if n > MAX_OBSERVATIONS:
        raise ValueError(f"election_safety: N={n} beyond "
                         f"{MAX_OBSERVATIONS}")
    if valid_len is not None:
        _check_int32("valid_len", valid_len, 1, dev)
        if valid_len.shape[0] != B:
            raise ValueError(f"election_safety: valid_len must be [{B}], "
                             f"got {tuple(valid_len.shape)}")
    if n == 0 or B == 0:
        return torch.ones((B,), dtype=torch.bool, device=dev), None
    log2cap = table_log2(n)
    if form is None:  # election_form(n), without computing log2cap twice
        form = "shared" if log2cap <= SHARED_MAX_LOG2 else "global"
    elif form not in FORMS:
        raise ValueError(f"election_safety: form {form!r} is not one of "
                         f"{sorted(FORMS)}")
    table = None
    if form == "global":
        table = torch.empty((B, 1 << log2cap), dtype=torch.int64, device=dev)
    safe = torch.empty((B,), dtype=torch.bool, device=dev)
    # the table's tensor lives as long as the arguments that hold it
    args = (ptr, None if valid_len is None else valid_len.data_ptr(),
            None if table is None else table.data_ptr(), safe.data_ptr(), B,
            n, log2cap, FORMS[form], obs.get_device(), table)
    return safe, args


def _launch(args, stream) -> None:
    rc = _build.load("election_safety").election_safety_launch(
        *args[:-1], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError("election_safety kernel launch failed: "
                           f"{_build.error_string('election_safety', rc)}")


def election_safety_launcher(obs, valid_len=None, form=None):
    """Everything `election_safety` does before the launch, at `form`
    (default `election_form(N)`): (safe [B] bool, launch(stream), or None
    when there is nothing to launch). For measuring one form against the
    other on the same rows; nothing is counted here."""
    safe, args = _prepare(obs, valid_len, form)
    return safe, None if args is None else (lambda s: _launch(args, s))


def election_safety(obs, valid_len=None):
    """[B] bool safety verdicts of obs [B, N, 2] int32 on a CUDA device
    (see the module docstring), at `election_form(N)`. Launches on the
    current stream without synchronising, or raises."""
    safe, args = _prepare(obs, valid_len, None)
    if args is not None:
        _launch(args, torch.cuda.current_stream(obs.device))
        LAUNCHES["election_safety"] += 1
    return safe
