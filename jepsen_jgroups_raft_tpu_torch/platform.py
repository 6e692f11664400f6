"""Environment knobs, degrade notes and device resolution for the port.

The env helpers are the reference package's (`jepsen_jgroups_raft_tpu/
platform.py`), copied so the port never imports it. What is new here:

  * `resolve_device` — every entry point of the port runs on the card
    unless the caller asks for the CPU by name. Without a CUDA device and
    without that explicit request it raises: the port never carries on
    on the host behind the caller's back.
  * `toolchain_stamp` — the torch / CUDA / nvcc versions and the card's
    name and power limit, printed beside every number a chip run keeps.
  * `pin_placements` — several placements of the CPU or of one card as
    this process's local devices (tests, chip_smoke.py's fan-out phase).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from typing import Optional

_log = logging.getLogger(__name__)

#: Why this process is NOT running on the platform it was asked for, or
#: None. Results carry it so a degraded run is distinguishable from an
#: intended one (the reference's convention).
_DEGRADED_NOTE: Optional[str] = None


def note_degraded(note: str) -> None:
    """Record that the platform degraded (first note wins: the root
    cause, not the retry cascade)."""
    global _DEGRADED_NOTE
    if _DEGRADED_NOTE is None:
        _DEGRADED_NOTE = note


def degraded_note() -> Optional[str]:
    """The degrade reason recorded by `note_degraded`, or None."""
    return _DEGRADED_NOTE


def env_int(name: str, default: int, minimum: Optional[int] = None) -> int:
    """Parse an integer env gate defensively: a non-integer value warns
    and falls back to the default; `minimum` clamps with a warning."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = int(raw.strip())
    except ValueError:
        _log.warning("%s=%r is not an integer; using default %d",
                     name, raw, default)
        return default
    if minimum is not None and val < minimum:
        _log.warning("%s=%d below minimum %d; clamping",
                     name, val, minimum)
        return minimum
    return val


def env_float(name: str, default: float,
              minimum: Optional[float] = None) -> float:
    """`env_int`'s float twin: garbage warns and keeps the default,
    sub-minimum clamps with a warning."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        val = float(raw.strip())
    except ValueError:
        _log.warning("%s=%r is not a number; using default %g",
                     name, raw, default)
        return default
    if minimum is not None and val < minimum:
        _log.warning("%s=%g below minimum %g; clamping",
                     name, val, minimum)
        return minimum
    return val


def env_str(name: str, default: str = "") -> str:
    """String twin of `env_int`: a missing or blank value falls back to
    the default."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip()


def resolve_device(device=None):
    """The torch.device an entry point runs on. None means the card:
    ``cuda`` when a CUDA device is present, else RuntimeError. Any
    explicit device (``"cpu"``, ``"cuda:0"``, a torch.device) is taken
    as given — asking for ``"cuda"`` without a card raises too."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


#: The local placements `pin_placements` set, or None: the host's cards.
_PLACEMENTS: Optional[tuple] = None


def pin_placements(n_placements: Optional[int], device="cpu") -> None:
    """Make this process's local devices `n_placements` placements of
    one `device` (the CPU by default, or one card, each placement of it
    then launching on a stream of its own), or with None (or 0) go back
    to the host's cards. The counterpart of the reference's
    `platform.pin_cpu(n)`, which splits the host into virtual devices:
    for tests, and for chip_smoke.py's fan-out phase on a one-card host.
    It reads no environment; the default never repeats a card."""
    import torch

    global _PLACEMENTS
    if not n_placements:
        _PLACEMENTS = None
        return
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _PLACEMENTS = (dev,) * int(n_placements)


def pinned_placements() -> Optional[tuple]:
    """The placements `pin_placements` set, or None."""
    return _PLACEMENTS


def _run(cmd) -> Optional[str]:
    """stdout of a short probe command, or None when it is absent or
    fails (the stamp reports what it could read, never raises)."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    return None


def toolchain_stamp() -> dict:
    """Versions and card identity for a run record: torch, its CUDA
    build, nvcc's release line, and `nvidia-smi`'s name + power limit
    (the limit matters: a card set below 700 W runs slower under load,
    so every kept number carries it)."""
    import torch

    nvcc = nvcc_path()
    nvcc_ver = _run([nvcc, "--version"]) if nvcc else None
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_name": (torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else None),
        "device_count": torch.cuda.device_count(),
        "nvcc": nvcc,
        "nvcc_version": (nvcc_ver.splitlines()[-1] if nvcc_ver else None),
        "nvidia_smi": smi,
    }
