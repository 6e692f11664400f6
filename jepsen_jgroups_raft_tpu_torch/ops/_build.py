"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` (with the shared `csrc/*.cuh` headers) is
compiled by `nvcc` for Hopper (sm_90a) into a shared library with a
plain C entry point, at first use, into `build/torch_kernels/` at the
root of the checkout (listed in .gitignore), and loaded with `ctypes`.
The library's file name carries a hash of its sources and flags, so an
edited source or header never loads a stale build. No PyTorch headers are compiled, which keeps a build to
seconds. Any failure — no nvcc, a compile error, a load error — raises;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from ..platform import nvcc_path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: ctypes signatures of each library's C entry points: name ->
#: {function: (restype, argtypes)}. Pointers and the stream are
#: c_void_p — a plain int would be cut to 32 bits.
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES: Dict[str, dict] = {
    "dense_scan": {
        # events, val_of, n_events, ok, B, E, R, macro_p, W, S,
        # field_log2, model, device, stream
        "dense_scan_launch": (_I, [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _VP]),
        "dense_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "mask_scan": {
        # events, n_events, ok, B, E, R, macro_p, W, model, init_state,
        # device, stream
        "mask_scan_launch": (_I, [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _VP]),
        "mask_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "sort_scan": {
        # events, n_events, ok, overflow, B, E, R, macro_p, W, C, model,
        # init_state, device, stream
        "sort_scan_launch": (_I, [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _VP]),
        "sort_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "segment_scan": {
        # events, val_of, seed_mask, seed_state, n_events, out, K, NB, E,
        # W, S, field_log2, model, device, stream
        "segment_scan_launch": (_I, [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _VP]),
        "segment_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "cycle_closure": {
        # B7: in, out, has, B, N, device, stream
        "cycle_closure_launch": (_I, [_VP, _VP, _VP, _I, _I, _I, _VP]),
        # B8: a (in place), has, B, N, T, device, stream
        "cycle_closure_tiled_launch": (_I, [_VP, _VP, _I, _I, _I, _I,
                                            _VP]),
        "cycle_closure_error_string": (ctypes.c_char_p, [_I]),
    },
    "election_safety": {
        # obs, valid_len (or null), table, safe, B, N, log2cap, device,
        # stream
        "election_safety_launch": (_I, [_VP, _VP, _VP, _VP, _I, _I, _I,
                                        _I, _VP]),
        "election_safety_error_string": (ctypes.c_char_p, [_I]),
    },
    "mask_scan_profile": {
        # events, n_events, ok, prof, B, E, R, macro_p, W, model,
        # init_state, device, stream
        "mask_scan_profile_launch": (_I, [_VP, _VP, _VP, _VP, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _VP]),
        "mask_scan_profile_error_string": (ctypes.c_char_p, [_I]),
        "mask_scan_profile_fields": (_I, []),
    },
}

#: Libraries built from another library's source with extra nvcc flags:
#: name -> (source stem in csrc/, flags). Every other library `name`
#: builds from csrc/<name>.cu. The instrumented mask kernel is one: it
#: is measured by chip_smoke.py and never launched on a main path.
VARIANTS: Dict[str, tuple] = {
    "mask_scan_profile": ("mask_scan", ["-DMASK_SCAN_PROFILE"]),
}


def _source(name: str):
    """(source path, extra nvcc flags) of library `name`."""
    stem, flags = VARIANTS.get(name, (name, []))
    return CSRC / f"{stem}.cu", list(flags)


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas resource report) of each build made by this
#: process; `build_log` also reads it back from beside a library built
#: earlier.
BUILD_LOG: Dict[str, str] = {}


def _target(name: str) -> Path:
    # the shared headers are part of every kernel's source
    cu, flags = _source(name)
    src = b"".join(p.read_bytes() for p in [cu, *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's CUDA kernels cannot build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cu, flags = _source(name)
    cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str]) -> float:
    """Build every named library that is not built yet, one nvcc per
    source, all started together. Returns the wall seconds spent;
    raises on any compile failure."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {n: _start(n) for n in names}
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            proc, tmp, out = job
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}:\n"
                              f"{log[-4000:]}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: concurrent builds agree
        if errors:
            raise RuntimeError("CUDA kernel build failed\n" +
                               "\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIBS[name] = lib
    return lib


def error_string(name: str, rc: int) -> str:
    """Readable form of library `name`'s return code (its
    `<name>_error_string` entry): a CUDA error's text, or the argument
    check that refused the launch."""
    msg = getattr(load(name), f"{name}_error_string")(int(rc))
    return f"{rc}: {msg.decode() if msg else 'unknown error'}"


def build_log(name: str) -> str:
    """nvcc's output for library `name` as built from the current source:
    from this process's build, or from the log kept beside the library."""
    if name in BUILD_LOG:
        return BUILD_LOG[name]
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str) -> dict:
    """Sum of ptxas -v's per-function report for library `name`: the
    functions compiled, the most registers and stack any of them uses,
    and the spill bytes stored and loaded over all of them."""
    log = build_log(name)
    frames = [tuple(int(x) for x in m) for m in _PTXAS_FRAME.findall(log)]
    regs = [int(x) for x in _PTXAS_REGS.findall(log)]
    return {"functions": len(frames),
            "max_registers": max(regs, default=0),
            "max_stack_bytes": max((f[0] for f in frames), default=0),
            "spill_store_bytes": sum(f[1] for f in frames),
            "spill_load_bytes": sum(f[2] for f in frames)}
