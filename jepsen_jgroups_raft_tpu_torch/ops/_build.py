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
from concurrent.futures import ThreadPoolExecutor
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
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES: Dict[str, dict] = {
    "dense_scan": {
        # events, val_of, n_events, ok, real (or null), counts (or null),
        # B, E, R, macro_p, W, S, field_log2, model, device, stream
        "dense_scan_launch": (_I, [_VP] * 6 + [_I] * 9 + [_VP]),
        # events, carry in, carry out, flags, row stride, B, width, R,
        # macro_p, W, S, field_log2, model, carry length, device, stream
        "dense_scan_chunk_launch": (_I, [_VP, _VP, _VP, _VP, _LL] + [_I] * 10
                                    + [_VP]),
        "dense_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "dense_scan_count": {
        # as dense_scan's, with counts (never null) and real (or null)
        "dense_scan_launch": (_I, [_VP] * 6 + [_I] * 9 + [_VP]),
        "dense_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "mask_scan": {
        # events, n_events, ok, real (or null), counts (or null), B, E, R,
        # macro_p, W, model, init_state, device, stream
        "mask_scan_launch": (_I, [_VP] * 5 + [_I] * 8 + [_VP]),
        # events, carry in, carry out, flags, row stride, B, width, R,
        # macro_p, W, model, carry length, device, stream
        "mask_scan_chunk_launch": (_I, [_VP, _VP, _VP, _VP, _LL] + [_I] * 8
                                   + [_VP]),
        "mask_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "mask_scan_count": {
        # as mask_scan's, with counts (never null) and real (or null)
        "mask_scan_launch": (_I, [_VP] * 5 + [_I] * 8 + [_VP]),
        "mask_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "sort_scan": {
        # events, n_events, ok, overflow, real (or null), counts (or
        # null), B, E, R, macro_p, W, C, model, init_state, threads, tile,
        # table log2, device, stream
        "sort_scan_launch": (_I, [_VP] * 6 + [_I] * 12 + [_VP]),
        # events, carry in, carry out, flags, row stride, B, width, R,
        # macro_p, W, C, model, carry length, threads, tile, table log2,
        # device, stream
        "sort_scan_chunk_launch": (_I, [_VP, _VP, _VP, _VP, _LL] + [_I] * 12
                                   + [_VP]),
        # W, C, threads, shared-memory cap, out[4]
        "sort_scan_shape": (_I, [_I, _I, _I, _I,
                                 ctypes.POINTER(ctypes.c_longlong)]),
        "sort_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "segment_scan": {
        # events, val_of, seed_mask, seed_state, n_events, out, K, NB, E,
        # W, S, field_log2, model, warps, device, stream
        "segment_scan_launch": (_I, [_VP] * 6 + [_I] * 9 + [_VP]),
        # W, field_log2, K, NB, E, warps, out[8]
        "segment_scan_attributes": (_I, [_I] * 6 +
                                    [ctypes.POINTER(ctypes.c_longlong)]),
        "segment_scan_error_string": (ctypes.c_char_p, [_I]),
    },
    "segment_scan_profile": {
        # as segment_scan_launch, with prof after out
        "segment_scan_profile_launch": (_I, [_VP] * 7 + [_I] * 9 + [_VP]),
        "segment_scan_profile_error_string": (ctypes.c_char_p, [_I]),
        "segment_scan_profile_fields": (_I, []),
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
        # obs, valid_len (or null), table (or null), safe, B, N, log2cap,
        # form, device, stream
        "election_safety_launch": (_I, [_VP] * 4 + [_I] * 5 + [_VP]),
        "election_safety_error_string": (ctypes.c_char_p, [_I]),
    },
    "verdict_counts": {
        # B10: ok, overflow, real, out[2], B, mode, device, stream
        "verdict_counts_launch": (_I, [_VP] * 4 + [_LL, _I, _I, _VP]),
        "verdict_counts_error_string": (ctypes.c_char_p, [_I]),
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

#: Entry points named apart from their library: the chunk entry points live
#: in the one-shot kernel's source (one kernel body, two entry points).
ENTRY_LIBRARY: Dict[str, str] = {
    "dense_scan_chunk": "dense_scan",
    "mask_scan_chunk": "mask_scan",
    "sort_scan_chunk": "sort_scan",
}

#: Libraries built from another library's source with extra nvcc flags:
#: name -> (source stem in csrc/, flags). Every other library `name`
#: builds from csrc/<name>.cu. The instrumented mask and segment kernels
#: are two: each is measured by chip_smoke.py and never launched on a main
#: path. The counting instances of B1 and B4 (the scans' `counts=True`
#: option) are two more, built beside the plain ones by their own nvcc.
VARIANTS: Dict[str, tuple] = {
    "mask_scan_profile": ("mask_scan", ["-DMASK_SCAN_PROFILE"]),
    "segment_scan_profile": ("segment_scan", ["-DSEGMENT_SCAN_PROFILE"]),
    "dense_scan_count": ("dense_scan", ["-DDENSE_SCAN_COUNT"]),
    "mask_scan_count": ("mask_scan", ["-DMASK_SCAN_COUNT"]),
}


def _source(name: str):
    """(source path, extra nvcc flags) of library `name`."""
    stem, flags = VARIANTS.get(name, (name, []))
    return CSRC / f"{stem}.cu", list(flags)


class KernelBuildError(RuntimeError):
    """A kernel library that did not build (no nvcc, a compile error)
    or did not load. Its own class so that the checking service's
    degrade arm, which re-checks a failing batch on the host, lets it
    through: a missing kernel fails the request, it is never hidden
    behind a host verdict."""


_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas resource report) of each build made by this
#: process; `build_log` also reads it back from beside a library built
#: earlier.
BUILD_LOG: Dict[str, str] = {}
#: wall seconds from the start of a `build` call to the end of each
#: library's nvcc, for the libraries this process built
BUILD_SECONDS: Dict[str, float] = {}


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
        raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc "
                               "on PATH); the port's CUDA kernels cannot "
                               "build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cu, flags = _source(name)
    cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(proc, t0: float):
    """(nvcc's output, seconds from t0 to its end) of one started build."""
    log, _ = proc.communicate()
    return log, time.perf_counter() - t0


def build(names: Iterable[str]) -> float:
    """Build every named library that is not built yet, one nvcc per
    source, all started together (each one's seconds in BUILD_SECONDS).
    Returns the wall seconds spent; raises on any compile failure."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {n: j for n, j in ((n, _start(n)) for n in names)
                if j is not None}
        with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
            ends = {n: pool.submit(_finish, j[0], t0)
                    for n, j in jobs.items()}
        errors = []
        for name, (proc, tmp, out) in jobs.items():
            log, BUILD_SECONDS[name] = ends[name].result()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}:\n"
                              f"{log[-4000:]}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: concurrent builds agree
        if errors:
            raise KernelBuildError("CUDA kernel build failed\n" +
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
            try:
                lib = ctypes.CDLL(str(_target(name)))
            except OSError as e:
                raise KernelBuildError(
                    f"kernel library {name} did not load: {e}") from e
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIBS[name] = lib
    return lib


def error_string(name: str, rc: int) -> str:
    """Readable form of entry point `name`'s return code (its library's
    `<library>_error_string` entry): a CUDA error's text, or the
    argument check that refused the launch."""
    lib = ENTRY_LIBRARY.get(name, name)
    msg = getattr(load(lib), f"{lib}_error_string")(int(rc))
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
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")


def ptxas_functions(name: str) -> Dict[str, dict]:
    """ptxas -v's report for each entry function of library `name`
    (mangled name → registers, static shared memory, stack and spill
    bytes)."""
    out: Dict[str, dict] = {}
    parts = _PTXAS_ENTRY.split(build_log(name))
    for fn, text in zip(parts[1::2], parts[2::2]):
        frame = _PTXAS_FRAME.search(text)
        regs = _PTXAS_REGS.search(text)
        smem = _PTXAS_SMEM.search(text)
        out[fn] = {"registers": int(regs.group(1)) if regs else 0,
                   "static_smem_bytes": int(smem.group(1)) if smem else 0,
                   "stack_bytes": int(frame.group(1)) if frame else 0,
                   "spill_bytes": (int(frame.group(2)) + int(frame.group(3))
                                   if frame else 0)}
    return out


#: the one-shot scans' kernel templates, by library: their instances
#: without the counting option (template flag false, `Lb0E` in the
#: mangled name) and with it (`Lb1E`; B1's and B4's in the library of
#: the same name with "_count")
SCAN_TEMPLATES = {"dense_scan": "dense_scan_warp",
                  "mask_scan": "mask_scan_warp",
                  "sort_scan": "sort_scan_block"}


def ptxas_by_count(lib: str) -> tuple:
    """ptxas's per-function report of scan library `lib`'s one-shot
    kernel template (and of `lib`_count's, where the counting instances
    build apart), split into the instances that do not count and those
    that do: (plain, counting), each mangled name → `ptxas_functions`'s
    entry. Reads the build logs of libraries built or loaded earlier."""
    stem = SCAN_TEMPLATES[lib]
    funcs = {n: r for x in (lib, f"{lib}_count") if x in SIGNATURES
             for n, r in ptxas_functions(x).items() if stem in n}
    return ({n: r for n, r in funcs.items() if "Lb0E" in n},
            {n: r for n, r in funcs.items() if "Lb1E" in n})


def ptxas_report(name: str) -> dict:
    """Sum of ptxas -v's per-function report for library `name`: the
    functions compiled, the most registers, static shared memory and
    stack any of them uses, and the spill bytes stored and loaded over
    all of them."""
    log = build_log(name)
    frames = [tuple(int(x) for x in m) for m in _PTXAS_FRAME.findall(log)]
    regs = [int(x) for x in _PTXAS_REGS.findall(log)]
    smem = [int(x) for x in _PTXAS_SMEM.findall(log)]
    return {"functions": len(frames),
            "max_registers": max(regs, default=0),
            "max_static_smem_bytes": max(smem, default=0),
            "max_stack_bytes": max((f[0] for f in frames), default=0),
            "spill_store_bytes": sum(f[1] for f in frames),
            "spill_load_bytes": sum(f[2] for f in frames)}
