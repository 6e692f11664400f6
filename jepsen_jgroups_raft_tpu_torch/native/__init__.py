"""Native tier bindings: build orchestration for the C++ data plane.

The C++ tier (the repository's `native/src`, built by its
`native/Makefile`) is the capability equivalent of the reference's Java
tier (SURVEY.md §2.2): raft_server daemon (Server.java), the three state
machines, libraftclient.so sync clients (SyncClient.java family), and
raft_member_cli (the jgroups-raft membership CLI the nemesis shells out
to, membership.clj:22-35). `ensure_built()` plays the role of the
reference's build-server! step (server.clj:48-58: built once on the
control node, gated so concurrent setups don't race).

The port builds into ``native/build-torch/`` (``make -C native
BUILD=build-torch``), never into the reference package's
``native/build/``, and takes an exclusive `fcntl` lock on a file there
around the staleness check and the build: the reference's lock is a
`threading.Lock` and guards one process only, while test workers and a
reference build may run at once. Sanitizer builds (``ensure_built(
san="tsan"|"asan")``) go into ``native/build-torch-<san>/`` under the
same lock, never into the reference's ``native/build-<san>/``.
"""

from __future__ import annotations

import fcntl
import subprocess
import threading
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "native"
BUILD_NAME = "build-torch"
BUILD_DIR = NATIVE_DIR / BUILD_NAME

SERVER_BIN = BUILD_DIR / "raft_server"
CLIENT_LIB = BUILD_DIR / "libraftclient.so"
MEMBER_CLI = BUILD_DIR / "raft_member_cli"

#: the binaries the harness runs; the Makefile's other targets (the log
#: self-test, the peer fuzzer) are not built
TARGETS = (SERVER_BIN, CLIENT_LIB, MEMBER_CLI)

_build_lock = threading.Lock()
_built = False

#: seconds the last build of this process took (0.0 when the binaries
#: were fresh); chip_smoke.py reports it
BUILD_SECONDS = 0.0

#: Sanitizer report markers per SAN= build (the reference's), shared by
#: every scanner of the node logs. No LeakSanitizer marker: every SUT
#: exit under the harness is SIGKILL, so LSAN's atexit check never runs.
SAN_MARKERS = {
    "tsan": ("WARNING: ThreadSanitizer",),
    "asan": ("ERROR: AddressSanitizer",),
}


def san_build_dir(san: str) -> Path:
    """Where ``ensure_built(san=san)`` puts its binaries."""
    return NATIVE_DIR / f"{BUILD_NAME}-{san}"


def _sources_mtime() -> float:
    src = NATIVE_DIR / "src"
    times = [p.stat().st_mtime for p in src.glob("*")]
    times.append((NATIVE_DIR / "Makefile").stat().st_mtime)
    return max(times)


def _stale(targets) -> bool:
    if not all(t.exists() for t in targets):
        return True
    return _sources_mtime() > min(t.stat().st_mtime for t in targets)


def _make_locked(targets, argv: list, what: str) -> float:
    """Run `argv` (a make command) if a target is missing or stale,
    holding the exclusive lock on ``native/build-torch/.build.lock``;
    returns the seconds it took (0.0 when the targets were fresh)."""
    seconds = 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _stale(targets):
                t0 = time.perf_counter()
                proc = subprocess.run(argv, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"native {what}build failed:\n{proc.stdout}\n"
                        f"{proc.stderr}")
                seconds = time.perf_counter() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return seconds


def ensure_built(san: str = "") -> None:
    """Build the native tier into ``native/build-torch/`` if a binary is
    missing or older than the sources. Idempotent; serialized within the
    process by a lock and across processes by an exclusive lock on
    ``native/build-torch/.build.lock``. With ``san="tsan"|"asan"`` the
    sanitizer build goes into ``native/build-torch-<san>/`` (``make
    BUILD=build-torch-<san> SAN=<san>``: the command line's BUILD
    overrides the Makefile's ``build-<san>``), under the same lock.
    Raises RuntimeError with make's output when the build fails."""
    global _built, BUILD_SECONDS
    with _build_lock:
        if san:
            if san not in SAN_MARKERS:
                raise ValueError(f"unknown sanitizer {san!r}; expected one "
                                 f"of {sorted(SAN_MARKERS)}")
            name = san_build_dir(san).name
            _make_locked((san_build_dir(san) / "raft_server",),
                         ["make", "-C", str(NATIVE_DIR), f"BUILD={name}",
                          f"SAN={san}"], f"{san} ")
            return
        if _built:
            return
        BUILD_SECONDS = _make_locked(
            TARGETS, ["make", "-C", str(NATIVE_DIR), f"BUILD={BUILD_NAME}",
                      *(f"{BUILD_NAME}/{t.name}" for t in TARGETS)], "")
        _built = True
