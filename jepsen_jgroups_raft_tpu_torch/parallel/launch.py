"""Local multi-process launcher for distributed checking: the port of the
reference's `jepsen_jgroups_raft_tpu/parallel/launch.py`.

One process per rank on this host, each with torchrun's environment over
a localhost store (`cluster_child_env`), so the N-process topology runs
the same runtime a multi-host job does (`distributed.
maybe_init_distributed`, per-process packing, the store exchange). On a
real cluster the operator runs torchrun (or sets its variables by hand)
on every host instead.

Consumers: the tests and `chip_smoke.py`'s cluster phase. The parent
side of a benchmark's ``--distributed N`` comes with the port's
benchmark.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple


def free_coordinator_port() -> int:
    """An ephemeral localhost port for the cluster's store."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def cluster_child_env(process_id: int, n_processes: int, port: int,
                      extra: Optional[Dict[str, str]] = None) -> dict:
    """Environment of one child of the local topology: this process's
    environment with torchrun's variables for rank `process_id` of
    `n_processes` over a localhost store on `port` (``LOCAL_WORLD_SIZE``
    too, which the backend rule reads), ``OMP_NUM_THREADS=1`` where it is
    unset and there are several processes (torchrun's default: N
    processes of a core's worth of intra-op threads each would otherwise
    oversubscribe the host), `extra` (``JGRAFT_*`` knobs) on top, and no
    ``XLA_FLAGS``."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    if n_processes > 1:
        env.setdefault("OMP_NUM_THREADS", "1")
    env.update({
        "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": str(port),
        "WORLD_SIZE": str(n_processes),
        "RANK": str(process_id),
        "LOCAL_RANK": str(process_id),
        "LOCAL_WORLD_SIZE": str(n_processes),
    })
    if extra:
        env.update(extra)
    return env


def launch_local_cluster(n_processes: int, command: Sequence[str],
                         env_extra: Optional[Dict[str, str]] = None,
                         timeout_s: float = 1800.0) -> List[Tuple[int, str]]:
    """Run `command` as an N-process localhost cluster; returns one
    (returncode, combined output) pair per process, in rank order. The
    children share one deadline of `timeout_s`: a child still running
    then (a peer that crashed out of a barrier, a store never reached) is
    killed with the timeout noted in its output. Every child is killed
    and reaped on every path; outputs go to temporary files, so no pipe
    fills while a peer waits."""
    port = free_coordinator_port()
    procs: List[subprocess.Popen] = []
    files = []
    try:
        for pid in range(n_processes):
            f = tempfile.TemporaryFile(mode="w+")
            files.append(f)
            procs.append(subprocess.Popen(
                list(command), stdout=f, stderr=subprocess.STDOUT,
                text=True, env=cluster_child_env(pid, n_processes, port,
                                                 env_extra)))
        deadline = time.monotonic() + timeout_s
        outs: List[Tuple[int, str]] = []
        for p, f in zip(procs, files):
            note = ""
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                note = f"\n[killed: no exit in {timeout_s:.0f}s]"
            f.seek(0)
            outs.append((p.returncode, f.read() + note))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
