"""Definite/indefinite error taxonomy.

Equivalent of the reference's workload/client.clj:6-63. The load-bearing
distinction: a **definite** failure means the op certainly did not execute
(safe to record ``fail`` — the checker drops it); an **indefinite** failure
means the op may have executed (must record ``info`` — the checker treats
it as forever-concurrent). Mis-classifying an indefinite error as definite
makes the checker unsound; the reverse merely slows it down (reference
doc/intro.md:35-41 — info ops are the checker-pressure problem).

Mapping mirrored from the reference (client.clj:14-44), translated to this
framework's exception vocabulary:
  timeout            → indefinite  (request may be executing server-side)
  connection refused → definite    (never reached a server)
  socket broken      → indefinite  (request may have been received)
  not-leader         → definite    (server rejected without executing)

Idempotent ops (reads/inspects — per-workload sets, reference
register.clj:72, counter.clj:80, leader.clj:39) are safe to record as
``fail`` even on indefinite errors: re-executing or not executing a read
changes nothing the model can observe.
"""

from __future__ import annotations

import socket
from typing import Iterable, Tuple

from ..history.ops import FAIL, INFO, Op


class ClientTimeout(TimeoutError):
    """Operation timed out — indefinite."""


class ConnectFailed(ConnectionError):
    """Could not reach the server — definite."""


class NotLeader(Exception):
    """Server refused because it is not the Raft leader — definite."""


class SocketBroken(OSError):
    """Connection died mid-request — indefinite."""


def classify_error(exc: BaseException) -> Tuple[bool, str, str]:
    """exception → (definite?, kind, description)."""
    if isinstance(exc, NotLeader):
        return True, "no-leader", str(exc) or "not the leader"
    if isinstance(exc, (ClientTimeout, TimeoutError, socket.timeout)):
        return False, "timeout", str(exc) or "operation timed out"
    if isinstance(exc, (ConnectFailed, ConnectionRefusedError)):
        return True, "connect", str(exc) or "connection refused"
    if isinstance(exc, (SocketBroken, ConnectionError, OSError)):
        return False, "socket", str(exc) or "socket error"
    raise exc  # not a client error: let it surface (jepsen rethrows too)


def with_errors(invoke_fn, test: dict, op: Op,
                idempotent: Iterable[str] = ()) -> Op:
    """Run ``invoke_fn(test, op)``; translate client errors into the
    completed-op taxonomy (reference client.clj:52-63): definite failure or
    idempotent op ⇒ ``fail``; otherwise ⇒ ``info``."""
    try:
        return invoke_fn(test, op)
    except BaseException as exc:  # classify_error re-raises non-client errs
        definite, kind, desc = classify_error(exc)
        ctype = FAIL if (definite or op.f in set(idempotent)) else INFO
        return op.replace(type=ctype, error=f"{kind}: {desc}")
