"""ctypes bindings over libraftclient.so — the sync client family.

Python face of the C++ sync client (native/src/client_lib.cc), shaped like
the reference's Java clients that the Clojure harness loads in-process
(SURVEY.md §1 "key structural fact"; register.clj:14, counter.clj:13,
leader.clj:12):

  NativeRsmConn     ← SyncReplicatedStateMachineClient (put/get/cas)
  NativeCounterConn ← SyncReplicatedCounterClient (fixed counter name "mtc",
                      SyncReplicatedCounterClient.java:11)
  NativeLeaderConn  ← SyncLeaderInspectionClient (inspect → (leader, term))

Status codes map 1:1 onto the harness error taxonomy (client/errors.py →
reference workload/client.clj:6-44); CAS precondition failure returns False
rather than raising (register.clj:82-84 records it as :fail :cas-fail).

A copy of the reference's module; it loads the port's build of the
library (``native/build-torch/``, `native.ensure_built`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

from ..client.errors import (ClientTimeout, ConnectFailed, NotLeader,
                             SocketBroken)
from . import CLIENT_LIB, ensure_built

RC_OK = 0
RC_TIMEOUT = 1
RC_CONNECT = 2
RC_SOCKET = 3
RC_NOT_LEADER = 4
RC_SERVER = 5
RC_CAS_FAIL = 6


class ServerError(Exception):
    """Definite server-side rejection (crossed the wire as a failure
    Response — data/Response.java:42-67 semantics)."""


#: Everything a NativeConn call raises for node-side reasons: OSError
#: covers the whole indefinite family (ClientTimeout ⊂ TimeoutError,
#: ConnectFailed ⊂ ConnectionError, SocketBroken — all OSError
#: subclasses); NotLeader and ServerError are the definite rejections.
#: Callers that probe/clean up catch THIS, not Exception: a broad catch
#: would also swallow harness bugs, which the graftlint taxonomy rule
#: (taxonomy-silent-swallow) flags.
CONN_ERRORS = (OSError, NotLeader, ServerError)


_lib = None
_lib_lock = threading.Lock()

_SIGS = {
    "rc_create": ([ctypes.c_char_p, ctypes.c_int, ctypes.c_int],
                  ctypes.c_void_p),
    "rc_destroy": ([ctypes.c_void_p], None),
    "rc_last_error": ([ctypes.c_void_p], ctypes.c_char_p),
    "rc_map_put": ([ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64],
                   ctypes.c_int),
    "rc_map_get": ([ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "rc_map_cas": ([ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
                    ctypes.c_int64], ctypes.c_int),
    "rc_counter_get": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int64)], ctypes.c_int),
    "rc_counter_add": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64],
                       ctypes.c_int),
    "rc_counter_add_get": ([ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_int64)], ctypes.c_int),
    "rc_counter_cas": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                        ctypes.c_int64], ctypes.c_int),
    "rc_inspect": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int64)], ctypes.c_int),
    "rc_admin_probe": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int64)], ctypes.c_int),
    "rc_admin_add": ([ctypes.c_void_p, ctypes.c_char_p], ctypes.c_int),
    "rc_admin_remove": ([ctypes.c_void_p, ctypes.c_char_p], ctypes.c_int),
    "rc_admin_block": ([ctypes.c_void_p, ctypes.c_char_p], ctypes.c_int),
    "rc_admin_unblock": ([ctypes.c_void_p], ctypes.c_int),
    "rc_admin_members": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int],
                         ctypes.c_int),
}


def load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            ensure_built()
            lib = ctypes.CDLL(str(CLIENT_LIB))
            for name, (argtypes, restype) in _SIGS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


class NativeConn:
    """One blocking connection to one node's client port."""

    def __init__(self, host: str, port: int, timeout: float):
        self.lib = load_lib()
        self.handle = self.lib.rc_create(host.encode(), int(port),
                                         int(timeout * 1000))
        self._closed = False

    def _check(self, rc: int) -> int:
        if rc in (RC_OK, RC_CAS_FAIL):
            return rc
        msg = (self.lib.rc_last_error(self.handle) or b"").decode(
            "utf-8", "replace")
        if rc == RC_TIMEOUT:
            raise ClientTimeout(msg)
        if rc == RC_CONNECT:
            raise ConnectFailed(msg)
        if rc == RC_SOCKET:
            raise SocketBroken(msg)
        if rc == RC_NOT_LEADER:
            raise NotLeader(msg)
        raise ServerError(msg)

    def probe(self) -> Tuple[Optional[str], int]:
        """Local leader view — the JMX RAFT.leader probe analogue
        (server.clj:34-39)."""
        buf = ctypes.create_string_buffer(256)
        term = ctypes.c_int64()
        self._check(self.lib.rc_admin_probe(self.handle, buf, 256,
                                            ctypes.byref(term)))
        leader = buf.value.decode() or None
        return leader, int(term.value)

    def admin_add(self, member_spec: str) -> None:
        self._check(self.lib.rc_admin_add(self.handle, member_spec.encode()))

    def admin_remove(self, name: str) -> None:
        self._check(self.lib.rc_admin_remove(self.handle, name.encode()))

    def admin_block(self, peers) -> None:
        csv = ",".join(sorted(peers))
        self._check(self.lib.rc_admin_block(self.handle, csv.encode()))

    def admin_unblock(self) -> None:
        self._check(self.lib.rc_admin_unblock(self.handle))

    def admin_members(self) -> list:
        buf = ctypes.create_string_buffer(65536)
        self._check(self.lib.rc_admin_members(self.handle, buf, 65536))
        text = buf.value.decode()
        return [s for s in text.split(",") if s]

    def close(self) -> None:
        if not self._closed:
            self.lib.rc_destroy(self.handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except (OSError, AttributeError, TypeError):
            # interpreter-shutdown teardown: ctypes globals may already
            # be gone; anything else should surface
            pass


class NativeRsmConn(NativeConn):
    """Replicated-map connection (register workload)."""

    def put(self, key, value) -> None:
        self._check(self.lib.rc_map_put(self.handle, int(key), int(value)))

    def get(self, key, quorum: bool = True):
        val = ctypes.c_int64()
        found = ctypes.c_int()
        self._check(self.lib.rc_map_get(self.handle, int(key),
                                        1 if quorum else 0,
                                        ctypes.byref(val),
                                        ctypes.byref(found)))
        return int(val.value) if found.value else None

    def cas(self, key, frm, to) -> bool:
        rc = self._check(self.lib.rc_map_cas(self.handle, int(key),
                                             int(frm), int(to)))
        return rc == RC_OK


class NativeCounterConn(NativeConn):
    """Replicated-counter connection; counter name fixed to "mtc" like the
    reference client (SyncReplicatedCounterClient.java:11)."""

    NAME = b"mtc"

    def get(self, quorum: bool = True) -> int:
        val = ctypes.c_int64()
        self._check(self.lib.rc_counter_get(self.handle, self.NAME,
                                            1 if quorum else 0,
                                            ctypes.byref(val)))
        return int(val.value)

    def add(self, delta: int) -> None:
        self._check(self.lib.rc_counter_add(self.handle, self.NAME,
                                            int(delta)))

    def add_and_get(self, delta: int) -> int:
        val = ctypes.c_int64()
        self._check(self.lib.rc_counter_add_get(self.handle, self.NAME,
                                                int(delta),
                                                ctypes.byref(val)))
        return int(val.value)

    def cas(self, expect: int, update: int) -> bool:
        rc = self._check(self.lib.rc_counter_cas(self.handle, self.NAME,
                                                 int(expect), int(update)))
        return rc == RC_OK


class NativeLeaderConn(NativeConn):
    """Leader-inspection connection: inspect() → (leader, term) from the
    contacted node's local raft metadata (LeaderElection.java:35-44)."""

    def inspect(self) -> Tuple[Optional[str], int]:
        buf = ctypes.create_string_buffer(256)
        term = ctypes.c_int64()
        self._check(self.lib.rc_inspect(self.handle, buf, 256,
                                        ctypes.byref(term)))
        leader = buf.value.decode() or None
        return leader, int(term.value)


_KIND_CONN = {
    "register": NativeRsmConn,
    "counter": NativeCounterConn,
    "election": NativeLeaderConn,
}


def make_conn_factory(resolve):
    """Build the workloads' conn_factory over a node→(host, client_port)
    resolver. Mirrors how each workload opens its Java client against the
    node's port-9000 endpoint (register.clj:56-66)."""

    def factory(node: str, kind: str, timeout: float):
        host, port = resolve(node)
        return _KIND_CONN[kind](host, port, timeout)

    return factory
