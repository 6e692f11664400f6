"""Shared content-addressed result store: the cluster tier's cache (the
reference's `service/store.py`; entry files are the same bytes, so
either package's `ResultStore` reads the other's).

A clean DONE terminal record of the admission journal already carries
the verdict list keyed by the submission's sha256 fingerprint. This
module lifts that idea out of the per-daemon journal into a filesystem
store ANY replica can read and write, so a verdict computed once is a
cache hit fleet-wide and a cold-started replica warms from the store
instead of re-checking from the wire.

Layout (under the cluster dir every replica shares)::

    <root>/results/<fp[:2]>/<fp>.json    # request-level verdict lists
    <root>/detail/<fp[:2]>/<fp>.json     # per-ROW result details (the
                                         # multi-process wavefront's
                                         # witness/counterexample
                                         # exchange, run_sharded)

Design points, each load-bearing:

* **Writes are atomic and first-wins.** An entry is written to a
  uniquely-named temp file in the same directory and published with
  ``os.replace`` — a reader never observes a half-written entry, and a
  crash mid-put leaves either no entry or a whole one. Two replicas
  racing the same fingerprint is the NORMAL case (idempotent
  resubmission fanned across the fleet): the writer that finds a valid
  entry already published discards its own copy (the verdicts are
  deterministic over the fingerprinted bytes, so either copy is
  correct — first-wins just avoids the pointless churn).
* **Entries carry a CRC and corrupt entries are never file-fatal.** A
  torn tail or bit-rotted entry costs exactly that entry: reads skip
  it LOUDLY (logged + counted) and report a miss; a later put heals it
  via the same atomic replace. One bad entry must never take down a
  replica or the store.
* **Degraded verdicts are never stored.** The same rule the LRU cache
  and the WAL terminal records apply: a ``platform-degraded`` stamp
  describes the run that produced it, not a future replay on a healthy
  replica — a degraded verdict served fleet-wide would poison every
  replica's answers for that fingerprint.
* **An entry keeps its writer's tags.** A verdict served from the
  store carries the ``algorithm`` / ``kernel`` of the replica that
  checked it, which in a cluster mixing both packages may be the
  reference's.

The store is INERT unless a cluster dir is configured
(``JGRAFT_SERVICE_CLUSTER_DIR``, or the daemon's ``cluster_dir``
argument) or the detail exchange names one (``JGRAFT_RESULT_STORE``);
single-replica graftd never touches this module.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path
from typing import List, Optional, Sequence

from ..platform import env_str
from .journal import _crc_line

LOG = logging.getLogger("jgraft.service")

#: Store schema version; reads refuse entries from a NEWER version
#: loudly (miss + count) instead of misparsing them.
STORE_VERSION = 1


def cluster_dir() -> Optional[str]:
    """The configured shared cluster directory, or None (the inert
    default — single-replica graftd)."""
    return env_str("JGRAFT_SERVICE_CLUSTER_DIR") or None


def _crc_entry(rec: dict) -> str:
    """Canonical CRC32 over the entry minus its own crc field (the same
    rule as the WAL's record CRC — service/journal.py)."""
    return _crc_line(rec)


def is_degraded(results: Sequence[dict]) -> bool:
    """The never-persist rule's predicate (module docstring)."""
    return any("platform-degraded" in r for r in results)


def detail_fingerprint(model, algorithm: str, enc) -> str:
    """Row-level content key for the detail exchange: one encoded unit
    hashed exactly like a single-unit submission (service/request.py),
    so the key is derivable by every process holding the same batch —
    the contract of `run_sharded` guarantees they all do — and equals
    the reference's key for the same encoding and algorithm name."""
    from .request import fingerprint_encodings

    return fingerprint_encodings(model, algorithm, [enc])


class ResultStore:
    """Filesystem-backed fingerprint → verdict store (module
    docstring). Thread-safe; every method is best-effort against IO
    failures — a store that raises would convert a disk hiccup into a
    checking outage, the exact conversion the journal refuses too."""

    def __init__(self, root):
        self.root = Path(root)
        self._lock = threading.Lock()
        self._counters = {"store_get_hits": 0,  # guarded_by(_lock)
                          "store_get_misses": 0,
                          "store_put_writes": 0, "store_put_discards": 0,
                          "store_corrupt_skipped": 0, "store_io_errors": 0}
        try:
            (self.root / "results").mkdir(parents=True, exist_ok=True)
            (self.root / "detail").mkdir(parents=True, exist_ok=True)
        except OSError:
            self._count("store_io_errors")
            LOG.warning("result store %s: layout mkdir failed",
                        self.root, exc_info=True)

    # ----------------------------------------------------------- paths

    def _entry_path(self, kind: str, fingerprint: str) -> Path:
        # two-level fan-out: one flat dir of millions of fingerprints
        # makes every listdir/rewrite O(fleet); 256 shards keep each
        # directory small
        return self.root / kind / fingerprint[:2] / f"{fingerprint}.json"

    # ----------------------------------------------------------- read

    def _read(self, kind: str, fingerprint: str) -> Optional[dict]:
        """Parsed valid entry or None. Corrupt/torn entries are skipped
        LOUDLY and never fatal; a racing writer's `os.replace` means a
        missing file between exists() and read is an ordinary miss."""
        path = self._entry_path(kind, fingerprint)
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            return None
        except OSError:
            self._count("store_io_errors")
            LOG.warning("result store: read of %s failed", path,
                        exc_info=True)
            return None
        try:
            rec = json.loads(raw)
            if not isinstance(rec, dict):
                raise ValueError("store entry is not an object")
            if int(rec.get("v", -1)) > STORE_VERSION:
                raise ValueError(
                    f"entry version {rec.get('v')} is newer than this "
                    f"replica ({STORE_VERSION})")
            if rec.get("crc") != _crc_entry(rec):
                raise ValueError("crc mismatch (torn or rotted entry)")
            if rec.get("fingerprint") != fingerprint:
                raise ValueError("entry fingerprint does not match its "
                                 "path (misfiled entry)")
        except (ValueError, json.JSONDecodeError) as e:
            self._count("store_corrupt_skipped")
            LOG.warning("result store: corrupt entry %s skipped: %s",
                        path, e)
            return None
        return rec

    def get(self, fingerprint: str) -> Optional[List[dict]]:
        """Verdict list for a fingerprint, or None (miss / corrupt)."""
        rec = self._read("results", fingerprint)
        if rec is None or not isinstance(rec.get("results"), list):
            self._count("store_get_misses")
            return None
        self._count("store_get_hits")
        return [dict(r) for r in rec["results"]]

    def get_detail(self, fingerprint: str) -> Optional[dict]:
        """Per-row result detail (witness, counterexample, kernel tag)
        for the distributed wavefront's remote rows, or None."""
        rec = self._read("detail", fingerprint)
        if rec is None or not isinstance(rec.get("result"), dict):
            return None
        return dict(rec["result"])

    # ----------------------------------------------------------- write

    def _publish(self, kind: str, fingerprint: str, body: dict) -> bool:
        """First-wins atomic publish (module docstring): discard when a
        VALID entry already exists; write temp + `os.replace` otherwise
        (healing a corrupt entry in place — replace is atomic, so a
        concurrent healthy writer cannot be half-overwritten)."""
        if self._read(kind, fingerprint) is not None:
            self._count("store_put_discards")
            return False
        rec = dict(body, v=STORE_VERSION, fingerprint=fingerprint)
        rec["crc"] = _crc_entry(rec)
        path = self._entry_path(kind, fingerprint)
        tmp = path.with_name(
            f".{fingerprint}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(rec, fh, sort_keys=True,
                          separators=(",", ":"))
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        except OSError:
            self._count("store_io_errors")
            LOG.warning("result store: publish of %s failed", path,
                        exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass  # temp already gone (replace landed) or unwritable
            return False
        self._count("store_put_writes")
        return True

    def put(self, fingerprint: str, results: Sequence[dict]) -> bool:
        """Store a clean verdict list; degraded verdicts are refused
        (never-persist rule). True when this call published the entry."""
        if is_degraded(results):
            return False
        from ..core.store import _jsonable

        return self._publish("results", fingerprint,
                             {"results": _jsonable(list(results))})

    def put_detail(self, fingerprint: str, result: dict) -> bool:
        """Store one row's full result detail (the detail exchange);
        same degraded gate as `put`."""
        if is_degraded([result]):
            return False
        from ..core.store import _jsonable

        return self._publish("detail", fingerprint,
                             {"result": _jsonable(dict(result))})

    # ----------------------------------------------------------- stats

    def _count(self, key: str) -> None:
        with self._lock:
            self._counters[key] += 1

    def stats(self) -> dict:
        with self._lock:
            return dict(self._counters)


_DETAIL_STORE_CACHE: dict = {}
_DETAIL_STORE_LOCK = threading.Lock()


def detail_store() -> Optional[ResultStore]:
    """Process-cached store for the distributed wavefront's detail
    exchange (parallel/distributed.run_sharded). Configured by
    ``JGRAFT_RESULT_STORE`` (a store dir shared across the cluster's
    processes) falling back to the cluster dir; None — the inert
    default — keeps remote rows as verdict-code stubs."""
    raw = env_str("JGRAFT_RESULT_STORE") or cluster_dir()
    if not raw:
        return None
    with _DETAIL_STORE_LOCK:
        store = _DETAIL_STORE_CACHE.get(raw)
        if store is None:
            store = ResultStore(raw)
            _DETAIL_STORE_CACHE[raw] = store
        return store
