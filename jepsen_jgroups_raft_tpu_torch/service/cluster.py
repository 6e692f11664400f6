"""Replica membership, liveness leases, and cross-replica journal
handoff: graftd's cluster tier (the reference's `service/cluster.py`;
lease files, the journal layout and the claim names are the same, so
replicas of either package can share one cluster dir).

A cluster is N daemons sharing one directory (the cluster dir): the
content-addressed result store (service/store.py), a ``leases/`` dir of
liveness leases, and a ``journal/<replica>/`` WAL per replica. There is
deliberately NO coordinator process — every cluster-wide decision is a
pure function of the shared filesystem, made atomic by the two
primitives the journal and store already lean on (``os.replace`` for
publish, ``os.rename`` for claim):

* **Leases.** Each replica heartbeats a lease file carrying its url,
  load (queue depth / retry-after estimate), and a wall-clock renewal
  stamp. A lease is expired only when ``now > renewed + ttl + skew``:
  the skew margin (``JGRAFT_CLUSTER_SKEW_S``) tolerates the wall-clock
  disagreement real fleets have, and a lease stamped in the FUTURE by a
  fast-clock replica is simply alive — expiry is one-sided, so skew can
  delay a handoff but never trigger a false one against a live replica.
  Corrupt lease files are skipped loudly (a torn heartbeat must not
  eject a replica).
* **Load shedding.** A replica past its shed threshold
  (``JGRAFT_SERVICE_SHED_DEPTH``; 0 = capacity-only) rejects with 429
  carrying the CLUSTER'S best retry-after — the minimum over live
  leases — not its own: the client's backoff+failover then lands on
  the least-loaded replica instead of camping on the loaded one.
* **Journal handoff.** A replica whose lease expires leaves a WAL of
  accepted-but-unfinished work. A surviving replica CLAIMS it by
  atomically renaming ``journal/<dead>`` to
  ``journal/<dead>.claim.<survivor>`` — rename succeeds for exactly one
  claimant, which is the whole no-double-ownership argument — then
  replays it through the existing journal machinery: finished clean
  verdicts are lifted into the shared store, unfinished entries are
  re-admitted (re-journaled under the claimant's OWN lease first, so
  the durability chain never has a gap), and the claimed dir plus the
  dead lease are removed. A claimant that itself dies mid-adoption
  leaves the ``.claim.`` dir behind; the scan treats a claim dir whose
  claimant's lease is expired as claimable again, so *accepted ⇒
  eventually checked* holds as long as any replica survives.
* **Records this replica cannot check.** A WAL written by a replica of
  the reference package may hold requests under an algorithm the port
  does not offer (``"jax"``, ``"pallas"``); replay skips them loudly.
  The claimant adopts everything else and KEEPS the claimed dir, as it
  does for a take its own shutdown cut short, so no accepted request
  is deleted: once this replica's lease expires, any replica (one of
  the reference package among them) can claim the dir again. While
  this replica lives it does not re-adopt a dir it kept.

No launch happens on the agent thread: adopted requests enter the
admission queue and run on the service's workers, and adopted stream
sessions are parked stubs that revive on their first touch, on the
caller's thread.

Everything here is INERT unless a cluster dir is configured — the
single-replica daemon constructs no ClusterManager and touches none of
these files.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import List, Optional

from ..platform import env_float, env_int
from .journal import _crc_line
from .store import ResultStore

LOG = logging.getLogger("jgraft.service")

#: Lease schema version (reads skip newer-versioned leases loudly).
LEASE_VERSION = 1

#: Marker separating a claimed journal dir's origin from its claimant.
CLAIM_SEP = ".claim."


def lease_ttl_s() -> float:
    """Lease time-to-live (JGRAFT_CLUSTER_TTL_S, default 10 s): how
    stale a heartbeat may be before peers treat the replica as dead and
    hand off its journal. Defensively parsed like every env gate."""
    return env_float("JGRAFT_CLUSTER_TTL_S", 10.0, minimum=0.05)


def skew_tolerance_s() -> float:
    """Extra slack past the TTL before a lease counts as expired
    (JGRAFT_CLUSTER_SKEW_S, default 2 s) — the wall-clock disagreement
    budget between replicas writing and reading lease stamps."""
    return env_float("JGRAFT_CLUSTER_SKEW_S", 2.0, minimum=0.0)


def shed_depth() -> int:
    """Queue depth at which a replica starts shedding to the cluster
    (JGRAFT_SERVICE_SHED_DEPTH; default 0 disables early shedding —
    only queue capacity rejects, as a single replica does)."""
    return env_int("JGRAFT_SERVICE_SHED_DEPTH", 0, minimum=0)


def read_lease(path) -> Optional[dict]:
    """Parse one lease file; corrupt/torn/newer-versioned leases are
    skipped LOUDLY (a mangled heartbeat must never eject a replica or
    crash a reader) and report as None."""
    path = Path(path)
    try:
        raw = path.read_bytes()
    except FileNotFoundError:
        return None
    except OSError:
        LOG.warning("cluster: lease read of %s failed", path,
                    exc_info=True)
        return None
    try:
        rec = json.loads(raw)
        if not isinstance(rec, dict):
            raise ValueError("lease is not an object")
        if int(rec.get("v", -1)) > LEASE_VERSION:
            raise ValueError(f"lease version {rec.get('v')} is newer "
                             f"than this replica ({LEASE_VERSION})")
        if rec.get("crc") != _crc_line(rec):
            raise ValueError("crc mismatch (torn lease write)")
        float(rec["renewed_wall"])
        float(rec["ttl_s"])
    except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
        LOG.warning("cluster: corrupt lease %s skipped: %s", path, e)
        return None
    return rec


def lease_expired(lease: dict, now: Optional[float] = None,
                  skew_s: Optional[float] = None) -> bool:
    """One-sided expiry (module docstring): stale beyond ttl+skew is
    dead; a future-dated stamp (fast writer clock) is alive."""
    now = time.time() if now is None else now
    skew = skew_tolerance_s() if skew_s is None else skew_s
    return now > float(lease["renewed_wall"]) + float(lease["ttl_s"]) + skew


def live_replicas(root, skew_s: Optional[float] = None) -> List[dict]:
    """Non-expired leases under <root>/leases, sorted by replica id
    (deterministic for tests and routing)."""
    leases_dir = Path(root) / "leases"
    out: List[dict] = []
    try:
        paths = sorted(leases_dir.glob("*.json"))
    except OSError:
        return out
    now = time.time()
    for p in paths:
        lease = read_lease(p)
        if lease is not None and not lease_expired(lease, now=now,
                                                   skew_s=skew_s):
            out.append(lease)
    return out


def discover_replica_urls(root) -> List[str]:
    """Advertised URLs of the live replicas (clients bootstrap their
    replica list from this when they share the cluster filesystem)."""
    return [lease["url"] for lease in live_replicas(root)
            if lease.get("url")]


class ClusterManager:
    """One replica's membership + handoff agent (owned by its
    CheckingService). Runs a single daemon thread that heartbeats the
    lease every ttl/3 and scans for expired peers every
    `scan_interval_s`; `shutdown()` removes the lease (a clean exit has
    no unfinished WAL entries — shutdown fails queued work loudly with
    terminal markers — so there is nothing to hand off)."""

    def __init__(self, service, root, replica_id: str,
                 url: Optional[str] = None,
                 lease_ttl: Optional[float] = None,
                 scan_interval_s: Optional[float] = None,
                 skew_s: Optional[float] = None,
                 autostart: bool = True):
        self.service = service
        self.root = Path(root)
        self.replica_id = str(replica_id)
        self.url = url
        self.store = ResultStore(self.root)
        self.lease_ttl = (lease_ttl if lease_ttl is not None
                          else lease_ttl_s())
        self.skew_s = skew_s if skew_s is not None else skew_tolerance_s()
        self.scan_interval_s = (scan_interval_s if scan_interval_s
                                is not None
                                else max(self.lease_ttl / 2.0, 0.2))
        self.shed_depth = shed_depth()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: names of claimed dirs adopted but kept (records this replica
        #: cannot check; module docstring), never re-adopted by it
        self._kept: set = set()
        try:
            (self.root / "leases").mkdir(parents=True, exist_ok=True)
            (self.root / "journal").mkdir(parents=True, exist_ok=True)
        except OSError:
            LOG.warning("cluster: layout mkdir under %s failed",
                        self.root, exc_info=True)
        # First lease BEFORE the service replays its own journal (the
        # daemon constructs the manager before _recover): a restarting
        # replica re-arms its liveness before peers can mistake the
        # boot-time replay window for death and claim the WAL it is
        # replaying.
        self.renew_lease()
        if autostart:
            self.start()

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        # Publish liveness BEFORE the heartbeat thread exists: a
        # shutdown()/start() cycle removed the lease, and the loop's
        # first renewal is a whole beat away — in that window a peer's
        # scan would find no lease at all (no ttl+skew grace applies to
        # a missing file) and claim the LIVE WAL this replica is about
        # to append to.
        self.renew_lease()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"{self.replica_id}-cluster")
        self._thread.start()

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        try:
            self._lease_path(self.replica_id).unlink(missing_ok=True)
        except OSError:
            LOG.warning("cluster: lease removal failed on shutdown",
                        exc_info=True)

    def _loop(self) -> None:
        beat = max(self.lease_ttl / 3.0, 0.05)
        next_scan = time.monotonic() + self.scan_interval_s
        while not self._stop.wait(beat):
            try:
                self.renew_lease()
                if time.monotonic() >= next_scan:
                    next_scan = time.monotonic() + self.scan_interval_s
                    self.handoff_scan()
            except Exception:  # noqa: BLE001 — the heartbeat must
                # survive any one iteration's failure: a dead heartbeat
                # expires the lease and peers would steal a LIVE
                # replica's journal. Logged loudly, never swallowed.
                LOG.exception("cluster: heartbeat/handoff iteration "
                              "failed on %s", self.replica_id)

    # ---------------------------------------------------------- leases

    def _lease_path(self, replica_id: str) -> Path:
        return self.root / "leases" / f"{replica_id}.json"

    def set_url(self, url: str) -> None:
        """Late-bind the advertised URL (the HTTP front knows its bound
        port only after the service exists) and re-publish the lease."""
        self.url = url
        self.renew_lease()

    def renew_lease(self) -> None:
        """Publish this replica's liveness + load advertisement
        atomically (temp + `os.replace` — a reader never sees a torn
        lease, only the previous whole one)."""
        svc = self.service
        rec = {
            "v": LEASE_VERSION,
            "replica": self.replica_id,
            "url": self.url,
            "pid": os.getpid(),
            "renewed_wall": time.time(),
            "ttl_s": self.lease_ttl,
            "queue_depth": svc.queue.depth,
            "queue_capacity": svc.queue.capacity,
            "retry_after_s": svc._retry_after(),
        }
        rec["crc"] = _crc_line(rec)
        path = self._lease_path(self.replica_id)
        tmp = path.with_name(f".{self.replica_id}.{os.getpid()}.tmp")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(rec, fh, sort_keys=True, separators=(",", ":"))
            os.replace(tmp, path)
        except OSError:
            LOG.warning("cluster: lease renewal failed for %s",
                        self.replica_id, exc_info=True)

    def peers(self) -> List[dict]:
        """Live leases excluding this replica's own."""
        return [lease for lease in live_replicas(self.root,
                                                 skew_s=self.skew_s)
                if lease.get("replica") != self.replica_id]

    def best_retry_after(self, own_retry_after_s: float) -> float:
        """The cluster's best backpressure hint: the minimum retry-after
        over live replicas — a shedding replica's 429 tells the client
        when the LEAST-loaded peer frees a slot, so the jittered-backoff
        retry lands where there is room."""
        best = float(own_retry_after_s)
        for lease in self.peers():
            try:
                # a peer already at capacity is not a better target no
                # matter what its estimate says
                if int(lease.get("queue_depth", 0)) >= \
                        int(lease.get("queue_capacity", 1)):
                    continue
                best = min(best, float(lease["retry_after_s"]))
            except (ValueError, KeyError, TypeError):
                continue  # malformed advert: lease CRC passed but a
                # field is off-schema; skip just this peer
        return round(max(0.1, best), 2)

    def should_shed(self) -> bool:
        """Past the shed threshold (0 = disabled)? The daemon checks
        this before queue insert and answers 429 with
        `best_retry_after` when true."""
        return 0 < self.shed_depth <= self.service.queue.depth

    # --------------------------------------------------------- handoff

    def _journal_root(self) -> Path:
        return self.root / "journal"

    def journal_dir(self) -> Path:
        """This replica's own WAL directory inside the shared layout."""
        return self._journal_root() / self.replica_id

    def _lease_alive(self, replica_id: str) -> bool:
        lease = read_lease(self._lease_path(replica_id))
        return lease is not None and not lease_expired(
            lease, skew_s=self.skew_s)

    def handoff_scan(self) -> int:
        """One pass of the cross-replica handoff: claim and adopt every
        journal dir whose owner's lease is expired. Returns the number
        of dirs adopted this pass."""
        adopted = 0
        try:
            entries = sorted(self._journal_root().iterdir())
        except OSError:
            return adopted
        for entry in entries:
            if not entry.is_dir():
                continue
            name = entry.name
            origin = name.split(CLAIM_SEP, 1)[0]
            if CLAIM_SEP in name:
                claimant = name.rsplit(CLAIM_SEP, 1)[1]
                if claimant == self.replica_id:
                    if name in self._kept:
                        continue  # adopted; the rest is not ours to run
                    # our own stale claim (we crashed mid-adoption and
                    # restarted): resume it — the rename already made
                    # it exclusively ours
                    adopted += self._adopt(entry, origin)
                    continue
                if self._lease_alive(claimant):
                    continue  # someone live owns this handoff
            else:
                if origin == self.replica_id or self._lease_alive(origin):
                    continue
            claimed = self._journal_root() / (
                f"{origin}{CLAIM_SEP}{self.replica_id}")
            try:
                os.rename(entry, claimed)
            except OSError:
                continue  # lost the claim race — exactly one renamer
                # wins, which is the no-double-ownership invariant
            LOG.warning("cluster: %s claimed journal of expired replica "
                        "%s (%s)", self.replica_id, origin, name)
            adopted += self._adopt(claimed, origin)
        self._reap_dead_leases()
        return adopted

    def _adopt(self, claimed: Path, origin: str) -> int:
        """Replay a claimed WAL through the existing journal machinery:
        clean finished verdicts are lifted into the shared store,
        unfinished entries re-enter this replica's admission (re-owned
        durably — see CheckingService.adopt_requests), then the claimed
        dir and the dead lease are removed so nothing is orphaned —
        unless the take was partial or the WAL holds requests this
        replica cannot check (module docstring), when the dir stays."""
        from .journal import AdmissionJournal
        from .request import DONE

        journal = AdmissionJournal(claimed)
        try:
            replayed = journal.replay()
        finally:
            journal.close()
        for sub, term in replayed["finished"]:
            if term.get("status") == DONE \
                    and isinstance(term.get("results"), list) \
                    and sub.get("fingerprint"):
                self.store.put(sub["fingerprint"], term["results"])
        taken = self.service.adopt_requests(replayed["unfinished"],
                                            origin=origin)
        # Stream sessions ride the same claim: re-journaled under our
        # lease, then restored as resumable stubs — the producer's next
        # append (404-failover finds us) resumes where the dead
        # replica's WAL left off.
        streams = replayed.get("streams") or {}
        streams_taken = self.service.streams.adopt(streams,
                                                   origin=origin)
        if taken < len(replayed["unfinished"]) \
                or streams_taken < len(streams):
            # our own shutdown interrupted the adoption: keep the
            # claimed dir (exclusively ours by the rename) so a peer —
            # or our restart — re-adopts once OUR lease expires; the
            # entries we did take are already re-journaled locally
            LOG.warning("cluster: adoption of %s interrupted after "
                        "%d/%d entries; claimed dir kept", origin,
                        taken, len(replayed["unfinished"]))
            return 0
        self.service._count("handoff_claims")
        refused = replayed.get("refused") or []
        if refused:
            self._kept.add(claimed.name)
            LOG.warning("cluster: %s adopted %d unfinished entries from "
                        "%s; %d request(s) under an algorithm this "
                        "replica does not offer stay in %s for a replica "
                        "that does (claimable once this lease expires)",
                        self.replica_id, taken, origin, len(refused),
                        claimed)
            return 1
        shutil.rmtree(claimed, ignore_errors=True)
        try:
            self._lease_path(origin).unlink(missing_ok=True)
        except OSError:
            LOG.warning("cluster: dead lease removal failed for %s",
                        origin, exc_info=True)
        LOG.warning("cluster: %s adopted %d unfinished / %d finished "
                    "entries from %s (%d corrupt skipped)",
                    self.replica_id, len(replayed["unfinished"]),
                    len(replayed["finished"]), origin,
                    replayed["skipped"])
        return 1

    def _reap_dead_leases(self) -> None:
        """Remove expired leases with NO journal dir left behind (the
        journal-off ablation, or a handoff another replica completed):
        an expired lease must not advertise a ghost replica forever."""
        try:
            paths = sorted((self.root / "leases").glob("*.json"))
        except OSError:
            return
        for p in paths:
            lease = read_lease(p)
            if lease is None or not lease_expired(lease,
                                                  skew_s=self.skew_s):
                continue
            rid = str(lease.get("replica", ""))
            if rid == self.replica_id or not rid:
                continue
            if (self._journal_root() / rid).exists():
                continue  # handoff pending: the claim path owns cleanup
            try:
                p.unlink(missing_ok=True)
            except OSError:
                LOG.warning("cluster: stale lease reap of %s failed", p,
                            exc_info=True)

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        live = live_replicas(self.root, skew_s=self.skew_s)
        return {
            "replica_id": self.replica_id,
            "live_replicas": len(live),
            "shed_depth": self.shed_depth,
            **self.store.stats(),
        }
