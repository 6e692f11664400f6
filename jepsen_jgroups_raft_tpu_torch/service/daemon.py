"""graftd: the always-on checking daemon (the reference's
`service/daemon.py`, on the service's device; one replica, or one of N
sharing a cluster dir — service/cluster.py).

Owns the pieces the rest of the package provides — admission queue +
result cache (service/admission.py), batching scheduler
(service/scheduler.py), request records (service/request.py) — and adds
the lifecycle: a supervised worker thread that drains the queue batch
by batch, service-level stats (throughput, queue depth high-water,
batch occupancy, latency percentiles, cache hits), and per-request
trace records written into the existing ``store/`` layout
(``store/<service>/<ts>-<reqid>/results.json``) so ``core/serve.py``
browses service verdicts exactly like test runs.

Device: `CheckingService(device=None)` checks on the card and raises
without one; ``device="cpu"`` runs the kernels' plain versions on the
host. On the card, `start()` builds (or loads) the kernel libraries the
service can launch (`SERVICE_LIBRARIES`), so a missing nvcc fails the
start instead of any later request. A replica of a cluster builds them
in its constructor, before it publishes its first lease: one whose
kernels do not build never joins the cluster.

Failure stance:

* A batch whose injected ``check_fn`` seam dies, or whose default
  check path dies on a CPU device, degrades to the host ladder inside
  the scheduler — the request completes with ``platform-degraded``
  stamped, it does not error.
* A batch whose execution raises anyway (any failure of the card's
  default check path, a batch the watchdog gave up on twice there, a
  kernel that does not build or load, a host fallback bug) fails only
  that batch's requests, with the cause recorded; the worker loop
  continues.
* The worker THREAD dying (anything escaping the loop) loses nothing:
  the supervisor requeues the popped-but-unfinished batch, increments
  ``worker_restarts``, and respawns the worker. Queued requests were
  never popped, so they simply wait.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import threading
import time
from collections import deque
from pathlib import Path
from typing import Optional, Sequence

from ..ops._build import KernelBuildError
from ..platform import resolve_device
from .admission import (AdmissionQueue, QueueFull, ResultCache,
                        ServiceStopped)
from .journal import AdmissionJournal, decode_request, journal_enabled
from .request import (CANCELLED, DONE, FAILED, QUEUED, RUNNING, CheckRequest,
                      admit, admit_run_dir)
from .scheduler import BatchScheduler, ShardLoads
from .stream import StreamManager

LOG = logging.getLogger("jgraft.service")

#: The kernel libraries a service on the card can launch: the dense,
#: mask and sort scans (every workload, and the streams' carried sort
#: scan), the segmented scan (long submissions) and the cycle closure
#: (the weaker consistency rungs).
SERVICE_LIBRARIES = ("dense_scan", "mask_scan", "sort_scan",
                     "segment_scan", "cycle_closure")


class _ShardQueue:
    """Closeable per-shard work queue. The close/put race matters: a
    dispatcher routing a batch while shutdown drains the queues would
    otherwise strand the batch forever — its requests were already
    popped from the admission queue (so its drain misses them) and the
    executors have exited (the shutdown/submit race the AdmissionQueue
    closes with `close()`; this is the routed-batch twin).
    `put` refuses under the same lock as the insert, so a routed batch
    either lands before `close_and_drain` (and is failed by it) or is
    refused (and the dispatcher fails it) — never silently stranded."""

    def __init__(self):
        self._cond = threading.Condition()
        self._items: deque = deque()  # guarded_by(_cond)
        self._closed = False  # guarded_by(_cond)

    def put(self, item) -> bool:
        with self._cond:
            if self._closed:
                return False
            self._items.append(item)
            self._cond.notify()
            return True

    def get(self, timeout: float):
        """Next item, or None on timeout / closed-and-empty."""
        with self._cond:
            if not self._items and not self._closed:
                self._cond.wait(timeout)
            if self._items:
                return self._items.popleft()
            return None

    def close_and_drain(self) -> list:
        with self._cond:
            self._closed = True
            items = list(self._items)
            self._items.clear()
            self._cond.notify_all()
            return items

    def reopen(self) -> None:
        with self._cond:
            self._closed = False


def default_workers() -> int:
    """Worker shards (JGRAFT_SERVICE_WORKERS, default 1 — the
    single-worker daemon). With N > 1, N independent shape-bucket
    batches check concurrently on the service's device, each executor
    on a CUDA stream of its own, instead of serializing through one
    thread; defensively parsed."""
    from ..platform import env_int

    return env_int("JGRAFT_SERVICE_WORKERS", 1, minimum=1)

#: Poll granularity of the worker loop (also the shutdown latency
#: bound). The queue condition wakes the worker instantly on arrival;
#: this only bounds how often an idle worker re-checks the stop flag.
IDLE_POLL_S = 0.25

#: Latency samples kept for the percentile window.
LATENCY_WINDOW = 4096


def retain_capacity() -> int:
    """Terminal requests kept queryable after completion (the /result
    retention window, JGRAFT_SERVICE_RETAIN). Bounded for the same
    reason the queue is: an always-on daemon that retains every
    finished request's histories and encodings grows RSS without
    limit — the OOM the admission bound exists to prevent."""
    from ..platform import env_int

    return env_int("JGRAFT_SERVICE_RETAIN", 1024, minimum=1)


def default_crash_cap() -> int:
    """Executor deaths tolerated per request before quarantine
    (JGRAFT_SERVICE_CRASH_CAP, default 2 — one batched attempt, one
    solo attempt after the split). The unbounded alternative: a
    deterministically-crashing batch re-kills the supervised worker
    forever."""
    from ..platform import env_int

    return env_int("JGRAFT_SERVICE_CRASH_CAP", 2, minimum=1)


def default_watchdog_margin() -> float:
    """Hung-batch watchdog margin in seconds past a request's DEADLINE
    (JGRAFT_SERVICE_WATCHDOG_S, default 30; 0 disables). Strike one at
    deadline+margin requeues the request; strike two at
    deadline+2·margin retries it solo via the bounded host ladder
    (`check_encoded_host`) — or, on the card's default check path,
    fails it — so a wedged device launch can never park a shard queue
    forever. Parsed as a float: sub-second margins are how
    the watchdog tests keep their wall clock down, and the old
    `float(env_int(...))` form silently discarded `0.5` to the
    default."""
    from ..platform import env_float

    return env_float("JGRAFT_SERVICE_WATCHDOG_S", 30.0, minimum=0.0)


class CheckingService:
    """The daemon. `start()` spawns the supervised worker; `submit*`
    admit requests (raising `admission.QueueFull` past capacity);
    `shutdown()` drains in-flight work and joins every thread."""

    def __init__(self, store_root: Optional[str] = None,
                 name: str = "graftd",
                 queue_capacity: Optional[int] = None,
                 batch_wait: Optional[float] = None,
                 max_batch_rows: Optional[int] = None,
                 cache_capacity: Optional[int] = None,
                 check_fn=None, host_fallback=None,
                 n_workers: Optional[int] = None,
                 journal_dir: Optional[str] = None,
                 crash_cap: Optional[int] = None,
                 watchdog_margin_s: Optional[float] = None,
                 cluster_dir: Optional[str] = None,
                 replica_id: Optional[str] = None,
                 advertise_url: Optional[str] = None,
                 lease_ttl_s: Optional[float] = None,
                 device=None,
                 autostart: bool = True):
        self.name = name
        self.store_root = Path(store_root) if store_root else None
        #: where every check of this service runs (module docstring)
        self.device = resolve_device(device)
        self._kernels_ready = False
        self.queue = AdmissionQueue(queue_capacity,
                                    on_prune=self._finalize_pruned)
        self.cache = ResultCache(cache_capacity)
        self.scheduler = BatchScheduler(
            self.queue, check_fn=check_fn, host_fallback=host_fallback,
            max_batch_rows=max_batch_rows, batch_wait=batch_wait,
            device=self.device)
        # Worker shards: 1 = a single supervised worker
        # executing inline; N > 1 = the same loop becomes a DISPATCHER
        # that routes each formed batch to the least-loaded shard's
        # executor thread, so independent shape buckets check
        # concurrently. Placement is stamped into per-request stats.
        self.n_workers = max(1, n_workers if n_workers is not None
                             else default_workers())
        self.shards = ShardLoads(self.n_workers)
        self._shard_queues: list = [_ShardQueue()
                                    for _ in range(self.n_workers)]
        self._executors: list = [None] * self.n_workers
        #: thread id → the batch that thread popped and is executing.
        #: Keyed by THREAD (not shard): after a watchdog replacement
        #: the zombie and its successor coexist briefly, and the
        #: zombie's cleanup must not clobber the successor's record.
        self._inflight_by_thread: dict = {}  # guarded_by(_lock)
        self._requests: dict = {}  # guarded_by(_lock)
        # finished ids, oldest first
        self._terminal: deque = deque()  # guarded_by(_lock)
        self._retain = retain_capacity()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._started = False
        self._worker: Optional[threading.Thread] = None
        self._latencies: deque = deque(maxlen=LATENCY_WINDOW)  # guarded_by(_lock)
        # Durability/resilience tier.
        self.crash_cap = (crash_cap if crash_cap is not None
                          else default_crash_cap())
        self.watchdog_margin_s = (
            watchdog_margin_s if watchdog_margin_s is not None
            else default_watchdog_margin())
        self._watchdog: Optional[threading.Thread] = None
        #: fingerprint → live (queued/running) primary request, and
        #: primary id → attached idempotent-duplicate followers.
        self._primary_by_fp: dict = {}  # guarded_by(_lock)
        self._followers: dict = {}  # guarded_by(_lock)
        self._stats = {  # guarded_by(_lock)
            "submitted": 0, "completed": 0, "failed": 0, "cancelled": 0,
            "rejected": 0, "cache_hits": 0, "batches": 0, "batch_rows": 0,
            "batched_requests": 0, "degraded_batches": 0,
            "max_queue_depth": 0, "worker_restarts": 0, "trace_errors": 0,
            "recovered_requests": 0, "attached_requests": 0,
            "quarantined": 0, "watchdog_requeues": 0,
            # lin-rung fast lane: requests fully decided by
            # the host certifier at dispatch — never a batch slot, a
            # shard queue, or a kernel launch. Always in the schema,
            # zero when the lane is off.
            "fastpath_requests": 0,
            # cluster tier — always in the schema, zero when clustering
            # is not configured (the seam stays inert)
            "store_hits": 0, "store_puts": 0,
            "handoff_claims": 0, "handoff_requests": 0,
        }
        #: daemon-wide decided-tier counters ({tier: rows}
        #: over every demuxed verdict) — the fleet capacity-model
        #: metric, merged per batch and served by /stats. Kept outside
        #: _stats so _count's int arithmetic never sees a dict.
        self._tier_counts: dict = {}  # guarded_by(_lock)
        self._service_time_s = 1.0  # EWMA of per-request service time
        # Cluster tier: constructed only when a cluster dir is
        # configured — the single-replica daemon never imports the
        # module. Created BEFORE the journal (the shared layout owns the
        # WAL path) and before _recover (the manager's first lease
        # re-arms liveness before the boot-time replay window, so a
        # restarting replica's peers do not claim the WAL it is
        # replaying). On the card the kernels are built first: a replica
        # whose kernels do not build raises here, before it publishes a
        # lease, and never joins the cluster as a host-only replica.
        self.cluster = None
        from ..platform import env_str

        cdir = (cluster_dir if cluster_dir is not None else
                env_str("JGRAFT_SERVICE_CLUSTER_DIR") or None)
        if cdir:
            from .cluster import ClusterManager

            self.prepare_kernels()
            rid = (replica_id
                   or env_str("JGRAFT_SERVICE_REPLICA_ID")
                   or f"{self.name}-{os.getpid()}")
            url = (advertise_url
                   or env_str("JGRAFT_SERVICE_ADVERTISE_URL") or None)
            self.cluster = ClusterManager(self, cdir, rid, url=url,
                                          lease_ttl=lease_ttl_s,
                                          autostart=autostart)
        self._journal: Optional[AdmissionJournal] = None
        if journal_enabled() and (journal_dir or self.cluster is not None
                                  or self.store_root):
            root = (Path(journal_dir) if journal_dir
                    else self.cluster.journal_dir()
                    if self.cluster is not None
                    else self.store_root / self.name / "journal")
            if self.cluster is not None and not journal_dir \
                    and self.store_root is not None:
                self._migrate_legacy_journal(root)
            self._journal = AdmissionJournal(root, retain=self._retain)
        # Streaming session tier: always constructed — the
        # in-memory mode works without a journal; crash resume and
        # idle-park resumability need one (stream.py docstring).
        self.streams = StreamManager(self)
        if self._journal is not None:
            self._recover()
        if autostart:
            self.start()

    def _migrate_legacy_journal(self, root: Path) -> None:
        """First boot after clustering is enabled on a daemon that was
        running durable single-replica: the per-daemon WAL
        (store/<name>/journal/wal.jsonl) is moved into the shared
        layout so its accepted-but-unfinished entries replay instead of
        being silently abandoned at the legacy path. When BOTH WALs
        exist (a partial earlier migration or manual copy) the cluster
        one wins and the legacy one is reported loudly — guessing at a
        record-level merge could double-admit."""
        import shutil

        legacy = self.store_root / self.name / "journal" / "wal.jsonl"
        target = root / "wal.jsonl"
        if not legacy.exists():
            return
        if target.exists():
            LOG.warning("%s: legacy journal %s left in place (a WAL "
                        "already exists at %s); entries there will NOT "
                        "replay — inspect and remove it manually",
                        self.name, legacy, target)
            return
        try:
            root.mkdir(parents=True, exist_ok=True)
            # shutil.move survives a cross-filesystem store/cluster
            # split, where os.replace would EXDEV; startup-only (runs
            # before worker threads or peers can race the WAL path)
            shutil.move(str(legacy), str(target))  # lint: allow(nonatomic-publish)
            LOG.warning("%s: migrated legacy journal %s into the "
                        "cluster layout at %s", self.name, legacy,
                        target)
        except OSError:
            LOG.warning("%s: legacy journal migration failed; entries "
                        "at %s will not replay", self.name, legacy,
                        exc_info=True)

    # ------------------------------------------------------- recovery

    def _recover(self) -> None:
        """Crash recovery: replay the admission journal.
        Finished entries are restored into the retention window (their
        clean results also re-warm the fingerprint cache); unfinished
        entries re-enter the admission queue in original deadline
        order, except that a replayed duplicate whose fingerprint now
        cache-hits (or matches an earlier replayed primary) short-
        circuits instead of re-executing."""
        try:
            replayed = self._journal.replay()
        except OSError:
            LOG.warning("%s journal replay failed; starting with an "
                        "empty queue", self.name, exc_info=True)
            return
        for sub, term in replayed["finished"]:
            try:
                req = decode_request(sub)
            except (ValueError, KeyError, TypeError):
                continue
            req._journaled = True   # already has its terminal marker
            req._retired = True     # do not re-journal / re-resolve
            req.replayed = True
            status = term.get("status", FAILED)
            results = term.get("results")
            if status == DONE and results is None:
                # The verdict existed but was not persisted (degraded
                # runs never are): restored as FAILED so the client
                # resubmits for a fresh one instead of reading a DONE
                # with no results.
                status, error = FAILED, ("verdict was not persisted "
                                         "across restart; resubmit")
            else:
                error = term.get("error")
            req.finish(status, results=results, error=error)
            with self._lock:
                self._requests[req.id] = req
                self._terminal.append(req.id)
            if status == DONE and results is not None \
                    and len(results) == req.n_rows:
                # WAL terminals never persist degraded results (the
                # encode_terminal gate strips them, and the DONE-with-
                # no-results arm above re-fails such rows), so a
                # journal-replayed verdict is clean by construction
                self.cache.put(req.fingerprint, results)  # lint: allow(degraded)
                # lift the WAL terminal record into the shared store: a
                # verdict this replica computed before the restart
                # becomes a fleet-wide cache hit
                if self.cluster is not None and \
                        self.cluster.store.put(req.fingerprint, results):
                    self._count("store_puts")
        recovered = []
        for req in replayed["unfinished"]:
            req._journaled = True
            with self._lock:
                self._requests[req.id] = req
            cached = self.cache.get(req.fingerprint)
            if cached is None and self.cluster is not None:
                # another replica may have verified this fingerprint
                # while we were down — a cold-started replica warms
                # from the store instead of re-checking
                stored = self.cluster.store.get(req.fingerprint)
                if stored is not None and len(stored) == req.n_rows:
                    cached = stored
                    self.cache.put(req.fingerprint, stored)
                    self._count("store_hits")
            if cached is not None and len(cached) == req.n_rows:
                req.cached = True
                req.finish(DONE, results=cached)
                self._count("cache_hits", "completed")
                self._retire(req)
                continue
            with self._lock:
                primary = self._primary_by_fp.get(req.fingerprint)
                if primary is not None and not primary.terminal:
                    # replayed duplicate: attach, don't re-execute
                    req.attached_to = primary.id
                    self._followers.setdefault(primary.id,
                                               []).append(req)
                    self._stats["attached_requests"] += 1
                    self._stats["recovered_requests"] += 1
                    continue
                self._primary_by_fp[req.fingerprint] = req
            recovered.append(req)
        if recovered:
            # requeue(): replayed entries were admitted once already —
            # capacity is not re-enforced against them (the same stance
            # as worker-death recovery). replay() sorted by deadline.
            self.queue.requeue(recovered)
            with self._lock:
                self._stats["recovered_requests"] += len(recovered)
        with self._lock:
            while len(self._terminal) > self._retain:
                self._requests.pop(self._terminal.popleft(), None)
        # Stream sessions: finished ones restore as terminal
        # stubs, unfinished ones as parked RESUMABLE stubs — the first
        # post-restart touch replays their journaled segments through
        # the identical pipeline (boot stays fast; rebuild is lazy).
        streams = replayed.get("streams") or {}
        if streams:
            self.streams.restore(streams)
        if recovered or replayed["finished"] or replayed["skipped"] \
                or streams:
            LOG.info("%s journal replay: %d unfinished requeued, %d "
                     "finished restored, %d stream session(s) restored, "
                     "%d corrupt/truncated record(s) skipped", self.name,
                     len(recovered), len(replayed["finished"]),
                     len(streams), replayed["skipped"])

    def adopt_requests(self, reqs, origin: str = "") -> int:
        """Re-own an expired replica's unfinished journal entries
        (called by ClusterManager._adopt after its atomic rename claim,
        on the cluster agent's thread, which never launches: adopted
        requests enter the admission queue and run on the workers).
        Each adopted request is re-journaled into THIS replica's WAL
        before it becomes runnable — the durability chain has no gap:
        until the claimed dir is removed the entry exists there, and
        from the append here it exists in our WAL under our live lease.
        Dedup mirrors _recover: a fingerprint the caches or a live
        primary already cover short-circuits instead of re-executing
        (resubmit-at-most-once, cluster-wide); an id this replica
        already holds (a claimed dir adopted again after a restart) is
        taken as it stands."""
        taken = 0
        recovered = []
        for req in reqs:
            if self._stop.is_set():
                # shutdown mid-adoption: entries not taken stay in the
                # claimed dir (the manager skips its cleanup when we
                # report a partial take), so nothing is orphaned
                break
            with self._lock:
                known = req.id in self._requests
            if known:
                taken += 1
                continue
            req.replayed = True
            if self._journal is not None:
                req._journaled = True
            with self._lock:
                self._requests[req.id] = req
            if self._journal is not None:
                self._journal.append_submit(req)
            self._count("handoff_requests")
            taken += 1
            cached = self.cache.get(req.fingerprint)
            if cached is None and self.cluster is not None:
                stored = self.cluster.store.get(req.fingerprint)
                if stored is not None and len(stored) == req.n_rows:
                    cached = stored
                    self.cache.put(req.fingerprint, stored)
                    self._count("store_hits")
            if cached is not None and len(cached) == req.n_rows:
                req.cached = True
                req.finish(DONE, results=cached)
                self._count("completed")
                self._retire(req)
                self._write_trace(req)
                continue
            attached = False
            with self._lock:
                primary = self._primary_by_fp.get(req.fingerprint)
                if primary is not None and not primary.terminal:
                    req.attached_to = primary.id
                    self._followers.setdefault(primary.id, []).append(req)
                    self._stats["attached_requests"] += 1
                    attached = True
                else:
                    self._primary_by_fp[req.fingerprint] = req
            if not attached:
                recovered.append(req)
        if recovered:
            # replay() delivered them deadline-sorted; requeue preserves
            # that order at the head (adopted work was admitted before
            # anything currently queued here)
            self.queue.requeue(recovered)
        if taken:
            self._ensure_worker()
            LOG.warning("%s adopted %d unfinished request(s) from "
                        "expired replica %s (%d requeued)", self.name,
                        taken, origin or "<unknown>", len(recovered))
        return taken

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        self.prepare_kernels()  # a replica's ran before its first lease
        self._stop.clear()
        self.queue.reopen()
        for q in self._shard_queues:
            q.reopen()
        self._started = True
        if self.cluster is not None:
            self.cluster.start()
        self._ensure_worker()

    def prepare_kernels(self) -> None:
        """On the card, build (or load) every library in
        SERVICE_LIBRARIES, one nvcc per source, all started together;
        nothing on a CPU device. A library that does not build or load
        raises `KernelBuildError` here, so the service never starts
        without its kernels (and never answers for them from the
        host)."""
        if self.device.type != "cuda" or self._kernels_ready:
            return
        from ..ops import _build

        _build.build(SERVICE_LIBRARIES)
        for name in SERVICE_LIBRARIES:
            _build.load(name)
        self._kernels_ready = True

    def _ensure_worker(self) -> None:
        """Spawn (or respawn after death) the supervised dispatcher and,
        for n_workers > 1, the per-shard executors. Called under submit
        too, so a STARTED daemon whose worker died serves the next
        tenant instead of silently queueing forever (a daemon built
        with autostart=False stays parked until `start()` — the
        deterministic-coalescing mode tests and the CI smoke use)."""
        with self._lock:
            if self._stop.is_set() or not self._started:
                return
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._supervised_loop, daemon=True,
                    name=f"{self.name}-worker")
                self._worker.start()
            if self.n_workers > 1:
                for k in range(self.n_workers):
                    t = self._executors[k]
                    if t is None or not t.is_alive():
                        t = threading.Thread(
                            target=self._supervised_executor, args=(k,),
                            daemon=True, name=f"{self.name}-shard{k}")
                        self._executors[k] = t
                        t.start()
            if self.watchdog_margin_s > 0 and (
                    self._watchdog is None
                    or not self._watchdog.is_alive()):
                self._watchdog = threading.Thread(
                    target=self._watchdog_loop, daemon=True,
                    name=f"{self.name}-watchdog")
                self._watchdog.start()

    def shutdown(self, wait: bool = True, timeout: float = 30.0) -> None:
        """Stop the workers; queued requests are failed loudly (a
        shutdown is not a verdict). Idempotent. The queue is CLOSED
        before the drain, so a submission racing this call either
        lands before the drain (and is failed by it) or gets
        ServiceStopped from `put` — never a silently-stranded entry."""
        self._stop.set()
        # Stop the cluster agent FIRST (joins its thread): a handoff
        # adoption racing this shutdown would otherwise requeue adopted
        # entries after the drain below and strand them. Entries it
        # already re-journaled are safe either way — they are in OUR
        # WAL, so the drain's terminal markers (or a later replay)
        # account for them.
        if self.cluster is not None:
            self.cluster.shutdown()
        self.queue.close()
        # Close the shard queues BEFORE joining: a dispatcher mid-route
        # either landed its batch (drained here) or gets a refused put
        # and fails the batch itself — no window strands a routed batch
        # (see _ShardQueue). Executors wake on the close and exit.
        stranded = [item for q in self._shard_queues
                    for item in q.close_and_drain()]
        for batch, _rows, _placement in stranded:
            self._fail_unexecuted(batch)
        worker = self._worker
        if wait and worker is not None and worker.is_alive():
            worker.join(timeout)
        if wait:
            for t in self._executors:
                if t is not None and t.is_alive():
                    t.join(timeout)
            wd = self._watchdog
            if wd is not None and wd.is_alive():
                wd.join(timeout)
        drained = self.queue.take(lambda pending: list(pending), timeout=0.0)
        for r in drained:
            if r.finish(FAILED, error="service shut down before execution"):
                self._count("failed")
            self._retire(r)
        # Stream sessions survive shutdown BY DESIGN (unlike queued
        # batch requests, which are failed loudly above): their
        # journaled segments make them resumable — a clean restart is
        # indistinguishable from a crash to a streaming producer.
        self.streams.shutdown()
        if self._journal is not None:
            self._journal.close()

    # --------------------------------------------------------- worker

    def _supervised_loop(self) -> None:
        try:
            self._worker_loop()
        except BaseException:
            # The loop itself died (not a batch — _worker_loop contains
            # per-batch error handling). Requeue what was popped and
            # respawn: queued tenants must survive a worker bug.
            LOG.exception("%s worker died; restarting", self.name)
            with self._lock:
                inflight = self._inflight_by_thread.pop(
                    threading.get_ident(), [])
            self._recover_crashed(inflight)
            self._count("worker_restarts")
            if not self._stop.is_set():
                with self._lock:
                    if self._worker is threading.current_thread():
                        self._worker = None
                self._ensure_worker()

    def _abandoned(self) -> bool:
        """True when THIS thread is no longer the daemon's dispatcher —
        the watchdog replaced it while it was wedged on a hung batch
       . The zombie finishes its in-flight no-op demux and
        exits instead of competing with its replacement."""
        return self._worker is not threading.current_thread()

    def _worker_loop(self) -> None:
        """Single-worker mode: form and execute inline. Multi-worker
        mode: this loop is the DISPATCHER — it forms batches and routes
        each to the least-loaded shard's executor, so independent shape
        buckets run concurrently."""
        tid = threading.get_ident()
        while not self._stop.is_set() and not self._abandoned():
            batch = self.scheduler.next_batch(
                timeout=IDLE_POLL_S, on_decided=self._fastlane_done)
            if not batch:
                continue
            rows = sum(r.n_rows for r in batch)
            if self.n_workers == 1:
                placement = {"shard": 0, "n_shards": 1,
                             "loads_at_dispatch": self.shards.snapshot()}
                self.shards.add(0, rows)
                with self._lock:
                    self._inflight_by_thread[tid] = list(batch)
                try:
                    self._run_batch(batch, placement)
                    # cleared only on NORMAL completion: when execution
                    # kills this thread, the record must survive for
                    # the supervisor's crash recovery to requeue it
                    with self._lock:
                        self._inflight_by_thread.pop(tid, None)
                finally:
                    self.shards.done(0, rows)
                continue
            k = self.shards.least_loaded()
            placement = {"shard": k, "n_shards": self.n_workers,
                         "loads_at_dispatch": self.shards.snapshot()}
            self.shards.add(k, rows)
            if not self._shard_queues[k].put((batch, rows, placement)):
                # Shutdown closed the shard queues between formation
                # and routing: fail the batch loudly, like the drains.
                self.shards.done(k, rows)
                self._fail_unexecuted(batch)

    def _fastlane_done(self, done) -> None:
        """Account requests the dispatch fast lane decided: they never
        reach a shard queue or `scheduler.execute`, so the
        completed/latency/cache/tier accounting and trace writes that
        normally ride the batch path run here. The results are clean
        host verdicts (never degraded), so the fingerprint cache serves
        resubmissions exactly like batch verdicts."""
        with self._lock:
            self._stats["fastpath_requests"] += len(done)
            for r in done:
                for tier, n in r.stats.get("decided_tier", {}).items():
                    self._tier_counts[tier] = \
                        self._tier_counts.get(tier, 0) + n
        self._account_requests(done)
        for r in done:
            self._write_trace(r)

    def _fail_unexecuted(self, batch) -> None:
        """A shutdown is not a verdict: requests popped from admission
        but never executed fail with the same error the queue drains
        use."""
        for r in batch:
            if r.status in (QUEUED, RUNNING):
                r.finish(FAILED,
                         error="service shut down before execution")
                self._count("failed")
                self._retire(r)

    def _run_batch(self, batch, placement: dict) -> None:
        """Execute one formed batch (dispatcher inline or a shard
        executor): batch-level failures fail only this batch's
        requests; traces are written either way."""
        try:
            info = self.scheduler.execute(batch, placement=placement)
            self._account_batch(batch, info)
        except Exception as e:
            # The card's default path failed, a kernel did not build
            # or load (never degraded), the host fallback failed, or a
            # scheduler bug: fail THIS batch's requests, keep serving
            # the queue.
            LOG.exception("%s batch execution failed", self.name)
            if isinstance(e, KernelBuildError):
                error = "kernel build or load failed: " + str(e)[-2000:]
            elif not self.scheduler.host_degrade:
                error = (f"device path failed on {self.device}: "
                         f"{type(e).__name__}: {e}")[:2000]
            else:
                error = "batch execution raised; see service log"
            for r in batch:
                if r.status not in (DONE, CANCELLED, FAILED):
                    r.finish(FAILED, error=error)
            self._account_requests(batch)
        for r in batch:
            self._write_trace(r)

    def _supervised_executor(self, k: int) -> None:
        """Shard executor k: drain this shard's routed batches. The
        same survival contract as the dispatcher's supervisor: a dying
        executor requeues its popped-but-unfinished batch into the
        admission queue, bumps ``worker_restarts``, and is respawned —
        queued tenants must survive an executor bug."""
        tid = threading.get_ident()
        try:
            q = self._shard_queues[k]
            while not self._stop.is_set() \
                    and self._executors[k] is threading.current_thread():
                item = q.get(timeout=IDLE_POLL_S)
                if item is None:
                    continue
                batch, rows, placement = item
                with self._lock:
                    self._inflight_by_thread[tid] = list(batch)
                try:
                    self._run_batch(batch, placement)
                    # normal-completion clear only; on death the
                    # supervisor below pops and requeues this record
                    with self._lock:
                        self._inflight_by_thread.pop(tid, None)
                finally:
                    self.shards.done(k, rows)
        except BaseException:
            LOG.exception("%s shard %d executor died; restarting",
                          self.name, k)
            with self._lock:
                inflight = self._inflight_by_thread.pop(tid, [])
            self._recover_crashed(inflight)
            self._count("worker_restarts")
            if not self._stop.is_set():
                with self._lock:
                    if self._executors[k] is threading.current_thread():
                        self._executors[k] = None
                self._ensure_worker()

    def _recover_crashed(self, inflight) -> None:
        """Executor-death recovery with the poison-batch quarantine
       . Every unfinished request of the dying batch gets a
        crash strike. Below the cap it re-queues — SPLIT solo when the
        batch had company, so a deterministically-crashing rider re-runs
        alone and its innocent neighbors complete. At the cap
        (JGRAFT_SERVICE_CRASH_CAP, default 2: one batched attempt + one
        solo attempt) the request is FAILED individually — the bounded
        alternative to respawning the worker forever."""
        unfinished = [r for r in inflight
                      if r.status in (QUEUED, RUNNING)]
        survivors = []
        for r in unfinished:
            r.crash_count += 1
            if r.crash_count >= self.crash_cap:
                if r.finish(FAILED, error=(
                        f"quarantined: executor died {r.crash_count}x "
                        "with this request in flight "
                        "(JGRAFT_SERVICE_CRASH_CAP)")):
                    self._count("failed", "quarantined")
                self._retire(r)
                self._write_trace(r)
            else:
                # split: every survivor of a crashed batch is suspect
                # and re-runs SOLO — an innocent rider completes alone,
                # the poison one crashes alone and hits the cap without
                # taking fresh arrivals down with it.
                r.solo = True
                r.status = QUEUED
                survivors.append(r)
        if survivors:
            self.queue.requeue(survivors)

    # ------------------------------------------------------- watchdog

    def _watchdog_loop(self) -> None:
        """Hung-batch watchdog: a RUNNING request that blows
        past its deadline by the margin is requeued once (strike one —
        maybe the shard was just busy); past 2x the margin it requeues
        again solo with ``force_host`` set, so the retry runs the
        bounded host ladder (or, on the card's default check path,
        fails) and the wedged device launch can never park a shard
        queue forever. The stale execution keeps running — a
        Python thread cannot be killed — but `finish` is first-wins, so
        whichever copy completes first owns the client-visible result;
        the loser demuxes into a no-op."""
        poll = max(0.05, min(1.0, self.watchdog_margin_s / 4.0))
        while not self._stop.wait(poll):
            now = time.monotonic()
            strikes = []
            with self._lock:
                reqs = list(self._requests.values())
            for r in reqs:
                if r.status != RUNNING or r.terminal \
                        or r.cancelled.is_set():
                    continue
                # BOTH clocks must be overdue: the deadline (the
                # client's latency contract) AND the current
                # execution's own runtime. A request that spent its
                # deadline waiting in a backlogged queue is late, not
                # hung — striking it would duplicate work and demote
                # healthy workers exactly when the daemon is busiest
                # (metastable-overload amplification).
                over = min(now - r.deadline, now - r.run_started)
                if over <= self.watchdog_margin_s:
                    continue
                if r.watchdog_hits == 0:
                    r.watchdog_hits = 1
                    strikes.append(r)
                elif (r.watchdog_hits == 1
                        and over > 2.0 * self.watchdog_margin_s):
                    r.watchdog_hits = 2
                    r.solo = True
                    r.force_host = True
                    strikes.append(r)
            for r in strikes:
                # status stays RUNNING on purpose: the wedged execution
                # still holds the request, and strike two keys on that
                # (a watchdog requeue is a retry of running work, not a
                # return to the queued state).
                self._count("watchdog_requeues")
                LOG.warning("%s watchdog: request %s exceeded its "
                            "deadline by >%gs (strike %d%s); requeued",
                            self.name, r.id, self.watchdog_margin_s,
                            r.watchdog_hits,
                            ", forcing host ladder"
                            if r.force_host else "")
                if r.watchdog_hits >= 2:
                    self._abandon_holder(r)
            if strikes:
                self.queue.requeue(strikes)

    def _abandon_holder(self, req: CheckRequest) -> None:
        """De-wedge: the worker thread wedged on `req`'s batch is
        demoted (a Python thread cannot be killed) and a replacement is
        spawned, so the requeued force-host retry — and every later
        batch — has a live worker to run on. The zombie notices it was
        replaced when (if) it unblocks, demuxes into first-wins no-ops,
        and exits its loop."""
        with self._lock:
            holders = [tid for tid, batch
                       in self._inflight_by_thread.items()
                       if any(x is req for x in batch)]
            if not holders:
                return
            for holder in holders:
                if self._worker is not None \
                        and self._worker.ident == holder:
                    self._worker = None
                for k, t in enumerate(self._executors):
                    if t is not None and t.ident == holder:
                        self._executors[k] = None
        LOG.warning("%s watchdog: worker thread(s) %s wedged on request "
                    "%s; spawning replacement", self.name, holders,
                    req.id)
        self._ensure_worker()

    # ------------------------------------------------------ admission

    def submit(self, histories: Sequence, workload: str = "register",
               algorithm: str = "auto", deadline_ms: Optional[float] = None,
               priority: int = 0,
               consistency: str = "linearizable") -> CheckRequest:
        """Admit a submission; returns its CheckRequest (already DONE on
        a cache hit). Raises QueueFull with a retry-after estimate when
        the queue is at capacity, ValueError on malformed input (unknown
        workload/consistency included)."""
        req = admit(histories, workload, algorithm=algorithm,
                    deadline_ms=deadline_ms, priority=priority,
                    consistency=consistency)
        return self._admit(req)

    def submit_frame(self, payload) -> CheckRequest:
        """Admit a binary columnar submission frame (service/frame.py):
        the client ran `encode_history` locally, so
        admission decodes zero-copy tensor views, re-derives the
        fingerprint over the received bytes, and skips the encode. The
        WAL already persists ENCODINGS (journal.encode_submit), so the
        frame journals without any re-encode either. Error taxonomy
        matches `submit` (FrameError is a ValueError → 400)."""
        from .admission import admit_frame

        return self._admit(admit_frame(payload))

    def submit_run_dir(self, run_dir, algorithm: str = "auto",
                       deadline_ms: Optional[float] = None,
                       priority: int = 0,
                       workload: Optional[str] = None,
                       consistency: str = "linearizable") -> CheckRequest:
        """Admit a recorded-run directory (store/<name>/<ts>/)."""
        req = admit_run_dir(run_dir, algorithm=algorithm,
                            deadline_ms=deadline_ms, priority=priority,
                            workload=workload, consistency=consistency)
        return self._admit(req)

    def _admit(self, req: CheckRequest) -> CheckRequest:
        if self._stop.is_set():
            # Fast-path refusal; the authoritative (race-free) check is
            # the closed queue's own `put`, below.
            raise ServiceStopped(f"{self.name} is shut down")
        with self._lock:
            self._requests[req.id] = req
        cached = self.cache.get(req.fingerprint)
        if cached is not None and len(cached) == req.n_rows:
            req.cached = True
            req.finish(DONE, results=cached)
            self._count("submitted", "cache_hits", "completed")
            self._observe_latency(req)
            self._retire(req)
            self._write_trace(req)
            return req
        if self.cluster is not None:
            # Shared-store lookup: a fingerprint any replica already
            # verified completes here without a kernel launch — the
            # cross-replica cache hit. The LRU is warmed so repeats
            # skip the filesystem too.
            stored = self.cluster.store.get(req.fingerprint)
            if stored is not None and len(stored) == req.n_rows:
                self.cache.put(req.fingerprint, stored)
                req.cached = True
                req.finish(DONE, results=stored)
                self._count("submitted", "store_hits", "completed")
                self._observe_latency(req)
                self._retire(req)
                self._write_trace(req)
                return req
        retry_after = self._retry_after()
        reject: Optional[Exception] = None
        with self._lock:
            # Idempotent resubmission: a fingerprint that is
            # already queued/running ATTACHES to the live primary
            # instead of double-checking — the follower completes with
            # the primary's results at `_resolve_followers`. Register /
            # attach and queue-insert happen under ONE lock so a racing
            # duplicate cannot slip between the check and the insert
            # (queue.put's own lock nests safely: on_prune runs outside
            # the queue condition).
            # _journaled is marked BEFORE the request becomes visible
            # to workers: a request fast enough to finish before this
            # thread reaches append_submit below must still get its
            # terminal marker from _retire (replay joins submit and
            # terminal records by id, so their on-disk ORDER is free).
            if self._journal is not None:
                req._journaled = True
            primary = self._primary_by_fp.get(req.fingerprint)
            if primary is not None and not primary.terminal:
                req.attached_to = primary.id
                self._followers.setdefault(primary.id, []).append(req)
                self._stats["submitted"] += 1
                self._stats["attached_requests"] += 1
            else:
                self._primary_by_fp[req.fingerprint] = req
                try:
                    if self.cluster is not None \
                            and self.cluster.should_shed():
                        # past the shed threshold: shed to the cluster
                        # with its best retry-after instead of queueing
                        # into a backlog a peer could absorb now
                        raise QueueFull(self.queue.depth, retry_after)
                    self.queue.put(req, retry_after_s=retry_after)
                except (QueueFull, ServiceStopped) as e:
                    if isinstance(e, QueueFull):
                        self._stats["rejected"] += 1
                    del self._requests[req.id]
                    if self._primary_by_fp.get(req.fingerprint) is req:
                        del self._primary_by_fp[req.fingerprint]
                    reject = e
                else:
                    self._stats["submitted"] += 1
                    self._stats["max_queue_depth"] = max(
                        self._stats["max_queue_depth"], self.queue.depth)
        if reject is not None:
            if isinstance(reject, QueueFull) and self.cluster is not None:
                # A 429 from this replica carries the CLUSTER's best
                # retry-after (min over live leases), so the backed-off
                # client returns when the least-loaded peer has room.
                # Consulting the lease files happens HERE — only on the
                # reject path and outside the daemon lock — never per
                # accepted submission (O(replicas) file reads do not
                # belong on the admission hot path).
                raise QueueFull(
                    reject.depth,
                    self.cluster.best_retry_after(
                        reject.retry_after_s)) from None
            raise reject
        if self._journal is not None:
            # Durability point: the WAL record is fsync'd BEFORE the
            # 202 becomes visible to the client — an accepted request
            # survives SIGKILL from here on. Followers are journaled
            # too (each was individually promised a result).
            self._journal.append_submit(req)
        self._ensure_worker()
        return req

    def _retry_after(self) -> float:
        """Backpressure hint: pending work over observed service rate.
        Never below half a second — a zero would invite a hot retry
        loop from the very client the bound exists to absorb."""
        with self._lock:
            est = self._service_time_s
        return round(max(0.5, self.queue.depth * est), 2)

    # -------------------------------------------------------- queries

    def get(self, request_id: str) -> Optional[CheckRequest]:
        with self._lock:
            return self._requests.get(request_id)

    def cancel(self, request_id: str) -> Optional[str]:
        """Cancel a request: pulled straight out if still queued,
        honored at demux if already riding a launch. Returns the
        request's status, or None for an unknown id."""
        req = self.get(request_id)
        if req is None:
            return None
        req.cancelled.set()
        if self.queue.remove(req):
            if req.finish(CANCELLED):
                self._count("cancelled")
            self._retire(req)
            self._write_trace(req)
        elif req.attached_to is not None:
            # a follower is never in the queue; finalize it directly
            # (first-wins: a racing primary resolution may have beaten
            # the cancel, in which case the delivered result stands)
            if req.finish(CANCELLED):
                self._count("cancelled")
                self._retire(req)
                self._write_trace(req)
        return req.status

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["decided_tier"] = dict(self._tier_counts)
            lat = list(self._latencies)
        out["queue_depth"] = self.queue.depth
        out["cache_entries"] = len(self.cache)
        out["queue_capacity"] = self.queue.capacity
        out["batch_occupancy_mean"] = round(
            out["batched_requests"] / out["batches"], 3) \
            if out["batches"] else 0.0
        if lat:
            lat.sort()
            out["p50_latency_s"] = round(statistics.median(lat), 4)
            out["p99_latency_s"] = round(
                lat[min(len(lat) - 1, int(0.99 * len(lat)))], 4)
        worker = self._worker
        out["worker_alive"] = bool(worker is not None and worker.is_alive())
        out["workers"] = self.n_workers
        out["shard_loads"] = self.shards.snapshot()
        out["journal_enabled"] = self._journal is not None
        if self._journal is not None:
            out.update(self._journal.stats())
        out["cluster_enabled"] = self.cluster is not None
        if self.cluster is not None:
            out.update(self.cluster.stats())
        out.update(self.streams.stats())
        return out

    # ----------------------------------------------------- accounting

    def _count(self, *keys: str) -> None:
        with self._lock:
            for k in keys:
                if k in self._stats:
                    self._stats[k] += 1

    def _retire(self, req: CheckRequest) -> None:
        """Enter a terminal request into the bounded retention window;
        the oldest finished requests (and their histories/encodings)
        are dropped from the registry past JGRAFT_SERVICE_RETAIN —
        in-flight requests are never evicted (only terminal ids enter
        the window). Also the single terminal choke point for the
        durability tier: the journal's terminal marker is appended here
        (every finish path funnels through _retire), and attached
        followers are resolved with the primary's outcome."""
        with req._finish_lock:
            if getattr(req, "_retired", False):
                return
            req._retired = True
        if self._journal is not None and getattr(req, "_journaled", False):
            self._journal.append_terminal(req)
        self._resolve_followers(req)
        with self._lock:
            self._terminal.append(req.id)
            while len(self._terminal) > self._retain:
                self._requests.pop(self._terminal.popleft(), None)

    def _resolve_followers(self, req: CheckRequest) -> None:
        """Deliver a terminal primary's outcome to its attached
        idempotent duplicates. DONE/FAILED mirror onto every
        follower (one execution, many 202s — the at-most-once-execution
        half of idempotent resubmission). A CANCELLED primary must NOT
        cancel its followers (one tenant's cancel is not another's):
        the first live follower is promoted to primary and requeued,
        the rest re-attach to it."""
        with self._lock:
            followers = self._followers.pop(req.id, [])
            if self._primary_by_fp.get(req.fingerprint) is req:
                del self._primary_by_fp[req.fingerprint]
        if not followers:
            return
        if req.status == CANCELLED:
            live = [f for f in followers
                    if not f.terminal and not f.cancelled.is_set()]
            for f in followers:
                if f.cancelled.is_set() and f.finish(CANCELLED):
                    self._count("cancelled")
                    self._retire(f)
                    self._write_trace(f)
            if not live:
                return
            new_primary, rest = live[0], live[1:]
            new_primary.attached_to = None
            with self._lock:
                # setdefault: a fresh submission may have claimed the
                # fingerprint already; then the promoted follower just
                # runs as its own (solo-keyed) primary.
                self._primary_by_fp.setdefault(req.fingerprint,
                                               new_primary)
                for f in rest:
                    f.attached_to = new_primary.id
                    self._followers.setdefault(new_primary.id,
                                               []).append(f)
            self.queue.requeue([new_primary])
            return
        for f in followers:
            if req.status == DONE and req.results is not None:
                done = f.finish(DONE,
                                results=[dict(r) for r in req.results])
                if done:
                    self._count("completed")
                    self._observe_latency(f)
            else:
                if f.finish(FAILED, error=(
                        f"primary request {req.id} "
                        f"{req.status}: {req.error}")):
                    self._count("failed")
            self._retire(f)
            self._write_trace(f)

    def _observe_latency(self, req: CheckRequest) -> None:
        dt = time.monotonic() - req.submitted
        with self._lock:
            self._latencies.append(dt)
            # EWMA feeds the retry-after estimate; per-REQUEST time.
            self._service_time_s = 0.8 * self._service_time_s + 0.2 * dt

    def _account_batch(self, batch, info: dict) -> None:
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batch_rows"] += info["rows"]
            self._stats["batched_requests"] += info["requests"]
            if info["degraded"]:
                self._stats["degraded_batches"] += 1
            for tier, n in info.get("tiers", {}).items():
                self._tier_counts[tier] = \
                    self._tier_counts.get(tier, 0) + n
        self._account_requests(batch)

    def _account_requests(self, batch) -> None:
        for r in batch:
            if not r.terminal:
                # a watchdog-requeued twin of this batch is still
                # running; the copy that finishes will account for it
                continue
            with r._finish_lock:
                if getattr(r, "_accounted", False):
                    # the stale twin of a watchdog requeue demuxed
                    # after the fresh copy already counted this request
                    continue
                r._accounted = True
            if r.status == DONE:
                self._count("completed")
                self._observe_latency(r)
                if not r.stats.get("degraded") and not any(
                        "platform-degraded" in res for res in r.results):
                    # Cache only verdicts free of ANY degrade stamp,
                    # whichever path put it there: a cached stamp would
                    # replay onto a healed platform.
                    self.cache.put(r.fingerprint, r.results)
                    # publish fleet-wide: the store applies the same
                    # never-persist-degraded rule and is first-wins
                    # against a racing replica
                    if self.cluster is not None and \
                            self.cluster.store.put(r.fingerprint,
                                                   r.results):
                        self._count("store_puts")
            elif r.status == CANCELLED:
                self._count("cancelled")
            elif r.status == FAILED:
                self._count("failed")
            if r.status in (DONE, CANCELLED, FAILED):
                self._retire(r)

    def _finalize_pruned(self, req: CheckRequest) -> None:
        """Queue pruned a cancelled (or already-terminal, e.g. a stale
        watchdog twin) entry before it reached a batch."""
        if req.status not in (DONE, CANCELLED, FAILED):
            if req.finish(CANCELLED):
                self._count("cancelled")
            self._retire(req)
            self._write_trace(req)

    # ---------------------------------------------------------- trace

    def _write_trace(self, req: CheckRequest) -> None:
        """Persist one request's terminal record into the store layout
        (store/<service>/<ts>-<reqid>/: results.json + history.jsonl),
        browsable by `core/serve.py` next to test runs. Best-effort:
        trace IO must never fail a verdict (counted, logged)."""
        if self.store_root is None or req.status == QUEUED:
            return
        try:
            from ..core.store import _jsonable

            ts = time.strftime("%Y%m%dT%H%M%S", time.localtime())
            d = self.store_root / self.name / f"{ts}-{req.id}"
            d.mkdir(parents=True, exist_ok=True)
            payload = _jsonable(req.to_dict())
            # Temp-write + os.replace: core/serve.py can list the run
            # dir mid-write, so the publish must be atomic — a reader
            # never parses a torn results.json. No fsync, though: the
            # trace is best-effort (a power cut may lose it); the
            # authoritative terminal record is the store entry
            # _retire published, which store._publish fsyncs.
            tmp = d / "results.json.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2)
            os.replace(tmp, d / "results.json")
            tmp = d / "history.jsonl.tmp"
            with open(tmp, "w") as f:
                for label, hist in req.units:
                    for op in hist:
                        row = dict(op.to_dict(), unit=label)
                        row_line = json.dumps(_jsonable(row)) + "\n"
                        # best-effort trace: atomic via the replace
                        # below, durability deliberately not promised
                        f.write(row_line)  # lint: allow(fsync)
            os.replace(tmp, d / "history.jsonl")
        except OSError:
            self._count("trace_errors")
            LOG.warning("trace write failed for request %s", req.id,
                        exc_info=True)
