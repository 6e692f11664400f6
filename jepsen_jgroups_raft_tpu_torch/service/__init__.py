"""graftd on the card: the multi-tenant checking service of the port.

The reference's `service/` package: an always-on daemon that coalesces
many tenants' submissions into one `check_encoded` batch on the card
(the chunked wavefront over the dense, mask and sort kernels),
demultiplexes the verdicts back to each request by row count, and
streams a history append by append through the carried sort scan; N
daemons sharing one cluster directory behave as one service.

* request.py   — admission-time normalization: encode once, fingerprint
                 the packed tensors (byte-identical to the reference's
                 fingerprints), per-key split for independent workloads.
* frame.py     — the binary columnar frames (byte-identical to the
                 reference's); the server always re-derives the
                 fingerprint, so a lying client corrupts only its own
                 verdict.
* admission.py — bounded queue with reject-with-retry-after
                 backpressure + the LRU result cache.
* journal.py   — write-ahead admission journal: fsync'd submit records
                 before the 202, terminal markers, bounded compaction,
                 loud torn-tail replay, the streams' segment records.
* scheduler.py — cross-request shape-bucket batching over
                 `checker.linearizable.check_encoded` on the service's
                 device, deadline/aging ordering, the fast lane,
                 per-request cancellation, the degrade arm.
* stream.py    — streaming verdict sessions: incremental encoding, the
                 resumable certifier and the carried sort scan per
                 append, journaled and resumable.
* daemon.py    — CheckingService: supervised worker and shard
                 executors, crash recovery, poison-batch quarantine,
                 hung-batch watchdog, stats, trace records.
* http.py      — stdlib HTTP+JSON front (make_server / serve_checker /
                 serve_in_thread).
* client.py    — ServiceClient: idempotent retry with backoff, keep-
                 alive, binary frames, stream sessions, cluster routing
                 (affinity-first, least-loaded fallback, cluster-global
                 attempt cap).
* store.py     — shared content-addressed result store: fingerprint →
                 verdict entries any replica reads and writes atomically
                 (the reference's bytes); per-row detail records for the
                 distributed wavefront's detail exchange.
* cluster.py   — replica membership leases, load shedding with the
                 cluster's best retry-after, and cross-replica journal
                 handoff (claim-by-rename, replay, re-own).

Every check runs on the card unless the service is built with
``device="cpu"`` (the kernels' plain versions on the host).
"""

from .admission import QueueFull, ServiceStopped  # noqa: F401
from .client import ServiceClient, ServiceError  # noqa: F401
from .cluster import ClusterManager, discover_replica_urls  # noqa: F401
from .client import StreamSession as ClientStreamSession  # noqa: F401
from .daemon import CheckingService  # noqa: F401
from .http import make_server, serve_checker, serve_in_thread  # noqa: F401
from .journal import AdmissionJournal, journal_enabled  # noqa: F401
from .request import CheckRequest  # noqa: F401
from .store import ResultStore  # noqa: F401
from .stream import StreamBusy, StreamConflict, StreamManager  # noqa: F401
