"""The measured gate of the lin fast path, in a host-fingerprinted store.

The port's share of the reference's checker/autotune.py: the
linearizable-rung pre-kernel certify pass (checker/linearizable
`lin_fastpath_pass`) has a measured worst case — a batch whose rows the
host certifier cannot decide pays the host scan AND the kernel — so per
(model family, event shape-bucket) this module accumulates hit-rate and
marginal-wall samples and `lin_fastpath_route` answers whether a bucket
tries the host certifier first or goes kernel-first. Beyond the
reference's hit-rate floor, the port's gate also weighs the two walls it
measures: certifying a row costs the certify wall per row and saves, on
a hit, the device's wall per row, so a bucket whose certify wall per row
exceeds hit rate × device wall per row goes kernel-first too. On the
card the device checks a north-star row in a fraction of what the host
certifier takes, which the hit rate alone cannot see (PERF.md §5).
Gating only ever affects ROUTING, never verdicts (undecided rows always
reach the kernels). With ``JGRAFT_AUTOTUNE=0`` the fast path always tries and
nothing is persisted (what the deterministic test environment pins).

Persistence: ``store/autotune/<host-fingerprint>/linfp-*.json``
(``JGRAFT_AUTOTUNE_STORE`` overrides the root); ``JGRAFT_LINFP_DIR``
names a gate directory shared by several processes. The fingerprint hashes the STABLE host identity —
cpu count, the device (the card's name and count, or "cpu"), the torch
and CUDA versions — so a host or toolchain change re-observes instead of
silently mis-gating.

The exact cycle tier's arm store (`cycle_arm_for`, `resolve_cycle_arm`)
keeps, per node bucket, the measured fastest of condensation, the host
DFS and the closure kernel, in the same store
(``cycle-arm-n<N>.json``). The launch-plan store (`tuned_group_plan`,
`tuned_sort_plan`) of the reference comes with the autotune item of the
ROADMAP.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Callable, Optional

from ..history.packing import bucket_rows
from ..platform import env_float, env_int, env_str

_log = logging.getLogger(__name__)

#: Default store root (gitignored alongside the test stores).
DEFAULT_STORE = "store/autotune"

_LOCK = threading.Lock()
_MISS = object()          # negative-cache sentinel (cycle_arm_for)
_COUNTERS = {"plans_loaded": 0, "plans_measured": 0, "plan_misses": 0}


def autotune_on() -> bool:
    """Whether plans are consulted/measured at all. Default ON; the
    measurement work-gates below keep small batches on the untuned
    path, so tiny runs behave exactly as before either way.
    JGRAFT_AUTOTUNE=0 restores today's behavior bit for bit. Parsed
    defensively (platform.env_int): garbage warns and keeps the
    default."""
    return env_int("JGRAFT_AUTOTUNE", 1, minimum=0) != 0


def sample_reps() -> int:
    """Timed reps per measured arm (after one untimed warm-up rep);
    JGRAFT_AUTOTUNE_SAMPLES, default 2."""
    return env_int("JGRAFT_AUTOTUNE_SAMPLES", 2, minimum=1)


def min_cells() -> int:
    """Work gate: a bucket's cells (for the cycle tier, N² × graphs)
    must reach this many before a measurement triggers
    (JGRAFT_AUTOTUNE_MIN_CELLS, default 2^16)."""
    return env_int("JGRAFT_AUTOTUNE_MIN_CELLS", 1 << 16, minimum=1)


def store_root() -> Path:
    """Store root; JGRAFT_AUTOTUNE_STORE overrides (defensively:
    a blank value keeps the default rather than writing to cwd)."""
    raw = os.environ.get("JGRAFT_AUTOTUNE_STORE", "")
    raw = raw.strip() if raw else ""
    return Path(raw) if raw else Path(DEFAULT_STORE)


# --------------------------------------------------------- fingerprint


def fingerprint_info() -> dict:
    """The STABLE host identity a gate record is valid for: cpu count,
    the device platform and count, the card's name, the torch and CUDA
    versions ("cpu" and torch's version without a card). Excludes load
    averages on purpose: a busy host should not fork the store."""
    info = {"cpu_count": os.cpu_count()}
    try:
        import torch

        info["torch"] = torch.__version__
        if torch.cuda.is_available():
            info["platform"] = "cuda"
            info["devices"] = torch.cuda.device_count()
            info["device_name"] = torch.cuda.get_device_name(0)
            info["cuda"] = torch.version.cuda
        else:
            info["platform"] = "cpu"
    except Exception:  # noqa: BLE001 — fingerprinting must never raise
        info["platform"] = "?"
    return info


def host_fingerprint() -> str:
    """Short stable hash of `fingerprint_info` — the store directory
    key. A host change lands in a different directory, so stale
    observations are never silently applied."""
    raw = json.dumps(fingerprint_info(), sort_keys=True)
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def consume_counters() -> dict:
    """Return and reset the store counters."""
    with _LOCK:
        out = dict(_COUNTERS)
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        return out


def _bump(key: str) -> None:
    with _LOCK:
        _COUNTERS[key] += 1


def reset_for_tests() -> None:
    """Drop the in-memory records and counters (tests simulate fresh
    processes)."""
    with _LOCK:
        _LINFP_MEM.clear()
        _CYCLE_MEM.clear()
        for k in _COUNTERS:
            _COUNTERS[k] = 0


def _fresh_record() -> dict:
    return {"rows": 0, "hits": 0, "certify_wall_s": 0.0}


# ------------------------------------------------ lin fast-path gating


#: lin-fastpath record schema version; unknown versions re-observe.
LINFP_VERSION = 1

#: sig -> {"rows", "hits", "certify_wall_s"}
_LINFP_MEM: dict = {}


def lin_fastpath_min_hit() -> float:
    """Hit-rate floor below which a measured bucket routes kernel-first
    (JGRAFT_LIN_FASTPATH_MIN_HIT, default 0.05 — the ~5% worst-case
    overhead bound the acceptance A/B pins; defensive parse)."""
    return env_float("JGRAFT_LIN_FASTPATH_MIN_HIT", 0.05, minimum=0.0)


def lin_fastpath_min_obs() -> int:
    """Rows a bucket must have been observed over before the hit-rate
    gate may route it kernel-first (JGRAFT_LIN_FASTPATH_MIN_OBS,
    default 64): trying IS measuring, so unknown buckets always try."""
    return env_int("JGRAFT_LIN_FASTPATH_MIN_OBS", 64, minimum=1)


def lin_fastpath_sig(family: str, n_events: int) -> tuple:
    """Gating bucket: model family plus the pow2+midpoint event bucket
    (the same floor-32 series the launch shapes pad to). Window/state
    shape is deliberately absent — certify cost scales with E·W but the
    hit-rate is a property of the WORKLOAD family, and fragmenting the
    observations per window would starve the gate of samples."""
    return ("linfp", str(family), bucket_rows(max(int(n_events), 1), 32))


def _linfp_path(sig: tuple) -> Path:
    return store_root() / host_fingerprint() / \
        f"linfp-{sig[1]}-e{sig[2]}.json"


def linfp_shared_dir() -> Optional[Path]:
    """Shared gate-store directory: when JGRAFT_LINFP_DIR names a
    directory every process can reach, lin-fastpath gate records
    replicate through ``<dir>/linfp/``, so a fresh process routes off
    the published observations instead of re-observing. Unset → None
    (gating stays host-local)."""
    raw = env_str("JGRAFT_LINFP_DIR", "").strip()
    if not raw:
        return None
    return Path(raw) / "linfp"


def _linfp_shared_path(sig: tuple) -> Optional[Path]:
    d = linfp_shared_dir()
    if d is None:
        return None
    return d / f"linfp-{sig[1]}-e{sig[2]}.json"


def _load_linfp(path: Path, sig: tuple, require_host: bool) -> \
        Optional[dict]:
    """Parse one gate record, or None. Shared records skip the
    host-fingerprint check: the hit-RATE the gate routes on is a
    property of the workload family, not the host — while host-local
    records keep the strict check so a toolchain swap re-observes. Keys
    the gate does not read (an older record's device wall) are
    ignored."""
    try:
        raw = json.loads(path.read_text())
        if (raw.get("version") == LINFP_VERSION
                and raw.get("signature") == list(sig)
                and (not require_host
                     or raw.get("fingerprint") == host_fingerprint())):
            return {"rows": int(raw["rows"]), "hits": int(raw["hits"]),
                    "certify_wall_s": float(raw["certify_wall_s"])}
        _log.warning("autotune: stale lin-fastpath record %s — "
                     "re-observing", path)
    except FileNotFoundError:
        pass
    except (OSError, json.JSONDecodeError, UnicodeDecodeError,
            KeyError, TypeError, ValueError) as e:
        _log.warning("autotune: unreadable lin-fastpath record %s "
                     "(%s: %s) — re-observing", path, type(e).__name__, e)
    return None


def _linfp_record(sig: tuple) -> dict:
    """The bucket's in-memory record, seeded on first touch from the
    fingerprint store — or, when the local file is absent/stale, from
    the shared gate dir, which is how a fresh process inherits the
    shared gate history instead of paying min_obs rows of
    re-observation. Corrupt/stale/foreign files mean 'start fresh,
    never silently mis-gate' — same stance as `plan_for`."""
    with _LOCK:
        rec = _LINFP_MEM.get(sig)
        if rec is not None:
            return rec
    fresh = _load_linfp(_linfp_path(sig), sig, require_host=True)
    if fresh is None:
        shared = _linfp_shared_path(sig)
        if shared is not None:
            fresh = _load_linfp(shared, sig, require_host=False)
    if fresh is None:
        fresh = _fresh_record()
    with _LOCK:
        rec = _LINFP_MEM.setdefault(sig, fresh)
    return rec


def lin_fastpath_route(sig: tuple) -> bool:
    """True → run the host certifier first for this bucket; False →
    the measured hit-rate says kernel-first. Routing only: a gated
    bucket's rows take the ordinary kernel ladder unchanged."""
    if not autotune_on():
        return True
    rec = _linfp_record(sig)
    with _LOCK:
        rows, hits = rec["rows"], rec["hits"]
    if rows < lin_fastpath_min_obs():
        return True
    return hits / rows >= lin_fastpath_min_hit()


def lin_fastpath_observe(sig: tuple, rows: int, hits: int,
                         wall_s: float) -> None:
    """Fold one batch's certify outcome into the bucket's record and
    persist it (atomic tmp+rename, best-effort — a read-only store
    degrades gating to in-memory, never checking)."""
    if rows <= 0 or not autotune_on():
        return
    rec = _linfp_record(sig)
    with _LOCK:
        rec["rows"] += int(rows)
        rec["hits"] += int(hits)
        rec["certify_wall_s"] += float(wall_s)
    _persist(sig, rec)


def _persist(sig: tuple, rec: dict) -> None:
    with _LOCK:
        payload = {
            "version": LINFP_VERSION,
            "fingerprint": host_fingerprint(),
            "fingerprint_info": fingerprint_info(),
            "signature": list(sig),
            "rows": rec["rows"],
            "hits": rec["hits"],
            "certify_wall_s": round(rec["certify_wall_s"], 6),
            # the marginal-wall sample an operator reads the gate by
            "certify_wall_per_row_s": round(
                rec["certify_wall_s"] / max(rec["rows"], 1), 6),
            "hit_rate": round(rec["hits"] / max(rec["rows"], 1), 4),
            "updated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
        }
    # publish locally AND (when configured) into the shared gate dir,
    # so sibling processes inherit the observation. Shared writes race
    # last-writer-wins across processes; each writer's record carries a
    # complete, internally consistent observation history, so whichever
    # lands is a valid gate input (per-pid tmp names keep the renames
    # atomic and non-colliding).
    targets = [_linfp_path(sig)]
    shared = _linfp_shared_path(sig)
    if shared is not None:
        targets.append(shared)
    for path in targets:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(json.dumps(payload, indent=2))
            os.replace(tmp, path)
        except OSError as e:
            _log.warning("autotune: could not persist lin-fastpath "
                         "record %s (%s: %s)", path, type(e).__name__, e)


# ------------------------------------------------- cycle-tier arm store
# The exact cycle tier has two routing dimensions per node bucket —
# condense-vs-direct (host Tarjan pre-pass or straight to the detector)
# and kernel-vs-DFS (batched closure launch or host 3-color DFS) — so
# the choice is measured per bucket, as the reference does: a
# fingerprint-keyed JSON record, version/signature checks, an in-memory
# negative cache, interleaved rotated best-of-min measurement. Arm
# choice is ROUTING ONLY — every arm is verdict-identical, so a stale or
# foreign record can only cost time, never answers.

#: cycle-arm record schema version; unknown versions re-measure.
CYCLE_ARM_VERSION = 1

#: Measurable arms, in deterministic measurement order: "condense" =
#: host Tarjan SCC pre-pass (detection IS the pre-pass), "dfs" = direct
#: host 3-color DFS, "kernel" = direct batched closure launch.
CYCLE_ARMS = ("condense", "dfs", "kernel")

_CYCLE_MEM: dict = {}   # sig -> arm str | _MISS


def cycle_arm_sig(n_bucket: int) -> tuple:
    """Arm bucket: the pow2+midpoint node bucket alone. The arm
    tradeoff is a property of graph size and host-vs-device matmul
    cost, not of the model family — fragmenting per family would
    starve small buckets of measurements."""
    return ("cycle-arm", int(n_bucket))


def _cycle_arm_path(sig: tuple) -> Path:
    return store_root() / host_fingerprint() / f"cycle-arm-n{sig[1]}.json"


def cycle_arm_for(sig: tuple) -> Optional[str]:
    """The bucket's measured arm: memory, then the fingerprint store.
    Corrupt/stale/foreign records return None (re-measure, never
    silently mis-route); misses are negative-cached so per-batch
    consults stay disk-free."""
    with _LOCK:
        arm = _CYCLE_MEM.get(sig)
    if arm is _MISS:
        return None
    if arm is not None:
        _bump("plans_loaded")
        return arm
    path = _cycle_arm_path(sig)
    try:
        raw = json.loads(path.read_text())
    except FileNotFoundError:
        return _cycle_miss(sig)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        _log.warning("autotune: unreadable cycle-arm record %s (%s: %s)"
                     " — re-measuring", path, type(e).__name__, e)
        return _cycle_miss(sig)
    arm = raw.get("arm")
    if (raw.get("version") != CYCLE_ARM_VERSION
            or raw.get("fingerprint") != host_fingerprint()
            or raw.get("signature") != list(sig)
            or arm not in CYCLE_ARMS):
        _log.warning("autotune: stale/corrupt cycle-arm record %s — "
                     "re-measuring", path)
        return _cycle_miss(sig)
    with _LOCK:
        _CYCLE_MEM[sig] = arm
    _bump("plans_loaded")
    return arm


def _cycle_miss(sig: tuple):
    with _LOCK:
        _CYCLE_MEM[sig] = _MISS
        _COUNTERS["plan_misses"] += 1
    return None


def save_cycle_arm(sig: tuple, arm: str, samples: dict) -> None:
    """Persist a measured arm (atomic tmp+rename; persistence failures
    warn and keep the in-memory arm)."""
    with _LOCK:
        _CYCLE_MEM[sig] = arm
    path = _cycle_arm_path(sig)
    payload = {
        "version": CYCLE_ARM_VERSION,
        "fingerprint": host_fingerprint(),
        "fingerprint_info": fingerprint_info(),
        "signature": list(sig),
        "arm": arm,
        "samples": samples,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(payload, indent=2))
        os.replace(tmp, path)
    except OSError as e:
        _log.warning("autotune: could not persist cycle-arm record %s "
                     "(%s: %s)", path, type(e).__name__, e)


def resolve_cycle_arm(sig: tuple,
                      measures: "dict[str, Callable[[], float]]") -> str:
    """Measure the available arms interleaved (one untimed warm-up rep
    each absorbs kernel builds, then `sample_reps` rounds with rotating
    order), pick best-of-min, persist, return. `measures` maps arm name
    → zero-arg wall-seconds measurement over the SAME batch of graphs
    (every arm is verdict-identical)."""
    arms = [a for a in CYCLE_ARMS if a in measures]
    times: dict = {a: [] for a in arms}
    for a in arms:
        measures[a]()
    reps = sample_reps()
    for rep in range(reps):
        order = arms[rep % len(arms):] + arms[:rep % len(arms)]
        for a in order:
            times[a].append(measures[a]())
    best = min(arms, key=lambda a: min(times[a]))
    samples = {a: [round(t, 6) for t in ts] for a, ts in times.items()}
    save_cycle_arm(sig, best, samples)
    _bump("plans_measured")
    return best
