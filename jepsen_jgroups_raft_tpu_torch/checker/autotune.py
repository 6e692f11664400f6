"""Per-shape-bucket autotuner: launch plans, the lin fast path's gate
and the cycle tier's arms, in one host-fingerprinted store.

The port of the reference's checker/autotune.py.

Launch plans. Every tuning knob of a wavefront launch is a global
default (`JGRAFT_SCAN_CHUNK`, the macro payload cap) although the right
value is a per-shape decision, so the plan store picks ``{family,
scan_chunk, macro_p, mesh_fanout}`` per SHAPE BUCKET (`bucket_signature`)
from short measured in-process samples and persists the winner, so a
later process loads instead of re-measuring. `tuned_group_plan` answers
for a dense window group and `tuned_sort_plan` for a rung of the sort
ladder (checker/linearizable.py asks both, as the reference's
`_jax_pass` does); `pack_group` applies a plan's macro cap at pack time
and `schedule.build_dense_launches` its chunk. Every candidate is sampled
interleaved (the order rotating each rep), with one untimed warm-up rep
that absorbs a kernel's first load, on up to `sample_rows_cap` rows of
the actual group, through the very launch path the plan will drive
(`schedule.run_chunked` with ``record_stats=False``, timed by
`time.perf_counter` around a run that ends in a flag read, so the card's
work is inside the window). One process launches on one card and the
port has no mesh placement, so `mesh_fanout` is always 1 (the reference
at a single device). Every candidate is a launch shape of the same
kernels, so verdicts are identical tuned or not. A sample runs on the
check's own device (`device`).

The lin fast path's gate. The linearizable-rung pre-kernel certify pass
(checker/linearizable `lin_fastpath_pass`) has a measured worst case — a
batch whose rows the host certifier cannot decide pays the host scan AND
the kernel — so per (model family, event shape-bucket) this module
accumulates hit-rate and marginal-wall samples and `lin_fastpath_route`
answers whether a bucket tries the host certifier first or goes
kernel-first. Beyond the reference's hit-rate floor, the port's gate
also weighs the two walls it measures: certifying a row costs the
certify wall per row and saves, on a hit, the device's wall per row, so
a bucket whose certify wall per row exceeds hit rate × device wall per
row goes kernel-first too. On the card the device checks a north-star
row in a fraction of what the host certifier takes, which the hit rate
alone cannot see (PERF.md §5). Gating only ever affects ROUTING, never
verdicts (undecided rows always reach the kernels).

The exact cycle tier's arm store (`cycle_arm_for`, `resolve_cycle_arm`)
keeps, per node bucket, the measured fastest of condensation, the host
DFS and the closure kernel.

With ``JGRAFT_AUTOTUNE=0`` nothing is consulted, measured or persisted:
no plan applies, the fast path always tries (what the deterministic test
environment pins).

Persistence: ``store/autotune/<host-fingerprint>/`` holds
``<family>-w<W>-s<S>-b<rows>-e<events>-m<macro>.json`` plans,
``linfp-*.json`` gate records and ``cycle-arm-n<N>.json`` arms, in the
reference's file names and JSON schemas (``JGRAFT_AUTOTUNE_STORE``
overrides the root; ``JGRAFT_LINFP_DIR`` names a gate directory shared
by several processes). The fingerprint hashes the STABLE host identity —
cpu count, the device (the card's name and count, or "cpu"), the torch
and CUDA versions — so a plan measured on one card never loads on
another, and a stale or foreign fingerprint, a corrupt file or an
unknown schema version all mean "re-measure, never silently mis-tune".
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..history.packing import (MACRO_MAX_OPENS, bucket_rows,
                               macro_events_on, pack_batch,
                               pack_macro_batch)
from ..platform import env_float, env_int, env_str

_log = logging.getLogger(__name__)

#: Plan-file schema version; unknown versions are re-measured.
PLAN_VERSION = 1

#: Default store root (gitignored alongside the test stores).
DEFAULT_STORE = "store/autotune"

_LOCK = threading.Lock()
_MISS = object()           # negative-cache sentinel (plan_for, cycle_arm_for)
_MEM: dict = {}            # sig -> TunedPlan | _MISS (this process)
_APPLIED: List[dict] = []  # bounded log of applied plans
_APPLIED_SEQ = 0           # monotone id of the last applied entry
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
    """Timed reps per candidate or arm (after one untimed warm-up rep);
    JGRAFT_AUTOTUNE_SAMPLES, default 2. More reps harden the pick
    against host jitter at measurement cost."""
    return env_int("JGRAFT_AUTOTUNE_SAMPLES", 2, minimum=1)


def min_rows() -> int:
    """Work gate: groups with fewer rows than this never trigger a
    measurement (loading a persisted plan is always allowed) — the
    sample cost cannot amortize (JGRAFT_AUTOTUNE_MIN_ROWS, default
    64)."""
    return env_int("JGRAFT_AUTOTUNE_MIN_ROWS", 64, minimum=1)


def min_cells() -> int:
    """Second work gate: a bucket's cells (rows × events for a launch
    plan, N² × graphs for the cycle tier) must reach this many before a
    measurement triggers (JGRAFT_AUTOTUNE_MIN_CELLS, default 2^16)."""
    return env_int("JGRAFT_AUTOTUNE_MIN_CELLS", 1 << 16, minimum=1)


def sample_rows_cap() -> int:
    """Rows per candidate sample run (JGRAFT_AUTOTUNE_SAMPLE_ROWS,
    default 64): enough rows that the sample keeps the launch shape the
    plan will drive."""
    return env_int("JGRAFT_AUTOTUNE_SAMPLE_ROWS", 64, minimum=1)


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


# ---------------------------------------------------------------- plans


@dataclass(frozen=True)
class TunedPlan:
    """One bucket's execution plan.

    family:      kernel family tag the plan was measured for ("dense",
                 "dense-mask", "sort") — recorded for reporting and as
                 a guard: a plan never applies across families.
    scan_chunk:  chunk size for the wavefront launch; 0 = one
                 whole-schedule span (the one-shot shape, still on the
                 wavefront driver).
    macro_p:     macro payload cap for pack_macro_batch; 0 = the legacy
                 one-event-per-step stream.
    mesh_fanout: devices the launch fans out over; always 1 in the port
                 (one process launches on one card).
    """

    family: str
    scan_chunk: int
    macro_p: int
    mesh_fanout: int


def default_plan(family: str) -> TunedPlan:
    """Today's global defaults, as a plan — the baseline candidate
    every measurement must beat."""
    from .schedule import scan_chunk

    return TunedPlan(family=family, scan_chunk=scan_chunk(),
                     macro_p=MACRO_MAX_OPENS if macro_events_on() else 0,
                     mesh_fanout=1)


def bucket_signature(family: str, n_slots: int, n_states: int,
                     n_rows: int, n_events: int) -> tuple:
    """The shape bucket a plan is keyed by: kernel family, exact
    window/state shape (they pick the kernel instance), the
    pow2+midpoint row/event buckets (they pick the launch shape), and
    the macro-stream mode: plans measured under the macro stream never
    leak into a JGRAFT_MACRO_EVENTS=0 run."""
    return (family, int(n_slots), int(n_states),
            bucket_rows(max(int(n_rows), 1)),
            bucket_rows(max(int(n_events), 1), 32),
            int(macro_events_on()))


def _sig_name(sig: tuple) -> str:
    fam, w, s, b, e, macro = sig
    return f"{fam}-w{w}-s{s}-b{b}-e{e}-m{macro}.json"


# ------------------------------------------------------ store + counters


def snapshot_counters() -> dict:
    with _LOCK:
        return dict(_COUNTERS)


def consume_counters() -> dict:
    """Return and reset the store counters."""
    with _LOCK:
        out = dict(_COUNTERS)
        for k in _COUNTERS:
            _COUNTERS[k] = 0
        return out


def applied_log() -> List[dict]:
    """Bounded log of {seq, signature, plan, source} entries, in
    application order (the recording thread id stays internal)."""
    with _LOCK:
        return [{k: v for k, v in e.items() if k != "thread"}
                for e in _APPLIED]


def applied_seq() -> int:
    """Monotone id of the most recent applied-plan entry. A caller
    attributing plans to a span snapshots this BEFORE the work and reads
    `applied_since` after (slicing the bounded log by length would break
    once trimming starts)."""
    with _LOCK:
        return _APPLIED_SEQ


def applied_since(seq: int, thread_id: Optional[int] = None) -> List[dict]:
    """Entries applied after `seq` that are still inside the bounded
    log; `thread_id` restricts to plans applied by that thread."""
    with _LOCK:
        return [{k: v for k, v in e.items() if k != "thread"}
                for e in _APPLIED
                if e["seq"] > seq
                and (thread_id is None or e.get("thread") == thread_id)]


def _record_applied(sig: tuple, plan: TunedPlan, source: str) -> None:
    global _APPLIED_SEQ
    with _LOCK:
        _APPLIED_SEQ += 1
        _APPLIED.append({"seq": _APPLIED_SEQ, "signature": list(sig),
                         "plan": asdict(plan), "source": source,
                         "thread": threading.get_ident()})
        del _APPLIED[:-256]


def _bump(key: str) -> None:
    with _LOCK:
        _COUNTERS[key] += 1


def reset_for_tests() -> None:
    """Drop the in-memory plans, records, applied log and counters (a
    fresh process; the store on disk stays)."""
    with _LOCK:
        _MEM.clear()
        _APPLIED.clear()
        _LINFP_MEM.clear()
        _CYCLE_MEM.clear()
        for k in _COUNTERS:
            _COUNTERS[k] = 0


def _plan_path(sig: tuple) -> Path:
    return store_root() / host_fingerprint() / _sig_name(sig)


def plan_for(sig: tuple) -> Optional[TunedPlan]:
    """Look a bucket's plan up: in-memory first, then the fingerprint
    directory on disk. Corrupt files, schema drift and a fingerprint
    mismatch (plan files copied across hosts) all return None —
    re-measure, never silently mis-tune. Misses are negative-cached in
    memory, so per-group consults of a below-gate bucket stay
    disk-free; `save_plan` replaces the sentinel when this process
    measures."""
    with _LOCK:
        plan = _MEM.get(sig)
    if plan is _MISS:
        return None
    if plan is not None:
        _bump("plans_loaded")
        _record_applied(sig, plan, "memory")
        return plan
    path = _plan_path(sig)
    try:
        raw = json.loads(path.read_text())
    except FileNotFoundError:
        return _miss(sig)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        _log.warning("autotune: unreadable plan %s (%s: %s) — "
                     "re-measuring", path, type(e).__name__, e)
        return _miss(sig)
    try:
        if raw.get("version") != PLAN_VERSION:
            raise ValueError(f"schema version {raw.get('version')!r}")
        if raw.get("fingerprint") != host_fingerprint():
            raise ValueError("host fingerprint mismatch")
        if raw.get("signature") != list(sig):
            raise ValueError("bucket signature mismatch")
        plan = TunedPlan(**{k: raw["plan"][k] for k in
                            ("family", "scan_chunk", "macro_p",
                             "mesh_fanout")})
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        _log.warning("autotune: stale/corrupt plan %s (%s: %s) — "
                     "re-measuring", path, type(e).__name__, e)
        return _miss(sig)
    with _LOCK:
        _MEM[sig] = plan
    _bump("plans_loaded")
    _record_applied(sig, plan, "disk")
    return plan


def _miss(sig: tuple):
    with _LOCK:
        _MEM[sig] = _MISS
        _COUNTERS["plan_misses"] += 1
    return None


def save_plan(sig: tuple, plan: TunedPlan, samples: dict) -> None:
    """Persist a measured plan (atomic tmp+rename; persistence failures
    warn and keep the in-memory plan — a read-only store must not break
    checking)."""
    with _LOCK:
        _MEM[sig] = plan
    path = _plan_path(sig)
    payload = {
        "version": PLAN_VERSION,
        "fingerprint": host_fingerprint(),
        "fingerprint_info": fingerprint_info(),
        "signature": list(sig),
        "plan": asdict(plan),
        "samples": samples,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2))
        os.replace(tmp, path)
    except OSError as e:
        _log.warning("autotune: could not persist plan %s (%s: %s)",
                     path, type(e).__name__, e)


# ----------------------------------------------------------- measurement


def resolve_plan(sig: tuple, candidates: Sequence[TunedPlan],
                 measure: Callable[[TunedPlan], float]) -> TunedPlan:
    """Measure `candidates` interleaved (one untimed warm-up rep per
    candidate absorbs a kernel's first load, then `sample_reps` timed
    rounds with the candidate order rotating so slow host drift cancels
    instead of biasing one candidate), pick the best-of-min, persist,
    and return. The caller has already missed `plan_for`."""
    times: dict = {c: [] for c in candidates}
    for c in candidates:
        measure(c)
    reps = sample_reps()
    for rep in range(reps):
        order = list(candidates)[rep % len(candidates):] + \
            list(candidates)[:rep % len(candidates)]
        for c in order:
            times[c].append(measure(c))
    best = min(candidates, key=lambda c: min(times[c]))
    samples = {json.dumps(asdict(c)): [round(t, 5) for t in ts]
               for c, ts in times.items()}
    save_plan(sig, best, samples)
    _bump("plans_measured")
    _record_applied(sig, best, "measured")
    return best


def pack_group(encs: Sequence, tuned: Optional[TunedPlan]) -> dict:
    """Pack one group's encodings under a plan's macro payload cap —
    or under today's defaults when no plan applies (tuned None). The
    JGRAFT_MACRO_EVENTS=0 ablation is absolute: a persisted macro plan
    never re-enables the macro stream under it."""
    if not macro_events_on():
        return pack_batch(encs)
    if tuned is None:
        return pack_macro_batch(encs)
    if tuned.macro_p <= 0:
        return pack_batch(encs)
    return pack_macro_batch(encs, cap=tuned.macro_p)


def _chunk_candidates(default_chunk: int, e_sched: int) -> List[int]:
    """Chunk sizes worth sampling for a schedule of `e_sched` events:
    the global default, its double, and 0 (one whole-schedule span).
    Values ≥ the schedule collapse into 0's shape and are dropped."""
    cands = [default_chunk, default_chunk * 2, 0]
    out: List[int] = []
    for c in cands:
        if c >= max(e_sched, 1):
            c = 0
        if c not in out:
            out.append(c)
    return out


def _fanout_candidates() -> List[int]:
    """Fan-out widths worth sampling: one card, the only width a process
    of the port launches at."""
    return [1]


def _macro_candidates() -> List[int]:
    """Macro payload caps worth sampling: the default cap and a narrow
    one (more rows, narrower ones); the legacy stream alone under
    JGRAFT_MACRO_EVENTS=0."""
    if not macro_events_on():
        return [0]
    return [MACRO_MAX_OPENS, 4]


def _star_candidates(base: TunedPlan, e_sched: int) -> List[TunedPlan]:
    """The candidate grid, kept small: the chunk ladder, the fan-out
    ladder and the macro ladder, each around `base` (a star, not the
    cross product)."""
    out: List[TunedPlan] = [base]

    def add(**kw):
        c = TunedPlan(**{**asdict(base), **kw})
        if c not in out:
            out.append(c)

    for chunk in _chunk_candidates(base.scan_chunk or 128, e_sched):
        add(scan_chunk=chunk)
    for fan in _fanout_candidates():
        add(mesh_fanout=fan)
    for p in _macro_candidates():
        add(macro_p=p)
    return out


def _coordinate_candidates(family: str, e_sched: int) -> List[TunedPlan]:
    """A dense group's candidates: the star around `default_plan`."""
    return _star_candidates(default_plan(family), e_sched)


def tuned_group_plan(model, plan, encs: Sequence, *,
                     device=None) -> Optional[TunedPlan]:
    """Consult (and, for large-enough groups, measure) the plan for one
    dense window group. `plan` is the group's ops.dense_scan.DensePlan;
    `encs` the group's encodings in plan row order; `device` the
    check's device, where the samples run. Returns None — today's exact
    behavior — when autotuning is off, the group is LONG (past
    MERGE_MAX_EVENTS events: its exact-row launch ignores plans), or
    the group is below the work gates with no persisted plan."""
    if not autotune_on() or not encs:
        return None
    from ..ops.dense_scan import MERGE_MAX_EVENTS

    e_max = max(e.n_events for e in encs)
    if e_max > MERGE_MAX_EVENTS:
        return None
    sig = bucket_signature(plan.kernel_tag, plan.n_slots, plan.n_states,
                           len(encs), e_max)
    found = plan_for(sig)
    if found is not None:
        return found
    if len(encs) < min_rows() or len(encs) * e_max < min_cells():
        return None
    k = min(len(encs), sample_rows_cap())
    sample = list(encs[:k])
    val_of = np.asarray(plan.val_of[:k])
    e_sched = bucket_rows(e_max, 32)

    def measure(cand: TunedPlan) -> float:
        return _run_dense_sample(model, plan, sample, val_of, cand,
                                 device=device)

    candidates = _coordinate_candidates(plan.kernel_tag, e_sched)
    return resolve_plan(sig, candidates, measure)


def _run_dense_sample(model, plan, sample: Sequence, val_of: np.ndarray,
                      cand: TunedPlan, *, device=None) -> float:
    """One timed sample run of a dense group candidate, through the
    launch path the plan will drive (run_chunked, stats suppressed),
    on `device`."""
    from ..ops.dense_scan import make_dense_chunk_checker
    from .schedule import ChunkLaunch, run_chunked

    batch = pack_group(sample, cand)
    e_sched = bucket_rows(batch["events"].shape[1], 32)
    init_fn, step_fn = make_dense_chunk_checker(
        model, plan.kind, plan.n_slots, plan.n_states,
        macro_p=batch.get("macro_p"))
    chunk = cand.scan_chunk or max(e_sched, 1)
    launch = ChunkLaunch(
        events=batch["events"], n_events=batch["n_events"],
        init_fn=init_fn, step_fn=step_fn, val_of=val_of,
        e_sched=e_sched, device=device, tag="autotune-sample",
        chunk=chunk)
    t0 = time.perf_counter()
    run_chunked([launch], chunk=chunk, record_stats=False)
    return time.perf_counter() - t0


def tuned_sort_plan(model, encs: Sequence, n_configs: int, n_slots: int,
                    *, device=None) -> Optional[TunedPlan]:
    """Sort-ladder twin of `tuned_group_plan` for one capacity rung; the
    rung's frontier capacity rides the signature's state slot (it picks
    the kernel instance exactly like S does for the dense family)."""
    if not autotune_on() or not encs:
        return None
    e_max = max(e.n_events for e in encs)
    sig = bucket_signature("sort", n_slots, n_configs, len(encs), e_max)
    found = plan_for(sig)
    if found is not None:
        return found
    if len(encs) < min_rows() or len(encs) * e_max < min_cells():
        return None
    sample = list(encs[:min(len(encs), sample_rows_cap())])

    def measure(cand: TunedPlan) -> float:
        return _run_sort_sample(model, n_configs, n_slots, sample, cand,
                                device=device)

    return resolve_plan(sig, _star_candidates(default_plan("sort"),
                                              bucket_rows(e_max, 32)),
                        measure)


def sort_rung_sharding(tuned: Optional[TunedPlan]):
    """The sort rung's launch placement under a plan: always None (the
    rung's own device), since the port does not fan a launch out over
    several cards."""
    return None


def _run_sort_sample(model, n_configs: int, n_slots: int,
                     sample: Sequence, cand: TunedPlan, *,
                     device=None) -> float:
    from ..ops.linear_scan import make_sort_chunk_checker
    from .schedule import ChunkLaunch, run_chunked

    batch = pack_group(sample, cand)
    e_sched = bucket_rows(batch["events"].shape[1], 32)
    init_fn, step_fn = make_sort_chunk_checker(
        model, n_configs, n_slots, macro_p=batch.get("macro_p"))
    chunk = cand.scan_chunk or max(e_sched, 1)
    launch = ChunkLaunch(
        events=batch["events"], n_events=batch["n_events"],
        init_fn=init_fn, step_fn=step_fn, e_sched=e_sched,
        device=device, tag="autotune-sample", chunk=chunk)
    t0 = time.perf_counter()
    run_chunked([launch], chunk=chunk, record_stats=False)
    return time.perf_counter() - t0


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
