"""Linearizability checker of the port: the north-star check on the card.

Equivalent of the reference's checker/linearizable.py, in the
reference's order; the weaker rungs ("sequential", "session") re-enter
the linearizable rung on relaxed encodings (`check_encoded`).
Histories are encoded on the host; at the default knobs the lin fast
path (`lin_fastpath_pass`: the host witness certifier, gated per bucket
by `checker/autotune`) decides the rows it can certify first, and only
the rest reach the device. There, histories of at least LONG_HISTORY_MIN_EVENTS events may
take the segmented scan (`ops.segment_scan.check_segmented_batch`, the
CUDA kernel ops/csrc/segment_scan.cu; rows report ``"kernel":
"dense-seg"`` and their ``"segments"``), the others are macro-packed,
grouped by kernel kind and concurrency window
(`ops.dense_scan.dense_plans_grouped`), and every window group runs a
hand-written CUDA kernel: the dense-domain scan (`ops.dense_scan.
dense_scan`) for enumerable domains (the register, a set with few
distinct adds), the mask-mode scan (`ops.dense_scan.mask_scan`) for
order-independent models (the counter, the queue, a set whose adds hit
distinct fresh bits), whose rows report ``"kernel": "dense-mask"`` and
``"decided-tier": "mask"``. The rows beyond the dense plans with a
window ≤ SORT_MAX_SLOTS (127) take the sort-frontier ladder, as the
reference's `_jax_pass` runs it: one batch at `bucket_slots` of its
widest window through the sort kernel (`ops.linear_scan.sort_scan`) at
C = 64, the rows that overflow again at C = 256; ``ok`` is VALID at any
rung, ``~ok & ~overflow`` INVALID, and a row that overflows at the top
rung is undecided. Ladder rows report ``"kernel": "sort"``,
``"decided-tier": "sort"``. At the default ``JGRAFT_SCAN_CHUNK`` (128)
the window groups and every rung run through the chunked wavefront
(`schedule.run_chunked` over the kernels' chunk forms), as the
reference's do, and chunked dense rows carry ``"chunked": True``; there
each window group and each rung asks the autotuner's plan store
(checker/autotune.py) for its measured launch plan (chunk, macro cap),
which loads a persisted plan or, for a large enough bucket, measures one;
``JGRAFT_SCAN_CHUNK=0`` selects the one-shot launches
(`schedule.run_dense_groups`, `schedule.run_sort_rung`).

Algorithms:
  * ``"auto"``  — a budgeted DFS (FAST_DFS_BUDGET) first on rows whose
                  window is beyond every dense kernel (> 12); then the
                  device pass above for every undecided row; then, on
                  the rows still undecided, the full-budget DFS
                  (DEFAULT_DFS_BUDGET) before the host frontier oracle
                  (`wgl_cpu.check_encoded_cpu`) on wide rows, and again
                  after an oracle UNKNOWN — a DFS budget that ran out is
                  not retried. Host verdicts report ``"decided-tier":
                  "host"`` with ``"algorithm"`` ``"dfs"`` or ``"cpu"``.
  * ``"dense"`` — the device only (the reference's ``"jax"``): a row
                  beyond the ladder, or undecided at its top rung,
                  reports UNKNOWN with an error.
  * ``"cpu"``   — the host frontier oracle for every history.
  * ``"dfs"``   — the DFS-with-undo engine (`dfs_cpu`) for every history.
  * ``"race"``  — the device pass and the DFS engine at once, on two
                  threads; per history the first decided verdict wins
                  (knossos' competition analysis), the rest take the
                  host oracle. The device thread launches on a CUDA
                  stream of its own and reads every result back before
                  it ends, so no launch is left pending; a device pass
                  that raises is raised again once both threads end.

``n_configs`` / ``n_slots`` pin the sort kernel's shape, as in the
reference: a pin skips the segmented and dense plans and runs every row
through the ladder at that shape (``n_configs``: one rung of that
capacity; ``n_slots``: that kernel window, and rows wider than it are
beyond the ladder).

Knobs, with the reference's names and meanings: ``JGRAFT_LIN_FASTPATH``
(0 turns the fast path off), ``JGRAFT_LIN_FASTPATH_ABORT`` (its per-event
step budget), the gate's ``JGRAFT_LIN_FASTPATH_MIN_HIT`` / ``_MIN_OBS``,
``JGRAFT_AUTOTUNE`` (0: no plan, no gate), ``JGRAFT_AUTOTUNE_STORE``, the
plan store's ``JGRAFT_AUTOTUNE_MIN_ROWS`` / ``_MIN_CELLS`` /
``_SAMPLE_ROWS`` / ``_SAMPLES``, ``JGRAFT_LINFP_DIR``, and
``JGRAFT_SEGMENT`` (1/0 forces the long-history routing; unset, a CPU
device routes nothing and the card follows `_segment_routing_on`); at
the weak rungs ``JGRAFT_GREEDY_CERTIFY`` / ``JGRAFT_GREEDY_BACKTRACK``
(checker/consistency.py) and the cycle tier's ``JGRAFT_CYCLE_*``
(checker/cycle.py); inside a multi-process group ``JGRAFT_DISTRIBUTED``
(0 keeps every process on its whole batch; see ``distribute``).

Device: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions on the
host. With no CUDA device and no explicit CPU request they raise.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

import torch

from ..history.ops import History
from ..history.packing import (EncodedHistory, bucket_rows, encode_history,
                               macro_events_on, pack_batch, pack_macro_batch)
from ..ops.dense_scan import dense_plans_grouped
from ..ops.kernel_ir import MASK_DENSE_MAX_SLOTS
from ..ops.linear_scan import (DEFAULT_N_CONFIGS, MAX_SLOTS, bucket_slots,
                               make_sort_chunk_checker)
from ..ops.segment_scan import LONG_HISTORY_MIN_EVENTS, check_segmented_batch
from ..parallel import distributed
from ..platform import env_int, resolve_device
from . import autotune
from .base import Checker, INVALID, UNKNOWN, VALID
from .certify_batch import certify_many
from .counterexample import attach_counterexample, write_counterexample_html
from .dfs_cpu import SearchBudgetExceeded, check_encoded_dfs
from .schedule import (ChunkLaunch, DenseLaunch, build_dense_launches,
                       note_tier, run_chunked, run_dense_groups, run_sort_rung,
                       scan_chunk)
from .wgl_cpu import FrontierOverflow, check_encoded_cpu

#: Default host-oracle frontier cap: the search is worst-case
#: exponential in the window, so beyond this it reports UNKNOWN.
DEFAULT_MAX_CPU_CONFIGS = 1 << 18

ALGORITHMS = ("auto", "dense", "cpu", "dfs", "race")

#: Capacities of the sort ladder's rungs, smallest first.
SORT_LADDER = (64, DEFAULT_N_CONFIGS)

#: DFS step budget of the "dfs" and "race" engines and of auto's host
#: ladder: enough for any history the harness produces at its scale,
#: small enough that adversarial backtracking cannot wedge a check.
DEFAULT_DFS_BUDGET = 4_000_000

#: Budget of auto's wide-window DFS first pass (sub-second): valid
#: histories typically decide in thousands of steps; adversarial ones
#: exhaust this quickly and go on to the device pass.
FAST_DFS_BUDGET = 300_000

#: On the card, the long-history rows of a batch take the segmented scan
#: when there are at most this many of them (`_segment_routing_on`).
#: chip_smoke.py's `long_main` times both arms end to end on suite
#: config 5 (one 100k-op history) and on 1, 2, 4, 8 and 16 of config 4's
#: 10k-op histories: the segmented arm won at 1, 2 and 4 in every run,
#: and at 8 and 16 the two tied, either one ahead by a few percent
#: (PERF.md §5; H100 80GB HBM3, 700 W).
SEGMENT_MAX_LONG_ROWS = 4


# ---------------------------------------------------- the lin fast path
# The host witness certifier (checker/consistency.certify_encoded, via
# certify_batch.certify_many) runs as a pre-kernel pass: a witness that
# respects every [OPEN, FORCE] interval IS a linearization, so a
# certified row is a sound VALID decided on the host in O(E·W) with no
# kernel launch. Undecided rows go on to the device unchanged, so
# verdicts are identical with the pass off (JGRAFT_LIN_FASTPATH=0). Its
# worst case (host scan AND kernel) is bounded by a length-scaled abort
# budget per row and by the measured per-bucket gate of
# checker/autotune.py, which routes low-hit buckets kernel-first.

#: Algorithms the fast path fronts: the kernel-launching selectors. An
#: explicit "cpu"/"dfs" keeps its host engine, and "race" already runs
#: a host engine of its own.
LIN_FASTPATH_ALGOS = ("auto", "dense")


def lin_fastpath_on() -> bool:
    """Whether the pre-kernel certify pass runs. Default ON;
    ``JGRAFT_LIN_FASTPATH=0`` force-disables (defensive parse — garbage
    keeps the default)."""
    return env_int("JGRAFT_LIN_FASTPATH", 1, minimum=0) != 0


def lin_abort_steps() -> int:
    """Per-event abort budget for the fast path's host scan
    (``JGRAFT_LIN_FASTPATH_ABORT``, default 32 `model.step` calls per
    stream event; 0 = unbounded): a hopeless row aborts after budget·E
    steps. The reference calibrated it on a host-CPU A/B: valid rows
    certify in ~2–8 step calls per event."""
    return env_int("JGRAFT_LIN_FASTPATH_ABORT", 32, minimum=0)


_FP_LOCK = threading.Lock()
_FP_ZERO = {"rows_scanned": 0, "rows_certified": 0, "rows_gated": 0,
            "rows_rung_skipped": 0, "events_scanned": 0,
            "certify_wall_s": 0.0}
_FP_COUNTERS = dict(_FP_ZERO)


def _fp_bump(**kw) -> None:
    with _FP_LOCK:
        for k, v in kw.items():
            _FP_COUNTERS[k] += v


def fastpath_counters() -> dict:
    """Process-wide lin-fastpath counters (non-destructive):
    rows_scanned / rows_certified (the hit rate), rows_gated (routed
    kernel-first by the measured gate), rows_rung_skipped (weak-rung
    rows the fast path did not rescan: the rung certifier already had),
    events_scanned and the summed certify wall."""
    with _FP_LOCK:
        return dict(_FP_COUNTERS)


def consume_fastpath_counters() -> dict:
    """Return and reset the counters (one window's worth)."""
    global _FP_COUNTERS
    with _FP_LOCK:
        out = dict(_FP_COUNTERS)
        _FP_COUNTERS = dict(_FP_ZERO)
        return out


def lin_fastpath_pass(encs: Sequence[EncodedHistory], model,
                      note: bool = True) -> list:
    """Run the certifier over a batch; returns one result dict per row,
    None where undecided (the caller sends those to the device). Rows
    are grouped into the gate's buckets; gated buckets are skipped
    wholesale (counted), and every scanned bucket's (rows, hits, wall)
    feeds the gate's record. Certified rows report ``"algorithm":
    "greedy-witness"`` and ``"decided-tier"`` ``"greedy@lin"`` or
    ``"backtrack@lin"``; ``note=False`` leaves tier attribution to the
    caller."""
    results: list = [None] * len(encs)
    fam = type(model).__name__
    buckets: dict = {}
    for i, e in enumerate(encs):
        if e.n_events <= 0:
            continue  # trivial rows keep their "trivial" tier
        buckets.setdefault(
            autotune.lin_fastpath_sig(fam, e.n_events), []).append(i)
    abort = lin_abort_steps()
    for sig, idxs in buckets.items():
        if not autotune.lin_fastpath_route(sig):
            _fp_bump(rows_gated=len(idxs))
            continue
        t0 = time.perf_counter()
        hits = 0
        certs = certify_many(
            [encs[i] for i in idxs], model,
            max_steps=[abort * max(encs[i].n_events, 1) if abort
                       else None for i in idxs])
        for i, (ok, tier, _) in zip(idxs, certs):
            if ok:
                hits += 1
                results[i] = {
                    "valid?": VALID,
                    "algorithm": "greedy-witness",
                    "op-count": encs[i].n_ops,
                    "concurrency-window": encs[i].n_slots,
                    "decided-tier": tier + "@lin",
                }
        dt = time.perf_counter() - t0
        # every scanned row cost ~dt/len(idxs); the certified rows book
        # that share, the undecided rows' cost is their kernel's wall
        per_row = dt / max(len(idxs), 1)
        if note:
            for i in idxs:
                if results[i] is not None:
                    note_tier(results[i]["decided-tier"], wall_s=per_row)
        autotune.lin_fastpath_observe(sig, rows=len(idxs), hits=hits,
                                      wall_s=dt)
        _fp_bump(rows_scanned=len(idxs), rows_certified=hits,
                 events_scanned=sum(encs[i].n_events for i in idxs),
                 certify_wall_s=dt)
    return results


# -------------------------------------------------------- entry points


def check_histories(
    histories: Sequence[History],
    model,
    algorithm: str = "auto",
    device=None,
    witness: bool = False,
    max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
    n_configs: Optional[int] = None,
    n_slots: Optional[int] = None,
    consistency: str = "linearizable",
    distribute: bool = True,
) -> list[dict]:
    """Check a batch of histories; one result dict per history. The
    batch is the unit of device work: histories are encoded, grouped
    by window, and each group is one kernel launch. ``consistency``
    selects the verdict's rung, ``distribute`` the cluster seam
    (`check_encoded`)."""
    dev = resolve_device(device)
    encs = [encode_history(h, model) for h in histories]
    return check_encoded(encs, model, algorithm, dev, witness,
                         max_cpu_configs, n_configs, n_slots,
                         consistency=consistency, distribute=distribute)


def check_encoded(
    encs: Sequence[EncodedHistory],
    model,
    algorithm: str = "auto",
    device=None,
    witness: bool = False,
    max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
    n_configs: Optional[int] = None,
    n_slots: Optional[int] = None,
    consistency: str = "linearizable",
    lin_fastpath: Optional[bool] = None,
    distribute: bool = True,
) -> list[dict]:
    """Check already-encoded histories (`history.packing.encode_history`),
    one result dict each. ``lin_fastpath``: None = the default (the
    pre-kernel certify pass runs for "auto" and "dense" unless
    ``JGRAFT_LIN_FASTPATH=0``), False = skip it.

    ``distribute`` (default True): inside a multi-process group
    (`parallel.distributed.wavefront_active`) a batch of more than one
    row goes through the reference's seam, `parallel.distributed.
    run_sharded`: each process checks its row shard and the verdicts are
    exchanged, so every process returns the whole batch's results (other
    processes' rows as ``"kernel": "remote-shard"`` stubs, or, with a
    shared result store, ``JGRAFT_RESULT_STORE``, as their owners'
    results). Such a batch
    stays kernel-first — no lin fast path — unless the gate store is
    shared (``JGRAFT_LINFP_DIR``): each process's gate is its own state,
    and two processes evicting different rows would break the exchange.

    ``consistency`` selects the rung (checker/consistency.py):
    "linearizable" (default), "sequential" or "session" (aliases
    accepted). A weak rung certifies what the host witness scan can
    (`apply_rung`: ``"algorithm": "greedy-witness"``, ``"decided-tier"``
    ``"greedy"`` or ``"backtrack"``); at "sequential" the exact cycle
    tier (`checker.cycle.find_cycles`) refutes the undecided rows it can
    (INVALID, ``"algorithm"`` and ``"decided-tier"`` ``"cycle"``, the
    ``"cycle"`` witness, ``"exact-sc-refutation"``); the rest re-enter
    here at the linearizable rung on their relaxed encodings, with the
    lin fast path off. At "session" a dependency cycle is attached as
    ``"sc-refuted"`` / ``"sc-cycle"`` evidence, never a verdict. Rows too
    big for the cycle tier carry ``"cycle-skipped-size"``; every result
    of a weak rung carries ``"consistency"``."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"expected one of {ALGORITHMS}")
    dev = resolve_device(device)
    consistency = _normalize_rung(consistency)
    if consistency != "linearizable":
        return _check_rung(encs, model, algorithm, dev, witness,
                           max_cpu_configs, n_configs, n_slots,
                           consistency, distribute)

    def local(sub):
        return _check_encoded(sub, model, algorithm, dev, witness,
                              max_cpu_configs, n_configs, n_slots)

    def rest(sub):
        # the reference's `_kernel_path` seam
        if distribute and distributed.wavefront_active() and len(sub) > 1:
            # the result-detail exchange keys its store records over
            # (model, algorithm, row encoding); inert unless a shared
            # store dir is configured
            return distributed.run_sharded(sub, local, model=model,
                                           algorithm=algorithm)
        return local(sub)

    # A sharded batch stays kernel-first unless every process reads the
    # same gate records (the shared store): the gate is process-local
    # state, and processes that evicted different rows would exchange
    # mismatched shards.
    distributing = (distribute and distributed.wavefront_active()
                    and len(encs) > 1)
    if not (lin_fastpath is not False and encs
            and (not distributing or autotune.linfp_shared_dir() is not None)
            and algorithm in LIN_FASTPATH_ALGOS and lin_fastpath_on()):
        return rest(encs)
    results = lin_fastpath_pass(encs, model)
    todo = [i for i, r in enumerate(results) if r is None]
    if todo:
        for i, r in zip(todo, rest([encs[i] for i in todo])):
            results[i] = r
    return results


def _check_rung(encs, model, algorithm, dev, witness, max_cpu_configs,
                n_configs, n_slots, consistency,
                distribute: bool = True) -> list[dict]:
    """A weak rung, as the reference's `check_encoded` runs it: certify
    and relax the batch once (`apply_rung`), refute by dependency cycle
    at the sequential rung (`find_cycles`), check the rest at the
    linearizable rung on their relaxed encodings."""
    from .consistency import apply_rung

    t0 = time.perf_counter()
    relaxed, certified, tiers = apply_rung(encs, model, consistency)
    dt_cert = time.perf_counter() - t0
    results: list = [None] * len(encs)
    todo: list = []
    # each certified row carries its fair share of the certify + relax
    # pass; the undecided rows' cost is their kernel tier's wall
    per_row = dt_cert / max(len(encs), 1)
    for i, (enc, ok) in enumerate(zip(relaxed, certified)):
        if ok:
            results[i] = {
                "valid?": VALID, "algorithm": "greedy-witness",
                "op-count": enc.n_ops,
                "concurrency-window": enc.n_slots,
                "decided-tier": tiers[i],
            }
            note_tier(tiers[i], wall_s=per_row)
        else:
            todo.append(i)
    # The exact cycle tier: a dependency cycle among the required ops is
    # a sharp SC refutation, and at the sequential rung it implies the
    # kernels' verdict INVALID, so undecided rows consult it before the
    # relaxed kernel pass. It only ever refutes.
    cycle_skips: dict = {}
    if todo and consistency == "sequential":
        from .cycle import cycle_tier_on, find_cycles

        if cycle_tier_on():
            t0 = time.perf_counter()
            cyc = find_cycles([encs[i] for i in todo], model, device=dev)
            dt_cyc = time.perf_counter() - t0
            hits = [(j, i) for j, i in enumerate(todo)
                    if cyc[j] is not None and "cycle" in cyc[j]]
            cycle_skips.update(
                (i, cyc[j]["skipped-size"]) for j, i in enumerate(todo)
                if cyc[j] is not None and "skipped-size" in cyc[j])
            for j, i in hits:
                results[i] = {
                    "valid?": INVALID, "algorithm": "cycle",
                    "op-count": encs[i].n_ops,
                    "concurrency-window": encs[i].n_slots,
                    "decided-tier": "cycle",
                    "cycle": cyc[j]["cycle"],
                    "exact-sc-refutation": True,
                }
                note_tier("cycle", wall_s=dt_cyc / len(hits))
            if hits:
                todo = [i for i in todo if results[i] is None]
    if todo:
        # the rung certifier already scanned these rows, on the original
        # stream and on the relaxed one (a superset of legality), so the
        # lin fast path could not certify them; the counter shows the
        # skip, and only where the fast path would have run
        if algorithm in LIN_FASTPATH_ALGOS and lin_fastpath_on():
            _fp_bump(rows_rung_skipped=len(todo))
        sub = check_encoded([relaxed[i] for i in todo], model, algorithm,
                            dev, witness, max_cpu_configs, n_configs,
                            n_slots, consistency="linearizable",
                            lin_fastpath=False, distribute=distribute)
        for i, r in zip(todo, sub):
            results[i] = r
    if consistency == "session":
        _annotate_sc_refutations(encs, results, model, dev)
    for i, n_skipped in cycle_skips.items():
        if results[i] is not None:
            results[i]["cycle-skipped-size"] = n_skipped
    for r in results:
        r["consistency"] = consistency
    return results


def _normalize_rung(name) -> str:
    """Rung normalization; the default rung never imports the
    consistency module."""
    if name in (None, "linearizable"):
        return "linearizable"
    from .consistency import normalize_consistency

    return normalize_consistency(name)


def _annotate_sc_refutations(encs, results, model, dev) -> None:
    """Session-rung SC evidence: the session guarantee (monotonic reads
    + read-your-writes) does not imply sequential consistency — a
    monotonic-writes violation can honestly PASS the rung — so a
    dependency cycle here is attached as an annotation, never a verdict
    change: ``sc-refuted`` / ``sc-cycle`` mark results whose history is
    exactly proven non-SC although the weaker rung holds. As in the
    reference, the evidence is best effort: a failure of the cycle tier
    leaves the sound verdicts without it."""
    from .cycle import cycle_tier_on, find_cycles

    if not cycle_tier_on():
        return
    try:
        cyc = find_cycles(encs, model, device=dev)
    except Exception:
        return  # evidence must never take down a sound verdict
    for r, c in zip(results, cyc):
        if c is None or r is None:
            continue
        if "cycle" in c:
            r["sc-refuted"] = True
            r["sc-cycle"] = c["cycle"]
        elif "skipped-size" in c:
            r["cycle-skipped-size"] = c["skipped-size"]


def _check_encoded(encs, model, algorithm, dev, witness, max_cpu_configs,
                   n_configs, n_slots) -> list[dict]:
    """The reference's `_check_encoded` order, fast path excluded."""
    if algorithm == "cpu":
        return [_check_cpu(e, model, witness, max_cpu_configs)
                for e in encs]
    if algorithm == "dfs":
        return [_check_dfs(e, model, witness, max_steps=DEFAULT_DFS_BUDGET)
                for e in encs]
    if algorithm == "race":
        return _race(encs, model, dev, n_configs, n_slots, witness,
                     max_cpu_configs)
    results: list = [None] * len(encs)
    if algorithm == "auto":
        # Wide windows are frontier-hostile (breadth-first cost ~2^W) but
        # usually DFS-trivial when valid: a small DFS budget first.
        for i, e in enumerate(encs):
            if e.n_slots > MASK_DENSE_MAX_SLOTS and e.n_events > 0:
                r = _check_dfs(e, model, witness, max_steps=FAST_DFS_BUDGET)
                if r["valid?"] is not UNKNOWN:
                    results[i] = r
    todo = [i for i, r in enumerate(results) if r is None]
    for i, r in zip(todo, _device_pass([encs[i] for i in todo], model, dev,
                                       n_configs, n_slots)):
        results[i] = r
    if algorithm == "dense":
        for i, r in enumerate(results):
            if r is None:
                results[i] = {
                    "valid?": UNKNOWN,
                    "algorithm": "torch",
                    "error": "beyond the kernels' caps (window "
                             f"{encs[i].n_slots} slots, or a frontier "
                             "overflow at the top rung); use "
                             "algorithm='auto' or 'cpu'",
                }
        return results
    for i, r in enumerate(results):
        dfs_exhausted = False
        if r is None and encs[i].n_slots > MASK_DENSE_MAX_SLOTS:
            # wide windows the device could not decide: the full-budget
            # DFS before the host frontier, whose overflow cap is the
            # final "unfeasible to verify" answer
            r2 = _check_dfs(encs[i], model, witness,
                            max_steps=DEFAULT_DFS_BUDGET)
            if r2["valid?"] is not UNKNOWN:
                results[i] = r2
                continue
            dfs_exhausted = True  # deterministic: a re-run cannot differ
        if results[i] is None:
            results[i] = _check_cpu(encs[i], model, witness, max_cpu_configs)
        if results[i].get("valid?") is UNKNOWN and not dfs_exhausted:
            r2 = _check_dfs(encs[i], model, witness,
                            max_steps=DEFAULT_DFS_BUDGET)
            if r2["valid?"] is not UNKNOWN:
                results[i] = r2
    return results


# --------------------------------------------------------- device pass


def _device_pass(encs, model, dev, n_configs=None, n_slots=None,
                 note: bool = True) -> list:
    """The reference's `_jax_pass` on the card (or the kernels' plain
    versions on a CPU device): one result dict per history, or None
    where the device could not decide (a window beyond the ladder, or a
    frontier overflow at the top rung). Order: trivial rows; long rows
    through the segmented scan; the dense plans; the sort ladder for
    the rest."""
    results: list = [None] * len(encs)
    cap = n_slots or MAX_SLOTS
    fits = []
    for i, e in enumerate(encs):
        if e.n_events == 0:
            if note:
                note_tier("trivial")
            results[i] = {"valid?": VALID, "algorithm": "trivial",
                          "op-count": 0, "decided-tier": "trivial"}
        elif e.n_slots <= cap:
            fits.append(i)
    if fits and n_configs is None and n_slots is None:
        fits = _segment_pass(encs, model, dev, fits, results, note)
        fits = _dense_pass(encs, model, dev, fits, results, note)
    _sort_pass(encs, model, dev, fits, results, n_configs, n_slots, note)
    return results


def _segment_routing_on(n_long: int, dev) -> bool:
    """Whether a batch's `n_long` long-history rows take the segmented
    scan. ``JGRAFT_SEGMENT`` forces it (1 on, anything else off);
    unset, a CPU device routes nothing (the basis multiplies host work)
    and the card routes up to SEGMENT_MAX_LONG_ROWS rows."""
    forced = os.environ.get("JGRAFT_SEGMENT")
    if forced is not None:
        return forced == "1"
    return torch.device(dev).type == "cuda" and \
        n_long <= SEGMENT_MAX_LONG_ROWS


def _segment_pass(encs, model, dev, fits, results, note: bool) -> list:
    """Long histories first: the rows of at least LONG_HISTORY_MIN_EVENTS
    events go to the segmented scan when `_segment_routing_on` says so.
    Fills `results` for the rows it decides (``"kernel": "dense-seg"``,
    ``"segments"``); returns the rest of `fits`. The segmented path keeps
    legacy event rows (its planner reasons about single events)."""
    long_idx = [i for i in fits if encs[i].n_events >= LONG_HISTORY_MIN_EVENTS]
    if not long_idx or not _segment_routing_on(len(long_idx), dev):
        return fits
    t0 = time.perf_counter()
    seg = check_segmented_batch([encs[i] for i in long_idx], model,
                                device=dev)
    dt = time.perf_counter() - t0
    n_done = sum(1 for r in seg if r is not None)
    for j, i in enumerate(long_idx):
        if seg[j] is not None:
            r = _jx(VALID if seg[j]["valid"] else INVALID, encs[i],
                    dt / max(n_done, 1), kernel="dense-seg", note=note)
            r["segments"] = seg[j]["segments"]
            results[i] = r
    return [i for i in fits if results[i] is None]


def _dense_pass(encs, model, dev, fits, results, note: bool) -> list:
    """Run every dense-eligible history of `fits` through its group's
    CUDA kernel, domain or mask (or the kernel's plain version on a CPU
    device): through the chunked wavefront (`run_chunked`, rows stamped
    ``"chunked": True``) when `scan_chunk()` > 0, each group under its
    launch plan where `autotune.tuned_group_plan` gives one, else the
    one-shot launches (`run_dense_groups`). Fills `results` for them;
    returns the rows beyond both kinds' caps."""
    if not fits:
        return fits
    grouped, rest = dense_plans_grouped(model, [encs[i] for i in fits])
    rest = [fits[j] for j in rest]
    if not grouped:
        return rest
    pack = pack_macro_batch if macro_events_on() else pack_batch
    chunked = scan_chunk() > 0
    triples = []
    for idxs, plan in grouped:
        sub = [fits[j] for j in idxs]
        sub_encs = [encs[i] for i in sub]
        # the group's launch plan (checker/autotune.py), on the wavefront
        # only, as the reference's: a persisted plan loads, a large
        # enough unplanned bucket measures once, anything else keeps the
        # defaults; the plan's macro cap acts here, its chunk in
        # build_dense_launches
        tuned = (autotune.tuned_group_plan(model, plan, sub_encs, device=dev)
                 if chunked else None)
        triples.append((sub, plan,
                        autotune.pack_group(sub_encs, tuned)
                        if tuned is not None else pack(sub_encs), tuned))
    if chunked:
        launches, subs = build_dense_launches(model, triples, device=dev)
        for sub, out in zip(subs, run_chunked(launches)):
            # each row reports its group's (overlapped) wall share
            dt = out.wall_s / max(len(sub), 1)
            for j, i in enumerate(sub):
                r = _jx(VALID if out.ok[j] else INVALID, encs[i], dt,
                        kernel=out.tag, note=note)
                r["chunked"] = True
                results[i] = r
        return rest
    launches = [DenseLaunch(
        events=torch.from_numpy(batch["events"]).to(dev),
        val_of=torch.from_numpy(plan.val_of).to(dev),
        n_events=torch.from_numpy(batch["n_events"]).to(dev),
        n_slots=plan.n_slots, macro_p=batch.get("macro_p"),
        tag=plan.kernel_tag, kind=plan.kind)
        for _, plan, batch, _ in triples]
    run = run_dense_groups(launches, model)
    dt = run.wall_s / max(sum(len(t[0]) for t in triples), 1)
    for (sub, _, _, _), ok, ln in zip(triples, run.ok, launches):
        for j, i in enumerate(sub):
            results[i] = _jx(VALID if ok[j] else INVALID, encs[i], dt,
                             kernel=ln.tag, note=note)
    return rest


def _sort_pass(encs, model, dev, rows, results, n_configs=None,
               n_slots=None, note: bool = True) -> None:
    """The sort-frontier ladder over `rows` (indices into encs), as the
    reference's `_jax_pass` runs it: one batch at the widest window's
    bucket (or the pinned `n_slots`), rungs SORT_LADDER (or the pinned
    `n_configs` alone); the rows that overflow go up a rung. Each rung
    is one `ChunkLaunch` (tag "sort") through the chunked wavefront when
    `scan_chunk()` > 0, under its launch plan where
    `autotune.tuned_sort_plan` gives one, else one `run_sort_rung`; its
    rows are recorded
    alike either way (no "chunked" stamp, as the reference's). Fills
    `results` for the rows it decides."""
    if not rows:
        return
    W = n_slots or bucket_slots(max(encs[i].n_slots for i in rows))
    ladder = [n_configs] if n_configs else list(SORT_LADDER)
    pack = pack_macro_batch if macro_events_on() else pack_batch
    remaining = rows
    for rung, C in enumerate(ladder):
        rung_encs = [encs[i] for i in remaining]
        chunked = scan_chunk() > 0
        # the rung's launch plan (family "sort", C in the signature), on
        # the wavefront only, as the reference's
        tuned = (autotune.tuned_sort_plan(model, rung_encs, C, W, device=dev)
                 if chunked else None)
        batch = (autotune.pack_group(rung_encs, tuned) if tuned is not None
                 else pack(rung_encs))
        t0 = time.perf_counter()
        if chunked:
            init_fn, step_fn = make_sort_chunk_checker(
                model, C, W, macro_p=batch.get("macro_p"))
            e_sched = bucket_rows(batch["events"].shape[1], 32)
            [out] = run_chunked([ChunkLaunch(
                events=batch["events"], n_events=batch["n_events"],
                init_fn=init_fn, step_fn=step_fn, e_sched=e_sched,
                device=autotune.sort_rung_sharding(tuned) or dev, tag="sort",
                chunk=(tuned.scan_chunk or max(e_sched, 1))
                if tuned is not None else None)])
            ok, overflow = out.ok, out.overflow
        else:
            run = run_sort_rung(torch.from_numpy(batch["events"]).to(dev),
                                torch.from_numpy(batch["n_events"]).to(dev),
                                W, C, batch.get("macro_p"), model)
            ok, overflow = run.ok, run.overflow
        dt = (time.perf_counter() - t0) / len(remaining)
        escalate = []
        for j, i in enumerate(remaining):
            if ok[j]:
                results[i] = _jx(VALID, encs[i], dt, kernel="sort",
                                 note=note)
            elif not overflow[j]:
                results[i] = _jx(INVALID, encs[i], dt, kernel="sort",
                                 note=note)
            elif rung + 1 < len(ladder):
                escalate.append(i)
            # else: overflowed at the top rung, undecided
        remaining = escalate
        if not remaining:
            break


# ---------------------------------------------------------------- race


def _race(encs, model, dev, n_configs, n_slots, witness, max_cpu_configs):
    """Race the device pass against the DFS engine; per history the first
    decided verdict wins (knossos.competition analogue). Histories
    neither engine decides take the capped host frontier, which can
    itself report UNKNOWN on adversarial histories. On the card the
    device thread sets the device and launches on a stream of its own;
    every launch it makes is read back before the thread ends, and both
    threads are joined before this returns. A device pass that raises
    (a kernel that does not build or launch) stops the DFS side at its
    next history and is raised again here: the host never answers for
    a device that failed."""
    decided: list = [None] * len(encs)
    lock = threading.Lock()
    failed: list = []

    def record(i, res):
        with lock:
            if decided[i] is None:
                res["raced"] = True
                decided[i] = res
                # tier attribution belongs to the winner only
                tier = res.get("decided-tier")
                if tier is not None:
                    note_tier(tier, wall_s=res.get("time-s", 0.0))

    def device_side():
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev), \
                        torch.cuda.stream(torch.cuda.Stream(dev)):
                    rs = _device_pass(encs, model, dev, n_configs, n_slots,
                                      note=False)
            else:
                rs = _device_pass(encs, model, dev, n_configs, n_slots,
                                  note=False)
        except BaseException as e:  # noqa: BLE001 — raised after the join
            failed.append(e)
            return
        for i, r in enumerate(rs):
            if r is not None:
                record(i, r)

    def dfs_side():
        # cheapest histories first: win the race where DFS is strong
        for i in sorted(range(len(encs)), key=lambda i: encs[i].n_events):
            if failed:
                return
            with lock:
                if decided[i] is not None:
                    continue
            r = _check_dfs(encs[i], model, witness,
                           max_steps=DEFAULT_DFS_BUDGET, note=False)
            if r["valid?"] is not UNKNOWN:
                record(i, r)

    threads = [threading.Thread(target=device_side),
               threading.Thread(target=dfs_side)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise failed[0]
    for i, r in enumerate(decided):
        if r is None:
            decided[i] = _check_cpu(encs[i], model, witness, max_cpu_configs)
    return decided


# ------------------------------------------------------------- results


def kernel_tier(tag: str) -> str:
    """Decided-tier name of a kernel tag (the reference's attribution):
    the mask kernel is its own tier, the sort ladder "sort", every other
    dense-family kernel (domain, segmented) "dense"."""
    if "mask" in tag:
        return "mask"
    if "sort" in tag:
        return "sort"
    return "dense"


def _jx(valid, enc: EncodedHistory, secs: float,
        kernel: str = "dense", note: bool = True) -> dict:
    tier = kernel_tier(kernel)
    if note:
        note_tier(tier, wall_s=secs)
    return {
        "valid?": valid,
        "algorithm": "torch",
        "kernel": kernel,
        "op-count": enc.n_ops,
        "concurrency-window": enc.n_slots,
        "time-s": secs,
        "decided-tier": tier,
    }


def check_encoded_host(enc: EncodedHistory, model, witness: bool = False,
                       max_cpu_configs: Optional[int]
                       = DEFAULT_MAX_CPU_CONFIGS,
                       consistency: str = "linearizable",
                       lin_fastpath: Optional[bool] = None) -> dict:
    """Host-only verdict ladder for one encoded history, the
    reference's: the capped CPU frontier first, the budgeted DFS when
    the frontier reports UNKNOWN — never a kernel launch, and no device
    is resolved. This is the checking service's degrade path (it
    re-checks a batch through it when the device pass raises mid-check)
    and its watchdog's forced host retry. A weaker ``consistency`` rung
    certifies and relaxes exactly like `check_encoded`, with the cycle
    tier's host arm; at the linearizable rung the same certify fast
    path runs first unless ``lin_fastpath=False``."""
    if enc.n_events == 0:
        note_tier("trivial")
        return {"valid?": VALID, "algorithm": "trivial", "op-count": 0,
                "decided-tier": "trivial"}
    consistency = _normalize_rung(consistency)
    if consistency != "linearizable":
        from .consistency import apply_rung
        from .cycle import cycle_tier_on, find_cycles

        orig = enc

        def annotate_session(res: dict) -> dict:
            # the sc-refuted evidence the device path attaches to every
            # session-rung result; best effort, host arm only
            if consistency == "session" and cycle_tier_on():
                try:
                    [c] = find_cycles([orig], model, kernel=False)
                except Exception:
                    c = None
                if c is not None and "cycle" in c:
                    res["sc-refuted"] = True
                    res["sc-cycle"] = c["cycle"]
                elif c is not None and "skipped-size" in c:
                    res["cycle-skipped-size"] = c["skipped-size"]
            return res

        [enc], [certified], [tier] = apply_rung([enc], model, consistency)
        if certified:
            note_tier(tier)
            return annotate_session(
                {"valid?": VALID, "algorithm": "greedy-witness",
                 "op-count": enc.n_ops,
                 "concurrency-window": enc.n_slots,
                 "decided-tier": tier,
                 "consistency": consistency})
        if consistency == "sequential" and cycle_tier_on():
            [c] = find_cycles([orig], model, kernel=False)
            if c is not None and "cycle" in c:
                note_tier("cycle")
                return {"valid?": INVALID, "algorithm": "cycle",
                        "op-count": orig.n_ops,
                        "concurrency-window": orig.n_slots,
                        "decided-tier": "cycle",
                        "cycle": c["cycle"],
                        "exact-sc-refutation": True,
                        "consistency": consistency}
    if consistency == "linearizable" and lin_fastpath is not False \
            and lin_fastpath_on():
        from .consistency import certify_encoded

        sig = autotune.lin_fastpath_sig(type(model).__name__,
                                        enc.n_events)
        if autotune.lin_fastpath_route(sig):
            abort = lin_abort_steps()
            t0 = time.perf_counter()
            ok, tier, _ = certify_encoded(
                enc, model,
                max_steps=abort * max(enc.n_events, 1) if abort
                else None)
            dt = time.perf_counter() - t0
            autotune.lin_fastpath_observe(sig, rows=1, hits=int(ok),
                                          wall_s=dt)
            _fp_bump(rows_scanned=1, rows_certified=int(ok),
                     events_scanned=enc.n_events, certify_wall_s=dt)
            if ok:
                note_tier(tier + "@lin", wall_s=dt)
                return {"valid?": VALID, "algorithm": "greedy-witness",
                        "op-count": enc.n_ops,
                        "concurrency-window": enc.n_slots,
                        "decided-tier": tier + "@lin"}
        else:
            _fp_bump(rows_gated=1)
    r = _check_cpu(enc, model, witness, max_cpu_configs)
    if r.get("valid?") is UNKNOWN:
        r2 = _check_dfs(enc, model, witness, max_steps=DEFAULT_DFS_BUDGET)
        if r2["valid?"] is not UNKNOWN:
            r = r2
    if consistency != "linearizable":
        r = annotate_session(r)
        r["consistency"] = consistency
    return r


def _check_dfs(enc: EncodedHistory, model, witness: bool = False,
               max_steps: Optional[int] = None, note: bool = True) -> dict:
    if enc.n_events == 0:
        if note:
            note_tier("trivial")
        return {"valid?": VALID, "algorithm": "trivial", "op-count": 0,
                "decided-tier": "trivial"}
    t0 = time.perf_counter()
    try:
        r = check_encoded_dfs(enc, model, max_steps=max_steps,
                              witness=witness)
    except SearchBudgetExceeded as e:
        return {"valid?": UNKNOWN, "algorithm": "dfs", "error": str(e)}
    if note:
        note_tier("host", wall_s=time.perf_counter() - t0)
    out = {
        "valid?": VALID if r.valid else INVALID,
        "algorithm": "dfs",
        "op-count": enc.n_ops,
        "concurrency-window": enc.n_slots,
        "configs-explored": r.configs_explored,
        "decided-tier": "host",
    }
    if not r.valid:
        out["failing-op-index"] = r.failing_op_index
    if r.witness is not None:
        out["witness"] = r.witness
    return out


def _check_cpu(enc: EncodedHistory, model, witness: bool,
               max_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
               note: bool = True) -> dict:
    t0 = time.perf_counter()
    try:
        r = check_encoded_cpu(enc, model, max_configs=max_configs,
                              witness=witness)
    except FrontierOverflow as e:
        return {"valid?": UNKNOWN, "algorithm": "cpu", "error": str(e)}
    if note:
        note_tier("host", wall_s=time.perf_counter() - t0)
    out = {
        "valid?": VALID if r.valid else INVALID,
        "algorithm": "cpu",
        "op-count": enc.n_ops,
        "concurrency-window": enc.n_slots,
        "configs-explored": r.configs_explored,
        "max-frontier": r.max_frontier,
        "decided-tier": "host",
    }
    if not r.valid:
        out["failing-op-index"] = r.failing_op_index
    if r.witness is not None:
        out["witness"] = r.witness
    return out


class LinearizableChecker(Checker):
    """Checker-protocol wrapper around `check_histories` for one
    history (client ops only), at the rung ``consistency``. An INVALID
    result carries the reference's counterexample
    (`checker/counterexample.py`, searched on the rung's stream), and
    its HTML timeline is written into ``test["store_dir"]`` when there
    is one."""

    def __init__(self, model, algorithm: str = "auto", device=None,
                 max_cpu_configs: Optional[int] = DEFAULT_MAX_CPU_CONFIGS,
                 consistency: str = "linearizable"):
        self.model = model
        self.algorithm = algorithm
        self.device = resolve_device(device)
        self.max_cpu_configs = max_cpu_configs
        self.consistency = _normalize_rung(consistency)

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        hist = history.client_ops()
        # witness=True so the host engines explain during the verdict
        # run; attach_counterexample re-searches only for kernel verdicts
        [result] = check_histories(
            [hist], self.model, self.algorithm, self.device, witness=True,
            max_cpu_configs=self.max_cpu_configs,
            consistency=self.consistency)
        if result.get("valid?") is INVALID:
            attach_counterexample(result, hist, self.model,
                                  max_cpu_configs=self.max_cpu_configs,
                                  consistency=self.consistency)
            write_counterexample_html(result, hist,
                                      (test or {}).get("store_dir"),
                                      "counterexample.html")
        return result
