"""Re-verify recorded run histories as one batch on the card (the port
of the reference's `checker/recorded.py`).

BASELINE config #3 ("CAS register + partition nemesis, 512 recorded
histories batched-verified") names the real unit of production work: not
synthetic histories, but histories a cluster actually produced, loaded
back from the store and verified together. This module is that path:

  store/<name>/<ts>/history.jsonl  →  load  →  per-key split (independent
  workloads, reference register.clj:106)  →  one `check_histories` batch
  per model family across every sub-history of every run  →  per-run
  verdicts. (Invariant-style checkers without the Model step interface —
  the election-safety models — run their direct host check instead.)

Exposed on the CLI as `python -m jepsen_jgroups_raft_tpu_torch check
RUN_DIR…`. The summary is the reference's, key for key; ``device``
(`platform.resolve_device`) is the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional, Sequence

from ..core.store import load_history
from ..models import CasRegister, Counter, GSet, TicketQueue
from ..models.base import Model
from ..models.leader import MajorityLeaderModel
from ..platform import resolve_device
from .base import INVALID, UNKNOWN, VALID, merge_valid
from .counter_bounds import decide_unknown_with_interval
from .independent import split_by_key
from .linearizable import check_histories

#: workload → (model factory, values are (key, value) tuples?)
#: Election re-checks use MajorityLeaderModel, not the parity
#: LeaderModel: a store written by a live run with --majority-election
#: carries `views` ops whose cross-node invariant would otherwise
#: silently weaken on re-verification; with no views ops in the history
#: it degrades exactly to the parity check.
WORKLOAD_MODELS = {
    "single-register": (CasRegister, True),
    "multi-register": (CasRegister, True),
    "counter": (Counter, False),
    "election": (MajorityLeaderModel, False),
    "set": (GSet, False),
    "queue": (TicketQueue, False),
}


def _run_workload(run_dir: Path) -> Optional[str]:
    try:
        with open(run_dir / "test.json") as f:
            t = json.load(f)
        # the harness keeps the raw CLI opts under "opts"; the workload
        # name lives there (top-level checked too for hand-built tests).
        return t.get("workload") or t.get("opts", {}).get("workload")
    except (OSError, json.JSONDecodeError):
        return None


def load_run_histories(run_dir, workload: Optional[str] = None):
    """Load one run dir → (model, [per-key sub-histories], workload)."""
    run_dir = Path(run_dir)
    workload = workload or _run_workload(run_dir)
    if workload not in WORKLOAD_MODELS:
        raise ValueError(
            f"{run_dir}: unknown workload {workload!r}; pass --workload")
    model_factory, independent = WORKLOAD_MODELS[workload]
    history = load_history(run_dir).client_ops()
    if independent:
        subs = list(split_by_key(history).values())
    else:
        subs = [history]
    return model_factory(), subs, workload


def check_recorded(run_dirs: Sequence, workload: Optional[str] = None,
                   algorithm: str = "auto",
                   n_configs: Optional[int] = None, device=None) -> dict:
    """Batch-verify recorded runs on `device`. Sub-histories across all
    runs are grouped by model family; each frontier-model group goes
    through one check_histories batch, non-Model invariant checkers
    (the election models) run their direct check per history. Counter
    UNKNOWNs are decided at the interval tier. Returns a summary dict
    with per-run verdicts and throughput."""
    dev = resolve_device(device)
    loaded = []  # (run_dir, model, subs)
    for d in run_dirs:
        model, subs, wl = load_run_histories(d, workload)
        loaded.append((str(d), model, subs, wl))

    t0 = time.perf_counter()
    # Group by model type so each batch is one kernel family.
    per_run: dict = {d: [] for d, _, _, _ in loaded}
    by_model: dict = {}
    for d, model, subs, _ in loaded:
        by_model.setdefault(type(model).__name__, (model, []))[1].extend(
            (d, s) for s in subs)
    n_histories = 0
    for _, (model, tagged) in by_model.items():
        hists = [s for _, s in tagged]
        if not hists:
            continue
        n_histories += len(hists)
        if not isinstance(model, Model):
            # Not a frontier-search model: the election models (safety
            # is order-independent) expose a direct `check(history)`.
            results = [model.check(h) for h in hists]
        else:
            results = check_histories(hists, model, algorithm=algorithm,
                                      n_configs=n_configs, device=dev)
            if isinstance(model, Counter):
                # The live counter workload's tier ladder: a recorded
                # canonical-envelope counter run must not re-check to
                # UNKNOWN when the bounds tier can decide it.
                for j, r in enumerate(results):
                    if r.get("valid?") is UNKNOWN:
                        results[j] = decide_unknown_with_interval(
                            r, hists[j])
        for (d, _), r in zip(tagged, results):
            per_run[d].append(r)
    dt = time.perf_counter() - t0

    run_verdicts = {
        d: merge_valid(r.get("valid?") for r in rs) if rs else VALID
        for d, rs in per_run.items()
    }
    all_results = [r for rs in per_run.values() for r in rs]
    return {
        "valid?": merge_valid(run_verdicts.values()),
        "runs": len(loaded),
        "histories": n_histories,
        "n-valid": sum(1 for r in all_results if r.get("valid?") is VALID),
        "n-invalid": sum(1 for r in all_results
                         if r.get("valid?") is INVALID),
        "n-unknown": sum(1 for r in all_results
                         if r.get("valid?") is UNKNOWN),
        "time-s": dt,
        "histories-per-sec": (n_histories / dt) if dt > 0 else 0.0,
        "run-verdicts": run_verdicts,
    }
