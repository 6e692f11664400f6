"""Seeded-violation recall harness (a copy of the reference's
`search/recall.py`).

Planting: each plant is a region — a (family, base-seed) pocket whose
base history is valid by construction — together with a PROOF that the
pocket contains a reachable violation: one (operator, edit-seed) pair
drawn from the same registry and the same bounded edit-seed space the
mutator searches, verified INVALID on the host checker at plant time.
The search driver never sees the proof; it only gets the bases. A
plant is FOUND when the corpus archives a re-verified violation in its
region.

Recall-per-CPU-minute uses `time.process_time`, which charges the
in-process graftd workers' checking threads to the run — the honest
denominator for the guided-vs-random comparison (wall time would
reward an arm that merely idles less in batch linger).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..checker.base import INVALID
from .driver import SearchConfig, SearchDriver
from .operators import operators_for
from .scenario import Scenario, materialize, mutate

_PLANT_ATTEMPTS_PER_SLOT = 12


def _scenario_invalid(sc: Scenario, consistency: str) -> bool:
    """Host-only verdict for a genome (no kernels: planting runs before
    any service exists, on the host by design)."""
    from ..checker.linearizable import check_histories
    from ..service.request import build_units

    hist = materialize(sc)
    model, units = build_units([hist], sc.family)
    for _, uh in units:
        res = check_histories([uh], model, algorithm="cpu", device="cpu",
                              consistency=consistency)[0]
        if res["valid?"] is INVALID:
            return True
    if sc.family == "list-append":
        from ..checker.anomaly import certify_submission

        if certify_submission([hist])["valid?"] is False:
            return True
    return False


@dataclass
class Plant:
    base: Scenario
    edit: tuple  # (operator-name, edit-seed) proven to invalidate

    @property
    def region(self):
        return self.base.region


@dataclass
class RecallReport:
    planted: int
    found: List[list]
    missed: List[list]
    recall: float
    cpu_s: float
    recall_per_cpu_min: float
    report: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "planted": self.planted, "found": self.found,
            "missed": self.missed, "recall": round(self.recall, 4),
            "cpu_s": round(self.cpu_s, 3),
            "recall_per_cpu_min": round(self.recall_per_cpu_min, 4),
            "report": self.report,
        }


def plant_violations(config: SearchConfig, k: int) -> List[Plant]:
    """Deterministically derive K plants across the config's families.
    Base seeds that admit no invalidating (operator, edit-seed) inside
    the mutator's edit space are skipped — every returned plant is
    PROVEN reachable, so recall misses are search failures, not
    planting failures."""
    plants: List[Plant] = []
    fams = list(config.families)
    slot = 0
    while len(plants) < k:
        fam = fams[len(plants) % len(fams)]
        plant = None
        for attempt in range(_PLANT_ATTEMPTS_PER_SLOT):
            seed = config.seed * 1000 + 101 * slot + 7 * attempt
            base = Scenario(
                family=fam, seed=seed, n_ops=config.n_ops,
                n_procs=config.n_procs, crash_p=config.crash_p,
                n_keys=config.n_keys if fam == "list-append" else 1)
            if _scenario_invalid(base, config.consistency):
                continue  # base must start valid
            ops = [op for op in operators_for(fam, "history")
                   if op.can_invalidate]
            hit = None
            for op in ops:
                for es in range(config.edit_space):
                    cand = mutate(base, op, es)
                    if _scenario_invalid(cand, config.consistency):
                        hit = (op.name, es)
                        break
                if hit:
                    break
            if hit:
                plant = Plant(base=base, edit=hit)
                break
        if plant is None:
            raise RuntimeError(
                f"could not derive a reachable plant for {fam!r} "
                f"(slot {slot}); widen JGRAFT_SEARCH_EDIT_SPACE")
        plants.append(plant)
        slot += 1
    return plants


def run_recall(config: SearchConfig, k: Optional[int] = None,
               plants: Optional[List[Plant]] = None,
               service=None) -> RecallReport:
    """Plant, search, score. The driver only receives the plant BASES;
    found = a re-verified violation archived in the plant's region."""
    if plants is None:
        plants = plant_violations(config, k or 20)
    t_cpu = time.process_time()
    driver = SearchDriver(config, service=service)
    rep = driver.run(seeds=[p.base for p in plants])
    cpu_s = max(1e-6, time.process_time() - t_cpu)
    regions = {tuple(e["region"]) for e in driver.corpus.entries()}
    found = [list(p.region) for p in plants if p.region in regions]
    missed = [list(p.region) for p in plants if p.region not in regions]
    recall = len(found) / max(1, len(plants))
    return RecallReport(
        planted=len(plants), found=found, missed=missed, recall=recall,
        cpu_s=cpu_s,
        recall_per_cpu_min=len(found) / (cpu_s / 60.0),
        report=rep)
