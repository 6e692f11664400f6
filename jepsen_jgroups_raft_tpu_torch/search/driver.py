"""Generation loop over graftd's batched admission (a copy of the
reference's `search/driver.py`, over the port's checking service).

Each generation mutates survivors into a candidate population, submits
every unseen candidate through graftd (all submissions are in flight
before the first wait, so shape-bucket coalescing batches them for
free), scores fitness from the verdicts, archives minimized violations
into the content-addressed corpus, and selects the next survivor pool.

Guided vs random (the `JGRAFT_SEARCH_GUIDED=0` ablation) differ ONLY
in what feedback they read:

  * guided — survivors are the fittest candidates, parents are drawn
    fitness-weighted, operator choice is weighted by each operator's
    observed violation/fitness yield, and regions whose violation is
    already archived are retired so the budget concentrates on unfound
    pockets;
  * random — survivors, parents and operators are drawn uniformly and
    nothing is retired: pure blind mutation, same operators, same
    budget, same admission path.

Determinism: every stochastic choice flows from seeded Random chains
and candidate evaluation pins ``JGRAFT_AUTOTUNE=0`` for the duration
of the run — the measured per-bucket gates (lin fastpath, certify
batch) are host-mood state that would otherwise let tier attribution,
hence fitness, hence SELECTION, differ between two identical runs.
Same seed ⇒ identical corpus fingerprints, asserted by ab_search
before any timing.

Three differences from the reference. The service runs on the card
unless ``SearchConfig.device`` names another device (an in-process
service is built on it; a ``service_url`` daemon runs on its own). A
request that does not come back DONE — failed, cancelled, or still
running past ``_EVAL_TIMEOUT_S`` — raises, naming its status and error:
the reference scores it as empty rows (fitness 0) and runs on, which on
the card would hide a failed launch behind a low fitness. Over HTTP, a
submit answer that already says "done" but carries no results (the
check finished before the answer was written; only a cache hit's
answer carries them) is polled for its results, where the reference
scores it as empty rows.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .. import platform as plat
from ..checker.base import INVALID
from ..service.request import DONE
from .corpus import Corpus, build_entry
from .fitness import score_candidate
from .operators import Operator, operators_for
from .scenario import Scenario, materialize, mutate, scenario_fingerprint

#: workloads whose admission overlay needs raw ops — the binary lane
#: ships encodings only (service/request.py), so these submit as JSON
_TXN_WORKLOADS = ("list-append",)

_EVAL_TIMEOUT_S = 120.0


def _require_done(status: str, error: Optional[str], request_id) -> None:
    """Raise unless a candidate's request came back DONE: a failed or
    cancelled check, or one still running at the timeout, is an error
    of the run, never a candidate of fitness 0."""
    if status != DONE:
        raise RuntimeError(f"search: check request {request_id} ended "
                           f"{status}: {error}")


def search_config_from_env(**overrides) -> "SearchConfig":
    kw = dict(
        population=plat.env_int("JGRAFT_SEARCH_POP", 48, minimum=4),
        generations=plat.env_int("JGRAFT_SEARCH_GENERATIONS", 8, minimum=1),
        survivors=plat.env_int("JGRAFT_SEARCH_SURVIVORS", 12, minimum=2),
        edit_space=plat.env_int("JGRAFT_SEARCH_EDIT_SPACE", 24, minimum=2),
        seed=plat.env_int("JGRAFT_SEARCH_SEED", 0),
        guided=plat.env_int("JGRAFT_SEARCH_GUIDED", 1) != 0,
        corpus_dir=plat.env_str("JGRAFT_SEARCH_DIR", "store/search"),
    )
    kw.update(overrides)
    return SearchConfig(**kw)


@dataclass
class SearchConfig:
    families: Tuple[str, ...] = ("register", "set", "queue", "list-append")
    population: int = 48
    generations: int = 8
    survivors: int = 12
    edit_space: int = 24
    seed: int = 0
    guided: bool = True
    corpus_dir: str = "store/search"
    consistency: str = "linearizable"
    n_ops: int = 20
    n_procs: int = 3
    crash_p: float = 0.1
    n_keys: int = 2  # list-append bases are multi-key (txn tier)
    bases_per_family: int = 4
    service_url: Optional[str] = None
    max_inflight: int = 64
    #: device of the in-process service, a name or a torch.device
    #: (None: the card)
    device: object = None


@dataclass
class _Candidate:
    sc: Scenario
    fingerprint: str
    fitness: float = 0.0
    invalid: bool = False
    rows: list = field(default_factory=list)
    txn: Optional[dict] = None


class SearchDriver:
    """One search run. Owns its CheckingService unless given a
    `service` (in-process) or a `SearchConfig.service_url` (a real
    graftd daemon over HTTP / unix socket, binary frames for the
    non-transactional workloads)."""

    def __init__(self, config: SearchConfig, service=None):
        self.config = config
        self.corpus = Corpus(config.corpus_dir)
        self._service = service
        self._client = None
        self._owns_service = service is None and config.service_url is None
        self.found_regions: set = set()
        self._anchors: List[_Candidate] = []
        self._rr = -1
        self.op_stats: dict = {}  # name -> [uses, invalids, fitness_sum]
        self.generation_stats: List[dict] = []
        self.unconfirmed = 0
        self.dedup_skips = 0
        self.candidates_evaluated = 0

    # ------------------------------------------------------------ seeds

    def base_scenarios(self) -> List[Scenario]:
        c = self.config
        out = []
        for fam in c.families:
            for i in range(c.bases_per_family):
                out.append(Scenario(
                    family=fam, seed=c.seed * 1000 + i, n_ops=c.n_ops,
                    n_procs=c.n_procs, crash_p=c.crash_p,
                    n_keys=c.n_keys if fam == "list-append" else 1))
        return out

    # ------------------------------------------------------- evaluation

    def _ensure_service(self):
        if self._service is None and self._owns_service:
            from ..service.daemon import CheckingService

            self._service = CheckingService(
                store_root=None,
                queue_capacity=max(256, 4 * self.config.population),
                batch_wait=0.02, device=self.config.device)
        if self._client is None and self.config.service_url:
            from ..service.client import ServiceClient

            self._client = ServiceClient(self.config.service_url)

    def close(self):
        if self._owns_service and self._service is not None:
            self._service.shutdown(wait=True)
            self._service = None
        if self._client is not None:
            self._client.close()
            self._client = None

    def _evaluate(self, cands: List[_Candidate]) -> None:
        """Submit every candidate, then wait — all in flight before the
        first wait so graftd's cross-request coalescing sees the whole
        population at once."""
        self._ensure_service()
        for chunk_start in range(0, len(cands), self.config.max_inflight):
            chunk = cands[chunk_start:chunk_start + self.config.max_inflight]
            if self._client is not None:
                self._eval_http(chunk)
            else:
                self._eval_inproc(chunk)
        for c in cands:
            self.candidates_evaluated += 1
            c.fitness = score_candidate(c.rows, c.txn)
            c.invalid = any(r.get("valid?") is INVALID for r in c.rows) or \
                bool(c.txn and c.txn.get("valid?") is INVALID)

    def _eval_inproc(self, chunk: List[_Candidate]) -> None:
        reqs = []
        for c in chunk:
            reqs.append(self._service.submit(
                [materialize(c.sc)], workload=c.sc.family,
                consistency=self.config.consistency))
        for c, req in zip(chunk, reqs):
            req.wait(_EVAL_TIMEOUT_S)
            _require_done(req.status, req.error, req.id)
            c.rows = list(req.results)
            c.txn = req.txn_anomalies

    def _eval_http(self, chunk: List[_Candidate]) -> None:
        recs = []
        for c in chunk:
            binary = c.sc.family not in _TXN_WORKLOADS
            recs.append(self._client.submit(
                [materialize(c.sc)], workload=c.sc.family,
                consistency=self.config.consistency, binary=binary))
        deadline = time.monotonic() + _EVAL_TIMEOUT_S
        for c, rec in zip(chunk, recs):
            # a submit answer carries results only on a cache hit: one
            # that says "done" without them (the check finished before
            # the answer was written) is polled for them too
            while "results" not in rec \
                    and rec["status"] not in ("failed", "cancelled") \
                    and time.monotonic() < deadline:
                rec = self._client.result(rec["id"], wait_s=10.0)
            _require_done(rec["status"], rec.get("error"), rec["id"])
            c.rows = list(rec["results"])
            c.txn = rec.get("txn-anomalies")

    # -------------------------------------------------------- selection

    def _pick_parent(self, rng: random.Random,
                     pool: List[_Candidate]) -> _Candidate:
        """Parent pool = base anchors (never evicted — every region
        stays reachable for the whole run) + the survivor pool.

        Guided splits its draws between coverage and exploitation:
        half round-robin over the anchors of regions with NO archived
        violation yet, half fitness-weighted over survivors in live
        regions. Random draws uniformly over the same structural pool
        and retires nothing — the ablation arm reads no feedback."""
        full = self._anchors + pool
        if not self.config.guided:
            return full[rng.randrange(len(full))]
        open_anchors = [c for c in self._anchors
                        if c.sc.region not in self.found_regions]
        live = [c for c in full if c.sc.region not in self.found_regions] \
            or full
        if open_anchors and (rng.random() < 0.7 or len(live) == 0):
            self._rr += 1
            return open_anchors[self._rr % len(open_anchors)]
        # fitness-weighted (shifted so zero-fitness pools stay uniform)
        weights = [0.25 + c.fitness for c in live]
        total = sum(weights)
        x = rng.random() * total
        for c, w in zip(live, weights):
            x -= w
            if x <= 0:
                return c
        return live[-1]

    def _pick_operator(self, rng: random.Random,
                       ops: Sequence[Operator]) -> Operator:
        if not self.config.guided:
            return ops[rng.randrange(len(ops))]
        weights = []
        for op in ops:
            uses, inv, gain = self.op_stats.get(op.name, (0, 0, 0.0))
            yield_w = (4.0 * inv + gain) / uses if uses else 0.0
            weights.append(0.5 + yield_w)
        total = sum(weights)
        x = rng.random() * total
        for op, w in zip(ops, weights):
            x -= w
            if x <= 0:
                return op
        return ops[-1]

    def _note_yield(self, op_name: str, child: _Candidate,
                    parent: _Candidate) -> None:
        uses, inv, gain = self.op_stats.get(op_name, (0, 0, 0.0))
        self.op_stats[op_name] = (
            uses + 1, inv + (1 if child.invalid else 0),
            gain + max(0.0, child.fitness - parent.fitness))

    # -------------------------------------------------------------- run

    def run(self, seeds: Optional[List[Scenario]] = None) -> dict:
        c = self.config
        arm = "guided" if c.guided else "random"
        rng = random.Random(f"search:{c.seed}:{arm}")
        t_wall = time.monotonic()
        t_cpu = time.process_time()
        saved_autotune = os.environ.get("JGRAFT_AUTOTUNE")
        os.environ["JGRAFT_AUTOTUNE"] = "0"  # deterministic tier routing
        try:
            return self._run(rng, seeds, t_wall, t_cpu)
        finally:
            if saved_autotune is None:
                os.environ.pop("JGRAFT_AUTOTUNE", None)
            else:
                os.environ["JGRAFT_AUTOTUNE"] = saved_autotune
            if self._owns_service:
                self.close()

    def _run(self, rng: random.Random, seeds: Optional[List[Scenario]],
             t_wall: float, t_cpu: float) -> dict:
        c = self.config
        bases = list(seeds) if seeds else self.base_scenarios()
        self._anchors = [_Candidate(sc, scenario_fingerprint(
            sc, c.consistency)) for sc in bases]
        self._rr = -1
        seen = {cand.fingerprint for cand in self._anchors}
        self._evaluate(self._anchors)
        self._archive(self._anchors, generation=0)
        pool: List[_Candidate] = []
        for gen in range(1, c.generations + 1):
            if c.guided and self._anchors and all(
                    a.sc.region in self.found_regions
                    for a in self._anchors):
                # coverage complete: every seeded region has an archived,
                # re-verified violation. Only the guided arm can know
                # this — stopping here is verdict feedback earning CPU,
                # exactly what the ablation measures.
                break
            children: List[_Candidate] = []
            attributions = []
            # exactly `population` mutation attempts per generation for
            # BOTH arms — duplicates burn their slot (dedup-skips), so
            # the ablation comparison is per-candidate-budget fair
            for _ in range(c.population):
                parent = self._pick_parent(rng, pool)
                ops = operators_for(parent.sc.family)
                op = self._pick_operator(rng, ops)
                child_sc = mutate(parent.sc, op, rng.randrange(c.edit_space))
                fp = scenario_fingerprint(child_sc, c.consistency)
                if fp in seen:
                    self.dedup_skips += 1
                    continue
                seen.add(fp)
                cand = _Candidate(child_sc, fp)
                children.append(cand)
                attributions.append((op.name, cand, parent))
            self._evaluate(children)
            for op_name, cand, parent in attributions:
                self._note_yield(op_name, cand, parent)
            found = self._archive(children, generation=gen)
            pool = self._select(rng, pool, children)
            fits = sorted(ch.fitness for ch in children) or [0.0]
            self.generation_stats.append({
                "generation": gen,
                "candidates": len(children),
                "invalid": sum(1 for ch in children if ch.invalid),
                "archived": found,
                "corpus": len(self.corpus),
                "fitness-mean": round(sum(fits) / len(fits), 4),
                "fitness-max": round(fits[-1], 4),
                "fitness-p50": round(fits[len(fits) // 2], 4),
            })
        return self._report(t_wall, t_cpu, bases)

    def _select(self, rng: random.Random, pool: List[_Candidate],
                children: List[_Candidate]) -> List[_Candidate]:
        c = self.config
        merged = pool + children
        if c.guided:
            merged.sort(key=lambda x: -x.fitness)  # stable: ties keep age
            return merged[:c.survivors]
        return [merged[rng.randrange(len(merged))]
                for _ in range(min(c.survivors, len(merged)))]

    def _archive(self, cands: List[_Candidate], generation: int) -> int:
        added = 0
        for cand in cands:
            if not cand.invalid:
                continue
            entry = build_entry(cand.sc, cand.fingerprint, cand.rows,
                                cand.txn, materialize(cand.sc), generation,
                                cand.fitness, self.config.consistency)
            if entry is None:
                self.unconfirmed += 1
                continue
            if self.corpus.add(entry):
                added += 1
            if self.config.guided:
                self.found_regions.add(cand.sc.region)
        return added

    def _report(self, t_wall: float, t_cpu: float,
                bases: List[Scenario]) -> dict:
        c = self.config
        fits = sorted(g["fitness-mean"] for g in self.generation_stats) \
            or [0.0]
        return {
            "arm": "guided" if c.guided else "random",
            "seed": c.seed,
            "families": list(c.families),
            "generations": len(self.generation_stats),
            "population": c.population,
            "candidates": self.candidates_evaluated,
            "dedup-skips": self.dedup_skips,
            "bases": len(bases),
            "corpus": len(self.corpus),
            "corpus-fingerprints": sorted(self.corpus.fingerprints()),
            "found-regions": sorted(map(list, self.found_regions)),
            "unconfirmed": self.unconfirmed,
            "fitness": {"mean": round(sum(fits) / len(fits), 4),
                        "max": round(fits[-1], 4),
                        "p50": round(fits[len(fits) // 2], 4)},
            "per-generation": self.generation_stats,
            "wall_s": round(time.monotonic() - t_wall, 3),
            "cpu_s": round(time.process_time() - t_cpu, 3),
        }
