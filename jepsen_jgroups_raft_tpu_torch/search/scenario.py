"""Scenario genomes: deterministic generation + edit replay (a copy of
the reference's `search/scenario.py`).

A Scenario is a frozen genome — generation parameters plus an ordered
chain of (operator-name, edit-seed) history edits. `materialize` is a
pure function of the genome: the base history comes from
`history/synth.random_valid_history` under a seed derived from
(family, seed), nemesis params are folded in via
`nemesis/package.schedule_pressure`, and each edit replays under its
own derived RNG. Same genome ⇒ same bytes ⇒ same admission
fingerprint — that identity is what makes the corpus reproducible, and
since the fingerprint hashes under the algorithm name "auto", which
both packages share, the port's fingerprints equal the reference's.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

from ..history.ops import INFO, INVOKE, OK, History
from ..history.synth import build_history, random_valid_history
from ..nemesis.package import schedule_pressure
from .operators import REGISTRY, Operator, apply_history_op

#: genome fields a "params" operator may rewrite
PARAM_FIELDS = ("n_ops", "n_procs", "value_range", "crash_p", "n_keys",
                "nemesis", "interval")


@dataclass(frozen=True)
class Scenario:
    family: str
    seed: int
    n_ops: int = 24
    n_procs: int = 3
    value_range: int = 3
    crash_p: float = 0.15
    n_keys: int = 1
    nemesis: str = "none"
    interval: float = 5.0
    #: ordered (operator-name, edit-seed) chain, replayed at materialize
    edits: Tuple[Tuple[str, int], ...] = field(default_factory=tuple)

    @property
    def region(self) -> Tuple[str, int]:
        """The (family, base-seed) pocket this genome explores — param
        and history edits stay inside the region."""
        return (self.family, self.seed)

    def to_dict(self) -> dict:
        return {
            "family": self.family, "seed": self.seed, "n_ops": self.n_ops,
            "n_procs": self.n_procs, "value_range": self.value_range,
            "crash_p": self.crash_p, "n_keys": self.n_keys,
            "nemesis": self.nemesis, "interval": self.interval,
            "edits": [list(e) for e in self.edits],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        d["edits"] = tuple((str(n), int(s)) for n, s in d.get("edits", ()))
        return cls(**d)


def mutate(sc: Scenario, op: Operator, edit_seed: int) -> Scenario:
    """One mutation step: params operators rewrite the genome now;
    history operators append to the edit chain (replayed lazily)."""
    if op.target == "params":
        params = {f: getattr(sc, f) for f in PARAM_FIELDS}
        params = op.fn(random.Random(f"param:{op.name}:{edit_seed}"), params)
        return replace(sc, **params)
    return replace(sc, edits=sc.edits + ((op.name, edit_seed),))


def _multi_key_list_append(rng: random.Random, n_ops: int, n_procs: int,
                           n_keys: int, crash_p: float,
                           max_crashes: int) -> History:
    """Serial (valid-by-construction) multi-key list-append history with
    (key, value) tuples — the service's independent list-append workload
    splits it per key at admission; the anomaly rung reads the session
    order across keys. Crashed processes retire under fresh ids, same
    as the single-key generator."""
    keys = ["k%d" % i for i in range(max(1, n_keys))]
    state = {k: [] for k in keys}
    nxt = {k: 1 for k in keys}
    rows = []
    crashes = 0
    free = list(range(n_procs))
    next_pid = n_procs
    for _ in range(n_ops):
        p = free.pop(rng.randrange(len(free)))
        k = rng.choice(keys)
        if nxt[k] <= 6 and rng.random() < 0.6:
            f, elem = "append", nxt[k]
            nxt[k] += 1
            inv_val = (k, elem)
        else:
            f, inv_val = "read", (k, None)
        rows.append((p, INVOKE, f, inv_val))
        if f == "append":
            state[k] = state[k] + [elem]
        if crashes < max_crashes and rng.random() < crash_p:
            crashes += 1
            free.append(next_pid)
            next_pid += 1
            if rng.random() < 0.5:
                rows.append((p, INFO, f, inv_val))
        else:
            rows.append((p, OK, f, (k, list(state[k]))))
            free.append(p)
    return build_history(rows)


def materialize(sc: Scenario) -> History:
    """Genome → history, deterministically. Edits whose operator is
    inapplicable on the current base are deterministic no-ops (the
    genome still counts them — fingerprint dedup collapses the
    duplicates)."""
    pressure = schedule_pressure(sc.nemesis, sc.interval)
    crash_p = min(0.6, sc.crash_p + pressure["crash_bias"])
    max_crashes = sc.n_procs + pressure["crash_burst"]
    rng = random.Random(f"scenario:{sc.family}:{sc.seed}")
    if sc.family == "list-append" and sc.n_keys > 1:
        h = _multi_key_list_append(rng, sc.n_ops, sc.n_procs, sc.n_keys,
                                   crash_p, max_crashes)
    else:
        h = random_valid_history(rng, sc.family, n_ops=sc.n_ops,
                                 n_procs=sc.n_procs,
                                 value_range=sc.value_range,
                                 crash_p=crash_p, max_crashes=max_crashes)
    for name, edit_seed in sc.edits:
        op = REGISTRY[name]
        out = apply_history_op(
            op, random.Random(f"edit:{name}:{edit_seed}"), h)
        if out is not None:
            h = out
    return h


def scenario_workload(sc: Scenario) -> str:
    """Service workload name for this genome (family names match)."""
    return sc.family


def scenario_fingerprint(sc: Scenario,
                         consistency: str = "linearizable",
                         hist: Optional[History] = None) -> str:
    """The ADMISSION fingerprint of the materialized history — the same
    content hash graftd's result store dedupes on, so the search corpus
    and the service cache agree on candidate identity."""
    from ..history.packing import encode_history
    from ..service.request import build_units, fingerprint_encodings

    h = materialize(sc) if hist is None else hist
    model, units = build_units([h], scenario_workload(sc))
    encs = [encode_history(u, model) for _, u in units]
    return fingerprint_encodings(model, "auto", encs, consistency)
