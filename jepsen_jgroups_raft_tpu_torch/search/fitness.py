"""Fitness from signals every verdict already carries (a copy of the
reference's `search/fitness.py`).

No new instrumentation: the score reads fields graftd's demux already
attaches to every result row. Mapping (doc/checker-design.md §22):

  signal                          reading                     weight
  ------------------------------  --------------------------  ------
  decided-tier                    distance from the cheap     0–1
                                  tiers (greedy 0, backtrack
                                  0.4, cycle 0.6, kernels/host
                                  1.0 — rows the certifier's
                                  step/abort budgets could not
                                  decide are near the boundary)
  valid? is INVALID               a found violation           +2.0
  valid? is UNKNOWN               undecidable inside budget   +1.5
  counterexample.minimal-op-count smaller minimized witness   +1/(1+n)
                                  = nearer the boundary
  sc-refuted                      cycle tier refuted the       +0.5
                                  stronger rung under a weak-
                                  rung pass
  cycle-skipped-size              txn graph past the node cap  +0.3
  decided-at-segment (stream)     later detection = deeper     +0.5·k/n
                                  pocket
  txn-anomalies overlay           anomaly classes witnessed    +1.0
                                  (+0.5 each extra class)

The kernel tiers (mask/dense/sort/host) collapse to one distance on
purpose: WHICH kernel family decides a row depends on the batch it
coalesced into (bucket shapes are sized to the batch's real maximum),
not on the row itself — scoring them apart would make fitness, and
therefore survivor selection, depend on admission timing and break the
corpus-determinism contract. For the same reason a row decided by a
CUDA kernel on the card scores as the same row decided on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..checker.base import INVALID, UNKNOWN

TIER_DISTANCE = {
    "trivial": 0.0,
    "greedy": 0.0,
    "greedy@lin": 0.0,
    "backtrack": 0.4,
    "backtrack@lin": 0.4,
    "cycle": 0.6,
    "mask": 1.0,
    "dense": 1.0,
    "sort": 1.0,
    "host": 1.0,
    "remote-shard": 1.0,
}

INVALID_BONUS = 2.0
UNKNOWN_BONUS = 1.5


def score_result_row(row: dict) -> float:
    """Fitness contribution of one demuxed result row."""
    s = TIER_DISTANCE.get(row.get("decided-tier"), 1.0)
    v = row.get("valid?")
    if v is INVALID:
        ce = row.get("counterexample") or {}
        n = ce.get("minimal-op-count") or row.get("op-count") or 64
        s += INVALID_BONUS + 1.0 / (1.0 + n)
    elif v is UNKNOWN:
        s += UNKNOWN_BONUS
    if row.get("sc-refuted"):
        s += 0.5
    if row.get("cycle-skipped-size"):
        s += 0.3
    seg = row.get("decided-at-segment")
    segs = row.get("segments") or row.get("segment-count")
    if isinstance(seg, int) and isinstance(segs, int) and segs > 0:
        s += 0.5 * min(1.0, seg / segs)
    return s


def score_txn(txn: Optional[dict]) -> float:
    """Fitness contribution of the admission-time anomaly overlay."""
    if not txn:
        return 0.0
    s = 0.0
    classes = 0
    for per in txn.get("histories", []):
        found = per.get("anomalies") or {}
        classes += sum(1 for w in found.values() if w is not None)
        if per.get("cycle-skipped-size"):
            s += 0.3
    if txn.get("valid?") is INVALID or classes:
        s += 1.0 + 0.5 * max(0, classes - 1)
    return s


def score_candidate(rows: Sequence[dict], txn: Optional[dict] = None) -> float:
    """Candidate fitness: mean per-unit row score (mean, not sum, so a
    multi-key submission isn't fitter merely for having more keys) plus
    the transactional overlay."""
    if not rows:
        return 0.0
    return sum(score_result_row(r) for r in rows) / len(rows) + score_txn(txn)
