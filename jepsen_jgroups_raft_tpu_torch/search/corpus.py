"""Content-addressed search corpus (a copy of the reference's
`search/corpus.py`; entries are the reference's bytes, so a corpus
written by either package loads and re-verifies in the other).

Survivor violations live under ``<root>/corpus/<fp[:2]>/<fp>.json``,
keyed by the ADMISSION fingerprint (the same content hash the graftd
result store dedupes on), written temp + os.replace so a crashed search
never publishes a torn entry.

Every entry is MINIMIZED before archive (`checker/counterexample.py`):
the corpus is a regression suite the fleet replays forever, so each
entry should be the smallest witness of its violation, not the raw
mutant — a 6-op reproducer re-checks in microseconds on the cheap tier
and its failure mode is human-readable, where the 40-op original would
pay kernel admission on every replay and bury the witness. Archive
refuses entries whose minimized ops do not re-verify INVALID (that
would mean the minimizer returned a non-witness — a corpus poisoned
with passing entries is worse than no corpus).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Iterator, List, Optional

from ..checker.base import INVALID
from ..history.ops import History, Op


class Corpus:
    """Fingerprint-deduped violation archive."""

    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, "corpus")
        os.makedirs(self.dir, exist_ok=True)
        self._fps = set()
        for sub in sorted(os.listdir(self.dir)):
            subdir = os.path.join(self.dir, sub)
            if os.path.isdir(subdir):
                for name in os.listdir(subdir):
                    if name.endswith(".json"):
                        self._fps.add(name[:-5])

    def __len__(self) -> int:
        return len(self._fps)

    def __contains__(self, fp: str) -> bool:
        return fp in self._fps

    def fingerprints(self) -> set:
        return set(self._fps)

    def _path(self, fp: str) -> str:
        return os.path.join(self.dir, fp[:2], fp + ".json")

    def add(self, entry: dict) -> bool:
        """Archive one entry keyed by entry['fingerprint']; False when a
        same-fingerprint entry already exists (dedup, not an error)."""
        fp = entry["fingerprint"]
        if fp in self._fps:
            return False
        path = self._path(fp)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".corpus-", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(entry, f, sort_keys=True, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._fps.add(fp)
        return True

    def load(self, fp: str) -> dict:
        with open(self._path(fp)) as f:
            return json.load(f)

    def entries(self) -> Iterator[dict]:
        for fp in sorted(self._fps):
            yield self.load(fp)


def _history_from_views(views: List[dict]) -> History:
    """Rebuild a checkable unit history from archived op views
    (`counterexample._op_view` shape — values keep their in-memory
    types because the corpus never crosses a JSON tuple boundary at
    re-verify time: tuples arrive as lists and the models treat the
    add-and-get pair positionally)."""
    h = History()
    for v in views:
        val = v.get("value")
        if isinstance(val, list) and v.get("f") == "add-and-get":
            val = tuple(val)
        h.append(Op(process=v["process"], type=v["type"], f=v["f"],
                    value=val))
    return h


def reverify_entry(entry: dict) -> bool:
    """Re-check an archived entry's minimized ops: still INVALID?
    Runs the exact host checker (no kernels — corpus replay must work
    on a bare CPU box, so the device is the host's by design, not by
    fallback) at the entry's rung; transactional-overlay entries replay
    through the anomaly certifier instead."""
    from ..checker.linearizable import check_histories
    from ..service.request import service_workloads

    if entry.get("kind") == "txn":
        from ..checker.anomaly import certify_history

        h = _history_from_views(entry["txn-ops"])
        # archived tuples arrive as lists; the anomaly graph needs
        # (key, value) pairs back
        for op in h:
            if isinstance(op.value, list) and len(op.value) == 2 and \
                    isinstance(op.value[0], str):
                op.value = tuple(op.value)
        return certify_history(h, kernel=False)["valid?"] is False
    model_factory, _ = service_workloads()[entry["family"]]
    for unit in entry["units"]:
        h = _history_from_views(unit["ops"])
        res = check_histories([h], model_factory(), algorithm="cpu",
                              device="cpu",
                              consistency=entry.get("consistency",
                                                    "linearizable"))[0]
        if res["valid?"] is INVALID:
            return True
    return False


def build_entry(sc, fingerprint: str, rows: List[dict],
                txn: Optional[dict], hist: History,
                generation: int, fitness: float,
                consistency: str = "linearizable") -> Optional[dict]:
    """Minimize an INVALID candidate and shape its corpus entry; None
    when nothing minimizes to a confirmed witness (the caller counts
    that as `unconfirmed`, it must never be archived)."""
    from ..checker.counterexample import attach_counterexample
    from ..service.request import build_units

    model, units = build_units([hist], sc.family)
    unit_views = []
    for (label, uh), row in zip(units, rows):
        if row.get("valid?") is not INVALID:
            continue
        r = dict(row)
        ce = r.get("counterexample") or {}
        if not ce.get("minimal-ops"):
            attach_counterexample(r, uh, model, consistency=consistency)
            ce = r.get("counterexample") or {}
        ops = ce.get("minimal-ops")
        minimized = ops is not None
        if ops is None:
            ops = [{"index": i, "process": o.process, "type": o.type,
                    "f": o.f, "value": o.value} for i, o in enumerate(uh)]
        unit_views.append({"label": label, "ops": ops,
                           "op-count": ce.get("minimal-op-count",
                                              r.get("op-count")),
                           "minimized": minimized})
    entry = {
        "fingerprint": fingerprint,
        "family": sc.family,
        "region": list(sc.region),
        "scenario": sc.to_dict(),
        "chain": [list(e) for e in sc.edits],
        "generation": generation,
        "fitness": round(fitness, 4),
        "consistency": consistency,
        "kind": "lin",
        "units": unit_views,
    }
    if not unit_views:
        if not (txn and txn.get("valid?") is False):
            return None
        # anomaly-overlay violation: every per-key unit passed its rung,
        # the cross-key txn graph is the witness — archive the full
        # (tupled) history for the certifier to replay
        entry["kind"] = "txn"
        entry["txn-ops"] = [{"index": i, "process": o.process,
                             "type": o.type, "f": o.f, "value": o.value}
                            for i, o in enumerate(hist)]
        entry["anomalies"] = sorted(
            k for per in txn.get("histories", [])
            for k, w in (per.get("anomalies") or {}).items()
            if w is not None)
    if not reverify_entry(entry):
        return None
    return entry
