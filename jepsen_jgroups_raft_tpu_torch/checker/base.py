"""Checker protocol and composition.

Equivalent of jepsen.checker/Checker + checker/compose
(reference raft.clj:73-77). A checker examines a completed history and
returns a map with at least ``valid?``, which is True, False, or
``"unknown"`` (e.g. the search exceeded its budget). Composition ANDs
validity: any False → False; else any unknown → unknown; else True.
"""

from __future__ import annotations

from typing import Dict

VALID = True
INVALID = False
UNKNOWN = "unknown"


class Checker:
    def check(self, test: dict, history, opts: dict | None = None) -> dict:
        raise NotImplementedError


class ComposedChecker(Checker):
    def __init__(self, checkers: Dict[str, Checker]):
        self.checkers = dict(checkers)

    def check(self, test, history, opts=None) -> dict:
        results = {}
        for name, c in self.checkers.items():
            try:
                results[name] = c.check(test, history, opts or {})
            except Exception as e:  # a crashing checker must not eat a run
                results[name] = {
                    "valid?": UNKNOWN,
                    "error": f"checker raised: {e!r}",
                }
        return {"valid?": merge_valid(r.get("valid?") for r in results.values()),
                **results}


def compose(checkers: Dict[str, Checker]) -> ComposedChecker:
    return ComposedChecker(checkers)


def merge_valid(vs) -> object:
    out = VALID
    for v in vs:
        if v is INVALID:
            return INVALID
        if v is not VALID:
            out = UNKNOWN
    return out
