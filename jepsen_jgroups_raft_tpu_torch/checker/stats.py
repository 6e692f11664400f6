"""Sanity checkers: op-count stats and unhandled exceptions.

Equivalents of jepsen checker/stats and checker/unhandled-exceptions
(reference raft.clj:75-76). Stats is valid iff every op kind that ran has
at least one ok (jepsen's rule); exceptions reports error kinds seen.
"""

from __future__ import annotations

from collections import Counter as TallyCounter

from ..history.ops import FAIL, INFO, INVOKE, OK, History
from .base import Checker


class StatsChecker(Checker):
    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        by_f: dict = {}
        for op in history.client_ops():
            if op.type == INVOKE:
                continue
            t = by_f.setdefault(op.f, TallyCounter())
            t[op.type] += 1
        result_by_f = {
            f: {
                "count": sum(t.values()),
                "ok-count": t[OK],
                "fail-count": t[FAIL],
                "info-count": t[INFO],
                "valid?": t[OK] > 0,
            }
            for f, t in by_f.items()
        }
        return {
            "valid?": all(r["valid?"] for r in result_by_f.values()) or not result_by_f,
            **{str(f): r for f, r in result_by_f.items()},
        }


class UnhandledExceptionsChecker(Checker):
    """Tally error annotations on fail/info ops (the analogue of jepsen's
    unhandled-exceptions checker: surface what went wrong, never fail the
    test by itself)."""

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        tally: TallyCounter = TallyCounter()
        for op in history:
            if op.error:
                kind = str(op.error).split(":", 1)[0]
                tally[kind] += 1
        return {"valid?": True, "error-kinds": dict(tally)}
