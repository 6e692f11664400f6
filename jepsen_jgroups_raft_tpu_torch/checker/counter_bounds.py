"""Interval (bounds) counter checker — the sound, never-gives-up tier.

A copy of the reference's `checker/counter_bounds.py` (host Python; the
port's recorded-run re-check, `checker/recorded.py`, sends its counter
UNKNOWNs here, as the reference's does).

Jepsen's library ships `checker/counter` as THE stock counter checker:
every read must fall within [sum of definitely-applied deltas, sum of
possibly-applied deltas] over the read's own duration. It is weaker
than linearizability (order-blind) but SOUND in the direction that
matters: a bounds violation is a real consistency bug under any
linearization, and bounds-validity is the certificate jepsen itself
accepts for counters.

Here it backs the exact engines rather than replacing them
(workload/counter.py CounterChecker): the reference's hand-written
knossos CounterModel (counter.clj:100-127) — which our Counter model
mirrors — becomes infeasible at the canonical envelope (60-90 s,
concurrency 100 hell runs pile up thousands of crashed adds, so the
concurrency window dwarfs every frontier/DFS budget and the exact
verdict is UNKNOWN; the reference community's own stance is
"unfeasible to verify", doc/intro.md:35-41). Instead of stopping at
UNKNOWN, the run is decided at the interval tier and labeled with the
weaker certificate — strictly more evidence than the reference
produces at the same scale.

Negative deltas (the reference's decrement maps to a negated add,
counter.clj:56-59) mirror the bounds: a possibly-applied negative
delta lowers `lo`, a definite one raises... lowers `hi`. All widening
is monotone toward soundness: transient possibilities (e.g. a failed
add's window) stay inside open readers' extremes.
"""

from __future__ import annotations

from typing import Optional

from ..history.ops import FAIL, INFO, INVOKE, OK, History
from .base import Checker, UNKNOWN


def _signed_delta(op) -> Optional[int]:
    """Signed delta of an add-family op at INVOKE time, else None."""
    f = op.f
    if f in ("add", "add-and-get"):
        return int(op.value)
    if f in ("decr", "decr-and-get"):
        return -int(op.value)
    return None


def interval_check(history: History) -> dict:
    """Sound bounds check of a counter history.

    Walks ops in real-time order maintaining the possible value range
    [lo, hi]; each read (and each add-and-get's implied pre-state
    observation) must fall within the range's envelope OVER ITS OWN
    SPAN — checking against the instantaneous range at completion
    would false-flag a read that linearized before a concurrent add
    completed mid-span.
    """
    lo = hi = 0
    # process -> [lo_min, hi_max] envelope since the observer's invoke
    open_obs: dict = {}

    def widen() -> None:
        for env in open_obs.values():
            if lo < env[0]:
                env[0] = lo
            if hi > env[1]:
                env[1] = hi

    reads = 0
    for idx, op in enumerate(history):
        f = op.f
        is_obs = f in ("read", "get", "add-and-get", "decr-and-get")
        if op.type == INVOKE:
            sd = _signed_delta(op)
            if sd is not None:  # possibly applied from invocation on
                if sd > 0:
                    hi += sd
                else:
                    lo += sd
                widen()
            if is_obs:
                open_obs[op.process] = [lo, hi]
        elif op.type == OK:
            env = open_obs.pop(op.process, [lo, hi])
            if f in ("read", "get"):
                v = int(op.value)
                reads += 1
                if not env[0] <= v <= env[1]:
                    return {
                        "valid?": False,
                        "checker": "counter-interval",
                        "error": f"read {v} outside possible range "
                                 f"[{env[0]}, {env[1]}]",
                        "op-index": idx,
                    }
            elif f in ("add-and-get", "decr-and-get"):
                delta, new = op.value
                sd = delta if f == "add-and-get" else -delta
                pre = int(new) - sd
                reads += 1
                # Own delta already widened one side at invoke; the
                # pre-state bound is checked against the (thus slightly
                # wide) envelope — monotone toward soundness.
                if not env[0] <= pre <= env[1]:
                    return {
                        "valid?": False,
                        "checker": "counter-interval",
                        "error": f"add-and-get observed {new} (pre-state "
                                 f"{pre}) outside possible range "
                                 f"[{env[0]}, {env[1]}]",
                        "op-index": idx,
                    }
                # ...and the delta is now definite.
                if sd > 0:
                    lo += sd
                else:
                    hi += sd
                widen()
            if f in ("add", "decr"):
                sd = _signed_delta(op)
                if sd > 0:
                    lo += sd
                else:
                    hi += sd
                widen()
        elif op.type == FAIL:
            open_obs.pop(op.process, None)
            sd = _signed_delta(op)
            if sd is not None:  # definitely never applied: retract the
                if sd > 0:      # possibility (open envelopes keep the
                    hi -= sd    # transient — sound, wider)
                else:
                    lo -= sd
        elif op.type == INFO:
            # Crashed: may or may not have applied, forever — the
            # possibility stays in the range. Observers: no constraint.
            open_obs.pop(op.process, None)
    return {"valid?": True, "checker": "counter-interval",
            "reads-checked": reads, "final-range": [lo, hi]}


def decide_unknown_with_interval(exact_result: dict,
                                 history: History) -> dict:
    """Decide an exact-UNKNOWN counter verdict at the interval tier,
    labeling the weaker certificate and attaching the exhausted exact
    attempt. Shared by the live workload checker (CounterChecker) and
    the recorded-store re-check path so the two produce the same
    results.json shape."""
    b = interval_check(history)
    b["certificate"] = "interval"
    b["exact"] = {k: v for k, v in exact_result.items() if k != "valid?"}
    b["note"] = ("exact engines exhausted (window beyond budget); "
                 "verdict decided at jepsen checker/counter interval "
                 "semantics")
    return b


class CounterChecker(Checker):
    """Exact linearizability first; the interval tier decides UNKNOWNs.

    The composed verdict is never UNKNOWN: exact verdicts pass through
    untouched; an exact-UNKNOWN (window beyond every engine's budget —
    the canonical-envelope counter shape) is decided by the bounds
    check and labeled ``certificate: interval`` so the weaker evidence
    is visible in results.json.
    """

    def __init__(self, exact: Checker):
        self.exact = exact

    def check(self, test, history, opts=None) -> dict:
        r = self.exact.check(test, history, opts)
        if r.get("valid?") is not UNKNOWN:
            return r
        if not isinstance(history, History):
            history = History(history)
        return decide_unknown_with_interval(r, history.client_ops())
