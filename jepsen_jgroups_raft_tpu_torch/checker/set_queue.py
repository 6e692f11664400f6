"""Derived (non-search) verdicts for the set and queue scenarios.

A copy of the reference's `checker/set_queue.py` (host Python).

Jepsen pairs its set/queue workloads with cheap whole-history analyses
beside the expensive order-sensitive checker — `checker/set-full`'s
lost/stale elements, `checker/total-queue`'s conservation laws. These
are linear scans: they cannot replace the frontier search (they ignore
op order), but they answer the operator's first question — *what was
lost, exactly?* — and they stay cheap at production scale.

`SetAnalysis` (grow-only set, workload/set.py):
  * lost      — element whose add completed ok BEFORE the final read
                was invoked, yet absent from that read. Real-time
                ordering makes this a definite data-loss witness.
  * stale     — element observed by an earlier read, absent from a
                later read that began after the earlier one completed:
                a grow-only set moved backwards.
  * recovered — info (indefinite) adds that nevertheless appear in the
                final read — the honest-indefiniteness bookkeeping.

`QueueConservation` (ticket FIFO, workload/queue.py):
  * double-delivery — a ticket dequeued ok more than once.
  * phantom         — a ticket dequeued ok that no enqueue (ok or info)
                      could have produced (beyond the issued range).
  * lost            — a ticket from an ok enqueue never dequeued ok
                      although dequeues drained past it... is NOT
                      derivable order-free; what IS sound is range
                      accounting: ok-dequeues ≤ ok+info enqueues. The
                      order-sensitive FIFO property itself belongs to
                      the TicketQueue frontier model.

Both attach counts and the offending element/ticket lists, so a `fail`
carries its evidence inline (the linearizable checker's counterexample
minimization covers the order-sensitive side).
"""

from __future__ import annotations

from ..history.ops import History, pair_ops_indexed
from .base import Checker, INVALID, VALID


class SetAnalysis(Checker):
    """Lost/stale-element analysis for the grow-only set workload."""

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        ops = list(history.client_ops())
        adds_ok: dict = {}    # element -> completion position
        adds_info: set = set()
        attempts = 0
        reads = []            # (invoke_pos, completion_pos, frozenset)
        for ip, cp, inv, comp in pair_ops_indexed(ops):
            ctype = comp.type if comp is not None else "info"
            if inv.f == "add":
                attempts += 1
                e = int(inv.value)
                if ctype == "ok":
                    # EARLIEST completion per element: lost-ness keys on
                    # "some ack landed before the final read began", so
                    # a later duplicate add must not mask an earlier ack
                    # (pairs arrive in invoke order, not completion
                    # order).
                    adds_ok[e] = min(adds_ok.get(e, cp), cp)
                elif ctype == "info":
                    adds_info.add(e)
            elif inv.f == "read" and ctype == "ok":
                elems = comp.value
                if isinstance(elems, int):
                    elems = [i for i in range(32) if (elems >> i) & 1]
                reads.append((ip, cp, frozenset(int(e) for e in elems)))
        if not reads:
            return {"valid?": VALID, "attempt-count": attempts,
                    "ok-count": len(adds_ok), "read-count": 0,
                    "note": "no completed reads — nothing to compare"}
        final = max(reads, key=lambda r: r[1])
        lost = sorted(e for e, cpos in adds_ok.items()
                      if cpos < final[0] and e not in final[2])
        # stale: sweep reads by invoke order; `settled` holds elements
        # some read completed observing before this read began — a
        # grow-only set must keep showing them. One incremental union
        # over a completion-ordered pointer keeps the scan O(R log R).
        stale: set = set()
        by_completion = sorted(reads, key=lambda r: r[1])
        settled: set = set()
        done = 0
        for ip, cp, elems in sorted(reads):
            while done < len(by_completion) and \
                    by_completion[done][1] < ip:
                settled |= by_completion[done][2]
                done += 1
            stale |= settled - elems
        recovered = sorted(adds_info & final[2])
        valid = not lost and not stale
        out = {
            "valid?": VALID if valid else INVALID,
            "attempt-count": attempts,
            "ok-count": len(adds_ok),
            "read-count": len(reads),
            "lost": lost,
            "stale": sorted(stale),
            "recovered": recovered,
            "final-read-size": len(final[2]),
        }
        if not valid:
            out["explanation"] = (
                f"grow-only set lost {len(lost)} and un-grew "
                f"{len(stale)} element(s): lost={lost} "
                f"stale={sorted(stale)}")
        return out


class QueueConservation(Checker):
    """Order-free conservation laws for the ticket-FIFO workload."""

    def check(self, test, history, opts=None) -> dict:
        if not isinstance(history, History):
            history = History(history)
        ops = list(history.client_ops())
        enq_ok: set = set()
        enq_attempts = 0
        enq_info = 0
        deq_counts: dict = {}
        empties = 0
        for ip, cp, inv, comp in pair_ops_indexed(ops):
            ctype = comp.type if comp is not None else "info"
            if inv.f == "enqueue":
                enq_attempts += 1
                if ctype == "ok":
                    enq_ok.add(int(comp.value))
                elif ctype == "info":
                    enq_info += 1
            elif inv.f == "dequeue" and ctype == "ok":
                if comp.value is None:
                    empties += 1
                else:
                    t = int(comp.value)
                    deq_counts[t] = deq_counts.get(t, 0) + 1
        double = sorted(t for t, n in deq_counts.items() if n > 1)
        issued = len(enq_ok) + enq_info  # upper bound on real tickets
        phantom = sorted(t for t in deq_counts
                         if t not in enq_ok and t >= issued)
        valid = not double and not phantom
        out = {
            "valid?": VALID if valid else INVALID,
            "enqueue-attempts": enq_attempts,
            "enqueue-ok": len(enq_ok),
            "enqueue-info": enq_info,
            "dequeue-ok": sum(deq_counts.values()),
            "dequeue-empty": empties,
            "double-delivery": double,
            "phantom": phantom,
        }
        if not valid:
            out["explanation"] = (
                f"queue conservation violated: double-delivery={double} "
                f"phantom={phantom}")
        return out
