"""The value-guided witness certifier, at the linearizable rung.

A copy of the part of the reference's checker/consistency.py that the
lin fast path runs: `certify_encoded` builds a linearization witness on
the host in O(events · window), with bounded backtracking, and never
refutes — True is a sound VALID (the committed order respects every
[OPEN, FORCE] interval of the stream), False means undecided and the
kernels answer. `checker/linearizable.lin_fastpath_pass` runs it (through
`checker/certify_batch.certify_many`) before the kernels.

The weaker rungs (stream relaxation, `apply_rung`, the streaming
certifier) come with the rest of the reference's module (ROADMAP A6).
Pure Python and numpy.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

from ..history.packing import EV_FORCE, EV_OPEN, EncodedHistory
from ..platform import env_int


#: Default BASE flip budget for the bounded-backtrack certifier:
#: enough to untangle the mutator ambiguity that defeats the pure
#: greedy scan on the register/cas family (measured: 98/100 seeded
#: 200-op register histories certify under 64 flips where the plain greedy
#: managed 9/100), small enough that an adversarial history cannot
#: turn the cheap tier into a search engine — undecided rows take the
#: exact kernel ladder. The EFFECTIVE per-row budget scales with
#: stream length (`_effective_budget`): wrong turns accumulate
#: linearly with ops, so a flat budget silently starved long histories
#: (1000-op register decided fraction 0.67 flat vs 1.0 scaled,
#: measured at ~equal wall — undecided rows are the expensive ones).
DEFAULT_BACKTRACK_BUDGET = 64

#: Events per base-budget unit in the length scaling.
_BUDGET_SCALE_EVENTS = 256

#: Most-recent choice points kept restorable. Dropping the oldest when
#: the stack outgrows this bounds certifier memory to
#: O(cap · ops/word) regardless of history length; a search that needs
#: deeper backtracking returns undecided (never wrong).
_BACKTRACK_STACK_CAP = 128


def greedy_backtrack_budget() -> int:
    """Resolved BASE flip budget (JGRAFT_GREEDY_BACKTRACK; 0 restores
    the no-backtrack greedy behavior — the ablation arm)."""
    return env_int("JGRAFT_GREEDY_BACKTRACK", DEFAULT_BACKTRACK_BUDGET,
                   minimum=0)


class _AbortBudget(Exception):
    """Internal: the certifier's step-count abort budget ran out.
    Converted to an undecided answer — never a verdict."""


def _effective_budget(base: int, n_events: int) -> int:
    """Per-row budget: the base, scaled linearly past
    `_BUDGET_SCALE_EVENTS` events (64 at ≤256 events, ~448 at a
    2000-event 1000-op register history)."""
    return base * max(1, n_events // _BUDGET_SCALE_EVENTS)


def _value_guide_masks(model, ops, forced):
    """Per-op (enable_mask, observe_mask) bitmasks over the observed
    value domain — GSet's membership-mask encoding trick applied to the
    certifier's choice ordering: `enable_mask[k] & observe_mask[e]`
    answers "can committing k expose a state e observes?" in one AND.
    None when the model lacks the enable/observe hooks, answers None
    for some op, or the domain outgrows the word — the step-lookahead
    fallback then orders candidates instead (exact, just slower)."""
    from ..models.base import EncodedOp

    if not (hasattr(model, "enable_values")
            and hasattr(model, "observe_values")):
        return None
    dom: dict = {}
    em = [0] * len(ops)
    om = [0] * len(ops)
    for k, (f, a, b) in enumerate(ops):
        eo = EncodedOp(f, a, b, forced[k])
        evs = model.enable_values(eo)
        ovs = model.observe_values(eo)
        if evs is None or ovs is None:
            return None
        for vals, masks in ((evs, em), (ovs, om)):
            for v in vals:
                if v not in dom:
                    if len(dom) >= 63:
                        return None
                    dom[v] = len(dom)
                masks[k] |= 1 << dom[v]
    return em, om


def certify_encoded(enc: EncodedHistory, model,
                    budget: Optional[int] = None,
                    max_steps: Optional[int] = None
                    ) -> Tuple[bool, Optional[str], int]:
    """Witness construction on an encoded stream, with value-guided
    bounded backtracking (the widening of a one-pass greedy scan).
    Returns ``(certified, tier, flips)`` — tier "greedy" when
    the first-choice path succeeded, "backtrack" when recovering from
    ``flips`` wrong turns did, None when undecided.

    Commit rules (the greedy scan's rules, now restartable):

      * EAGER observations: a pending READ-ONLY op (an opcode in
        `readonly_fcodes` — never mutates at ANY state) that is legal
        NOW commits immediately — provably lossless: if any witness
        places a read-only op elsewhere, moving it to the current legal
        point yields another witness (the op preserves state), so eager
        commits never foreclose anything and are NOT choice points.
      * LAZY mutations: a state-changing op commits only at its own
        FORCE, or when a forced op needs its effect.
      * CHOICE POINTS: every FORCE of a mutator is a decision — commit
        it directly (when legal), or commit some older pending op first
        and re-try. The pure greedy took the first option and aborted
        on any dead end; this certifier snapshots (pos, state, done)
        per decision and, on a dead end, restores the most recent
        snapshot with untried options — up to ``budget`` flips
        (`JGRAFT_GREEDY_BACKTRACK`), after which it returns undecided.
      * VALUE-GUIDED ordering: candidate commits are ranked by whether
        they can expose a state the blocked op observes (the
        enable/observe bitmask intersection above, confirmed by a
        1-step lookahead; pure lookahead for models without the hooks
        — this is what places a crashed queue landmine ENQ_ANY/DEQ_ANY
        lazily at the first state where it unblocks a forced op), then
        will-be-forced ops before optional crashed ops (known outcomes
        before poison), then open order.

    Soundness is the greedy scan's: True is returned only when a
    complete legal witness respecting every [OPEN, FORCE] interval was
    built, so True is a sound VALID for whatever rung produced the
    stream; False/undecided NEVER refutes — callers fall through to the
    exact kernel ladder (the reference's doc/checker-design.md §15).

    ``max_steps``: an ABORT budget on total `model.step`
    calls. The flip budget bounds backtracking but not the scan's raw
    candidate-enumeration work, so a hopeless row on the linearizable
    fast path could otherwise cost an unbounded fraction of its kernel
    wall; past the budget the row returns undecided (never wrong — the
    kernels answer). None/0 = unbounded, today's exact behavior; the
    lin fast path passes a length-scaled budget
    (JGRAFT_LIN_FASTPATH_ABORT · events, checker/linearizable.py).
    """
    state = model.init_state()
    step = model.step
    if max_steps is not None and max_steps > 0:
        raw_step, left = step, [int(max_steps)]

        def step(s, f, a, b):
            left[0] -= 1
            if left[0] < 0:
                raise _AbortBudget()
            return raw_step(s, f, a, b)
    readonly = frozenset(getattr(model, "readonly_fcodes", ()) or ())
    if budget is None:
        budget = _effective_budget(greedy_backtrack_budget(),
                                   enc.n_events)
    events = enc.events.tolist()
    n_ev = len(events)

    # -- pre-decode: flat op table + per-event (etype, op id) ----------
    ops: List[tuple] = []          # (f, a, b) per op, in open order
    op_forced: List[bool] = []     # will this op's slot see a FORCE?
    ev_ops: List[tuple] = []       # (etype, op id) per event position
    active: dict = {}
    for pos in range(n_ev):
        et, slot = events[pos][0], events[pos][1]
        if et == EV_OPEN:
            k = len(ops)
            ops.append((events[pos][2], events[pos][3], events[pos][4]))
            op_forced.append(False)
            active[slot] = k
            ev_ops.append((EV_OPEN, k))
        elif et == EV_FORCE:
            k = active.pop(slot)
            op_forced[k] = True
            ev_ops.append((EV_FORCE, k))
        else:
            ev_ops.append((0, -1))
    opened_by = [0] * (n_ev + 1)   # #ops opened among events[:pos]
    for pos in range(n_ev):
        opened_by[pos + 1] = opened_by[pos] + (
            1 if ev_ops[pos][0] == EV_OPEN else 0)
    guide = _value_guide_masks(model, ops, op_forced)

    def sweep(state, done, pending):
        # One pass suffices: read-only commits leave the state (the
        # only legality input) unchanged.
        for k in pending:
            if not (done >> k) & 1 and ops[k][0] in readonly \
                    and step(state, *ops[k])[1]:
                done |= 1 << k
        return done

    def candidates(state, done, pending, e):
        """Ordered commit options at op e's FORCE. None = commit e
        directly (listed first when legal — the greedy choice);
        otherwise an older pending op id, value-guided order."""
        te = ops[e]
        s_e, legal_e = step(state, *te)
        out = []
        if legal_e:
            out.append((-1, 0, 0, -1, None))
        for k in pending:
            if (done >> k) & 1 or k == e:
                continue
            s2, legal = step(state, *ops[k])
            if not legal:
                continue
            if guide is not None and not (guide[0][k] & guide[1][e]):
                enables = 1  # mask proves k exposes nothing e observes
            else:
                enables = 0 if step(s2, *te)[1] else 1
            out.append((0, enables, 0 if op_forced[k] else 1, k, k))
        out.sort(key=lambda t: t[:4])
        return [t[4] for t in out]

    flips = 0
    # choice points: [pos, state, done, candidates|None (lazy), next].
    # A None candidate list is computed only on first restore — the
    # never-backtracked common path (every valid unambiguous row) pays
    # one direct step() per FORCE exactly like the greedy scan, not a
    # full candidate enumeration.
    stack: deque = deque(maxlen=_BACKTRACK_STACK_CAP)
    pending: List[int] = []
    pos, done = 0, 0
    try:
        while pos < n_ev:
            et, k = ev_ops[pos]
            if et == EV_OPEN:
                f, a, b = ops[k]
                # Eager-commit at open when read-only and already legal
                # (the rest of `pending` was swept at this same state).
                if f in readonly and step(state, f, a, b)[1]:
                    done |= 1 << k
                else:
                    pending.append(k)
                pos += 1
                continue
            if et != EV_FORCE or (done >> k) & 1:
                pos += 1
                continue
            s_k, legal_k = step(state, *ops[k])
            choice = None
            if legal_k:
                # greedy direct commit; alternatives resolve lazily
                if budget > 0 and any(not (done >> o) & 1
                                      for o in pending):
                    stack.append([pos, state, done, None, 1])
            else:
                cands = candidates(state, done, pending, k)
                if cands:
                    if len(cands) > 1 and budget > 0:
                        stack.append([pos, state, done, cands, 1])
                    choice = cands[0]
                else:
                    # dead end: restore the most recent choice point
                    # with an untried option (one restore = one flip)
                    while stack:
                        cp = stack[-1]
                        if cp[3] is None:  # lazy: enumerate at its state
                            kc = ev_ops[cp[0]][1]
                            pc = [o for o in range(opened_by[cp[0]])
                                  if not (cp[2] >> o) & 1]
                            cp[3] = candidates(cp[1], cp[2], pc, kc)
                        if cp[4] < len(cp[3]):
                            flips += 1
                            if flips > budget:
                                return False, None, flips
                            pos, state, done = cp[0], cp[1], cp[2]
                            choice = cp[3][cp[4]]
                            cp[4] += 1
                            k = ev_ops[pos][1]
                            pending = [o for o in range(opened_by[pos])
                                       if not (done >> o) & 1]
                            break
                        stack.pop()
                    else:
                        return False, None, flips  # undecided — kernels
            commit = k if choice is None else choice
            state = step(state, *ops[commit])[0]
            done = sweep(state, done | (1 << commit), pending)
            if choice is None:
                pos += 1
            # else: stay at pos — re-evaluate k's FORCE at the new state
            pending = [o for o in pending if not (done >> o) & 1]
    except _AbortBudget:
        return False, None, flips  # abort budget spent — undecided
    return True, ("greedy" if flips == 0 else "backtrack"), flips
