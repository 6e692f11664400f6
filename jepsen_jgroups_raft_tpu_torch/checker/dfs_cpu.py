"""DFS-with-undo linearizability search, the host's second engine.

A copy of the reference's checker/dfs_cpu.py (pure Python, no device
code): the classic Wing & Gong / knossos / porcupine depth-first search
with undo and memoization — a different search order from the frontier
scan (wgl_cpu.py and the kernels), which is breadth-first over
configuration sets.

DFS commits to ONE linearization order at a time, so on histories where
almost any order works (the common valid case) it finishes after ~n
steps without materializing the configuration frontier; adversarial
histories can send it into deep backtracking that frontier dedup shrugs
off. `checker/linearizable.py` spends a small DFS budget first on wide
windows under ``auto`` and races it against the kernels under
``"race"``.

Algorithm (porcupine-style, on the packed event stream of
history/packing.py — OPEN is an op's invoke point, FORCE its completion):
walk an entry list; at an OPEN entry try to linearize that op now (apply
the model step, consult the visited cache of (linearized-mask, state));
on success lift the op's OPEN and FORCE entries from the list and push an
undo record; a FORCE entry reached before its op linearized ⇒ every op
order consistent with real time has been tried for this prefix ⇒ backtrack
(undo the most recent tentative linearization, resume after it). The
visited cache makes revisits O(1): a (mask, state) pair that failed once
can never succeed later, because future legality depends only on it.
Crashed (info) ops have an OPEN but no FORCE: they are optional — eligible
for linearization forever, never forcing backtracking. Success = every
FORCE entry consumed.
"""

from __future__ import annotations

from typing import Optional

from ..history.packing import EV_FORCE, EV_OPEN, EncodedHistory
from .wgl_cpu import CpuCheckResult


class SearchBudgetExceeded(Exception):
    """DFS step budget exhausted (adversarial backtracking)."""

    def __init__(self, steps: int):
        super().__init__(f"dfs budget exceeded: {steps} steps")
        self.steps = steps


def check_encoded_dfs(
    enc: EncodedHistory,
    model,
    max_steps: Optional[int] = None,
    witness: bool = False,
) -> CpuCheckResult:
    """Run the DFS-with-undo search on one encoded history.

    max_steps bounds total loop iterations (None = unbounded); exceeding it
    raises SearchBudgetExceeded so callers can escalate/race rather than
    hang on adversarial histories.
    """

    events = enc.events
    n = enc.n_events

    # Entry list over event indices, doubly linked through arrays.
    # nxt/prv have a virtual head at index -1 (head) and tail at n.
    nxt = list(range(1, n + 1))
    prv = list(range(-1, n))
    head = 0 if n > 0 else n

    # Per-event metadata.
    op_f = events[:, 2]
    op_a = events[:, 3]
    op_b = events[:, 4]
    # For each OPEN event, the event index of its FORCE (or -1 if info).
    force_of = [-1] * n
    open_of = [-1] * n  # for each FORCE event, its OPEN's event index
    last_open_for_slot: dict = {}
    op_bit = [0] * n  # distinct bit per op (OPEN event index order)
    bit = 1
    for ei in range(n):
        et, slot = int(events[ei, 0]), int(events[ei, 1])
        if et == EV_OPEN:
            last_open_for_slot[slot] = ei
            op_bit[ei] = bit
            bit <<= 1
        elif et == EV_FORCE:
            oi = last_open_for_slot[slot]
            force_of[oi] = ei
            open_of[ei] = oi
    n_forces = sum(1 for ei in range(n) if int(events[ei, 0]) == EV_FORCE)

    def unlink(i: int) -> None:
        nonlocal head
        p, q = prv[i], nxt[i]
        if p == -1:
            head = q
        else:
            nxt[p] = q
        if q < n:
            prv[q] = p

    def relink(i: int) -> None:
        nonlocal head
        p, q = prv[i], nxt[i]
        if p == -1:
            head = i
        else:
            nxt[p] = i
        if q < n:
            prv[q] = i

    state = model.init_state()
    mask = 0
    cache = {(0, state)}
    undo: list = []  # (open_ei, prev_state) — linearization order, newest last
    remaining_forces = n_forces
    steps = 0
    furthest_block = -1  # furthest FORCE event the search ever got stuck on
                         # — "the linearizable prefix ends here", matching
                         # the frontier engine's failing-op semantics

    cur = head
    while True:
        if remaining_forces == 0:
            return CpuCheckResult(
                valid=True,
                configs_explored=len(cache),
                max_frontier=len(undo) + 1,
                witness=[int(enc.op_index[ei]) for ei, _ in undo]
                if witness else None,
            )
        steps += 1
        if max_steps is not None and steps > max_steps:
            raise SearchBudgetExceeded(steps)
        if cur >= n:
            # Walked off the tail: only un-linearizable entries remain
            # ahead, and no FORCE was hit — means remaining entries are all
            # OPENs of info ops that can't legally linearize. That's fine
            # only if no FORCE remains (handled above); otherwise the next
            # pass from head would loop, so treat like hitting a FORCE of
            # an unlinearized op: backtrack.
            et = EV_FORCE
            force_blocked_ei = None
        else:
            et = int(events[cur, 0])
            force_blocked_ei = cur
        if et == EV_OPEN:
            ei = cur
            s2, legal = model.step(state, int(op_f[ei]), int(op_a[ei]),
                                   int(op_b[ei]))
            cfg = (mask | op_bit[ei], s2)
            if legal and cfg not in cache:
                cache.add(cfg)
                undo.append((ei, state))
                state = s2
                mask |= op_bit[ei]
                fe = force_of[ei]
                unlink(ei)
                if fe >= 0:
                    unlink(fe)
                    remaining_forces -= 1
                cur = head
            else:
                cur = nxt[cur]
        else:  # FORCE (or tail): op not linearized in time — backtrack
            if force_blocked_ei is not None:
                furthest_block = max(furthest_block, force_blocked_ei)
            if not undo:
                return CpuCheckResult(
                    valid=False,
                    configs_explored=len(cache),
                    max_frontier=1,
                    failing_op_index=int(enc.op_index[furthest_block])
                    if furthest_block >= 0 else None,
                    witness=None,
                )
            ei, prev_state = undo.pop()
            fe = force_of[ei]
            if fe >= 0:
                relink(fe)
                remaining_forces += 1
            relink(ei)
            state = prev_state
            mask &= ~op_bit[ei]
            cur = nxt[ei]
