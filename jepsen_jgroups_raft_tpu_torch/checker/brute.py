"""Brute-force linearizability oracle (tests only).

A copy of the reference's checker/brute.py. Definition-level checker:
enumerate every subset of optional (info) ops and every permutation of
the chosen ops that respects real-time precedence, and ask the model
whether some order is sequentially legal. Exponential — the tests use it
to hold the port's engines to the definition on small randomized
histories.
"""

from __future__ import annotations

from itertools import combinations
from typing import Sequence, Union

from ..history.ops import History, Op, OpPair, pair_ops_indexed


def check_brute(history: Union[History, Sequence[Op]], model) -> bool:
    ops = list(history)
    items = []  # (inv_pos, res_pos, encoded)
    for ip, cp, inv, comp in pair_ops_indexed(ops):
        enc = model.encode_pair(OpPair(inv, comp))
        if enc is None:
            continue
        if enc.forced and cp < 0:
            # Same inconsistency encode_history rejects: a forced op must
            # have a completion; cp=-1 would order it before everything.
            raise ValueError(
                f"model {type(model).__name__} encoded a pair with no "
                f"completion as forced (invoke index {inv.index})")
        items.append((ip, cp if enc.forced else float("inf"), enc))

    forced = [it for it in items if it[2].forced]
    optional = [it for it in items if not it[2].forced]

    for r in range(len(optional) + 1):
        for chosen in combinations(optional, r):
            if _search(forced + list(chosen), model):
                return True
    return False


def _search(items, model) -> bool:
    """DFS over precedence-respecting permutations with model pruning."""

    n = len(items)
    if n == 0:
        return True

    def rec(remaining: frozenset, state) -> bool:
        if not remaining:
            return True
        for i in remaining:
            inv_i = items[i][0]
            # i may come next only if no remaining j finished before i began
            if any(items[j][1] < inv_i for j in remaining if j != i):
                continue
            e = items[i][2]
            state2, legal = model.step(state, e.f, e.a, e.b)
            if legal and rec(remaining - {i}, state2):
                return True
        return False

    return rec(frozenset(range(n)), model.init_state())
