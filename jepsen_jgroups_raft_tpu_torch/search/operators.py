"""Typed mutation-operator registry (a copy of the reference's
`search/operators.py`).

A registry of named, per-family operators the search driver draws from
with a seed-stable RNG; `history/synth.corrupt` is a thin wrapper over
it. The same operator, family and RNG give the reference's history
op for op.

Soundness contract (doc/checker-design.md §22): every operator maps a
well-formed history to a well-formed history — the packing layer must
never reject a mutant, because a candidate that fails encode wastes an
admission slot and (worse) would make corpus replay seed-dependent on
the *error* path. Concretely:

  * value edits stay inside each model's packed domain (set/list
    elements ≤ 31, list length ≤ 6, queue tickets ≥ 0);
  * a completed append's observed list must end in its own element
    (models/listappend._prefix raises otherwise), so append edits only
    touch the prefix ``lst[:-1]``;
  * row moves keep every invocation strictly before its completion and
    never reorder one process's ops against each other;
  * crash injection (ok→info) rewrites the completion value back to the
    *invocation* value, matching the synth generator's info rows.

Operators return ``None`` when inapplicable (e.g. no cas rows to flip)
so the driver can treat the mutation as a deterministic no-op instead
of raising.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..history.ops import FAIL, INFO, INVOKE, OK, History
from ..history.synth import build_history

FAMILIES = ("register", "counter", "set", "queue", "list-append")

#: packed-domain bounds shared with models/gset.py and models/listappend.py
_MAX_ELEM = 31
_MAX_LIST_LEN = 6


def _rows(hist: History) -> List[list]:
    return [[o.process, o.type, o.f, o.value] for o in hist]


def _invoke_of(rows: Sequence[list], i: int) -> Optional[int]:
    """Index of the invocation row belonging to completion row i."""
    p = rows[i][0]
    for j in range(i - 1, -1, -1):
        if rows[j][0] == p:
            return j if rows[j][1] == INVOKE else None
    return None


def _completion_of(rows: Sequence[list], i: int) -> Optional[int]:
    """Index of the completion row belonging to invocation row i."""
    p = rows[i][0]
    for j in range(i + 1, len(rows)):
        if rows[j][0] == p:
            return j if rows[j][1] != INVOKE else None
    return None


def _kv(value, tupled: bool):
    """Unwrap a (key, payload) value for the transactional tier."""
    if tupled:
        return value[0], value[1]
    return None, value


def _wrap(key, payload, tupled: bool):
    return (key, payload) if tupled else payload


def _is_tupled(rows: Sequence[list]) -> bool:
    for r in rows:
        if r[1] == INVOKE:
            return isinstance(r[3], tuple)
    return False


# ---------------------------------------------------------------- value edits

def _perturb_read(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    idxs = [i for i, r in enumerate(rows)
            if r[1] == OK and r[2] == "read" and not isinstance(r[3], list)]
    if not idxs:
        return None
    i = rng.choice(idxs)
    v = rows[i][3]
    rows[i][3] = (v if isinstance(v, int) else 0) + rng.choice([1, -1])
    return rows


def _perturb_write(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    # the old corrupt() write arm was a silent no-op: completed writes
    # carry the written value, so flipping ONLY the completion would
    # desync it from the invocation. Rewrite both rows together.
    idxs = [i for i, r in enumerate(rows) if r[1] == OK and r[2] == "write"]
    if not idxs:
        return None
    i = rng.choice(idxs)
    j = _invoke_of(rows, i)
    if j is None:
        return None
    v = rows[i][3] if isinstance(rows[i][3], int) else 0
    nv = v + rng.choice([1, -1, 2])
    rows[i][3] = nv
    rows[j][3] = nv
    return rows


def _perturb_cas(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    idxs = [i for i, r in enumerate(rows)
            if r[1] in (OK, FAIL) and r[2] == "cas"]
    if not idxs:
        return None
    i = rng.choice(idxs)
    rows[i][1] = FAIL if rows[i][1] == OK else OK
    return rows


def _perturb_set_read(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    idxs = [i for i, r in enumerate(rows)
            if r[1] == OK and r[2] == "read" and isinstance(r[3], list)]
    if not idxs:
        return None
    i = rng.choice(idxs)
    v = list(rows[i][3])
    if v and rng.random() < 0.5:
        v.pop(rng.randrange(len(v)))  # drop an observed element
    else:
        absent = [e for e in range(_MAX_ELEM + 1) if e not in v]
        if not absent:
            return None
        v.append(absent[rng.randrange(len(absent))])  # claim one
        v.sort()
    rows[i][3] = v
    return rows


def _perturb_sum(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    idxs = [i for i, r in enumerate(rows)
            if r[1] == OK and r[2] == "add-and-get"
            and isinstance(r[3], tuple) and len(r[3]) == 2]
    if not idxs:
        return None
    i = rng.choice(idxs)
    v0, s = rows[i][3]
    rows[i][3] = (v0, s + rng.choice([1, -1]))
    return rows


def _perturb_ticket(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    idxs = [i for i, r in enumerate(rows)
            if r[1] == OK and r[2] in ("enqueue", "dequeue")]
    if not idxs:
        return None
    i = rng.choice(idxs)
    v = rows[i][3]
    if isinstance(v, int):
        rows[i][3] = max(0, v + rng.choice([1, -1])) if v else v + 1
    else:
        rows[i][3] = 0  # an empty dequeue claims a ticket
    return rows


def _perturb_observed_list(rng: random.Random,
                           rows: List[list]) -> Optional[List[list]]:
    tupled = _is_tupled(rows)
    cands = []
    for i, r in enumerate(rows):
        if r[1] != OK or r[2] not in ("read", "append"):
            continue
        _, payload = _kv(r[3], tupled)
        if not isinstance(payload, list):
            continue
        # appends may only edit the prefix (the list must keep ending in
        # the appended element or encode rejects the history)
        editable = len(payload) - 1 if r[2] == "append" else len(payload)
        if r[2] == "append" and editable < 1:
            continue
        cands.append((i, editable))
    if not cands:
        return None
    i, editable = cands[rng.randrange(len(cands))]
    key, payload = _kv(rows[i][3], tupled)
    lst = list(payload)
    tail = lst[editable:]
    head = lst[:editable]
    mode = rng.random()
    if head and mode < 0.45:
        head.pop(rng.randrange(len(head)))  # drop an observed element
    elif len(head) >= 2 and mode < 0.7:
        j = rng.randrange(len(head) - 1)
        head[j], head[j + 1] = head[j + 1], head[j]  # reorder observation
    else:
        absent = [e for e in range(1, _MAX_ELEM + 1) if e not in lst]
        if not absent or len(lst) >= _MAX_LIST_LEN:
            if not head:
                return None
            head.pop(rng.randrange(len(head)))
        else:
            head.insert(rng.randrange(len(head) + 1),
                        absent[rng.randrange(len(absent))])  # claim one
    rows[i][3] = _wrap(key, head + tail, tupled)
    return rows


# ----------------------------------------------------------- structural edits

#: ambiguity budget for crash-injecting operators: every crashed op
#: holds a concurrency-window slot forever (history/synth.py caps
#: max_crashes=n_procs for the same reason), and past a handful the
#: exact host check goes combinatorial — a mutant nobody can afford to
#: check is not a useful candidate, and its cost would swamp the
#: recall-per-CPU-minute metric with one pathological genome.
_MAX_CRASHED = 5


def _crashed_count(rows: Sequence[list]) -> int:
    """Crashed ops so far: info completions + silently dangling
    invocations (invokes minus completions)."""
    n_inv = sum(1 for r in rows if r[1] == INVOKE)
    n_done = sum(1 for r in rows if r[1] in (OK, FAIL))
    return n_inv - n_done  # info rows pair a dangling invoke


def _retire_process(rows: List[list], after: int, p) -> None:
    """Crashed-id remapping (history/synth.py): once an op's completion
    becomes unknown, its process can never act again — later rows of p
    move under a fresh worker id, or pair_ops rejects the history as
    invoked-twice-without-completing."""
    later = [j for j in range(after + 1, len(rows)) if rows[j][0] == p]
    if not later:
        return
    fresh = max((r[0] for r in rows if isinstance(r[0], int)),
                default=-1) + 1
    for j in later:
        rows[j][0] = fresh


def _drop_completion(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    if _crashed_count(rows) >= _MAX_CRASHED:
        return None
    idxs = [i for i, r in enumerate(rows) if r[1] == OK]
    if not idxs:
        return None
    i = rng.choice(idxs)
    p = rows[i][0]
    del rows[i]  # dangling invocation == crashed worker (pair_ops)
    _retire_process(rows, i - 1, p)
    return rows


def _crash_op(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    if _crashed_count(rows) >= _MAX_CRASHED:
        return None
    idxs = [i for i, r in enumerate(rows) if r[1] in (OK, FAIL)]
    if not idxs:
        return None
    i = rng.choice(idxs)
    j = _invoke_of(rows, i)
    if j is None:
        return None
    rows[i][1] = INFO
    rows[i][3] = rows[j][3]  # info rows carry the invocation value
    _retire_process(rows, i, rows[i][0])
    return rows


def _reorder_completion(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    idxs = []
    for i, r in enumerate(rows):
        if r[1] == INVOKE:
            continue
        j = _invoke_of(rows, i)
        if j is not None and i - j >= 2:
            idxs.append((i, j))
    if not idxs:
        return None
    i, j = idxs[rng.randrange(len(idxs))]
    dst = rng.randrange(j + 1, i)  # earlier, still after the invocation
    row = rows.pop(i)
    rows.insert(dst, row)
    return rows


def _reorder_invoke(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    idxs = []
    for i, r in enumerate(rows):
        if r[1] != INVOKE:
            continue
        c = _completion_of(rows, i)
        end = c if c is not None else len(rows)
        if end - i >= 2:
            idxs.append((i, end))
    if not idxs:
        return None
    i, end = idxs[rng.randrange(len(idxs))]
    dst = rng.randrange(i + 1, end)  # later, still before the completion
    row = rows.pop(i)
    rows.insert(dst, row)
    return rows


def _session_shuffle(rng: random.Random, rows: List[list]) -> Optional[List[list]]:
    """Swap two adjacent completed ops of one process that target
    DIFFERENT keys (transactional tier only). Each key's own op order
    is untouched — only the session (po) order flips, which is exactly
    the plane the anomaly certifier reads."""
    if not _is_tupled(rows):
        return None
    by_proc: dict = {}
    for i, r in enumerate(rows):
        if r[1] == INVOKE:
            c = _completion_of(rows, i)
            if c is not None and rows[c][1] == OK:
                by_proc.setdefault(r[0], []).append((i, c))
    cands = []
    for pairs in by_proc.values():
        for a, b in zip(pairs, pairs[1:]):
            ka = rows[a[0]][3][0]
            kb = rows[b[0]][3][0]
            if ka != kb:
                cands.append((a, b))
    if not cands:
        return None
    (ia, ca), (ib, cb) = cands[rng.randrange(len(cands))]
    rows[ia], rows[ib] = rows[ib], rows[ia]
    rows[ca], rows[cb] = rows[cb], rows[ca]
    return rows


# ------------------------------------------------------------- param mutation

def _mix_crash_rate(rng: random.Random, params: dict) -> dict:
    p = params["crash_p"]
    p = rng.choice([0.05, 0.15, 0.3]) if p <= 0 else p * rng.choice([0.5, 2.0])
    params["crash_p"] = min(0.6, round(p, 4))
    return params


def _mix_procs(rng: random.Random, params: dict) -> dict:
    params["n_procs"] = min(8, max(2, params["n_procs"] + rng.choice([-1, 1])))
    return params


def _mix_value_range(rng: random.Random, params: dict) -> dict:
    params["value_range"] = min(8, max(2, params["value_range"]
                                       + rng.choice([-1, 1])))
    return params


def _nemesis_interval(rng: random.Random, params: dict) -> dict:
    params["interval"] = min(20.0, max(0.5,
                                       params["interval"]
                                       * rng.choice([0.5, 2.0])))
    return params


def _nemesis_schedule(rng: random.Random, params: dict) -> dict:
    from ..nemesis.package import FAULTS, SCHEDULES

    specs = ("none",) + FAULTS + SCHEDULES + ("all",)
    cur = params["nemesis"]
    others = [s for s in specs if s != cur]
    params["nemesis"] = others[rng.randrange(len(others))]
    return params


# ------------------------------------------------------------------- registry

@dataclass(frozen=True)
class Operator:
    """A named, typed mutation.

    ``target`` is "history" (rewrites rows of a materialized history)
    or "params" (rewrites the scenario genome before generation).
    ``families`` scopes applicability; ``can_invalidate`` marks value
    edits that can flip a valid history to invalid — the compat
    `corrupt()` wrapper and the recall planter draw only from those.
    """

    name: str
    target: str
    families: Tuple[str, ...]
    can_invalidate: bool
    fn: Callable


_ALL = FAMILIES

_OPERATORS = (
    Operator("perturb-read", "history", ("register", "counter"), True,
             _perturb_read),
    Operator("perturb-write", "history", ("register",), True, _perturb_write),
    Operator("perturb-cas", "history", ("register",), True, _perturb_cas),
    Operator("perturb-set-read", "history", ("set",), True, _perturb_set_read),
    Operator("perturb-sum", "history", ("counter",), True, _perturb_sum),
    Operator("perturb-ticket", "history", ("queue",), True, _perturb_ticket),
    Operator("perturb-observed-list", "history", ("list-append",), True,
             _perturb_observed_list),
    Operator("drop-completion", "history", _ALL, False, _drop_completion),
    Operator("crash-op", "history", _ALL, False, _crash_op),
    Operator("reorder-completion", "history", _ALL, False,
             _reorder_completion),
    Operator("reorder-invoke", "history", _ALL, False, _reorder_invoke),
    Operator("session-shuffle", "history", ("list-append",), False,
             _session_shuffle),
    Operator("mix-crash-rate", "params", _ALL, False, _mix_crash_rate),
    Operator("mix-procs", "params", _ALL, False, _mix_procs),
    Operator("mix-value-range", "params",
             ("register", "counter", "set"), False, _mix_value_range),
    Operator("nemesis-interval", "params", _ALL, False, _nemesis_interval),
    Operator("nemesis-schedule", "params", _ALL, False, _nemesis_schedule),
)

REGISTRY = {op.name: op for op in _OPERATORS}


def operators_for(family: str, target: Optional[str] = None) -> List[Operator]:
    return [op for op in _OPERATORS
            if family in op.families
            and (target is None or op.target == target)]


def apply_history_op(op: Operator, rng: random.Random,
                     hist: History) -> Optional[History]:
    """Apply one history operator; None when inapplicable."""
    out = op.fn(rng, _rows(hist))
    return None if out is None else build_history(
        (r[0], r[1], r[2], r[3]) for r in out)


# ------------------------------------------------------------- compat surface

def family_of(hist: History) -> str:
    """Best-effort model family of a synth history (for the corrupt()
    compat wrapper, which historically dispatched on op shape)."""
    fs = {o.f for o in hist}
    if "append" in fs:
        return "list-append"
    if "enqueue" in fs or "dequeue" in fs:
        return "queue"
    if "cas" in fs or "write" in fs:
        return "register"
    if "add-and-get" in fs:
        return "counter"
    if "add" in fs:
        for o in hist:
            if o.type == OK and o.f == "read":
                return "set" if isinstance(o.value, list) else "counter"
        return "set"
    for o in hist:
        if o.type == OK and isinstance(o.value, list):
            return "set"
    return "register"


def corrupt_once(rng: random.Random, hist: History,
                 family: Optional[str] = None) -> History:
    """Single value-level corruption (the old `synth.corrupt` contract):
    perturb one completion so the oracle may or may not invalidate.
    Draws from the family's ``can_invalidate`` operators; returns the
    history unchanged when none applies (e.g. no completions at all)."""
    fam = family or family_of(hist)
    ops = [op for op in operators_for(fam, "history") if op.can_invalidate]
    order = list(range(len(ops)))
    rng.shuffle(order)
    for k in order:
        out = apply_history_op(ops[k], rng, hist)
        if out is not None:
            return out
    return hist
