"""Synthetic history generation (a copy of the reference's generator).

A randomized generator with a built-in linearizability guarantee: ops take
effect atomically at a simulated linearization point between invocation and
completion, so the produced history IS linearizable by construction.
Crashed ops may linearize and then never report (→ info), reproducing the
ambiguous-completion semantics the checker must handle.

The port uses it for the north-star batch (chip_smoke.py) and its tests;
the same seed gives the same histories as the reference's generator.
"""

from __future__ import annotations

import random

from .ops import FAIL, INFO, INVOKE, NEMESIS, OK, History, Op


def build_history(rows) -> History:
    """Build a history from (process, type, f, value) rows; indices/times
    are assigned from position."""
    h = History()
    for i, (process, typ, f, value) in enumerate(rows):
        h.append(Op(process=process, type=typ, f=f, value=value, time=i))
    return h


def random_valid_history(
    rng: random.Random,
    model_kind: str = "register",
    n_ops: int = 8,
    n_procs: int = 3,
    value_range: int = 3,
    crash_p: float = 0.2,
    max_crashes: int | None = None,
) -> History:
    """Generate a linearizable-by-construction history of n_ops ops.

    model_kind: "register" (read/write/cas), "counter"
    (read/add/add-and-get), "set" (add/read over the 32-wide
    membership), "queue" (ticket-FIFO enqueue/dequeue, completed
    enqueues observing their assigned ticket), or "list-append"
    (unique-element appends observing the resulting list, reads
    observing the whole list). crash_p biases how often
    a pending op crashes instead of completing (info ops are the
    checker-pressure knob).

    A crashed process is REPLACED by a fresh process id, the way jepsen's
    runner remaps crashed worker ids — so the history really reaches n_ops
    regardless of crashes. Every crashed op holds a concurrency-
    window slot forever, so `max_crashes` caps the total — the knob that
    keeps long histories inside a checkable window. The default (None)
    caps at n_procs: the concurrency window stays ≤ 2·n_procs no matter
    how long the history. An uncapped run (windows in the
    hundreds, beyond every checker) must be asked for with
    max_crashes=n_ops."""

    if max_crashes is None:
        max_crashes = n_procs
    if model_kind == "register":
        state = None
    elif model_kind == "queue":
        state = (0, 0)  # (head, tail)
    elif model_kind == "list-append":
        state = []  # the append-only list itself
    else:
        state = 0  # counter value / set membership mask
    # list-append: unique elements 1..MAX_LEN (the packed int32 state
    # admits at most 6), then the generator degrades to reads
    next_elem = 1
    rows = []
    # pending: process -> dict(f, value, linearized?, result)
    pending: dict = {}
    done_ops = 0
    crashes = 0
    free = list(range(n_procs))
    next_pid = n_procs
    while done_ops < n_ops or pending:
        choices = []
        if done_ops < n_ops and free:
            choices.append("invoke")
        unlin = [p for p, d in pending.items() if not d["lin"]]
        lin = [p for p, d in pending.items() if d["lin"]]
        may_crash = crashes < max_crashes
        if unlin:
            choices.append("linearize")
            if may_crash and rng.random() < crash_p:
                choices.append("crash_unapplied")
        if lin:
            choices.append("complete")
            if may_crash and rng.random() < crash_p:
                choices.append("crash_applied")
        act = rng.choice(choices)
        if act == "invoke":
            p = free.pop(rng.randrange(len(free)))
            if model_kind == "register":
                f = rng.choice(["read", "write", "cas"])
                if f == "read":
                    value = None
                elif f == "write":
                    value = rng.randrange(value_range)
                else:
                    value = (rng.randrange(value_range), rng.randrange(value_range))
            elif model_kind == "set":
                f = rng.choice(["add", "add", "read"])
                value = rng.randrange(value_range) if f == "add" else None
            elif model_kind == "queue":
                f = rng.choice(["enqueue", "enqueue", "dequeue"])
                value = None
            elif model_kind == "list-append":
                if next_elem <= 6 and rng.random() < 0.5:
                    f, value = "append", next_elem
                    next_elem += 1
                else:
                    f, value = "read", None
            else:
                f = rng.choice(["read", "add", "add-and-get"])
                value = None if f == "read" else rng.randrange(1, value_range + 1)
            pending[p] = {"f": f, "value": value, "lin": False, "result": None}
            rows.append((p, INVOKE, f, value))
            done_ops += 1
        elif act == "linearize":
            p = rng.choice(unlin)
            d = pending[p]
            f, v = d["f"], d["value"]
            if model_kind == "register":
                if f == "read":
                    d["result"] = state
                elif f == "write":
                    state = v
                    d["result"] = None
                else:
                    frm, to = v
                    if state == frm:
                        state = to
                        d["result"] = True
                    else:
                        d["result"] = False
            elif model_kind == "set":
                if f == "add":
                    state |= 1 << v
                    d["result"] = None
                else:
                    d["result"] = [i for i in range(32)
                                   if (state >> i) & 1]
            elif model_kind == "queue":
                h, t = state
                if f == "enqueue":
                    state = (h, t + 1)
                    d["result"] = t  # the assigned ticket
                elif h == t:
                    d["result"] = None  # empty observation
                else:
                    state = (h + 1, t)
                    d["result"] = h
            elif model_kind == "list-append":
                if f == "append":
                    state = state + [v]
                d["result"] = list(state)  # the observed/resulting list
            else:
                if f == "read":
                    d["result"] = state
                elif f == "add":
                    state += v
                    d["result"] = None
                else:
                    state += v
                    d["result"] = (v, state)
            d["lin"] = True
        elif act == "complete":
            p = rng.choice(lin)
            d = pending.pop(p)
            f, r = d["f"], d["result"]
            if model_kind == "register" and f == "cas" and r is False:
                rows.append((p, FAIL, f, d["value"]))
            elif f == "read":
                rows.append((p, OK, f, r))
            elif f in ("add-and-get", "enqueue", "dequeue", "append"):
                rows.append((p, OK, f, r))  # observed result/ticket/list
            else:
                rows.append((p, OK, f, d["value"]))
            free.append(p)
        else:
            # Crash (applied or not): completion unknown. The op's slot
            # stays open forever; the worker comes back under a fresh
            # process id (jepsen's crashed-id remapping).
            p = rng.choice(lin if act == "crash_applied" else unlin)
            d = pending.pop(p)
            crashes += 1
            free.append(next_pid)
            next_pid += 1
            if rng.random() < 0.5:
                rows.append((p, INFO, d["f"], d["value"]))
            # else: no completion row at all — pair_ops treats the dangling
            # invocation as a crashed (info) op, same as jepsen.
    return build_history(rows)


def listappend_txn_rows(rng: random.Random, n_ops: int, n_keys: int,
                        n_procs: int, read_p: float = 0.55) -> list:
    """Rows (process, type, f, value) of a clean multi-key list-append
    history, serializable by construction: serial keyed ops round-robined
    over processes, ``("append", (k, e))`` completing with the key's
    whole list and ``("read", (k, None))`` observing it; at most 31
    appends per key (elements 1..31), reads once a key is full. Reads
    observe prefixes that later appends extend, so anti-dependency (rw)
    edges abound — the shape of the reference's transactional cycle A/B
    (scripts/ab_cycle.py `_serial_listappend_rows`, same draws from
    `rng`)."""
    state = {k: [] for k in range(n_keys)}
    next_elem = {k: 1 for k in range(n_keys)}
    rows = []
    for i in range(n_ops):
        p = i % n_procs
        k = rng.randrange(n_keys)
        if next_elem[k] <= 31 and rng.random() > read_p:
            e = next_elem[k]
            next_elem[k] += 1
            state[k] = state[k] + [e]
            rows.append((p, INVOKE, "append", (k, e)))
            rows.append((p, OK, "append", (k, list(state[k]))))
        else:
            rows.append((p, INVOKE, "read", (k, None)))
            rows.append((p, OK, "read", (k, list(state[k]))))
    return rows


#: Planted transactional anomalies on keys "x" and "y" (the fixtures of
#: the reference's tests/test_anomaly.py), each the smallest history of
#: its class:
#:   * "G0"       — cross-key po/ww cycle: the two sessions' append
#:                  orders are pinned contradictory by a third reader;
#:   * "G1c"      — cross-key po/wr cycle: each session reads the OTHER
#:                  key's append before its own lands;
#:   * "G-single" — one key: a read observes [2], and the rw edge back to
#:                  append(1) closes the ww/wr path (the only rw edge);
#:   * "clean"    — no anomaly.
ANOMALY_ROWS = {
    "G0": (
        (1, INVOKE, "append", ("x", 1)), (1, OK, "append", ("x", [2, 1])),
        (1, INVOKE, "append", ("y", 1)), (1, OK, "append", ("y", [1])),
        (2, INVOKE, "append", ("y", 2)), (2, OK, "append", ("y", [1, 2])),
        (2, INVOKE, "append", ("x", 2)), (2, OK, "append", ("x", [2])),
        (3, INVOKE, "read", ("x", None)), (3, OK, "read", ("x", [2, 1])),
        (3, INVOKE, "read", ("y", None)), (3, OK, "read", ("y", [1, 2])),
    ),
    "G1c": (
        (1, INVOKE, "read", ("y", None)), (1, OK, "read", ("y", [1])),
        (2, INVOKE, "read", ("x", None)), (2, OK, "read", ("x", [1])),
        (1, INVOKE, "append", ("x", 1)), (1, OK, "append", ("x", [1])),
        (2, INVOKE, "append", ("y", 1)), (2, OK, "append", ("y", [1])),
    ),
    "G-single": (
        (1, INVOKE, "append", ("x", 1)), (1, OK, "append", ("x", [1])),
        (1, INVOKE, "append", ("x", 2)), (1, OK, "append", ("x", [1, 2])),
        (2, INVOKE, "read", ("x", None)), (2, OK, "read", ("x", [2])),
    ),
    "clean": (
        (1, INVOKE, "append", ("x", 1)), (1, OK, "append", ("x", [1])),
        (2, INVOKE, "append", ("y", 1)), (2, OK, "append", ("y", [1])),
        (1, INVOKE, "append", ("y", 2)), (1, OK, "append", ("y", [1, 2])),
        (2, INVOKE, "read", ("x", None)), (2, OK, "read", ("x", [1])),
        (1, INVOKE, "read", ("y", None)), (1, OK, "read", ("y", [1, 2])),
    ),
}


def plant_anomaly(rows: list, kind: str, tag: str,
                  proc_base: int) -> list:
    """`rows` followed by the ANOMALY_ROWS fixture `kind`, on keys of its
    own (``(tag, "x")``, ``(tag, "y")``) and processes `proc_base` + its
    process ids, so its edges touch nothing of `rows`."""
    return list(rows) + [
        (proc_base + p, typ, f, ((tag, v[0]), v[1]))
        for p, typ, f, v in ANOMALY_ROWS[kind]]


def plant_stale_read(history, rng: random.Random):
    """A register history with one late read appended: a process whose
    last op completed, and which completed a write, reads the initial
    value (None) after everything else. No op writes the initial value,
    so the read must precede every write, and its own write precedes it
    in session order: INVALID at the sequential rung, refuted by the
    cycle tier. Returns (rows, the process), or (None, None) when no
    process qualifies."""
    ops = list(history)
    last: dict = {}
    wrote = set()
    for op in ops:
        last[op.process] = op
        if op.type == OK and op.f == "write":
            wrote.add(op.process)
    cands = sorted(p for p, op in last.items()
                   if p in wrote and op.type in (OK, FAIL))
    if not cands:
        return None, None
    p = rng.choice(cands)
    rows = [(op.process, op.type, op.f, op.value) for op in ops]
    rows += [(p, INVOKE, "read", None), (p, OK, "read", None)]
    return rows, p


def burst_history(rng: random.Random, model_kind: str, n_ops: int,
                  value_range: int = 3) -> History:
    """n_ops processes each invoke one op at once; the ops take effect
    in a random order and complete in another: linearizable by
    construction, with every kept op open at the same time, so the
    concurrency window is the number of ops the encoder keeps (a
    register's failed CAS is dropped). model_kind as in `random_valid_history`:
    "register", "counter", "set", "queue" or "list-append" (appends of
    elements 1..6 by the first six processes, reads by the rest: the
    packed list holds six). Wide windows (up to the sort kernel's 127
    slots) in few rows: one closing FORCE per history."""
    ops = []
    for p in range(n_ops):
        if model_kind == "list-append":
            f, v = ("append", p + 1) if p < 6 else ("read", None)
        elif model_kind == "register":
            f = rng.choice(["read", "write", "cas"])
            v = (None if f == "read" else rng.randrange(value_range)
                 if f == "write" else (rng.randrange(value_range),
                                       rng.randrange(value_range)))
        elif model_kind == "set":
            f = rng.choice(["add", "add", "read"])
            v = rng.randrange(value_range) if f == "add" else None
        elif model_kind == "queue":
            f, v = rng.choice(["enqueue", "enqueue", "dequeue"]), None
        else:
            f = rng.choice(["read", "add", "add-and-get"])
            v = None if f == "read" else rng.randrange(1, value_range + 1)
        ops.append([p, f, v, None])
    state = (None if model_kind == "register" else
             (0, 0) if model_kind == "queue" else
             [] if model_kind == "list-append" else 0)
    for k in rng.sample(range(n_ops), n_ops):
        _, f, v, _ = op = ops[k]
        if model_kind == "list-append":
            if f == "append":
                state = state + [v]
            op[3] = list(state)  # the resulting / observed list
        elif model_kind == "register":
            if f == "read":
                op[3] = state
            elif f == "write":
                state = v
            else:
                op[3] = state == v[0]
                state = v[1] if op[3] else state
        elif model_kind == "set":
            if f == "add":
                state |= 1 << v
            else:
                op[3] = [i for i in range(32) if (state >> i) & 1]
        elif model_kind == "queue":
            h, t = state
            if f == "enqueue":
                state, op[3] = (h, t + 1), t
            elif h == t:
                op[3] = None
            else:
                state, op[3] = (h + 1, t), h
        else:
            if f != "read":
                state += v
            op[3] = state if f == "read" else (v, state) \
                if f == "add-and-get" else None
    rows = [(p, INVOKE, f, v) for p, f, v, _ in ops]
    for k in rng.sample(range(n_ops), n_ops):
        p, f, v, r = ops[k]
        if model_kind == "register" and f == "cas":
            rows.append((p, OK if r else FAIL, f, v))
        elif f in ("read", "add-and-get", "enqueue", "dequeue", "append"):
            rows.append((p, OK, f, r))
        else:
            rows.append((p, OK, f, v))
    return build_history(rows)


def chained_bursts(rng: random.Random, width: int, n_bursts: int,
                   ambiguous: int = 1, off: int = 0) -> History:
    """A counter history of `n_bursts` bursts one after another: in
    each, `width` processes invoke an increment by 1 at once — the first
    `ambiguous` of them a plain add, the rest add-and-get, whose
    observed values pin their order — the increments take effect in a
    random order and complete in another. A final read observes the
    total plus `off` (INVALID for any `off` other than 0). The window is
    `width` while the frontier stays a few dozen configurations, so the
    sort ladder decides such a history at width 20 with one ambiguous
    add; a DFS over an INVALID one visits every configuration before
    the final read and, past a few hundred bursts, runs out of auto's
    fast budget (FAST_DFS_BUDGET)."""
    rows, total = [], 0
    fs = ["add"] * ambiguous + ["add-and-get"] * (width - ambiguous)
    for _ in range(n_bursts):
        rows += [(p, INVOKE, fs[p], 1) for p in range(width)]
        seen = {}
        for p in rng.sample(range(width), width):
            total += 1
            seen[p] = total
        rows += [(p, OK, fs[p], 1 if fs[p] == "add" else (1, seen[p]))
                 for p in rng.sample(range(width), width)]
    rows += [(0, INVOKE, "read", None), (0, OK, "read", total + off)]
    return build_history(rows)


def offset_counter_history(history, offset: int) -> list:
    """A counter history as if the counter had started at `offset`:
    every observed value (a read's, an add-and-get's new value) moves by
    `offset`, wrapping like int32. Check it with Counter(initial=offset);
    an offset near 2^31 makes the counter cross the int32 boundary."""
    def shift(v):
        return ((v + offset + 2**31) & 0xFFFFFFFF) - 2**31

    out = []
    for op in history:
        v = op.value
        if op.type == OK and v is not None:
            if op.f == "read":
                op = op.replace(value=shift(v))
            elif op.f == "add-and-get":
                op = op.replace(value=(v[0], shift(v[1])))
        out.append(op)
    return out


#: counter arguments that reach the int32 edges
_EDGE_VALUES = (-2**31, 2**31 - 1, 2**30, -2**30, 1, -1, 0, 7, 3)


def random_mask_rows(rng, n: int, n_rows: int, n_slots: int,
                     macro_p, kind: str):
    """[n, n_rows, R] int32 event rows for the mask-mode and sort scans
    that stray from what the packer emits, while keeping many frontiers
    alive: mostly always-legal ops (counter adds, queue crashed
    enqueues, set adds, register writes) on free slots and FORCEs of
    open slots, but also slots out of range (added to the clipped column
    at OPEN, clipped at FORCE), re-opened slots, payloads sharing a slot
    in one macro row, n_opens past P or negative, padding and unknown
    kinds, unknown opcodes, and arguments at the int32 edges. `rng` is a
    numpy Generator; R is 5 (macro_p None) or 3 + 4·macro_p; kind is
    "counter", "queue", "set", "register" or "list-append" (whose crashed
    appends at int32-edge elements drive the state negative and past
    int32)."""
    import numpy as np

    W, P = int(n_slots), macro_p
    R = 5 if P is None else 3 + 4 * P
    ev = np.zeros((n, n_rows, R), dtype=np.int32)

    def slot(among, p_among):
        if among and rng.random() < p_among:
            return int(rng.choice(among))
        return int(rng.integers(-2, W + 2))

    def op():
        if kind == "counter":
            f = int(rng.choice([1, 0, 2, 5], p=[.8, .07, .08, .05]))
            a = int(rng.choice(_EDGE_VALUES))
        elif kind == "set":  # add an element bit, read a membership
            f = int(rng.choice([0, 1, 5], p=[.8, .12, .08]))
            a = (1 << int(rng.integers(0, 32)) if rng.random() < .8
                 else int(rng.choice(_EDGE_VALUES)))
            a = ((a + 2**31) & 0xFFFFFFFF) - 2**31
        elif kind == "register":  # write, read, cas over a few values
            f = int(rng.choice([1, 0, 2, 6], p=[.6, .15, .2, .05]))
            a = int(rng.choice([0, 1, 2, -2**31, 2**31 - 1]))
            return f, a, int(rng.choice([0, 1, 2, -2**31]))
        elif kind == "list-append":  # crashed appends, reads, appends
            f = int(rng.choice([2, 0, 1, 5], p=[.7, .1, .15, .05]))
            a = (int(rng.integers(1, 32)) if rng.random() < .8
                 else int(rng.choice(_EDGE_VALUES)))
            return f, a, int(rng.choice([1, 7, 31, 2**31 - 1, -2**31]))
        else:
            f = int(rng.choice([1, 4, 0, 2, 3, 7],
                               p=[.45, .2, .15, .1, .05, .05]))
            a = int(rng.integers(-1, 4))
        return f, a, int(rng.choice(_EDGE_VALUES))

    for h in range(n):
        open_: set = set()
        for e in range(n_rows):
            free = [w for w in range(W) if w not in open_]
            k = int(rng.choice([0, 1, 2, 3], p=[.05, .45, .45, .05]))
            if k == 2 and P is None and not open_ and rng.random() < .9:
                k = 1
            opens = []
            if P is None and k == 1:
                opens = [(slot(free, 0.85), *op())]
                ev[h, e, :5] = (1, *opens[0])
            elif P is not None:
                m = int(rng.integers(0, min(len(free), P) + 1))
                opens = [(slot(free, 0.85), *op()) for _ in range(m)]
                for j, pay in enumerate(opens):
                    ev[h, e, 3 + 4 * j:7 + 4 * j] = pay
                ev[h, e, 2] = m if rng.random() < 0.9 else \
                    int(rng.choice([-1, P + 2]))
            open_ |= {q for q, *_ in opens if 0 <= q < W}
            ev[h, e, 0] = k
            if k == 2:
                f = slot(sorted(open_), 0.97)
                ev[h, e, 1] = f
                open_.discard(f)
    return ev


def sort_edge_rows(ops, forces, macro_p=None):
    """One history's event rows [E, R] int32 for the sort scan, written
    by hand: an OPEN of each (slot, f, a, b) of `ops` in order (legacy
    rows, or macro rows of up to `macro_p` opens), then a FORCE of each
    slot of `forces` in order (a macro row's opens join the first
    FORCE)."""
    import numpy as np

    P = macro_p
    rows = []
    if P is None:
        rows = [(1, *op) for op in ops] + [(2, w, 0, 0, 0) for w in forces]
        return np.asarray(rows, dtype=np.int32).reshape(-1, 5)
    groups = [ops[i:i + P] for i in range(0, len(ops), P)] or [[]]
    for i, g in enumerate(groups):
        row = [0] * (3 + 4 * P)
        last = i == len(groups) - 1
        row[0], row[1], row[2] = (2, forces[0], len(g)) if last and forces \
            else (1, 0, len(g))
        for j, op in enumerate(g):
            row[3 + 4 * j:7 + 4 * j] = op
        rows.append(row)
    rows += [[2, w, 0] + [0] * 4 * P for w in forces[1:]]
    return np.asarray(rows, dtype=np.int32)


def sort_edge_cases():
    """The sort scan's edge cases, on the CAS register (write f=1, read
    f=0): [(name, W, C, events [B, E, R] int32, n_events [B], macro_p)].
    Writes of one value on w slots reach all 2^w masks, each round's
    candidates colliding (the last round's on one key); C = 2^w is a
    distinct count of exactly C, C = 2^w - 1 one of C + 1 (the full mask,
    the largest key, is dropped, so forcing every slot fails). Writes of
    w distinct values give keys that differ only in the state (1 + w·2^(w-1)
    distinct). Slots from 32·(K-1) up give keys that differ only in the
    highest key field, the last mask word (W = 127: K = 4). Each case has
    two histories: the slots forced in ascending and in descending order;
    the row format alternates."""
    import numpy as np

    plan = [  # (kind, W, first slot, w, C)
        ("illegal", 1, 0, 1, 1), ("collide", 1, 0, 1, 1),
        ("collide", 2, 0, 2, 4), ("collide", 2, 0, 2, 3),
        ("collide", 6, 0, 6, 64), ("collide", 6, 0, 6, 63),
        ("collide", 8, 0, 8, 256), ("collide", 8, 0, 8, 255),
        ("collide", 9, 0, 9, 512), ("collide", 9, 0, 9, 511),
        ("state", 4, 0, 4, 33), ("state", 4, 0, 4, 32),
        ("state", 5, 0, 5, 64), ("state", 8, 0, 8, 256),
        ("high", 63, 32, 6, 64), ("high", 95, 64, 6, 63),
        ("high", 127, 96, 6, 64), ("high", 127, 96, 6, 63),
        ("high", 127, 96, 9, 512), ("high", 127, 96, 9, 511),
        ("state", 127, 96, 5, 64), ("state", 127, 96, 6, 256),
    ]
    cases = []
    for i, (kind, W, lo, w, C) in enumerate(plan):
        slots = list(range(lo, lo + w))
        ops = [(s, 0, 5, 0) if kind == "illegal" else
               (s, 1, 1 + j if kind == "state" else 1, 0)
               for j, s in enumerate(slots)]
        P = None if i % 2 == 0 else (8 if w <= 8 else 16)
        hs = [sort_edge_rows(ops, order, P)
              for order in (slots, slots[::-1])]
        ev = np.stack(hs)
        ne = np.full(len(hs), ev.shape[1], dtype=np.int32)
        cases.append((f"{kind}_W{W}_w{w}_C{C}", W, C, ev, ne, P))
    return cases


def random_segment_rows(rng, K: int, n_rows: int, n_slots: int, vals,
                        n_crashed: int, bad_read: float = 0.01,
                        stray: float = 0.005):
    """[K, n_rows, 5] int32 legacy event rows for the segmented scan, as
    its planner lays a segment out: a prologue that OPENs slots 0 ..
    n_crashed-1 (crashed ops: never FORCEd), then register ops on the
    other slots, OPENed on free slots and FORCEd while open. Each op
    takes effect at its OPEN on a running register state that starts at
    `vals[k][0]` (a read observes it, a cas expects it), so frontiers
    seeded at id 0 survive; a share `bad_read` of the reads and cas
    observe another value, and a few rows stray from the packer: 2 % padding and
    unknown kinds, a share `stray` with slots out of range (a FORCE of
    one clips to slot 0), unknown opcodes. Lower both for long segments,
    or every frontier dies early. `rng` is a numpy Generator; `vals`
    [K, S] int (a segment's id→value table)."""
    import numpy as np

    W = int(n_slots)
    ev = np.zeros((K, n_rows, 5), dtype=np.int32)
    for k in range(K):
        table = [int(v) for v in vals[k]]
        state = table[0]

        def op(state):
            f = int(rng.choice([1, 0, 2, 6], p=[.45, .35, .17, .03]))
            a, b = int(rng.choice(table)), int(rng.choice(table))
            if f != 1 and rng.random() >= bad_read:
                a = state
            nxt = a if f == 1 else (b if f == 2 and a == state else state)
            return (f, a, b), nxt

        pro = min(n_crashed, W, n_rows)
        for c in range(pro):
            ev[k, c] = (1, c, *op(state)[0])
        open_: set = set()
        for e in range(pro, n_rows):
            free = [w for w in range(n_crashed, W) if w not in open_]
            u = rng.random()
            if u < 0.02:
                ev[k, e, 0] = int(rng.choice([0, 3]))   # padding, unknown
            elif u < 0.02 + stray:
                ev[k, e] = (int(rng.choice([1, 2])),
                            int(rng.choice([-1, W, W + 3])), *op(state)[0])
            elif free and (not open_ or u < 0.5):
                w = int(rng.choice(free))
                args, state = op(state)
                ev[k, e] = (1, w, *args)
                open_.add(w)
            elif open_:
                w = int(rng.choice(sorted(open_)))
                ev[k, e, :2] = (2, w)
                open_.discard(w)
    return ev


def random_segment_inputs(rng, K: int, n_rows: int, n_slots: int,
                          n_states: int, n_crashed: int,
                          bad_read: float = 0.01, stray: float = 0.005):
    """A batch of K arbitrary segments for the segmented scan at window
    `n_slots` over `n_states`-entry value tables (the last quarter
    repeating id 0, as the planner pads): `random_segment_rows` with
    crashed slots 0 .. n_crashed-1, the seed basis (every subset of them
    × every state id), then dead seeds (-1) and a seed mask beyond the
    frontier; real lengths mixed (the first segment whole). Returns numpy
    (events [K, n_rows, 5], val_of [K, S], seed_mask and seed_state [K,
    NB], n_events [K]), all int32, NB ≤ 256."""
    import numpy as np

    W, S = int(n_slots), int(n_states)
    vals = rng.integers(-3, 4, size=(K, S)).astype(np.int32)
    vals[:, S - S // 4:] = vals[:, :1]
    ev = random_segment_rows(rng, K, n_rows, W, vals, n_crashed, bad_read,
                             stray)
    basis = [(sub, s) for sub in range(1 << n_crashed) for s in range(S)]
    NB = min(len(basis) + 4, 256)
    seed_mask = np.full((K, NB), -1, dtype=np.int32)
    seed_state = np.zeros((K, NB), dtype=np.int32)
    for b, (m, s) in enumerate(basis[:NB - 2]):
        seed_mask[:, b], seed_state[:, b] = m, s
    seed_mask[:, NB - 1] = 1 << W
    n_events = rng.integers(n_rows // 3, n_rows + 1, size=K).astype(np.int32)
    n_events[0] = n_rows
    return ev, vals, seed_mask, seed_state, n_events


# ------------------------------------------------------ recorded runs
# Stores shaped like the harness's own runs, written through the port's
# `core/store.save_test` (the reference's on-disk format), for the
# re-check of recorded runs (`checker/recorded.py`, the `check` CLI).

#: the partition nemesis's op names (the reference's nemesis/package.py)
PARTITION_FS = ("start-partition", "stop-partition")


def _crashed_pids(rows) -> set:
    """Processes whose last op in `rows` is an invocation left open or an
    info completion: crashed workers, never used again."""
    last: dict = {}
    for p, typ, _, _ in rows:
        last[p] = typ
    return {p for p, typ in last.items() if typ in (INVOKE, INFO)}


def keyed_register_history(rng: random.Random, n_keys: int = 512,
                           ops_per_key: int = 16, concurrency: int = 10,
                           value_range: int = 5, crash_p: float = 0.05,
                           max_crashes: int = 3, n_wide: int = 8,
                           wide_crash_p: float = 0.5,
                           wide_max_crashes: int = 8,
                           wide_min_window: int = 13,
                           nemesis_every: int = 32) -> History:
    """A multi-register run shaped like the reference suite's recorded
    config 3 (bench.py:1946-1958: 5 nodes, `concurrency` 10 threads,
    `ops_per_key` 16 ops a key, values in [0, 5)). With min(2n,
    concurrency) = 10 threads a key (the reference's
    workload/register.py), one group of `concurrency` workers works one
    key after another; each
    key's ops are a `random_valid_history` over that group, every value
    tupled `(key, v)`. A crashed worker comes back under a fresh process
    id (jepsen's remapping) and keeps it for later keys. Standing in for
    the partition nemesis's timeouts, `n_wide` keys (drawn by `rng`) take
    `wide_crash_p` with ≤ `wide_max_crashes` crashes, redrawn until the
    encoded window is ≥ `wide_min_window`; the rest take `crash_p` with
    ≤ `max_crashes`. Nemesis ops (process "nemesis", type info,
    start-partition / stop-partition) sit between keys every
    `nemesis_every` keys; `client_ops()` drops them."""
    from ..models.register import CasRegister
    from .packing import encode_history

    wide = set(rng.sample(range(n_keys), n_wide))
    slots = list(range(concurrency))  # the live worker of each thread
    next_pid = concurrency
    out: list = []
    for k in range(n_keys):
        if k % nemesis_every == 0 and k:
            f = PARTITION_FS[(k // nemesis_every + 1) % 2]
            v = "majority" if f == PARTITION_FS[0] else None
            out += [(NEMESIS, INFO, f, v), (NEMESIS, INFO, f, v)]
        while True:
            sub = random_valid_history(
                rng, "register", n_ops=ops_per_key, n_procs=concurrency,
                value_range=value_range,
                crash_p=wide_crash_p if k in wide else crash_p,
                max_crashes=wide_max_crashes if k in wide else max_crashes)
            if k not in wide or encode_history(
                    sub, CasRegister()).n_slots >= wide_min_window:
                break
        rows = [(op.process, op.type, op.f, op.value) for op in sub]
        crashed = _crashed_pids(rows)
        universe = concurrency + len(crashed)
        pid = {p: slots[p] for p in range(concurrency)}
        for q in range(concurrency, universe):
            pid[q] = next_pid
            next_pid += 1
        out += [(pid[p], typ, f, (k, v)) for p, typ, f, v in rows]
        slots = [pid[p] for p in range(universe) if p not in crashed]
    return build_history(out)


def election_history(rng: random.Random, n_ops: int = 1000,
                     n_nodes: int = 5, concurrency: int = 5,
                     p_views: float = 0.25, p_new_term: float = 0.02,
                     p_catch_up: float = 0.3,
                     p_timeout: float = 0.02) -> History:
    """An election run with views (the reference's election workload with
    its every-node probe, workload/leader.py: `inspect` ops observe the
    connected node's (leader, term), and every 4th op on average is a
    `views` op observing [(node, leader, term)] of every node). A
    simulated cluster: each new term has one leader (or none yet, a
    leaderless interval), and each node's view moves forward to the
    newest term with probability `p_catch_up` a step, so views lag but
    never go back: the run is safe by construction. Process p talks to
    node p mod n_nodes; an op times out (info) with `p_timeout`."""
    nodes = [f"n{i + 1}" for i in range(n_nodes)]
    term, leader = 1, rng.choice(nodes)
    view = {n: (leader, term) for n in nodes}
    pending: dict = {}  # process -> f
    rows: list = []
    done = 0
    free = list(range(concurrency))
    while done < n_ops or pending:
        if rng.random() < p_new_term:
            term += 1
            leader = rng.choice(nodes) if rng.random() < 0.8 else None
        for n in nodes:
            if view[n][1] < term and rng.random() < p_catch_up:
                view[n] = (leader, term)
        if free and done < n_ops and (not pending or rng.random() < 0.5):
            p = free.pop(rng.randrange(len(free)))
            f = "views" if rng.random() < p_views else "inspect"
            pending[p] = f
            rows.append((p, INVOKE, f, None))
            done += 1
            continue
        p = rng.choice(sorted(pending))
        f = pending.pop(p)
        free.append(p)
        if rng.random() < p_timeout:
            rows.append((p, INFO, f, None))
        elif f == "inspect":
            rows.append((p, OK, f, view[nodes[p % n_nodes]]))
        else:
            rows.append((p, OK, f, [(n, *view[n]) for n in nodes]))
    return build_history(rows)


def write_run(store_root, name: str, workload: str, history: History,
              **params) -> str:
    """Write `history` as one run of `workload` under
    `store_root`/`name`/<timestamp>/ through `core/store.save_test`
    (history.jsonl, results.json, test.json and the `latest` symlink);
    `params` go into test.json. Returns the run dir."""
    from ..core.store import save_test

    test = {"name": name, "workload": workload,
            "store_root": str(store_root), **params}
    return save_test(test, history, {"synthesized": True})


def keyed_register_run(store_root, seed: int, **shape) -> str:
    """`keyed_register_history(random.Random(seed), **shape)` written as a
    multi-register run."""
    h = keyed_register_history(random.Random(seed), **shape)
    return write_run(store_root, "multi-register", "multi-register", h,
                     seed=seed, nemesis="partition", **shape)


def counter_run(store_root, seed: int, n_ops: int = 1000, n_procs: int = 5,
                crash_p: float = 0.05, max_crashes: int = 3) -> str:
    """A counter run of the reference suite's counter shape (bench.py
    config 2: 1000 ops, 5 processes, crash_p 0.05, ≤ 3 crashes), drawn
    by `random_valid_history(random.Random(seed), "counter", ...)`."""
    shape = dict(n_ops=n_ops, n_procs=n_procs, crash_p=crash_p,
                 max_crashes=max_crashes)
    h = random_valid_history(random.Random(seed), "counter", **shape)
    return write_run(store_root, "counter", "counter", h, seed=seed,
                     **shape)


def election_run(store_root, seed: int, **shape) -> str:
    """`election_history(random.Random(seed), **shape)` written as an
    election run."""
    h = election_history(random.Random(seed), **shape)
    return write_run(store_root, "election", "election", h, seed=seed,
                     **shape)


def election_observation_rows(rng, B: int, N: int, n_terms: int = 64,
                              n_leaders: int = 5):
    """[B, N, 2] int32 numpy rows of pooled (term, leader) observations,
    safe by construction: terms drawn from [0, n_terms), one leader per
    term (numpy Generator `rng`). Rows to plant conflicts in are the
    caller's to edit."""
    import numpy as np

    lead = rng.integers(0, n_leaders, size=(B, n_terms), dtype=np.int32)
    terms = rng.integers(0, n_terms, size=(B, N), dtype=np.int32)
    leaders = np.take_along_axis(lead, terms, axis=1)
    return np.stack([terms, leaders], axis=2).astype(np.int32)
