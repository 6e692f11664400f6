"""Core generator combinators (see package docstring for the protocol).

A copy of the reference's `generator/base.py`. One difference: `Stagger`
takes its random source (`rng`: a `random.Random` or a seed), so a run
built from a seed draws the same gaps; without one it keeps the
reference's unseeded generator."""

from __future__ import annotations

import logging
import random
from typing import Callable, Optional, Sequence

LOG = logging.getLogger("jgraft.generator")

#: "nothing for this thread right now" marker.
PENDING = "pending"

NEMESIS_THREAD = "nemesis"


class Generator:
    def op(self, test: dict, ctx: dict):
        raise NotImplementedError

    def update(self, test: dict, ctx: dict, event) -> "Generator":
        return self


def to_gen(x) -> Optional[Generator]:
    """Coerce: Generator | op-dict | callable(test, ctx)->op | list | None."""
    if x is None or isinstance(x, Generator):
        return x
    if isinstance(x, dict):
        return Seq([x])
    if callable(x):
        return OpFn(x)
    if isinstance(x, (list, tuple)):
        return Seq(list(x))
    raise TypeError(f"cannot make a generator from {x!r}")


class OpFn(Generator):
    """Infinite generator from a function (test, ctx) -> op dict."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def op(self, test, ctx):
        return dict(self.fn(test, ctx)), self


class Repeat(Generator):
    """Emit the same op template forever (or n times)."""

    def __init__(self, op_map: dict, n: Optional[int] = None):
        self.op_map = dict(op_map)
        self.n = n

    def op(self, test, ctx):
        if self.n is not None and self.n <= 0:
            return None
        nxt = Repeat(self.op_map, None if self.n is None else self.n - 1)
        return dict(self.op_map), nxt


class Seq(Generator):
    """Run children (generators or op maps) to exhaustion, in order."""

    def __init__(self, items: Sequence):
        self.items = list(items)

    def op(self, test, ctx):
        items = self.items
        while items:
            head = items[0]
            if isinstance(head, dict):
                return dict(head), Seq(items[1:])
            g = to_gen(head)
            r = g.op(test, ctx)
            if r is None:
                items = items[1:]
                continue
            op, g2 = r
            return op, Seq([g2] + items[1:])
        return None

    def update(self, test, ctx, event):
        if self.items and isinstance(self.items[0], Generator):
            return Seq([self.items[0].update(test, ctx, event)] + self.items[1:])
        return self


def Phases(*gens) -> Seq:
    """Sequential phases with a synchronization barrier between them
    (jepsen gen/phases): phase N+1 starts only after every phase-N op has
    *completed*, not merely been handed out — otherwise "final" reads run
    concurrently with unfinished earlier ops and the phase isolation the
    reference's schedule relies on (raft.clj:78-91) silently weakens."""
    items: list = []
    for g in gens:
        items.append(g)
        items.append(Synchronize())
    return Seq(items[:-1] if items else items)


class Mix(Generator):
    """Pick a random child for each emission (jepsen gen/mix). Children are
    op maps or op functions; exhausted children drop out."""

    def __init__(self, choices: Sequence, seed: Optional[int] = None):
        self.choices = list(choices)
        self.rng = random.Random(seed)

    def op(self, test, ctx):
        choices = self.choices
        while choices:
            i = self.rng.randrange(len(choices))
            g = to_gen(choices[i])
            r = g.op(test, ctx)
            if r is None:
                choices = choices[:i] + choices[i + 1:]
                continue
            op, g2 = r
            # __new__ clone: Mix() would reseed a fresh Random from OS
            # entropy on every emission, under the scheduler lock.
            nxt = Mix.__new__(Mix)
            nxt.rng = self.rng
            nxt.choices = choices[:i] + [g2] + choices[i + 1:]
            return op, nxt
        return None


class Stagger(Generator):
    """Space emissions ~dt seconds apart on average (uniform 0..2dt gaps),
    across all threads (jepsen gen/stagger — reference raft.clj:80).
    `rng` is the gaps' source: a `random.Random`, a seed, or None for a
    generator seeded from the OS (the reference's behaviour)."""

    def __init__(self, dt: float, gen, _next_at: Optional[int] = None,
                 rng=None):
        self.dt = dt
        self.gen = to_gen(gen)
        self.next_at = _next_at  # ns timestamp of next allowed emission
        self.rng = (rng if isinstance(rng, random.Random)
                    else random.Random(rng))

    def _with(self, gen, next_at) -> "Stagger":
        # __new__ clone: Stagger() reseeds a Random from OS entropy; this
        # runs once per emitted op under the scheduler lock.
        nxt = Stagger.__new__(Stagger)
        nxt.dt = self.dt
        nxt.gen = gen
        nxt.next_at = next_at
        nxt.rng = self.rng
        return nxt

    def op(self, test, ctx):
        now = ctx["time"]
        next_at = self.next_at if self.next_at is not None else now
        if now < next_at:
            return PENDING, self
        r = self.gen.op(test, ctx)
        if r is None:
            return None
        if r[0] == PENDING:
            return PENDING, self._with(r[1], next_at)
        op, g2 = r
        gap = int(self.rng.uniform(0, 2 * self.dt) * 1e9)
        # Clamp catch-up: if we fell far behind (idle workers), restart the
        # cadence from now instead of emitting a burst.
        base = next_at if next_at > now - 2 * gap else now
        return op, self._with(g2, base + gap)

    def update(self, test, ctx, event):
        return self._with(self.gen.update(test, ctx, event), self.next_at)


class Limit(Generator):
    """At most n emissions (jepsen gen/limit)."""

    def __init__(self, n: int, gen):
        self.n = n
        self.gen = to_gen(gen)

    def op(self, test, ctx):
        if self.n <= 0:
            return None
        r = self.gen.op(test, ctx)
        if r is None:
            return None
        op, g2 = r
        if op == PENDING:
            return PENDING, Limit(self.n, g2)
        return op, Limit(self.n - 1, g2)

    def update(self, test, ctx, event):
        return Limit(self.n, self.gen.update(test, ctx, event))


class TimeLimit(Generator):
    """Stop emitting after `secs` of test time (jepsen gen/time-limit)."""

    def __init__(self, secs: float, gen, _deadline: Optional[int] = None):
        self.secs = secs
        self.gen = to_gen(gen)
        self.deadline = _deadline

    def op(self, test, ctx):
        deadline = self.deadline
        if deadline is None:
            deadline = ctx["time"] + int(self.secs * 1e9)
        if ctx["time"] >= deadline:
            return None
        r = self.gen.op(test, ctx)
        if r is None:
            return None
        op, g2 = r
        return op, TimeLimit(self.secs, g2, deadline)

    def update(self, test, ctx, event):
        return TimeLimit(self.secs, self.gen.update(test, ctx, event),
                         self.deadline)


class Sleep(Generator):
    """Emit nothing for `secs`, then exhaust (jepsen gen/sleep)."""

    def __init__(self, secs: float, _until: Optional[int] = None):
        self.secs = secs
        self.until = _until

    def op(self, test, ctx):
        until = self.until
        if until is None:
            until = ctx["time"] + int(self.secs * 1e9)
            return PENDING, Sleep(self.secs, until)
        if ctx["time"] >= until:
            return None
        return PENDING, self


class Delay(Generator):
    """At least `dt` seconds between successive emissions (jepsen
    gen/delay — used by the membership flip-flop, membership.clj:110)."""

    def __init__(self, dt: float, gen, _next_at: int = 0):
        self.dt = dt
        self.gen = to_gen(gen)
        self.next_at = _next_at

    def op(self, test, ctx):
        if ctx["time"] < self.next_at:
            return PENDING, self
        r = self.gen.op(test, ctx)
        if r is None:
            return None
        op, g2 = r
        if op == PENDING:
            return PENDING, Delay(self.dt, g2, self.next_at)
        return op, Delay(self.dt, g2, ctx["time"] + int(self.dt * 1e9))


class Log(Generator):
    """Log a message once, emit nothing (jepsen gen/log)."""

    def __init__(self, message: str, _done: bool = False):
        self.message = message
        self.done = _done

    def op(self, test, ctx):
        # Mutating under the scheduler lock; containers that re-poll
        # exhausted children (Any) must not re-log on every poll.
        if not self.done:
            self.done = True
            LOG.info(self.message)
        return None  # logging is a side effect; nothing to emit


class FlipFlop(Generator):
    """Alternate emissions between two generators (jepsen gen/flip-flop;
    reference membership.clj:105-111 alternates shrink/grow)."""

    def __init__(self, a, b, _turn: int = 0):
        self.gens = [to_gen(a), to_gen(b)]
        self.turn = _turn

    def op(self, test, ctx):
        g = self.gens[self.turn]
        if g is None:
            return None
        r = g.op(test, ctx)
        if r is None:
            return None
        op, g2 = r
        pair = list(self.gens)
        pair[self.turn] = g2
        if op == PENDING:
            return PENDING, FlipFlop(pair[0], pair[1], self.turn)
        return op, FlipFlop(pair[0], pair[1], 1 - self.turn)


class _Routed(Generator):
    """Restrict a child generator to a class of threads.

    Exhaustion is sticky and visible to ALL threads: once the child
    returns None (observable only on a matching thread's poll), the other
    thread class must see None too — otherwise an Any(clients, nemesis)
    pair deadlocks, each side reporting PENDING to the other forever.
    Mutating the flag is safe: generator calls run under the scheduler
    lock.
    """

    nemesis: bool

    def __init__(self, gen):
        self.gen = to_gen(gen)
        self.dead = self.gen is None

    def _mine(self, ctx) -> bool:
        is_nem = ctx.get("thread") == NEMESIS_THREAD
        return is_nem == self.nemesis

    def op(self, test, ctx):
        if self.dead:
            return None
        if not self._mine(ctx):
            return PENDING, self
        r = self.gen.op(test, ctx)
        if r is None:
            self.dead = True
            return None
        op, g2 = r
        if g2 is self.gen:
            return op, self
        return op, type(self)(g2)

    def update(self, test, ctx, event):
        return type(self)(self.gen.update(test, ctx, event))


class NemesisGen(_Routed):
    """Ops for the nemesis thread only (jepsen gen/nemesis)."""

    nemesis = True


class Clients(_Routed):
    """Ops for client threads only (jepsen gen/clients)."""

    nemesis = False


class Any(Generator):
    """Offer ops from whichever child has one for the asking thread
    (jepsen's implicit merge of client + nemesis streams). Exhausts when
    every child is exhausted."""

    def __init__(self, *gens):
        self.gens = [to_gen(g) for g in gens if g is not None]

    def op(self, test, ctx):
        # Exhausted children are dropped so they aren't re-polled forever.
        new = []
        found = None
        for g in self.gens:
            if found is not None:
                new.append(g)
                continue
            r = g.op(test, ctx)
            if r is None:
                continue
            op, g2 = r
            new.append(g2)
            if op != PENDING:
                found = op
        if not new:
            return None
        out = Any()
        out.gens = new
        return (found if found is not None else PENDING), out

    def update(self, test, ctx, event):
        out = Any()
        out.gens = [g.update(test, ctx, event) for g in self.gens]
        return out


class Synchronize(Generator):
    """Barrier: emit nothing until every worker is idle, then exhaust
    (jepsen gen/synchronize semantics, approximated via the interpreter's
    busy-thread count in ctx)."""

    def op(self, test, ctx):
        if ctx.get("busy", 0) > 0:
            return PENDING, self
        return None
