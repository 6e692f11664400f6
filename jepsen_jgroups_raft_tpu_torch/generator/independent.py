"""Multi-key decomposition: independent concurrent generator.

Equivalent of jepsen.independent/concurrent-generator + tuple values
(reference register.clj:112-117): client threads are partitioned into
groups of `n`; each group works one key at a time, running `gen_fn(key)`
until it exhausts, then moving to the next key from `keys`. Emitted op
values are wrapped as ``(key, value)`` tuples; the independent checker
(checker/independent.py) splits the history back per key — giving the
batch dimension the checker runs as one batch on the card
(SURVEY.md §2.4).

Stateful by design (group bookkeeping), safe because the interpreter calls
op() under the scheduler lock.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

from .base import NEMESIS_THREAD, PENDING, Generator, to_gen


def tuple_value(key, value):
    """Wrap a value in the (key, value) independent tuple."""
    return (key, value)


class ConcurrentGenerator(Generator):
    def __init__(self, n: int, keys: Iterable, gen_fn: Callable):
        if n < 1:
            raise ValueError("need at least 1 thread per key")
        self.n = n
        self.keys: Iterator = iter(keys)
        self.gen_fn = gen_fn
        self.groups: dict = {}  # group id -> generator | None (exhausted)
        self.group_keys: dict = {}

    def _group_gen(self, gid: int):
        if gid not in self.groups:
            self._advance(gid)
        return self.groups[gid]

    def _advance(self, gid: int) -> None:
        try:
            key = next(self.keys)
        except StopIteration:
            self.groups[gid] = None
            self.group_keys[gid] = None
            return
        self.groups[gid] = to_gen(self.gen_fn(key))
        self.group_keys[gid] = key

    def op(self, test, ctx):
        thread = ctx.get("thread")
        if thread == NEMESIS_THREAD or thread is None:
            return PENDING, self
        gid = int(thread) // self.n
        while True:
            g = self._group_gen(gid)
            if g is None:
                # This group is out of keys. Only report global exhaustion
                # (None) when EVERY group is done — a lone None would tell
                # the scheduler the whole generator is finished (e.g. the
                # single-register workload keeps just group 0 busy; other
                # threads idle, reference register.clj:112-117 semantics).
                if all(gg is None for gg in self.groups.values()):
                    return None
                return PENDING, self
            r = g.op(test, ctx)
            if r is None:
                self._advance(gid)
                continue
            op, g2 = r
            self.groups[gid] = g2
            if op == PENDING:
                return PENDING, self
            key = self.group_keys[gid]
            out = dict(op)
            out["value"] = tuple_value(key, out.get("value"))
            return out, self
