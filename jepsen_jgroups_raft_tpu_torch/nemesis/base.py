"""Nemesis protocol.

Equivalent of jepsen.nemesis/Nemesis (setup!/invoke!/teardown!) plus
composition by op kind (what jepsen.nemesis.combined/compose-packages does
for the reference at nemesis.clj:46).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from ..history.ops import Op


class Nemesis:
    def setup(self, test: dict) -> "Nemesis":
        return self

    def invoke(self, test: dict, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        return None

    #: op kinds (f values) this nemesis handles; used for composition.
    fs: Iterable[str] = ()


class NoopNemesis(Nemesis):
    def invoke(self, test, op):
        return op.replace(value="noop")


class ComposedNemesis(Nemesis):
    """Route ops to children by op.f."""

    def __init__(self, children: Iterable[Nemesis]):
        self.children = list(children)
        self.routes: Dict[str, Nemesis] = {}
        for c in self.children:
            for f in c.fs:
                if f in self.routes:
                    raise ValueError(f"two nemeses both handle f={f!r}")
                self.routes[f] = c

    def setup(self, test):
        self.children = [c.setup(test) for c in self.children]
        self.routes = {}
        for c in self.children:
            for f in c.fs:
                self.routes[f] = c
        return self

    def invoke(self, test, op):
        child = self.routes.get(op.f)
        if child is None:
            return op.replace(value=f"no nemesis handles {op.f}")
        return child.invoke(test, op)

    def teardown(self, test):
        for c in self.children:
            c.teardown(test)


def compose_nemeses(children: Iterable[Optional[Nemesis]]) -> Nemesis:
    kids = [c for c in children if c is not None]
    if not kids:
        return NoopNemesis()
    if len(kids) == 1:
        return kids[0]
    return ComposedNemesis(kids)
