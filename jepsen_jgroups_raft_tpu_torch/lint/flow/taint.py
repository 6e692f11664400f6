"""Shared taint lattice for the graftgate tier.

The four verdict-integrity analyzers (fingerprint, degraded, knobclass,
tierstamp) all reduce to the same two primitives over the §7 CFG:

* **guard polarity** — classify an ``if`` test's arms against a
  predicate family: which outgoing edge kind (TRUE/FALSE) *establishes*
  a fact about the guarded region. The weak-rung family proves
  ``consistency != "linearizable"`` on an arm (``!=`` / ``== <weak
  rung>`` conjuncts establish it on TRUE; ``== "linearizable"``
  disjuncts establish it on FALSE — an ``or`` arm is only sound on the
  all-false side, an ``and`` arm only on the all-true side). The
  degraded family proves "this value carries no platform-degraded
  stamp" the same way (``not <degraded-atom>`` conjuncts on TRUE, bare
  degraded atoms on FALSE).
* **guard dominance** — a node is dominated by a guard family iff it is
  unreachable from the CFG entry once every establishing edge is
  removed: each surviving path would be a path that reaches the node
  with the fact unproven. This is sound on the §7 graph because edge
  kinds are preserved through finally-instances and joins
  (``cfg._Builder.connect``).

Both are syntactic: a guard spelled through a helper this module does
not know (or a value laundered through a container) is reported, and
the fix is a ``# lint: allow(...)`` pragma with a reason — exactly the
written-record contract of the earlier tiers (doc/checker-design.md
§19).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .cfg import CFG, FALSE, TRUE, Node, walk_own

#: the strongest rung; everything else is "weak" (consistency.py's
#: CONSISTENCY_LEVELS — re-stated here so the lint package stays
#: import-free of the checker).
LIN = "linearizable"
WEAK_RUNGS = ("sequential", "session")

#: substrings marking a degraded-result atom: the stamp key itself and
#: the `is_degraded` / `stats.get("degraded")` helper idioms.
DEGRADED_MARKERS = ("platform-degraded", "degraded")


def call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def dotted(expr: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _conjuncts(test: ast.AST) -> List[ast.AST]:
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return [c for t in test.values for c in _conjuncts(t)]
    return [test]


def _disjuncts(test: ast.AST) -> List[ast.AST]:
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
        return [d for t in test.values for d in _disjuncts(t)]
    return [test]


def _str_consts(node: ast.AST) -> Set[str]:
    return {s.value for s in ast.walk(node)
            if isinstance(s, ast.Constant) and isinstance(s.value, str)}


# ------------------------------------------------------ weak-rung guards


def _weak_positive(expr: ast.AST, wnames: Set[str]) -> bool:
    """True when `expr` being true implies the rung is weak."""
    if isinstance(expr, ast.Name) and expr.id in wnames:
        return True
    if not (isinstance(expr, ast.Compare) and len(expr.ops) == 1):
        return False
    op = expr.ops[0]
    sides = {expr.left, expr.comparators[0]}
    consts = {s.value for s in sides if isinstance(s, ast.Constant)}
    if isinstance(op, ast.NotEq):
        return LIN in consts
    if isinstance(op, ast.Eq):
        return bool(consts & set(WEAK_RUNGS))
    if isinstance(op, ast.NotIn):
        return LIN in _str_consts(expr.comparators[0])
    return False


def _lin_positive(expr: ast.AST) -> bool:
    """True when `expr` being FALSE implies the rung is weak (i.e. the
    expression asserts linearizable — or something ⊇ it, which is
    still sound: all-disjuncts-false refutes this one too)."""
    if not (isinstance(expr, ast.Compare) and len(expr.ops) == 1):
        return False
    op = expr.ops[0]
    sides = {expr.left, expr.comparators[0]}
    consts = {s.value for s in sides if isinstance(s, ast.Constant)}
    if isinstance(op, ast.Eq):
        return LIN in consts
    if isinstance(op, ast.In):
        names = _str_consts(expr.comparators[0])
        # `in (None, "linearizable")`: false ⟹ not linearizable, as
        # long as no WEAK rung sits in the same tuple
        return LIN in names and not (names & set(WEAK_RUNGS))
    return False


def weak_assign_names(fn: ast.AST) -> Set[str]:
    """Local names bound to a weak-positive expression (the
    ``weak = consistency != "linearizable"`` idiom)."""
    out: Set[str] = set()
    for node in walk_own(fn):
        if isinstance(node, ast.Assign) and \
                _weak_positive(node.value, out | set()):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def weak_edges(test: ast.AST, wnames: Set[str]) -> Set[str]:
    """Edge kinds out of an ``if test:`` that establish a weak rung."""
    kinds: Set[str] = set()
    if any(_weak_positive(c, wnames) for c in _conjuncts(test)):
        kinds.add(TRUE)
    if any(_lin_positive(d) for d in _disjuncts(test)):
        kinds.add(FALSE)
    return kinds


# ------------------------------------------------------- degraded guards


def _degraded_atom(expr: ast.AST) -> bool:
    """Does evaluating `expr` test for a degrade stamp? Matches the
    repo idioms: ``"platform-degraded" in r`` (incl. inside any(...)),
    ``is_degraded(...)``, ``.stats.get("degraded")``."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Constant) and \
                sub.value in DEGRADED_MARKERS:
            return True
        if isinstance(sub, ast.Call) and \
                "degraded" in call_name(sub).lower():
            return True
    return False


def clean_edges(test: ast.AST) -> Set[str]:
    """Edge kinds out of an ``if test:`` that establish "the guarded
    value is NOT degraded"."""
    kinds: Set[str] = set()
    for c in _conjuncts(test):
        if isinstance(c, ast.UnaryOp) and isinstance(c.op, ast.Not) \
                and _degraded_atom(c.operand):
            kinds.add(TRUE)
            break
    for d in _disjuncts(test):
        if not (isinstance(d, ast.UnaryOp) and
                isinstance(d.op, ast.Not)) and _degraded_atom(d):
            kinds.add(FALSE)
            break
    return kinds


# ----------------------------------------------------- guard dominance


def reachable_without(cfg: CFG, blocked) -> Set[int]:
    """Node idxs reachable from entry along edges NOT classified as
    establishing: ``blocked(node)`` returns the establishing edge
    kinds out of `node` (empty set for most nodes)."""
    seen = {cfg.entry.idx}
    stack = [cfg.entry]
    while stack:
        n = stack.pop()
        cut = blocked(n)
        for succ, kind in n.succs:
            if kind in cut:
                continue
            if succ.idx not in seen:
                seen.add(succ.idx)
                stack.append(succ)
    return seen


def guard_blocked(wnames: Set[str], edges_of):
    """A ``blocked`` callback for :func:`reachable_without` that cuts
    the establishing arms of ``if`` guards, where `edges_of` is
    :func:`weak_edges`-shaped (test, wnames) -> kinds."""
    def blocked(node: Node) -> Set[str]:
        if node.label != "if":
            return set()
        return edges_of(node.stmt.test, wnames)
    return blocked


def nodes_containing(cfg: CFG, target: ast.AST) -> List[Node]:
    """CFG nodes whose evaluated expressions contain `target` (by
    identity)."""
    from .cfg import own_exprs

    out = []
    for node in cfg.nodes:
        for expr in own_exprs(node):
            if any(sub is target for sub in ast.walk(expr)):
                out.append(node)
                break
    return out


def dominated(cfg: CFG, target: ast.AST, wnames: Set[str],
              edges_of) -> bool:
    """Is every entry→target path forced through an establishing guard
    arm? False also when the target cannot be located in the graph
    (conservative: unlocated code is unguarded code)."""
    nodes = nodes_containing(cfg, target)
    if not nodes:
        return False
    alive = reachable_without(cfg, guard_blocked(wnames, edges_of))
    return all(n.idx not in alive for n in nodes)


# --------------------------------------------------------- call graphs


class CallSite:
    __slots__ = ("caller", "call", "name")

    def __init__(self, caller: ast.AST, call: ast.Call, name: str):
        self.caller = caller
        self.call = call
        self.name = name


def calls_of(fn: ast.AST) -> List[CallSite]:
    return [CallSite(fn, node, call_name(node))
            for node in walk_own(fn) if isinstance(node, ast.Call)]


def weak_functions(functions: Sequence[Tuple[str, ast.AST, CFG]]
                   ) -> Set[str]:
    """Greatest fixpoint of "only reachable at a weak rung" over a
    bare-name call graph: a function is weak iff it has at least one
    known call site and EVERY known call site is either intra-guarded
    by a weak-rung test or lives in a weak function. Entry points (no
    call sites in the scanned set) are never weak — they are exactly
    the rung-dispatching surface."""
    by_name: Dict[str, List[Tuple[str, ast.AST, CFG]]] = {}
    for name, fn, cfg in functions:
        by_name.setdefault(name, []).append((name, fn, cfg))
    sites: Dict[str, List[Tuple[str, bool]]] = {}
    for caller_name, fn, cfg in functions:
        wnames = weak_assign_names(fn)
        for cs in calls_of(fn):
            if cs.name not in by_name:
                continue
            guarded = dominated(cfg, cs.call, wnames, weak_edges)
            sites.setdefault(cs.name, []).append((caller_name, guarded))
    weak = {name for name in by_name if sites.get(name)}
    changed = True
    while changed:
        changed = False
        for name in sorted(weak):
            ok = all(guarded or caller in weak
                     for caller, guarded in sites[name])
            if not ok:
                weak.discard(name)
                changed = True
    return weak
