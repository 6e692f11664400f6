"""Fault↔heal pairing analyzer for the nemesis tier.

A nemesis that injects a fault and loses track of it silently
invalidates the run: a never-healed partition/pause turns the final
read phase into timeouts, and a never-restarted node makes "valid"
vacuous (the history just stops exercising the SUT). The runner
guarantees ``teardown`` runs (core/runner.py nemesis_worker's
``finally``), so the contract this rule enforces is *accountability*,
not inline healing:

    every path out of a function that performed a fault call —
    **including exception edges** — must either (a) complete the
    matching heal call, (b) register the affliction in instance state
    (``self.<set>.add(...)`` / ``self.<dict>[k] = …``) so teardown can
    undo it, or (c) be blanket-covered by a ``teardown`` in the class
    (or a same-module base class) that heals unconditionally — a heal
    call NOT inside a loop over instance state. A teardown that heals
    ``for n in self.afflicted`` only covers what was registered, so it
    deliberately does not discharge sites; that is what (b) is for.

Deliberate unhealed faults (crash workloads, members leaving the
cluster for good) carry ``# lint: allow(unhealed)`` on the fault line
with a comment saying why — the pragma inventory is the audit trail.

Coarseness, on purpose: which *node* a heal targets is not tracked (a
heal of any node discharges the path), and a method whose entire body
is a single delegating fault call (``KillNemesis._do``) is the
primitive itself, analyzed at its call sites, not flagged.

Rule: ``flow-unhealed-fault``. Scan set (CLI): ``nemesis/``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..base import Finding, SourceFile, pkg_rel
from .cfg import EXC, build_cfg, functions_of, own_exprs, reach, walk_own

#: fault attribute-call name -> names whose successful completion heals
#: it. `_do` is the shared toggle-nemesis hook (its heal is `_undo`);
#: a removed member is regrown, so `add_member` pairs `remove_member`.
FAULT_HEALS: Dict[str, Set[str]] = {
    "partition": {"heal"},
    "kill": {"start", "restart"},
    "pause": {"resume"},
    "_do": {"_undo"},
    "remove_member": {"add_member"},
}

#: method names that count as registration containers regardless of the
#: attribute they are called on, provided the receiver hangs off `self`.
_REGISTER_CALLS = {"add", "append", "insert", "update"}

SCAN_PREFIXES = ("nemesis/",)

RULE = "flow-unhealed-fault"


def applies_to(relpath: str) -> bool:
    rp = pkg_rel(relpath)
    return rp.startswith(SCAN_PREFIXES)


# ------------------------------------------------------------ AST helpers


def _attr_calls(node: ast.AST):
    """(call, attr-name) for attribute calls in an expression subtree."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            yield sub, sub.func.attr


def _node_attr_calls(node):
    """Attribute calls evaluated AT a CFG node (header exprs only)."""
    for expr in own_exprs(node):
        yield from _attr_calls(expr)


def _touches_self(node: ast.AST) -> bool:
    return any(isinstance(s, ast.Name) and s.id == "self"
               for s in ast.walk(node))


def _is_registration(node) -> bool:
    """self.<container>.add/append/…(x) or self.<container>[k] = x."""
    for call, attr in _node_attr_calls(node):
        if attr in _REGISTER_CALLS and _touches_self(call.func):
            return True
    for expr in own_exprs(node):
        if isinstance(expr, ast.Assign):
            for tgt in expr.targets:
                if isinstance(tgt, ast.Subscript) and \
                        _touches_self(tgt.value):
                    return True
    return False


def _heal_at_node(node, heals: Set[str]) -> bool:
    return any(attr in heals for _, attr in _node_attr_calls(node))


def _fault_sites(fn: ast.FunctionDef):
    """Every fault attribute call in the function's own frame (nested
    defs get analyzed as their own functions)."""
    for sub in walk_own(fn):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Attribute) and \
                sub.func.attr in FAULT_HEALS:
            yield sub, sub.func.attr


def _is_delegating_wrapper(fn: ast.FunctionDef) -> bool:
    """Body (minus docstring) is a single fault-call statement — the
    method IS the primitive; analyzed at its call sites."""
    body = [s for s in fn.body
            if not (isinstance(s, ast.Expr) and
                    isinstance(s.value, ast.Constant) and
                    isinstance(s.value.value, str))]
    return (len(body) == 1 and isinstance(body[0], ast.Expr) and
            isinstance(body[0].value, ast.Call) and
            any(attr in FAULT_HEALS
                for _, attr in _attr_calls(body[0])))


# ------------------------------------------------------- class-level pass


def _class_map(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.ClassDef)}


def _mro_methods(cls: Optional[ast.ClassDef], classes, name: str):
    """`name` methods along the same-module single-inheritance chain."""
    seen = set()
    while cls is not None and cls.name not in seen:
        seen.add(cls.name)
        for stmt in cls.body:
            if isinstance(stmt, ast.FunctionDef) and stmt.name == name:
                yield stmt
        nxt = None
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes:
                nxt = classes[base.id]
                break
        cls = nxt


def _blanket_teardown(cls: Optional[ast.ClassDef], classes,
                      heals: Set[str]) -> bool:
    """Does teardown heal unconditionally (not just over a registry)?
    A heal inside a ``for`` iterating instance state only covers
    registered afflictions, so it does not blanket-discharge."""
    for td in _mro_methods(cls, classes, "teardown"):
        loops = [n for n in ast.walk(td)
                 if isinstance(n, ast.For) and _touches_self(n.iter)]
        in_loop = set()
        for lp in loops:
            for sub in ast.walk(lp):
                in_loop.add(id(sub))
        for call, attr in _attr_calls(td):
            if attr in heals and id(call) not in in_loop:
                return True
    return False


# --------------------------------------------------------------- analysis


def _analyze_function(src: SourceFile, cls, classes,
                      fn: ast.FunctionDef) -> List[Finding]:
    if _is_delegating_wrapper(fn):
        return []
    sites = [(call, kind) for call, kind in _fault_sites(fn)
             if not (src.allowed(call.lineno, RULE) or
                     src.allowed(call.lineno, "unhealed"))]
    if not sites:
        return []
    cfg = build_cfg(fn)
    findings: List[Finding] = []
    for call, kind in sites:
        heals = FAULT_HEALS[kind]
        if _blanket_teardown(cls, classes, heals):
            continue
        # the CFG node whose own (header) expressions contain this call
        site_nodes = [n for n in cfg.nodes
                      if any(sub is call for e in own_exprs(n)
                             for sub in ast.walk(e))]
        for node in site_nodes:
            # analysis starts at the fault's NORMAL completion: if the
            # fault call itself raised, the fault may not have landed.
            starts = [s for s, k in node.succs if k != EXC]

            def stop(n, kind_in, _heals=heals, _site=node):
                if _is_registration(n):
                    return "kill"
                if n is cfg.exit or n is cfg.raise_exit:
                    return "report"
                if n is not _site and _heal_at_node(n, _heals):
                    # completing the heal discharges; the heal call
                    # RAISING does not — keep walking its exc edge.
                    return {EXC}
                return None

            escapes = reach(cfg, starts, stop)
            if escapes:
                via = escapes[0]
                how = ("an exception path"
                       if via and via[-1] is cfg.raise_exit
                       else "a normal exit")
                findings.append(Finding(
                    src.path, call.lineno, RULE,
                    f"`{kind}` fault in `{fn.name}` can escape un-healed "
                    f"via {how}: no {'/'.join(sorted(heals))} completes "
                    "and the affliction is not registered in instance "
                    "state for teardown; heal it, register it, or "
                    "annotate `# lint: allow(unhealed)` with why"))
                break  # one finding per fault call site
    return findings


def analyze_source(src: SourceFile) -> List[Finding]:
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    classes = _class_map(tree)
    findings: List[Finding] = []
    for cls, fn in functions_of(tree):
        findings.extend(_analyze_function(src, cls, classes, fn))
    return findings


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
