"""Shared lock-region machinery for the concurrency analyzers.

The service tier's locking convention is uniform — every critical
section is a ``with <lock>:`` block over a ``threading.Lock`` /
``RLock`` / ``Condition`` — which makes lock *regions* a pure CFG
property: the nodes flooded from a ``with-enter`` up to the matching
``with-exit`` markers hold the lock, on every continuation the CFG
models (normal fall-through, exception unwind, early return,
break/continue — the ``finally``-style duplication in cfg.py keeps each
one explicit). Both the lock-discipline analyzer (guarded.py) and the
lock-ordering analyzer (lockorder.py) consume the same region map, so
"held at this statement" means the same thing in both.

Annotation conventions recognized here (doc/checker-design.md §18):

* ``# guarded_by(lockname)`` — trailing comment on an attribute
  *declaration* (``self.x = ...`` in ``__init__``, or a class-level
  field): every read/write of that attribute must happen while the
  declaring object's ``lockname`` is held.
* ``# requires(lockname)`` — trailing comment on a ``def`` line: the
  method's *callers* hold ``self.lockname``; the body is analyzed as if
  the lock were held throughout (the Python twin of native/'s
  ``// REQUIRES(mu_)``).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ..base import SourceFile
from .cfg import CFG, EXC

_GUARDED_RE = re.compile(r"#\s*guarded_by\((\w+)\)")
_REQUIRES_RE = re.compile(r"#\s*requires\((\w+)\)")

#: dotted-name tail segments treated as locks when they appear as a
#: ``with`` context (``self._lock``, ``sess.lock``, ``self._gcond``,
#: module-level ``_DETAIL_STORE_LOCK`` ...).
_LOCKISH = ("lock", "cond", "mutex", "mu")


def dotted(expr: ast.AST) -> Optional[str]:
    """``a.b.c`` for a pure Name/Attribute chain, else None (calls,
    subscripts and anything computed cannot name a stable lock)."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def is_lockish(name: str) -> bool:
    tail = name.rsplit(".", 1)[-1].lower()
    return any(seg in tail for seg in _LOCKISH)


def node_locks(node) -> Set[str]:
    """Dotted lock names acquired at a ``with-enter`` node."""
    if node.label != "with-enter":
        return set()
    out = set()
    for item in node.stmt.items:
        d = dotted(item.context_expr)
        if d is not None and is_lockish(d):
            out.add(d)
    return out


def lock_regions(cfg: CFG) -> Dict[int, Set[str]]:
    """node idx → set of dotted lock names held *at* that node.

    Flood-fill from each lock-acquiring ``with-enter``'s non-exception
    successors (an ``__enter__`` that raised never took the lock),
    stopping at the ``with-exit`` markers of the same statement — the
    CFG has one marker per escaping continuation, so exception and
    early-return paths end the region exactly where ``__exit__`` runs.
    """
    held: Dict[int, Set[str]] = {n.idx: set() for n in cfg.nodes}
    for enter in cfg.find("with-enter"):
        locks = node_locks(enter)
        if not locks:
            continue
        stmt = enter.stmt
        stack = [s for s, k in enter.succs if k != EXC]
        seen: Set[int] = set()
        while stack:
            n = stack.pop()
            if n.idx in seen:
                continue
            seen.add(n.idx)
            held[n.idx] |= locks
            if n.label == "with-exit" and n.stmt is stmt:
                continue  # lock released here — do not flood past it
            stack.extend(s for s, _k in n.succs)
    return held


def _stmt_comment_match(src: SourceFile, rx: re.Pattern, lo: int,
                        hi: int) -> Optional[str]:
    lines = src.text.splitlines()
    for i in range(lo, hi + 1):
        if 1 <= i <= len(lines):
            m = rx.search(lines[i - 1])
            if m:
                return m.group(1)
    return None


def guarded_decls(src: SourceFile,
                  tree: ast.AST) -> Dict[Tuple[str, str], str]:
    """``{(classname, attr): lockname}`` from ``# guarded_by(...)``
    comments on attribute declarations — ``self.attr = ...`` statements
    anywhere in the class body, plus class-level (dataclass-style)
    field declarations."""
    decls: Dict[Tuple[str, str], str] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (sub.targets if isinstance(sub, ast.Assign)
                       else [sub.target])
            hi = getattr(sub, "end_lineno", sub.lineno) or sub.lineno
            lock = _stmt_comment_match(src, _GUARDED_RE, sub.lineno, hi)
            if lock is None:
                continue
            for tgt in targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    decls.setdefault((node.name, tgt.attr), lock)
                elif isinstance(tgt, ast.Name):
                    # class-level field (dataclass / class attribute)
                    decls.setdefault((node.name, tgt.id), lock)
    return decls


def fn_requires(src: SourceFile, fn: ast.FunctionDef) -> Set[str]:
    """Lock attribute names a ``# requires(...)`` comment on the def
    line (or a continuation line of a multi-line signature) declares as
    held by every caller."""
    hi = fn.body[0].lineno - 1 if fn.body else fn.lineno
    out: Set[str] = set()
    lines = src.text.splitlines()
    for i in range(fn.lineno, max(hi, fn.lineno) + 1):
        if 1 <= i <= len(lines):
            for m in _REQUIRES_RE.finditer(lines[i - 1]):
                out.add(m.group(1))
    return out


def walk_expr(root: ast.AST):
    """ast.walk over one evaluated expression/statement, not descending
    into lambdas or nested defs (their bodies run later, possibly on a
    different thread with different locks held)."""
    stack: List[ast.AST] = [root]
    while stack:
        node = stack.pop()
        if node is not root and isinstance(
                node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))
