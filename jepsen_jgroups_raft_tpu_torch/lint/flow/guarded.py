"""Lock-discipline analyzer: guarded attributes accessed off-guard.

The service tier's thread-safety story is annotation + convention:
mutable shared state (daemon registries, scheduler queues, stream
session tables, journal group-commit state) is declared with a trailing
``# guarded_by(lockname)`` comment, and every access is supposed to sit
inside a ``with self.lockname:`` region (or in a method whose callers
hold it, declared ``# requires(lockname)``). The last five hardening
rounds each found a real violation of exactly this convention by review
— shutdown/submit races, stats read outside the daemon lock, a torn
inflight-table read. This analyzer makes the convention checkable: it
resolves lock regions on the CFG (locks.lock_regions — so try/finally,
early return and exception paths are all modeled) and flags any
read/write of a guarded attribute at a node where the declaring
object's lock is not held.

Model (biased against false positives, like resource.py):

* ``self.attr`` accesses are checked only inside the *declaring* class
  (another class's same-named attribute is a different field).
* ``obj.attr`` cross-object accesses are checked when ``attr`` is
  declared guarded by exactly one class in the file and ``obj`` is not
  a local born from a constructor call in the same function (a freshly
  constructed object is not yet shared).
* ``__init__`` bodies are exempt for ``self`` — construction happens
  before the object escapes to other threads.
* Reads via snapshot methods, deliberate racy fast-paths etc. carry
  ``# lint: allow(unguarded)`` with a reason comment.

Rule: ``flow-unguarded-access`` (pragma alias ``unguarded``). Scan set:
``service/``, ``parallel/``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from ..base import Finding, SourceFile, pkg_rel
from .cfg import build_cfg, functions_of, own_exprs
from .locks import (dotted, fn_requires, guarded_decls, lock_regions,
                    walk_expr)

RULE = "flow-unguarded-access"

SCAN_PREFIXES = ("service/", "parallel/")


def applies_to(relpath: str) -> bool:
    rp = pkg_rel(relpath)
    return rp.startswith(SCAN_PREFIXES)


def _constructed_locals(fn: ast.FunctionDef) -> Set[str]:
    """Names assigned from a constructor-looking call (capitalized
    callee) in this function: the object is local-born, not shared."""
    out: Set[str] = set()
    for node in walk_expr(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            callee = node.value.func
            name = callee.id if isinstance(callee, ast.Name) else (
                callee.attr if isinstance(callee, ast.Attribute) else "")
            if name[:1].isupper():
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
    return out


def _analyze_function(src: SourceFile, clsname: str, fn: ast.FunctionDef,
                      decls: Dict[Tuple[str, str], str],
                      by_attr: Dict[str, List[Tuple[str, str]]]
                      ) -> List[Finding]:
    init = fn.name == "__init__"
    cfg = build_cfg(fn)
    held = lock_regions(cfg)
    required = fn_requires(src, fn)
    born = _constructed_locals(fn)
    findings: List[Finding] = []
    reported: Set[Tuple[int, str]] = set()
    for node in cfg.nodes:
        for expr in own_exprs(node):
            for sub in walk_expr(expr):
                if not isinstance(sub, ast.Attribute):
                    continue
                base = dotted(sub.value)
                if base is None:
                    continue
                attr = sub.attr
                if base == "self":
                    if init:
                        continue
                    lock = decls.get((clsname, attr))
                    if lock is None:
                        continue
                    if lock in required:
                        continue
                else:
                    owners = by_attr.get(attr, [])
                    if len(owners) != 1:
                        continue
                    if base.split(".", 1)[0] in born:
                        continue
                    lock = owners[0][1]
                if f"{base}.{lock}" in held[node.idx]:
                    continue
                line = getattr(sub, "lineno", node.line)
                key = (line, f"{base}.{attr}")
                if key in reported:
                    continue
                reported.add(key)
                if src.allowed(line, RULE) or src.allowed(line, "unguarded"):
                    continue
                findings.append(Finding(
                    src.path, line, RULE,
                    f"`{base}.{attr}` is guarded_by({lock}) but accessed "
                    f"without holding `{base}.{lock}` — wrap the access in "
                    f"`with {base}.{lock}:`, mark the method "
                    f"`# requires({lock})` if callers hold it, or record "
                    "the deliberate race with `# lint: allow(unguarded)` "
                    "+ a reason"))
    return findings


def analyze_source(src: SourceFile) -> List[Finding]:
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    decls = guarded_decls(src, tree)
    if not decls:
        return []
    by_attr: Dict[str, List[Tuple[str, str]]] = {}
    for (cls, attr), lock in decls.items():
        by_attr.setdefault(attr, []).append((cls, lock))
    findings: List[Finding] = []
    for cls, fn in functions_of(tree):
        findings.extend(_analyze_function(
            src, cls.name if cls is not None else "", fn, decls, by_attr))
    return findings


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
