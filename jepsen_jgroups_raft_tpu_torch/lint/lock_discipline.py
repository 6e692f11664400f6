"""Native lock-discipline analyzer (header-annotation checker).

The C++ tier documents its concurrency contract in comments
(``// GUARDED_BY(mu_)`` on a field, ``// REQUIRES(mu_)`` on a helper
that is only called with the lock held — the ``*_locked`` convention
from raft.h made machine-checkable). This analyzer parses those
annotations out of ``native/src/*.h``/``*.cc`` and verifies, at
function granularity, that every use of a guarded field happens in a
function that either

* acquires the named mutex (``std::lock_guard<std::mutex> g(mu_);`` /
  ``std::unique_lock<std::mutex> g(mu_);`` anywhere in its body — block
  scoping inside the function is trusted, this is a lightweight checker
  in the clang-tidy lineage, not a flow analysis), or
* carries a ``// REQUIRES(mu_)`` annotation on/above its signature.

Constructors, destructors, and the declaration line itself are exempt
(members are initialized before any thread can see the object).
TSAN (tests/test_tsan.py) catches what this misses at runtime; this
catches what TSAN needs a lucky interleaving to see, at compile time.

Rules
-----
``lock-guarded-field``
    A guarded field is touched by a function that neither locks its
    mutex nor is annotated REQUIRES.
``lock-unknown-mutex``
    A GUARDED_BY/REQUIRES names a mutex that is not declared in the
    same class — a stale annotation is worse than none.

Suppress a deliberate unlocked access (e.g. an atomic pre-check) with
``// lint: allow(lock-guarded-field)`` on the line.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .base import Finding, SourceFile, filter_allowed

GUARDED_RE = re.compile(r"//\s*GUARDED_BY\((\w+)\)")
REQUIRES_RE = re.compile(r"//\s*REQUIRES\((\w+)\)")
ACQUIRE_RE = re.compile(
    # template args optional: C++17 CTAD allows `std::scoped_lock g(mu_)`
    r"\b(?:std::)?(?:lock_guard|unique_lock|scoped_lock)\s*(?:<[^>]*>)?\s*"
    r"\w+\s*\(\s*(\w+)")
MUTEX_DECL_RE = re.compile(r"\bstd::(?:recursive_)?mutex\s+(\w+)\s*;")
FIELD_DECL_RE = re.compile(
    # `type name;` / `type name = x;` / `type name{..};`, or a bare
    # `name;` continuation line of a wrapped declaration
    r"^\s*(?:[\w:<>,\s&*\[\]]+?[\s&*>])?(\w+)\s*(?:=[^;{]*|\{[^;]*\})?;")
CLASS_RE = re.compile(r"^\s*(?:class|struct)\s+(\w+)")
FUNC_RE = re.compile(
    r"^\s*(?:template\s*<[^>]*>\s*)?"
    r"(?:(?:static|virtual|inline|constexpr|explicit|friend|\[\[\w+\]\])\s+)*"
    r"(?:[\w:<>,\s&*~\[\]]+?[\s&*>])?"
    r"(~?\w+|operator\S+)\s*\(")


def _strip_code(line: str) -> Tuple[str, str]:
    """(code, comment) with string literals blanked out of code."""
    code = line
    # blank string/char literals (keeps length, avoids fake matches)
    code = re.sub(r'"(?:[^"\\]|\\.)*"', '""', code)
    code = re.sub(r"'(?:[^'\\]|\\.)*'", "''", code)
    idx = code.find("//")
    if idx >= 0:
        return code[:idx], code[idx:]
    return code, ""


@dataclass
class _Func:
    name: str
    cls: str
    start: int
    requires: Set[str] = field(default_factory=set)
    acquires: Set[str] = field(default_factory=set)
    #: (line, field, mutex) accesses recorded while inside the body
    accesses: List[Tuple[int, str, str]] = field(default_factory=list)


def analyze_source(src: SourceFile) -> List[Finding]:
    lines = src.text.splitlines()

    # Pass 1: class → {field: (mutex, decl line)} and declared mutexes.
    guarded: Dict[str, Dict[str, Tuple[str, int]]] = {}
    mutexes: Dict[str, Set[str]] = {}
    decl_lines: Set[int] = set()
    class_stack: List[Tuple[str, int]] = []  # (name, brace depth at entry)
    depth = 0
    pending_class: Optional[str] = None
    for i, raw in enumerate(lines, start=1):
        code, comment = _strip_code(raw)
        m = CLASS_RE.match(code)
        if m and ";" not in code.split("{")[0]:
            pending_class = m.group(1)
        cur = class_stack[-1][0] if class_stack else ""
        gm = GUARDED_RE.search(comment)
        if gm and cur:
            fm = FIELD_DECL_RE.match(code)
            if fm:
                guarded.setdefault(cur, {})[fm.group(1)] = (gm.group(1), i)
                decl_lines.add(i)
        mm = MUTEX_DECL_RE.search(code)
        if mm and cur:
            mutexes.setdefault(cur, set()).add(mm.group(1))
        for ch in code:
            if ch == "{":
                depth += 1
                if pending_class:
                    class_stack.append((pending_class, depth))
                    pending_class = None
            elif ch == "}":
                if class_stack and class_stack[-1][1] == depth:
                    class_stack.pop()
                depth -= 1

    findings: List[Finding] = []
    for cls, fields in guarded.items():
        declared = mutexes.get(cls, set())
        for fname, (mu, decl_line) in fields.items():
            if mu not in declared:
                findings.append(Finding(
                    src.path, decl_line, "lock-unknown-mutex",
                    f"{cls}.{fname} is GUARDED_BY({mu}) but {cls} "
                    f"declares no mutex `{mu}`"))
    if not guarded:
        return filter_allowed(src, findings)

    # Pass 2: walk function bodies, record acquisitions + field uses.
    # A REQUIRES annotation binds to a signature when it sits on the
    # signature line or on the line directly above it.
    def _requires_near(sig_line: int) -> Set[str]:
        out: Set[str] = set()
        for ln in (sig_line - 1, sig_line):
            if 1 <= ln <= len(lines):
                out |= set(REQUIRES_RE.findall(lines[ln - 1]))
        return out

    funcs: List[_Func] = []
    func_stack: List[_Func] = []
    class_stack = []
    depth = 0
    pending_class = None
    pending_func: Optional[_Func] = None
    for i, raw in enumerate(lines, start=1):
        code, comment = _strip_code(raw)
        m = CLASS_RE.match(code)
        if m and ";" not in code.split("{")[0]:
            pending_class = m.group(1)
        cur_cls = class_stack[-1][0] if class_stack else ""

        if pending_func is None and cur_cls and not func_stack:
            fm = FUNC_RE.match(code)
            if fm and "=" not in code.split("(")[0] and \
                    not code.strip().startswith(("return", "if", "for",
                                                 "while", "switch", "case",
                                                 "else", "do", "new",
                                                 "delete", "throw")):
                pending_func = _Func(name=fm.group(1), cls=cur_cls, start=i,
                                     requires=_requires_near(i))

        active = func_stack[-1] if func_stack else None
        if active is not None:
            am = ACQUIRE_RE.search(code)
            if am:
                active.acquires.add(am.group(1))
            fields = guarded.get(active.cls, {})
            if fields and i not in decl_lines:
                for fname, (mu, _) in fields.items():
                    if re.search(rf"\b{re.escape(fname)}\b", code):
                        active.accesses.append((i, fname, mu))

        for ch in code:
            if ch == "{":
                depth += 1
                if pending_class:
                    class_stack.append((pending_class, depth))
                    pending_class = None
                elif pending_func is not None:
                    pending_func.depth = depth  # type: ignore[attr-defined]
                    func_stack.append(pending_func)
                    funcs.append(pending_func)
                    pending_func = None
            elif ch == "}":
                if func_stack and \
                        getattr(func_stack[-1], "depth", -1) == depth:
                    func_stack.pop()
                if class_stack and class_stack[-1][1] == depth:
                    class_stack.pop()
                depth -= 1
        if pending_func is not None and ";" in code:
            pending_func = None  # declaration only, no body

    for fn in funcs:
        if fn.name == fn.cls or fn.name == f"~{fn.cls}":
            continue  # ctor/dtor: no concurrent access yet/anymore
        for line, fname, mu in fn.accesses:
            if mu in fn.acquires or mu in fn.requires:
                continue
            findings.append(Finding(
                src.path, line, "lock-guarded-field",
                f"`{fname}` is GUARDED_BY({mu}) but "
                f"`{fn.cls}::{fn.name}` neither locks {mu} nor is "
                f"annotated // REQUIRES({mu})"))
    return filter_allowed(src, findings)


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))


def applies_to(relpath: str) -> bool:
    rp = relpath.replace("\\", "/")
    return "native/src/" in rp and rp.endswith((".h", ".cc"))
