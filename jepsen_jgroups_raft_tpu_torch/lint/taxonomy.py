"""Taxonomy-soundness analyzer.

Enforces the load-bearing invariant of client/errors.py: a ``fail``
outcome asserts the op **certainly did not execute** — the checker drops
it. An exception path that records ``fail`` without routing through
``classify_error`` (or while catching an indefinite type on a
non-idempotent op) can therefore hide a write that later takes effect:
the checker would pass an unlinearizable history, i.e. become unsound.
The reverse mistake (recording ``info`` too often) only slows the search
(reference doc/intro.md:35-41), so ``info`` paths are never flagged.

Rules
-----
``taxonomy-bare-except-fail``
    An ``except Exception``/``except BaseException``/bare ``except``
    handler records a FAIL outcome without calling ``classify_error`` /
    ``with_errors``. A broad catch sees indefinite errors too.
``taxonomy-indefinite-fail``
    A handler catching a known-indefinite type (``ClientTimeout``,
    ``SocketBroken``, ``TimeoutError``, ``socket.timeout``,
    ``ConnectionResetError``) records FAIL with no visible idempotence
    guard (no name containing ``idempotent`` in the handler).
``taxonomy-silent-swallow``
    A broad handler whose body neither re-raises, classifies, logs, nor
    records any outcome — an invisible drop. In the client tier a
    swallowed indefinite error usually surfaces later as a mystery
    timeout; narrow the catch to the concrete types the ``try`` body can
    raise, or log it.

Scan set (when run via the CLI): ``client/``, ``workload/``,
``core/runner.py``, ``native/client.py``, ``deploy/``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .base import Finding, SourceFile, filter_allowed, pkg_rel

#: Exception names treated as "catches everything".
BROAD = {"Exception", "BaseException"}

#: Exception names whose meaning is "the op may have executed" — the
#: taxonomy's own types plus every stdlib parent classify_error maps to
#: an indefinite kind (OSError/ConnectionError: `socket`; the timeout
#: family: `timeout`). Catching any of these and recording FAIL is the
#: indefinite-as-definite unsoundness, regardless of spelling.
INDEFINITE = {"ClientTimeout", "SocketBroken", "TimeoutError",
              "ConnectionResetError", "BrokenPipeError", "OSError",
              "ConnectionError", "timeout"}  # timeout = socket.timeout

#: Calls that prove the handler routes through the taxonomy.
CLASSIFIERS = {"classify_error", "with_errors"}

#: Logging attribute names that make a swallow visible.
LOG_METHODS = {"debug", "info", "warning", "error", "exception", "critical",
               "log"}

#: The port's own helpers that log what they are handed (a call to one
#: makes a handler visible, as a logging call does): the distributed
#: tier's `_degrade` logs a warning and records the degrade note
#: (parallel/distributed.py).
LOG_HELPERS = {"_degrade"}

#: Default CLI scan set, relative to the package root. The service
#: tier (graftd) and both stdlib HTTP servers are covered: a
#: long-lived daemon is where a silently-swallowed broad except turns
#: into an unexplained wedge instead of a crashed run. The distributed
#: tier rides along: its degrade paths (malformed cluster
#: env, failed init, unsupported collectives) are broad-except-shaped
#: by design and must stay VISIBLE — a silent swallow there is exactly
#: the silent-CPU pattern at cluster scale.
#: The scenario tier widens the net: generator/ rides along
#: (the set/queue workloads put stateful op generation there — a
#: swallowed error in a generator silently starves a phase), and the
#: scenario checkers (derived analyses + the consistency rung family)
#: are scanned like the service tier — a broad except around a verdict
#: path is exactly where an indefinite error could turn into a wrong
#: "valid".
#: search/ is scanned like the service tier: a swallowed
#: error in evaluation or archive would silently count a candidate as
#: boring (fitness 0) or drop a violation — recall numbers that lie.
SCAN_PREFIXES = ("client/", "workload/", "deploy/", "service/",
                 "generator/", "search/")
SCAN_FILES = ("core/runner.py", "native/client.py", "core/serve.py",
              "parallel/distributed.py", "parallel/launch.py",
              "checker/set_queue.py", "checker/consistency.py",
              "checker/counterexample.py")


def applies_to(relpath: str) -> bool:
    rp = pkg_rel(relpath)
    return rp.startswith(SCAN_PREFIXES) or rp in SCAN_FILES


def _names_of(type_expr: Optional[ast.expr]) -> List[str]:
    """Exception names in an except clause (handles tuples, dotted)."""
    if type_expr is None:
        return [""]  # bare except
    items = (type_expr.elts if isinstance(type_expr, ast.Tuple)
             else [type_expr])
    out = []
    for it in items:
        if isinstance(it, ast.Name):
            out.append(it.id)
        elif isinstance(it, ast.Attribute):
            out.append(it.attr)
    return out


def _is_fail_const(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and node.value == "fail":
        return True
    if isinstance(node, ast.Name) and node.id == "FAIL":
        return True
    if isinstance(node, ast.Attribute) and node.attr == "FAIL":
        return True
    return False


def _records_fail(handler: ast.ExceptHandler) -> Optional[int]:
    """Line of the first FAIL-outcome record in the handler body, if any."""
    for node in ast.walk(handler):
        # op.replace(type=FAIL) / Op(..., type="fail")
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "type" and _is_fail_const(kw.value):
                    return node.lineno
        # comp.type = FAIL / "fail"
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Attribute) and tgt.attr == "type"
                        and _is_fail_const(node.value)):
                    return node.lineno
    return None


def _calls_classifier(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            if name in CLASSIFIERS:
                return True
    return False


def _mentions_idempotent(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = node.id if isinstance(node, ast.Name) else node.attr
            if "idempotent" in name.lower():
                return True
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "idempotent" in node.value.lower():
            return True
    return False


def _is_visible(handler: ast.ExceptHandler) -> bool:
    """Does the handler do ANYTHING observable with the error?"""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in LOG_METHODS:
                return True
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            if name in CLASSIFIERS or name in LOG_HELPERS or \
                    name in ("print", "repr", "str"):
                return True
        # records any outcome at all (fail/info/ok)
        if isinstance(node, ast.keyword) and node.arg in ("type", "error"):
            return True
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        tgt.attr in ("type", "error"):
                    return True
    return False


def analyze_source(src: SourceFile) -> List[Finding]:
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        names = _names_of(node.type)
        broad = any(n in BROAD or n == "" for n in names)
        indefinite = [n for n in names if n in INDEFINITE]
        fail_line = _records_fail(node)
        if fail_line is not None and not _calls_classifier(node):
            if broad:
                findings.append(Finding(
                    src.path, fail_line, "taxonomy-bare-except-fail",
                    "broad except handler records a FAIL outcome without "
                    "classify_error — an indefinite error recorded as "
                    "definite makes the linearizability checker unsound "
                    "(client/errors.py)"))
            if indefinite and not _mentions_idempotent(node):
                findings.append(Finding(
                    src.path, fail_line, "taxonomy-indefinite-fail",
                    f"catching indefinite {'/'.join(indefinite)} but "
                    "recording FAIL with no idempotence guard — the op "
                    "may have executed; record INFO (or gate on the "
                    "workload's idempotent set)"))
        if broad and fail_line is None and not _is_visible(node):
            findings.append(Finding(
                src.path, node.lineno, "taxonomy-silent-swallow",
                f"broad `except {'/'.join(n or 'BaseException' for n in names)}`"
                " swallows the error invisibly — narrow it to the concrete "
                "types the try body raises, or log it"))
    return filter_allowed(src, findings)


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
