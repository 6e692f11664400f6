"""Crash-consistency protocol analyzer for the service tier.

checker-design.md §11/§13 promise three durability shapes, and graftd's
crash-recovery tests only exercise the crashes someone thought of. This
analyzer enforces the shapes statically, on the CFG, so a refactor that
quietly drops an fsync or converts an atomic publish into an in-place
write fails lint before it fails a power-cut:

* ``flow-fsync-before-ack`` — in any ``service/`` function, every
  non-exception path from a file-handle ``.write(...)`` to the
  function's return must pass ``os.fsync`` (§11: the WAL record is on
  disk before the caller can ack a 2xx). Handles are recognized
  structurally: locals born from builtin ``open(...)`` (including
  ``with open(...) as fh``), locals returned by a ``*handle*()``
  helper, and ``self._fh``-style attributes. A branch on a parameter
  whose name contains ``fsync`` is the caller explicitly opting out of
  durability for this record — its False arm is not a violation (the
  group-commit leader/member split in journal.py keeps the covering
  fsync on the leader's write path, which is the path with the write).
* ``flow-inplace-publish`` — any write-mode ``open()`` in ``service/``
  must be either append-mode (the WAL family: torn tails are handled
  by replay, §11) or a temp file whose name is later passed to
  ``os.replace``/``os.rename`` in the same function (§13: cross-process
  publishes are atomic; ownership claims are ``os.rename``). An
  in-place ``open(final_path, "w")`` is a torn-read window for every
  other process.
* ``flow-nonatomic-publish`` — ``shutil.move/copy*`` in ``service/``:
  neither atomic nor fsynced; publishes and claims must use the
  replace/rename idioms instead.

Deliberate exceptions (best-effort trace files, startup-time
migrations) carry ``# lint: allow(inplace-publish)`` /
``# lint: allow(nonatomic-publish)`` with a reason. Pragma alias
``fsync`` covers the first rule.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..base import Finding, SourceFile, pkg_rel
from .cfg import EXC, FALSE, NORMAL, TRUE, build_cfg, functions_of, own_exprs, reach
from .locks import walk_expr

RULE_FSYNC = "flow-fsync-before-ack"
RULE_INPLACE = "flow-inplace-publish"
RULE_SHUTIL = "flow-nonatomic-publish"

SCAN_PREFIXES = ("service/",)

_SHUTIL_CALLS = {"move", "copy", "copy2", "copyfile", "copytree"}


def applies_to(relpath: str) -> bool:
    rp = pkg_rel(relpath)
    return rp.startswith(SCAN_PREFIXES)


# ------------------------------------------------------------ predicates


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _dotted(expr: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _is_file_born(value: ast.AST) -> bool:
    """Does this expression yield a real file handle? builtin open()
    or a *handle* helper (journal's `fh = self._handle()`)."""
    if not isinstance(value, ast.Call):
        return False
    name = _call_name(value)
    return name == "open" or "handle" in name.lower()


def _file_handles(fn: ast.FunctionDef) -> Set[str]:
    """Dotted names of file handles live in this function."""
    out: Set[str] = set()
    for node in walk_expr(fn):
        if isinstance(node, ast.Assign) and _is_file_born(node.value):
            for tgt in node.targets:
                d = _dotted(tgt)
                if d:
                    out.add(d)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if item.optional_vars is not None and \
                        _is_file_born(item.context_expr):
                    d = _dotted(item.optional_vars)
                    if d:
                        out.add(d)
    return out


def _writes_at(node, handles: Set[str]) -> List[int]:
    """Lines of handle.write(...) calls evaluated at this node."""
    out = []
    for expr in own_exprs(node):
        for sub in walk_expr(expr):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr == "write":
                recv = _dotted(sub.func.value)
                if recv is not None and (
                        recv in handles or recv.endswith("_fh")):
                    out.append(sub.lineno)
    return out


def _calls_fsync(node) -> bool:
    for expr in own_exprs(node):
        for sub in walk_expr(expr):
            if isinstance(sub, ast.Call) and _call_name(sub) == "fsync":
                return True
    return False


def _fsync_optout_guard(node) -> Optional[set]:
    """An `if <param-containing-fsync>:` branch: the False arm means
    the caller did not request durability for this record — only the
    True arm owes an fsync."""
    if node.label != "if":
        return None
    test = node.stmt.test
    names = {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
    if any("fsync" in n.lower() for n in names):
        return {TRUE}
    return None


# -------------------------------------------------- fsync-before-return


def _check_fsync(src: SourceFile, fn: ast.FunctionDef) -> List[Finding]:
    handles = _file_handles(fn)
    cfg = build_cfg(fn)
    findings: List[Finding] = []
    for node in cfg.nodes:
        for line in _writes_at(node, handles):
            if src.allowed(line, RULE_FSYNC) or src.allowed(line, "fsync"):
                continue

            def stop(n, kind_in):
                if _calls_fsync(n):
                    return "kill"
                if n is cfg.exit:
                    return "report"
                if n is cfg.raise_exit:
                    # exception escape = no ack to protect
                    return "kill"
                guard = _fsync_optout_guard(n)
                if guard is not None:
                    return guard
                # durability must hold on the SUCCESS path; exception
                # edges lead to error returns, which ack nothing
                return {NORMAL, TRUE, FALSE}

            starts = [s for s, k in node.succs if k != EXC]
            if reach(cfg, starts, stop):
                findings.append(Finding(
                    src.path, line, RULE_FSYNC,
                    "file write can reach the function's return without "
                    "an os.fsync on the same path — §11 requires the "
                    "record durable before the caller can ack; fsync "
                    "before returning (or route through the group-commit "
                    "path, whose leader fsyncs the batch)"))
    return findings


# ------------------------------------------------------ publish protocol


def _open_mode(call: ast.Call) -> str:
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return "r"


def _replaced_names(fn: ast.FunctionDef) -> Set[str]:
    """Dotted names passed as the SOURCE of os.replace/os.rename in
    this function — i.e. temp files that get atomically published."""
    out: Set[str] = set()
    for node in walk_expr(fn):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("replace", "rename") and node.args:
            base = _dotted(node.func.value)
            if base == "os":
                d = _dotted(node.args[0])
                if d:
                    out.add(d)
    return out


def _check_publish(src: SourceFile, fn: ast.FunctionDef) -> List[Finding]:
    findings: List[Finding] = []
    replaced = _replaced_names(fn)
    for node in walk_expr(fn):
        if isinstance(node, ast.Call) and _call_name(node) == "open" and \
                isinstance(node.func, ast.Name) and node.args:
            mode = _open_mode(node)
            writing = any(c in mode for c in "wx+")
            appending = "a" in mode and not writing
            if not writing or appending:
                continue  # reads and WAL-style appends are fine
            line = node.lineno
            if src.allowed(line, RULE_INPLACE) or \
                    src.allowed(line, "inplace-publish"):
                continue
            target = _dotted(node.args[0])
            if target is not None and target in replaced:
                continue  # temp-write + atomic replace/rename
            findings.append(Finding(
                src.path, line, RULE_INPLACE,
                f"write-mode open({mode!r}) is not a temp-write published "
                "via os.replace/os.rename in this function — §13 requires "
                "cross-process publishes to be atomic (write `<final>.tmp`,"
                " fsync, then os.replace) so readers never see a torn "
                "file; truly-local best-effort files need "
                "`# lint: allow(inplace-publish)` + a reason"))
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SHUTIL_CALLS and \
                _dotted(node.func.value) == "shutil":
            line = node.lineno
            if src.allowed(line, RULE_SHUTIL) or \
                    src.allowed(line, "nonatomic-publish"):
                continue
            findings.append(Finding(
                src.path, line, RULE_SHUTIL,
                f"shutil.{node.func.attr} is neither atomic nor fsynced — "
                "publishes must be temp-write + os.replace, ownership "
                "claims os.rename (§13); startup-time migrations that "
                "predate concurrency need "
                "`# lint: allow(nonatomic-publish)` + a reason"))
    return findings


# --------------------------------------------------------------- driver


def analyze_source(src: SourceFile) -> List[Finding]:
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    findings: List[Finding] = []
    for _cls, fn in functions_of(tree):
        findings.extend(_check_fsync(src, fn))
        findings.extend(_check_publish(src, fn))
    return findings


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
