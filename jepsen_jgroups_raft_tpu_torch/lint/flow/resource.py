"""Resource-leak analyzer: acquire/release across exception paths.

The deploy and runner tiers hold real OS resources — client sockets
(NativeConn / Client.open), popen handles, log file handles, probe
sockets, tempdirs. A handle that leaks on an exception path is invisible
in a 10-op unit test and fatal in a 120-run hell campaign (fd
exhaustion mid-soak kills the harness, not the SUT — the verdict is
lost, not failed). This analyzer tracks each acquisition through the
function's CFG and reports any path — normal return, exception edge, or
a reassignment that drops the handle — on which the resource is neither
released nor transferred.

Model (deliberately coarse, biased against false positives):

* **acquire** — ``x = <acquire-call>()``: builtin ``open``, ``Popen``,
  ``NativeConn``, ``socket``/``create_connection``, tempfile makers,
  executors, and any callee with ``open`` as a snake-case segment
  (``proto.open``, ``_open_client``). ``with acquire() as x`` is
  release-by-construction and never tracked.
* **release** — ``x.close() / shutdown / terminate / kill / release /
  cleanup / stop``. An *attempted* release discharges even if it raises
  (the fd's fate is the callee's problem at that point).
* **transfer** — ownership leaves the function: ``return x`` (bare, or
  a tuple element), storing into an attribute/subscript, aliasing to
  another name, or adoption into a collection (``xs.append(x)``,
  ``d.setdefault(k, x)``…). Passing ``x`` as an argument to an ordinary
  call is **not** a transfer — ``Popen(stdout=log)`` does not own
  ``log``; that asymmetry is exactly what caught the start_node leak.
* **guards** — ``if x is None`` / ``is not None`` tests prune the branch
  on which the tracked value cannot be the live resource (the idiom the
  runner's close-in-finally uses).

Rule: ``flow-resource-leak`` (pragma alias ``resource-leak``). Scan set
(CLI): ``deploy/ssh.py``, ``deploy/local.py``, ``core/runner.py``,
``core/db.py``.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..base import Finding, SourceFile, pkg_rel
from .cfg import (EXC, FALSE, NORMAL, TRUE, build_cfg, functions_of,
                  own_exprs, reach)

RULE = "flow-resource-leak"

_ACQ_EXACT = {"open", "popen", "nativeconn", "socket", "create_connection",
              "mkdtemp", "mkstemp", "temporarydirectory",
              "namedtemporaryfile", "threadpoolexecutor", "sshclient",
              "connect"}

_RELEASE = {"close", "shutdown", "terminate", "kill", "release", "cleanup",
            "stop", "disconnect"}

#: collection-adoption callees: the receiver takes ownership.
_ADOPT = {"append", "add", "insert", "put", "register", "setdefault",
          "store"}

SCAN_FILES = ("deploy/ssh.py", "deploy/local.py", "core/runner.py",
              "core/db.py",
              # the distributed tier: the multi-process launcher
              # holds subprocess handles + the coordinator port socket
              # across exception paths (a leaked child is a whole
              # wedged interpreter, not just an fd), and distributed.py
              # owns the cluster runtime handles.
              "parallel/distributed.py", "parallel/launch.py")

#: The service tier is scanned wholesale: graftd holds queue
#: entries, per-call client sockets, trace file handles, and worker
#: threads across exception paths, and it is long-lived — a per-request
#: leak that a one-shot run never notices exhausts the daemon's fds.
#: workload/ rides along since the scenario tier: its
#: set/queue clients own real connections behind CAS retry loops — an
#: exception path that drops one mid-loop is the leak class this rule
#: exists for. search/ rides along: search/driver.py owns a whole
#: CheckingService (worker threads) plus corpus temp files — a search
#: that leaks its daemon on an exception path wedges the next run's
#: admission.
SCAN_PREFIXES = ("service/", "workload/", "search/")


def applies_to(relpath: str) -> bool:
    rp = pkg_rel(relpath)
    return rp in SCAN_FILES or rp.startswith(SCAN_PREFIXES)


# ------------------------------------------------------------- predicates


def _callee_name(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _is_acquire_call(value: ast.expr) -> bool:
    if not isinstance(value, ast.Call):
        return False
    low = _callee_name(value).lower()
    return low in _ACQ_EXACT or "open" in low.split("_")


def _acquisitions(fn_cfg):
    """(node, varname) per tracked acquisition statement."""
    out = []
    for node in fn_cfg.nodes:
        for expr in own_exprs(node):
            if isinstance(expr, ast.Assign) and len(expr.targets) == 1 \
                    and isinstance(expr.targets[0], ast.Name) \
                    and _is_acquire_call(expr.value):
                out.append((node, expr.targets[0].id))
    return out


def _releases(node, var: str) -> bool:
    for expr in own_exprs(node):
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _RELEASE and \
                    isinstance(sub.func.value, ast.Name) and \
                    sub.func.value.id == var:
                return True
    return False


def _bare(expr: ast.expr, var: str) -> bool:
    return isinstance(expr, ast.Name) and expr.id == var


def _transfers(node, var: str) -> bool:
    for expr in own_exprs(node):
        if isinstance(expr, ast.Return) and expr.value is not None:
            v = expr.value
            if _bare(v, var) or (isinstance(v, ast.Tuple) and
                                 any(_bare(e, var) for e in v.elts)):
                return True
        if isinstance(expr, ast.Assign):
            # alias to another name, or escape into an attr/subscript
            if _bare(expr.value, var):
                return True
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in _ADOPT:
                args = list(sub.args) + [k.value for k in sub.keywords]
                if any(_bare(a, var) for a in args):
                    return True
    return False


def _reassigns(node, var: str, site_stmt) -> bool:
    for expr in own_exprs(node):
        if expr is site_stmt:
            continue
        if isinstance(expr, (ast.Assign,)):
            for tgt in expr.targets:
                if _bare(tgt, var):
                    return True
        if isinstance(expr, ast.AugAssign) and _bare(expr.target, var):
            return True
    return False


def _none_guard(node, var: str) -> Optional[set]:
    """Edge kinds to follow through an `if` that tests the tracked var
    against None; None when the test says nothing about it."""
    if node.label != "if":
        return None
    tests = [node.stmt.test]
    if isinstance(node.stmt.test, ast.BoolOp) and \
            isinstance(node.stmt.test.op, ast.And):
        tests = list(node.stmt.test.values)
    for t in tests:
        if isinstance(t, ast.Compare) and _bare(t.left, var) and \
                len(t.ops) == 1 and \
                isinstance(t.comparators[0], ast.Constant) and \
                t.comparators[0].value is None:
            if isinstance(t.ops[0], ast.Is):
                # true arm ⇒ var is None ⇒ not the live resource
                return {FALSE, EXC}
            if isinstance(t.ops[0], ast.IsNot) and \
                    t is node.stmt.test:
                # (only sound for the whole test, not an And conjunct)
                return {TRUE, EXC}
    return None


# --------------------------------------------------------------- analysis


def _analyze_function(src: SourceFile, fn: ast.FunctionDef) -> List[Finding]:
    cfg = build_cfg(fn)
    findings: List[Finding] = []
    for site, var in _acquisitions(cfg):
        if src.allowed(site.line, RULE) or \
                src.allowed(site.line, "resource-leak"):
            continue
        site_stmt = site.stmt
        starts = [s for s, k in site.succs if k != EXC]

        def stop(n, kind_in, _var=var, _site=site, _stmt=site_stmt):
            if n is _site:
                return "kill"  # looped back: fresh acquisition re-tracks
            if _releases(n, _var) or _transfers(n, _var):
                return "kill"
            if _reassigns(n, _var, _stmt):
                return "report"
            if n is cfg.exit or n is cfg.raise_exit:
                return "report"
            guard = _none_guard(n, _var)
            if guard is not None:
                return guard | {NORMAL}
            return None

        escapes = reach(cfg, starts, stop)
        if escapes:
            end = escapes[0][-1]
            if end is cfg.raise_exit:
                how = "an exception path escapes the function"
            elif end is cfg.exit:
                how = "a return path completes"
            else:
                how = (f"line {end.line} reassigns `{var}` while it is "
                       "still open")
            findings.append(Finding(
                src.path, site.line, RULE,
                f"`{var}` acquired here is not released on every path: "
                f"{how} without close/transfer — release it in a "
                "finally, use `with`, or hand ownership off before the "
                "path splits"))
    return findings


def analyze_source(src: SourceFile) -> List[Finding]:
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    findings: List[Finding] = []
    for _cls, fn in functions_of(tree):
        findings.extend(_analyze_function(src, fn))
    return findings


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
