"""Tier-stamp totality analyzer (graftgate rule (d)).

The attribution contract: every terminal verdict records which
tier of the escalation ladder decided it (``decided-tier``), so the
fleet's tier counters, the bench's decided-tiers summary and the
incident playbook in doc/running.md stay trustworthy as new tiers
land. The invariant is *totality* — a construction site someone adds
next year must not silently ship unstamped rows.

Every dict literal carrying a ``"valid?"`` key on the verdict surface
(checker ladder, host ladder, fast lanes, stream mid-run/finish,
distributed demux) must satisfy one of:

* the literal itself carries a ``"decided-tier"`` key;
* the literal carries an ``"error"`` key — an undecided/error record:
  no tier decided anything, and stamping one would lie to the
  counters;
* the literal carries a ``"results"`` key — an aggregate envelope
  whose per-row results are stamped individually;
* the literal is bound to a local name and EVERY CFG path from the
  construction to the function's normal exit passes a
  ``name["decided-tier"] = ...`` / ``name.setdefault("decided-tier",
  ...)`` stamp (the post-assignment idiom; paths that end in a raise
  never return the dict and are exempt);
* a reasoned ``# lint: allow(no-tier)`` pragma.

Otherwise: ``flow-tier-unstamped``. The rule found a real one on the
shipped tree — the distributed demux stub (`_remote_result`) returned
wire-exact verdicts with no tier attribution, undercounting remote
rows in every fleet tier summary.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional

from ..base import Finding, SourceFile, pkg_rel
from .cfg import build_cfg, functions_of, reach, walk_own
from . import taint

RULE = "flow-tier-unstamped"
PRAGMA = "no-tier"

VERDICT_KEY = "valid?"
TIER_KEY = "decided-tier"
#: keys whose presence in the same literal discharges the obligation.
EXEMPT_KEYS = ("error", "results")

#: anchor file: the CLI walk triggers the whole-surface analysis once.
ANCHOR = "checker/linearizable.py"

SCAN = (
    "checker/linearizable.py",
    "service/scheduler.py",
    "service/stream.py",
    "parallel/distributed.py",
)


def applies_to(relpath: str) -> bool:
    return pkg_rel(relpath) == ANCHOR


def _keys(d: ast.Dict) -> List[str]:
    return [k.value for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


def _bound_name(fn: ast.AST, lit: ast.Dict) -> Optional[str]:
    """The local name the literal is directly assigned to, if any."""
    for stmt in walk_own(fn):
        if isinstance(stmt, ast.Assign) and stmt.value is lit:
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Name):
                    return tgt.id
    return None


def _is_stamp(stmt: ast.AST, name: str) -> bool:
    """``name["decided-tier"] = ...`` or ``name.setdefault(
    "decided-tier", ...)``."""
    if isinstance(stmt, ast.Assign):
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == name and \
                    isinstance(tgt.slice, ast.Constant) and \
                    tgt.slice.value == TIER_KEY:
                return True
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        call = stmt.value
        if taint.call_name(call) == "setdefault" and \
                isinstance(call.func, ast.Attribute) and \
                isinstance(call.func.value, ast.Name) and \
                call.func.value.id == name and call.args and \
                isinstance(call.args[0], ast.Constant) and \
                call.args[0].value == TIER_KEY:
            return True
    return False


def _stamped_on_all_paths(cfg, fn: ast.AST, lit: ast.Dict) -> bool:
    name = _bound_name(fn, lit)
    if name is None:
        return False
    starts = taint.nodes_containing(cfg, lit)
    if not starts:
        return False
    stamps = {n.idx for n in cfg.nodes
              if n.stmt is not None and _is_stamp(n.stmt, name)}

    def stop(node, _kind):
        if node.idx in stamps:
            return "kill"
        if node is cfg.exit:
            return "report"  # normal return with the stamp pending
        return None

    return not reach(cfg, starts, stop)


def analyze_sources(sources: Dict[str, SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for rel in SCAN:
        src = sources.get(rel)
        if src is None:
            continue
        try:
            tree = ast.parse(src.text)
        except SyntaxError as e:
            findings.append(Finding(src.path, e.lineno or 1,
                                    "parse-error", str(e)))
            continue
        for _cls, fn in functions_of(tree):
            cfg = None
            for node in walk_own(fn):
                if not isinstance(node, ast.Dict):
                    continue
                keys = _keys(node)
                if VERDICT_KEY not in keys:
                    continue
                if TIER_KEY in keys or any(k in keys
                                           for k in EXEMPT_KEYS):
                    continue
                line = node.lineno
                if src.allowed(line, RULE) or src.allowed(line, PRAGMA):
                    continue
                if cfg is None:
                    cfg = build_cfg(fn)
                if _stamped_on_all_paths(cfg, fn, node):
                    continue
                findings.append(Finding(
                    src.path, line, RULE,
                    "terminal result constructed without a "
                    "`decided-tier` stamp on some path to return — "
                    "tier attribution must stay total (fleet "
                    "counters and the decided-tiers summary undercount "
                    "otherwise); stamp the literal, stamp the bound "
                    "name on every path, keep an `error` key on "
                    "undecided records, or justify with "
                    "`# lint: allow(no-tier)`"))
    return findings


def _load_surface(anchor: Path) -> Dict[str, SourceFile]:
    pkg = anchor.resolve().parents[1]
    return {rel: SourceFile.load(pkg / rel)
            for rel in SCAN if (pkg / rel).exists()}


def analyze_file(path) -> List[Finding]:
    return analyze_sources(_load_surface(Path(path)))
