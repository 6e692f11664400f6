"""Cross-engine lock-step tripwire (graftgate).

``consistency.certify_encoded`` (the one-shot greedy/backtrack
certifier) and ``consistency.StreamingCertifier`` (its resumable twin)
duplicate the witness commit rules BY HAND — the one-shot stays a
hand-tuned closure loop because it is the measured hot path (see the
LOCK-STEP CONTRACT note on the class). Until now the only tripwire was
the differential test, which needs a history that happens to exercise
the drifted rule. This rule pins the duplicated structure statically:
edit one side's commit rules without the other and lint fails on every
run, witness or not.

Three pinned pairs, compared as normalized AST (``self._x`` reads
rewritten to bare ``x`` — the method side rebinds its attributes to
locals of exactly those names):

* **sweep** — the eager read-only commit test: every ``if`` test of
  the nested ``sweep`` closure vs ``StreamingCertifier._sweep``.
* **candidates** — the commit-option constants and value-guided
  ordering: every ``out.append(...)`` argument (the ``(-1, 0, 0, -1,
  None)`` direct-commit row and the ranked candidate row) plus the
  ``out.sort(key=...)`` ranking lambda, in order, of the nested
  ``candidates`` closure vs ``StreamingCertifier._candidates``.
* **scan** — the choice-point shape and helper wiring of the main
  loops (``certify_encoded`` body vs ``StreamingCertifier._scan``):
  every ``stack.append([...])`` snapshot row and every assignment
  whose value is a ``sweep(...)``/``candidates(...)`` call.

The guide-mask plumbing around those pins legitimately differs
(closure arrays vs instance state) and is deliberately NOT compared.
``flow-lockstep-anchor`` fires loudly if either side's function is
missing or a pair extracts nothing — a refactor that moves the code
must move this rule's anchors with it, not silently disable it.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from ..base import Finding, SourceFile, pkg_rel
from .cfg import functions_of, walk_own
from . import taint

RULE_DRIFT = "flow-lockstep-drift"
RULE_ANCHOR = "flow-lockstep-anchor"
PRAGMA = "lockstep"

ANCHOR = "checker/consistency.py"
ONESHOT = "certify_encoded"
TWIN = "StreamingCertifier"
#: a fixture that defines either twin (a file that only calls or names
#: them, as a driver script does, is not one)
_DEFINES_TWIN = re.compile(rf"^\s*(?:def {ONESHOT}|class {TWIN})\b", re.M)


def applies_to(relpath: str) -> bool:
    return pkg_rel(relpath) == ANCHOR


class _Normalize(ast.NodeTransformer):
    """``self._x`` / ``self.x`` -> ``x``: the streaming methods rebind
    their attributes to locals named exactly like the one-shot's."""

    def visit_Attribute(self, node: ast.Attribute):
        self.generic_visit(node)
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            return ast.copy_location(
                ast.Name(id=node.attr.lstrip("_"), ctx=node.ctx), node)
        return node


def _sig(node: ast.AST) -> str:
    return ast.dump(_Normalize().visit(ast.parse(
        ast.unparse(node), mode="eval").body))


def _if_tests(fn: ast.AST) -> List[Tuple[int, str, str]]:
    # walk_own yields stack order, not document order — sort by line so
    # both sides' elements pair up positionally.
    return sorted((n.lineno, "if-test", _sig(n.test))
                  for n in walk_own(fn) if isinstance(n, ast.If))


def _append_sort(fn: ast.AST) -> List[Tuple[int, str, str]]:
    out = []
    for n in walk_own(fn):
        if not isinstance(n, ast.Call):
            continue
        name = taint.call_name(n)
        if name == "append" and n.args:
            out.append((n.lineno, "append", _sig(n.args[0])))
        elif name == "sort" and n.keywords:
            for kw in n.keywords:
                if kw.arg == "key":
                    out.append((n.lineno, "sort-key", _sig(kw.value)))
    return sorted(out)


def _scan_shape(fn: ast.AST) -> List[Tuple[int, str, str]]:
    out = []
    for n in walk_own(fn):
        if isinstance(n, ast.Call) and taint.call_name(n) == "append" \
                and n.args and isinstance(n.args[0], ast.List):
            out.append((n.lineno, "snapshot", _sig(n.args[0])))
        elif isinstance(n, ast.Assign) and \
                isinstance(n.value, ast.Call):
            callee = taint.call_name(n.value).lstrip("_")
            if callee in ("sweep", "candidates"):
                out.append((n.lineno, f"{callee}-call", _sig(n.value)))
    return sorted(out)


#: (pair name, one-shot function, twin method, extractor)
PAIRS = (
    ("sweep", "sweep", "_sweep", _if_tests),
    ("candidates", "candidates", "_candidates", _append_sort),
    ("scan", ONESHOT, "_scan", _scan_shape),
)


def _functions(tree: ast.AST) -> Dict[Tuple[Optional[str], str], ast.AST]:
    return {(cls.name if cls is not None else None, fn.name): fn
            for cls, fn in functions_of(tree)}


def analyze_source(src: SourceFile) -> List[Finding]:
    # The CLI analyzes explicit single-file arguments with EVERY
    # requested analyzer; this rule is anchored to one file's twin
    # functions, so stay quiet on anything that is neither the anchor
    # nor a fixture mentioning the twins (missing-anchor loudness would
    # otherwise fire on every `lint somefile.py` invocation).
    if not (str(src.path).replace("\\", "/").endswith(ANCHOR)
            or _DEFINES_TWIN.search(src.text)):
        return []
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    fns = _functions(tree)
    findings: List[Finding] = []
    for pair, a_name, b_name, extract in PAIRS:
        a = fns.get((None, a_name))
        b = fns.get((TWIN, b_name))
        if a is None or b is None:
            missing = a_name if a is None else f"{TWIN}.{b_name}"
            findings.append(Finding(
                src.path, 1, RULE_ANCHOR,
                f"lock-step anchor {missing}() not found in {ANCHOR} — "
                "the duplicated-certifier contract moved; update "
                "lint/flow/lockstep.py's PAIRS with it"))
            continue
        sa, sb = extract(a), extract(b)
        if not sa or not sb:
            findings.append(Finding(
                src.path, min(a.lineno, b.lineno), RULE_ANCHOR,
                f"lock-step pair '{pair}' extracted no comparable "
                "structure — the commit-rule shape this rule pins "
                "changed; re-anchor lint/flow/lockstep.py"))
            continue
        if len(sa) != len(sb):
            line = sb[min(len(sa), len(sb)) - 1][0] if sb else b.lineno
            if not (src.allowed(line, RULE_DRIFT) or
                    src.allowed(line, PRAGMA)):
                findings.append(Finding(
                    src.path, line, RULE_DRIFT,
                    f"lock-step pair '{pair}': {a_name}() pins "
                    f"{len(sa)} commit-rule element(s) but "
                    f"{TWIN}.{b_name}() has {len(sb)} — the two "
                    "certifiers' commit rules are duplicated BY HAND "
                    "and must change together"))
            continue
        for (la, ka, da), (lb, kb, db) in zip(sa, sb):
            if ka == kb and da == db:
                continue
            if src.allowed(lb, RULE_DRIFT) or src.allowed(lb, PRAGMA):
                continue
            findings.append(Finding(
                src.path, lb, RULE_DRIFT,
                f"lock-step pair '{pair}': the {kb} here drifted from "
                f"{a_name}()'s {ka} at line {la} — the one-shot and "
                "streaming certifiers duplicate the witness commit rules "
                "BY HAND; mirror the edit in both (or re-anchor "
                "lint/flow/lockstep.py if the contract itself moved)"))
    return findings


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
