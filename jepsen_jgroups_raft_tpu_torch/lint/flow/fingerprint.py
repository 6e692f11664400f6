"""Fingerprint-completeness analyzer (graftgate rule (a)).

The result cache, the shared store and the WAL all key verdicts on
``service/request.py:fingerprint_encodings``. A verdict is only safely
cacheable if it is a deterministic function of the hashed bytes — so
every :class:`EncodedHistory` field a verdict-deciding path reads must
be covered by the hash **at the rung that reads it**. The JAX package
once shipped the counterexample this rule exists for: the weak-rung
relaxation read ``proc`` while the fingerprint did not hash it, so two
histories with identical event rows but different per-process orders
shared one cache entry.

Cross-file, in three parses:

1. ``history/packing.py`` — the EncodedHistory field inventory
   (dataclass fields + properties). A field whose declaration line
   carries ``# lint: allow(fp-irrelevant)`` is exempt everywhere: the
   written record that it is derivable from hashed bytes (op_index /
   n_ops / n_events are recomputable from the events rows) and so
   cannot split a fingerprint.
2. ``service/request.py`` — per-field hash coverage inside
   ``fingerprint_encodings``: ``always`` when the field feeds the hash
   unconditionally, ``weak`` when only under a weak-rung guard (the
   ``weak = consistency != "linearizable"`` / ``if weak:`` idiom),
   absent otherwise.
3. the verdict surface (checker/linearizable, consistency, cycle,
   certify_batch, service/scheduler) — every attribute read of an
   inventory field:

   * coverage ``always`` → fine at any rung;
   * coverage ``weak``   → the read must be weak-context: intra-
     procedurally dominated by a weak-rung guard, or inside a function
     the :func:`taint.weak_functions` fixpoint proves is only ever
     called at weak rungs → else ``flow-fp-rung-mismatch``;
   * no coverage and not exempt → ``flow-fp-unhashed``.

Receivers are not typed: any attribute spelled like an inventory field
counts as a read. That is deliberately conservative where it matters —
always-hashed fields never fire, so lookalike attributes on other
types (``plan.n_slots``) cost nothing — and the unhashed/weak fields
(``proc``) have no lookalikes on the verdict surface. Pragma aliases:
``fp-irrelevant`` covers both rules at a read site too.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from ..base import Finding, SourceFile, pkg_rel
from .cfg import build_cfg, functions_of, walk_own
from . import taint

RULE_UNHASHED = "flow-fp-unhashed"
RULE_RUNG = "flow-fp-rung-mismatch"
PRAGMA = "fp-irrelevant"

#: anchor file: the CLI walk triggers the whole-surface analysis once.
ANCHOR = "service/request.py"
PACKING = "history/packing.py"
HASH_FN = "fingerprint_encodings"
DATACLASS = "EncodedHistory"

#: the verdict-deciding surface.
SCAN = (
    "checker/linearizable.py",
    "checker/consistency.py",
    "checker/cycle.py",
    "checker/certify_batch.py",
    "service/scheduler.py",
)


def applies_to(relpath: str) -> bool:
    return pkg_rel(relpath) == ANCHOR


# ------------------------------------------------------ field inventory


def field_inventory(packing: SourceFile
                    ) -> Tuple[Set[str], Set[str], Optional[int]]:
    """(fields, exempt, class_line) from the EncodedHistory dataclass:
    annotated fields plus @property names; `exempt` holds the names
    whose declaration line carries the fp-irrelevant pragma."""
    tree = ast.parse(packing.text)
    fields: Set[str] = set()
    exempt: Set[str] = set()
    cls_line: Optional[int] = None
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and
                node.name == DATACLASS):
            continue
        cls_line = node.lineno
        for stmt in node.body:
            name = line = None
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                name, line = stmt.target.id, stmt.lineno
            elif isinstance(stmt, ast.FunctionDef) and any(
                    isinstance(d, ast.Name) and d.id == "property"
                    for d in stmt.decorator_list):
                name, line = stmt.name, stmt.lineno
            if name is None:
                continue
            fields.add(name)
            if packing.allowed(line, PRAGMA) or \
                    packing.allowed(line, RULE_UNHASHED):
                exempt.add(name)
    return fields, exempt, cls_line


# -------------------------------------------------------- hash coverage


def hash_coverage(request: SourceFile,
                  fields: Set[str]) -> Optional[Dict[str, str]]:
    """field -> "always" | "weak" from the fingerprint function; None
    when the function is missing (anchor drift must be loud)."""
    tree = ast.parse(request.text)
    fn = next((f for _c, f in functions_of(tree) if f.name == HASH_FN),
              None)
    if fn is None:
        return None
    wnames = taint.weak_assign_names(fn)
    cfg = build_cfg(fn)
    coverage: Dict[str, str] = {}
    for node in walk_own(fn):
        if not (isinstance(node, ast.Attribute) and
                isinstance(node.ctx, ast.Load) and
                node.attr in fields):
            continue
        weak_only = taint.dominated(cfg, node, wnames, taint.weak_edges)
        cov = "weak" if weak_only else "always"
        if coverage.get(node.attr) != "always":
            coverage[node.attr] = cov
    return coverage


# --------------------------------------------------------- read harvest


def _field_reads(fn: ast.AST, fields: Set[str]
                 ) -> List[ast.Attribute]:
    return [node for node in walk_own(fn)
            if isinstance(node, ast.Attribute) and
            isinstance(node.ctx, ast.Load) and node.attr in fields]


def analyze_sources(sources: Dict[str, SourceFile]) -> List[Finding]:
    """Whole-surface pass over {relpath: SourceFile}; must contain
    PACKING and ANCHOR, plus whichever SCAN modules are present."""
    packing = sources.get(PACKING)
    request = sources.get(ANCHOR)
    if packing is None or request is None:
        return []
    try:
        fields, exempt, cls_line = field_inventory(packing)
        if cls_line is None:
            return [Finding(packing.path, 1, RULE_UNHASHED,
                            f"{DATACLASS} dataclass not found in "
                            f"{PACKING} — the fingerprint-completeness "
                            "anchor moved; update lint/flow/"
                            "fingerprint.py")]
        coverage = hash_coverage(request, fields)
        if coverage is None:
            return [Finding(request.path, 1, RULE_UNHASHED,
                            f"{HASH_FN}() not found in {ANCHOR} — the "
                            "fingerprint-completeness anchor moved; "
                            "update lint/flow/fingerprint.py")]
    except SyntaxError as e:
        return [Finding(packing.path, e.lineno or 1, "parse-error",
                        str(e))]

    # per-module function tables for the interprocedural weak fixpoint
    functions: List[Tuple[str, ast.AST, object]] = []
    mods: List[Tuple[SourceFile, ast.AST]] = []
    for rel in SCAN:
        src = sources.get(rel)
        if src is None:
            continue
        try:
            tree = ast.parse(src.text)
        except SyntaxError as e:
            return [Finding(src.path, e.lineno or 1, "parse-error",
                            str(e))]
        mods.append((src, tree))
        for _cls, fn in functions_of(tree):
            functions.append((fn.name, fn, build_cfg(fn)))
    weak_fns = taint.weak_functions(functions)
    cfgs = {id(fn): cfg for _n, fn, cfg in functions}

    findings: List[Finding] = []
    for src, tree in mods:
        for _cls, fn in functions_of(tree):
            wnames = taint.weak_assign_names(fn)
            cfg = cfgs[id(fn)]
            for read in _field_reads(fn, fields):
                field, line = read.attr, read.lineno
                cov = coverage.get(field)
                if cov == "always" or field in exempt:
                    continue
                if src.allowed(line, PRAGMA) or \
                        src.allowed(line, RULE_UNHASHED) or \
                        src.allowed(line, RULE_RUNG):
                    continue
                if cov is None:
                    findings.append(Finding(
                        src.path, line, RULE_UNHASHED,
                        f"verdict path reads EncodedHistory.{field}, "
                        f"which {HASH_FN} never hashes — two "
                        "submissions differing only in this field "
                        "would share a cache entry (the proc "
                        "bug class); hash it, or mark the field "
                        "declaration `# lint: allow(fp-irrelevant)` "
                        "with why it is derivable from hashed bytes"))
                    continue
                if fn.name in weak_fns or \
                        taint.dominated(cfg, read, wnames,
                                        taint.weak_edges):
                    continue
                findings.append(Finding(
                    src.path, line, RULE_RUNG,
                    f"EncodedHistory.{field} is hashed only at weak "
                    "rungs but this read is not proven weak-context "
                    "(no dominating weak-rung guard, and "
                    f"{fn.name}() has a non-weak call site) — a "
                    "linearizable-rung verdict would depend on "
                    "unhashed bytes; guard the read or extend the "
                    "hash to all rungs"))
    return findings


def _load_surface(anchor: Path) -> Dict[str, SourceFile]:
    pkg = anchor.resolve().parents[1]   # .../jepsen_jgroups_raft_tpu_torch
    out: Dict[str, SourceFile] = {}
    for rel in (PACKING, ANCHOR) + SCAN:
        f = pkg / rel
        if f.exists():
            out[rel] = SourceFile.load(f)
    return out


def analyze_file(path) -> List[Finding]:
    return analyze_sources(_load_surface(Path(path)))
