"""Routing/verdict separation analyzer (graftgate rule (c)).

The fast paths ship behind JGRAFT_* gates under one contract:
a knob may choose *which engine* computes a verdict, *where* it is
persisted, or *how the fleet is operated* — it may never change the
verdict value itself. This analyzer makes that contract machine-checked
in two halves:

* **classification** (``flow-knob-unclassified``) — every knob the
  envknobs harvest finds must have a row in :data:`KNOB_CLASS`:
  ``routing`` (engine/tier selection, batching and fastpath gates,
  chunk/unroll/fanout shapes), ``durability`` (what is persisted and
  where), ``ops`` (fleet operation: workers, watchdogs, bench drivers,
  time budgets), or ``semantic`` (declared verdict-affecting — the
  class is deliberately EMPTY today; a future knob that genuinely
  changes verdict semantics must self-declare here and thereby exempt
  itself from the taint rule below, in writing).
* **taint** (``flow-knob-verdict``) — from every ``env_int`` /
  ``env_float`` / ``env_str`` / raw-environ call site of a ``routing``
  knob (unclassified knobs are treated as routing — conservative),
  values propagate through local assignments, module-level constants
  (cross-module by bare name: ``from mod import CONST`` re-binds the
  same name) and the return values of knob-*accessor* functions —
  functions whose return expression carries an env read or tainted
  constant directly, matched at bare-name call sites only (one level;
  transitive method-name matching conflates every ``get`` in the
  package). The sink is the verdict
  value itself: the value expression of a ``"valid?"`` key in a dict
  literal or a ``d["valid?"] = ...`` store. Control dependence is
  deliberately NOT tainted: ``if fastpath: <engine A> else: <engine
  B>`` is exactly what routing knobs are for — both engines must
  produce the same value, which the differential tests already pin.
  Data dependence is the violation: a verdict *computed from* a
  routing knob's value.

Pragma: ``# lint: allow(knob-verdict)`` on the sink line, with a
reason (none are needed on the shipped tree).

``verdict_taint(sources)`` additionally reports, for every knob of any
class, whether its value data-flows into a verdict expression — the
``verdict_reachable`` column of the ``--knob-registry`` artifact (all
false on the shipped tree; the CI assert keeps it that way).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Set, Tuple

from ..base import PACKAGE, Finding, SourceFile, pkg_rel
from .cfg import functions_of, walk_own
from .envknobs import _env_read, harvest

RULE_UNCLASS = "flow-knob-unclassified"
RULE_VERDICT = "flow-knob-verdict"
PRAGMA = "knob-verdict"

#: anchor file: the CLI walk triggers the whole-package analysis once
#: (platform.py defines the env_* helpers every knob read goes through).
ANCHOR = "platform.py"

ROUTING = "routing"
SEMANTIC = "semantic"
DURABILITY = "durability"
OPS = "ops"

#: every JGRAFT_* knob the port reads (the package and chip_smoke.py),
#: classified — exactly those: the JAX package's bench-only knobs have no
#: row here. The table is the contract: a new knob fails lint until a
#: class is chosen for it, and `semantic` membership is the only licence
#: to influence a verdict.
KNOB_CLASS: Dict[str, str] = {
    # -- routing: which engine/tier computes the verdict --------------
    "JGRAFT_AUTOTUNE": ROUTING,
    "JGRAFT_AUTOTUNE_MIN_CELLS": ROUTING,
    "JGRAFT_AUTOTUNE_MIN_ROWS": ROUTING,
    "JGRAFT_AUTOTUNE_SAMPLES": ROUTING,
    "JGRAFT_AUTOTUNE_SAMPLE_ROWS": ROUTING,
    "JGRAFT_CERTIFY_BATCH": ROUTING,
    "JGRAFT_CERTIFY_BATCH_MIN": ROUTING,
    "JGRAFT_CERTIFY_BATCH_MIN_HIT": ROUTING,
    "JGRAFT_CERTIFY_BATCH_MIN_OBS": ROUTING,
    "JGRAFT_CYCLE_CONDENSE": ROUTING,
    "JGRAFT_CYCLE_KERNEL": ROUTING,
    "JGRAFT_CYCLE_MAX_OPS": ROUTING,
    "JGRAFT_CYCLE_TIER": ROUTING,
    "JGRAFT_CYCLE_TILE": ROUTING,
    "JGRAFT_DISTRIBUTED": ROUTING,
    "JGRAFT_ENCODE_VECTOR": ROUTING,
    "JGRAFT_GREEDY_BACKTRACK": ROUTING,
    "JGRAFT_GREEDY_CERTIFY": ROUTING,
    "JGRAFT_LIN_FASTPATH": ROUTING,
    "JGRAFT_LIN_FASTPATH_ABORT": ROUTING,
    "JGRAFT_LIN_FASTPATH_MIN_HIT": ROUTING,
    "JGRAFT_LIN_FASTPATH_MIN_OBS": ROUTING,
    # shared lin-fastpath gate dir: where gate records
    # replicate FROM decides which engine tries first — routing, like
    # the rest of the linfp family; verdicts never depend on it.
    "JGRAFT_LINFP_DIR": ROUTING,
    "JGRAFT_MACRO_EVENTS": ROUTING,
    "JGRAFT_MERGE_ALL": ROUTING,
    "JGRAFT_MERGE_LONG": ROUTING,
    "JGRAFT_SCAN_CHUNK": ROUTING,
    # search-arm knobs route which CANDIDATES get generated/checked
    # (guided vs random parent/operator draw, mutation edit-seed
    # space); no knob touches how any candidate's verdict is computed
    "JGRAFT_SEARCH_EDIT_SPACE": ROUTING,
    "JGRAFT_SEARCH_GUIDED": ROUTING,
    "JGRAFT_SEGMENT": ROUTING,
    "JGRAFT_SERVICE_BATCH_WAIT_MS": ROUTING,
    "JGRAFT_SERVICE_MAX_BATCH_ROWS": ROUTING,
    "JGRAFT_STREAM_GREEDY_MAX_EVENTS": ROUTING,
    # -- durability: what is persisted, where, for how long -----------
    "JGRAFT_JOURNAL_GROUP_MS": DURABILITY,
    "JGRAFT_RESULT_STORE": DURABILITY,
    "JGRAFT_SERVICE_CLUSTER_DIR": DURABILITY,
    "JGRAFT_SERVICE_JOURNAL": DURABILITY,
    "JGRAFT_SERVICE_RETAIN": DURABILITY,
    # -- ops: fleet operation, bench drivers, budgets -----------------
    "JGRAFT_AUTOTUNE_STORE": OPS,
    "JGRAFT_CLIENT_KEEPALIVE": OPS,
    "JGRAFT_CLUSTER_SKEW_S": OPS,
    "JGRAFT_CLUSTER_TTL_S": OPS,
    "JGRAFT_DISTRIBUTED_TIMEOUT_MS": OPS,
    "JGRAFT_SEARCH_DIR": OPS,
    "JGRAFT_SEARCH_GENERATIONS": OPS,
    "JGRAFT_SEARCH_POP": OPS,
    "JGRAFT_SEARCH_SEED": OPS,
    "JGRAFT_SEARCH_SURVIVORS": OPS,
    "JGRAFT_SERVICE_ADVERTISE_URL": OPS,
    "JGRAFT_SERVICE_CACHE": OPS,
    "JGRAFT_SERVICE_CRASH_CAP": OPS,
    "JGRAFT_SERVICE_QUEUE": OPS,
    "JGRAFT_SERVICE_REPLICA_ID": OPS,
    "JGRAFT_SERVICE_SHED_DEPTH": OPS,
    "JGRAFT_SERVICE_UDS": OPS,
    "JGRAFT_SERVICE_WATCHDOG_S": OPS,
    "JGRAFT_SERVICE_WORKERS": OPS,
    "JGRAFT_STREAM_BYTES_PER_S": OPS,
    "JGRAFT_STREAM_IDLE_S": OPS,
    "JGRAFT_STREAM_RESIDENT_EVENTS": OPS,
    "JGRAFT_STREAM_SEGS_PER_S": OPS,
    "JGRAFT_STREAM_SESSIONS": OPS,
    # -- semantic: verdict-affecting by declaration (EMPTY: the routing
    # -- contract is that no knob changes verdict semantics) -----------
}

VERDICT_KEY = "valid?"


def applies_to(relpath: str) -> bool:
    return pkg_rel(relpath) == ANCHOR


def knob_class(name: str) -> str:
    return KNOB_CLASS.get(name, "unclassified")


# ----------------------------------------------------------- taint core


def _expr_knobs(expr: ast.AST, globals_t: Dict[str, Set[str]],
                locals_t: Dict[str, Set[str]],
                fns_t: Dict[str, Set[str]],
                tracked) -> Set[str]:
    """Knob names whose value data-flows into `expr`."""
    out: Set[str] = set()
    for sub in ast.walk(expr):
        r = _env_read(sub)
        if r is not None and tracked(r.name):
            out |= {r.name}
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            out |= locals_t.get(sub.id, set())
            out |= globals_t.get(sub.id, set())
        elif isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Name):
            # bare-name calls only: matching `x.get(...)` against every
            # method named `get` in the package conflates unrelated
            # definitions and poisons the whole call graph
            out |= fns_t.get(sub.func.id, set())
    return out


def _assign_targets(stmt: ast.AST) -> List[str]:
    tgts: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        tgts = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)) and \
            stmt.value is not None:
        tgts = [stmt.target]
    out = []
    for t in tgts:
        for el in ast.walk(t):
            if isinstance(el, ast.Name):
                out.append(el.id)
    return out


def _fn_locals(fn: ast.AST, globals_t, fns_t, tracked
               ) -> Dict[str, Set[str]]:
    """Intra-function fixpoint of name -> tainting knob set."""
    locals_t: Dict[str, Set[str]] = {}
    for _ in range(8):  # assignment chains are short; bound the loop
        changed = False
        for stmt in walk_own(fn):
            if not isinstance(stmt, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)):
                continue
            if stmt.value is None:
                continue
            knobs = _expr_knobs(stmt.value, globals_t, locals_t,
                                fns_t, tracked)
            if not knobs:
                continue
            for name in _assign_targets(stmt):
                if not knobs <= locals_t.get(name, set()):
                    locals_t[name] = locals_t.get(name, set()) | knobs
                    changed = True
        if not changed:
            break
    return locals_t


class _Surface:
    """Parsed whole-package view: module trees + the two cross-module
    taint maps (global constants and function return values)."""

    def __init__(self, sources: Dict[str, SourceFile], tracked):
        self.mods: List[Tuple[str, SourceFile, ast.AST]] = []
        self.globals_t: Dict[str, Set[str]] = {}
        self.fns_t: Dict[str, Set[str]] = {}
        self.errors: List[Finding] = []
        self.tracked = tracked
        for rel, src in sorted(sources.items()):
            try:
                tree = ast.parse(src.text)
            except SyntaxError as e:
                self.errors.append(Finding(src.path, e.lineno or 1,
                                           "parse-error", str(e)))
                continue
            self.mods.append((rel, src, tree))
        self._fixpoint()

    def _fixpoint(self) -> None:
        # pass 1 — module-level constants bound to knob reads, to a
        # cross-module fixpoint (a constant may re-export another).
        for _ in range(8):
            changed = False
            for _rel, _src, tree in self.mods:
                for stmt in tree.body:
                    if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        continue
                    if getattr(stmt, "value", None) is None:
                        continue
                    knobs = _expr_knobs(stmt.value, self.globals_t, {},
                                        {}, self.tracked)
                    if not knobs:
                        continue
                    for name in _assign_targets(stmt):
                        if not knobs <= self.globals_t.get(name, set()):
                            self.globals_t[name] = \
                                self.globals_t.get(name, set()) | knobs
                            changed = True
            if not changed:
                break
        # pass 2 — knob-accessor functions: a return value carrying an
        # env read or tainted constant DIRECTLY (through locals, not
        # through further calls). Deliberately ONE level: transitive
        # call-taint over bare names conflates every `get`/`put`
        # method in the package and drowns the rule in false
        # positives, while the real conduits (`scan_chunk()`,
        # `lin_fastpath_on()`, `greedy_backtrack_budget()`) are all
        # direct accessors.
        for _rel, _src, tree in self.mods:
            for _cls, fn in functions_of(tree):
                locals_t = _fn_locals(fn, self.globals_t, {},
                                      self.tracked)
                ret: Set[str] = set()
                for stmt in walk_own(fn):
                    if isinstance(stmt, ast.Return) and \
                            stmt.value is not None:
                        ret |= _expr_knobs(stmt.value, self.globals_t,
                                           locals_t, {}, self.tracked)
                if ret:
                    self.fns_t[fn.name] = \
                        self.fns_t.get(fn.name, set()) | ret

    def verdict_sinks(self):
        """Yield (rel, src, line, value-expr, locals_t) for every
        verdict-constructing expression on the surface."""
        for rel, src, tree in self.mods:
            for _cls, fn in functions_of(tree):
                locals_t = _fn_locals(fn, self.globals_t, self.fns_t,
                                      self.tracked)
                for node in walk_own(fn):
                    if isinstance(node, ast.Dict):
                        for k, v in zip(node.keys, node.values):
                            if isinstance(k, ast.Constant) and \
                                    k.value == VERDICT_KEY:
                                yield rel, src, v.lineno, v, locals_t
                    elif isinstance(node, ast.Assign):
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Subscript) and \
                                    isinstance(tgt.slice, ast.Constant) \
                                    and tgt.slice.value == VERDICT_KEY:
                                yield (rel, src, node.lineno,
                                       node.value, locals_t)


# --------------------------------------------------------------- driver


def verdict_taint(sources: Dict[str, SourceFile]) -> Dict[str, bool]:
    """knob -> does its value data-flow into any verdict expression?
    (all classes tracked; the --knob-registry verdict_reachable column)."""
    surface = _Surface(sources, tracked=lambda _n: True)
    reachable: Dict[str, bool] = {}
    for _rel, _src, _line, value, locals_t in surface.verdict_sinks():
        for knob in _expr_knobs(value, surface.globals_t, locals_t,
                                surface.fns_t, lambda _n: True):
            reachable[knob] = True
    return reachable


def analyze_sources(sources: Dict[str, SourceFile]) -> List[Finding]:
    findings: List[Finding] = []

    # half 1: every harvested knob is classified
    for rel, src in sorted(sources.items()):
        try:
            tree = ast.parse(src.text)
        except SyntaxError:
            continue  # _Surface reports the parse error below
        seen: Set[str] = set()
        for read in sorted(harvest(tree), key=lambda r: r.line):
            if read.name in seen or \
                    knob_class(read.name) != "unclassified":
                continue
            seen.add(read.name)
            if src.allowed(read.line, RULE_UNCLASS):
                continue
            findings.append(Finding(
                src.path, read.line, RULE_UNCLASS,
                f"{read.name} has no row in lint/flow/knobclass."
                "KNOB_CLASS — classify it as routing | semantic | "
                "durability | ops (semantic means verdict-affecting "
                "and exempts it from flow-knob-verdict, in writing)"))

    # half 2: routing-knob taint must never reach a verdict value
    def tracked(name: str) -> bool:
        return knob_class(name) in (ROUTING, "unclassified")

    surface = _Surface(sources, tracked=tracked)
    findings.extend(surface.errors)
    for _rel, src, line, value, locals_t in surface.verdict_sinks():
        knobs = _expr_knobs(value, surface.globals_t, locals_t,
                            surface.fns_t, tracked)
        if not knobs:
            continue
        if src.allowed(line, RULE_VERDICT) or src.allowed(line, PRAGMA):
            continue
        findings.append(Finding(
            src.path, line, RULE_VERDICT,
            "verdict value is computed from routing-class knob(s) "
            f"{', '.join(sorted(knobs))} — routing knobs choose which "
            "engine runs, never what it decides (the routing contract); "
            "reclassify the knob as `semantic` in KNOB_CLASS if the "
            "dependence is intended, otherwise derive the verdict "
            "from the history alone"))
    return findings


def _load_package(anchor: Path) -> Dict[str, SourceFile]:
    """The package that holds `anchor` (its nearest parent directory
    named PACKAGE, every module in it), or `anchor`'s own directory
    when no such parent exists — never a whole checkout."""
    anchor = anchor.resolve()
    pkg = next((p for p in anchor.parents if p.name == PACKAGE),
               anchor.parent)
    files = sorted(pkg.rglob("*.py")) if pkg.name == PACKAGE else \
        sorted(pkg.glob("*.py"))
    out: Dict[str, SourceFile] = {}
    for f in files:
        out[str(f.relative_to(pkg))] = SourceFile.load(f)
    return out


def analyze_file(path) -> List[Finding]:
    return analyze_sources(_load_package(Path(path)))
