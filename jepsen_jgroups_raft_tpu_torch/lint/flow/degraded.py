"""Degraded-result quarantine analyzer (graftgate rule (b)).

The never-persist rule (doc/checker-design.md §16): a result stamped
``platform-degraded`` (the honesty stamp — the platform the
verdict ran on was not the platform the caller asked for) must never
reach a durable or shared surface, because every one of them replays
the stamp onto a healed platform: the LRU result cache, the
:class:`ResultStore` (``results/`` and ``detail/`` publishes), and WAL
terminal records. This analyzer walks every such sink in the service
and parallel tiers and demands a proof the value is clean:

* **guard dominance** — the sink is dominated by a degraded guard of
  clean polarity (``not any("platform-degraded" in r ...)`` on the
  TRUE arm, ``if is_degraded(x): return`` fall-through on the FALSE
  arm — :func:`taint.clean_edges`);
* **self-gating callee** — ``.put`` / ``.put_detail`` on a ``store``
  receiver is clean because ``ResultStore.put``/``put_detail``
  themselves refuse degraded input before ``_publish``. That gate is
  VERIFIED, not assumed: this analyzer re-proves the dominance inside
  store.py on every run, and if the gate is edited away, every call
  site that leaned on it fires along with the gate itself;
* **clean source** — a value read back from the store
  (``x = ...store.get(...)``) is clean by the store's own gate, so
  warming the LRU from it needs no local guard;
* **pragma** — ``# lint: allow(degraded)`` with a reason, for sinks
  whose cleanliness is structural but out of this analyzer's sight
  (daemon's journal-replay warm: WAL terminals never persist degraded
  results, so replayed results are clean by construction).

Sinks: ``<...cache...>.put(...)``, ``<...store...>.put/put_detail``,
``self._publish("results"|"detail", ...)`` (store.py's raw writer) and
``rec["results"] = ...`` in journal.py's record encoders (the WAL
terminal / stream-fin payload).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set

from ..base import Finding, SourceFile, pkg_rel
from .cfg import build_cfg, functions_of
from . import taint

RULE = "flow-degraded-sink"
PRAGMA = "degraded"

#: anchor file: the CLI walk triggers the whole-tier analysis once.
ANCHOR = "service/daemon.py"

SCAN = (
    "service/daemon.py",
    "service/scheduler.py",
    "service/journal.py",
    "service/store.py",
    "service/cluster.py",
    "service/stream.py",
    "parallel/distributed.py",
)

STORE_FILE = "service/store.py"
JOURNAL_FILE = "service/journal.py"
_GATED_METHODS = ("put", "put_detail")


def applies_to(relpath: str) -> bool:
    return pkg_rel(relpath) == ANCHOR


# -------------------------------------------------------------- sinks


def _recv(call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return taint.dotted(call.func.value) or ""
    return ""


def _is_cache_put(call: ast.Call) -> bool:
    return taint.call_name(call) == "put" and "cache" in _recv(call)


def _is_store_put(call: ast.Call) -> bool:
    return taint.call_name(call) in _GATED_METHODS and \
        "store" in _recv(call)


def _is_raw_publish(call: ast.Call) -> bool:
    if taint.call_name(call) != "_publish" or not call.args:
        return False
    kind = call.args[0]
    return isinstance(kind, ast.Constant) and \
        kind.value in ("results", "detail")


def _clean_source_names(fn: ast.AST) -> Set[str]:
    """Names assigned from a store read-back (`x = ...store.get(...)`):
    the store never holds degraded entries, so x is clean."""
    out: Set[str] = set()
    for node in taint.walk_own(fn):
        if not (isinstance(node, ast.Assign) and
                isinstance(node.value, ast.Call)):
            continue
        call = node.value
        if taint.call_name(call) == "get" and "store" in _recv(call):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _value_arg(call: ast.Call) -> Optional[ast.AST]:
    """The stored-value argument of a put-family call (last positional
    — put(key, value) / put_detail(key, value))."""
    return call.args[-1] if len(call.args) >= 2 else None


# ----------------------------------------------------- store self-gate


def _store_gate_ok(store_src: SourceFile) -> Dict[str, bool]:
    """method name -> is every path from entry to its _publish call
    dominated by a clean-polarity degraded guard?"""
    out = {m: False for m in _GATED_METHODS}
    try:
        tree = ast.parse(store_src.text)
    except SyntaxError:
        return out
    for _cls, fn in functions_of(tree):
        if fn.name not in _GATED_METHODS:
            continue
        cfg = build_cfg(fn)
        publishes = [n for n in taint.walk_own(fn)
                     if isinstance(n, ast.Call) and
                     taint.call_name(n) == "_publish"]
        ok = bool(publishes)
        for call in publishes:
            if not taint.dominated(cfg, call, set(),
                                   lambda t, _w: taint.clean_edges(t)):
                ok = False
        out[fn.name] = ok
    return out


# --------------------------------------------------------------- driver


def analyze_sources(sources: Dict[str, SourceFile]) -> List[Finding]:
    store_src = sources.get(STORE_FILE)
    gate_ok = _store_gate_ok(store_src) if store_src is not None \
        else {m: False for m in _GATED_METHODS}

    findings: List[Finding] = []
    for rel, src in sorted(sources.items()):
        try:
            tree = ast.parse(src.text)
        except SyntaxError as e:
            findings.append(Finding(src.path, e.lineno or 1,
                                    "parse-error", str(e)))
            continue
        is_store = rel.endswith("store.py")
        is_journal = rel.endswith("journal.py")
        for _cls, fn in functions_of(tree):
            cfg = build_cfg(fn)
            clean_names = _clean_source_names(fn)

            def guarded(node) -> bool:
                return taint.dominated(
                    cfg, node, set(),
                    lambda t, _w: taint.clean_edges(t))

            for node in taint.walk_own(fn):
                sink = kind = None
                if isinstance(node, ast.Call):
                    if _is_cache_put(node):
                        sink, kind = node, "LRU cache put"
                    elif _is_store_put(node) and not is_store:
                        if gate_ok.get(taint.call_name(node)):
                            continue  # verified self-gating callee
                        sink, kind = node, (
                            f"ResultStore.{taint.call_name(node)} "
                            "whose degraded self-gate is missing")
                    elif _is_raw_publish(node) and is_store:
                        sink, kind = node, "raw store publish"
                elif isinstance(node, ast.Assign) and is_journal:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Subscript) and \
                                isinstance(tgt.slice, ast.Constant) \
                                and tgt.slice.value == "results":
                            sink, kind = node, "WAL record results field"
                if sink is None:
                    continue
                line = sink.lineno
                if src.allowed(line, RULE) or src.allowed(line, PRAGMA):
                    continue
                if isinstance(sink, ast.Call):
                    val = _value_arg(sink)
                    if isinstance(val, ast.Name) and \
                            val.id in clean_names:
                        continue  # store read-back: clean by the gate
                if guarded(sink):
                    continue
                findings.append(Finding(
                    src.path, line, RULE,
                    f"{kind} is reachable without a degraded-result "
                    "guard on the path — a platform-degraded verdict "
                    "would be persisted/shared and replayed onto a "
                    "healed platform (§16 never-persist rule); guard "
                    "with `not any(\"platform-degraded\" in r ...)` "
                    "/ is_degraded(), or record why the value is "
                    "structurally clean with `# lint: allow(degraded)`"))
    return findings


def _load_tier(anchor: Path) -> Dict[str, SourceFile]:
    pkg = anchor.resolve().parents[1]
    return {rel: SourceFile.load(pkg / rel)
            for rel in SCAN if (pkg / rel).exists()}


def analyze_file(path) -> List[Finding]:
    return analyze_sources(_load_tier(Path(path)))
