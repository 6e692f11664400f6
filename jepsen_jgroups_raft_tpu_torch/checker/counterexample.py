"""Counterexample presentation for invalid linearizability verdicts.

A copy of the reference's checker/counterexample.py. Knossos emits
linearization diagrams and the upstream control image ships graphviz to
render anomalies; this module is that capability for the checker: given
an INVALID verdict, it

  1. recovers a machine-checkable explanation — the failing op (the
     completion at which no linearization order survives) and a witness
     prefix (one maximal legal linearization) — re-running the unbounded
     CPU frontier with witness tracking when the deciding engine (e.g. the
     CUDA kernel) didn't produce one;
  2. inlines a human-readable `counterexample` dict into the result map
     (store/results.json picks it up verbatim);
  3. renders `counterexample[-<key>].html` into the run's store dir: the
     op timeline with the violating op highlighted and the witness prefix
     listed below.
"""

from __future__ import annotations

import html as html_mod
from pathlib import Path
from typing import Optional

from ..history.ops import History, Op, pair_ops_indexed
from ..history.packing import encode_history
from .base import INVALID
from .timeline import render_timeline
from .wgl_cpu import FrontierOverflow, check_encoded_cpu

#: Minimization budget: the greedy pair-drop pass re-checks the history
#: once per candidate pair on the capped CPU frontier, so both knobs
#: bound worst-case minimization time (≈ pairs × frontier cap). Above
#: the pair cap the suffix truncation still applies — it is free.
MINIMIZE_MAX_PAIRS = 64
MINIMIZE_MAX_CONFIGS = 1 << 14


def _op_view(op: Op) -> dict:
    return {"index": op.index, "process": op.process, "type": op.type,
            "f": op.f, "value": op.value}


def _index_map(history: History) -> dict:
    """history-index → Op, matching packing's op_index convention
    (op.index when set, list position otherwise)."""
    out = {}
    for i, op in enumerate(history):
        out[op.index if op.index >= 0 else i] = op
    return out


def _encode_at_rung(history: History, model,
                    consistency: Optional[str]):
    """Encode (and, for a weaker rung, relax) a history — the stream the
    deciding engine actually scanned, so explanations and minimization
    re-searches stay on the verdict's own precedence order."""
    enc = encode_history(history, model)
    if consistency not in (None, "linearizable"):
        from .consistency import relax_encoded

        enc = relax_encoded(enc, model, consistency)
    return enc


def attach_counterexample(result: dict, history: History, model,
                          max_cpu_configs: Optional[int] = None,
                          consistency: Optional[str] = None) -> dict:
    """Enrich an INVALID result with failing-op/witness details, a
    human-readable `counterexample` dict, and (when the budget allows) a
    MINIMIZED witness history — the production-scale contract: a fail
    verdict comes back as a small reproducer, not a raw op dump. No-op
    for valid/unknown. `consistency` names the rung that produced the
    verdict so the re-search scans the same relaxed stream."""
    if result.get("valid?") is not INVALID:
        return result
    if "failing-op-index" not in result:
        # The deciding engine (a CUDA kernel) returned only the verdict;
        # recover the explanation on the CPU frontier. Host engines attach
        # failing-op-index during the verdict run, so this re-search only
        # happens for kernel-decided results.
        try:
            r = check_encoded_cpu(_encode_at_rung(history, model,
                                                  consistency), model,
                                  max_configs=max_cpu_configs, witness=True)
            if not r.valid:
                result.setdefault("failing-op-index", r.failing_op_index)
                if r.witness is not None:
                    result.setdefault("witness", r.witness)
        except FrontierOverflow:
            pass  # verdict stands; explanation unavailable at this budget

    by_index = _index_map(history)
    ce: dict = {}
    fi = result.get("failing-op-index")
    if fi is not None and fi in by_index:
        bad = by_index[fi]
        ce["failing-op"] = _op_view(bad)
        ce["explanation"] = (
            f"no linearization order satisfies the completion of "
            f"{bad.f} {bad.value!r} by process {bad.process} "
            f"(history index {fi}); every configuration that survived the "
            f"preceding ops is killed here")
    wit = result.get("witness")
    if wit is not None:
        ce["witness-prefix"] = [
            _op_view(by_index[i]) for i in wit if i in by_index
        ]
    if ce:
        result["counterexample"] = ce
    minimize_counterexample(result, history, model,
                            consistency=consistency)
    return result


def _still_invalid(ops, model, consistency) -> Optional[bool]:
    """Capped re-check of a candidate reduction; None = undecidable at
    the minimization budget (treated as 'keep the op')."""
    try:
        r = check_encoded_cpu(
            _encode_at_rung(History(list(ops)), model, consistency),
            model, max_configs=MINIMIZE_MAX_CONFIGS)
        return not r.valid
    except FrontierOverflow:
        return None


def minimize_counterexample(result: dict, history: History, model,
                            consistency: Optional[str] = None) -> dict:
    """Shrink an INVALID history to a small reproducer, in two sound
    passes:

      1. Suffix truncation (verified): the frontier died at the failing
         op's completion, so at the LINEARIZABLE rung nothing after
         that event participated — but at a weaker rung the deciding
         FORCE was DEFERRED past later ops' opens, which may have
         constrained the frontier, so the truncation is re-checked on
         the capped CPU frontier at the same rung and kept only when
         the prefix is still invalid (otherwise the full history stays).
      2. Greedy pair-drop (budgeted): for each remaining op pair except
         the failing one, re-check the history without it the same way;
         a pair whose removal keeps the verdict INVALID is removed for
         good. Each kept reduction preserves invalidity by direct
         re-check, so the final set is a genuine counterexample
         (1-minimal under the budget, not globally minimal).

    Attaches ``counterexample.minimal-ops`` / ``minimal-op-count`` when
    some verified reduction landed; skips silently when the failing op
    is unknown or nothing could be (affordably) verified smaller."""
    fi = result.get("failing-op-index")
    if fi is None:
        return result
    ops = list(history)
    comp_pos = None
    for i, op in enumerate(ops):
        idx = op.index if op.index >= 0 else i
        if idx == fi and op.is_completion():
            comp_pos = i
    if comp_pos is None:
        return result
    prefix = ops[:comp_pos + 1]
    failing_op = ops[comp_pos]
    reduced = False
    if len(prefix) < len(ops) and \
            _still_invalid(prefix, model, consistency):
        reduced = True
    else:
        prefix = ops
    pairs = pair_ops_indexed(prefix)
    if len(pairs) <= MINIMIZE_MAX_PAIRS:
        removed: set = set()
        for ip, cp, inv, comp in pairs:
            if cp >= 0 and prefix[cp] is failing_op:
                continue  # never drop the failing op itself
            trial = removed | ({ip, cp} - {-1})
            kept = [op for j, op in enumerate(prefix) if j not in trial]
            if _still_invalid(kept, model, consistency):
                removed = trial
        if removed:
            reduced = True
            prefix = [op for j, op in enumerate(prefix)
                      if j not in removed]
    if not reduced:
        return result
    ce = result.setdefault("counterexample", {})
    ce["minimal-ops"] = [_op_view(op) for op in prefix]
    ce["minimal-op-count"] = sum(1 for op in prefix if op.is_invoke())
    return result


def write_counterexample_html(result: dict, history: History,
                              store_dir, filename: str) -> Optional[str]:
    """Render the highlighted timeline + witness into the store dir."""
    if result.get("valid?") is not INVALID or not store_dir:
        return None
    ce = result.get("counterexample", {})
    lines = []
    if "explanation" in ce:
        lines.append("VIOLATION: " + ce["explanation"])
    for v in ce.get("witness-prefix", []):
        lines.append(
            f"  linearized: [{v['index']}] proc {v['process']} "
            f"{v['f']} {v['value']!r}")
    footer = html_mod.escape("\n".join(lines))
    doc = render_timeline(history,
                          highlight_index=result.get("failing-op-index"),
                          footer_html=footer)
    path = Path(store_dir) / filename
    try:
        path.write_text(doc)
    except OSError:
        return None
    result.setdefault("counterexample", {})["file"] = str(path)
    return str(path)
