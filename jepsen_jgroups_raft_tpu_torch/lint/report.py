"""Finding output formats and the regression baseline.

SARIF-style JSON (``--format json``) makes graftlint findings machine-
readable for CI annotation (the 2.1.0 result/location shape GitHub code
scanning ingests). The baseline (``lint/baseline.json``) holds
fingerprints of accepted pre-existing findings so the gate fails only on
*regression*: new findings exit non-zero, baselined ones are reported as
suppressed.

Fingerprints are content-based, not line-based: sha1 over (path, rule,
stripped source line text) plus an occurrence counter for duplicates —
so findings survive unrelated edits that shift line numbers, and a
baseline never silently grows to cover a *new* instance of an old rule
on the same line text twice.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from .base import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def _line_text(root: Path, finding: Finding,
               cache: Dict[str, List[str]]) -> str:
    lines = cache.get(finding.path)
    if lines is None:
        try:
            lines = (root / finding.path).read_text(
                encoding="utf-8", errors="replace").splitlines()
        except OSError:
            lines = []
        cache[finding.path] = lines
    if 1 <= finding.line <= len(lines):
        return lines[finding.line - 1].strip()
    return f"<line {finding.line}>"


def fingerprints(findings: Sequence[Finding],
                 root) -> List[Tuple[Finding, str]]:
    """[(finding, stable fingerprint)] in input order."""
    root = Path(root)
    cache: Dict[str, List[str]] = {}
    seen: Counter = Counter()
    out = []
    for f in findings:
        key = f"{f.path}|{f.rule}|{_line_text(root, f, cache)}"
        seq = seen[key]
        seen[key] += 1
        digest = hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]
        out.append((f, f"{digest}:{seq}"))
    return out


def load_baseline(path) -> set:
    p = Path(path)
    if not p.exists():
        return set()
    data = json.loads(p.read_text(encoding="utf-8"))
    return set(data.get("findings", []))


def save_baseline(path, fps: Sequence[str]) -> None:
    Path(path).write_text(json.dumps(
        {"version": 1,
         "comment": "accepted pre-existing graftlint findings; "
                    "regenerate with --update-baseline",
         "findings": sorted(fps)}, indent=2) + "\n", encoding="utf-8")


def to_sarif(findings: Sequence[Finding], baselined: Sequence[bool],
             rule_ids: Sequence[str],
             rule_help: Dict[str, str] = None) -> dict:
    """One-run SARIF log; `baselined[i]` marks finding i suppressed.
    `rule_help` maps rule ids to helpUri anchors (the README's lint
    section) so code-scanning UIs link each finding to the invariant it
    enforces."""
    results = []
    for f, sup in zip(findings, baselined):
        results.append({
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(f.line, 1)},
                },
            }],
            "suppressions": (
                [{"kind": "external",
                  "justification": "baselined in lint/baseline.json"}]
                if sup else []),
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "README.md#graftlint-on-the-port",
                "rules": [
                    {"id": r, **({"helpUri": rule_help[r]}
                                 if rule_help and r in rule_help else {})}
                    for r in sorted(set(rule_ids))],
            }},
            "results": results,
        }],
    }
