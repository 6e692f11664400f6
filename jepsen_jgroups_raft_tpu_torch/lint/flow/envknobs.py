"""Env-knob registry analyzer: every ``JGRAFT_*`` read, accounted for.

``JGRAFT_*`` knobs are read across the port's checker, service,
parallel and harness tiers and its chip_smoke.py. Three failure modes keep
recurring: a raw ``int(os.environ.get(...))`` that crashes the importer
on a blank/garbage value (the failure platform.env_int exists to
prevent), two call sites parsing the same knob with *different
defaults* (the behavior silently depends on which module read it
first), and knobs that exist only in the source (the knob tables
drift). This analyzer harvests every read and enforces all
three, and ``build_registry`` emits the harvest as a JSON artifact so
CI (and doc reviews) can diff the actual knob surface.

Rules:

* ``flow-env-raw-parse`` (alias ``env-raw``) — ``int(...)``/
  ``float(...)`` directly wrapping an environment read of a
  ``JGRAFT_*`` name: must go through ``platform.env_int`` /
  ``env_float`` (``env_str`` for string knobs), whose blank/garbage
  handling warns and falls back instead of raising at import time.
* ``flow-env-undocumented`` (alias ``env-doc``) — a ``JGRAFT_*`` knob
  read in code but absent from ``doc/running.md`` (the JAX package's
  knob tables, which the port shares) and from the README's
  "PyTorch/CUDA port" section (where a knob only the port reads is
  documented); brace groups like ``JGRAFT_X_{A,B}`` are expanded before
  matching.
* ``flow-env-dup-default`` (alias ``env-dup``) — the same knob parsed
  at multiple sites with conflicting defaults/minimums/types
  (cross-file; reported by ``build_registry``, which the full-repo CLI
  run invokes).

Scan set: the whole package plus ``chip_smoke.py`` (EXTRA_FILES: the
script is where raw parses accumulate).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from ..base import PACKAGE, Finding, SourceFile, pkg_rel

RULE_RAW = "flow-env-raw-parse"
RULE_DOC = "flow-env-undocumented"
RULE_DUP = "flow-env-dup-default"

#: files outside the package covered by build_registry (and by the
#: per-file rules when the CLI full run invokes it).
EXTRA_FILES = ("chip_smoke.py",)

_KNOB_RE = re.compile(r"JGRAFT_[A-Z0-9_]+")
_BRACE_RE = re.compile(r"(JGRAFT_[A-Z0-9_]*)\{([A-Z0-9_,\s]+)\}")

_ENV_HELPERS = {"env_int": "int", "env_float": "float", "env_str": "str"}


def applies_to(relpath: str) -> bool:
    rp = relpath.replace("\\", "/")
    stripped = pkg_rel(rp)
    return stripped.endswith(".py") or rp in EXTRA_FILES


# ------------------------------------------------------------ harvesting


class KnobRead:
    __slots__ = ("name", "via", "line", "default", "minimum")

    def __init__(self, name: str, via: str, line: int,
                 default=None, minimum=None):
        self.name = name
        self.via = via
        self.line = line
        self.default = default
        self.minimum = minimum


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _literal(node: Optional[ast.AST]):
    if node is None:
        return None
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return "<expr>"


def _dotted(expr: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return None
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _env_read(node: ast.AST) -> Optional[KnobRead]:
    """A JGRAFT_* environment read at this AST node, if any."""
    if isinstance(node, ast.Subscript) and \
            isinstance(node.ctx, ast.Load) and \
            _dotted(node.value) == "os.environ":
        name = _const_str(node.slice)
        if name and name.startswith("JGRAFT_"):
            return KnobRead(name, "environ", node.lineno)
        return None
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    callee = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else "")
    if callee == "get" and isinstance(fn, ast.Attribute) and \
            _dotted(fn.value) == "os.environ" and node.args:
        name = _const_str(node.args[0])
        if name and name.startswith("JGRAFT_"):
            return KnobRead(name, "environ", node.lineno,
                            default=_literal(node.args[1])
                            if len(node.args) > 1 else None)
    elif callee == "getenv" and node.args:
        name = _const_str(node.args[0])
        if name and name.startswith("JGRAFT_"):
            return KnobRead(name, "environ", node.lineno,
                            default=_literal(node.args[1])
                            if len(node.args) > 1 else None)
    elif callee in _ENV_HELPERS and node.args:
        name = _const_str(node.args[0])
        if name and name.startswith("JGRAFT_"):
            minimum = None
            for kw in node.keywords:
                if kw.arg == "minimum":
                    minimum = _literal(kw.value)
            if len(node.args) > 2 and minimum is None:
                minimum = _literal(node.args[2])
            return KnobRead(name, callee, node.lineno,
                            default=_literal(node.args[1])
                            if len(node.args) > 1 else None,
                            minimum=minimum)
    return None


def harvest(tree: ast.AST) -> List[KnobRead]:
    return [r for node in ast.walk(tree)
            for r in [_env_read(node)] if r is not None]


def _raw_parses(tree: ast.AST) -> List[Tuple[str, int]]:
    """(knob, line) for int()/float() directly wrapping an environ
    read of a JGRAFT_* name."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("int", "float"):
            for arg in node.args:
                for sub in ast.walk(arg):
                    r = _env_read(sub)
                    if r is not None and r.via == "environ":
                        out.append((r.name, node.lineno))
    return out


# --------------------------------------------------------- documentation


_DOC_CACHE: Dict[str, Optional[Set[str]]] = {}


def doc_knob_names(text: str) -> Set[str]:
    """Knob names mentioned in doc text, expanding ``JGRAFT_X_{A,B}``
    brace groups into JGRAFT_X_A, JGRAFT_X_B."""
    names = set(_KNOB_RE.findall(text))
    for m in _BRACE_RE.finditer(text):
        for part in m.group(2).split(","):
            part = part.strip()
            if part:
                names.add(m.group(1) + part)
    return names


def _find_doc(start: Path) -> Optional[Path]:
    for parent in [start] + list(start.parents):
        cand = parent / "doc" / "running.md"
        if cand.exists():
            return cand
    return None


#: The README section that documents the port (and any knob only the
#: port reads).
README_SECTION = "## PyTorch/CUDA port"


def readme_section(text: str) -> str:
    """The README's port section: from its heading to the next ``## ``
    heading (empty when there is none)."""
    start = text.find(README_SECTION)
    if start < 0:
        return ""
    end = text.find("\n## ", start + len(README_SECTION))
    return text[start:] if end < 0 else text[start:end]


def _doc_names_for(path_str: str) -> Optional[Set[str]]:
    doc = _find_doc(Path(path_str).resolve().parent)
    if doc is None:
        return None
    key = str(doc)
    if key not in _DOC_CACHE:
        names = doc_knob_names(
            doc.read_text(encoding="utf-8", errors="replace"))
        readme = doc.parents[1] / "README.md"
        if readme.exists():
            names |= doc_knob_names(readme_section(readme.read_text(
                encoding="utf-8", errors="replace")))
        _DOC_CACHE[key] = names
    return _DOC_CACHE[key]


# --------------------------------------------------------------- analysis


def analyze_source(src: SourceFile,
                   doc_names: Optional[Set[str]] = None) -> List[Finding]:
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    findings: List[Finding] = []
    for knob, line in _raw_parses(tree):
        if src.allowed(line, RULE_RAW) or src.allowed(line, "env-raw"):
            continue
        findings.append(Finding(
            src.path, line, RULE_RAW,
            f"raw int()/float() parse of {knob} — a blank or garbage "
            "value raises at import time; use platform.env_int/"
            "env_float, which warn and fall back to the default"))
    if doc_names is None:
        doc_names = _doc_names_for(src.path)
    if doc_names is not None:
        seen: Set[str] = set()
        for read in sorted(harvest(tree), key=lambda r: r.line):
            if read.name in seen or read.name in doc_names:
                continue
            seen.add(read.name)
            if src.allowed(read.line, RULE_DOC) or \
                    src.allowed(read.line, "env-doc"):
                continue
            findings.append(Finding(
                src.path, read.line, RULE_DOC,
                f"{read.name} is read here but absent from "
                "doc/running.md's knob tables and the README's port "
                "section — add a row (or expand "
                "the brace group that should cover it)"))
    return findings


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))


# --------------------------------------------------------------- registry


def build_registry(root) -> Tuple[dict, List[Finding]]:
    """Scan the package + EXTRA_FILES; return (registry-json-dict,
    findings): per-file findings for the EXTRA_FILES (the normal CLI
    walk does not visit them) plus cross-file dup-default findings."""
    root = Path(root)
    files: List[Path] = sorted(
        (root / PACKAGE).rglob("*.py"))
    extras = [root / f for f in EXTRA_FILES if (root / f).exists()]
    doc = _doc_names_for(str(root / PACKAGE))
    knobs: Dict[str, List[Tuple[str, KnobRead]]] = {}
    findings: List[Finding] = []
    srcs: Dict[str, SourceFile] = {}
    for f in files + extras:
        src = SourceFile.load(f)
        relp = str(f.relative_to(root))
        srcs[relp] = src
        try:
            tree = ast.parse(src.text)
        except SyntaxError:
            continue  # the per-file pass reports parse errors
        for read in harvest(tree):
            knobs.setdefault(read.name, []).append((relp, read))
        if f in extras:
            for fnd in analyze_source(src, doc_names=doc):
                findings.append(Finding(relp, fnd.line, fnd.rule,
                                        fnd.message))
    # graftgate columns: classification from the
    # knobclass table, and whether the knob's value data-flows into any
    # verdict expression (imported lazily — knobclass imports this
    # module for the harvest helpers).
    from .knobclass import knob_class, verdict_taint

    reachable = verdict_taint({relp: s for relp, s in srcs.items()
                               if relp.endswith(".py")})
    registry: Dict[str, dict] = {}
    for name in sorted(knobs):
        sites = sorted(knobs[name], key=lambda s: (s[0], s[1].line))
        typed = [(relp, r) for relp, r in sites if r.via in _ENV_HELPERS]
        # conflicting parse configs for one knob: order-of-import decides
        # the behavior, which is exactly the bug class this rule kills
        distinct = {(r.via, repr(r.default), repr(r.minimum))
                    for _relp, r in typed}
        if len(distinct) > 1:
            first_relp, first = typed[0]
            for relp, r in typed[1:]:
                if (r.via, repr(r.default), repr(r.minimum)) == \
                        (first.via, repr(first.default), repr(first.minimum)):
                    continue
                if srcs[relp].allowed(r.line, RULE_DUP) or \
                        srcs[relp].allowed(r.line, "env-dup"):
                    continue
                findings.append(Finding(
                    relp, r.line, RULE_DUP,
                    f"{name} parsed as {r.via}(default={r.default!r}, "
                    f"minimum={r.minimum!r}) here but as "
                    f"{first.via}(default={first.default!r}, "
                    f"minimum={first.minimum!r}) at {first_relp}:"
                    f"{first.line} — one knob, one parse: hoist a shared "
                    "helper or align the defaults"))
        registry[name] = {
            "type": (typed[0][1].via.replace("env_", "")
                     if typed else "raw"),
            "class": knob_class(name),
            "verdict_reachable": bool(reachable.get(name, False)),
            "documented": (name in doc) if doc is not None else None,
            "sites": [{
                "path": relp, "line": r.line, "via": r.via,
                **({"default": r.default} if r.default is not None else {}),
                **({"minimum": r.minimum} if r.minimum is not None else {}),
            } for relp, r in sites],
        }
    reg = {"version": 2,
           "comment": "JGRAFT_* env-knob registry harvested by the "
                      "envknobs analyzer; regenerate with "
                      "python -m jepsen_jgroups_raft_tpu_torch.lint "
                      "--rules envknobs --knob-registry FILE",
           "knobs": registry}
    return reg, findings
