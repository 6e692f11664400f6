"""graftlint core: findings, pragmas, file collection.

The suite is project-native on purpose (SURVEY.md §5.2 direction): generic
linters cannot know that recording ``fail`` for an indefinite error makes
the checker unsound (client/errors.py docstring), that a ``.item()`` on
a card tensor stalls the host until the card drains its stream, or that
``pending_`` belongs to ``mu_``. Each analyzer encodes one such
repo-level invariant and reports uniform :class:`Finding` rows.

Suppression: a line carrying ``lint: allow(<rule>)`` in a trailing comment
(``#`` in Python, ``//`` in C++) is exempt from that rule — the pragma is
the written record that a hop/handler is intentional.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Set

_PRAGMA_RE = re.compile(r"lint:\s*allow\(([\w\-,\s]+)\)")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    """A file plus its per-line pragma index."""

    path: str
    text: str
    allows: Dict[int, Set[str]] = field(default_factory=dict)

    @classmethod
    def load(cls, path) -> "SourceFile":
        text = Path(path).read_text(encoding="utf-8", errors="replace")
        return cls.from_text(str(path), text)

    @classmethod
    def from_text(cls, path: str, text: str) -> "SourceFile":
        allows: Dict[int, Set[str]] = {}
        for i, line in enumerate(text.splitlines(), start=1):
            m = _PRAGMA_RE.search(line)
            if m:
                allows[i] = {r.strip() for r in m.group(1).split(",")
                             if r.strip()}
        return cls(path, text, allows)

    def allowed(self, line: int, rule: str) -> bool:
        rules = self.allows.get(line)
        return bool(rules) and (rule in rules or "*" in rules)


def filter_allowed(src: SourceFile,
                   findings: Iterable[Finding]) -> List[Finding]:
    """Drop findings whose line carries a matching allow pragma."""
    return [f for f in findings if not src.allowed(f.line, f.rule)]


def collect_files(paths: Sequence[str], suffixes: Sequence[str]) -> List[Path]:
    """Expand files/directories into a sorted list of matching files."""
    out: Set[Path] = set()
    for p in paths:
        path = Path(p)
        if path.is_dir():
            for suf in suffixes:
                out.update(path.rglob(f"*{suf}"))
        elif path.suffix in suffixes:
            out.add(path)
    return sorted(out)


#: The package every analyzer's scope is relative to.
PACKAGE = "jepsen_jgroups_raft_tpu_torch"


def pkg_rel(relpath: str) -> str:
    """`relpath` with forward slashes and relative to the package when it
    lies inside it (``service/daemon.py``), else unchanged
    (``chip_smoke.py``): the one form every ``applies_to`` matches."""
    return relpath.replace("\\", "/").split(PACKAGE + "/", 1)[-1]


def rel(path, root) -> str:
    """Repo-relative display path (falls back to the input)."""
    try:
        return str(Path(path).resolve().relative_to(Path(root).resolve()))
    except ValueError:
        return str(path)
