"""graftlint on the port, held to the JAX package's lint on the same inputs.

Thirteen of the port's fifteen analyzers (and the flow machinery under
them: cfg, taint, locks, interp) are copies of the JAX package's with
their scopes on ``jepsen_jgroups_raft_tpu_torch/``. Both lints are
stdlib-only, so each copy is run beside its original:

* :func:`twin_of` wraps a copied analyzer so that every
  ``analyze_source`` / ``analyze_sources`` / ``analyze_file`` call also
  runs the JAX package's analyzer on the same text (the package prefix of
  the path swapped) and asserts the same (path, line, rule) findings. The
  mirror tests (``test_torch_lint*.py``) call their copied analyzers
  through it, so each of their seeded fixtures and mutations is a
  differential case.
* The tree tests copy a whole package — the JAX package with its prefix
  rewritten to the port's, and the port with its prefix rewritten to the
  JAX package's — and hold the two lints' scopes and findings equal file
  by file, with the ``lint: allow`` pragmas kept (both clean) and
  stripped (every finding the pragmas answer, equal).
* The interpreter the kernel contract evaluates the plain twins with
  agrees with the JAX package's on every module constant the latter
  resolves, and with Python itself on the twins over their domains.

The port's documented differences (:func:`documented_delta`): its
``taxonomy`` counts the distributed tier's logging ``_degrade`` helper as
a visible handler; its ``lockstep`` reads only a file that defines a
twin; its ``knobclass`` table holds exactly the knobs the port reads.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import re
import shutil
from pathlib import Path
from unittest import mock

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.lint import cli
from jepsen_jgroups_raft_tpu_torch.lint.base import SourceFile

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = "jepsen_jgroups_raft_tpu_torch"
REF = "jepsen_jgroups_raft_tpu"

#: the copied analyzers: CLI name → the port's module
COPIED = {name: mod for name, (mod, _) in cli.ANALYZERS.items()
          if name not in cli.REDESIGNED}


def ref_module(port_mod):
    """The JAX package's module that `port_mod` copies."""
    return importlib.import_module(port_mod.__name__.replace(PORT, REF, 1))


_REF_BASE = importlib.import_module(f"{REF}.lint.base")


def to_ref(path: str) -> str:
    return str(path).replace("\\", "/").replace(f"{PORT}/", f"{REF}/")


def to_port(path: str) -> str:
    return str(path).replace("\\", "/").replace(f"{REF}/", f"{PORT}/")


def _handlers_calling(text: str, names) -> set:
    """Lines of the `except` handlers of `text` whose body calls one of
    `names`."""
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return set()
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and any(
                isinstance(c, ast.Call) and
                getattr(c.func, "id", getattr(c.func, "attr", None)) in names
                for stmt in node.body for c in ast.walk(stmt)):
            out.add(node.lineno)
    return out


def documented_delta(name: str, text_of, only_ref, only_port) -> bool:
    """Whether findings (path, line, rule) that one lint reports and the
    other does not are the port's documented differences; `text_of`
    maps a finding's path to its file's text."""
    if not only_ref and not only_port:
        return True
    if only_port:
        return False
    if name == "taxonomy":
        helpers = COPIED["taxonomy"].LOG_HELPERS
        return all(rule == "taxonomy-silent-swallow" and
                   line in _handlers_calling(text_of(path), helpers)
                   for path, line, rule in only_ref)
    if name == "lockstep":
        mod = COPIED["lockstep"]
        return all(rule == "flow-lockstep-anchor" and
                   not path.endswith(mod.ANCHOR) and
                   not mod._DEFINES_TWIN.search(text_of(path))
                   for path, line, rule in only_ref)
    return False


def _keyed(findings, norm):
    return sorted({(norm(f.path), f.line, f.rule) for f in findings})


class Twin:
    """A copied analyzer whose every analysis also runs the JAX
    package's on the same input and must agree with it; any other
    attribute is the port's module's."""

    def __init__(self, name: str):
        self._name = name
        self._port = COPIED[name]
        self._ref = ref_module(self._port)

    def __getattr__(self, attr):
        return getattr(self._port, attr)

    def _ref_tables(self):
        # the JAX package's knob table has rows for its bench-only knobs;
        # the logic is compared under the port's table
        if self._name == "knobclass":
            return mock.patch.object(self._ref, "KNOB_CLASS",
                                     self._port.KNOB_CLASS)
        return contextlib.nullcontext()

    def _hold(self, got, want, texts) -> None:
        got_k = _keyed(got, to_port)
        want_k = _keyed(want, to_port)
        only_ref = sorted(set(want_k) - set(got_k))
        only_port = sorted(set(got_k) - set(want_k))

        def text_of(path):
            if path in texts:
                return texts[path]
            p = Path(path)
            return p.read_text(encoding="utf-8", errors="replace") \
                if p.exists() else ""

        assert documented_delta(self._name, text_of, only_ref, only_port), (
            f"{self._name}: the port's analyzer disagrees with the JAX "
            f"package's on the same input: only the JAX package's "
            f"{only_ref}, only the port's {only_port}")

    def analyze_source(self, src, *args, **kw):
        got = self._port.analyze_source(src, *args, **kw)
        with self._ref_tables():
            want = self._ref.analyze_source(
                _REF_BASE.SourceFile.from_text(to_ref(src.path), src.text),
                *args, **kw)
        self._hold(got, want, {to_port(src.path): src.text})
        return got

    def analyze_sources(self, srcs, *args, **kw):
        got = self._port.analyze_sources(srcs, *args, **kw)
        ref_srcs = {k: _REF_BASE.SourceFile.from_text(to_ref(s.path), s.text)
                    for k, s in srcs.items()}
        with self._ref_tables():
            want = self._ref.analyze_sources(ref_srcs, *args, **kw)
        self._hold(got, want, {to_port(s.path): s.text
                               for s in srcs.values()})
        return got

    def analyze_file(self, path, *args, **kw):
        got = self._port.analyze_file(path, *args, **kw)
        with self._ref_tables():
            want = self._ref.analyze_file(path, *args, **kw)
        self._hold(got, want, {})
        return got


def twin_of(name: str) -> Twin:
    return Twin(name)


# ------------------------------------------------------------ tree copies


_PRAGMA = re.compile(r"(lint:\s*)allow\(")


def _copy_tree(src_pkg: str, dst_pkg: str, root: Path, strip: bool) -> Path:
    """`src_pkg` of this checkout (with native/src and doc/running.md)
    under `root`, the package directory and every mention of it renamed
    to `dst_pkg`, and, with `strip`, every ``lint: allow(`` pragma made
    inert (line numbers unchanged)."""
    if src_pkg == REF:
        rename = re.compile(rf"\b{REF}(?!_torch)\b")
    else:
        rename = re.compile(rf"\b{PORT}\b")
    shutil.copytree(REPO / src_pkg, root / dst_pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so",
                                                  "*.o", "build*"))
    shutil.copytree(REPO / "native" / "src", root / "native" / "src")
    (root / "doc").mkdir()
    shutil.copy(REPO / "doc" / "running.md", root / "doc" / "running.md")
    for f in list((root / dst_pkg).rglob("*")) + \
            list((root / "native" / "src").rglob("*")):
        if f.suffix not in (".py", ".h", ".cc", ".json") or not f.is_file():
            continue
        text = f.read_text(encoding="utf-8", errors="replace")
        new = rename.sub(dst_pkg, text)
        if strip:
            new = _PRAGMA.sub(r"\1allow_off(", new)
        if new != text:
            f.write_text(new, encoding="utf-8")
    return root


#: (name, the package copied, stripped pragmas?)
TREES = [(src, strip) for src in (REF, PORT) for strip in (False, True)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Per (copied package, strip): (the tree under the JAX package's
    name, the tree under the port's name). The checkout's own package
    stands for itself, pragma'd trees and all, so a copy is made only of
    what must be renamed or stripped."""
    out = {}
    for src, strip in TREES:
        base = tmp_path_factory.mktemp(f"{src}-{'strip' if strip else 'kept'}")
        other = PORT if src == REF else REF
        renamed = _copy_tree(src, other, base / "renamed", strip)
        if strip:
            same = _copy_tree(src, src, base / "same", True)
        else:
            same = REPO
        out[(src, strip)] = (same, renamed) if src == REF else \
            (renamed, same)
    return out


def _tree_findings(mod, root: Path, pkg: str, tables=None):
    """(scope, findings) of analyzer `mod` over the files of `pkg` and
    native/src under `root` with its suffixes: {relpath: in scope?},
    {relpath: {(line, rule)}}."""
    [suffixes] = [sfx for m, sfx in cli.ANALYZERS.values() if m is mod] \
        or [sfx for m, sfx in cli.ANALYZERS.values()
            if m.__name__ == mod.__name__.replace(REF, PORT, 1)]
    scopes, found = {}, {}
    files = sorted((root / pkg).rglob("*")) + \
        sorted((root / "native" / "src").rglob("*"))
    with tables or contextlib.nullcontext():
        for f in files:
            if "__pycache__" in f.parts or f.suffix not in suffixes or \
                    not f.is_file():
                continue
            relpath = f.relative_to(root).as_posix()
            scopes[relpath] = mod.applies_to(relpath)
            if scopes[relpath]:
                for x in mod.analyze_file(f):
                    p = Path(x.path)
                    key = p.relative_to(root).as_posix() if p.is_absolute() \
                        and p.is_relative_to(root) else str(x.path)
                    found.setdefault(key, set()).add((x.line, x.rule))
    return scopes, found


@pytest.mark.parametrize("name", sorted(COPIED))
@pytest.mark.parametrize("src,strip", TREES,
                         ids=[f"{'ref' if s == REF else 'port'}-"
                              f"{'stripped' if t else 'pragmas'}"
                              for s, t in TREES])
def test_copied_analyzer_matches_the_reference_on_a_whole_tree(
        trees, name, src, strip):
    """One package's tree under both names: the port's analyzer over the
    copy named for the port and the JAX package's over the copy named for
    it take the same files into scope and report the same (line, rule)
    findings in each — none with the pragmas kept, the same ones with
    them stripped — but for the port's documented differences. The
    port's knob table is compared under the JAX package's rows on the
    JAX package's tree (its rows are those rows, cut to the port's
    knobs: test_knob_table_is_the_references_cut_to_the_ports_knobs)."""
    ref_root, port_root = trees[(src, strip)]
    port_mod = COPIED[name]
    ref_mod = ref_module(port_mod)
    tables = None
    if name == "knobclass" and src == REF:
        tables = mock.patch.object(port_mod, "KNOB_CLASS",
                                   ref_mod.KNOB_CLASS)
    ref_scope, ref_found = _tree_findings(ref_mod, ref_root, REF)
    port_scope, port_found = _tree_findings(port_mod, port_root, PORT,
                                            tables)
    assert {to_port(k): v for k, v in ref_scope.items()} == port_scope
    assert any(port_scope.values()), f"{name}: nothing in scope"

    ref_flat = {(to_port(p), ln, r) for p, v in ref_found.items()
                for ln, r in v}
    port_flat = {(p, ln, r) for p, v in port_found.items() for ln, r in v}

    def text_of(path):
        return (port_root / path).read_text(encoding="utf-8",
                                            errors="replace")

    only_ref = sorted(ref_flat - port_flat)
    only_port = sorted(port_flat - ref_flat)
    assert documented_delta(name, text_of, only_ref, only_port), (
        f"{name} on the {src} tree (pragmas "
        f"{'stripped' if strip else 'kept'}): only the JAX package's "
        f"{only_ref[:10]}, only the port's {only_port[:10]}")
    if not strip:
        # both lints are clean on their own package, pragmas and all
        assert not (port_flat if src == PORT else ref_flat)


def test_stripped_trees_are_not_vacuous(trees):
    """With the pragmas stripped the copied analyzers do find what the
    pragmas answer, in both packages — the comparison above compares
    something."""
    counts = {}
    for src in (REF, PORT):
        ref_root, port_root = trees[(src, True)]
        n = 0
        for name in ("taxonomy", "crashproto", "fingerprint", "degraded",
                     "guarded"):
            _, found = _tree_findings(COPIED[name], port_root, PORT)
            n += sum(len(v) for v in found.values())
        counts[src] = n
    assert counts[REF] >= 10 and counts[PORT] >= 10, counts


def test_knob_table_is_the_references_cut_to_the_ports_knobs():
    """Every row of the port's knob table is the JAX package's row, and
    it holds exactly the knobs the port reads (its package and
    chip_smoke.py)."""
    from jepsen_jgroups_raft_tpu_torch.lint.flow import envknobs

    port_tab = COPIED["knobclass"].KNOB_CLASS
    ref_tab = ref_module(COPIED["knobclass"]).KNOB_CLASS
    assert {k: ref_tab.get(k) for k in port_tab} == port_tab
    registry, _ = envknobs.build_registry(REPO)
    assert set(port_tab) == set(registry["knobs"])


# ------------------------------------------------------------ interpreter


def _interp_modules():
    return sorted(p.relative_to(REPO / REF).as_posix()
                  for p in (REPO / REF).rglob("*.py")
                  if "__pycache__" not in p.parts and
                  p.parts[len(REPO.parts) + 1] in ("ops", "parallel",
                                                   "history", "checker"))


def _plain(v) -> bool:
    """A value both interpreters spell alike: an int, float, str or bool,
    or a tuple of them."""
    if isinstance(v, tuple) and type(v) is tuple:
        return all(_plain(x) for x in v)
    return isinstance(v, (int, float, str))


@pytest.mark.parametrize("rel", _interp_modules())
def test_interp_agrees_with_the_references_on_its_modules(rel):
    """The port's interpreter (with its relative-import binding, NamedTuple
    records and int.bit_length) binds every module constant of the JAX
    package's checker modules that the JAX package's interpreter
    resolves, to the same value."""
    port_interp = importlib.import_module(f"{PORT}.lint.flow.interp")
    ref_interp = importlib.import_module(f"{REF}.lint.flow.interp")
    text = (REPO / REF / rel).read_text(encoding="utf-8")
    tree = ast.parse(text)
    ref = ref_interp.Interp(tree)
    plain = port_interp.Interp(ast.parse(text))
    loaded = port_interp.load(REPO / REF / rel)
    resolved = {k: v for k, v in ref.module_env.items() if _plain(v)}
    for k, v in resolved.items():
        assert plain.module_env.get(k) == v, (rel, k)
        assert loaded.module_env.get(k) == v, (rel, k)
    assert set(plain.functions) == set(ref.functions)


#: the plain twins the kernel contract evaluates, with argument grids
TWIN_CALLS = {
    "ops/linear_scan.py": [
        ("sort_shape_plain", [(W, C, t, cap)
                              for W in (1, 5, 31, 32, 63, 64, 96, 127)
                              for C in (1, 64, 512)
                              for t in (0, 32, 1024) for cap in (0, 1)]),
        ("sort_smem_plain", [(W, C, W // 32 + 1, tile, tlog)
                             for W in (1, 127) for C in (1, 512)
                             for tile in (1, 512) for tlog in (1, 13)]),
    ],
    "ops/segment_scan.py": [
        ("segment_shape_at", [(W, lf, nb) for W in (1, 5, 10)
                              for lf in (0, 2, 4) for nb in (1, 33, 4096)]),
        ("segment_smem_bytes", [(W, lf, w, t) for W in (1, 9)
                                for lf in (0, 4) for w in (1, 8)
                                for t in (1, 2048)]),
        ("segment_tile", [(e,) for e in (1, 700, 2048, 5000)]),
    ],
    "ops/election_safety.py": [
        ("election_threads", [(n,) for n in (1, 32, 33, 511, 512, 8192)]),
    ],
    "ops/cycle_closure.py": [
        ("closure_smem_bytes", [(n,) for n in (1, 128, 129, 256, 257, 512,
                                               513, 4096)]),
        ("closure_static_smem_bytes", [(n, t) for n in (1, 100, 128, 300,
                                                        1024, 4096)
                                       for t in (None, 32, 256)]),
        ("closure_shape", [(n, t) for n in (1, 128, 129, 512, 1024, 4096)
                           for t in (None, 64)]),
    ],
}


@pytest.mark.parametrize("rel", sorted(TWIN_CALLS))
def test_interp_agrees_with_python_on_the_twins(rel):
    """Each plain twin the kernel contract evaluates gives, under the
    restricted interpreter, what Python gives calling it."""
    from jepsen_jgroups_raft_tpu_torch.lint.flow import interp

    it = interp.load(REPO / PORT / rel)
    mod = importlib.import_module(f"{PORT}.{rel[:-3].replace('/', '.')}")
    for fn, grid in TWIN_CALLS[rel]:
        node = it.functions[fn]
        names = [a.arg for a in node.args.args]
        for args in grid:
            got = it.exec_fn(node, dict(zip(names, args)))
            want = getattr(mod, fn)(*args)
            assert got is not interp.UNKNOWN, (fn, args)
            assert tuple(got) == tuple(want) if isinstance(want, tuple) \
                else got == want, (fn, args, got, want)
