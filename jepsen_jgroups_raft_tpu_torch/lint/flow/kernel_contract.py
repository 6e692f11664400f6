"""Kernel-contract analyzer: the Hopper kernels' limits, proven on the host.

The JAX package's analyzer of this name evaluated the BlockSpec, grid and
VMEM arithmetic around every ``pl.pallas_call``. The port has no Pallas
call: its kernels are CUDA C++ (``ops/csrc/``) launched through ctypes,
and what fails there at run time — or silently diverges — is different:

* a C++ cap restated from a Python constant drifts from it (the launcher
  refuses what the Python side plans, or the kernel's fixed arrays are
  sized for another cap);
* a block asks for more dynamic shared memory than the card grants (48 KB
  without an opt-in, 227 KB with one): the launch fails;
* a block has more threads than its ``__launch_bounds__`` (or than 1024):
  the launch fails, or ptxas budgeted registers for fewer threads.

So the Pallas rules (``kernel-block-divide``, ``-grid-cover``,
``-block-tile``, ``kernel-dtype``, ``kernel-vmem-budget``) have no
counterpart, and the contract is:

``kernel-cap-drift``
    A namespace-level ``constexpr … = N;  // NAME`` in ``ops/csrc/``
    whose trailing comment names a Python constant (``NAME`` or
    ``module.NAME``) must equal that constant as the port's modules
    define it (:data:`CAP_MODULES`).
``kernel-smem-budget``
    For each kernel that takes dynamic shared memory, the bytes its plain
    Python twin gives over the legal domain (:data:`PY_CONTRACTS`) stay
    at or under the H100's opt-in limit (227 KB = 232,448 B) when the
    CUDA source opts that kernel in above 48 KB
    (``cudaFuncSetAttribute(kernel,
    cudaFuncAttributeMaxDynamicSharedMemorySize, …)``), and at or under
    48 KB when it does not.
``kernel-threads``
    Every ``__launch_bounds__`` resolves to at most 1024 threads over its
    template domain (:data:`TEMPLATE_DOMAINS`); every launch's block
    size that is a compile-time expression stays within the launched
    kernel's bound; a block size computed at run time is covered by a
    row of :data:`RUNTIME_BLOCKS`, whose Python twin is proven within the
    bound over the legal domain.
``kernel-unresolved``
    The analyzer could not evaluate something it needed — a constant, a
    bound, a block size, a twin — a loud finding, never a silent pass.

Registers, spills and static shared memory exist only after ptxas, so
this host proof leaves them to the card: chip_smoke.py's
``lint_contract`` phase adds the static bytes ptxas reports to the
contract's largest dynamic bytes (:func:`contract_table`) and holds the
sum to the card's opt-in limit for a kernel that opts in and to 48 KB
for one that does not, registers × threads to the card's register file,
and the twins to the libraries' own shape queries.

Scan set (CLI): ``ops/csrc/*.cu``, ``ops/csrc/*.cuh`` and the Python
files of :data:`PY_CONTRACTS`.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from itertools import product
from pathlib import Path
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..base import PACKAGE, Finding, SourceFile, filter_allowed, pkg_rel
from . import interp as _interp
from .interp import UNKNOWN, Interp, Record

#: Shared memory a block may take on an H100 with the opt-in
#: (cudaFuncAttributeMaxDynamicSharedMemorySize): 227 KB.
SMEM_OPTIN_MAX = 232448
#: ... and without it (the default limit on dynamic shared memory).
SMEM_DEFAULT_MAX = 48 * 1024
#: Threads a block holds at most.
MAX_THREADS = 1024

RULE_DRIFT = "kernel-cap-drift"
RULE_SMEM = "kernel-smem-budget"
RULE_THREADS = "kernel-threads"
RULE_UNRESOLVED = "kernel-unresolved"

#: The modules a cap comment's NAME resolves in, in this order (the first
#: that binds NAME to an int defines it); ``module.NAME`` picks the
#: module of that stem.
CAP_MODULES = ("ops/kernel_ir.py", "ops/linear_scan.py",
               "ops/segment_scan.py", "ops/election_safety.py",
               "ops/cycle_closure.py", "ops/dense_scan.py",
               "ops/verdict_counts.py", "history/packing.py")

#: The values each kernel template parameter takes: the instances the
#: launchers pick (a bound or a block that depends on a parameter outside
#: this table is unresolved).
TEMPLATE_DOMAINS: Dict[str, Dict[str, Tuple[int, ...]]] = {
    # sort_scan_block<K, kCount>: K = W / 32 + 1 mask words, W ≤ 127
    "ops/csrc/sort_scan.cu": {"K": (1, 2, 3, 4), "kCount": (0, 1)},
    # closure_warp<NW> (N ≤ 128), closure_panels<MW> (MW 8 or 16),
    # close_diagonal / fold_tiles / run_tiled<TW> (T = 32·TW ≤ 256)
    "ops/csrc/cycle_closure.cu": {"NW": (1, 2, 3, 4), "MW": (8, 16),
                                  "TW": (1, 2, 4, 8)},
}

#: Launches whose block size is computed at run time: (CUDA source,
#: launched kernel, the block expression as written) → the Python file
#: whose contract proves the twin of that block size within the bound.
RUNTIME_BLOCKS: Dict[Tuple[str, str, str], str] = {
    ("ops/csrc/sort_scan.cu", "sort_scan_block", "threads"):
        "ops/linear_scan.py",
    ("ops/csrc/segment_scan.cu", "segment_scan_cta", "warps * 32"):
        "ops/segment_scan.py",
    ("ops/csrc/election_safety.cu", "election_shared", "shared_threads(N)"):
        "ops/election_safety.py",
    ("ops/csrc/cycle_closure.cu", "closure_panels", "32 * nw"):
        "ops/cycle_closure.py",
}

#: The block sizes the repo's callers hand the sort kernel: the default
#: (0) and chip_smoke.py's / the GPU tests' SORT_SHAPE_THREADS. The plan
#: store hands it none (`TunedPlan` carries no threads).
SORT_THREADS_DOMAIN = (0, 32, 64, 128, 256, 512, 1024)
#: The shared-memory caps they hand it: the default (0), and the small
#: caps that cut the tile (1 B, 8 KB).
SORT_CAP_DOMAIN = (0, 1, 8192)


# ------------------------------------------------------------ C++ reading


class Unresolved(Exception):
    """A C++ expression left the evaluable fragment."""


_TOKEN = re.compile(r"\s*(?:(0[xX][0-9a-fA-F]+|\d+)[uUlLzZ]*|"
                    r"([A-Za-z_][\w:]*)|(<<|>>|<=|>=|==|!=|&&|\|\||"
                    r"[-+*/%()<>!~&|^?:,]))")
_SIZEOF = {"int": 4, "unsigned": 4, "uint32_t": 4, "int32_t": 4,
           "uint64_t": 8, "int64_t": 8, "size_t": 8, "long long": 8,
           "unsigned long long": 8, "uint8_t": 1, "int8_t": 1,
           "uint16_t": 2, "int16_t": 2, "float": 4, "double": 8}


def _tokens(text: str) -> List[str]:
    out, pos, text = [], 0, text.strip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            raise Unresolved(f"cannot read {text[pos:]!r}")
        pos = m.end()
        if m.group(1) is not None:
            out.append(str(int(m.group(1), 0)))
        else:
            out.append(m.group(2) or m.group(3))
    return out


class _CParser:
    """Precedence climbing over C integer expressions: literals, names
    bound in `env` (ints, or expression text evaluated on demand),
    unary ``- + ! ~``, the binary operators, ``?:``, parentheses,
    ``static_cast<T>(x)`` and ``sizeof(T)`` of a basic type."""

    _LEVELS = (("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
               ("<", "<=", ">", ">="), ("<<", ">>"), ("+", "-"),
               ("*", "/", "%"))

    def __init__(self, text: str, lookup: Callable[[str], int]):
        self.toks = _tokens(text)
        self.i = 0
        self.lookup = lookup

    def parse(self) -> int:
        v = self._ternary()
        if self.i != len(self.toks):
            raise Unresolved(f"trailing {self.toks[self.i:]}")
        return v

    def _peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def _take(self, tok: Optional[str] = None) -> str:
        t = self._peek()
        if t is None or (tok is not None and t != tok):
            raise Unresolved(f"expected {tok!r}, got {t!r}")
        self.i += 1
        return t

    def _ternary(self) -> int:
        c = self._binary(0)
        if self._peek() == "?":
            self._take("?")
            a = self._ternary()
            self._take(":")
            b = self._ternary()
            return a if c else b
        return c

    def _binary(self, level: int) -> int:
        if level == len(self._LEVELS):
            return self._unary()
        v = self._binary(level + 1)
        while self._peek() in self._LEVELS[level]:
            op = self._take()
            w = self._binary(level + 1)
            v = _c_binop(op, v, w)
        return v

    def _unary(self) -> int:
        t = self._peek()
        if t in ("-", "+", "!", "~"):
            self._take()
            v = self._unary()
            return {"-": -v, "+": v, "!": int(not v), "~": ~v}[t]
        return self._primary()

    def _primary(self) -> int:
        t = self._take()
        if t == "(":
            v = self._ternary()
            self._take(")")
            return v
        if t.isdigit():
            return int(t)
        if t in ("static_cast", "std::static_cast"):
            self._take("<")
            while self._take() != ">":
                pass
            self._take("(")
            v = self._ternary()
            self._take(")")
            return v
        if t == "sizeof":
            self._take("(")
            words = []
            while self._peek() != ")":
                words.append(self._take())
            self._take(")")
            name = " ".join(w.replace("std::", "") for w in words)
            if name not in _SIZEOF:
                raise Unresolved(f"sizeof({name})")
            return _SIZEOF[name]
        if t in ("true", "false"):
            return int(t == "true")
        if self._peek() == "(":
            raise Unresolved(f"call of {t}()")
        return self.lookup(t)


def _c_binop(op: str, a: int, b: int) -> int:
    if op in ("/", "%"):
        if b == 0:
            raise Unresolved("division by zero")
        q = abs(a) // abs(b) * (1 if (a >= 0) == (b >= 0) else -1)
        return q if op == "/" else a - q * b
    return {"||": lambda: int(bool(a) or bool(b)),
            "&&": lambda: int(bool(a) and bool(b)),
            "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
            "==": lambda: int(a == b), "!=": lambda: int(a != b),
            "<": lambda: int(a < b), "<=": lambda: int(a <= b),
            ">": lambda: int(a > b), ">=": lambda: int(a >= b),
            "<<": lambda: a << b, ">>": lambda: a >> b,
            "+": lambda: a + b, "-": lambda: a - b,
            "*": lambda: a * b}[op]()


def c_eval(text: str, env: Dict[str, object]) -> int:
    """Evaluate C integer expression `text`; names resolve in `env` (ints,
    or the text of another constexpr, evaluated recursively). Raises
    :class:`Unresolved` outside the fragment."""
    busy: set = set()

    def lookup(name: str) -> int:
        short = name.split("::")[-1]
        if short not in env:
            raise Unresolved(f"`{short}` is not a known constant")
        val = env[short]
        if isinstance(val, int):
            return val
        if short in busy:
            raise Unresolved(f"`{short}` refers to itself")
        busy.add(short)
        try:
            return _CParser(str(val), lookup).parse()
        finally:
            busy.discard(short)

    return _CParser(text, lookup).parse()


_CONSTEXPR = re.compile(r"^\s*(?:static\s+)?constexpr\s+[\w:\s]*?"
                        r"\b(\w+)\s*=\s*([^;{}]+);")
_CAP_COMMENT = re.compile(r"^//\s*((?:[a-z_][a-z0-9_]*\.)?"
                          r"[A-Z][A-Z0-9]*(?:_[A-Z0-9]+)+)\b")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"')
_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                     r"\(((?:[^()]|\([^()]*\))*)\)\s*)?(\w+)\s*\(", re.S)
_TEMPLATE = re.compile(r"template\s*<([^<>]*)>\s*$", re.S)
_OPT_IN = re.compile(r"cudaFuncSetAttribute\s*\(\s*([\w:]+)\s*,\s*"
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize\b")
_LAUNCH = re.compile(r"([\w.]+)\s*(?:<([^<>;()]*)>)?\s*<<<(.*?)>>>", re.S)


def _split_top(text: str) -> List[str]:
    """`text` split at the commas outside parentheses and angle-free
    brackets."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur).strip())
    return out


def _params(decl: str) -> List[str]:
    """Template parameter names of `template <int TW, bool kCount>`."""
    out = []
    for part in _split_top(decl):
        words = part.replace("=", " = ").split()
        if "=" in words:
            words = words[:words.index("=")]
        if len(words) >= 2 and words[0] not in ("typename", "class"):
            out.append(words[-1])
    return out


def _strip(text: str) -> Tuple[str, List[str]]:
    """(code with comments and string literals blanked, keeping every
    offset and newline; each line's trailing ``//`` comment)."""
    code, comments = [], []
    i, n = 0, len(text)
    line_comment = ""
    while i < n:
        ch = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            line_comment = text[i:j]
            code.append(" " * (j - i))
            i = j
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            code.append("".join(c if c == "\n" else " "
                                for c in text[i:j]))
            comments.extend([""] * text[i:j].count("\n"))
            i = j
            continue
        if ch == '"' or ch == "'":
            j = i + 1
            while j < n and text[j] != ch and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            code.append(ch + " " * (min(j, n) - i - 1) +
                        (ch if j < n and text[j] == ch else ""))
            i = min(j + 1, n) if j < n and text[j] == ch else j
            continue
        if ch == "\n":
            comments.append(line_comment)
            line_comment = ""
        code.append(ch)
        i += 1
    comments.append(line_comment)
    return "".join(code), comments


@dataclass
class Kernel:
    name: str
    line: int
    params: List[str]
    bound: Optional[str]          # the first __launch_bounds__ argument


@dataclass
class Launch:
    line: int
    name: str                     # as written (a kernel or a pointer)
    targs: List[str]              # template arguments at the launch
    block: str                    # the block expression as written
    params: List[str]             # template parameters around the launch
    local: Dict[str, str]         # constexprs of the enclosing function


@dataclass
class CudaSource:
    """One CUDA file, read as text: its namespace-level constexprs (with
    its includes' in the same directory), kernels and launches."""

    path: str
    consts: Dict[str, str] = field(default_factory=dict)
    own_consts: Dict[str, Tuple[int, str, str]] = field(default_factory=dict)
    kernels: Dict[str, Kernel] = field(default_factory=dict)
    launches: List[Launch] = field(default_factory=list)
    #: the kernels the source opts in above 48 KB of dynamic shared
    #: memory (cudaFuncSetAttribute on the kernel, or on a pointer in a
    #: source of one kernel)
    opted: Set[str] = field(default_factory=set)
    #: (line, name) of each opt-in on a name that is neither a kernel
    #: nor a pointer in a source of one kernel
    opt_unresolved: List[Tuple[int, str]] = field(default_factory=list)

    @classmethod
    def parse(cls, path: str, text: str, base: Optional[Path] = None,
              _seen=None) -> "CudaSource":
        src = cls(path)
        code, comments = _strip(text)
        seen = set() if _seen is None else _seen
        for raw in text.splitlines():
            m = _INCLUDE.match(raw)
            if m and base is not None:
                inc = base / m.group(1)
                if inc.exists() and inc not in seen:
                    seen.add(inc)
                    sub = cls.parse(str(inc), inc.read_text(
                        encoding="utf-8", errors="replace"), base, seen)
                    src.consts.update(sub.consts)
        src._walk(code, comments)
        for m in _KERNEL.finditer(code):
            head = code[:m.start()]
            t = _TEMPLATE.search(head[-200:])
            src.kernels[m.group(2)] = Kernel(
                m.group(2), code.count("\n", 0, m.start(2)) + 1,
                _params(t.group(1)) if t else [],
                _split_top(m.group(1))[0] if m.group(1) else None)
        for m in _OPT_IN.finditer(code):
            name = m.group(1)
            if name in src.kernels:
                src.opted.add(name)
            elif len(src.kernels) == 1:
                src.opted.update(src.kernels)
            else:
                src.opt_unresolved.append(
                    (code.count("\n", 0, m.start()) + 1, name))
        return src

    def _walk(self, code: str, comments: List[str]) -> None:
        """Namespace-level constexprs, and each top-level block's local
        constexprs, template parameters and launches."""
        stack: List[str] = []          # "ns" or "blk" per open brace
        stmt_start = 0                 # offset of the current statement
        block_start, block_decl = None, ""
        lines = code.split("\n")
        offsets = [0]
        for ln in lines:
            offsets.append(offsets[-1] + len(ln) + 1)
        line_of = lambda off: _bisect(offsets, off)  # noqa: E731
        blocks: List[Tuple[int, int, str]] = []     # (start, end, decl)
        for i, ch in enumerate(code):
            if ch == "{":
                decl = code[stmt_start:i]
                depth = stack.count("blk")
                if re.search(r"\bnamespace\b[\w\s]*$", decl) or \
                        re.search(r'extern\s+"[^"]*"\s*$', decl):
                    stack.append("ns")
                else:
                    stack.append("blk")
                    if depth == 0:
                        block_start, block_decl = i, decl
                stmt_start = i + 1
            elif ch == "}":
                kind = stack.pop() if stack else "ns"
                if kind == "blk" and stack.count("blk") == 0 and \
                        block_start is not None:
                    blocks.append((block_start, i, block_decl))
                    block_start = None
                stmt_start = i + 1
            elif ch == ";":
                if stack.count("blk") == 0:
                    m = _CONSTEXPR.match(code[stmt_start:i + 1])
                    if m:
                        line = line_of(stmt_start +
                                       code[stmt_start:i + 1].index(
                                           m.group(1)))
                        self.consts[m.group(1)] = m.group(2).strip()
                        self.own_consts[m.group(1)] = (
                            line, m.group(2).strip(),
                            comments[line - 1].strip()
                            if line - 1 < len(comments) else "")
                stmt_start = i + 1
        for start, end, decl in blocks:
            body = code[start:end]
            t = _decl_template(decl)
            local = {m.group(1): m.group(2).strip()
                     for m in re.finditer(
                         r"\bconstexpr\s+[\w:\s]*?\b(\w+)\s*=\s*([^;{}]+);",
                         body)}
            for m in _LAUNCH.finditer(body):
                args = _split_top(m.group(3))
                self.launches.append(Launch(
                    line_of(start + m.start()), m.group(1).split(".")[-1],
                    _split_top(m.group(2)) if m.group(2) else [],
                    " ".join(args[1].split()) if len(args) > 1 else "",
                    t, local))

    def kernel_for(self, launch: Launch) -> Optional[Kernel]:
        if launch.name in self.kernels:
            return self.kernels[launch.name]
        if len(self.kernels) == 1:   # a pointer to the file's one kernel
            return next(iter(self.kernels.values()))
        return None


def _decl_template(decl: str) -> List[str]:
    """Template parameters of the function whose declaration `decl`
    (the text before its body's brace) starts with ``template <...>``."""
    m = re.search(r"template\s*<([^<>]*)>", decl)
    return _params(m.group(1)) if m else []


def _bisect(offsets: List[int], off: int) -> int:
    lo, hi = 0, len(offsets) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if offsets[mid] <= off:
            lo = mid
        else:
            hi = mid - 1
    return lo + 1


def _names_in(text: str) -> set:
    return set(re.findall(r"[A-Za-z_]\w*", text))


def _bindings(params: List[str], used: set, domains: dict):
    """Every binding of the template parameters in `params` that `used`
    mentions, over `domains`; None when one has no domain."""
    need = [p for p in params if p in used]
    if any(p not in domains for p in need):
        return None
    return [dict(zip(need, combo))
            for combo in product(*(domains[p] for p in need))]


def kernel_bound(src: CudaSource, kernel: Kernel, binding: dict) -> int:
    """The threads `kernel` may launch with at `binding` of its template
    parameters: its ``__launch_bounds__``, or MAX_THREADS without one."""
    if kernel.bound is None:
        return MAX_THREADS
    env = {**src.consts, **binding}
    return c_eval(kernel.bound, env)


def bound_range(src: CudaSource, kernel: Kernel, domains: dict
                ) -> List[Tuple[dict, int]]:
    """[(binding, bound)] of `kernel` over its template domain."""
    if kernel.bound is None:
        return [({}, MAX_THREADS)]
    b = _bindings(kernel.params, _names_in(kernel.bound), domains)
    if b is None:
        raise Unresolved(f"`__launch_bounds__({kernel.bound})` of "
                         f"{kernel.name} depends on a template parameter "
                         "outside TEMPLATE_DOMAINS")
    return [(x, kernel_bound(src, kernel, x)) for x in b]


# ------------------------------------------------------------- the package


def package_root(path) -> Path:
    """The port package `path` lies in, or (for a fixture outside it) the
    package this lint belongs to."""
    p = Path(path).resolve()
    for parent in p.parents:
        if parent.name == PACKAGE:
            return parent
    return Path(__file__).resolve().parents[2]


_PY_CACHE: Dict[Tuple[str, float], Interp] = {}


def module_interp(root: Path, rel: str) -> Optional[Interp]:
    """A restricted interpreter over the package module `rel` (its
    relative imports bound), or None when it is missing."""
    p = root / rel
    if not p.exists():
        return None
    key = (str(p), p.stat().st_mtime)
    if key not in _PY_CACHE:
        try:
            _PY_CACHE[key] = _interp.load(p)
        except SyntaxError:
            return None
    return _PY_CACHE[key]


def python_constant(root: Path, name: str) -> Optional[int]:
    """The int the port's modules bind `name` (``NAME`` or
    ``module.NAME``) to, by :data:`CAP_MODULES`; None when none does."""
    mod, _, const = name.rpartition(".")
    for rel in CAP_MODULES:
        if mod and Path(rel).stem != mod:
            continue
        it = module_interp(root, rel)
        if it is None:
            continue
        val = it.module_env.get(const)
        if isinstance(val, int) and not isinstance(val, bool):
            return val
    return None


def smem_limit(cu: CudaSource, kernel: str) -> int:
    """The shared bytes a block of `cu`'s `kernel` may take: the opt-in
    limit when the source opts it in, else 48 KB."""
    return SMEM_OPTIN_MAX if kernel in cu.opted else SMEM_DEFAULT_MAX


def cuda_source(root: Path, rel: str) -> Optional[CudaSource]:
    p = root / rel
    if not p.exists():
        return None
    return CudaSource.parse(rel, p.read_text(encoding="utf-8",
                                             errors="replace"), p.parent)


# ----------------------------------------------------------- CUDA analysis


def _analyze_cuda(src: SourceFile, root: Path) -> List[Finding]:
    rel = pkg_rel(src.path)
    cu = CudaSource.parse(src.path, src.text, root / "ops" / "csrc")
    domains = TEMPLATE_DOMAINS.get(rel, {})
    out: List[Finding] = []

    def unresolved(line: int, what: str) -> None:
        out.append(Finding(src.path, line, RULE_UNRESOLVED,
                           f"cannot statically evaluate {what} — extend "
                           "the contract in lint/flow/kernel_contract.py "
                           "or simplify the expression"))

    for line, name in cu.opt_unresolved:
        unresolved(line, f"the kernel that cudaFuncSetAttribute opts in "
                         f"through {name}")

    # kernel-cap-drift: a constexpr whose comment names a Python constant
    for name, (line, expr, comment) in sorted(cu.own_consts.items(),
                                              key=lambda x: x[1][0]):
        m = _CAP_COMMENT.match(comment)
        if not m:
            continue
        py_name = m.group(1)
        want = python_constant(root, py_name)
        if want is None:
            unresolved(line, f"{py_name} (named by {name}'s comment): no "
                             "module of the port binds it to an int")
            continue
        try:
            got = c_eval(expr, cu.consts)
        except Unresolved as e:
            unresolved(line, f"{name} = {expr} ({e})")
            continue
        if got != want:
            out.append(Finding(
                src.path, line, RULE_DRIFT,
                f"{name} = {got} but its comment names {py_name}, which "
                f"the port defines as {want} — the C++ cap restates the "
                "Python one and must move with it"))

    # kernel-threads: every launch bound within the card's 1024
    for k in cu.kernels.values():
        try:
            for binding, n in bound_range(cu, k, domains):
                if not 1 <= n <= MAX_THREADS:
                    out.append(Finding(
                        src.path, k.line, RULE_THREADS,
                        f"__launch_bounds__ of {k.name} is {n} threads at "
                        f"{binding or 'every instance'}; a block holds 1 "
                        f"to {MAX_THREADS}"))
                    break
        except Unresolved as e:
            unresolved(k.line, f"the launch bound of {k.name} ({e})")

    # kernel-threads: every launch's block within its kernel's bound
    for ln in cu.launches:
        k = cu.kernel_for(ln)
        if k is None:
            unresolved(ln.line, f"the kernel launched as `{ln.name}` (not "
                                "a __global__ of this file)")
            continue
        env_base = {**cu.consts, **ln.local}
        in_bound = _names_in(k.bound or "")
        targs = {p: a for p, a in zip(k.params, ln.targs) if p in in_bound}
        used = _names_in(ln.block) | {
            x for a in targs.values() for x in _names_in(a)} | \
            _names_in(" ".join(ln.local.values()))
        binds = _bindings(ln.params, used, domains)
        try:
            if binds is None:
                raise Unresolved("a template parameter outside "
                                 "TEMPLATE_DOMAINS")
            for b in binds:
                env = {**env_base, **b}
                block = c_eval(ln.block, env)
                kb = {p: c_eval(a, env) for p, a in targs.items()}
                bound = kernel_bound(cu, k, kb)
                if not 1 <= block <= bound:
                    out.append(Finding(
                        src.path, ln.line, RULE_THREADS,
                        f"launch of {k.name} with blocks of {block} threads "
                        f"at {b or 'every instance'}; its bound is {bound}"))
                    break
        except Unresolved:
            key = (rel, k.name, ln.block)
            if key not in RUNTIME_BLOCKS:
                unresolved(ln.line, f"the block size `{ln.block}` of the "
                                    f"launch of {k.name}, computed at run "
                                    "time, which no RUNTIME_BLOCKS row "
                                    "covers")
    return out


# --------------------------------------------------------- Python twins


@dataclass
class Ctx:
    """What a Python contract reads: the file's own interpreter and the
    package root (for the CUDA sources and sibling modules)."""

    path: str
    interp: Interp
    root: Path
    findings: List[Finding] = field(default_factory=list)
    #: per CUDA kernel: the most threads and dynamic bytes proven
    facts: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def line_of(self, fn: str) -> int:
        node = self.interp.functions.get(fn)
        return node.lineno if node is not None else 1

    def report(self, rule: str, fn: str, msg: str) -> None:
        self.findings.append(Finding(self.path, self.line_of(fn), rule,
                                     msg))

    def const(self, name: str) -> Optional[int]:
        v = self.interp.module_env.get(name)
        return v if isinstance(v, int) and not isinstance(v, bool) \
            else None

    def consts(self, fn: str, *names: str) -> Optional[List[int]]:
        vals = [self.const(n) for n in names]
        missing = [n for n, v in zip(names, vals) if v is None]
        if missing:
            self.report(RULE_UNRESOLVED, fn,
                        f"{', '.join(missing)} not resolvable from "
                        f"{pkg_rel(self.path)}'s module constants")
            return None
        return vals

    def call(self, fn: str, *args):
        node = self.interp.functions.get(fn)
        if node is None:
            return UNKNOWN
        return self.interp.exec_fn(node, dict(zip(
            [a.arg for a in node.args.args], args)))

    def need(self, *fns: str) -> bool:
        missing = [f for f in fns if f not in self.interp.functions]
        for f in missing:
            self.findings.append(Finding(
                self.path, 1, RULE_UNRESOLVED,
                f"{f}() not found in {pkg_rel(self.path)} — the kernel "
                "contract evaluates it; update lint/flow/"
                "kernel_contract.py with it"))
        return not missing

    def cuda(self, rel: str) -> Optional[CudaSource]:
        return cuda_source(self.root, rel)

    def fact(self, kernel: str, key: str, value: int) -> None:
        d = self.facts.setdefault(kernel, {})
        d[key] = max(d.get(key, 0), value)


def _bound_of(ctx: Ctx, cu: Optional[CudaSource], kernel: str, fn: str,
              binding: dict) -> Optional[int]:
    if cu is None or kernel not in cu.kernels:
        ctx.report(RULE_UNRESOLVED, fn, f"kernel {kernel} not found in its "
                                        "CUDA source")
        return None
    try:
        return kernel_bound(cu, cu.kernels[kernel], binding)
    except Unresolved as e:
        ctx.report(RULE_UNRESOLVED, fn, f"the launch bound of {kernel} "
                                        f"({e})")
        return None


def _is_ints(v, n: int) -> bool:
    return isinstance(v, tuple) and len(v) == n and \
        all(isinstance(x, int) for x in v)


def _sort_contract(ctx: Ctx) -> None:
    """B5: `sort_shape_plain` over every W ≤ SORT_MAX_SLOTS at each C of
    the ladder and MAX_CONFIGS (default threads and cap), and at each K
    boundary over SORT_THREADS_DOMAIN × SORT_CAP_DOMAIN: a shape the
    launcher takes (whole warps within the bound of K, tile ≤ 8 a
    thread, a table of twice a round's entries, log2 ≤ 20), and dynamic
    shared memory within the budget."""
    fn = "sort_shape_plain"
    if not ctx.need(fn):
        return
    caps = ctx.consts(fn, "MAX_SLOTS", "MAX_CONFIGS", "DEFAULT_N_CONFIGS")
    if caps is None:
        return
    w_max, c_max, c_default = caps
    lin = module_interp(ctx.root, "checker/linearizable.py")
    ladder = lin.module_env.get("SORT_LADDER") if lin else None
    if not (isinstance(ladder, tuple) and
            all(isinstance(c, int) for c in ladder)):
        ctx.report(RULE_UNRESOLVED, fn, "checker/linearizable.py's "
                                        "SORT_LADDER not resolvable")
        return
    cu = ctx.cuda("ops/csrc/sort_scan.cu")
    bounds = {}
    for K in range(1, w_max // 32 + 2):
        b = _bound_of(ctx, cu, "sort_scan_block", fn, {"K": K})
        if b is None:
            return
        bounds[K] = b
    cs = sorted(set(ladder) | {c_max, c_default, 1})
    edges = sorted({w for k in range(0, w_max + 1, 32)
                    for w in (k - 1, k) if 1 <= w <= w_max} | {1, w_max})
    points = [(W, C, 0, 0) for C in cs for W in range(1, w_max + 1)] + \
        [(W, C, t, cap) for W in edges for C in cs
         for t in SORT_THREADS_DOMAIN for cap in SORT_CAP_DOMAIN]
    limit = smem_limit(cu, "sort_scan_block")
    seen = set()
    for W, C, t, cap in points:
        shape = ctx.call(fn, W, C, t, cap)
        if not _is_ints(shape, 4):
            ctx.report(RULE_UNRESOLVED, fn, f"{fn}({W}, {C}, {t}, {cap}) "
                                            "not evaluable")
            return
        threads, tile, tlog, smem = shape
        K = W // 32 + 1
        ctx.fact("sort_scan_block", "threads", threads)
        ctx.fact("sort_scan_block", "dynamic_bytes", smem)
        at = f"at (W={W}, C={C}, threads={t or 'default'}, " \
             f"smem_cap={cap or 'default'})"
        if "threads" not in seen and not (
                threads % 32 == 0 and 32 <= threads <= bounds[K]):
            seen.add("threads")
            ctx.report(RULE_THREADS, fn,
                       f"{threads} threads {at}: the kernel takes whole "
                       f"warps up to its bound at K={K}, {bounds[K]}")
        if "shape" not in seen and not (
                1 <= tile <= 8 * threads and 1 <= tlog <= 20 and
                (1 << tlog) >= 2 * (C + tile)):
            seen.add("shape")
            ctx.report(RULE_THREADS, fn,
                       f"tile {tile}, table 2^{tlog} {at}: the launcher "
                       "refuses it (tile ≤ 8 a thread, a table of at "
                       "least twice C + tile slots, log2 ≤ 20)")
        if "smem" not in seen and smem > limit:
            seen.add("smem")
            ctx.report(RULE_SMEM, fn,
                       f"{smem} B of dynamic shared memory {at} exceed the "
                       f"{limit} B a block may take")


def _segment_contract(ctx: Ctx) -> None:
    """B6: `segment_smem_bytes` at every (W, field width) the dense caps
    admit, with SEGMENT_MAX_TILE_ROWS rows and every warp count up to
    SEGMENT_MAX_WARPS, within the budget; `segment_shape_at`'s warps
    within SEGMENT_MAX_WARPS and the kernel's bound."""
    fn = "segment_smem_bytes"
    if not ctx.need(fn, "segment_shape_at"):
        return
    caps = ctx.consts(fn, "DENSE_MAX_SLOTS", "DENSE_MAX_STATES",
                      "DENSE_MAX_CELLS", "SEGMENT_MAX_TILE_ROWS",
                      "SEGMENT_MAX_WARPS")
    if caps is None:
        return
    w_max, s_max, cells, tile_max, warps_max = caps
    cu = ctx.cuda("ops/csrc/segment_scan.cu")
    bound = _bound_of(ctx, cu, "segment_scan_cta", "segment_shape_at", {})
    if bound is None:
        return
    limit = smem_limit(cu, "segment_scan_cta")
    lf_max = (s_max - 1).bit_length()
    reported = set()
    for W in range(1, w_max + 1):
        for lf in range(0, lf_max + 1):
            s_min = 1 if lf == 0 else (1 << (lf - 1)) + 1
            if (1 << W) * s_min > cells:
                continue
            for warps in range(1, warps_max + 1):
                n = ctx.call(fn, W, lf, warps, tile_max)
                if not isinstance(n, int):
                    ctx.report(RULE_UNRESOLVED, fn, f"{fn}({W}, {lf}, "
                                                    f"{warps}, {tile_max}) "
                                                    "not evaluable")
                    return
                ctx.fact("segment_scan_cta", "dynamic_bytes", n)
                if n > limit and RULE_SMEM not in reported:
                    reported.add(RULE_SMEM)
                    ctx.report(RULE_SMEM, fn,
                               f"{n} B of dynamic shared memory at (W={W}, "
                               f"field_log2={lf}, warps={warps}, tile="
                               f"{tile_max}) exceed the {limit} B a block "
                               "may take")
            for nb in (1, 2, 31, 32, 33, 256, 4096, 1 << 20):
                shape = ctx.call("segment_shape_at", W, lf, nb)
                if not _is_ints(shape, 3):
                    ctx.report(RULE_UNRESOLVED, "segment_shape_at",
                               f"segment_shape_at({W}, {lf}, {nb}) not "
                               "evaluable")
                    return
                warps = shape[1]
                ctx.fact("segment_scan_cta", "threads", warps * 32)
                if not (1 <= warps <= warps_max and warps * 32 <= bound) \
                        and RULE_THREADS not in reported:
                    reported.add(RULE_THREADS)
                    ctx.report(RULE_THREADS, "segment_shape_at",
                               f"{warps} warps at (W={W}, field_log2={lf}, "
                               f"NB={nb}): the launcher takes 1 to "
                               f"{warps_max}, the kernel's bound "
                               f"{bound} threads")


def _election_contract(ctx: Ctx) -> None:
    """B9: the shared form's table, 2^SHARED_MAX_LOG2 64-bit slots, within
    the budget; `election_threads` within the shared kernel's bound for
    every row length the shared form takes."""
    fn = "election_threads"
    if not ctx.need(fn):
        return
    caps = ctx.consts(fn, "SHARED_MAX_LOG2", "SHARED_MAX_OBSERVATIONS")
    if caps is None:
        return
    log2, n_max = caps
    cu = ctx.cuda("ops/csrc/election_safety.cu")
    bound = _bound_of(ctx, cu, "election_shared", fn, {})
    if bound is None:
        return
    table = 8 << log2
    ctx.fact("election_shared", "dynamic_bytes", table)
    limit = smem_limit(cu, "election_shared")
    if table > limit:
        ctx.report(RULE_SMEM, fn, f"the shared form's table, {table} B at "
                                  f"SHARED_MAX_LOG2 = {log2}, exceeds the "
                                  f"{limit} B a block may take")
    ns = sorted({1, 2, 31, 32, 33, 511, 512, 513, n_max} |
                {1 << k for k in range(n_max.bit_length())})
    for n in ns:
        if n > n_max:
            continue
        t = ctx.call(fn, n)
        if not isinstance(t, int):
            ctx.report(RULE_UNRESOLVED, fn, f"{fn}({n}) not evaluable")
            return
        ctx.fact("election_shared", "threads", t)
        if not (t % 32 == 0 and 32 <= t <= bound):
            ctx.report(RULE_THREADS, fn, f"{t} threads for rows of {n}: "
                                         "the shared kernel takes whole "
                                         f"warps up to its bound, {bound}")
            return


def _closure_contract(ctx: Ctx) -> None:
    """B7/B8: the panel form's dynamic shared memory at every N up to
    CYCLE_MAX_NODES within what a block takes (the source opts in to
    none: 48 KB); the static staging of the warp form and of B8 at every
    kernel tile up to CYCLE_MAX_NODES_TILED within 48 KB; `closure_shape`'s
    blocks within 1024 threads."""
    fns = ("closure_smem_bytes", "closure_static_smem_bytes",
           "closure_shape")
    if not ctx.need(*fns):
        return
    caps = ctx.consts(fns[0], "CYCLE_MAX_NODES", "CYCLE_MAX_NODES_TILED",
                      "CYCLE_TILE", "WARP_MAX_NODES")
    tiles = ctx.interp.module_env.get("KERNEL_TILES")
    if caps is None:
        return
    if not (isinstance(tiles, tuple) and all(isinstance(t, int)
                                             for t in tiles)):
        ctx.report(RULE_UNRESOLVED, fns[1], "KERNEL_TILES not resolvable")
        return
    n_mono, n_tiled, tile_default, n_warp = caps
    cu = ctx.cuda("ops/csrc/cycle_closure.cu")
    if cu is None:
        ctx.report(RULE_UNRESOLVED, fns[0], "ops/csrc/cycle_closure.cu "
                                            "not found")
        return
    limit = smem_limit(cu, "closure_panels")
    for n in range(1, n_mono + 1):
        dyn = ctx.call(fns[0], n)
        stat = ctx.call(fns[1], n, None)
        shape = ctx.call(fns[2], n, None)
        if not (isinstance(dyn, int) and isinstance(stat, int) and
                isinstance(shape, Record) and len(shape) == 2):
            ctx.report(RULE_UNRESOLVED, fns[0], f"the closure's shape or "
                                                f"bytes at N={n} not "
                                                "evaluable")
            return
        kernel = "closure_warp" if n <= n_warp else "closure_panels"
        ctx.fact(kernel, "dynamic_bytes", dyn)
        ctx.fact(kernel, "threads", 32 * shape[1])
        if dyn > limit:
            ctx.report(RULE_SMEM, fns[0], f"{dyn} B of dynamic shared "
                                          f"memory at N={n} exceed the "
                                          f"{limit} B a block may take")
            return
        if stat > SMEM_DEFAULT_MAX or shape[1] * 32 > MAX_THREADS:
            ctx.report(RULE_SMEM if stat > SMEM_DEFAULT_MAX else
                       RULE_THREADS, fns[1],
                       f"at N={n}: {stat} B of static shared memory "
                       f"(at most {SMEM_DEFAULT_MAX}), {shape[1] * 32} "
                       f"threads (at most {MAX_THREADS})")
            return
    for n in sorted({n_mono + 1, 768, 1024, n_tiled}):
        for tile in sorted(set(tiles) | {tile_default}):
            stat = ctx.call(fns[1], n, tile)
            shape = ctx.call(fns[2], n, tile)
            if not (isinstance(stat, int) and isinstance(shape, Record)):
                ctx.report(RULE_UNRESOLVED, fns[1], f"the closure at "
                                                    f"N={n}, tile={tile} "
                                                    "not evaluable")
                return
            if stat > SMEM_DEFAULT_MAX or shape[1] * 32 > MAX_THREADS:
                ctx.report(RULE_SMEM if stat > SMEM_DEFAULT_MAX else
                           RULE_THREADS, fns[1],
                           f"B8 at N={n}, tile={tile}: {stat} B of static "
                           f"shared memory (at most {SMEM_DEFAULT_MAX}), "
                           f"{shape[1] * 32} threads (at most "
                           f"{MAX_THREADS})")
                return


#: The Python twins' contracts, by the file that defines the twins.
PY_CONTRACTS: Dict[str, Callable[[Ctx], None]] = {
    "ops/linear_scan.py": _sort_contract,
    "ops/segment_scan.py": _segment_contract,
    "ops/election_safety.py": _election_contract,
    "ops/cycle_closure.py": _closure_contract,
}


@dataclass(frozen=True)
class KernelRow:
    """One kernel of PERF.md's table: its label, CUDA source, the
    libraries built from it, and the Python file of its twins (None: no
    dynamic shared memory, no block computed at run time)."""

    label: str
    source: str
    libraries: Tuple[str, ...]
    twins: Optional[str]


KERNEL_ROWS = (
    KernelRow("B1", "ops/csrc/dense_scan.cu",
              ("dense_scan", "dense_scan_count"), None),
    KernelRow("B4", "ops/csrc/mask_scan.cu",
              ("mask_scan", "mask_scan_count", "mask_scan_profile"), None),
    KernelRow("B5", "ops/csrc/sort_scan.cu", ("sort_scan",),
              "ops/linear_scan.py"),
    KernelRow("B6", "ops/csrc/segment_scan.cu",
              ("segment_scan", "segment_scan_profile"),
              "ops/segment_scan.py"),
    KernelRow("B7/B8", "ops/csrc/cycle_closure.cu", ("cycle_closure",),
              "ops/cycle_closure.py"),
    KernelRow("B9", "ops/csrc/election_safety.cu", ("election_safety",),
              "ops/election_safety.py"),
    KernelRow("B10", "ops/csrc/verdict_counts.cu", ("verdict_counts",),
              None),
)


def _py_ctx(path: str, text: Optional[str], root: Path) -> Optional[Ctx]:
    """The contract context of the Python source at `path` (its `text`
    when given). Its relative imports resolve from `path` when that lies
    in the package, else from the package file of the same key (a
    mutated copy of a twin file reads the real siblings)."""
    p = Path(path)
    anchor = p if p.is_absolute() and PACKAGE in p.parts else \
        root / pkg_rel(path)
    try:
        it = _interp.load(anchor, text)
    except (SyntaxError, OSError):
        return None
    return Ctx(path, it, root)


def contract_table(root=None) -> List[dict]:
    """Per kernel row: the libraries built from its source, and per
    __global__ function the most threads a block of it may hold (its
    launch bound, or — without one — the most its launches take), the
    most dynamic shared memory the contract proves it takes, and whether
    it opts in above 48 KB (what it may take in all). What
    chip_smoke.py's ``lint_contract`` phase adds ptxas's static bytes and
    registers to."""
    root = Path(root) if root is not None else \
        Path(__file__).resolve().parents[2]
    rows = []
    for row in KERNEL_ROWS:
        cu = cuda_source(root, row.source)
        if cu is None or cu.opt_unresolved:
            raise Unresolved(f"{row.source}: not readable, or an opt-in "
                             f"on no kernel: {cu and cu.opt_unresolved}")
        facts: Dict[str, Dict[str, int]] = {}
        if row.twins is not None:
            ctx = _py_ctx(str(root / row.twins), None, root)
            if ctx is None:
                raise Unresolved(f"{row.twins} not readable")
            PY_CONTRACTS[row.twins](ctx)
            if ctx.findings:
                raise Unresolved("; ".join(f.render()
                                           for f in ctx.findings))
            facts = ctx.facts
        domains = TEMPLATE_DOMAINS.get(row.source, {})
        kernels = {}
        for k in cu.kernels.values():
            threads = max(n for _, n in bound_range(cu, k, domains)) \
                if k.bound is not None else 0
            if k.bound is None:
                for ln in cu.launches:
                    if cu.kernel_for(ln) is not k:
                        continue
                    binds = _bindings(ln.params, _names_in(ln.block),
                                      domains) or [{}]
                    for b in binds:
                        try:
                            threads = max(threads, c_eval(
                                ln.block, {**cu.consts, **ln.local, **b}))
                        except Unresolved:
                            threads = max(threads, facts.get(
                                k.name, {}).get("threads", 0))
            kernels[k.name] = {
                "threads": threads,
                "dynamic_bytes": facts.get(k.name, {}).get(
                    "dynamic_bytes", 0),
                "opts_in": k.name in cu.opted,
                "smem_limit": smem_limit(cu, k.name)}
        rows.append({"kernel": row.label, "source": row.source,
                     "libraries": list(row.libraries), "functions": kernels})
    return rows


# ------------------------------------------------------------- interface


def applies_to(relpath: str) -> bool:
    rp = pkg_rel(relpath)
    return rp in PY_CONTRACTS or (rp.startswith("ops/csrc/") and
                                  rp.endswith((".cu", ".cuh")))


def analyze_source(src: SourceFile) -> List[Finding]:
    root = package_root(src.path)
    rel = pkg_rel(src.path)
    if src.path.endswith((".cu", ".cuh")):
        return filter_allowed(src, _analyze_cuda(src, root))
    key = next((k for k in PY_CONTRACTS if rel.endswith(k)), None)
    if key is None:
        return []
    try:
        ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    ctx = _py_ctx(src.path, src.text, root)
    if ctx is None:
        return [Finding(src.path, 1, RULE_UNRESOLVED,
                        f"{key} not readable by the kernel contract")]
    PY_CONTRACTS[key](ctx)
    return filter_allowed(src, ctx.findings)


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
