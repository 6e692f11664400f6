"""Host-sync analyzer for the port's hot path (analyzer ``sync``).

The JAX package's analyzer of this name looked inside jitted and Pallas
bodies for host syncs, Python branches on tracers and recompile hazards.
The port has no traced bodies: every torch op is issued eagerly from the
host, and the card runs them asynchronously on a stream. What costs a
round trip here is any call that makes the host wait for the card — the
stream drains, the launch pipeline empties, and on a host-bound path
(PERF.md §5) every such hop is a stall of the whole batch. The jax-only
rules (``jit-host-sync``, ``jit-python-branch``, ``jit-recompile-hazard``)
have no counterpart; ``host-sync`` keeps its id, so
``# lint: allow(host-sync)`` reads the same in both packages.

Rule ``host-sync`` fires on

* ``.item()`` and ``.cpu()`` on a value that may be a card tensor, and
  ``.tolist()`` and ``.numpy()`` on a card tensor;
* ``torch.cuda.synchronize(...)`` and any ``<event or
  stream>.synchronize()``;
* a blocking host→card copy: ``.to(<device>)`` or ``.cuda()`` of host
  memory without ``non_blocking=True``, and ``torch.tensor`` /
  ``torch.as_tensor`` of host data with a ``device=`` (each copy waits
  for the card's stream to drain first);
* ``int()`` / ``float()`` / ``bool()`` of a value derived from a card
  tensor, and the implicit ``bool()`` of an ``if`` / ``while`` /
  ``assert`` test, a ternary's test, or a ``not`` / ``and`` / ``or``
  operand derived from one.

Values are classed per function (flow-insensitively, over its own
assignments and those of the functions around it):

* *card* — may live on the card: the result of a torch op that is not a
  host constructor, of ``.to(<device>)`` and ``.cuda()``, a method,
  subscript or arithmetic of a card value, and a parameter annotated
  ``torch.Tensor``;
* *host* — certainly host memory: ``torch.from_numpy(...)``, a torch
  factory (``tensor``, ``as_tensor``, ``zeros``, ...) with no device or
  the CPU one, ``.cpu()``, ``.numpy()`` and numpy results;
* anything else is unknown.

``.shape``, ``.dtype``, ``.device``, ``.ndim`` (and ``.numel()``,
``.dim()``, ``.size()``, ...) are host metadata and break the chain.
``.item()`` and ``.cpu()`` fire unless their receiver is host memory
(unknown receivers fire: a kernel wrapper's result is a card tensor the
analyzer cannot see through); ``.tolist()`` (which numpy arrays share)
and ``.numpy()`` (which raises on a card tensor) fire, as
``int``/``float``/``bool`` do, only on card values.
Each fire is an intended hop or a fix: the pragma
``# lint: allow(host-sync)``, with its reason on the line, records why
the hop is intended (for example "the per-launch flag read; the
wavefront decides on it").

Scan set (CLI): ``ops/``, ``checker/``, ``parallel/``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from .base import Finding, SourceFile, pkg_rel
from .flow.taint import dotted

RULE = "host-sync"

SCAN_PREFIXES = ("ops/", "checker/", "parallel/")

CARD = "card"
HOST = "host"
NUMPY = "numpy"

#: methods that copy a card tensor to the host and wait for it
SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
#: ... of those, the ones that fire on card values only (numpy arrays
#: share `.tolist()`; `.numpy()` raises on a card tensor)
CARD_ONLY_METHODS = ("tolist", "numpy")
#: Python casts that read a tensor's value on the host
HOST_CASTS = ("int", "float", "bool")
#: attributes and methods that read host metadata only
TAINT_BREAKERS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                  "nbytes", "itemsize", "names", "requires_grad"}
BREAKER_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                   "stride", "is_contiguous", "get_device", "nelement",
                   "storage_offset", "is_pinned", "untyped_storage"}
#: torch factories: host memory unless given a device other than the CPU
FACTORIES = {"tensor", "as_tensor", "zeros", "ones", "empty", "full",
             "arange", "linspace", "eye", "randint", "rand", "randn",
             "randperm", "empty_strided", "scalar_tensor"}
#: torch names whose results are not tensors (or are host-side objects)
NON_TENSOR = {"device", "Size", "dtype", "is_tensor", "no_grad",
              "inference_mode", "manual_seed", "Generator", "iinfo",
              "finfo", "promote_types", "get_num_threads",
              "set_num_threads", "get_default_dtype", "is_floating_point",
              "set_printoptions", "is_grad_enabled", "compile"}
#: torch sub-namespaces whose calls return no tensor
NON_TENSOR_NS = ("torch.cuda", "torch.backends", "torch.distributed",
                 "torch.utils", "torch.profiler", "torch.autograd",
                 "torch.testing", "torch.version")


def applies_to(relpath: str) -> bool:
    return pkg_rel(relpath).startswith(SCAN_PREFIXES)


#: the kind of a value the analyzer cannot place
UNKNOWN = None
Kinds = frozenset


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_cpu_device(expr: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and dotted(expr.func) == "torch.device" \
            and expr.args and isinstance(expr.args[0], ast.Constant):
        return expr.args[0].value == "cpu"
    return False


def _is_dtype(expr: ast.expr) -> bool:
    d = dotted(expr)
    return d is not None and d.startswith("torch.") and \
        d.count(".") == 1 and d.split(".")[1] not in ("device",)


_ANY = frozenset({UNKNOWN})


def _union(*sets: Kinds) -> Kinds:
    out = frozenset().union(*sets)
    return out or _ANY


class _Kinds:
    """What each name of one scope (or dotted ``self.x``) may hold: the
    set of kinds over every assignment to it (UNKNOWN for a parameter
    and for what the analyzer cannot place)."""

    def __init__(self, outer: Optional[Dict[str, Kinds]] = None):
        self.env: Dict[str, Kinds] = dict(outer or {})

    # ------------------------------------------------------------- kinds

    def kind(self, node: Optional[ast.AST]) -> Kinds:
        if node is None:
            return _ANY
        if isinstance(node, ast.Name):
            return self.env.get(node.id, _ANY)
        if isinstance(node, ast.Attribute):
            if node.attr in TAINT_BREAKERS:
                return _ANY
            d = dotted(node)
            if d is not None and d in self.env:
                return self.env[d]
            if isinstance(node.value, ast.Name) and \
                    node.value.id in ("np", "numpy", "torch", "self"):
                return _ANY
            return self.kind(node.value)
        if isinstance(node, ast.Subscript):
            return self.kind(node.value)
        if isinstance(node, ast.BinOp):
            return _union(self.kind(node.left), self.kind(node.right))
        if isinstance(node, ast.UnaryOp):
            return _ANY if isinstance(node.op, ast.Not) else \
                self.kind(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return _ANY
            return _union(self.kind(node.left),
                          *(self.kind(c) for c in node.comparators))
        if isinstance(node, ast.IfExp):
            return _union(self.kind(node.body), self.kind(node.orelse))
        if isinstance(node, (ast.List, ast.Tuple)):
            return _union(*(self.kind(e) for e in node.elts))
        if isinstance(node, ast.Starred):
            return self.kind(node.value)
        if isinstance(node, ast.Call):
            return self._call_kind(node)
        return _ANY

    def _call_kind(self, call: ast.Call) -> Kinds:
        fn = call.func
        d = dotted(fn)
        if d is not None and d.split(".")[0] in ("np", "numpy"):
            return frozenset({NUMPY})
        if d is not None and d.startswith("torch."):
            name = d.split(".", 1)[1]
            if d.startswith(NON_TENSOR_NS) or name in NON_TENSOR:
                return _ANY
            if name == "from_numpy":
                return frozenset({HOST})
            dev = _kw(call, "device")
            if dev is not None:
                return frozenset({HOST if _is_cpu_device(dev) else CARD})
            if name.endswith("_like") and call.args:
                return self.kind(call.args[0])
            if name in FACTORIES:
                return frozenset({HOST})
            ks = _union(*(self.kind(a) for a in call.args),
                        *(self.kind(k.value) for k in call.keywords))
            return frozenset(HOST if k == NUMPY else k for k in ks)
        if isinstance(fn, ast.Attribute):
            m = fn.attr
            if m == "cuda":
                return frozenset({CARD})
            if m == "to":
                target = call.args[0] if call.args else _kw(call, "device")
                if target is None or _is_dtype(target):
                    return self.kind(fn.value)
                return frozenset({HOST if _is_cpu_device(target)
                                  else CARD})
            if m == "cpu":
                return frozenset({HOST})
            if m == "numpy":
                return frozenset({NUMPY})
            if m in ("tolist", "item") or m in BREAKER_METHODS:
                return _ANY
            return self.kind(fn.value)
        return _ANY

    # ------------------------------------------------------------- binds

    def bind(self, target: ast.AST, kinds: Kinds) -> bool:
        """Add `kinds` to every name in `target`; True when one moved."""
        changed = False
        for sub in ast.walk(target):
            key = None
            if isinstance(sub, ast.Name):
                key = sub.id
            elif isinstance(sub, ast.Attribute):
                key = dotted(sub)
            if key is None:
                continue
            new = self.env.get(key, frozenset()) | kinds
            if new != self.env.get(key):
                self.env[key] = new
                changed = True
        return changed


def _own_nodes(body: List[ast.stmt]) -> List[ast.AST]:
    """Every node of `body` outside nested defs, classes and lambdas, in
    source order."""
    out: List[ast.AST] = []
    stack = list(reversed(body))
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(reversed(list(ast.iter_child_nodes(node))))
    return out


def _annotated_tensor(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.endswith("Tensor")
    d = dotted(ann)
    return d is not None and d.endswith("Tensor")


def _bind_scope(kinds: _Kinds, nodes: List[ast.AST]) -> None:
    """Fixpoint of the scope's assignments (a loop may bind a name
    after its first use)."""
    for _ in range(6):
        changed = False
        for node in nodes:
            if isinstance(node, ast.Assign):
                k = kinds.kind(node.value)
                for tgt in node.targets:
                    changed |= kinds.bind(tgt, k)
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                    node.value is not None:
                k = kinds.kind(node.value)
                if isinstance(node, ast.AugAssign):
                    k = _union(k, kinds.kind(node.target))
                changed |= kinds.bind(node.target, k)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                changed |= kinds.bind(node.target, kinds.kind(node.iter))
            elif isinstance(node, ast.NamedExpr):
                changed |= kinds.bind(node.target, kinds.kind(node.value))
        if not changed:
            return


def _is_literal(node: ast.AST) -> bool:
    return isinstance(node, (ast.Constant, ast.List, ast.Dict, ast.Set,
                             ast.ListComp, ast.DictComp, ast.SetComp,
                             ast.JoinedStr))


def _blocking_upload(kinds: _Kinds, call: ast.Call) -> bool:
    """A copy of host memory to a (possibly card) device that waits: no
    ``non_blocking=True``."""
    nb = _kw(call, "non_blocking")
    if isinstance(nb, ast.Constant) and nb.value is True:
        return False
    fn = call.func
    d = dotted(fn)
    if d in ("torch.tensor", "torch.as_tensor"):
        dev = _kw(call, "device")
        return dev is not None and not _is_cpu_device(dev)
    if not (isinstance(fn, ast.Attribute) and fn.attr in ("to", "cuda")):
        return False
    recv = kinds.kind(fn.value)
    if not recv or not recv <= {HOST, NUMPY}:
        return False
    if fn.attr == "cuda":
        return True
    target = call.args[0] if call.args else _kw(call, "device")
    return target is not None and not _is_dtype(target) and \
        not _is_cpu_device(target)


def _site_line(call: ast.Call) -> int:
    """The line a sync at `call` is reported on: that of a method's name
    (where Python places the call, and where the pragma goes, when the
    receiver spans lines), else the call's first line."""
    fn = call.func
    return fn.end_lineno if isinstance(fn, ast.Attribute) else call.lineno


def _scope_findings(src: SourceFile, name: str, kinds: _Kinds,
                    nodes: List[ast.AST]) -> Dict[int, Finding]:
    out: Dict[int, Finding] = {}

    def fire(line: int, what: str) -> None:
        out.setdefault(line, Finding(
            src.path, line, RULE,
            f"{what} in `{name}` makes the host wait for the card's "
            "stream (a host sync); if the hop is intended, say why with "
            "`# lint: allow(host-sync)` on the line"))

    def test(expr: Optional[ast.AST], what: str) -> None:
        if expr is not None and CARD in kinds.kind(expr):
            fire(expr.lineno, what)

    for node in nodes:
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in SYNC_METHODS:
                recv = fn.value
                k = kinds.kind(recv)
                if fn.attr in CARD_ONLY_METHODS:
                    quiet = CARD not in k
                else:
                    quiet = not k & {CARD, UNKNOWN} or _is_literal(recv) \
                        or (dotted(recv) or "").split(".")[0] in ("np",
                                                                  "numpy")
                if not quiet:
                    fire(_site_line(node), f"`.{fn.attr}()`")
            elif _blocking_upload(kinds, node):
                fire(_site_line(node), "a blocking host→card copy")
            elif isinstance(fn, ast.Attribute) and \
                    fn.attr == "synchronize":
                fire(_site_line(node),
                     f"`{dotted(fn) or 'synchronize'}()`")
            elif isinstance(fn, ast.Name) and fn.id in HOST_CASTS and \
                    any(CARD in kinds.kind(a) for a in node.args):
                fire(_site_line(node), f"`{fn.id}()` of a card tensor")
        elif isinstance(node, (ast.If, ast.While, ast.Assert)):
            test(node.test, f"the `{type(node).__name__.lower()}` test "
                            "(an implicit bool()) of a card tensor")
        elif isinstance(node, ast.IfExp):
            test(node.test, "a ternary's test (an implicit bool()) of a "
                            "card tensor")
        elif isinstance(node, ast.BoolOp):
            for v in node.values:
                test(v, "an `and`/`or` operand (an implicit bool()) of a "
                        "card tensor")
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            test(node.operand, "`not` (an implicit bool()) of a card "
                               "tensor")
    return out


def _walk_scopes(src: SourceFile, name: str, body: List[ast.stmt],
                 outer: Dict[str, Kinds], params=(),
                 out: Optional[Dict[int, Finding]] = None
                 ) -> Dict[int, Finding]:
    out = {} if out is None else out
    kinds = _Kinds(outer)
    for arg in params:  # a parameter shadows the outer name
        kinds.env[arg.arg] = frozenset({CARD}) if _annotated_tensor(arg) \
            else _ANY
    nodes = _own_nodes(body)
    _bind_scope(kinds, nodes)
    for line, f in _scope_findings(src, name, kinds, nodes).items():
        out.setdefault(line, f)
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            _walk_scopes(src, node.name, node.body, kinds.env,
                         a.posonlyargs + a.args + a.kwonlyargs +
                         [x for x in (a.vararg, a.kwarg) if x], out)
        elif isinstance(node, ast.ClassDef):
            _walk_scopes(src, node.name, node.body, {}, (), out)
        elif isinstance(node, ast.Lambda):
            _walk_scopes(src, "<lambda>", [ast.Expr(node.body)],
                         kinds.env, node.args.args, out)
    return out


def analyze_source(src: SourceFile) -> List[Finding]:
    try:
        tree = ast.parse(src.text)
    except SyntaxError as e:
        return [Finding(src.path, e.lineno or 1, "parse-error", str(e))]
    found = _walk_scopes(src, "<module>", tree.body, {})
    return [f for _, f in sorted(found.items())
            if not src.allowed(f.line, f.rule)]


def raw_sites(src: SourceFile) -> List[int]:
    """Every line the rule fires on, pragma or not: the static sites a
    run's recorded syncs are held against (chip_smoke.py)."""
    try:
        tree = ast.parse(src.text)
    except SyntaxError:
        return []
    return sorted(_walk_scopes(src, "<module>", tree.body, {}))


def analyze_file(path) -> List[Finding]:
    return analyze_source(SourceFile.load(path))
