"""Restricted AST evaluator for static shape arithmetic.

``kernel_contract`` needs to *execute* the port's plain shape functions
(``sort_shape_plain``, ``segment_shape_at``, ``closure_shape``, ...)
under concrete symbol bindings without importing torch or running any
real code. This module is that executor: a small big-step interpreter
over the integer/bool/tuple fragment of Python — arithmetic,
comparisons, conditionals, bounded loops, calls to
``max``/``min``/``len``/``range``/``int``/``abs``, ``int.bit_length``,
``NamedTuple`` records (built positionally, read by field), and calls
into other functions of the same module or, through :func:`load`, of
the modules it imports from (depth-bounded).

Anything outside the fragment evaluates to :data:`UNKNOWN`, which
propagates: an expression touching UNKNOWN is UNKNOWN, a branch on an
UNKNOWN test aborts the enclosing function evaluation (result UNKNOWN)
rather than guessing a path. The kernel-contract analyzer turns an
UNKNOWN where a shape was needed into a loud ``kernel-unresolved``
finding — silence is never vacuous.

Attribute chains resolve to an opaque :class:`Dotted` name
(``torch.int32`` → ``Dotted("torch.int32")``), which is how dtypes are
read without importing torch.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Any, Dict, Optional


class _Unknown:
    def __repr__(self):
        return "UNKNOWN"


UNKNOWN = _Unknown()


class Dotted:
    """An unevaluated dotted name (``jnp.int32``); `.name` keeps the
    full spelling, `.leaf` the final attribute."""

    def __init__(self, name: str):
        self.name = name

    @property
    def leaf(self) -> str:
        return self.name.rsplit(".", 1)[-1]

    def __repr__(self):
        return f"Dotted({self.name})"

    def __eq__(self, other):
        return isinstance(other, Dotted) and other.name == self.name

    def __hash__(self):
        return hash(("Dotted", self.name))


class Record(tuple):
    """A ``NamedTuple`` value: a tuple whose `fields` name its items."""

    fields: tuple = ()

    @classmethod
    def make(cls, fields, values) -> "Record":
        r = cls(values)
        r.fields = tuple(fields)
        return r


class _RecordType:
    """A module's ``NamedTuple`` class: called positionally, it builds a
    :class:`Record`."""

    def __init__(self, fields):
        self.fields = tuple(fields)

    def __call__(self, *args):
        if len(args) != len(self.fields):
            return UNKNOWN
        return Record.make(self.fields, args)


class Closure:
    """A lambda/def captured with its defining environment."""

    def __init__(self, node, env: Dict[str, Any], interp: "Interp"):
        self.node = node
        self.env = env
        self.interp = interp

    def call(self, args):
        params = [a.arg for a in self.node.args.args]
        if len(args) != len(params):
            return UNKNOWN
        env = dict(self.env)
        env.update(zip(params, args))
        if isinstance(self.node, ast.Lambda):
            return self.interp.eval(self.node.body, env)
        return self.interp.exec_fn(self.node, env)


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Abort(Exception):
    """Evaluation left the supported fragment (unknown branch test,
    loop bound, iteration space…) — the whole function is UNKNOWN."""


_BUILTINS = {"max": max, "min": min, "len": len, "abs": abs, "int": int,
             "bool": bool, "sum": sum, "range": range, "sorted": sorted,
             "tuple": tuple, "list": list}

#: loop-iteration ceiling: shape arithmetic loops (pow2 bucketing etc.)
#: finish in tens of steps; anything longer is outside the fragment.
MAX_ITER = 100_000


class Interp:
    def __init__(self, module: Optional[ast.Module] = None,
                 max_depth: int = 6, env: Optional[Dict[str, Any]] = None):
        self.functions: Dict[str, ast.FunctionDef] = {}
        #: names bound before the module body runs (its imports, see
        #: :func:`load`)
        self.module_env: Dict[str, Any] = dict(env or {})
        self.max_depth = max_depth
        self.depth = 0
        #: lenient mode (scope harvesting): an UNKNOWN branch test skips
        #: the construct instead of aborting — used when the goal is
        #: "collect every assignment we *can* evaluate", not a faithful
        #: single-path execution.
        self.lenient = False
        if module is not None:
            for stmt in module.body:
                if isinstance(stmt, ast.FunctionDef):
                    self.functions[stmt.name] = stmt
                    self.module_env.pop(stmt.name, None)
                elif isinstance(stmt, ast.ClassDef) and any(
                        (b.id if isinstance(b, ast.Name) else
                         getattr(b, "attr", "")) == "NamedTuple"
                        for b in stmt.bases):
                    self.module_env[stmt.name] = _RecordType(
                        s.target.id for s in stmt.body
                        if isinstance(s, ast.AnnAssign) and
                        isinstance(s.target, ast.Name))
                elif isinstance(stmt, ast.Assign) and \
                        len(stmt.targets) == 1 and \
                        isinstance(stmt.targets[0], ast.Name):
                    try:
                        v = self.eval(stmt.value, {})
                    except _Abort:
                        v = UNKNOWN
                    self.module_env[stmt.targets[0].id] = v

    # ------------------------------------------------------------ expr

    def eval(self, node: ast.AST, env: Dict[str, Any]) -> Any:
        try:
            return self._eval(node, env)
        except _Abort:
            raise
        except Exception:
            return UNKNOWN

    def _eval(self, node: ast.AST, env: Dict[str, Any]) -> Any:
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            if node.id in self.module_env:
                return self.module_env[node.id]
            if node.id in self.functions:
                return Closure(self.functions[node.id], {}, self)
            if node.id in _BUILTINS:
                return _BUILTINS[node.id]
            return Dotted(node.id)
        if isinstance(node, ast.Attribute):
            base = self._eval(node.value, env)
            if isinstance(base, Dotted):
                return Dotted(f"{base.name}.{node.attr}")
            if isinstance(base, Record) and node.attr in base.fields:
                return base[base.fields.index(node.attr)]
            if isinstance(base, int) and not isinstance(base, bool) and \
                    node.attr == "bit_length":
                return base.bit_length
            return UNKNOWN
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(self._eval(e, env) for e in node.elts)
        if isinstance(node, ast.Lambda):
            return Closure(node, dict(env), self)
        if isinstance(node, ast.BinOp):
            a = self._eval(node.left, env)
            b = self._eval(node.right, env)
            if a is UNKNOWN or b is UNKNOWN:
                return UNKNOWN
            return _BINOPS[type(node.op)](a, b)
        if isinstance(node, ast.UnaryOp):
            v = self._eval(node.operand, env)
            if v is UNKNOWN:
                return UNKNOWN
            return _UNOPS[type(node.op)](v)
        if isinstance(node, ast.BoolOp):
            vals = [self._eval(v, env) for v in node.values]
            if any(v is UNKNOWN for v in vals):
                return UNKNOWN
            if isinstance(node.op, ast.And):
                out = True
                for v in vals:
                    out = out and v
                return out
            out = False
            for v in vals:
                out = out or v
            return out
        if isinstance(node, ast.Compare):
            left = self._eval(node.left, env)
            for op, comp in zip(node.ops, node.comparators):
                right = self._eval(comp, env)
                if left is UNKNOWN or right is UNKNOWN:
                    return UNKNOWN
                if not _CMPOPS[type(op)](left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.IfExp):
            test = self._eval(node.test, env)
            if test is UNKNOWN:
                return UNKNOWN
            return self._eval(node.body if test else node.orelse, env)
        if isinstance(node, ast.Subscript):
            base = self._eval(node.value, env)
            idx = self._eval(node.slice, env)
            if base is UNKNOWN or idx is UNKNOWN:
                return UNKNOWN
            return base[idx]
        if isinstance(node, ast.Call):
            return self._call(node, env)
        return UNKNOWN

    def _call(self, node: ast.Call, env: Dict[str, Any]) -> Any:
        fn = self._eval(node.func, env)
        args = [self._eval(a, env) for a in node.args]
        if fn is UNKNOWN or isinstance(fn, Dotted):
            return UNKNOWN
        if any(a is UNKNOWN for a in args):
            return UNKNOWN
        if node.keywords:
            return UNKNOWN  # fragment: positional calls only
        if isinstance(fn, Closure):
            return fn.call(args)
        if callable(fn):
            return fn(*args)
        return UNKNOWN

    # ------------------------------------------------------------ stmts

    def exec_fn(self, fn: ast.FunctionDef, env: Dict[str, Any]) -> Any:
        """Run a def's body under `env`; returns its return value, or
        UNKNOWN when the body leaves the fragment."""
        if self.depth >= self.max_depth:
            return UNKNOWN
        self.depth += 1
        try:
            self.exec_body(fn.body, env)
            return None
        except _Return as r:
            return r.value
        except _Abort:
            return UNKNOWN
        finally:
            self.depth -= 1

    def exec_body(self, stmts, env: Dict[str, Any]) -> None:
        for stmt in stmts:
            self.exec_stmt(stmt, env)

    def exec_stmt(self, stmt: ast.stmt, env: Dict[str, Any]) -> None:
        if isinstance(stmt, ast.Assign):
            val = self.eval(stmt.value, env)
            for tgt in stmt.targets:
                self._bind(tgt, val, env)
            return
        if isinstance(stmt, ast.AugAssign):
            if not isinstance(stmt.target, ast.Name):
                return
            cur = env.get(stmt.target.id, UNKNOWN)
            val = self.eval(stmt.value, env)
            if cur is UNKNOWN or val is UNKNOWN:
                env[stmt.target.id] = UNKNOWN
                return
            env[stmt.target.id] = _BINOPS[type(stmt.op)](cur, val)
            return
        if isinstance(stmt, ast.Return):
            raise _Return(self.eval(stmt.value, env)
                          if stmt.value is not None else None)
        if isinstance(stmt, ast.If):
            test = self.eval(stmt.test, env)
            if test is UNKNOWN:
                if self.lenient:
                    return
                raise _Abort
            self.exec_body(stmt.body if test else stmt.orelse, env)
            return
        if isinstance(stmt, ast.While):
            it = 0
            while True:
                test = self.eval(stmt.test, env)
                if test is UNKNOWN:
                    if self.lenient:
                        return
                    raise _Abort
                if not test:
                    return
                it += 1
                if it > MAX_ITER:
                    raise _Abort
                self.exec_body(stmt.body, env)
            return
        if isinstance(stmt, ast.For):
            seq = self.eval(stmt.iter, env)
            if seq is UNKNOWN or not isinstance(stmt.target, ast.Name):
                if self.lenient:
                    return
                raise _Abort
            it = 0
            for v in seq:
                it += 1
                if it > MAX_ITER:
                    raise _Abort
                env[stmt.target.id] = v
                self.exec_body(stmt.body, env)
            return
        if isinstance(stmt, ast.FunctionDef):
            env[stmt.name] = Closure(stmt, env, self)
            return
        if isinstance(stmt, (ast.Pass, ast.Expr, ast.Import,
                             ast.ImportFrom, ast.Assert)):
            return
        # anything else (try, with, class, del…) is outside the shape-
        # arithmetic fragment; its targets just become unresolvable.
        return

    def _bind(self, tgt: ast.expr, val: Any,
              env: Dict[str, Any]) -> None:
        if isinstance(tgt, ast.Name):
            env[tgt.id] = val
        elif isinstance(tgt, (ast.Tuple, ast.List)) and \
                isinstance(val, tuple) and len(tgt.elts) == len(val):
            for t, v in zip(tgt.elts, val):
                self._bind(t, v, env)


_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Div: lambda a, b: a / b,
    ast.Mod: lambda a, b: a % b,
    ast.Pow: lambda a, b: a ** b,
    ast.LShift: lambda a, b: a << b,
    ast.RShift: lambda a, b: a >> b,
    ast.BitAnd: lambda a, b: a & b,
    ast.BitOr: lambda a, b: a | b,
    ast.BitXor: lambda a, b: a ^ b,
}

_UNOPS = {
    ast.USub: lambda v: -v,
    ast.UAdd: lambda v: +v,
    ast.Not: lambda v: not v,
    ast.Invert: lambda v: ~v,
}

_CMPOPS = {
    ast.Eq: lambda a, b: a == b,
    ast.NotEq: lambda a, b: a != b,
    ast.Lt: lambda a, b: a < b,
    ast.LtE: lambda a, b: a <= b,
    ast.Gt: lambda a, b: a > b,
    ast.GtE: lambda a, b: a >= b,
    ast.Is: lambda a, b: a is b,
    ast.IsNot: lambda a, b: a is not b,
    ast.In: lambda a, b: a in b,
    ast.NotIn: lambda a, b: a not in b,
}


def load(path, text: Optional[str] = None, depth: int = 0) -> Interp:
    """An :class:`Interp` over the module at `path` (its source `text`
    when given), whose relative imports (``from .kernel_ir import
    CYCLE_TILE``, ``from ..ops.linear_scan import MAX_CONFIGS``) are
    bound first: a constant to its value, a function to a
    :class:`Closure` over its own module. Missing or unparsable
    siblings leave their names unbound (and so unresolved)."""
    path = Path(path)
    if text is None:
        text = path.read_text(encoding="utf-8", errors="replace")
    tree = ast.parse(text)
    env: Dict[str, Any] = {}
    for stmt in tree.body:
        if not (isinstance(stmt, ast.ImportFrom) and stmt.level >= 1
                and stmt.module) or depth >= 3:
            continue
        target = path.parent
        for _ in range(stmt.level - 1):
            target = target.parent
        sib = target.joinpath(*stmt.module.split(".")).with_suffix(".py")
        if not sib.exists():
            continue
        try:
            sub = load(sib, depth=depth + 1)
        except SyntaxError:
            continue
        for alias in stmt.names:
            if alias.name in sub.functions:
                val = Closure(sub.functions[alias.name], {}, sub)
            else:
                val = sub.module_env.get(alias.name, UNKNOWN)
            if val is not UNKNOWN:
                env[alias.asname or alias.name] = val
    return Interp(tree, env=env)
