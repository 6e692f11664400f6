"""Statement-level control-flow graphs over Python ``ast``.

One :class:`CFG` per function: nodes are statements (plus a few synthetic
markers), edges carry a kind — ``normal`` fall-through, ``true``/``false``
branch arms, and ``exc`` for the exception edge out of any statement whose
evaluation can raise. The graph models the control constructs the repo's
invariants live in: ``if``/``for``/``while`` (with ``break``/``continue``),
``try``/``except``/``else``/``finally``, ``with``, early ``return`` and
``raise``.

``finally`` semantics use instance duplication: each continuation kind
entering a ``try``/``finally`` (normal completion, exception propagation,
``return``, ``break``, ``continue``) gets its own copy of the ``finally``
body wired to that continuation's onward target. Duplication keeps every
path explicit — exactly what the heal/resource analyzers need, since "the
heal runs in the finally" must hold separately on the exception path and
the return path — at a node-count cost that is irrelevant at
function-sized graphs.

Exception dispatch is conservative: an ``exc`` edge from a statement goes
to the innermost ``except-dispatch`` node, which fans out to every
handler; unless some handler is a catch-all (bare / ``Exception`` /
``BaseException``), the dispatch also keeps a propagate edge outward
(through the enclosing ``finally`` chain). Which concrete exception type
flows where is not modeled — the analyzers' properties must hold on the
superset of paths.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Tuple

NORMAL = "normal"
TRUE = "true"
FALSE = "false"
EXC = "exc"

#: handler type names treated as catching every exception.
CATCH_ALL = {"Exception", "BaseException"}


class Node:
    """One CFG node: a statement, or a synthetic marker (entry/exit/
    join/except-dispatch/handler/finally/with-*)."""

    __slots__ = ("idx", "stmt", "label", "succs")

    def __init__(self, idx: int, stmt: Optional[ast.AST], label: str):
        self.idx = idx
        self.stmt = stmt
        self.label = label
        self.succs: List[Tuple["Node", str]] = []

    @property
    def line(self) -> int:
        return getattr(self.stmt, "lineno", 0)

    def __repr__(self):
        return f"<{self.idx}:{self.label}@{self.line}>"


class CFG:
    """Graph for one function: ``entry``, statement nodes, ``exit``
    (normal return) and ``raise_exit`` (exception escapes the function)."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: List[Node] = []
        self.entry = self.new(None, "entry")
        self.exit = self.new(None, "exit")
        self.raise_exit = self.new(None, "raise-exit")

    def new(self, stmt: Optional[ast.AST], label: str) -> Node:
        n = Node(len(self.nodes), stmt, label)
        self.nodes.append(n)
        return n

    def edge(self, src: Node, dst: Node, kind: str = NORMAL) -> None:
        src.succs.append((dst, kind))

    def stmt_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.stmt is not None]

    def find(self, label: str) -> List[Node]:
        return [n for n in self.nodes if n.label == label]


class _Ctx:
    """Continuation targets for the region being built. Entering a
    ``try``/``finally`` rebinds each target to that continuation's
    finally instance."""

    __slots__ = ("exc", "ret", "brk", "cont")

    def __init__(self, exc: Node, ret: Node,
                 brk: Optional[Node] = None, cont: Optional[Node] = None):
        self.exc = exc
        self.ret = ret
        self.brk = brk
        self.cont = cont

    def derive(self, **kw) -> "_Ctx":
        out = _Ctx(self.exc, self.ret, self.brk, self.cont)
        for k, v in kw.items():
            setattr(out, k, v)
        return out


def _expr_raises(node: Optional[ast.AST]) -> bool:
    """Can evaluating this expression raise? Calls and subscripts are
    the raisers that matter for the invariants here (a KeyError out of
    ``test["members"]`` skips a heal exactly like a failed RPC does);
    attribute loads and arithmetic are treated as safe to keep the
    graph's exception fan-out meaningful."""
    if node is None:
        return False
    return any(isinstance(sub, (ast.Call, ast.Subscript, ast.Await))
               for sub in ast.walk(node))


def _stmt_raises(stmt: ast.stmt) -> bool:
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    return _expr_raises(stmt)


_SIMPLE = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr, ast.Delete,
           ast.Pass, ast.Import, ast.ImportFrom, ast.Global, ast.Nonlocal,
           ast.Assert, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)

Preds = List[Tuple[Node, str]]


class _Builder:
    def __init__(self, fn: ast.FunctionDef):
        self.cfg = CFG(fn.name)

    def build(self, fn: ast.FunctionDef) -> CFG:
        ctx = _Ctx(exc=self.cfg.raise_exit, ret=self.cfg.exit)
        out = self.body(fn.body, [(self.cfg.entry, NORMAL)], ctx)
        self.connect(out, self.cfg.exit)
        return self.cfg

    # ---------------------------------------------------------- plumbing

    def connect(self, preds: Preds, dst: Node) -> None:
        """Attach dangling edges to `dst`, PRESERVING each edge's own
        kind: a dangling if-FALSE arm stays a `false` edge even when it
        flows into a finally instance that resumes an exception —
        analyzers prune on the kind of the edge leaving its source node
        (guards, post-heal exception arms), not on what continuation the
        join serves."""
        for n, k in preds:
            self.cfg.edge(n, dst, k)

    def body(self, stmts: Sequence[ast.stmt], preds: Preds,
             ctx: _Ctx) -> Preds:
        for stmt in stmts:
            preds = self.stmt(stmt, preds, ctx)
        return preds

    def stmt(self, stmt: ast.stmt, preds: Preds, ctx: _Ctx) -> Preds:
        if isinstance(stmt, ast.If):
            return self._if(stmt, preds, ctx)
        if isinstance(stmt, ast.While):
            return self._while(stmt, preds, ctx)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._for(stmt, preds, ctx)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, preds, ctx)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, preds, ctx)
        if isinstance(stmt, ast.Return):
            n = self.cfg.new(stmt, "return")
            self.connect(preds, n)
            if _expr_raises(stmt.value):
                self.cfg.edge(n, ctx.exc, EXC)
            self.cfg.edge(n, ctx.ret, NORMAL)
            return []
        if isinstance(stmt, ast.Raise):
            n = self.cfg.new(stmt, "raise")
            self.connect(preds, n)
            self.cfg.edge(n, ctx.exc, EXC)
            return []
        if isinstance(stmt, ast.Break):
            n = self.cfg.new(stmt, "break")
            self.connect(preds, n)
            if ctx.brk is not None:
                self.cfg.edge(n, ctx.brk, NORMAL)
            return []
        if isinstance(stmt, ast.Continue):
            n = self.cfg.new(stmt, "continue")
            self.connect(preds, n)
            if ctx.cont is not None:
                self.cfg.edge(n, ctx.cont, NORMAL)
            return []
        # simple statement (incl. nested def/class: opaque, non-raising
        # at definition time beyond default-arg evaluation)
        n = self.cfg.new(stmt, "stmt")
        self.connect(preds, n)
        if isinstance(stmt, _SIMPLE) and _stmt_raises(stmt):
            self.cfg.edge(n, ctx.exc, EXC)
        return [(n, NORMAL)]

    # ------------------------------------------------------- structures

    def _if(self, stmt: ast.If, preds: Preds, ctx: _Ctx) -> Preds:
        cond = self.cfg.new(stmt, "if")
        self.connect(preds, cond)
        if _expr_raises(stmt.test):
            self.cfg.edge(cond, ctx.exc, EXC)
        out = self.body(stmt.body, [(cond, TRUE)], ctx)
        if stmt.orelse:
            out += self.body(stmt.orelse, [(cond, FALSE)], ctx)
        else:
            out += [(cond, FALSE)]
        return out

    def _while(self, stmt: ast.While, preds: Preds, ctx: _Ctx) -> Preds:
        cond = self.cfg.new(stmt, "while")
        loop_exit = self.cfg.new(stmt, "loop-exit")
        self.connect(preds, cond)
        if _expr_raises(stmt.test):
            self.cfg.edge(cond, ctx.exc, EXC)
        inner = ctx.derive(brk=loop_exit, cont=cond)
        back = self.body(stmt.body, [(cond, TRUE)], inner)
        self.connect(back, cond)
        forever = isinstance(stmt.test, ast.Constant) and \
            bool(stmt.test.value)
        if not forever:
            # `while True:` has no false arm — only `break` leaves.
            self.cfg.edge(cond, loop_exit, FALSE)
        out = [(loop_exit, NORMAL)]
        if stmt.orelse:
            out = self.body(stmt.orelse, out, ctx)
        return out

    def _for(self, stmt, preds: Preds, ctx: _Ctx) -> Preds:
        head = self.cfg.new(stmt, "for")
        loop_exit = self.cfg.new(stmt, "loop-exit")
        self.connect(preds, head)
        if _expr_raises(stmt.iter):
            self.cfg.edge(head, ctx.exc, EXC)
        inner = ctx.derive(brk=loop_exit, cont=head)
        back = self.body(stmt.body, [(head, TRUE)], inner)
        self.connect(back, head)
        self.cfg.edge(head, loop_exit, FALSE)
        out = [(loop_exit, NORMAL)]
        if stmt.orelse:
            out = self.body(stmt.orelse, out, ctx)
        return out

    def _finally_instance(self, finalbody: Sequence[ast.stmt], ctx: _Ctx,
                          onward: Node, kind: str) -> Node:
        """One copy of the finally body whose completion resumes the
        pending continuation via an edge of `kind` to `onward`.
        Exceptions raised *inside* the finally replace the continuation
        and propagate outward (ctx is the outer context)."""
        entry = self.cfg.new(None, "finally")
        out = self.body(list(finalbody), [(entry, NORMAL)], ctx)
        self.connect(out, onward)
        return entry

    def _try(self, stmt: ast.Try, preds: Preds, ctx: _Ctx) -> Preds:
        inner = ctx
        if stmt.finalbody:
            inner = ctx.derive(
                exc=self._finally_instance(stmt.finalbody, ctx,
                                           ctx.exc, EXC),
                ret=self._finally_instance(stmt.finalbody, ctx,
                                           ctx.ret, NORMAL))
            if ctx.brk is not None:
                inner.brk = self._finally_instance(stmt.finalbody, ctx,
                                                   ctx.brk, NORMAL)
            if ctx.cont is not None:
                inner.cont = self._finally_instance(stmt.finalbody, ctx,
                                                    ctx.cont, NORMAL)

        handler_out: Preds = []
        body_ctx = inner
        if stmt.handlers:
            dispatch = self.cfg.new(stmt, "except-dispatch")
            body_ctx = inner.derive(exc=dispatch)
            catch_all = False
            for h in stmt.handlers:
                entry = self.cfg.new(h, "handler")
                self.cfg.edge(dispatch, entry, EXC)
                names = _handler_names(h)
                if any(n in CATCH_ALL or n == "" for n in names):
                    catch_all = True
                # exceptions raised in a handler are not re-dispatched
                # here; they propagate (through any finally) outward
                handler_out += self.body(h.body, [(entry, NORMAL)], inner)
            if not catch_all:
                self.cfg.edge(dispatch, inner.exc, EXC)

        body_out = self.body(stmt.body, preds, body_ctx)
        if stmt.orelse:
            # else runs after an exception-free body; its exceptions are
            # NOT seen by this try's handlers
            body_out = self.body(stmt.orelse, body_out, inner)
        out = body_out + handler_out
        if stmt.finalbody:
            entry = self.cfg.new(None, "finally")
            fin_out = self.body(stmt.finalbody, [(entry, NORMAL)], ctx)
            self.connect(out, entry)
            return fin_out
        return out

    def _with(self, stmt, preds: Preds, ctx: _Ctx) -> Preds:
        enter = self.cfg.new(stmt, "with-enter")
        self.connect(preds, enter)
        if any(_expr_raises(it.context_expr) for it in stmt.items):
            self.cfg.edge(enter, ctx.exc, EXC)

        def exit_marker(onward: Node, kind: str) -> Node:
            m = self.cfg.new(stmt, "with-exit")
            self.cfg.edge(m, onward, kind)
            return m

        inner = ctx.derive(exc=exit_marker(ctx.exc, EXC),
                           ret=exit_marker(ctx.ret, NORMAL))
        if ctx.brk is not None:
            inner.brk = exit_marker(ctx.brk, NORMAL)
        if ctx.cont is not None:
            inner.cont = exit_marker(ctx.cont, NORMAL)
        out = self.body(stmt.body, [(enter, NORMAL)], inner)
        norm = self.cfg.new(stmt, "with-exit")
        self.connect(out, norm)
        return [(norm, NORMAL)]


def _handler_names(h: ast.ExceptHandler) -> List[str]:
    if h.type is None:
        return [""]
    items = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
    out = []
    for it in items:
        if isinstance(it, ast.Name):
            out.append(it.id)
        elif isinstance(it, ast.Attribute):
            out.append(it.attr)
        else:
            out.append("?")
    return out


def build_cfg(fn: ast.FunctionDef) -> CFG:
    """CFG of one function body (nested defs are opaque single nodes —
    build theirs separately)."""
    return _Builder(fn).build(fn)


def own_exprs(node: Node) -> List[ast.AST]:
    """The AST actually *evaluated at* this node. Compound-statement
    nodes (if/while/for/with/try) carry the whole construct in `.stmt`
    for location info, but only their header expression executes there —
    matching against the full subtree would credit a node with calls
    that live in its body. Nested function/class defs execute nothing
    of their body at definition time."""
    s = node.stmt
    if s is None:
        return []
    if node.label in ("if", "while"):
        return [s.test]
    if node.label == "for":
        return [s.iter]
    if node.label == "with-enter":
        return [it.context_expr for it in s.items]
    if node.label in ("except-dispatch", "handler", "with-exit",
                      "loop-exit"):
        return []
    if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []
    return [s]


def walk_own(fn: ast.FunctionDef):
    """ast.walk over a function, not descending into nested defs or
    lambdas (their bodies run later, in their own frame)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def functions_of(tree: ast.AST):
    """Every function def in a module, with its enclosing class (or
    None): [(class_node, fn_node)]. Nested functions are included with
    the class of their outermost enclosing scope."""
    out = []

    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((cls, child))
                walk(child, cls)
            else:
                walk(child, cls)

    walk(tree, None)
    return out


def cfg_for(source: str, func: str) -> CFG:
    """Test helper: parse `source` and build the CFG of the (possibly
    nested / method) function named `func`."""
    tree = ast.parse(source)
    for _, fn in functions_of(tree):
        if fn.name == func:
            return build_cfg(fn)
    raise ValueError(f"no function {func!r} in source")


def reach(cfg: CFG, starts: Sequence[Node], stop) -> List[List[Node]]:
    """Depth-first path search used by the dataflow analyzers.

    `stop(node, kind_in)` classifies each visited node:
      * ``"kill"``   — path is discharged here, stop exploring it;
      * ``"report"`` — an escaping path ends here (exit reached while
        the property is still pending): record it;
      * a set/list of edge kinds — keep exploring, but only along edges
        whose kind is in the set;
      * ``None``     — keep exploring along every edge.

    Returns the recorded escape paths (each a node list, for messages).
    Cycles are cut with a visited set, so each node is expanded once —
    sound for pure reachability properties like these."""
    found: List[List[Node]] = []
    seen = set()
    stack = [(n, k, [n]) for n, k in ((s, NORMAL) for s in starts)]
    while stack:
        node, kind, path = stack.pop()
        if node.idx in seen:
            continue
        seen.add(node.idx)
        verdict = stop(node, kind)
        if verdict == "kill":
            continue
        if verdict == "report":
            found.append(path)
            continue
        for succ, k in node.succs:
            if verdict is not None and k not in verdict:
                continue
            stack.append((succ, k, path + [succ]))
    return found
