"""Lock-ordering analyzer: the acquires-while-holding graph of service/.

graftd is one process holding half a dozen locks — the daemon registry
lock, per-shard queue conditions, stream session RLocks, the stream
manager table lock, the journal's append lock and group-commit
condition, the store publish lock. A deadlock needs only two of them
acquired in opposite orders on two threads, and no unit test reliably
produces that interleaving. This analyzer computes the
acquires-while-holding relation over the whole ``service/`` directory
(one analysis, not per-file — nesting crosses files via calls), fails
on cycles, and pins today's real acquisition order as an explicit
hierarchy so a contradicting edge fails review even before it closes a
cycle.

Lock identity is the *declaration*: ``self._lock = threading.Lock()``
in class C is the canonical lock ``C._lock`` (one lock class per
instance attribute — the standard lock-ordering abstraction; per-object
cycles within one lock class are caught by the reentrancy check
instead). Module-level ``X = threading.Lock()`` is ``module.X``.
Reentrant locks (``RLock``, argless ``Condition`` — its hidden lock is
an RLock) may self-nest; a self-edge on a non-reentrant lock is an
unconditional deadlock and reported as a cycle of length one.

Edges come from two sources, both computed on the CFG with
locks.lock_regions so try/finally and early-return paths are modeled:

* a ``with``-acquisition at a node where another lock is held;
* a *call* at such a node, resolved through a typed receiver map
  (param annotations, ``self.attr = ClassName(...)``, list/dict element
  types, locals) with a unique-method-name fallback for unannotated
  handles, into the callee's transitively-may-acquire set (fixpoint
  over the call graph).

Unresolvable receivers are skipped — under-approximation keeps the
reported edges real; the hierarchy check keeps the approximation
honest by requiring every *declared* lock to be ranked.

Rules: ``flow-lock-cycle`` (a cycle in the graph — deadlock),
``flow-lock-order`` (an edge contradicting the pinned hierarchy),
``flow-lock-unranked`` (a declared lock missing from the hierarchy —
update HIERARCHY + checker-design.md §18 together). Pragma alias for
all three: ``lock-order``.

CLI anchoring: the analyzer applies to ``service/daemon.py`` and, when
invoked on it, loads every sibling ``service/*.py`` — one whole-tier
analysis per run, attributed to the file each edge lives in.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..base import Finding, SourceFile, pkg_rel
from .cfg import build_cfg, functions_of, own_exprs
from .locks import fn_requires, lock_regions, node_locks, walk_expr

RULE_CYCLE = "flow-lock-cycle"
RULE_ORDER = "flow-lock-order"
RULE_RANK = "flow-lock-unranked"

ANCHOR = "service/daemon.py"

#: Today's real acquisition order, outermost first (checker-design.md
#: §18 documents the same list with rationale). An edge from a lock to
#: one at the same or an earlier level fails flow-lock-order; a
#: declared lock absent from this list fails flow-lock-unranked so the
#: pinned order can never silently rot.
HIERARCHY: Tuple[str, ...] = (
    # stream tier: a session RLock is taken first (public entry points
    # lock the session, then journal/manager internals)
    "StreamSession.lock",
    "StreamManager._lock",
    # daemon tier: the registry lock wraps shard handoff
    "CheckingService._lock",
    "_ShardQueue._cond",
    "AdmissionQueue._cond",
    "BatchScheduler._seq_lock",
    "ShardLoads._lock",
    "ResultCache._lock",
    # request finish is leaf-before-journal (first-wins flag flip, then
    # durability outside the flag lock)
    "CheckRequest._finish_lock",
    # durability tier: group-commit membership, then the handle lock
    "AdmissionJournal._gcond",
    "AdmissionJournal._lock",
    # cross-process publish leaves: the detail-store singleton factory
    # holds the registry lock while constructing/loading the store
    "store._DETAIL_STORE_LOCK",
    "ResultStore._lock",
    # tenant-side leaf: keep-alive A/B counters — bumped
    # with nothing else held, never wraps an acquisition
    "ServiceClient._counter_lock",
)

#: Method names too generic for unique-name call resolution (they exist
#: on builtins/stdlib types the typed layer does not track).
_GENERIC = {"get", "put", "pop", "append", "add", "remove", "clear",
            "update", "items", "keys", "values", "close", "stop",
            "start", "run", "join", "wait", "notify", "notify_all",
            "acquire", "release", "submit", "send", "recv", "read",
            "write", "flush", "set", "is_set", "cancel", "result",
            "copy", "sort", "index", "count", "setdefault", "extend",
            "strip", "split", "encode", "decode", "format", "mkdir",
            "exists", "unlink", "open"}


def applies_to(relpath: str) -> bool:
    rp = pkg_rel(relpath)
    return rp == ANCHOR


# ------------------------------------------------------------ harvesting


def _callee(call: ast.Call) -> Tuple[str, Optional[ast.AST]]:
    """(name, receiver-expr-or-None) of a call."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id, None
    if isinstance(fn, ast.Attribute):
        return fn.attr, fn.value
    return "", None


def _lock_ctor(value: ast.AST) -> Optional[bool]:
    """None if `value` is not a lock construction, else its reentrancy.

    Recognizes threading.Lock/RLock/Condition calls and the dataclass
    ``field(default_factory=threading.Lock)`` form."""
    if not isinstance(value, ast.Call):
        return None
    name, _recv = _callee(value)
    if name == "field":
        for kw in value.keywords:
            if kw.arg == "default_factory":
                fac = kw.value
                fname = (fac.attr if isinstance(fac, ast.Attribute)
                         else fac.id if isinstance(fac, ast.Name) else "")
                if fname in ("Lock", "RLock", "Condition"):
                    return fname != "Lock"
        return None
    if name == "Lock":
        return False
    if name == "RLock":
        return True
    if name == "Condition":
        # argless Condition wraps an RLock (reentrant); an explicit
        # Condition(threading.Lock()) is non-reentrant.
        if value.args:
            inner = _lock_ctor(value.args[0])
            return bool(inner)
        return True
    return None


class _World:
    """Cross-file harvest: locks, classes, methods, attribute types."""

    def __init__(self, srcs: Dict[str, SourceFile]):
        self.srcs = srcs
        self.trees: Dict[str, ast.AST] = {}
        self.parse_errors: List[Finding] = []
        #: canonical lock → (reentrant, filekey, line)
        self.locks: Dict[str, Tuple[bool, str, int]] = {}
        #: lock attr name → [classname] that declare it
        self.lock_owners: Dict[str, List[str]] = {}
        #: module-level lock Name → canonical (unique across files)
        self.module_locks: Dict[str, str] = {}
        self.classes: Set[str] = set()
        #: (classname, method) → (filekey, fn-node)
        self.methods: Dict[Tuple[str, str], Tuple[str, ast.FunctionDef]] = {}
        #: module function name → (filekey, fn-node); ambiguous → dropped
        self.modfuncs: Dict[str, Optional[Tuple[str, ast.FunctionDef]]] = {}
        #: method name → unique (classname, method) or None if ambiguous
        self.unique_methods: Dict[str, Optional[Tuple[str, str]]] = {}
        #: (classname, attr) → ClassName it holds
        self.attr_types: Dict[Tuple[str, str], str] = {}
        #: (classname, attr) → element ClassName (list/dict of)
        self.elem_types: Dict[Tuple[str, str], str] = {}
        for key, src in srcs.items():
            try:
                self.trees[key] = ast.parse(src.text)
            except SyntaxError as e:
                self.parse_errors.append(
                    Finding(src.path, e.lineno or 1, "parse-error", str(e)))
        for key, tree in self.trees.items():
            self._harvest_decls(key, tree)
        for key, tree in self.trees.items():
            self._harvest_types(key, tree)

    def _modbase(self, key: str) -> str:
        return Path(key).stem

    def _harvest_decls(self, key: str, tree: ast.AST) -> None:
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if isinstance(node, ast.Assign):
                re_ent = _lock_ctor(node.value)
                if re_ent is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            canon = f"{self._modbase(key)}.{tgt.id}"
                            self.locks[canon] = (re_ent, key, node.lineno)
                            if tgt.id in self.module_locks:
                                self.module_locks[tgt.id] = ""  # ambiguous
                            else:
                                self.module_locks[tgt.id] = canon
        for cls, fn in functions_of(tree):
            clsname = cls.name if cls is not None else None
            if clsname is None:
                prev = self.modfuncs.get(fn.name, "absent")
                self.modfuncs[fn.name] = ((key, fn) if prev == "absent"
                                          else None)
                continue
            self.classes.add(clsname)
            prev_m = self.methods.get((clsname, fn.name))
            if prev_m is None:
                self.methods[(clsname, fn.name)] = (key, fn)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.classes.add(node.name)
                for sub in ast.walk(node):
                    self._class_lock_decl(key, node.name, sub)

    def _class_lock_decl(self, key: str, clsname: str, sub: ast.AST) -> None:
        if isinstance(sub, ast.Assign):
            targets, value = sub.targets, sub.value
        elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
            targets, value = [sub.target], sub.value
        else:
            return
        re_ent = _lock_ctor(value)
        if re_ent is None:
            return
        for tgt in targets:
            attr = None
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and tgt.value.id == "self":
                attr = tgt.attr
            elif isinstance(tgt, ast.Name):
                attr = tgt.id
            if attr is not None:
                canon = f"{clsname}.{attr}"
                if canon not in self.locks:
                    self.locks[canon] = (re_ent, key, sub.lineno)
                    self.lock_owners.setdefault(attr, []).append(clsname)

    def _harvest_types(self, key: str, tree: ast.AST) -> None:
        for (clsname, _m), (k, fn) in list(self.methods.items()):
            if k != key:
                continue
            ann = {a.arg: self._ann_type(a.annotation)
                   for a in fn.args.args if a.annotation is not None}
            for node in walk_expr(fn):
                tgt_attr = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    t, value = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    t, value = node.target, node.value
                else:
                    continue
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    tgt_attr = t.attr
                elif isinstance(t, ast.Subscript) and \
                        isinstance(t.value, ast.Attribute) and \
                        isinstance(t.value.value, ast.Name) and \
                        t.value.value.id == "self":
                    # self.attr[k] = ClassName(...) → element type
                    elem = self._ctor_type(value)
                    if elem:
                        self.elem_types.setdefault(
                            (clsname, t.value.attr), elem)
                    continue
                if tgt_attr is None:
                    continue
                direct = self._ctor_type(value)
                if direct:
                    self.attr_types.setdefault((clsname, tgt_attr), direct)
                    continue
                elem = self._elem_ctor_type(value)
                if elem:
                    self.elem_types.setdefault((clsname, tgt_attr), elem)
                    continue
                if isinstance(value, ast.Name) and value.id in ann and ann[value.id]:
                    # self.journal = journal  (annotated param)
                    self.attr_types.setdefault(
                        (clsname, tgt_attr), ann[value.id])

    def _ann_type(self, ann: ast.AST) -> Optional[str]:
        if isinstance(ann, ast.Name) and ann.id in self.classes:
            return ann.id
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str) \
                and ann.value in self.classes:
            return ann.value
        if isinstance(ann, ast.Attribute) and ann.attr in self.classes:
            return ann.attr
        return None

    def _ctor_type(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call):
            name, _recv = _callee(value)
            if name in self.classes:
                return name
        return None

    def _elem_ctor_type(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, (ast.List, ast.Tuple, ast.Set)):
            for e in value.elts:
                t = self._ctor_type(e)
                if t:
                    return t
        if isinstance(value, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._ctor_type(value.elt)
        if isinstance(value, ast.DictComp):
            return self._ctor_type(value.value)
        return None

    def finish(self) -> None:
        for (clsname, m) in self.methods:
            prev = self.unique_methods.get(m, "absent")
            self.unique_methods[m] = ((clsname, m) if prev == "absent"
                                      else None)


# -------------------------------------------------------------- analysis


class _MethodScan:
    """Per-method facts: local types, direct acquisitions, calls."""

    def __init__(self, world: _World, key: str, clsname: Optional[str],
                 fn: ast.FunctionDef):
        self.world = world
        self.key = key
        self.cls = clsname
        self.fn = fn
        self.cfg = build_cfg(fn)
        self.held_dotted = lock_regions(self.cfg)
        self.local_types = self._local_types()

    def _local_types(self) -> Dict[str, str]:
        w, out = self.world, {}
        for a in self.fn.args.args:
            if a.annotation is not None:
                t = w._ann_type(a.annotation)
                if t:
                    out[a.arg] = t
        for node in walk_expr(self.fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                t = self._type_of(node.value, out)
                if t:
                    out[node.targets[0].id] = t
            if isinstance(node, (ast.For,)) and \
                    isinstance(node.target, ast.Name):
                t = self._iter_elem_type(node.iter, out)
                if t:
                    out[node.target.id] = t
        return out

    def _type_of(self, expr: ast.AST, env: Dict[str, str]) -> Optional[str]:
        w = self.world
        if isinstance(expr, ast.Name):
            if expr.id == "self":
                return self.cls
            return env.get(expr.id)
        if isinstance(expr, ast.Call):
            name, recv = _callee(expr)
            if name in w.classes:
                return name
            if name == "get" and recv is not None:
                base = self._type_of(recv, env)
                # dict-of-T lookup via typed attr
                if base is None and isinstance(recv, ast.Attribute):
                    owner = self._type_of(recv.value, env)
                    if owner:
                        return w.elem_types.get((owner, recv.attr))
            return None
        if isinstance(expr, ast.Attribute):
            owner = self._type_of(expr.value, env)
            if owner:
                return w.attr_types.get((owner, expr.attr))
            return None
        if isinstance(expr, ast.Subscript):
            if isinstance(expr.value, ast.Attribute):
                owner = self._type_of(expr.value.value, env)
                if owner:
                    return w.elem_types.get((owner, expr.value.attr))
            if isinstance(expr.value, ast.Name):
                return None
        return None

    def _iter_elem_type(self, it: ast.AST,
                        env: Dict[str, str]) -> Optional[str]:
        w = self.world
        if isinstance(it, ast.Attribute):
            owner = self._type_of(it.value, env)
            if owner:
                return w.elem_types.get((owner, it.attr))
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr in ("values", "copy", "list"):
            return self._iter_elem_type(it.func.value, env)
        return None

    # -- canonicalization -------------------------------------------

    def canon_lock_expr(self, expr: ast.AST) -> Optional[str]:
        w = self.world
        if isinstance(expr, ast.Name):
            canon = w.module_locks.get(expr.id)
            return canon or None
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            owner = self._type_of(expr.value, self.local_types)
            if owner and f"{owner}.{attr}" in w.locks:
                return f"{owner}.{attr}"
            owners = w.lock_owners.get(attr, [])
            if len(owners) == 1:
                return f"{owners[0]}.{attr}"
        return None

    def canon_dotted(self, dotted_name: str) -> Optional[str]:
        """Canonicalize a dotted lock name from lock_regions."""
        parts = dotted_name.split(".")
        if len(parts) == 1:
            return self.world.module_locks.get(parts[0]) or None
        env = self.local_types
        base: Optional[str]
        if parts[0] == "self":
            base = self.cls
        else:
            base = env.get(parts[0])
        for attr in parts[1:-1]:
            if base is None:
                break
            base = self.world.attr_types.get((base, attr))
        attr = parts[-1]
        if base and f"{base}.{attr}" in self.world.locks:
            return f"{base}.{attr}"
        owners = self.world.lock_owners.get(attr, [])
        if len(owners) == 1:
            return f"{owners[0]}.{attr}"
        return None

    def resolve_call(self, call: ast.Call
                     ) -> Optional[Tuple[Optional[str], str]]:
        """(classname-or-None, method) the call lands in, or None."""
        w = self.world
        name, recv = _callee(call)
        if not name:
            return None
        if recv is None:
            if name in w.classes and (name, "__init__") in w.methods:
                return (name, "__init__")
            mf = w.modfuncs.get(name)
            if mf:
                return (None, name)
            return None
        t = self._type_of(recv, self.local_types)
        if t is not None:
            if (t, name) in w.methods:
                return (t, name)
            return None  # typed receiver without such a method: not ours
        if name in _GENERIC:
            return None
        u = w.unique_methods.get(name)
        return u if u else None


def _method_key(cls: Optional[str], name: str, key: str):
    return (cls, name) if cls is not None else (f"mod:{key}", name)


def analyze_sources(srcs: Dict[str, SourceFile],
                    hierarchy: Optional[Sequence[str]] = HIERARCHY
                    ) -> List[Finding]:
    world = _World(srcs)
    world.finish()
    findings: List[Finding] = list(world.parse_errors)

    scans: Dict[Tuple, _MethodScan] = {}
    for (clsname, m), (key, fn) in world.methods.items():
        scans[_method_key(clsname, m, key)] = _MethodScan(
            world, key, clsname, fn)
    for name, entry in world.modfuncs.items():
        if entry:
            key, fn = entry
            scans[_method_key(None, name, key)] = _MethodScan(
                world, key, None, fn)

    # transitively-may-acquire fixpoint over the resolved call graph
    acq: Dict[Tuple, Set[str]] = {}
    calls: Dict[Tuple, List[Tuple]] = {}
    for mk, scan in scans.items():
        direct: Set[str] = set()
        callees: List[Tuple] = []
        for node in scan.cfg.nodes:
            for lock_expr_canon in (
                    scan.canon_lock_expr(it.context_expr)
                    for it in (node.stmt.items
                               if node.label == "with-enter" else [])):
                if lock_expr_canon:
                    direct.add(lock_expr_canon)
            for expr in own_exprs(node):
                for sub in walk_expr(expr):
                    if isinstance(sub, ast.Call):
                        r = scan.resolve_call(sub)
                        if r is not None:
                            cls_r, m_r = r
                            k = (world.methods[r][0] if cls_r is not None
                                 else world.modfuncs[m_r][0])
                            callees.append(_method_key(cls_r, m_r, k))
        acq[mk] = direct
        calls[mk] = callees
    changed = True
    while changed:
        changed = False
        for mk in scans:
            for callee in calls[mk]:
                extra = acq.get(callee, set()) - acq[mk]
                if extra:
                    acq[mk] |= extra
                    changed = True

    # edge collection: (src_lock, dst_lock) → (filekey, line, how)
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for mk, scan in scans.items():
        req: Set[str] = set()
        for name in fn_requires(srcs[scan.key], scan.fn):
            canon = scan.canon_dotted(f"self.{name}")
            if canon:
                req.add(canon)
        for node in scan.cfg.nodes:
            held = {c for c in (scan.canon_dotted(d)
                                for d in scan.held_dotted[node.idx]) if c}
            held |= req
            if not held:
                continue
            acquired_here: List[Tuple[str, str]] = []
            if node.label == "with-enter":
                for d in node_locks(node):
                    c = scan.canon_dotted(d)
                    if c:
                        acquired_here.append((c, "acquired directly"))
            for expr in own_exprs(node):
                for sub in walk_expr(expr):
                    if isinstance(sub, ast.Call):
                        r = scan.resolve_call(sub)
                        if r is None:
                            continue
                        cls_r, m_r = r
                        k = (world.methods[r][0] if cls_r is not None
                             else world.modfuncs[m_r][0])
                        label = (f"{cls_r}.{m_r}" if cls_r else m_r)
                        for c in acq.get(_method_key(cls_r, m_r, k), set()):
                            acquired_here.append(
                                (c, f"acquired via call to {label}()"))
            for c, how in acquired_here:
                for h in held:
                    if (h, c) not in edges:
                        edges[(h, c)] = (scan.key, node.line, how)

    # self-edges: reentrant locks may nest; others deadlock immediately
    graph: Dict[str, Set[str]] = {}
    for (a, b), (key, line, how) in sorted(edges.items()):
        if a == b:
            reentrant = world.locks.get(a, (False, "", 0))[0]
            if not reentrant:
                src = srcs[key]
                if not (src.allowed(line, RULE_CYCLE) or
                        src.allowed(line, "lock-order")):
                    findings.append(Finding(
                        src.path, line, RULE_CYCLE,
                        f"`{a}` is {how} while already held and is not "
                        "reentrant — this self-nesting deadlocks "
                        "unconditionally (move the inner acquisition "
                        "outside the region, or make the callee "
                        "# requires() the lock instead of taking it)"))
            continue
        graph.setdefault(a, set()).add(b)

    # cycle detection (iterative DFS, report each cycle once)
    color: Dict[str, int] = {}
    stack_path: List[str] = []
    reported_cycles: Set[frozenset] = set()

    def dfs(start: str) -> None:
        stack = [(start, iter(sorted(graph.get(start, ()))))]
        color[start] = 1
        stack_path.append(start)
        while stack:
            node, it = stack[-1]
            advanced = False
            for nxt in it:
                if color.get(nxt, 0) == 1:
                    cyc = stack_path[stack_path.index(nxt):] + [nxt]
                    key_c = frozenset(cyc)
                    if key_c not in reported_cycles:
                        reported_cycles.add(key_c)
                        fk, line, how = edges[(node, nxt)]
                        src = srcs[fk]
                        if not (src.allowed(line, RULE_CYCLE) or
                                src.allowed(line, "lock-order")):
                            findings.append(Finding(
                                src.path, line, RULE_CYCLE,
                                "lock-order cycle "
                                + " -> ".join(cyc)
                                + f" (closing edge here: `{nxt}` {how} "
                                  f"while `{node}` is held) — two threads "
                                  "taking these in opposite orders "
                                  "deadlock; restructure so acquisitions "
                                  "follow the §18 hierarchy"))
                elif color.get(nxt, 0) == 0:
                    color[nxt] = 1
                    stack_path.append(nxt)
                    stack.append((nxt, iter(sorted(graph.get(nxt, ())))))
                    advanced = True
                    break
            if not advanced:
                color[node] = 2
                stack_path.pop()
                stack.pop()

    for start in sorted(graph):
        if color.get(start, 0) == 0:
            dfs(start)

    # hierarchy conformance
    if hierarchy is not None:
        rank = {name: i for i, name in enumerate(hierarchy)}
        unranked_seen: Set[str] = set()
        for lock, (_re, key, line) in sorted(world.locks.items()):
            if lock not in rank and lock not in unranked_seen:
                unranked_seen.add(lock)
                src = srcs[key]
                if not (src.allowed(line, RULE_RANK) or
                        src.allowed(line, "lock-order")):
                    findings.append(Finding(
                        src.path, line, RULE_RANK,
                        f"lock `{lock}` is not in the pinned hierarchy — "
                        "add it to lockorder.HIERARCHY and the §18 table "
                        "at the level its acquisitions demand"))
        for (a, b), (key, line, how) in sorted(edges.items()):
            if a == b or a not in rank or b not in rank:
                continue
            if rank[a] >= rank[b]:
                src = srcs[key]
                if not (src.allowed(line, RULE_ORDER) or
                        src.allowed(line, "lock-order")):
                    findings.append(Finding(
                        src.path, line, RULE_ORDER,
                        f"`{b}` {how} while `{a}` is held, but the pinned "
                        f"hierarchy orders `{b}` (level {rank[b]}) at or "
                        f"above `{a}` (level {rank[a]}) — either release "
                        "the outer lock first or re-pin the hierarchy in "
                        "lockorder.HIERARCHY + checker-design.md §18"))
    return findings


def analyze_source(src: SourceFile) -> List[Finding]:
    """Single-source entry (fixtures/mutation tests): the whole
    'package' is this one file."""
    return analyze_sources({Path(src.path).name or "mod.py": src})


def analyze_file(path) -> List[Finding]:
    p = Path(path)
    srcs = {f.name: SourceFile.load(f)
            for f in sorted(p.parent.glob("*.py"))}
    return analyze_sources(srcs)
