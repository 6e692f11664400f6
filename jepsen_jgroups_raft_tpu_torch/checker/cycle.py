"""Exact dependency-cycle refutation tier (the port's copy of the
reference's checker/cycle.py).

The weaker-consistency rungs (checker/consistency.py) are interval-order
*relaxations*: a rung PASS certifies its guarantee, but a rung FAIL only
certifies non-linearizability. This module adds the exact *refutation*
direction: build the dependency graph whose edges every
sequentially-consistent execution must respect; a cycle in it is a
witness-carrying proof that NO sequential order exists.

Graph construction (register-shaped, via ``Model.rw_classify`` — the
hook's contract is last-writer-wins state, models/base.py):

  * **Required ops** — forced (ok-completed) ops always linearize. An
    optional (crashed) op is pulled in only when it is the UNIQUE writer
    of a value some required reader observed, fixed-pointed across
    chains of optional CASes. All other optional ops are excluded.
  * **SO** (session order): consecutive required ops of one process, in
    open order.
  * **WR** (reads-from): reader r observed v (≠ the initial value) and
    exactly ONE op w in the whole encoded history writes v ⇒ w → r.
  * **RW** (anti-dependency): r reads v from unique writer w, and w' is a
    required writer whose order after w is KNOWN (same process as w,
    later open) ⇒ r → w'.
  * **Reads-of-initial**: r observed the initial value and NO op writes
    it ⇒ r → every required writer.

Each edge holds in every legal sequential execution of the required
ops, so a cycle at the *sequential* rung means the rung's kernels must
answer INVALID too, and the tier decides the row first (`"decided-tier":
"cycle"`). At the *session* rung (monotonic reads + read-your-writes,
which does not imply sequential consistency) a cycle is attached as an
``sc-refuted`` annotation instead of a verdict.

Execution: graphs batch by pow2+midpoint node bucket; per bucket the arm
is condensation (host Tarjan, the default), the closure kernels of
ops/cycle_closure.py (B7 up to 512 nodes, B8 above; their plain versions
on a CPU device) or the host DFS — every arm verdict-identical.
``JGRAFT_CYCLE_KERNEL`` forces the direct arm's launch routing (1 the
kernel, 0 the DFS); unset, the kernel runs where the device is CUDA.
Knobs, with the reference's names and meanings: ``JGRAFT_CYCLE_TIER``,
``JGRAFT_CYCLE_KERNEL``, ``JGRAFT_CYCLE_TILE``, ``JGRAFT_CYCLE_CONDENSE``,
``JGRAFT_CYCLE_MAX_OPS``.
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, Optional, Sequence

import numpy as np

from ..history.packing import EV_FORCE, EV_OPEN, EncodedHistory
from ..ops.kernel_ir import (CYCLE_MAX_NODES, CYCLE_MAX_NODES_TILED,
                             CYCLE_TILE, cycle_closure_tile,
                             cycle_closure_tiles)
from ..platform import env_int, resolve_device


def cycle_tier_on() -> bool:
    """Whether the exact cycle tier runs at the weak rungs
    (JGRAFT_CYCLE_TIER=0 disables — the ablation arm; verdicts must be
    identical either way at the sequential rung, pinned by tests)."""
    return env_int("JGRAFT_CYCLE_TIER", 1, minimum=0) != 0


def cycle_tile() -> int:
    """Tile edge for the blocked closure kernel (JGRAFT_CYCLE_TILE,
    default ops/kernel_ir.CYCLE_TILE; 0 disables the tiled path — the
    ablation arm that reproduces the 512-cap tier, including its lower
    default node cap). Routing only: every arm is verdict-identical."""
    return env_int("JGRAFT_CYCLE_TILE", CYCLE_TILE, minimum=0)


def cycle_max_ops() -> int:
    """Per-row node cap (JGRAFT_CYCLE_MAX_OPS): rows whose required-op
    graph is bigger skip the tier — the kernel ladder still decides
    them, so the cap only moves work, never answers, and the skip
    leaves a trace (the cycle-skipped-size annotation and counter).
    Default is the blocked-closure cap (CYCLE_MAX_NODES_TILED
    = 4096) when the tiled kernel is enabled, the monolithic
    CYCLE_MAX_NODES = 512 when JGRAFT_CYCLE_TILE=0."""
    cap = CYCLE_MAX_NODES_TILED if cycle_tile() > 0 else CYCLE_MAX_NODES
    return env_int("JGRAFT_CYCLE_MAX_OPS", cap, minimum=1)


def _condense_env() -> Optional[bool]:
    """JGRAFT_CYCLE_CONDENSE force: True/False when set, None when the
    arm is left to the measured per-bucket choice (default: condense —
    the host Tarjan pre-pass is O(V+E) and decides plain cyclicity
    outright). =0 is the ablation arm: the direct path."""
    if os.environ.get("JGRAFT_CYCLE_CONDENSE") is None:
        return None
    return env_int("JGRAFT_CYCLE_CONDENSE", 1, minimum=0) != 0


def _use_kernel(dev) -> bool:
    """Closure-kernel routing: JGRAFT_CYCLE_KERNEL=1/0 forces the arm
    (tests, ablation); unset, the kernel runs where the device is CUDA
    and the O(V+E) host DFS elsewhere."""
    forced = os.environ.get("JGRAFT_CYCLE_KERNEL")
    if forced is not None:
        return forced == "1"
    return dev is not None and dev.type == "cuda"


# ------------------------------------------------------ graph building


def build_sc_graph(enc: EncodedHistory, model,
                   want_planes: bool = False) -> Optional[dict]:
    """Dependency graph of one encoded history, or None when the model
    cannot classify an op / the encoding has no per-event process ids.
    Returns {"n", "adj" ([n, n] uint8), "op_index" (node → original
    history op index)} — or, when the required-op count exceeds the
    cap, the skip marker {"skipped-nodes": count} so callers can stamp
    the previously-silent size skip (``"adj" in g`` distinguishes).

    With ``want_planes`` the result also carries ``"planes"``: the
    edge-class-labeled adjacency submatrices the transactional anomaly
    rung (checker/anomaly.py) closes over — ``po`` (session order),
    ``wr`` (reads-from), ``ww`` (write-version order: a reads-from
    edge into an op that itself writes — the reader installs the
    successor version, so the writers are version-ordered), ``rw``
    (anti-dependency + reads-of-initial).  adj is exactly the union of
    the planes; plane extraction never adds or drops an edge."""
    classify = getattr(model, "rw_classify", None)
    if classify is None or enc.proc is None or enc.n_events == 0:
        return None
    events = enc.events
    ops: List[tuple] = []   # (f, a, b, pid, hist_index)
    forced: List[bool] = []
    active: dict = {}
    for pos in range(enc.n_events):
        et, slot = int(events[pos, 0]), int(events[pos, 1])
        if et == EV_OPEN:
            active[slot] = len(ops)
            ops.append((int(events[pos, 2]), int(events[pos, 3]),
                        int(events[pos, 4]), int(enc.proc[pos]),
                        int(enc.op_index[pos])))
            forced.append(False)
        elif et == EV_FORCE:
            forced[active.pop(slot)] = True
    cls: List[tuple] = []
    for f, a, b, _pid, _hi in ops:
        c = classify(f, a, b)
        if c is None:
            return None  # one unclassifiable op poisons every edge
        cls.append(c)

    def read_of(k):
        c = cls[k]
        return c[1] if c[0] in ("r", "rw") else None

    def write_of(k):
        c = cls[k]
        return c[2] if c[0] == "rw" else (c[1] if c[0] == "w" else None)

    initial = model.init_state()
    writers: dict = {}
    for k in range(len(ops)):
        wv = write_of(k)
        if wv is not None:
            writers.setdefault(wv, []).append(k)

    # required = forced ∪ (unique writers of required-observed values),
    # to a fixpoint across optional CAS chains
    required = {k for k in range(len(ops)) if forced[k]}
    wr_edges = set()
    frontier = list(required)
    while frontier:
        nxt = []
        for r in frontier:
            rv = read_of(r)
            if rv is None or rv == initial:
                continue
            ws = writers.get(rv, [])
            if len(ws) == 1 and ws[0] != r:
                w = ws[0]
                wr_edges.add((w, r))
                if w not in required:
                    required.add(w)
                    nxt.append(w)
        frontier = nxt
    if len(required) > cycle_max_ops():
        return {"skipped-nodes": len(required)}

    order = sorted(required)               # open order
    node = {k: i for i, k in enumerate(order)}
    n = len(order)
    adj = np.zeros((n, n), dtype=np.uint8)
    planes = {c: np.zeros((n, n), dtype=np.uint8)
              for c in ("po", "ww", "wr", "rw")} if want_planes else None

    def edge(cls_name, u, v):
        adj[u, v] = 1
        if planes is not None:
            planes[cls_name][u, v] = 1

    # SO: consecutive required ops per process
    last_of: dict = {}
    for k in order:
        pid = ops[k][3]
        if pid in last_of:
            edge("po", node[last_of[pid]], node[k])
        last_of[pid] = k
    req_writers = [k for k in order if write_of(k) is not None]
    for w, r in wr_edges:
        edge("wr", node[w], node[r])
        if cls[r][0] == "rw":
            # the reader writes too (CAS-shaped): it installs the
            # version right after w's — a known write-order pair
            edge("ww", node[w], node[r])
        # RW: r must precede every overwrite whose order after w is
        # known (same process as w, opened later)
        for w2 in req_writers:
            if w2 != w and w2 != r and ops[w2][3] == ops[w][3] \
                    and w2 > w:
                edge("rw", node[r], node[w2])
    # reads-of-initial: no op writes the initial value ⇒ the reader
    # precedes every required writer
    if not writers.get(initial):
        for r in order:
            if read_of(r) == initial:
                for w2 in req_writers:
                    if w2 != r:
                        edge("rw", node[r], node[w2])
    np.fill_diagonal(adj, 0)
    out = {"n": n, "adj": adj,
           "op_index": [ops[k][4] for k in order]}
    if planes is not None:
        for p in planes.values():
            np.fill_diagonal(p, 0)
        out["planes"] = planes
    return out


# ------------------------------------------------------ cycle detection


def host_has_cycle(adj: np.ndarray) -> bool:
    """Iterative 3-color DFS over a dense adjacency matrix — the host
    oracle the closure kernels are held to, and the direct arm off the
    card."""
    n = int(adj.shape[0])
    color = np.zeros(n, dtype=np.int8)  # 0 white, 1 gray, 2 black
    succ = [np.flatnonzero(adj[i]) for i in range(n)]
    for root in range(n):
        if color[root]:
            continue
        stack = [(root, 0)]
        color[root] = 1
        while stack:
            v, j = stack[-1]
            if j < len(succ[v]):
                stack[-1] = (v, j + 1)
                w = int(succ[v][j])
                if color[w] == 1:
                    return True
                if color[w] == 0:
                    color[w] = 1
                    stack.append((w, 0))
            else:
                color[v] = 2
                stack.pop()
    return False


def cycle_witness(adj: np.ndarray) -> Optional[List[int]]:
    """One concrete cycle (node list, closed implicitly) from a cyclic
    adjacency matrix: shortest cycle through the first node that can
    reach itself (BFS) — small, checkable evidence for the result
    record."""
    n = int(adj.shape[0])
    for start in range(n):
        # BFS from start's successors back to start
        prev = np.full(n, -1, dtype=np.int64)
        q = []
        for s in np.flatnonzero(adj[start]):
            prev[int(s)] = start
            q.append(int(s))
        qi = 0
        while qi < len(q):
            v = q[qi]
            qi += 1
            if adj[v, start]:
                # path start → ... → v (→ start implicitly)
                path = [v]
                while path[-1] != start:
                    path.append(int(prev[path[-1]]))
                path.reverse()
                return path
            for w in np.flatnonzero(adj[v]):
                w = int(w)
                if prev[w] < 0:
                    prev[w] = v
                    q.append(w)
    return None


def tarjan_scc(adj: np.ndarray) -> List[List[int]]:
    """Strongly connected components of a dense adjacency matrix —
    host ITERATIVE Tarjan (explicit work stack; the required-op graphs
    now reach 4096 nodes, far past Python's recursion limit).
    Components come out in reverse topological order of the condensed
    DAG.  This is the condensation pre-pass oracle: a component of
    size ≥ 2 contains a cycle (two mutually-reachable nodes), and any
    dependency cycle lies entirely inside one component — so
    "non-trivial SCC exists" ⇔ "cycle exists", with no kernel launch
    (the reference's doc/checker-design.md §21)."""
    n = int(adj.shape[0])
    succ = [np.flatnonzero(adj[i]).tolist() for i in range(n)]
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: List[int] = []
    comps: List[List[int]] = []
    counter = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            descended = False
            for i in range(pi, len(succ[v])):
                w = succ[v][i]
                if index[w] == -1:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    descended = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if descended:
                continue
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                comps.append(comp)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return comps


#: Bytes of bit rows per closure launch: a bucket's graphs go to the
#: card in chunks of at most this many bytes (and 65535 graphs).
_LAUNCH_BYTES = 256 << 20


def _closure_run(N: int, tile: Optional[int], graphs: List[np.ndarray],
                 dev, want_closed: bool = False):
    """Close a bucket's graphs ([n, n] 0/1 arrays, n ≤ N): bit-packed on
    the host, closed by `ops.cycle_closure.cycle_closure_bits` on `dev`
    (the kernel on the card, its plain version on the CPU). Returns
    (has_cycle [B] bool, closed [B, N, N] uint8 or None)."""
    import torch

    from ..ops.cycle_closure import (cycle_closure_bits, pack_adjacency,
                                     unpack_adjacency, words_per_row)

    per = max(1, min(65535, _LAUNCH_BYTES // (N * words_per_row(N) * 4)))
    has_all, closed_all = [], []
    for s in range(0, len(graphs), per):
        bits = torch.from_numpy(pack_adjacency(graphs[s:s + per], N))
        has, closed = cycle_closure_bits(bits.to(dev), N, tile,  # lint: allow(host-sync) a chunk's adjacency bits go up (pageable)
                                         want_closed)
        has_all.append(has.cpu().numpy())  # lint: allow(host-sync) the closure's verdicts, once a launch chunk
        if want_closed:
            closed_all.append(unpack_adjacency(closed.cpu().numpy(), N))  # lint: allow(host-sync) the closed rows the host's witness search reads
    has = np.concatenate(has_all) if has_all else np.zeros(0, dtype=bool)
    return has, (np.concatenate(closed_all) if want_closed else None)


def closure_fn(n_bucket: int):
    """The closure for a node bucket, with its tile-program count for
    the cycle_tiles_run counter: the monolithic closure (B7) up to
    CYCLE_MAX_NODES (one "tile"), the blocked one (B8) above it (when
    JGRAFT_CYCLE_TILE > 0), None past the enabled cap — callers fall
    back to the host DFS. The closure is ``fn(graphs, dev,
    want_closed=False)`` (see `_closure_run`)."""
    if n_bucket <= CYCLE_MAX_NODES:
        return functools.partial(_closure_run, n_bucket, None), 1
    t = cycle_tile()
    if t <= 0 or n_bucket > CYCLE_MAX_NODES_TILED:
        return None, 0
    t = cycle_closure_tile(n_bucket, t)
    return (functools.partial(_closure_run, n_bucket, t),
            cycle_closure_tiles(n_bucket, t))


def _condense_detect(g: dict) -> Optional[dict]:
    """Condensation arm for one graph: Tarjan decides cyclicity
    outright — a non-trivial SCC is an immediate cycle verdict (the
    witness search runs inside that component only), no SCC ⇒ acyclic,
    and either way no kernel launches. Counters: nodes_post is the
    condensed-DAG size (number of components), scc_hits the number of
    non-trivial components."""
    from .schedule import note_cycle

    comps = tarjan_scc(g["adj"])
    nontrivial = [c for c in comps if len(c) >= 2]
    note_cycle(cycle_nodes_post=len(comps),
               cycle_scc_hits=len(nontrivial))
    if not nontrivial:
        return None
    comp = sorted(min(nontrivial, key=min))   # deterministic pick
    sub = g["adj"][np.ix_(comp, comp)]
    path = cycle_witness(sub) or []
    return {"cycle": [g["op_index"][comp[v]] for v in path],
            "nodes": g["n"]}


def _direct_flags(rows: List[tuple], N: int, use_kernel: bool,
                  dev=None) -> dict:
    """Direct arm over one bucket's graphs: batched closure launch or
    per-graph host DFS.  Returns {row index: has_cycle}."""
    from .schedule import note_cycle

    kfn = tiles = None
    if use_kernel:
        kfn, tiles = closure_fn(N)
    if kfn is not None:
        has, _closed = kfn([g["adj"] for _i, g in rows], dev)
        if tiles > 1:
            note_cycle(cycle_tiles_run=tiles)
        return {i: bool(has[j]) for j, (i, _g) in enumerate(rows)}
    return {i: host_has_cycle(g["adj"]) for i, g in rows}


def _bucket_arm(N: int, rows: List[tuple], kernel: Optional[bool],
                dev=None) -> str:
    """Arm choice for one node bucket: "condense" | "kernel" | "dfs".

    Precedence: a JGRAFT_CYCLE_CONDENSE force wins; otherwise forcing
    the direct arm explicitly (the `kernel` parameter or
    JGRAFT_CYCLE_KERNEL) is a request to EXERCISE that arm — tests and
    ablations pin the kernel/DFS differential through here, and the
    condensation pre-pass would shadow it.  With nothing forced the
    measured per-bucket arm applies (checker/autotune.py cycle-arm
    store, resolved on first contact once the bucket carries enough
    work to time honestly), defaulting to condensation.  Every arm is
    verdict-identical, so this is routing only."""
    forced_cond = _condense_env()
    env_kern = os.environ.get("JGRAFT_CYCLE_KERNEL")
    if forced_cond is True:
        return "condense"
    direct_kernel = kernel if kernel is not None else _use_kernel(dev)
    if forced_cond is False or kernel is not None or env_kern is not None:
        return "kernel" if direct_kernel else "dfs"
    from . import autotune

    if autotune.autotune_on():
        sig = autotune.cycle_arm_sig(N)
        arm = autotune.cycle_arm_for(sig)
        if arm is None and N * N * len(rows) >= autotune.min_cells():
            arm = autotune.resolve_cycle_arm(
                sig, _arm_measures(N, rows, direct_kernel, dev))
        if arm is not None:
            if arm == "kernel" and (not direct_kernel
                                    or closure_fn(N)[0] is None):
                arm = "dfs"
            return arm
    return "condense"


def _arm_measures(N: int, rows: List[tuple], allow_kernel: bool,
                  dev=None) -> dict:
    """Zero-arg wall-second measurements over the bucket's real graphs
    for the autotuner's interleaved resolve. The kernel arm is offered
    only where a kernel exists for the bucket (and the caller hasn't
    vetoed launches)."""
    def timed(fn):
        def run():
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        return run

    measures = {
        "condense": timed(lambda: [tarjan_scc(g["adj"])
                                   for _i, g in rows]),
        "dfs": timed(lambda: [host_has_cycle(g["adj"])
                              for _i, g in rows]),
    }
    if allow_kernel and closure_fn(N)[0] is not None:
        measures["kernel"] = timed(
            lambda: _direct_flags(rows, N, use_kernel=True, dev=dev))
    return measures


def find_cycles(encs: Sequence[EncodedHistory], model,
                kernel: Optional[bool] = None, device=None
                ) -> List[Optional[dict]]:
    """Per row: None (no graph / acyclic), {"cycle": [history op
    indices...], "nodes": n} — an exact SC refutation witness — or
    {"skipped-size": n} when the required-op graph exceeds
    cycle_max_ops() (stamped and counted; callers test ``"cycle" in
    c``).  Graphs batch by pow2-bucketed node count; per bucket the arm
    is condensation (host Tarjan — the default), the batched closure
    kernel (B7 ≤ 512 nodes, B8 above), or the host DFS — forced by
    JGRAFT_CYCLE_CONDENSE / JGRAFT_CYCLE_KERNEL, measured per bucket
    otherwise (identical answers every way).  `kernel` overrides the
    launch routing (False = no kernel even on the card, and no device is
    resolved); `device` is where the kernel arm runs (None: the card,
    through `platform.resolve_device`; "cpu": the plain versions)."""
    from ..history.packing import bucket_rows
    from .schedule import note_cycle

    dev = None if kernel is False else resolve_device(device)
    out: List[Optional[dict]] = [None] * len(encs)
    built = []
    skipped = 0
    for i, enc in enumerate(encs):
        g = build_sc_graph(enc, model)
        if g is None:
            continue
        if "adj" not in g:
            out[i] = {"skipped-size": g["skipped-nodes"]}
            skipped += 1
        elif g["n"] >= 2:
            built.append((i, g))
    if skipped:
        note_cycle(cycle_size_skips=skipped)
    if not built:
        return out
    note_cycle(cycle_nodes_pre=sum(g["n"] for _i, g in built))
    by_bucket: dict = {}
    for i, g in built:
        by_bucket.setdefault(bucket_rows(g["n"], 4), []).append((i, g))
    for N, rows in by_bucket.items():
        arm = _bucket_arm(N, rows, kernel, dev)
        if arm == "condense":
            for i, g in rows:
                out[i] = _condense_detect(g)
            continue
        flags = _direct_flags(rows, N, use_kernel=(arm == "kernel"),
                              dev=dev)
        for i, g in rows:
            if flags.get(i):
                path = cycle_witness(g["adj"]) or []
                out[i] = {"cycle": [g["op_index"][v] for v in path],
                          "nodes": g["n"]}
    return out
