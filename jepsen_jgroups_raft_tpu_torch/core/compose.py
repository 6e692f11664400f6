"""Test composition: merge DB + workload + nemesis + checkers + the phased
generator into a runnable test map.

Equivalent of the reference's `raft-tests` (raft.clj:54-92):
  * workload by name from the registry (raft.clj:63, workload.clj:10-15),
  * nemesis package from the fault spec (raft.clj:62, nemesis.clj:48-58),
  * shared mutable membership set (raft.clj:70),
  * composed checker {perf, exceptions, stats, workload} (raft.clj:73-77),
  * the phased schedule (raft.clj:78-91):
      1. main phase: staggered client ops interleaved with the nemesis
         schedule (first nemesis op delayed `interval`), bounded by
         `time_limit`;
      2. heal log + 10 s quiesce;
      3. nemesis final generator (heal partitions / restart killed /
         re-grow membership);
      4. 10 s quiesce;
      5. workload final generator (slot exists; no stock workload defines
         one — same as the reference).
  * quorum_reads = not stale_reads (raft.clj:92).

The port's copy resolves the checking device once
(`platform.resolve_device`: the card unless ``device`` names another; no
card and no ``"cpu"`` raises before any workload is built) and threads
it into the workload's options, so every checker the workload builds
runs there. A ``seed`` (the option, or this function's argument when the
option is absent) seeds the workload's op draws and the stagger's gaps,
as it seeds the nemesis schedule; with none, both are drawn from
unseeded generators, as in the reference.
"""

from __future__ import annotations

import random
from typing import Optional

from ..checker.base import compose as compose_checkers
from ..checker.perf import PerfChecker
from ..checker.stats import StatsChecker, UnhandledExceptionsChecker
from ..generator.base import (
    Any,
    Clients,
    Delay,
    Log,
    NemesisGen,
    Phases,
    Seq,
    Sleep,
    Stagger,
    TimeLimit,
)
from ..nemesis.package import setup_nemesis
from ..platform import resolve_device
from ..workload import WORKLOADS

DEFAULTS = {
    # reference cli-opts (raft.clj:14-51)
    "rate": 10.0,              # ops/sec across the run's stagger
    "ops_per_key": 100,
    "workload": "single-register",
    "nemesis": None,
    "interval": 5.0,           # seconds between nemesis ops
    "operation_timeout": 10.0,
    "stale_reads": False,
    "time_limit": 60.0,
    "concurrency": 10,
    "quiesce": 10.0,
}


def compose_test(opts: dict, db=None, net=None,
                 seed: Optional[int] = None) -> dict:
    """Build a runnable test map from options (reference raft-tests)."""
    o = {**DEFAULTS, **opts}
    nodes = list(o.get("nodes") or [f"n{i}" for i in range(1, 6)])
    o["nodes"] = nodes
    workload_name = o["workload"]
    try:
        wl_ctor = WORKLOADS[workload_name]
    except KeyError:
        raise ValueError(
            f"unknown workload {workload_name!r}; valid: {sorted(WORKLOADS)}")
    o["device"] = resolve_device(o.get("device"))
    if o.get("seed") is None:
        o["seed"] = seed
    wl = wl_ctor(o)

    db = db if db is not None else o.get("db")
    net = net if net is not None else o.get("net")
    if o.get("nemesis") is None and wl.get("suggested_nemesis"):
        # Paired fault schedule: a workload may name
        # the schedule that actually stresses it (set → membership churn
        # during the fill, queue → partition during the drain); an
        # explicit --nemesis (including "none") always wins.
        o["nemesis"] = wl["suggested_nemesis"]
    pkg = setup_nemesis(o, db, net, seed=o["seed"])

    client_gen = Stagger(1.0 / float(o["rate"]), wl["generator"],
                         rng=random.Random(None if o["seed"] is None
                                           else f"stagger:{o['seed']}"))
    # First nemesis op delayed by `interval` (raft.clj:81-84); spacing
    # between subsequent ops is owned by each package's Delay.
    main = Any(
        Clients(client_gen),
        NemesisGen(Seq([Sleep(float(o["interval"])), pkg.generator]))
        if pkg.generator is not None else None,
    )
    if o.get("time_limit"):
        main = TimeLimit(float(o["time_limit"]), main)

    quiesce = float(o["quiesce"])
    phases = [main, Log("healing cluster"), Sleep(quiesce)]
    if pkg.final_generator is not None:
        phases.append(NemesisGen(
            TimeLimit(60.0, pkg.final_generator)))
    phases.append(Sleep(quiesce))
    if wl.get("final_generator") is not None:
        phases.append(Clients(wl["final_generator"]))
    gen = Phases(*phases)

    checker = compose_checkers({
        "perf": PerfChecker(render=o.get("render_plots", True),
                            nemeses=pkg.perf),
        "exceptions": UnhandledExceptionsChecker(),
        "stats": StatsChecker(),
        "workload": wl["checker"],
    })

    return {
        "name": o.get("name", f"jgraft-{workload_name}"),
        "nodes": nodes,
        "concurrency": int(o["concurrency"]),
        "client": wl["client"],
        "nemesis": pkg.nemesis,
        "generator": gen,
        "checker": checker,
        "db": db,
        "members": set(nodes),        # the shared membership atom
        "idempotent": wl.get("idempotent", set()),
        "quorum_reads": not o.get("stale_reads", False),
        "store": o.get("store", True),
        "store_root": o.get("store_root", "store"),
        "opts": o,
    }
