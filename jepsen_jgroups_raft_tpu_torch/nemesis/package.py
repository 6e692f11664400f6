"""Nemesis packages: fault schedules bundled with their nemeses.

Equivalent of jepsen.nemesis.combined's packages as the reference composes
them (nemesis.clj:24-58): a package = nemesis + main-phase generator +
final (healing) generator + perf annotation. `setup_nemesis` parses the
fault spec (``partition,kill`` / ``all`` / ``hell`` / ``none``,
nemesis.clj:8-29), builds one package per fault, and composes them.

Schedule shape mirrors the combined packages: each fault alternates
inject/heal (FlipFlop) with ≥interval seconds between ops (Delay), target
kinds drawn per-op from the reference's victim-class lists
(nemesis.clj:48-58).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..generator.base import (Delay, FlipFlop, Generator, Mix, OpFn, Seq,
                              Sleep)
from .base import Nemesis, NoopNemesis, compose_nemeses
from .faults import KillNemesis, PartitionNemesis, PauseNemesis
from .membership import GrowUntilFull, MemberNemesis
from .targets import NODE_TARGETS, PARTITION_TARGETS

FAULTS = ("pause", "kill", "partition", "member")
SPECIALS = {
    "none": (),
    "all": ("pause", "kill", "partition"),
    # member+kill can legitimately wedge the cluster (a majority of the
    # *current* membership can be dead) — same caveat as nemesis.clj:18-22.
    "hell": ("pause", "kill", "partition", "member"),
}

#: Workload-paired schedules: named fault schedules
#: tuned to what actually stresses a scenario, selectable like faults
#: (--nemesis set-churn) and auto-suggested by their workloads
#: (core/compose.py). Each rides the existing nemeses — so the PR-2
#: fault↔heal pairing analyzer's guarantees carry over unchanged.
SCHEDULES = ("set-churn", "queue-drain")


def parse_nemesis_spec(spec) -> tuple:
    """Comma-separated fault list or special name -> fault tuple
    (nemesis.clj:24-29)."""
    if spec is None:
        return ()
    if isinstance(spec, (list, tuple, set, frozenset)):
        faults = tuple(spec)
    else:
        s = str(spec).strip()
        if s in SPECIALS:
            return SPECIALS[s]
        faults = tuple(f.strip() for f in s.split(",") if f.strip())
    for f in faults:
        if f in SPECIALS and len(faults) == 1:
            return SPECIALS[f]
        if f not in FAULTS and f not in SCHEDULES:
            raise ValueError(
                f"unknown fault {f!r}; valid: {FAULTS}, schedules "
                f"{SCHEDULES}, or {tuple(SPECIALS)}")
    return faults


#: per-fault completion-ambiguity pressure at the reference interval
#: (5s): how strongly each fault turns live client ops into crashed
#: (info) ops in a recorded history. kill/partition sever clients
#: mid-op; pause merely delays; schedules churn specific workloads.
_FAULT_PRESSURE = {
    "kill": 0.08,
    "partition": 0.06,
    "pause": 0.03,
    "member": 0.05,
    "set-churn": 0.08,
    "queue-drain": 0.06,
}


def schedule_pressure(spec, interval: float) -> dict:
    """Map a nemesis spec + firing interval onto synthetic-history
    pressure: offline scenario search can't run the live
    fault injectors, but the *observable* effect of a schedule on a
    history is its crashed-op density — each fault contributes its
    reference pressure scaled by firing rate (5.0/interval), capped so
    the generator's concurrency window stays checkable. Returns
    {"crash_bias": float, "crash_burst": int} for
    `history/synth.random_valid_history`'s crash_p / max_crashes."""
    faults = parse_nemesis_spec(spec)
    rate = 5.0 / max(0.5, float(interval))
    bias = sum(_FAULT_PRESSURE.get(f, 0.04) for f in faults) * rate
    return {"crash_bias": round(min(0.4, bias), 4),
            "crash_burst": min(4, len(faults))}


@dataclass
class Package:
    """One fault's bundle (jepsen.nemesis.combined package map)."""

    nemesis: Nemesis
    generator: Optional[Generator] = None
    final_generator: Optional[Generator] = None
    #: perf-plot annotations, each {"name", "start" fs, "stop" fs,
    #: "color"} — uniformly a list so composition is concatenation.
    perf: list = field(default_factory=list)


def _targeted(f: str, kinds: Sequence[str], rng: random.Random) -> OpFn:
    return OpFn(lambda test, ctx: {"f": f, "value": rng.choice(list(kinds))})


def partition_package(opts: dict, db, net,
                      rng: random.Random) -> Package:
    interval = float(opts.get("interval", 5.0))
    gen = Delay(interval, FlipFlop(
        _targeted("start-partition", PARTITION_TARGETS, rng),
        OpFn(lambda test, ctx: {"f": "stop-partition"})))
    return Package(
        nemesis=PartitionNemesis(net, db, seed=rng.randrange(2**31)),
        generator=gen,
        final_generator=Seq([{"f": "stop-partition"}]),
        perf=[{"name": "partition", "start": {"start-partition"},
               "stop": {"stop-partition"}, "color": "#E9A447"}],
    )


def kill_package(opts: dict, db, rng: random.Random) -> Package:
    interval = float(opts.get("interval", 5.0))
    gen = Delay(interval, FlipFlop(
        _targeted("kill", NODE_TARGETS, rng),
        OpFn(lambda test, ctx: {"f": "restart"})))
    return Package(
        nemesis=KillNemesis(db, seed=rng.randrange(2**31)),
        generator=gen,
        final_generator=Seq([{"f": "restart", "value": "all"}]),
        perf=[{"name": "kill", "start": {"kill"}, "stop": {"restart"},
               "color": "#E0584F"}],
    )


def pause_package(opts: dict, db, rng: random.Random) -> Package:
    interval = float(opts.get("interval", 5.0))
    gen = Delay(interval, FlipFlop(
        _targeted("pause", NODE_TARGETS, rng),
        OpFn(lambda test, ctx: {"f": "resume"})))
    return Package(
        nemesis=PauseNemesis(db, seed=rng.randrange(2**31)),
        generator=gen,
        final_generator=Seq([{"f": "resume", "value": "all"}]),
        perf=[{"name": "pause", "start": {"pause"}, "stop": {"resume"},
               "color": "#6A51A3"}],
    )


def member_package(opts: dict, db, rng: random.Random) -> Package:
    interval = float(opts.get("interval", 5.0))
    gen = Delay(interval, FlipFlop(
        OpFn(lambda test, ctx: {"f": "shrink"}),
        OpFn(lambda test, ctx: {"f": "grow"})))
    return Package(
        nemesis=MemberNemesis(db, seed=rng.randrange(2**31)),
        generator=gen,
        # membership.clj:142-157: grow until full again (time-bounded by
        # the caller's final-phase budget). PACED: a grow that fails
        # instantly (no alive member mid-heal, stalled SUT) would
        # otherwise spin the final phase into an unbounded info-op spray
        # — a starved TSAN soak recorded 101k grow attempts in one run;
        # retrying ~4×/s heals just as fast and bounds the history.
        final_generator=Delay(0.25, GrowUntilFull()),
        perf=[{"name": "member", "start": {"shrink"}, "stop": {"grow"},
               "color": "#3C8031"}],
    )


def set_churn_package(opts: dict, db, rng: random.Random) -> Package:
    """Membership churn paired with the set workload's fill:
    shrink/grow at TWICE the configured fault rate, so acknowledged adds
    race view changes — the schedule that loses elements on a SUT whose
    snapshot/catch-up path is buggy. Same MemberNemesis + GrowUntilFull
    healing discipline as the stock member package (the fault↔heal
    pairing analyzer's coverage carries over unchanged)."""
    interval = max(0.5, float(opts.get("interval", 5.0)) / 2.0)
    gen = Delay(interval, FlipFlop(
        OpFn(lambda test, ctx: {"f": "shrink"}),
        OpFn(lambda test, ctx: {"f": "grow"})))
    return Package(
        nemesis=MemberNemesis(db, seed=rng.randrange(2**31)),
        generator=gen,
        final_generator=Delay(0.25, GrowUntilFull()),
        perf=[{"name": "set-churn", "start": {"shrink"}, "stop": {"grow"},
               "color": "#3C8031"}],
    )


def queue_drain_package(opts: dict, db, net,
                        rng: random.Random) -> Package:
    """Partition paired with the queue workload's drain: the
    fill phase runs clean long enough to build a backlog (first fault
    delayed a full interval past the standard nemesis warm-up), then
    majority-flavored partitions flip during the drain — the schedule
    that double-delivers or loses tickets on a SUT whose leader handoff
    re-serves a popped head. Same PartitionNemesis + stop-partition
    healing as the stock package."""
    interval = float(opts.get("interval", 5.0))
    drain_targets = ("majority", "majorities-ring", "primaries")
    gen = Seq([Sleep(interval),
               Delay(interval, FlipFlop(
                   _targeted("start-partition", drain_targets, rng),
                   OpFn(lambda test, ctx: {"f": "stop-partition"})))])
    return Package(
        nemesis=PartitionNemesis(net, db, seed=rng.randrange(2**31)),
        generator=gen,
        final_generator=Seq([{"f": "stop-partition"}]),
        perf=[{"name": "queue-drain", "start": {"start-partition"},
               "stop": {"stop-partition"}, "color": "#E9A447"}],
    )


def compose_packages(packages: Sequence[Package],
                     seed: Optional[int] = None) -> Package:
    pkgs = [p for p in packages if p is not None]
    if not pkgs:
        return Package(nemesis=NoopNemesis())
    gens = [p.generator for p in pkgs if p.generator is not None]
    finals = [p.final_generator for p in pkgs if p.final_generator is not None]
    return Package(
        nemesis=compose_nemeses([p.nemesis for p in pkgs]),
        generator=Mix(gens, seed=seed) if gens else None,
        final_generator=Seq(finals) if finals else None,
        perf=[a for p in pkgs for a in p.perf],
    )


def setup_nemesis(opts: dict, db, net=None,
                  seed: Optional[int] = None) -> Package:
    """Fault spec -> composed package (nemesis.clj:48-58)."""
    faults = parse_nemesis_spec(opts.get("nemesis"))
    rng = random.Random(seed)
    pkgs = []
    for f in faults:
        if f == "partition":
            if net is None:
                raise ValueError("partition fault requires a Net")
            pkgs.append(partition_package(opts, db, net, rng))
        elif f == "kill":
            pkgs.append(kill_package(opts, db, rng))
        elif f == "pause":
            pkgs.append(pause_package(opts, db, rng))
        elif f == "member":
            pkgs.append(member_package(opts, db, rng))
        elif f == "set-churn":
            pkgs.append(set_churn_package(opts, db, rng))
        elif f == "queue-drain":
            if net is None:
                raise ValueError("queue-drain schedule requires a Net")
            pkgs.append(queue_drain_package(opts, db, net, rng))
    return compose_packages(pkgs, seed=rng.randrange(2**31))
