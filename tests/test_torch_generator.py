"""The port's generator algebra (`generator/base.py`, `independent.py`)
and the workloads' op generators against the reference's.

Every combinator is built in both packages from the same arguments and
drained under the same fixed contexts (time, asking thread, busy count):
the emitted ops, PENDING answers and the exhaustion point must be equal
op for op. The reference's unseeded sources are seeded from the test,
which edits nothing: `Stagger.rng` is assigned, the register and counter
workloads' module-level `_RNG` is monkeypatched, and `Mix`'s
`random.Random(None)` is routed through a shim that seeds it from the
same stream the port's workload draws its `Mix` seeds from."""

import logging
import random
import sys
import types

import pytest
import torch

from jepsen_jgroups_raft_tpu.core import compose as ref_compose
from jepsen_jgroups_raft_tpu.core import db as ref_db
from jepsen_jgroups_raft_tpu.generator import base as ref_gb
from jepsen_jgroups_raft_tpu.generator import independent as ref_gi
from jepsen_jgroups_raft_tpu.sut import inmemory as ref_sut
from jepsen_jgroups_raft_tpu.workload import WORKLOADS as REF_WORKLOADS
from jepsen_jgroups_raft_tpu.workload import counter as ref_counter
from jepsen_jgroups_raft_tpu.workload import register as ref_register
from jepsen_jgroups_raft_tpu_torch.core import compose
from jepsen_jgroups_raft_tpu_torch.core import db
from jepsen_jgroups_raft_tpu_torch.generator import base as gb
from jepsen_jgroups_raft_tpu_torch.generator import independent as gi
from jepsen_jgroups_raft_tpu_torch.history.ops import Op
from jepsen_jgroups_raft_tpu_torch.sut import inmemory
from jepsen_jgroups_raft_tpu_torch.workload import WORKLOADS

torch.set_num_threads(1)

THREADS = (0, 1, 2, 3, "nemesis")


def drain(gen, steps=240, dt_ns=137_000_000, threads=THREADS, test=None):
    """Poll `gen` under a fixed schedule of contexts: the k-th poll asks
    for thread THREADS[k % 5] at time k·dt with busy = (k // 3) % 2, and
    every emitted op is fed back through `update`. Returns the answers
    (op dicts, "pending") and "end" when it exhausts."""
    test = {} if test is None else test
    out = []
    for k in range(steps):
        ctx = {"time": k * dt_ns, "thread": threads[k % len(threads)],
               "busy": (k // 3) % 2}
        r = gen.op(test, ctx)
        if r is None:
            out.append("end")
            return out
        op, gen = r
        if op == "pending":
            out.append("pending")
            continue
        out.append(dict(op))
        gen = gen.update(test, dict(ctx, thread=None),
                         Op(process=0, type="ok", f=op.get("f"),
                            value=op.get("value")))
    return out


def _fn_x(test, ctx):
    return {"f": "x", "value": ctx["time"] // 10**8}


def _fn_y(test, ctx):
    return {"f": "y", "value": ctx["thread"]}


#: name → make(g, gi, seed): the same combinator tree in either
#: package (g = its generator.base, gi = its generator.independent)
CASES = {
    "opfn": lambda g, gi, s: g.OpFn(_fn_x),
    "repeat_n": lambda g, gi, s: g.Repeat({"f": "a", "value": 1}, 3),
    "repeat_forever": lambda g, gi, s: g.Repeat({"f": "a"}),
    "seq": lambda g, gi, s: g.Seq([{"f": "a"}, g.Repeat({"f": "b"}, 2),
                                   {"f": "c"}, _fn_y]),
    "to_gen_list": lambda g, gi, s: g.to_gen([{"f": "a"}, {"f": "b"}]),
    "to_gen_dict": lambda g, gi, s: g.to_gen({"f": "only"}),
    "to_gen_fn": lambda g, gi, s: g.Limit(4, g.to_gen(_fn_y)),
    "phases": lambda g, gi, s: g.Phases(g.Repeat({"f": "a"}, 2),
                                        g.Repeat({"f": "b"}, 2),
                                        g.Repeat({"f": "c"}, 1)),
    "mix_maps": lambda g, gi, s: g.Mix([{"f": "a"}, {"f": "b"},
                                        {"f": "c"}], seed=s),
    "mix_fns": lambda g, gi, s: g.Limit(30, g.Mix([_fn_x, _fn_y,
                                                   {"f": "once"}], seed=s)),
    "limit": lambda g, gi, s: g.Limit(5, g.Repeat({"f": "a"})),
    "time_limit": lambda g, gi, s: g.TimeLimit(2.0, g.OpFn(_fn_x)),
    "sleep": lambda g, gi, s: g.Seq([g.Sleep(0.5), {"f": "after"}]),
    "delay": lambda g, gi, s: g.Limit(6, g.Delay(0.4, g.OpFn(_fn_x))),
    "log": lambda g, gi, s: g.Any(g.Log("heal"), g.Repeat({"f": "x"}, 3)),
    "flip_flop": lambda g, gi, s: g.Limit(9, g.FlipFlop(
        g.Repeat({"f": "a"}), g.Repeat({"f": "b"}))),
    "flip_flop_ends": lambda g, gi, s: g.FlipFlop(g.Repeat({"f": "a"}, 2),
                                                  g.Repeat({"f": "b"}, 5)),
    "routed": lambda g, gi, s: g.Any(
        g.Clients(g.Repeat({"f": "client"}, 4)),
        g.NemesisGen(g.Repeat({"f": "nemesis"}, 2))),
    "routed_dead": lambda g, gi, s: g.Any(
        g.Clients(g.Limit(3, g.OpFn(_fn_y))),
        g.NemesisGen(g.Seq([]))),
    "any": lambda g, gi, s: g.Any(g.Repeat({"f": "a"}, 1),
                                  g.Repeat({"f": "b"}, 2), None),
    "synchronize": lambda g, gi, s: g.Seq([{"f": "a"}, g.Synchronize(),
                                           {"f": "b"}]),
    "concurrent": lambda g, gi, s: gi.ConcurrentGenerator(
        2, range(3), lambda k: g.Limit(3, g.Repeat({"f": "w",
                                                    "value": k}))),
    "concurrent_mix": lambda g, gi, s: gi.ConcurrentGenerator(
        3, iter(range(4)), lambda k: g.Limit(4, g.Mix(
            [_fn_x, {"f": "r"}, _fn_y], seed=s + k))),
    "schedule": lambda g, gi, s: g.Phases(
        g.TimeLimit(3.0, g.Any(
            g.Clients(g.Limit(12, g.Mix([_fn_x, _fn_y], seed=s))),
            g.NemesisGen(g.Seq([g.Sleep(0.5), g.Delay(0.6, g.FlipFlop(
                g.OpFn(lambda t, c: {"f": "start"}),
                g.OpFn(lambda t, c: {"f": "stop"})))])))),
        g.Log("healing"), g.Sleep(0.3),
        g.NemesisGen(g.Seq([{"f": "stop"}])), g.Sleep(0.3)),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 7])
def test_combinator_drains_equal_the_reference(name, seed, caplog):
    with caplog.at_level(logging.INFO, logger="jgraft.generator"):
        mine = drain(CASES[name](gb, gi, seed))
        n_mine = len(caplog.records)
        ref = drain(CASES[name](ref_gb, ref_gi, seed))
    assert mine == ref
    assert n_mine == len(caplog.records) - n_mine  # Log logs alike
    assert any(x not in ("pending", "end") for x in mine)


@pytest.mark.parametrize("dt", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("seed", [1, 2])
def test_stagger_equals_the_reference_with_its_rng_assigned(dt, seed):
    inner = [_fn_x, _fn_y]
    mine = gb.Stagger(dt, gb.Mix(inner, seed=seed), rng=seed + 100)
    ref = ref_gb.Stagger(dt, ref_gb.Mix(inner, seed=seed))
    ref.rng = random.Random(seed + 100)
    assert drain(mine) == drain(ref)


def test_stagger_takes_a_generator_or_a_seed_and_defaults_unseeded():
    r = random.Random(5)
    assert gb.Stagger(0.1, {"f": "a"}, rng=r).rng is r
    a = drain(gb.Stagger(0.2, gb.OpFn(_fn_x), rng=9))
    assert a == drain(gb.Stagger(0.2, gb.OpFn(_fn_x), rng=9))
    assert isinstance(gb.Stagger(0.1, {"f": "a"}).rng, random.Random)


def _mix_seed_shim(monkeypatch, source):
    """Route the reference's `random.Random(None)` in generator/base when
    a `Mix` asks for it (its unseeded default) to a generator seeded from
    `source`; other callers (Stagger, whose rng the tests assign) get an
    unseeded one and draw nothing from `source`."""

    def make(seed=None):
        caller = sys._getframe(1).f_locals.get("self")
        if seed is None and isinstance(caller, ref_gb.Mix):
            seed = source.randrange(2**31)
        return random.Random(seed)

    monkeypatch.setattr(ref_gb, "random", types.SimpleNamespace(Random=make))


def _opts(extra=None):
    return {"nodes": ["n1", "n2", "n3"], "concurrency": 4,
            "conn_factory": None, "ops_per_key": 6, "total_ops": 40,
            "queue_fill": 12, "queue_drain": 8, "listappend_keys": 3,
            "listappend_ops": 30, "views_probe": lambda: [],
            **(extra or {})}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("seed", [11, 12])
def test_workload_generators_equal_the_reference(workload, seed,
                                                 monkeypatch):
    module_rng = random.Random(seed)
    if workload in ("single-register", "multi-register"):
        monkeypatch.setattr(ref_register, "_RNG", module_rng)
    elif workload == "counter":
        monkeypatch.setattr(ref_counter, "_RNG", module_rng)
    _mix_seed_shim(monkeypatch, module_rng)
    mine = WORKLOADS[workload](_opts({"seed": seed, "device": "cpu"}))
    ref = REF_WORKLOADS[workload](_opts({"seed": seed}))
    for key in ("generator", "final_generator"):
        assert (mine.get(key) is None) == (ref.get(key) is None)
        if mine.get(key) is not None:
            a, b = drain(mine[key], steps=300), drain(ref[key], steps=300)
            assert a == b
            assert any(x not in ("pending", "end") for x in a)
    assert mine["idempotent"] == ref["idempotent"]
    assert mine.get("suggested_nemesis") == ref.get("suggested_nemesis")


@pytest.mark.parametrize("workload,nemesis", [
    ("single-register", "partition"), ("counter", "hell"),
    ("set", None), ("queue", None), ("multi-register", "kill,pause")])
def test_composed_schedule_equals_the_reference(workload, nemesis,
                                                monkeypatch):
    """`compose_test`'s whole phased generator (stagger, workload mix,
    nemesis packages, heal and quiesce phases) from one seed."""
    seed = 21
    module_rng = random.Random(seed)
    monkeypatch.setattr(ref_register, "_RNG", module_rng)
    monkeypatch.setattr(ref_counter, "_RNG", module_rng)
    _mix_seed_shim(monkeypatch, module_rng)
    nodes = ["n1", "n2", "n3", "n4", "n5"]
    opts = {"workload": workload, "nemesis": nemesis, "nodes": nodes,
            "rate": 20.0, "interval": 0.4, "time_limit": 4.0,
            "quiesce": 0.3, "concurrency": 4, "conn_factory": None,
            "ops_per_key": 8}
    c = inmemory.InMemoryCluster(nodes, inmemory.LatencyPlan(seed=1))
    rc = ref_sut.InMemoryCluster(nodes, ref_sut.LatencyPlan(seed=1))
    try:
        mine = compose.compose_test(
            {**opts, "device": "cpu"}, db=db.InMemoryDB(c),
            net=db.InMemoryNet(c), seed=seed)
        ref = ref_compose.compose_test(
            opts, db=ref_db.InMemoryDB(rc), net=ref_db.InMemoryNet(rc),
            seed=seed)
        # the reference's stagger: items[0] is TimeLimit(Any(Clients(
        # Stagger), ...))
        stagger = ref["generator"].items[0].gen.gens[0].gen
        assert isinstance(stagger, ref_gb.Stagger)
        stagger.rng = random.Random(f"stagger:{seed}")
        a = drain(mine["generator"], steps=400, dt_ns=41_000_000,
                  test=mine)
        b = drain(ref["generator"], steps=400, dt_ns=41_000_000, test=ref)
        assert a == b
        assert sum(1 for x in a if isinstance(x, dict)) > 10
    finally:
        c.shutdown()
        rc.shutdown()
