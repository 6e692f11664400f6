"""The port's nemeses (`nemesis/`) against the reference's.

For the same seed, over 3, 5 and 7 nodes and every victim kind: the
victim picks and grudges equal the reference's (and leave the two random
generators in the same state); `parse_nemesis_spec` and
`schedule_pressure` equal it for every spec of `FAULTS`, `SCHEDULES` and
`SPECIALS`; each package's main and final generators drain to the same
ops. Then every fault is invoked on each package's own `InMemoryDB` /
`InMemoryNet` (a seeded `InMemoryCluster`): the completions, and the
cluster's leader, term, dead, paused and partitioned sets after each
one, equal the reference's."""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.core import db as ref_db
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu.nemesis import package as ref_package
from jepsen_jgroups_raft_tpu.nemesis import targets as ref_targets
from jepsen_jgroups_raft_tpu.sut import inmemory as ref_sut
from jepsen_jgroups_raft_tpu_torch.core import db
from jepsen_jgroups_raft_tpu_torch.history.ops import INFO, NEMESIS, Op
from jepsen_jgroups_raft_tpu_torch.nemesis import package, targets
from jepsen_jgroups_raft_tpu_torch.sut import inmemory

from test_torch_generator import drain

torch.set_num_threads(1)

SIZES = (3, 5, 7)
SEEDS = (0, 1, 2)
SPECS = [*package.FAULTS, *package.SCHEDULES, *package.SPECIALS,
         "partition,kill", "pause, member", ("kill", "partition"), None]


def _nodes(n):
    return [f"n{i}" for i in range(1, n + 1)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["one", "primaries", "minority", "all"])
@pytest.mark.parametrize("seed", SEEDS)
def test_pick_nodes_equals_the_reference(n, kind, seed):
    nodes = _nodes(n)
    for primaries in ([], [nodes[1]], nodes[:2], ["gone"]):
        a, b = random.Random(seed), random.Random(seed)
        assert targets.pick_nodes(kind, nodes, primaries, a) == \
            ref_targets.pick_nodes(kind, nodes, primaries, b)
        assert a.getstate() == b.getstate()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", targets.PARTITION_TARGETS)
@pytest.mark.parametrize("seed", SEEDS)
def test_partition_grudge_equals_the_reference(n, kind, seed):
    nodes = _nodes(n)
    for primaries in ([], [nodes[0]], nodes[:2], nodes):
        a, b = random.Random(seed), random.Random(seed)
        assert targets.partition_grudge(kind, nodes, primaries, a) == \
            ref_targets.partition_grudge(kind, nodes, primaries, b)
        assert a.getstate() == b.getstate()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_ring_and_complete_grudges_equal_the_reference(n, seed):
    nodes = _nodes(n)
    assert targets.majorities_ring_grudge(nodes, random.Random(seed)) == \
        ref_targets.majorities_ring_grudge(nodes, random.Random(seed))
    comps = [set(nodes[:n // 2]), set(nodes[n // 2:])]
    assert targets.complete_grudge(comps) == \
        ref_targets.complete_grudge(comps)
    assert targets.complete_grudge([]) == ref_targets.complete_grudge([])


def test_unknown_kinds_raise_in_both():
    for mod in (targets, ref_targets):
        with pytest.raises(ValueError):
            mod.pick_nodes("bogus", ["n1"], [], random.Random(0))
        with pytest.raises(ValueError):
            mod.partition_grudge("bogus", ["n1", "n2"], [],
                                 random.Random(0))
    assert targets.pick_nodes("one", [], [], random.Random(0)) == []


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_parse_and_pressure_equal_the_reference(spec):
    assert package.parse_nemesis_spec(spec) == \
        ref_package.parse_nemesis_spec(spec)
    for interval in (0.1, 1.0, 5.0, 30.0):
        assert package.schedule_pressure(spec, interval) == \
            ref_package.schedule_pressure(spec, interval)


@pytest.mark.parametrize("spec", ["bogus", "partition,bogus", "all,kill"])
def test_bad_specs_raise_in_both(spec):
    for mod in (package, ref_package):
        with pytest.raises(ValueError):
            mod.parse_nemesis_spec(spec)


def _clusters(n, seed):
    nodes = _nodes(n)
    return (inmemory.InMemoryCluster(nodes, inmemory.LatencyPlan(seed=seed)),
            ref_sut.InMemoryCluster(nodes, ref_sut.LatencyPlan(seed=seed)))


def _state(c):
    return (c.leader, c.term, sorted(c.killed), sorted(c.nodes),
            sorted(n for n, e in c.resume_events.items() if not e.is_set()),
            {k: sorted(v) for k, v in c.grudge.items()},
            sorted(c.stale_views))


@pytest.mark.parametrize("spec", [s for s in SPECS if s is not None],
                         ids=str)
@pytest.mark.parametrize("n", SIZES)
def test_package_generators_drain_alike(spec, n):
    c, rc = _clusters(n, 3)
    try:
        opts = {"nemesis": spec, "interval": 0.3}
        mine = package.setup_nemesis(opts, db.InMemoryDB(c),
                                     db.InMemoryNet(c), seed=9)
        ref = ref_package.setup_nemesis(opts, ref_db.InMemoryDB(rc),
                                        ref_db.InMemoryNet(rc), seed=9)
        assert mine.perf == ref.perf
        assert type(mine.nemesis).__name__ == type(ref.nemesis).__name__
        test = {"nodes": _nodes(n), "members": set(_nodes(n)[:-1])}
        ref_test = {"nodes": _nodes(n), "members": set(_nodes(n)[:-1])}
        for key in ("generator", "final_generator"):
            a, b = getattr(mine, key), getattr(ref, key)
            assert (a is None) == (b is None)
            if a is not None:
                ops = drain(a, steps=120, threads=("nemesis",), test=test)
                assert ops == drain(b, steps=120, threads=("nemesis",),
                                    test=ref_test)
    finally:
        c.shutdown()
        rc.shutdown()


def _fault_ops(spec, n):
    """The nemesis ops a fault's schedule invokes: each start kind, its
    stop, the heal of the final generator."""
    faults = package.parse_nemesis_spec(spec)
    ops = []
    for f in faults:
        if f in ("partition", "queue-drain"):
            for kind in targets.PARTITION_TARGETS:
                ops += [("start-partition", kind), ("stop-partition", None)]
            ops += [("start-partition", None), ("stop-partition", None)]
        elif f in ("kill", "pause"):
            stop = {"kill": "restart", "pause": "resume"}[f]
            for kind in targets.NODE_TARGETS:
                ops += [(f, kind), (stop, None)]
            ops += [(f, "minority"), (f, "one"), (stop, "all")]
        else:  # member, set-churn
            ops += [("shrink", None)] * (n // 2 + 1) + \
                [("grow", None)] * (n // 2 + 1)
    return ops


@pytest.mark.parametrize("spec", ["partition", "kill", "pause", "member",
                                  "set-churn", "queue-drain", "hell"])
@pytest.mark.parametrize("n", SIZES)
def test_faults_on_inmemory_db_complete_as_the_reference(spec, n):
    c, rc = _clusters(n, 4 + n)
    try:
        opts = {"nemesis": spec, "interval": 0.3}
        mine = package.setup_nemesis(opts, db.InMemoryDB(c),
                                     db.InMemoryNet(c), seed=5)
        ref = ref_package.setup_nemesis(opts, ref_db.InMemoryDB(rc),
                                        ref_db.InMemoryNet(rc), seed=5)
        test = {"nodes": _nodes(n), "members": set(_nodes(n))}
        ref_test = {"nodes": _nodes(n), "members": set(_nodes(n))}
        nem, ref_nem = mine.nemesis.setup(test), ref.nemesis.setup(ref_test)
        for f, value in _fault_ops(spec, n):
            out = nem.invoke(test, Op(process=NEMESIS, type=INFO, f=f,
                                      value=value))
            ref_out = ref_nem.invoke(ref_test, RefOp(process=NEMESIS,
                                                     type=INFO, f=f,
                                                     value=value))
            assert (out.f, out.value, out.type) == \
                (ref_out.f, ref_out.value, ref_out.type), (f, value)
            assert _state(c) == _state(rc), (f, value)
            assert test["members"] == ref_test["members"]
        nem.teardown(test)
        ref_nem.teardown(ref_test)
        assert _state(c) == _state(rc)
    finally:
        c.shutdown()
        rc.shutdown()
