"""The local multi-card fan-out on the CPU: one process spreading a
launch's rows over the placements it owns, held to the reference's
fan-out over the 8 virtual devices that tests/conftest.py pins
(`pin_cpu(8)`). The port fans out over 2, 3 and 8 placements of the CPU
(`platform.pin_placements`).

* The gate (`launch_fan_out`, `chunk_sharding`) under
  JGRAFT_GROUP_DEVICES unset, 0, 1, 2 and 8 and a per-call cap; the
  strided rule for a rank's cards (`local_cards`, `local_devices`) under
  a faked device count and LOCAL_WORLD_SIZE; `shard_bounds` with a
  granularity.
* `build_dense_launches` places as the reference's: groups whole, every
  group but an `exact_rows` one on the mesh, a tuned fan-out capped.
* `run_chunked` over placements gives the reference's fanned-out
  outcome per launch (ok, overflow, chunks_run, evicted_rows,
  early_exit) and counters on its wavefront cases, B below the mesh's
  size included; `shard_chunk_fns` equals the one-device chunk pair.
* `check_histories` result dicts and counters equal the reference's at
  the default chunk, 16 and 0; `check_batch_sharded` (ladder, pinned
  rung, `defer`, the dense and mask plans) and the sharded checkers
  equal the reference's; `check_segmented_batch` over placements equals
  one device, and its tables the one launch's.
* The autotuner's fan-out candidates, default plan and
  `sort_rung_sharding` equal the reference's at the same width.
* A two-process gloo cluster whose ranks each fan out over 2 placements
  gives one process's verdicts and counts.

Tolerance: exact — verdicts, flags, counts, cuts and counters compared
for equality."""

import json
import random
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import autotune as ref_at
from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.history import packing as ref_packing
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu.ops import dense_scan as ref_ds
from jepsen_jgroups_raft_tpu.ops import linear_scan as ref_ls
from jepsen_jgroups_raft_tpu.ops import segment_scan as ref_ss
from jepsen_jgroups_raft_tpu.parallel import distributed as ref_dist
from jepsen_jgroups_raft_tpu.parallel import mesh as ref_mesh
from jepsen_jgroups_raft_tpu_torch import platform
from jepsen_jgroups_raft_tpu_torch.checker import autotune, schedule
from jepsen_jgroups_raft_tpu_torch.checker.autotune import TunedPlan
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.history import packing
from jepsen_jgroups_raft_tpu_torch.history.packing import (bucket_rows,
                                                           encode_history)
from jepsen_jgroups_raft_tpu_torch.history.synth import (burst_history,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls
from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss
from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import shard_chunk_fns
from jepsen_jgroups_raft_tpu_torch.parallel import distributed, launch, mesh
from jepsen_jgroups_raft_tpu_torch.parallel.selfcheck import (corrupt_read,
                                                              seeded_batch)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
KIND = {"register": "cas-register", "counter": "counter", "queue": "queue",
        "set": "set", "list-append": "list-append"}
KEYS = ("chunks_run", "evicted_rows", "groups_run", "groups_early_exited")
WIDTHS = (2, 3, 8)


@pytest.fixture
def pin():
    """pin(n): n placements of the CPU as this process's local devices;
    the host's own (none here) again after the test."""
    yield lambda n: platform.pin_placements(n, "cpu")
    platform.pin_placements(None)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("JGRAFT_GROUP_DEVICES", raising=False)
    schedule.consume_stats()
    ref_schedule.consume_stats()
    yield
    schedule.consume_stats()
    ref_schedule.consume_stats()


def _models(kind):
    return MODELS[KIND[kind]](), REF_MODELS[KIND[kind]]()


def _size(placement):
    """Placements of a port launch device (a Mesh, or one device)."""
    return placement.size if isinstance(placement, mesh.Mesh) else 1


def _ref_size(placement):
    """Devices of a reference launch placement (a sharding, or one)."""
    m = getattr(placement, "mesh", None)
    return int(m.size) if m is not None else 1


def _corrupt(h, rng):
    """One completed observation changed, where the history has one: a
    register or counter read, an add-and-get's new value, an enqueue's
    or dequeue's ticket raised by one; a set or list read missing its
    last element."""
    ops = list(h)
    idx = [j for j, op in enumerate(ops) if op.type == "ok"
           and op.value is not None and op.f in ("read", "add-and-get",
                                                 "enqueue", "dequeue")]
    if not idx:
        return ops
    j = rng.choice(idx)
    v = ops[j].value
    if isinstance(v, tuple):
        v = (v[0], v[1] + 1)
    elif isinstance(v, (list, set, frozenset)):
        if not v:
            return ops
        v = list(v)[:-1] if isinstance(v, list) else sorted(v)[:-1]
    else:
        v = v + 1
    ops[j] = ops[j].replace(value=v)
    return ops


def _histories(kind, seed, n=8, n_ops=30, n_procs=4, crash_p=0.15,
               max_crashes=2, corrupt_every=3):
    rng = random.Random(seed)
    kw = {"value_range": 32} if kind == "set" else {}
    hs = []
    for i in range(n):
        h = random_valid_history(rng, kind, n_ops=n_ops + 3 * i,
                                 n_procs=n_procs, crash_p=crash_p,
                                 max_crashes=max_crashes, **kw)
        if corrupt_every and i % corrupt_every == 1:
            h = _corrupt(h, rng)
        hs.append(h)
    return hs


# ------------------------------------------------------------- the gate


@pytest.mark.parametrize("cap", [None, 0, 1, 3, 8, 16])
@pytest.mark.parametrize("knob", [None, "0", "1", "2", "8"])
def test_chunk_sharding_gate_equals_reference(knob, cap, pin, monkeypatch):
    """Over 8 placements against the reference's 8 virtual devices: the
    knob unset fans out over all, 0 forbids it, 1 clamps to one device
    (None), N caps the mesh, and a per-call cap is bounded by the knob."""
    pin(8)
    if knob is not None:
        monkeypatch.setenv("JGRAFT_GROUP_DEVICES", knob)
    assert mesh.launch_fan_out() == ref_mesh.launch_fan_out() == \
        (knob != "0")
    ours, theirs = mesh.chunk_sharding(cap), ref_mesh.chunk_sharding(cap)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.size == theirs.mesh.size >= 2
        assert ours.devices == (torch.device("cpu"),) * ours.size
        assert mesh.chunk_sharding(cap, device="cpu") == ours


def test_no_fan_out_without_placements(monkeypatch):
    """This host has no card: no local device, no mesh. A check on the
    CPU beside cards never fans out over them (decided before asking
    for a card)."""
    assert mesh.local_devices() == ()
    assert mesh.chunk_sharding() is None
    assert distributed.placement_granularity() == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_card():
        raise AssertionError("asked for a card")

    monkeypatch.setattr(torch.cuda, "current_device", no_card)
    assert mesh.chunk_sharding(device="cpu") is None


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_local_mesh_and_make_mesh_take_the_placements(n, pin):
    pin(n)
    want = mesh.Mesh((torch.device("cpu"),) * n)
    assert mesh.local_mesh() == want == mesh.make_mesh(n_devices=n)
    assert mesh.local_mesh(1) == mesh.make_mesh("cpu")
    assert mesh.make_mesh(devices=["cpu"] * 3, n_devices=2).size == 2
    with pytest.raises(ValueError, match="requested"):
        mesh.make_mesh(n_devices=n + 1)
    assert distributed.placement_granularity() == (n if n > 1 else 1)
    assert distributed.global_mesh() == \
        [(0, torch.device("cpu"))] * (n if n > 1 else 1)


@pytest.mark.parametrize("n_cards,lws,want", [
    (8, 1, [[0, 1, 2, 3, 4, 5, 6, 7]]),
    (8, 2, [[0, 2, 4, 6], [1, 3, 5, 7]]),
    (8, 4, [[0, 4], [1, 5], [2, 6], [3, 7]]),
    (8, 8, [[r] for r in range(8)]),
    (4, 3, [[0], [1], [2]]),
    (3, 2, [[0], [1]]),
    (2, 4, [[0]] * 4),
])
def test_local_cards_strided_rule(n_cards, lws, want):
    """A rank owns the cards c with c % LOCAL_WORLD_SIZE == LOCAL_RANK,
    as many as every other rank of the host (its own card first), never
    another rank's; ranks that share cards own card 0 alone."""
    got = [mesh.local_cards(n_cards, r, lws) for r in range(lws)]
    assert got == want
    for r, cards in enumerate(got):
        if lws <= n_cards:
            assert cards[0] == r
    owned = [c for cards in got for c in cards]
    if lws <= n_cards:
        assert len(owned) == len(set(owned))


def test_local_cards_outside_a_cluster_put_this_card_first():
    assert mesh.local_cards(4, current=2) == [2, 0, 1, 3]
    assert mesh.local_cards(0) == []


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_local_devices_under_a_faked_cluster(rank, monkeypatch):
    """Eight faked cards, four ranks a host: rank r's mesh is
    (cuda:r, cuda:r+4), its device first, and its width is the
    cross-process granularity."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: rank)
    monkeypatch.setattr(distributed, "local_rank_world", lambda: (rank, 4))
    want = (torch.device("cuda", rank), torch.device("cuda", rank + 4))
    assert mesh.local_devices() == want
    assert mesh.chunk_sharding() == mesh.Mesh(want)
    assert mesh.chunk_sharding(device=f"cuda:{rank}") == mesh.Mesh(want)
    assert mesh.chunk_sharding(device=f"cuda:{(rank + 1) % 4}") is None
    assert distributed.placement_granularity() == 2
    monkeypatch.setenv("JGRAFT_GROUP_DEVICES", "1")
    assert mesh.chunk_sharding() is None


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_shard_bounds_granularity_equals_reference(g):
    for n in (0, 1, 2, 3, 7, 8, 16, 33, 100, 1001):
        for shards in (1, 2, 3, 4, 8):
            cuts = [packing.shard_bounds(n, shards, i, g)
                    for i in range(shards)]
            assert cuts == [ref_dist.shard_bounds(n, shards, i, g)
                            for i in range(shards)]
            assert cuts[0][0] == 0 and cuts[-1][1] == n
            assert all(lo % g == 0 for lo, _ in cuts)
    assert distributed.shard_bounds is packing.shard_bounds


# ------------------------------------------------- build_dense_launches


def _grouped(kind, seed, n, n_ops):
    """Histories of 2 to 4 processes, no crash (three window groups),
    encoded and grouped by both packages."""
    m, rm = _models(kind)
    rng = random.Random(seed)
    hs = [random_valid_history(rng, kind, n_ops=n_ops, n_procs=2 + i % 3,
                               crash_p=0.0, max_crashes=0)
          for i in range(n)]
    encs = [encode_history(h, m) for h in hs]
    ref_encs = [ref_packing.encode_history(h, rm) for h in hs]
    grouped, rest = ds.dense_plans_grouped(m, encs)
    ref_grouped, ref_rest = ref_ds.dense_plans_grouped(rm, ref_encs)
    assert not rest and not ref_rest
    assert [g for g, _ in grouped] == [g for g, _ in ref_grouped]
    return m, rm, encs, grouped, [p for _, p in ref_grouped]


@pytest.mark.parametrize("knob", [None, "0", "2"])
def test_build_dense_launches_placement_equals_reference(knob, pin,
                                                         monkeypatch):
    """Groups stay whole and in the reference's order; every non-LONG
    group spreads over the mesh, a LONG group (exact_rows) stays on the
    check's device, a tuned group takes its capped fan-out; at
    JGRAFT_GROUP_DEVICES=0 nothing spreads."""
    pin(8)
    if knob is not None:
        monkeypatch.setenv("JGRAFT_GROUP_DEVICES", knob)
    m, rm, encs, grouped, ref_plans = _grouped("register", 47, 48, 12)
    ours, theirs = [], []
    for k, ((idxs, plan), rplan) in enumerate(zip(grouped, ref_plans)):
        batch = packing.pack_batch([encs[i] for i in idxs])
        if k == 0:
            batch["legacy_events"] = ds.MERGE_MAX_EVENTS + 1  # LONG
        tuned = TunedPlan("dense", 0, 0, 3) if k == 1 else None
        ref_tuned = ref_at.TunedPlan("dense", 0, 0, 3) if k == 1 else None
        ours.append((idxs, plan, batch) + ((tuned,) if tuned else ()))
        theirs.append((idxs, rplan, batch)
                      + ((ref_tuned,) if ref_tuned else ()))
    a, a_subs = schedule.build_dense_launches(m, ours, device="cpu")
    b, b_subs = ref_schedule.build_dense_launches(rm, theirs)
    assert a_subs == b_subs
    assert len(a) == len(grouped) >= 3
    for x, y in zip(a, b):
        assert x.events.shape == y.events.shape
        assert (x.exact_rows, x.chunk, x.e_sched) == \
            (y.exact_rows, y.chunk, y.e_sched)
        assert _size(x.device) == _ref_size(y.device)
        if x.exact_rows:
            assert x.device == "cpu"
    sizes = sorted(_size(x.device) for x in a)
    want = {None: 8, "0": 1, "2": 2}[knob]
    assert sizes.count(1) == (len(a) if want == 1 else 1)
    assert max(sizes) == want


# ---------------------------------------------------------- run_chunked


def _launch_pairs(kind, hs, m, rm, width, e_sched=None, exact=False):
    """The same dense groups as the port's ChunkLaunches over `width`
    CPU placements and the reference's over its 8-device sharding (on
    its one default device for `exact` rows, which the reference never
    places on a mesh: its sharding needs a multiple of 8 rows)."""
    encs = [encode_history(h, m) for h in hs]
    grouped, rest = ds.dense_plans_grouped(m, encs)
    assert not rest
    placement = mesh.Mesh(("cpu",) * width)
    sharding = ref_mesh.chunk_sharding()
    assert sharding is not None and sharding.mesh.size == 8
    ref_mesh_ = None if exact else sharding.mesh
    ours, theirs = [], []
    for idxs, plan in grouped:
        batch = packing.pack_batch([encs[i] for i in idxs])
        init, step = ds.make_dense_chunk_checker(m, plan.kind, plan.n_slots,
                                                 plan.n_states)
        ours.append(schedule.ChunkLaunch(
            events=batch["events"], n_events=batch["n_events"],
            init_fn=init, step_fn=step, val_of=plan.val_of,
            e_sched=e_sched, device=placement, tag=plan.kernel_tag,
            exact_rows=exact))
        rinit, rstep = ref_ds.make_dense_chunk_checker(
            rm, plan.kind, plan.n_slots, plan.n_states, mesh=ref_mesh_)
        theirs.append(ref_schedule.ChunkLaunch(
            events=batch["events"], n_events=batch["n_events"],
            init_fn=rinit, step_fn=rstep, val_of=plan.val_of,
            e_sched=e_sched, device=None if exact else sharding,
            tag=plan.kernel_tag,
            exact_rows=exact))
    return ours, theirs


def _same_outcomes(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.ok, b.ok)
        np.testing.assert_array_equal(a.overflow, b.overflow)
        assert (a.chunks_run, a.evicted_rows, a.early_exit, a.tag) == \
            (b.chunks_run, b.evicted_rows, b.early_exit, b.tag)


def _same_counters():
    a, b = schedule.consume_stats(), ref_schedule.consume_stats()
    assert [a[k] for k in KEYS] == [b[k] for k in KEYS]
    return a


# name: (kind, histories' seed, rows, ops, chunk, e_sched, exact)
WAVEFRONT = {
    "eviction-register": ("register", 17, 24, 4, 8, None, False),
    "eviction-counter": ("counter", 17, 24, 4, 8, None, False),
    "recompaction": ("register", 23, 30, 6, 4, None, False),
    "early-exit": ("register", 29, 9, 10, 8, 256, False),
    "exact-rows": ("register", 31, 5, 8, 4, None, True),
    "fewer-rows-than-placements": ("register", 37, 3, 12, 4, None, False),
}


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", list(WAVEFRONT))
def test_run_chunked_over_placements_equals_reference(case, width):
    """Per launch the reference's fanned-out verdicts, launches,
    evictions and early exits, and its counters: a group stays one group
    however many placements its rows spread over."""
    kind, seed, n, n_ops, chunk, e_sched, exact = WAVEFRONT[case]
    m, rm = _models(kind)
    hs = _histories(kind, seed, n=n, n_ops=n_ops, n_procs=3,
                    corrupt_every=3)
    ours, theirs = _launch_pairs(kind, hs, m, rm, width, e_sched, exact)
    _same_outcomes(schedule.run_chunked(ours, chunk=chunk),
                   ref_schedule.run_chunked(theirs, chunk=chunk))
    got = _same_counters()
    if case.startswith("eviction"):
        assert got["evicted_rows"] > 0
    if case == "early-exit":
        assert got["groups_early_exited"] >= 1


@pytest.mark.parametrize("width", WIDTHS)
def test_sort_launch_over_placements_equals_reference(width):
    """One sort launch at a chunk that does not divide the event length,
    with overflowing rows (C = 4) and not (C = 64): the reference's
    fanned-out outcome."""
    m, rm = _models("register")
    rng = random.Random(37)
    encs = [encode_history(random_valid_history(rng, "register", n_ops=n,
                                                crash_p=0.4), m)
            for n in (5, 9, 14, 20, 26)]
    batch = packing.pack_batch(encs)
    E = batch["events"].shape[1]
    sharding = ref_mesh.chunk_sharding()
    for C in (4, 64):
        init, step = ls.make_sort_chunk_checker(m, C, 8)
        rinit, rstep = ref_ls.make_sort_chunk_checker(rm, C, 8,
                                                      mesh=sharding.mesh)
        kw = dict(events=batch["events"], n_events=batch["n_events"],
                  e_sched=bucket_rows(E, 32), tag="sort")
        _same_outcomes(
            schedule.run_chunked([schedule.ChunkLaunch(
                init_fn=init, step_fn=step,
                device=mesh.Mesh(("cpu",) * width), **kw)], chunk=6),
            ref_schedule.run_chunked([ref_schedule.ChunkLaunch(
                init_fn=rinit, step_fn=rstep, device=sharding, **kw)],
                chunk=6))
        _same_counters()


@pytest.mark.parametrize("width", WIDTHS)
def test_shard_chunk_fns_equal_the_one_device_pair(width):
    """Each placement's carries and flags, joined in row order, equal
    the chunk pair's on the whole batch, chunk after chunk."""
    m, _ = _models("register")
    hs = _histories("register", 5, n=7, n_ops=10, n_procs=3)
    encs = [encode_history(h, m) for h in hs]
    [(idxs, plan)], _ = ds.dense_plans_grouped(m, encs)
    batch = packing.pack_batch([encs[i] for i in idxs])
    init, step = ds.make_dense_chunk_checker(m, plan.kind, plan.n_slots,
                                             plan.n_states)
    init_shards, step_shards = shard_chunk_fns(
        init, step, mesh.Mesh(("cpu",) * width))
    shards, carries = init_shards(plan.val_of, batch["n_events"])
    assert [s.lo for s in shards] == \
        [packing.shard_bounds(len(idxs), width, i)[0] for i in range(width)
         if packing.shard_bounds(len(idxs), width, i)[1] >
         packing.shard_bounds(len(idxs), width, i)[0]]
    whole = init(torch.from_numpy(plan.val_of),
                 torch.from_numpy(batch["n_events"]))
    assert torch.equal(torch.cat(carries), whole)
    ev = torch.from_numpy(batch["events"])
    for lo in range(0, ev.shape[1], 8):
        outs = step_shards(shards, carries,
                           [ev[s.lo:s.hi, lo:lo + 8] for s in shards], 8)
        want = step(whole, ev[:, lo:lo + 8], 8)
        for k in range(5):
            assert torch.equal(torch.cat([o.out[k] for o in outs]), want[k])
        carries, whole = [o.out[0] for o in outs], want[0]


# ------------------------------------------------------ check_histories


def _strip(r):
    return {k: v for k, v in r.items() if k not in ("time-s", "algorithm")}


@pytest.mark.parametrize("chunk", [None, "0", "16"])
@pytest.mark.parametrize("kind", ["register", "counter", "set"])
def test_result_dicts_over_placements_equal_reference(kind, chunk, pin,
                                                      monkeypatch):
    """check_histories fanned out over 3 placements against the
    reference's fan-out over 8 devices: every result dict field for
    field ("chunked" and "kernel" included) and the wavefront counters,
    at the default chunk, 16 and 0 (the one-shot path)."""
    if chunk is None:
        monkeypatch.delenv("JGRAFT_SCAN_CHUNK", raising=False)
    else:
        monkeypatch.setenv("JGRAFT_SCAN_CHUNK", chunk)
    m, rm = _models(kind)
    hs = _histories(kind, 41, n=10, n_ops=24, corrupt_every=4)
    one = check_histories(hs, m, device="cpu")
    schedule.consume_stats()
    pin(3)
    ours = check_histories(hs, m, device="cpu")
    theirs = ref_check(hs, rm)
    assert [_strip(r) for r in ours] == [_strip(r) for r in theirs] == \
        [_strip(r) for r in one]
    got = _same_counters()
    assert (got["groups_run"] > 0) == (chunk != "0")


# ------------------------------------------------- check_batch_sharded


def _ladder_rows():
    """Burst rows (frontiers past C = 64, some past 256), valid and
    corrupted, and ordinary rows: 13 rows, odd."""
    rng = random.Random(3)
    hs = []
    for i in range(9):
        h = burst_history(rng, "register", rng.randint(6, 11))
        if i % 2:
            h, _ = corrupt_read(h, rng, 4)
        hs.append(h)
    hs += [random_valid_history(rng, "register", n_ops=20, n_procs=3)
           for _ in range(4)]
    m, rm = _models("register")
    encs = [encode_history(h, m) for h in hs]
    return packing.pack_batch(encs)["events"], \
        ls.bucket_slots(max(e.n_slots for e in encs))


def _same_result(ours, theirs):
    ok, ovf, nv, nu = ours
    r_ok, r_ovf, r_nv, r_nu = theirs
    assert np.array_equal(ok, np.asarray(r_ok))
    assert np.array_equal(ovf, np.asarray(r_ovf))
    assert (nv, nu) == (int(r_nv), int(r_nu))


@pytest.mark.parametrize("width", WIDTHS)
def test_ladder_over_placements_equals_reference(width):
    """The capacity ladder over placements (both rungs reached, some
    rows left undecided), a pinned rung deferred: the reference's."""
    ev, W = _ladder_rows()
    m, rm = _models("register")
    placed = mesh.Mesh(("cpu",) * width)
    ours = mesh.check_batch_sharded(m, ev, placed, n_slots=W)
    _same_result(ours, ref_mesh.check_batch_sharded(rm, ev, n_slots=W))
    _same_result(ours, mesh.check_batch_sharded(m, ev, device="cpu",
                                                n_slots=W))
    assert ours[3] > 0 and ours[2] > 0
    fin = mesh.check_batch_sharded(m, ev, placed, n_configs=8, n_slots=W,
                                   defer=True)
    _same_result(fin(), ref_mesh.check_batch_sharded(rm, ev, n_configs=8,
                                                     n_slots=W))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", ["register", "counter"])
def test_dense_arm_over_placements_equals_reference(kind, width):
    """`dense=` over placements: the domain plan (B1) and the mask plan
    (B4), macro rows, an odd batch, deferred and not; counts summed over
    the shards equal the reference's psum."""
    m, rm = _models(kind)
    hs = _histories(kind, 21, n=11, n_ops=30, corrupt_every=4)
    encs = [encode_history(h, m) for h in hs]
    ref_encs = [ref_packing.encode_history(h, rm) for h in hs]
    plan = ds.dense_plan(m, encs)
    rplan = ref_ds.dense_plan(rm, ref_encs)
    batch = packing.pack_macro_batch(encs)
    placed = mesh.Mesh(("cpu",) * width)
    theirs = ref_mesh.check_batch_sharded(rm, batch["events"], dense=rplan,
                                          macro_p=batch["macro_p"])
    for defer in (False, True):
        out = mesh.check_batch_sharded(m, batch["events"], placed,
                                       dense=plan, defer=defer,
                                       macro_p=batch["macro_p"])
        _same_result(out() if defer else out, theirs)
    assert 0 < theirs[2] < len(hs)


@pytest.mark.parametrize("width", WIDTHS)
def test_sharded_checkers_over_placements_equal_reference(width):
    """The sharded checkers over placements, padding rows masked by
    `real`: the reference's flags and counts, results in row order on
    the mesh's first device."""
    ev, W = _ladder_rows()
    ev16 = np.concatenate([ev, np.zeros((3,) + ev.shape[1:], np.int32)])
    real = np.arange(16) < len(ev)
    m, rm = _models("register")
    placed = mesh.Mesh(("cpu",) * width)
    ok, ovf, nv, nu = mesh.sharded_batch_checker(m, placed, 64, W)(
        torch.from_numpy(ev16), torch.from_numpy(real))
    r = ref_mesh.sharded_batch_checker(rm, ref_mesh.make_mesh(), 64, W)(
        ev16, real)
    _same_result((ok.numpy(), ovf.numpy(), int(nv), int(nu)), r)
    hs = _histories("register", 4, n=16, n_ops=20, n_procs=3)
    encs = [encode_history(h, m) for h in hs]
    plan = ds.dense_plan(m, encs)
    dev16 = packing.pack_batch(encs)["events"]
    fn = mesh.sharded_dense_checker(m, placed, plan.kind, plan.n_slots,
                                    plan.n_states)
    ok, ovf, nv, nu = fn(torch.from_numpy(dev16),
                         torch.from_numpy(plan.val_of),
                         torch.from_numpy(real))
    r = ref_mesh.sharded_dense_checker(rm, ref_mesh.make_mesh(), plan.kind,
                                       plan.n_slots, plan.n_states)(
        dev16, plan.val_of, real)
    _same_result((ok.numpy(), ovf.numpy(), int(nv), int(nu)), r)
    assert ok.device == placed.device


# --------------------------------------------------------- segment batch


@pytest.mark.parametrize("width", WIDTHS)
def test_segmented_batch_over_placements_equals_one_device(width, pin):
    """The segment axis spread over placements: the final tables equal
    the one launch's bitwise, the results one device's and the
    reference's (whose segment axis spans its 8 devices)."""
    m, rm = _models("register")
    rng = random.Random(42)
    hs = []
    for i in range(4):
        h = random_valid_history(rng, "register", n_ops=160, n_procs=4,
                                 crash_p=0.03, max_crashes=3)
        if i % 2:
            h, _ = corrupt_read(h, rng, 4)
        hs.append(h)
    encs = [encode_history(h, m) for h in hs]
    batch = ss.prepare_segment_batch(encs, m, 40, 0, "cpu")
    one = ss._segment_tables(batch, m, (torch.device("cpu"),))
    ones = ss.check_segmented_batch(encs, m, 40, 0, device="cpu")
    pin(width)
    placed = mesh.chunk_sharding(device="cpu")
    assert placed.size == width and int(batch.events.shape[0]) >= width
    spread = ss._segment_tables(batch, m, placed.devices)
    assert spread.dtype == one.dtype and np.array_equal(spread, one)
    ours = ss.check_segmented_batch(encs, m, 40, 0, device="cpu",
                                    mesh=placed)
    theirs = ref_ss.check_segmented_batch(
        [ref_packing.encode_history(h, rm) for h in hs], rm, 40, 0)
    assert ours == ones == theirs
    assert {r["valid"] for r in ours} == {True, False}


def test_check_passes_its_mesh_to_the_segmented_scan(pin, monkeypatch):
    """A check whose long histories take the segmented scan hands it the
    check's fan-out mesh: one launch a placement, the result dicts one
    device's."""
    m, _ = _models("register")
    rng = random.Random(7)
    h = random_valid_history(rng, "register", n_ops=5600, n_procs=4,
                             crash_p=0.01, max_crashes=2)
    bad, _ = corrupt_read(h, rng, 4)
    hs = [h, bad]
    monkeypatch.setenv("JGRAFT_SEGMENT", "1")
    seen = []
    real = ss._segment_tables
    monkeypatch.setattr(ss, "_segment_tables", lambda b, mo, devices: (
        seen.append(len(devices)) or real(b, mo, devices)))
    whole = check_histories(hs, m, device="cpu")
    pin(3)
    fanned = check_histories(hs, m, device="cpu")
    assert seen == [1, 3]
    assert [_strip(r) for r in fanned] == [_strip(r) for r in whole]
    assert [r["valid?"] for r in fanned] == [True, False]
    assert {r["kernel"] for r in fanned} == {"dense-seg"}


# ------------------------------------------------------------ autotune


@pytest.mark.parametrize("knob", [None, "2", "3"])
def test_fanout_candidates_and_sort_rung_equal_reference(knob, pin,
                                                         monkeypatch):
    """At the reference's width (8, or capped by the knob): the fan-out
    candidates, the default plan's fan-out and the tuned sort rung's
    placement for every fan-out."""
    pin(8)
    if knob is not None:
        monkeypatch.setenv("JGRAFT_GROUP_DEVICES", knob)
    assert autotune._fanout_candidates() == ref_at._fanout_candidates()
    assert asdict(autotune.default_plan("dense")) == \
        asdict(ref_at.default_plan("dense"))
    for fan in (0, 1, 2, 3, 8, 9):
        ours = autotune.sort_rung_sharding(TunedPlan("sort", 0, 4, fan))
        theirs = ref_at.sort_rung_sharding(ref_at.TunedPlan("sort", 0, 4,
                                                            fan))
        assert _size(ours) == _ref_size(theirs)
        if ours is not None:
            assert autotune.sort_rung_sharding(
                TunedPlan("sort", 0, 4, fan), device="cpu") == ours
    assert autotune.sort_rung_sharding(None) is None


def test_tuned_sort_rung_over_placements_equals_one_device(pin,
                                                           monkeypatch):
    """A sort rung under a plan of fan-out 3 runs over three placements
    and gives one device's result dicts."""
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    m, _ = _models("list-append")
    hs = _histories("list-append", 9, n=8, n_ops=16, corrupt_every=3)
    encs = [encode_history(h, m) for h in hs]
    plan = TunedPlan("sort", 0, 0, 3)
    monkeypatch.setattr(autotune, "tuned_sort_plan",
                        lambda *a, **kw: plan)
    seen = []
    real = schedule.run_chunked

    def spy(launches, *a, **kw):
        seen.extend(_size(ln.device) for ln in launches)
        return real(launches, *a, **kw)

    monkeypatch.setattr("jepsen_jgroups_raft_tpu_torch.checker."
                        "linearizable.run_chunked", spy)
    one = check_histories(hs, m, device="cpu")
    pin(3)
    spread = check_histories(hs, m, device="cpu")
    assert [_strip(r) for r in spread] == [_strip(r) for r in one]
    assert seen and set(seen[:len(seen) // 2]) == {1} \
        and set(seen[len(seen) // 2:]) == {3}
    assert len(encs) == len(hs)


# ---------------------------------------------------- a two-rank cluster

#: A rank's program: 2 placements of the CPU, then `selfcheck.main`.
PINNED_SELFCHECK = (
    "import sys\n"
    "from jepsen_jgroups_raft_tpu_torch import platform\n"
    "from jepsen_jgroups_raft_tpu_torch.parallel import selfcheck\n"
    "platform.pin_placements(2, 'cpu')\n"
    "sys.exit(selfcheck.main(sys.argv[1:]))\n")


def test_two_process_gloo_cluster_with_local_fan_out(monkeypatch):
    """selfcheck on two gloo ranks on the CPU, each fanning its launches
    out over 2 placements: every rank returns one process's verdicts of
    the whole batch (dense, auto, macro on and off, a 3-row batch whose
    first shard is empty at granularity 2), the global counts of one
    process, granularity 2 and the cluster's four placements."""
    # each rank pins its 2 placements, then runs selfcheck's main
    outs = launch.launch_local_cluster(
        2, [sys.executable, "-c", PINNED_SELFCHECK,
            "--device", "cpu", "--global",
            "--histories", "10", "--wide", "2"],
        env_extra={"PYTHONPATH": str(ROOT), "JGRAFT_LIN_FASTPATH": "0",
                   "JGRAFT_AUTOTUNE": "0"},
        timeout_s=150)
    got = []
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-3000:]}"
        [line] = [ln for ln in out.splitlines()
                  if ln.startswith("SELFCHECK ")]
        got.append(json.loads(line[len("SELFCHECK "):]))
    hs = seeded_batch(11, 10, 30, n_wide=2, corrupt_every=3)
    model = MODELS["cas-register"]()
    want = {}
    for macro in ("1", "0"):
        monkeypatch.setenv("JGRAFT_MACRO_EVENTS", macro)
        for alg in ("dense", "auto"):
            want[f"macro={macro},{alg}"] = [
                r["valid?"] for r in check_histories(hs, model, alg,
                                                     device="cpu")]
    tiny = [r["valid?"] for r in check_histories(hs[:3], model, "dense",
                                                 device="cpu")]
    counts = {}
    for name, m, rows in (
            ("register", model, hs[:10]),
            ("counter", MODELS["counter"](),
             seeded_batch(12, 10, 30, kind="counter"))):
        es = [encode_history(h, m) for h in rows]
        b = packing.pack_macro_batch(es)
        counts[name] = list(mesh.check_batch_sharded(
            m, b["events"], device="cpu", dense=ds.dense_plan(m, es),
            macro_p=b["macro_p"])[2:])
    assert {False, True} <= set(want["macro=1,dense"])
    for rank, r in enumerate(got):
        assert (r["rank"], r["world"], r["device"]) == (rank, 2, "cpu")
        assert r["granularity"] == 2
        assert r["global_mesh"] == [[0, "cpu"], [0, "cpu"], [1, "cpu"],
                                    [1, "cpu"]]
        assert {k: v["verdicts"] for k, v in r["checks"].items()} == want
        lo, hi = packing.shard_bounds(len(hs), 2, rank, 2)
        kernels = r["checks"]["macro=1,dense"]["kernels"]
        assert all(k == "remote-shard" for i, k in enumerate(kernels)
                   if not lo <= i < hi)
        assert not any(k == "remote-shard" for k in kernels[lo:hi])
        assert r["tiny"] == tiny and r["empty_shard"] == tiny[:1]
        assert {k: list(v) for k, v in r["global"].items()} == counts


# ------------------------------------------------- no fallback hides one


def _fail_on_call(fn, n):
    """fn, raising RuntimeError on its n-th call (1-based): a launch that
    fails on one placement."""
    calls = [0]

    def wrapped(*a, **kw):
        calls[0] += 1
        if calls[0] == n:
            raise RuntimeError("launch failed on this placement")
        return fn(*a, **kw)

    return wrapped


@pytest.mark.parametrize("bad", [1, 2, 3])
def test_a_failed_launch_on_any_placement_raises(bad, pin, monkeypatch):
    """A launch that fails on one placement makes the call raise: the
    wavefront (the first span's launch on shard `bad`), the one-shot
    groups and `check_batch_sharded`'s dense arm and ladder, and the
    segment batch. Nothing drops to one placement or to the host."""
    m, _ = _models("register")
    hs = _histories("register", 13, n=9, n_ops=12, n_procs=3)
    encs = [encode_history(h, m) for h in hs]
    [(idxs, plan)], _ = ds.dense_plans_grouped(m, encs)
    batch = packing.pack_batch([encs[i] for i in idxs])
    init, step = ds.make_dense_chunk_checker(m, plan.kind, plan.n_slots,
                                             plan.n_states)
    placed = mesh.Mesh(("cpu",) * 3)
    with pytest.raises(RuntimeError, match="this placement"):
        schedule.run_chunked([schedule.ChunkLaunch(
            events=batch["events"], n_events=batch["n_events"],
            init_fn=init, step_fn=_fail_on_call(step, bad),
            val_of=plan.val_of, device=placed)], chunk=4)
    monkeypatch.setattr(schedule, "dense_scan",
                        _fail_on_call(schedule.dense_scan, bad))
    with pytest.raises(RuntimeError, match="this placement"):
        mesh.check_batch_sharded(m, batch["events"], placed,
                                 dense=ds.dense_plan(m, encs))
    monkeypatch.setattr(schedule, "sort_scan",
                        _fail_on_call(schedule.sort_scan, bad))
    with pytest.raises(RuntimeError, match="this placement"):
        mesh.check_batch_sharded(m, batch["events"], placed,
                                 n_slots=ls.bucket_slots(plan.n_slots))
    long = [encode_history(random_valid_history(
        random.Random(2), "register", n_ops=6000, n_procs=4,
        crash_p=0.01, max_crashes=2), m)]
    monkeypatch.setattr(ss, "segment_scan",
                        _fail_on_call(ss.segment_scan, bad))
    pin(3)
    with pytest.raises(RuntimeError, match="this placement"):
        ss.check_segmented_batch(long, m, 40, 0, device="cpu",
                                 mesh=mesh.chunk_sharding(device="cpu"))
