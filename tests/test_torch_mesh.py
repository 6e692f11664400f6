"""B10, the batch mesh, on the CPU: the port's per-process packers and
`parallel.mesh` against the reference's `parallel/mesh.py` on its
8-device CPU mesh (the same seeded histories, encoded by each package),
and B10's verdict counts against numpy.

Tolerance: exact — every pack is compared byte for byte, every flag and
count for equality."""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.history import packing as ref_packing
from jepsen_jgroups_raft_tpu.models.counter import Counter as RefCounter
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu.ops.dense_scan import dense_plan as ref_plan
from jepsen_jgroups_raft_tpu.parallel import mesh as ref_mesh
from jepsen_jgroups_raft_tpu_torch.history import packing
from jepsen_jgroups_raft_tpu_torch.history.synth import (burst_history,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import CasRegister, Counter
from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc
from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_plan
from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import (DEFAULT_N_CONFIGS,
                                                          bucket_slots)
from jepsen_jgroups_raft_tpu_torch.parallel import mesh
from jepsen_jgroups_raft_tpu_torch.parallel.selfcheck import corrupt_read

torch.set_num_threads(1)

CPU = mesh.make_mesh("cpu")


def _mixed(seed=5, n=13, n_ops=40):
    """Histories with macro-interesting shapes: crashed trailing opens,
    runs longer than small payload widths, varied lengths, a third of
    them corrupted."""
    rng = random.Random(seed)
    hs = []
    for i in range(n):
        h = random_valid_history(rng, "register", n_ops=n_ops,
                                 n_procs=4 + (i % 3) * 6, crash_p=0.1,
                                 max_crashes=4)
        if i % 3 == 0:
            h, _ = corrupt_read(h, rng, 4)
        hs.append(h)
    return hs


def _encs(hs, port_model=CasRegister(), ref_model=RefReg()):
    return ([packing.encode_history(h, port_model) for h in hs],
            [ref_packing.encode_history(h, ref_model) for h in hs])


def _same_pack(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ----------------------------------------------------- per-process packing


@pytest.mark.parametrize("macro", [True, False])
@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("pad", [0, 5])
def test_shard_packs_equal_reference_and_whole_pack(macro, n_shards, pad):
    encs, ref_encs = _encs(_mixed())
    n_rows = len(encs) + pad if pad else None
    shard = packing.pack_macro_batch_shard if macro else \
        packing.pack_batch_shard
    ref_shard = ref_packing.pack_macro_batch_shard if macro else \
        ref_packing.pack_batch_shard
    parts = [shard(encs, p, n_shards, n_rows=n_rows)
             for p in range(n_shards)]
    for p, part in enumerate(parts):
        _same_pack(part, ref_shard(ref_encs, p, n_shards, n_rows=n_rows))
    whole = (packing.pack_macro_batch if macro else packing.pack_batch)(encs)
    B = len(encs)
    for k, v in whole.items():
        if not isinstance(v, np.ndarray):
            assert all(part[k] == v for part in parts), k
            continue
        cat = np.concatenate([part[k] for part in parts])
        assert cat.shape[0] == B + pad
        assert np.array_equal(cat[:B], v), k
        # the global padding rows are EV_PAD no-ops (op_index -1)
        assert (cat[B:] == (-1 if k == "op_index" else 0)).all(), k
    assert parts[0]["shard"][0] == 0 and parts[-1]["shard"][1] == B + pad
    assert all(part["n_rows_global"] == B + pad for part in parts)


@pytest.mark.parametrize("macro", [True, False])
def test_shard_pack_refuses_fewer_rows_than_the_batch(macro):
    encs, ref_encs = _encs(_mixed(n=4))
    shard = packing.pack_macro_batch_shard if macro else \
        packing.pack_batch_shard
    ref_shard = ref_packing.pack_macro_batch_shard if macro else \
        ref_packing.pack_batch_shard
    with pytest.raises(ValueError, match="n_rows 2 smaller than batch 4"):
        shard(encs, 0, 2, n_rows=2)
    with pytest.raises(ValueError, match="n_rows 2 smaller than batch 4"):
        ref_shard(ref_encs, 0, 2, n_rows=2)


def test_macro_row_count_matches_compaction_and_reference():
    encs, _ = _encs(_mixed(n=6))
    for e in encs:
        for P in (1, 2, 4, 16):
            n = packing.macro_row_count(e.events, P)
            assert n == packing.macro_compact(e.events, P).shape[0]
            assert n == ref_packing.macro_row_count(e.events, P)


# ------------------------------------------------------ check_batch_sharded


def _ladder_histories():
    """Burst rows (every op open at once: frontiers past C = 64, some of
    them past C = 256 too), valid and corrupted, and ordinary rows; 13
    rows, an odd batch the reference pads to 16."""
    rng = random.Random(3)
    hs = []
    for i in range(9):
        h = burst_history(rng, "register", rng.randint(6, 11))
        if i % 2:
            h, _ = corrupt_read(h, rng, 4)
        hs.append(h)
    hs += [random_valid_history(rng, "register", n_ops=20, n_procs=3)
           for _ in range(4)]
    return hs


def _same_result(ours, theirs):
    ok, ovf, nv, nu = ours
    r_ok, r_ovf, r_nv, r_nu = theirs
    assert ok.dtype == ovf.dtype == np.bool_
    assert np.array_equal(ok, np.asarray(r_ok))
    assert np.array_equal(ovf, np.asarray(r_ovf))
    assert (nv, nu) == (int(r_nv), int(r_nu))


@pytest.fixture(scope="module")
def ladder():
    hs = _ladder_histories()
    encs, ref_encs = _encs(hs)
    W = bucket_slots(max(e.n_slots for e in encs))
    ev = packing.pack_batch(encs)["events"]
    ref_ev = ref_packing.pack_batch(ref_encs)["events"]
    assert np.array_equal(ev, ref_ev)
    return ev, W


def test_sort_ladder_escalates_as_the_reference(ladder):
    ev, W = ladder
    ours = mesh.check_batch_sharded(CasRegister(), ev, CPU, n_slots=W)
    theirs = ref_mesh.check_batch_sharded(RefReg(), ev, n_slots=W)
    _same_result(ours, theirs)
    ok, ovf, _, n_unknown = ours
    # the rows undecided at C = 64 escalate: at C = 256 some end VALID,
    # some INVALID, some stay undecided
    p_ok, p_ovf, _, _ = mesh.check_batch_sharded(CasRegister(), ev, CPU,
                                                 n_configs=64, n_slots=W)
    up = p_ovf & ~p_ok
    assert up.sum() >= 3
    assert (ok & up).any() and (~ok & ~ovf & up).any() and n_unknown > 0
    assert len(ev) % 2 == 1  # odd B: the reference pads, the port does not


def test_ladder_leaves_register_rows_undecided_as_the_reference():
    """North-star-shaped register rows (5 processes, crash_p 0.05, at
    most 3 crashes; 100 ops here) through the whole ladder: frontiers
    past C = 256 leave rows undecided, in the reference's ladder as in
    the port's, and no row is INVALID."""
    rng = random.Random(20260729)
    hs = [random_valid_history(rng, "register", n_ops=100, n_procs=5,
                               crash_p=0.05, max_crashes=3)
          for _ in range(8)]
    encs, ref_encs = _encs(hs)
    W = bucket_slots(max(e.n_slots for e in encs))
    batch = packing.pack_macro_batch(encs)
    ours = mesh.check_batch_sharded(CasRegister(), batch["events"], CPU,
                                    n_slots=W, macro_p=batch["macro_p"])
    ref_batch = ref_packing.pack_macro_batch(ref_encs)
    theirs = ref_mesh.check_batch_sharded(RefReg(), ref_batch["events"],
                                          n_slots=W,
                                          macro_p=ref_batch["macro_p"])
    _same_result(ours, theirs)
    ok, ovf, n_valid, n_unknown = ours
    assert n_unknown > 0 and n_valid + n_unknown == len(hs)
    assert not (~ok & ~ovf).any()


def test_pinned_rung_and_defer(ladder):
    ev, W = ladder
    fin = mesh.check_batch_sharded(CasRegister(), ev, CPU, n_configs=8,
                                   n_slots=W, defer=True)
    assert callable(fin)
    theirs = ref_mesh.check_batch_sharded(RefReg(), ev, n_configs=8,
                                          n_slots=W)
    _same_result(fin(), theirs)


@pytest.mark.parametrize("macro", [True, False])
def test_sort_ladder_macro_rows(macro):
    hs = _mixed(seed=8, n=11, n_ops=30)
    encs, ref_encs = _encs(hs)
    W = bucket_slots(max(e.n_slots for e in encs))
    pack = packing.pack_macro_batch if macro else packing.pack_batch
    ref_pack = ref_packing.pack_macro_batch if macro else \
        ref_packing.pack_batch
    batch, ref_batch = pack(encs), ref_pack(ref_encs)
    P = batch.get("macro_p")
    assert P == ref_batch.get("macro_p")
    ours = mesh.check_batch_sharded(CasRegister(), batch["events"], CPU,
                                    n_slots=W, macro_p=P)
    theirs = ref_mesh.check_batch_sharded(RefReg(), ref_batch["events"],
                                          n_slots=W, macro_p=P)
    _same_result(ours, theirs)
    assert not ours[0].all() and ours[0].any()


@pytest.mark.parametrize("kind", ["register", "counter"])
@pytest.mark.parametrize("defer", [False, True])
def test_dense_plans_as_the_reference(kind, defer):
    """`dense=`: the domain plan (register, B1) and the mask plan
    (counter, B4), macro rows, an odd batch."""
    rng = random.Random(21)
    hs = [random_valid_history(rng, kind, n_ops=40, n_procs=4,
                               max_crashes=2) for _ in range(11)]
    if kind == "register":
        hs = [corrupt_read(h, rng, 4)[0] if i % 4 == 0 else h
              for i, h in enumerate(hs)]
        models = (CasRegister(), RefReg())
    else:
        hs = [corrupt_read(h, rng, 10**6)[0] if i % 4 == 0 else h
              for i, h in enumerate(hs)]
        models = (Counter(), RefCounter())
    encs, ref_encs = _encs(hs, *models)
    plan, rplan = dense_plan(models[0], encs), ref_plan(models[1], ref_encs)
    assert plan.kind == rplan.kind == ("domain" if kind == "register"
                                       else "mask")
    assert np.array_equal(plan.val_of, rplan.val_of)
    batch = packing.pack_macro_batch(encs)
    ref_batch = ref_packing.pack_macro_batch(ref_encs)
    assert np.array_equal(batch["events"], ref_batch["events"])
    out = mesh.check_batch_sharded(models[0], batch["events"], CPU,
                                   dense=plan, defer=defer,
                                   macro_p=batch["macro_p"])
    if defer:
        out = out()
    theirs = ref_mesh.check_batch_sharded(models[1], ref_batch["events"],
                                          dense=rplan,
                                          macro_p=ref_batch["macro_p"])
    _same_result(out, theirs)
    assert 0 < out[2] < len(hs)


# -------------------------------------------------- the sharded checkers


def _padded(kind):
    """16 rows, the last 5 EV_PAD padding with real False."""
    rng = random.Random(4)
    model, rmodel = (CasRegister(), RefReg()) if kind == "domain" else \
        (Counter(), RefCounter())
    hs = [random_valid_history(rng, "register" if kind == "domain"
                               else "counter", n_ops=30, n_procs=3,
                               max_crashes=1) for _ in range(11)]
    hs = [corrupt_read(h, rng, 4 if kind == "domain" else 10**6)[0]
          if i % 3 == 0 else h for i, h in enumerate(hs)]
    encs, _ = _encs(hs, model, rmodel)
    plan = dense_plan(model, encs)
    batch = packing.pack_batch(encs)
    ev, _, B = packing.pad_batch_bucketed(batch["events"], floor_e=None,
                                          multiple_b=8)
    assert ev.shape[0] == 16 and B == 11
    val_of = np.concatenate([plan.val_of,
                             np.repeat(plan.val_of[:1], 5, axis=0)])
    real = np.arange(16) < 11
    return model, rmodel, plan, ev, val_of, real


@pytest.mark.parametrize("kind", ["domain", "mask"])
def test_dense_checker_masks_padding_rows(kind):
    model, rmodel, plan, ev, val_of, real = _padded(kind)
    fn = mesh.sharded_dense_checker(model, CPU, plan.kind, plan.n_slots,
                                    plan.n_states)
    ok, ovf, nv, nu = fn(torch.from_numpy(ev), torch.from_numpy(val_of),
                         torch.from_numpy(real))
    rfn = ref_mesh.sharded_dense_checker(rmodel, ref_mesh.make_mesh(),
                                         plan.kind, plan.n_slots,
                                         plan.n_states)
    r_ok, r_ovf, r_nv, r_nu = rfn(ev, val_of, real)
    assert np.array_equal(ok.numpy(), np.asarray(r_ok))
    assert np.array_equal(ovf.numpy(), np.asarray(r_ovf))
    assert (int(nv), int(nu)) == (int(r_nv), int(r_nu))
    # the pad rows are trivially ok and masked out of the count
    assert ok[11:].all() and int(nv) == int(ok[:11].sum()) < 11


def test_batch_checker_masks_padding_rows(ladder):
    ev, W = ladder
    pad = np.zeros((3,) + ev.shape[1:], dtype=np.int32)
    ev16 = np.concatenate([ev, pad])
    real = np.arange(16) < len(ev)
    fn = mesh.sharded_batch_checker(CasRegister(), CPU, 64, W)
    ok, ovf, nv, nu = fn(torch.from_numpy(ev16), torch.from_numpy(real))
    rfn = ref_mesh.sharded_batch_checker(RefReg(), ref_mesh.make_mesh(),
                                         64, W)
    r_ok, r_ovf, r_nv, r_nu = rfn(ev16, real)
    assert np.array_equal(ok.numpy(), np.asarray(r_ok))
    assert np.array_equal(ovf.numpy(), np.asarray(r_ovf))
    assert (int(nv), int(nu)) == (int(r_nv), int(r_nu))
    assert ok[len(ev):].all()
    assert int(nv) == int((ok & ~ovf)[:len(ev)].sum())


def test_checkers_refuse_tensors_off_the_mesh_device():
    fn = mesh.sharded_batch_checker(CasRegister(), CPU, 64, 8)
    with pytest.raises(ValueError, match="mesh's device"):
        fn(np.zeros((1, 1, 5), np.int32), torch.ones(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="kind"):
        mesh.sharded_dense_checker(CasRegister(), CPU, "bogus", 4, 4)


# ------------------------------------------------------------ the mesh


def test_mesh_is_this_process_device():
    assert CPU == mesh.Mesh(torch.device("cpu"))
    assert mesh.make_mesh(torch.device("cpu")).device.type == "cpu"


def test_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.check_batch_sharded(CasRegister(),
                                 np.zeros((1, 1, 5), np.int32))


# ------------------------------------- the launches check_batch_sharded makes


def _spy(monkeypatch, module, name):
    """Record the calls of module.name, still calling it."""
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _spy_counts(monkeypatch):
    """Spies on the ways a count can be made: the scans `checker.schedule`
    calls (their counting option) and the standalone `verdict_counts`."""
    from jepsen_jgroups_raft_tpu_torch.checker import schedule

    return ({name: _spy(monkeypatch, schedule, name)
             for name in ("dense_scan", "mask_scan", "sort_scan")},
            _spy(monkeypatch, vc, "verdict_counts"))


@pytest.mark.parametrize("kind", ["domain", "mask"])
def test_dense_arm_is_one_group_of_launch_dense_groups(monkeypatch, kind):
    """`dense=` queues one group through `checker.schedule`'s launch
    helper, counts included, and reads the counts it returns: they come
    from the group's own scan (its counting option), with no standalone
    `verdict_counts` call after it."""
    model, _, plan, ev, _, real = _padded(kind)
    ev = ev[real]
    calls = _spy(monkeypatch, mesh, "launch_dense_groups")
    scans, standalone = _spy_counts(monkeypatch)
    ok, ovf, n_valid, n_unknown = mesh.check_batch_sharded(
        model, ev, CPU, dense=plan)
    [(args, kw)] = calls
    [ln] = args[0]
    assert kw == {"counts": True} and ln.kind == plan.kind
    assert ln.n_events is None and ln.n_slots == plan.n_slots
    assert (n_valid, n_unknown) == (int(ok.sum()), 0) and not ovf.any()
    scan = "mask_scan" if kind == "mask" else "dense_scan"
    assert [c[1]["counts"] for c in scans[scan]] == [True]
    assert standalone == [] and not scans["sort_scan"]


@pytest.mark.parametrize("n_configs", [None, 8])
def test_ladder_launches_no_counts(monkeypatch, ladder, n_configs):
    """The ladder counts on the host: one `run_sort_rung` a rung, whose
    scan asks for no counts, and no `verdict_counts` call whose result
    nothing reads."""
    ev, W = ladder
    rungs = _spy(monkeypatch, mesh, "run_sort_rung")
    scans, standalone = _spy_counts(monkeypatch)
    ok, ovf, n_valid, n_unknown = mesh.check_batch_sharded(
        CasRegister(), ev, CPU, n_configs=n_configs, n_slots=W)
    assert standalone == [] and not scans["dense_scan"]
    assert len(scans["sort_scan"]) == len(rungs)
    assert not any(c[1].get("counts") for c in scans["sort_scan"])
    assert [a[3] for a, _ in rungs] == ([8] if n_configs
                                        else [64, DEFAULT_N_CONFIGS])
    assert (n_valid, n_unknown) == (int(ok.sum()), int((ovf & ~ok).sum()))


@pytest.mark.parametrize("kind", ["domain", "mask"])
def test_launch_dense_groups_counts_and_finalizes(monkeypatch, kind):
    """The launch helper's finalizer gives `run_dense_groups`' verdicts,
    and with counts each group's (n_valid, n_unknown) of its verdicts,
    from each group's own scan (one counting scan a group, no
    `verdict_counts` call)."""
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        DenseLaunch, launch_dense_groups, run_dense_groups)

    model, _, plan, ev, val_of, _ = _padded(kind)
    halves = [slice(0, 7), slice(7, 16)]
    launches = [DenseLaunch(
        events=torch.from_numpy(ev[h]), val_of=torch.from_numpy(val_of[h]),
        n_events=None, n_slots=plan.n_slots, kind=plan.kind)
        for h in halves]
    scans, standalone = _spy_counts(monkeypatch)
    fin = launch_dense_groups(launches, model, counts=True)
    scan = "mask_scan" if kind == "mask" else "dense_scan"
    assert [c[1]["counts"] for c in scans[scan]] == [True, True]
    assert standalone == []
    run, plain = fin(), run_dense_groups(launches, model)
    assert plain.counts is None
    for ok, want, c in zip(run.ok, plain.ok, run.counts):
        assert np.array_equal(ok, want)
        assert c.dtype == np.int64 and c.tolist() == [int(ok.sum()), 0]
    assert not all(ok.all() for ok in run.ok)


# ----------------------------------------------------------- B10's counts


def _np_counts(ok, ovf, real, mode):
    valid = ok & real & (~ovf if mode == "sort" else True)
    return [int(valid.sum()), int((ovf & real).sum())]


@pytest.mark.parametrize("mode", ["dense", "sort"])
@pytest.mark.parametrize("B", [0, 1, 31, 32, 33, 1000])
def test_verdict_counts_plain_against_numpy(mode, B):
    rng = np.random.default_rng(B * 7 + len(mode))
    ok, ovf, real = (rng.random(B) < p for p in (0.7, 0.3, 0.8))
    got = vc.verdict_counts(torch.from_numpy(ok), torch.from_numpy(ovf),
                            torch.from_numpy(real), mode)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
    assert got.tolist() == _np_counts(ok, ovf, real, mode)
    assert vc.verdict_counts_plain(
        torch.from_numpy(ok), torch.from_numpy(ovf),
        torch.from_numpy(real), mode).tolist() == got.tolist()


def test_verdict_counts_takes_slices_and_refuses_bad_input():
    flags = torch.from_numpy(np.random.default_rng(1).random((3, 50)) < 0.5)
    ok, ovf, real = flags[0, 3:40], flags[1, 5:42], flags[2, 1:38]
    got = vc.verdict_counts(ok, ovf, real, "sort")
    assert got.tolist() == _np_counts(ok.numpy(), ovf.numpy(),
                                      real.numpy(), "sort")
    with pytest.raises(ValueError, match="mode"):
        vc.verdict_counts(ok, ovf, real, "both")
    with pytest.raises(TypeError, match="bool"):
        vc.verdict_counts(ok.int(), ovf, real)
    with pytest.raises(ValueError, match="rows"):
        vc.verdict_counts(ok, ovf[1:], real)
    with pytest.raises(ValueError, match="contiguous"):
        vc.verdict_counts(flags[:, 0], flags[:, 1], flags[:, 2])
    before = vc.launch_counts()
    vc.verdict_counts(ok, ovf, real)  # the CPU counts no launch
    assert vc.launch_counts() == before
