"""B10's counts from the scans' counting option, on the CPU: `dense_scan`
(B1), `mask_scan` (B4) and `sort_scan` (B5) with ``counts=True`` against
the reference's `parallel/mesh.py` `sharded_dense_checker` /
`sharded_batch_checker` on a one-device CPU mesh, on the same seeded
batches: real histories (a third of them corrupted), EV_PAD padding
rows, and a `real` mask with holes; odd B, B = 0 and B = 1.

On the CPU the counting option is the plain scan and
`verdict_counts_plain` of its own flags; on the card it is the kernel's
epilogue (tests/test_torch_kernels_gpu.py holds the two equal).

Tolerance: exact — flags and counts are compared for equality."""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.history import packing as ref_packing
from jepsen_jgroups_raft_tpu.models.counter import Counter as RefCounter
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu.parallel import mesh as ref_mesh
from jepsen_jgroups_raft_tpu_torch.history import packing
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models import CasRegister, Counter
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls
from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc
from jepsen_jgroups_raft_tpu_torch.parallel.selfcheck import corrupt_read

torch.set_num_threads(1)

#: batch sizes: empty, one row, odd sizes with padding rows
SIZES = (0, 1, 7, 13)
#: the window and domain a batch without histories is launched at
EMPTY_W, EMPTY_S = 4, 4
#: the sort rung's capacity: small, so that some rows overflow
SORT_C = 8


def _batch(kind: str, B: int, seed: int):
    """(port model, reference model, events [B, E, 5], val_of [B, S], W,
    real [B]) for `kind` "domain" (the register on B1), "mask" (the
    counter on B4) or "sort" (the register on B5): B - B // 3 histories,
    every third corrupted, then EV_PAD rows; `real` False on the padding
    and on about a quarter of the histories."""
    rng = random.Random(seed)
    mask = kind == "mask"
    model, rmodel = (Counter(), RefCounter()) if mask else \
        (CasRegister(), RefReg())
    n_real = B - B // 3
    hs = [random_valid_history(rng, "counter" if mask else "register",
                               n_ops=30, n_procs=3, max_crashes=1)
          for _ in range(n_real)]
    hs = [corrupt_read(h, rng, 10**6 if mask else 4)[0] if i % 3 == 0
          else h for i, h in enumerate(hs)]
    encs = [packing.encode_history(h, model) for h in hs]
    ref_encs = [ref_packing.encode_history(h, rmodel) for h in hs]
    if encs:
        batch = packing.pack_batch(encs)["events"]
        assert np.array_equal(batch, ref_packing.pack_batch(ref_encs)
                              ["events"])
        plan = ds.dense_plan(model, encs)
        W = plan.n_slots if kind != "sort" else \
            ls.bucket_slots(max(e.n_slots for e in encs))
        val_of = plan.val_of
    else:
        batch = np.zeros((0, 8, 5), dtype=np.int32)
        W, val_of = EMPTY_W, np.zeros((0, EMPTY_S), dtype=np.int32)
    events = np.zeros((B,) + batch.shape[1:], dtype=np.int32)
    events[:n_real] = batch
    vo = np.zeros((B, val_of.shape[1]), dtype=np.int32)
    vo[:n_real] = val_of
    vo[n_real:] = val_of[:1] if n_real else 0
    real = (np.arange(B) < n_real) & \
        (np.random.default_rng(seed).random(B) < 0.75)
    return model, rmodel, events, vo, W, real


def _ref_dense(kind, rmodel, events, val_of, W, real):
    fn = ref_mesh.sharded_dense_checker(rmodel, ref_mesh.make_mesh(1), kind,
                                        W, int(val_of.shape[1]))
    return fn(events, val_of, real)


@pytest.mark.parametrize("B", SIZES, ids=lambda b: f"B{b}")
@pytest.mark.parametrize("kind", ["domain", "mask"])
def test_dense_counting_option_matches_reference(kind, B):
    model, rmodel, ev, vo, W, real = _batch(kind, B, seed=31 + B)
    if kind == "mask":
        ok, counts = ds.mask_scan(torch.from_numpy(ev), W, model=model,
                                  counts=True, real=torch.from_numpy(real))
    else:
        ok, counts = ds.dense_scan(torch.from_numpy(ev),
                                   torch.from_numpy(vo), W, model=model,
                                   counts=True, real=torch.from_numpy(real))
    r_ok, _, r_nv, r_nu = _ref_dense(kind, rmodel, ev, vo, W, real)
    assert counts.dtype == torch.int64 and tuple(counts.shape) == (2,)
    assert np.array_equal(ok.numpy(), np.asarray(r_ok))
    assert counts.tolist() == [int(r_nv), int(r_nu)]
    assert counts.tolist() == [int((ok.numpy() & real).sum()), 0]
    if B > 3:  # the mask has holes that change the count
        assert int((ok.numpy() & ~real).sum()) > 0


@pytest.mark.parametrize("B", SIZES, ids=lambda b: f"B{b}")
def test_sort_counting_option_matches_reference(B):
    model, rmodel, ev, _, W, real = _batch("sort", B, seed=57 + B)
    ok, ovf, counts = ls.sort_scan(torch.from_numpy(ev), W, SORT_C,
                                   model=model, counts=True,
                                   real=torch.from_numpy(real))
    fn = ref_mesh.sharded_batch_checker(rmodel, ref_mesh.make_mesh(1),
                                        SORT_C, W)
    r_ok, r_ovf, r_nv, r_nu = fn(ev, real)
    assert np.array_equal(ok.numpy(), np.asarray(r_ok))
    assert np.array_equal(ovf.numpy(), np.asarray(r_ovf))
    assert counts.tolist() == [int(r_nv), int(r_nu)]
    if B > 3:  # overflow and ok both occur among the real rows
        assert int((ovf.numpy() & real).sum()) > 0
        assert int((ok.numpy() & ~ovf.numpy() & real).sum()) > 0


@pytest.mark.parametrize("kind", ["domain", "mask", "sort"])
def test_counting_option_defaults_and_refusals(kind):
    """Without `real` every row counts; the flags are the non-counting
    call's; a `real` of the wrong length or dtype is refused; the CPU
    counts no kernel launch."""
    model, _, ev, vo, W, _ = _batch(kind, 7, seed=5)
    ev_t, vo_t = torch.from_numpy(ev), torch.from_numpy(vo)

    def scan(**kw):
        if kind == "sort":
            return ls.sort_scan(ev_t, W, SORT_C, model=model, **kw)
        if kind == "mask":
            return ds.mask_scan(ev_t, W, model=model, **kw)
        return ds.dense_scan(ev_t, vo_t, W, model=model, **kw)

    def launches():
        return (vc.launch_counts(), ds.launch_counts(), ls.launch_counts(),
                ds.count_launch_counts(), ls.count_launch_counts())

    before = launches()
    plain = scan()
    out = scan(counts=True)
    flags = [plain] if kind != "sort" else list(plain)
    for a, b in zip(flags, out[:-1]):
        assert torch.equal(a, b)
    want = vc.verdict_counts_plain(
        flags[0], flags[1] if kind == "sort" else torch.zeros_like(flags[0]),
        torch.ones_like(flags[0]), "sort" if kind == "sort" else "dense")
    assert out[-1].tolist() == want.tolist()
    with pytest.raises(TypeError, match="real"):
        scan(counts=True, real=torch.ones(6, dtype=torch.bool))
    with pytest.raises(TypeError, match="real"):
        scan(counts=True, real=torch.ones(7, dtype=torch.uint8))
    assert launches() == before
