"""The port's host encoder and packers are byte-identical to the
reference's on register histories: valid and corrupted, with crashes,
both prune modes, both encode paths, legacy and macro packing, spill
rows at small payload widths, and the bucketed padding. Tolerance:
exact equality of every int32 array and every count."""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.history import packing as ref
from jepsen_jgroups_raft_tpu.history import synth as ref_synth
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu_torch.history import packing as port
from jepsen_jgroups_raft_tpu_torch.history import synth as port_synth
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister

torch.set_num_threads(1)


def _corrupt_read(ops, rng):
    ops = list(ops)
    reads = [j for j, op in enumerate(ops)
             if op.type == "ok" and op.f == "read" and op.value is not None]
    if reads:
        j = rng.choice(reads)
        ops[j] = ops[j].replace(value=ops[j].value + 1)
    return ops


def _histories(seed, n=24):
    """Register histories from the port's generator, which must replay
    the reference's generator exactly (checked here), half corrupted."""
    knobs = random.Random(seed * 7)
    rng_p, rng_r = random.Random(seed), random.Random(seed)
    out = []
    for i in range(n):
        kw = dict(n_ops=knobs.randint(5, 120), n_procs=knobs.randint(1, 6),
                  crash_p=knobs.uniform(0.0, 0.4),
                  max_crashes=knobs.randint(0, 5))
        h = port_synth.random_valid_history(rng_p, "register", **kw)
        hr = ref_synth.random_valid_history(rng_r, "register", **kw)
        assert [o.to_dict() for o in h] == [o.to_dict() for o in hr]
        if i % 2:
            h = _corrupt_read(h, knobs)
        out.append(h)
    return out


def _same_enc(a, b):
    assert np.array_equal(a.events, b.events)
    assert a.events.dtype == b.events.dtype == np.int32
    assert np.array_equal(a.op_index, b.op_index)
    assert np.array_equal(a.proc, b.proc)
    assert (a.n_slots, a.n_ops, a.n_events) == (b.n_slots, b.n_ops,
                                                b.n_events)


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "per-pair"])
@pytest.mark.parametrize("prune", [True, False], ids=["prune", "noprune"])
def test_encode_history_byte_identical(monkeypatch, vector, prune):
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    for h in _histories(11 + int(prune)):
        _same_enc(port.encode_history(h, CasRegister(), prune=prune),
                  ref.encode_history(h, RefReg(), prune=prune))


def _pairs(seed):
    hs = _histories(seed)
    return ([port.encode_history(h, CasRegister()) for h in hs],
            [ref.encode_history(h, RefReg()) for h in hs])


def _same_dict(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_pack_batch_byte_identical():
    pe, re_ = _pairs(21)
    _same_dict(port.pack_batch(pe), ref.pack_batch(re_))
    _same_dict(port.pack_batch(pe, n_events=300),
               ref.pack_batch(re_, n_events=300))


@pytest.mark.parametrize("P", [1, 2, 3, 4, 16])
def test_macro_compact_byte_identical_with_spill(P):
    pe, re_ = _pairs(31)
    spilled = 0
    for a, b in zip(pe, re_):
        ma = port.macro_compact(a.events, P)
        assert np.array_equal(ma, ref.macro_compact(b.events, P))
        spilled += int((ma[:, 0] == port.EV_OPEN).sum())
        assert port.max_open_run(a.events) == ref.max_open_run(b.events)
    if P <= 2:
        assert spilled > 0  # small P must exercise latch-only spill rows


@pytest.mark.parametrize("cap", [2, 16])
def test_pack_macro_batch_byte_identical(cap):
    pe, re_ = _pairs(41)
    _same_dict(port.pack_macro_batch(pe, cap=cap),
               ref.pack_macro_batch(re_, cap=cap))
    assert port.bucket_opens(5, cap) == ref.bucket_opens(5, cap)


@pytest.mark.parametrize("kw", [{}, {"floor_e": None}, {"multiple_b": 3},
                                {"floor_b": 1, "floor_e": 8}])
def test_pad_batch_bucketed_byte_identical(kw):
    pe, re_ = _pairs(51)
    for packer in ("pack_batch", "pack_macro_batch"):
        ev_p = getattr(port, packer)(pe)["events"]
        ev_r = getattr(ref, packer)(re_)["events"]
        tab = np.arange(len(pe) * 4, dtype=np.int32).reshape(len(pe), 4)
        a = port.pad_batch_bucketed(ev_p, (tab,), **kw)
        b = ref.pad_batch_bucketed(ev_r, (tab,), **kw)
        assert np.array_equal(a[0], b[0]) and a[0].dtype == b[0].dtype
        assert np.array_equal(a[1][0], b[1][0]) and a[2] == b[2]
    for n in range(1, 200, 7):
        assert port.bucket_rows(n) == ref.bucket_rows(n)
