"""The port's grow-only set model, and the checker's ladder, against the
reference's.

`torch_step` must equal the reference's `jax_step` (and the scalar
`step` for the two real opcodes) over masks that include bit 31;
`mask_delta`, `always_legal`, `step_columnar`, the encodings (both
encoder paths), `mask_eligible` and `dense_domain` must be identical
too. Then the checker: the port's `check_encoded(..., algorithm="auto",
device="cpu")` against the reference's `check_histories(...,
algorithm="auto")` (run under tests/conftest.py's pins) on set batches
that take all three kernels (domain, mask, the sort ladder), a set batch
with `n_configs=8` pinned (rows that overflow at the one rung go to the
host oracle), and register / counter rows beyond the dense caps; and the
port's "dense" against the reference's "jax". Results agree on valid?,
kernel, decided-tier, op-count and concurrency-window. Everything is
integers and booleans: exact equality.
"""

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.history.synth import (build_history,
                                                   random_valid_history)
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu.models.setmodel import GSet as RefGSet
from jepsen_jgroups_raft_tpu.models.setmodel import element_mask as ref_mask
from jepsen_jgroups_raft_tpu_torch import interop, models
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import check_encoded
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.models.setmodel import (ADD, READ, GSet,
                                                           element_mask)

torch.set_num_threads(1)

KEYS = ("valid?", "kernel", "decided-tier", "op-count", "concurrency-window")
MASKS = [0, 1, 2, 3, 5, 1 << 30, -2**31, -1, 2**31 - 1, 0x55555555,
         -0x55555556]


def _grid(f):
    rows = list(itertools.product(MASKS, MASKS))
    s, a = (np.asarray(c, dtype=np.int32) for c in zip(*rows))
    return s, np.full_like(s, f), a, np.zeros_like(s)


@pytest.mark.parametrize("f", [ADD, READ, 2, -1])
def test_torch_step_matches_jax_step(f):
    s, fv, a, b = _grid(f)
    ns, legal = GSet().torch_step(*(torch.from_numpy(x) for x in (s, fv, a,
                                                                   b)))
    r_ns, r_legal = RefGSet().jax_step(*(jnp.asarray(x) for x in (s, fv, a,
                                                                   b)))
    assert ns.dtype == torch.int32
    assert ns.tolist() == np.asarray(r_ns).tolist()
    assert legal.tolist() == np.asarray(r_legal).tolist()
    c_ns, c_legal = GSet().step_columnar(s, fv, a, b)
    r_cns, r_clegal = RefGSet().step_columnar(s, fv, a, b)
    assert c_ns.tolist() == r_cns.tolist() == ns.tolist()
    assert c_legal.tolist() == r_clegal.tolist() == legal.tolist()
    if f in (ADD, READ):
        for st, aa in zip(s.tolist(), a.tolist()):
            assert GSet().step(st, f, aa, 0) == RefGSet().step(st, f, aa, 0)
    delta = GSet().mask_delta(*(torch.from_numpy(x) for x in (fv, a, b)))
    assert delta.tolist() == np.asarray(
        RefGSet().mask_delta(jnp.asarray(fv), jnp.asarray(a),
                             jnp.asarray(b))).tolist()
    # always_legal is exactly the legality term that reads no state
    always = GSet().always_legal(torch.from_numpy(fv))
    assert always.tolist() == [f == ADD] * len(s)
    assert (legal | ~always).all()


def _set_histories(seed, n, n_ops, n_procs, crash_p, max_crashes,
                   value_range, corrupt=True):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = list(random_valid_history(rng, "set", n_ops=n_ops,
                                      n_procs=n_procs, crash_p=crash_p,
                                      max_crashes=max_crashes,
                                      value_range=value_range))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read" and op.value]
        if corrupt and i % 2 and reads:
            j = rng.choice(reads)  # an observed element disappears
            h[j] = h[j].replace(value=h[j].value[1:])
        out.append(h)
    return out


def _handmade():
    return [build_history([
        (0, "invoke", "add", 31), (0, "ok", "add", 31),
        (1, "invoke", "add", 0), (1, "fail", "add", 0),
        (2, "invoke", "add", 5), (2, "info", "add", 5),
        (3, "invoke", "read", None), (3, "info", "read", None),
        (4, "invoke", "read", None), (4, "ok", "read", [31, 5]),
        (5, "invoke", "read", None), (5, "ok", "read", []),
        (6, "invoke", "add", 7)])]


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "per_pair"])
def test_encodings_byte_identical(monkeypatch, vector):
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    hs = (_set_histories(3, 12, 60, 5, 0.1, 3, 32)
          + _set_histories(4, 6, 40, 3, 0.2, 2, 4) + _handmade())
    for h in hs:
        mine, theirs = encode_history(h, GSet()), ref_enc(h, RefGSet())
        assert np.array_equal(mine.events, theirs.events)
        assert mine.events.dtype == np.int32
        assert np.array_equal(mine.op_index, theirs.op_index)
        assert np.array_equal(mine.proc, theirs.proc)
        assert (mine.n_slots, mine.n_ops) == (theirs.n_slots, theirs.n_ops)


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "per_pair"])
def test_bad_elements_raise_like_reference(monkeypatch, vector):
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    for bad in (build_history([(0, "invoke", "add", 32)]),
                build_history([(0, "invoke", "read", None),
                               (0, "ok", "read", [40])]),
                build_history([(0, "invoke", "pop", 1)])):
        for model, enc in ((GSet(), encode_history), (RefGSet(), ref_enc)):
            with pytest.raises(ValueError):
                enc(bad, model)
    for v in ([0, 31], [], None, 7, [3, 3]):
        assert element_mask(v) == ref_mask(v)


def _routing_batch():
    """Set histories of every routing kind: few distinct adds (domain),
    distinct fresh elements (mask), re-added elements (the ladder)."""
    hs = (_set_histories(7, 10, 24, 3, 0.1, 1, 3)
          + _set_histories(8, 30, 16, 4, 0.2, 2, 32)
          + _set_histories(9, 10, 60, 5, 0.05, 3, 32))
    return [encode_history(h, RefGSet()) for h in hs]


def test_mask_eligible_and_dense_domain_match_reference():
    encs = _routing_batch()
    kinds = set()
    for e in encs:
        assert GSet().mask_eligible(e.events) == \
            RefGSet().mask_eligible(e.events)
        assert GSet().dense_domain(e.events) == \
            RefGSet().dense_domain(e.events)
        kinds.add("domain" if GSet().dense_domain(e.events) is not None
                  else "mask" if GSet().mask_eligible(e.events) else "rest")
    assert kinds == {"domain", "mask", "rest"}
    assert GSet(1 << 3).mask_eligible(np.array([[1, 0, ADD, 1 << 3, 0]],
                                               np.int32)) is False


def test_registry_and_kernel_id():
    assert models.MODELS["set"] is GSet
    assert GSet.KERNEL_MODEL == 3 and not GSet.mask_determined
    assert GSet.name == RefGSet.name
    m = interop.model_from_reference(RefGSet([2, 9]))
    assert isinstance(m, GSet) and m.init_state() == RefGSet(
        [2, 9]).init_state()
    assert GSet(3).cache_key() != GSet(5).cache_key()


def _view(r):
    return {k: r.get(k) for k in KEYS}


def _compare(hs, kind, **kw):
    ref_m = REF_MODELS[kind]()
    port_m = interop.model_from_reference(ref_m)
    encs = [interop.encoding_from_reference(ref_enc(h, ref_m)) for h in hs]
    ours = check_encoded(encs, port_m, algorithm=kw.pop("algorithm", "auto"),
                         device="cpu", **kw)
    theirs = ref_check(hs, ref_m, **kw)
    assert [_view(r) for r in ours] == [_view(r) for r in theirs]
    return ours


def test_auto_set_batches_match_reference():
    hs = (_set_histories(7, 6, 24, 3, 0.1, 1, 3)
          + _set_histories(8, 12, 16, 4, 0.2, 2, 32)
          + _set_histories(9, 8, 80, 5, 0.05, 3, 32))
    ours = _compare(hs, "set")
    assert {r["decided-tier"] for r in ours} == {"dense", "mask", "sort"}
    verdicts = [r["valid?"] for r in ours]
    assert True in verdicts and False in verdicts


def test_auto_set_pinned_capacity_escalates_like_reference():
    """One rung of 8 configurations: rows that overflow there are
    undecided and go to the host oracle, as in the reference."""
    hs = _set_histories(11, 16, 12, 4, 0.0, 0, 3)
    ours = _compare(hs, "set", n_configs=8)
    tiers = [r["decided-tier"] for r in ours]
    assert "sort" in tiers and "host" in tiers


def test_auto_register_and_counter_beyond_dense_caps_match_reference():
    """Registers with a window of 11-12 or a domain beyond 16 values
    take the ladder under auto; a pinned capacity sends counter rows
    (mask-eligible otherwise) through it too."""
    rng = random.Random(12)
    ref_m = REF_MODELS["cas-register"]()
    regs = []
    while len(regs) < 4:
        wide = len(regs) % 2 == 0
        h = random_valid_history(rng, "register", n_ops=40, n_procs=5,
                                 crash_p=0.5, max_crashes=7 if wide else 3,
                                 value_range=3 if wide else 30)
        e = ref_enc(h, ref_m)
        d = ref_m.dense_domain(e.events)
        if (e.n_slots in (11, 12)) if wide else \
                (e.n_slots <= 10 and len(d) > 16):
            regs.append(h)
    ours = _compare(regs, "cas-register")
    assert "sort" in {r["decided-tier"] for r in ours}
    ctrs = [random_valid_history(rng, "counter", n_ops=40, n_procs=4,
                                 crash_p=0.2, max_crashes=2)
            for _ in range(4)]
    ours = _compare(ctrs, "counter", n_configs=16)
    assert "sort" in {r["decided-tier"] for r in ours}


def test_dense_algorithm_matches_reference_jax():
    """The device-only algorithm runs the ladder for every row up to
    127 slots (a 13-slot window included), as the reference's "jax"."""
    rows = [(0, "invoke", "write", 0), (0, "ok", "write", 0)]
    rows += [(k + 1, "invoke", "cas", (k, k + 1)) for k in range(12)]
    wide = build_history(rows + [(20, "invoke", "read", None),
                                 (20, "ok", "read", 12)])
    ref_m = REF_MODELS["cas-register"]()
    port_m = interop.model_from_reference(ref_m)
    hs = [wide] + [random_valid_history(random.Random(s), "register",
                                        n_ops=40, n_procs=5, crash_p=0.5,
                                        max_crashes=6, value_range=20)
                   for s in range(3)]
    encs = [interop.encoding_from_reference(ref_enc(h, ref_m)) for h in hs]
    ours = check_encoded(encs, port_m, algorithm="dense", device="cpu")
    theirs = ref_check(hs, ref_m, algorithm="jax")
    assert [_view(r) for r in ours] == [_view(r) for r in theirs]
    assert ours[0]["concurrency-window"] == 13
    assert ours[0]["decided-tier"] == "sort" and ours[0]["valid?"] is True



def test_element_31_clamp_pinned_valid():
    """The reference's element-31 clamp (ROADMAP Queue C), kept visible:
    `GSet` encodes 31 as the int32 clamp 0x7FFFFFFF, so a read holding
    31 hides every other element. This history adds 5, then 31, both
    completed, then reads {31}: the read misses the completed add of 5,
    yet the reference's checker (its default path and its sort kernel),
    the port's `sort_scan_plain` (both row formats), its chunk form, the
    host oracle `wgl_cpu` and `check_encoded` all answer VALID. A fix
    would edit the reference; until then the port keeps its verdict."""
    from jepsen_jgroups_raft_tpu.ops.linear_scan import make_batch_checker
    from jepsen_jgroups_raft_tpu_torch.checker.wgl_cpu import \
        check_encoded_cpu
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        pack_batch, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.history.synth import \
        build_history as port_build
    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

    rows = [(0, "invoke", "add", 5), (0, "ok", "add", 5),
            (1, "invoke", "add", 31), (1, "ok", "add", 31),
            (2, "invoke", "read", None), (2, "ok", "read", [31])]
    assert element_mask([31]) == 2**31 - 1 == element_mask([5, 31])
    ref_m, m = RefGSet(), GSet()
    [theirs] = ref_check([build_history(rows)], ref_m)
    assert theirs["valid?"] is True
    enc = encode_history(port_build(rows), m)
    ref_e = ref_enc(build_history(rows), ref_m)
    np.testing.assert_array_equal(enc.events, ref_e.events)
    W = ls.bucket_slots(enc.n_slots)
    ref_ok, ref_of = make_batch_checker(ref_m, 64, W)(ref_e.events[None])
    assert bool(np.asarray(ref_ok)[0]) and not bool(np.asarray(ref_of)[0])
    for pack in (pack_batch, pack_macro_batch):
        b = pack([enc])
        ev, ne = torch.from_numpy(b["events"]), torch.from_numpy(b["n_events"])
        ok, of = ls.sort_scan_plain(ev, W, 64, b.get("macro_p"), ne, model=m)
        assert ok.tolist() == [True] and of.tolist() == [False]
        init, step = ls.make_sort_chunk_checker(m, 64, W, b.get("macro_p"))
        carry = init(ne)
        for lo in range(0, ev.shape[1]):
            carry, _, _, ok, of = step(carry, ev[:, lo:lo + 1])
        assert ok.tolist() == [True] and of.tolist() == [False]
    assert check_encoded_cpu(enc, m).valid is True
    [ours] = check_encoded([enc], m, device="cpu")
    assert ours["valid?"] is True
