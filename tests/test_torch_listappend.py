"""The port's list-append model against the reference's.

`ListAppend.step`, `step_columnar` and `torch_step` are held elementwise
to the reference's `step` and `jax_step` (run on CPU JAX) over seeded
int32 states — negative states, states past 32^5 and products that
overflow int32 included; encodings are byte-identical on both encoder
paths; `sort_scan_plain` gives the reference sort kernel's flags on
list-append rows (the reference's own encodings, through `interop`); and
`check_histories` on device="cpu" gives the reference's verdict, kernel
and tier row for row. Exact equality throughout. The CUDA twin in
ops/csrc/models.cuh is held to `torch_step` by the card tests
(tests/test_torch_kernels_gpu.py).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.history.packing import (pack_batch,
                                                     pack_macro_batch,
                                                     pad_batch_bucketed)
from jepsen_jgroups_raft_tpu.history.synth import \
    random_valid_history as ref_random_history
from jepsen_jgroups_raft_tpu.models.listappend import \
    ListAppend as RefListAppend
from jepsen_jgroups_raft_tpu.models.listappend import \
    pack_list as ref_pack_list
from jepsen_jgroups_raft_tpu.ops import linear_scan as ref_ls
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import (build_history,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.models.listappend import (
    APPEND, APPEND_ANY, READ, ListAppend, pack_list, unpack_list)
from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import (bucket_slots,
                                                           sort_scan_plain)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drain_reference_counters():
    """The reference's counters are process-wide, and its own tests read
    their totals: leave none of this file's reference calls in them."""
    yield
    ref_schedule.consume_stats()
    ref_schedule.consume_tiers()


I32_MIN, I32_MAX = -(2**31), 2**31 - 1
#: states at the edges that matter: the packed-prefix bound 32^5, the
#: top of the packable range, int32's edges, negative states
EDGE_STATES = [0, 1, 31, 32, 33, 32**5 - 1, 32**5, 32**5 + 1, 2**26,
               2**30 - 1, I32_MAX, I32_MIN, -1, -(32**5), -33]


def _operands(seed: int, n: int):
    rng = np.random.default_rng(seed)
    state = np.concatenate([np.array(EDGE_STATES, dtype=np.int64),
                            rng.integers(I32_MIN, I32_MAX, n,
                                         endpoint=True)]).astype(np.int32)
    m = state.shape[0]
    f = rng.integers(0, 3, m).astype(np.int32)
    a = np.where(rng.random(m) < 0.4, state,
                 rng.integers(I32_MIN, I32_MAX, m, endpoint=True)
                 ).astype(np.int32)
    b = rng.integers(-40, 40, m).astype(np.int32)
    return state, f, a, b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_steps_match_reference_elementwise(seed):
    ours, ref = ListAppend(), RefListAppend()
    state, f, a, b = _operands(seed, 200)
    r_ns, r_lg = ref.jax_step(jnp.asarray(state), jnp.asarray(f),
                              jnp.asarray(a), jnp.asarray(b))
    r_ns, r_lg = np.asarray(r_ns), np.asarray(r_lg)
    t_ns, t_lg = ours.torch_step(*(torch.from_numpy(x)
                                   for x in (state, f, a, b)))
    assert t_ns.dtype == torch.int32 and t_lg.dtype == torch.bool
    assert t_ns.numpy().tolist() == r_ns.tolist()
    assert t_lg.numpy().tolist() == r_lg.tolist()
    c_ns, c_lg = ours.step_columnar(state, f, a, b)
    rc_ns, rc_lg = ref.step_columnar(state, f, a, b)
    assert c_ns.tolist() == rc_ns.tolist() == r_ns.tolist()
    assert c_lg.tolist() == rc_lg.tolist() == r_lg.tolist()
    for j in range(state.shape[0]):
        args = (int(state[j]), int(f[j]), int(a[j]), int(b[j]))
        mine = ours.step(*args)
        assert mine == ref.step(*args)
        assert (mine[0], bool(mine[1])) == (int(r_ns[j]), bool(r_lg[j]))


def test_signed_bound_and_wrapping_product():
    """APPEND_ANY's bound is a signed compare (a negative state may
    append) and products wrap like int32."""
    m = ListAppend()
    assert m.step(-5, APPEND_ANY, 3, 0) == (-5 * 32 + 3, True)
    assert m.step(32**5, APPEND_ANY, 3, 0)[1] is False
    ns, lg = m.step(2**27, APPEND, 2**27, 5)
    assert ns == ((2**27 * 32 + 5 + 2**31) % 2**32) - 2**31 and lg
    t_ns, t_lg = m.torch_step(*(torch.tensor([x], dtype=torch.int32)
                                for x in (I32_MAX, APPEND_ANY, 7, 0)))
    assert int(t_ns) == ((I32_MAX * 32 + 7 + 2**31) % 2**32) - 2**31
    assert not bool(t_lg)


def test_model_surface_matches_reference():
    ours, ref = ListAppend(), RefListAppend()
    assert MODELS["list-append"] is ListAppend
    assert ListAppend.KERNEL_MODEL == 4
    assert (ours.name, ours.n_fcodes, ours.readonly_fcodes,
            ours.init_state()) == (ref.name, ref.n_fcodes,
                                   ref.readonly_fcodes, ref.init_state())
    assert isinstance(interop.model_from_reference(ref), ListAppend)
    for lst in ([], [1], [3, 1, 2], [31] * 6, [1, 2, 3, 4, 5, 6]):
        assert pack_list(lst) == ref_pack_list(lst)
        assert unpack_list(pack_list(lst)) == lst
    for bad in ([0], [32], [1] * 7):
        with pytest.raises(ValueError):
            pack_list(bad)
    for f, a, b in ((READ, 5, 0), (APPEND, 3, 4), (APPEND_ANY, 9, 0),
                    (7, 1, 1)):
        assert ours.rw_classify(f, a, b) == ref.rw_classify(f, a, b)


def _histories(seed: int, n: int, n_ops: int, n_procs: int = 4,
               crash_p: float = 0.2, max_crashes: int = 3):
    rng = random.Random(seed)
    return [random_valid_history(rng, "list-append", n_ops=n_ops,
                                 n_procs=n_procs, crash_p=crash_p,
                                 max_crashes=max_crashes)
            for _ in range(n)]


def _break_read(h, rng):
    """One ok read made to observe a list the history never held: its
    last element dropped (or, for an empty list, [1] appended)."""
    ops = list(h)
    idx = [j for j, op in enumerate(ops)
           if op.type == "ok" and op.f == "read"]
    if idx:
        j = rng.choice(idx)
        v = list(ops[j].value)
        ops[j] = ops[j].replace(value=v[:-1] if v else [1])
    return ops


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "pairs"])
def test_encodings_are_byte_identical(vector, monkeypatch):
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    ours, ref = ListAppend(), RefListAppend()
    for h in _histories(3, 12, 40, crash_p=0.3):
        e, r = encode_history(h, ours), ref_enc(h, ref)
        assert e.events.tobytes() == r.events.tobytes()
        assert e.op_index.tobytes() == r.op_index.tobytes()
        assert e.proc.tobytes() == r.proc.tobytes()
        assert (e.n_slots, e.n_ops) == (r.n_slots, r.n_ops)


def test_malformed_completed_append_is_loud():
    h = build_history([(0, "invoke", "append", 2), (0, "ok", "append", [1])])
    with pytest.raises(ValueError):
        encode_history(h, ListAppend())


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("C", [4, 64])
def test_sort_scan_plain_matches_reference_kernel(C, macro):
    ref_m = RefListAppend()
    port_m = interop.model_from_reference(ref_m)
    rng = random.Random(17 + C)
    hs = _histories(17 + C, 10, 30, n_procs=5, crash_p=0.3)
    hs = [_break_read(h, rng) if i % 2 else h for i, h in enumerate(hs)]
    encs = [ref_enc(h, ref_m) for h in hs]
    W = bucket_slots(max(e.n_slots for e in encs))
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    ok, of = sort_scan_plain(torch.from_numpy(batch["events"]), W, C,
                             batch.get("macro_p"),
                             torch.from_numpy(batch["n_events"]),
                             model=port_m)
    ev, _, B = pad_batch_bucketed(batch["events"])
    r_ok, r_of = ref_ls.make_batch_checker(ref_m, C, W,
                                           macro_p=batch.get("macro_p"))(ev)
    assert ok.numpy().tolist() == np.asarray(r_ok)[:B].tolist()
    assert of.numpy().tolist() == np.asarray(r_of)[:B].tolist()
    # both polarities at C = 64; rows that overflow at C = 4
    assert (ok.any() and not ok.all()) if C == 64 else of.any()


def test_check_histories_matches_reference():
    """List-append rows take the ladder (no dense domain) in both
    packages: same verdict, kernel and tier row for row."""
    rng = random.Random(29)
    hs = _histories(29, 12, 40, n_procs=5, crash_p=0.1)
    hs = [_break_read(h, rng) if i % 3 == 0 else h
          for i, h in enumerate(hs)]
    ours = check_histories(hs, ListAppend(), device="cpu")
    theirs = ref_check(hs, RefListAppend())
    for r, t in zip(ours, theirs):
        assert (r["valid?"], r.get("decided-tier")) == \
            (t["valid?"], t.get("decided-tier"))
        assert r.get("kernel") == t.get("kernel") == "sort"
    assert {r["valid?"] for r in ours} == {True, False}


def test_reference_generator_histories_encode_alike():
    """The port's generator draws what the reference's draws."""
    a = _histories(5, 3, 30)
    rng = random.Random(5)
    b = [ref_random_history(rng, "list-append", n_ops=30, n_procs=4,
                            crash_p=0.2, max_crashes=3) for _ in range(3)]
    for x, y in zip(a, b):
        assert [(o.process, o.type, o.f, o.value) for o in x] == \
            [(o.process, o.type, o.f, o.value) for o in y]


@pytest.mark.parametrize("P", [None, 3], ids=["legacy", "P3"])
@pytest.mark.parametrize("W", [4, 12, 40])
def test_sort_scan_plain_matches_reference_on_arbitrary_rows(W, P):
    """Rows the packer never emits: crashed appends at int32-edge
    elements drive states negative and past int32, where the signed
    bound and the wrapping product decide legality."""
    ref_m = RefListAppend()
    port_m = interop.model_from_reference(ref_m)
    rng = np.random.default_rng(W + (P or 0))
    from jepsen_jgroups_raft_tpu_torch.history.synth import random_mask_rows

    B, E = 12, 24
    ev = random_mask_rows(rng, B, E, W, P, "list-append")
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0
    ok, of = sort_scan_plain(torch.from_numpy(ev), W, 8, P,
                             torch.from_numpy(n_events), model=port_m)
    padded, _, B2 = pad_batch_bucketed(ev)
    r_ok, r_of = ref_ls.make_batch_checker(ref_m, 8, W, macro_p=P)(padded)
    assert ok.numpy().tolist() == np.asarray(r_ok)[:B].tolist()
    assert of.numpy().tolist() == np.asarray(r_of)[:B].tolist()
    # macro rows open many appends at once, which pass 32^5 and die
    assert not ok.all() and (ok.any() or P is not None)
