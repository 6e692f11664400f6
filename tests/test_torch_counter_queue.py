"""The port's counter and ticket-queue models against the reference's.

`torch_step` must equal the reference's `jax_step` (and the scalar
`step` where the two models agree) over a grid that crosses the int32
boundary (counter) and the queue's 15-bit field edges; `mask_delta`,
`step_columnar` and the history encodings must be identical too, and the
queue's field limits must raise as the reference's do. States, deltas
and encodings are integers and legality is boolean: exact equality.
"""

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu import models as ref_models
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.models.counter import Counter as RefCounter
from jepsen_jgroups_raft_tpu.models.queuemodel import TicketQueue as RefQueue
from jepsen_jgroups_raft_tpu_torch import models
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import (
    build_history, offset_counter_history, random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models.counter import (
    ADD, ADD_AND_GET, READ, Counter)
from jepsen_jgroups_raft_tpu_torch.models.queuemodel import (
    DEQ, DEQ_ANY, DEQ_EMPTY, ENQ, ENQ_ANY, TICKET_MAX, TicketQueue,
    pack_state, unpack_state)

torch.set_num_threads(1)

I32_MIN, I32_MAX = -2**31, 2**31 - 1
COUNTER_VALUES = [I32_MIN, I32_MIN + 1, -2**30, -2, -1, 0, 1, 2, 3, 2**30,
                  I32_MAX - 1, I32_MAX]
QUEUE_STATES = [pack_state(h, t) for h, t in itertools.product(
    [0, 1, 2, TICKET_MAX - 1, TICKET_MAX], repeat=2)] + [-1, I32_MIN,
                                                         I32_MAX, -32768]
QUEUE_ARGS = [-1, 0, 1, 2, TICKET_MAX - 1, TICKET_MAX, 1 << 15]


def _grid(states, args, f):
    rows = list(itertools.product(states, args, args))
    s, a, b = (np.asarray(c, dtype=np.int32) for c in zip(*rows))
    return s, np.full_like(s, f), a, b


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


CASES = [("counter", f) for f in (0, 1, 2, 5)] + \
    [("queue", f) for f in (0, 1, 2, 3, 4, 7)]


def _models(kind):
    return (Counter(), RefCounter()) if kind == "counter" else \
        (TicketQueue(), RefQueue())


def _inputs(kind, f):
    if kind == "counter":
        return _grid(COUNTER_VALUES, COUNTER_VALUES, f)
    return _grid(QUEUE_STATES, QUEUE_ARGS, f)


@pytest.mark.parametrize("kind,f", CASES, ids=[f"{k}_f{f}" for k, f in CASES])
def test_torch_step_matches_jax_step(kind, f):
    port, ref = _models(kind)
    s, fs, a, b = _inputs(kind, f)
    ns_t, lg_t = port.torch_step(*_torch(s, fs, a, b))
    ns_j, lg_j = ref.jax_step(*(jnp.asarray(x) for x in (s, fs, a, b)))
    assert ns_t.dtype == torch.int32 and lg_t.dtype == torch.bool
    assert np.array_equal(ns_t.numpy(), np.asarray(ns_j))
    assert np.array_equal(lg_t.numpy(), np.asarray(lg_j))
    if kind == "counter" and f in (0, 1, 2):
        # the scalar step wraps like int32: it agrees everywhere
        py = [ref.step(int(x), f, int(y), int(z)) for x, y, z in zip(s, a, b)]
        assert ns_t.tolist() == [p[0] for p in py]
        assert lg_t.tolist() == [bool(p[1]) for p in py]


@pytest.mark.parametrize("kind,f", CASES, ids=[f"{k}_f{f}" for k, f in CASES])
def test_mask_delta_and_columnar_step_match_reference(kind, f):
    port, ref = _models(kind)
    s, fs, a, b = _inputs(kind, f)
    d_t = port.mask_delta(*_torch(fs, a, b))
    d_j = ref.mask_delta(*(jnp.asarray(x) for x in (fs, a, b)))
    assert d_t.dtype == torch.int32
    assert np.array_equal(d_t.numpy(), np.asarray(d_j))
    ns_c, lg_c = port.step_columnar(s, fs, a, b)
    ns_r, lg_r = ref.step_columnar(s, fs, a, b)
    assert np.array_equal(ns_c, ns_r) and np.array_equal(lg_c, lg_r)


# Each model's `always_legal(f)`, the predicate the mask kernel uses to
# skip a slot's legality table, must be exactly the term of `torch_step`'s
# legality that reads no state.
ALWAYS = {"counter": ADD, "queue": ENQ_ANY}
OPCODES = {"counter": (READ, ADD, ADD_AND_GET),
           "queue": (ENQ, ENQ_ANY, DEQ, DEQ_EMPTY, DEQ_ANY)}


def _check_always_legal(kind, f):
    """`always_legal(f)` against `torch_step` over the grid: where it
    holds, the op is legal in every state for every (a, b); where it
    fails for a real opcode, each (a, b) has a state that makes the op
    illegal; an f outside the opcodes is never legal. Returns the
    predicate's value."""
    port, _ = _models(kind)
    s, fs, a, b = _torch(*_inputs(kind, f))
    n_args = len(COUNTER_VALUES if kind == "counter" else QUEUE_ARGS)
    legal = port.torch_step(s, fs, a, b)[1].view(-1, n_args, n_args)
    al = port.always_legal(fs)
    assert al.dtype == torch.bool and al.shape == fs.shape
    assert bool(al.all()) or not bool(al.any())  # a function of f alone
    if bool(al[0]):
        assert bool(legal.all())
    elif f in OPCODES[kind]:
        assert bool((~legal).any(dim=0).all())  # each (a, b) can fail
    else:
        assert not bool(legal.any())
    return bool(al[0])


@pytest.mark.parametrize("f", range(-3, 9))
@pytest.mark.parametrize("kind", ["counter", "queue"])
def test_always_legal_is_the_unconditional_term(kind, f):
    assert _check_always_legal(kind, f) == (f == ALWAYS[kind])


@pytest.mark.parametrize("kind", ["counter", "queue"])
def test_always_legal_is_elementwise_on_summed_opcodes(kind):
    """A macro row may sum several payloads' f into one slot (the
    reference's `macro_latch_i32`), and the predicate reads that sum as
    the step does: every sum of two or three opcodes (or of -1, an
    unknown one) is held to `torch_step` as one f, and a batch of the
    sums gives the same answers element by element."""
    ops = (-1, *OPCODES[kind])
    sums = sorted({sum(c) for r in (2, 3)
                   for c in itertools.combinations_with_replacement(ops, r)})
    port, _ = _models(kind)
    got = port.always_legal(torch.tensor(sums, dtype=torch.int32)).tolist()
    assert got == [_check_always_legal(kind, f) for f in sums]


def test_queue_scalar_step_matches_reference_inside_fields():
    """The scalar step masks each field; inside the fields (no overflow)
    it also equals the additive torch_step."""
    port, ref = TicketQueue(), RefQueue()
    for h, t in itertools.product([0, 1, 2, 7, TICKET_MAX - 1], repeat=2):
        st = pack_state(h, t)
        assert unpack_state(st) == (h, t)
        for f, a in itertools.product(range(5), [-1, 0, 1, 2, 7]):
            mine = port.step(st, f, a, 0)
            assert mine == ref.step(st, f, a, 0)
            ns, lg = port.torch_step(*(torch.tensor([x], dtype=torch.int32)
                                       for x in (st, f, a, 0)))
            assert (int(ns), bool(lg)) == (mine[0], bool(mine[1]))


def test_registry_and_kernel_ids():
    for name in ("cas-register", "counter", "queue"):
        assert models.MODELS[name].__name__ == \
            ref_models.MODELS[name].__name__
    assert (models.CasRegister.KERNEL_MODEL, Counter.KERNEL_MODEL,
            TicketQueue.KERNEL_MODEL) == (0, 1, 2)
    assert Counter.mask_determined and TicketQueue.mask_determined
    assert not models.CasRegister.mask_determined
    assert Counter(5).init_state() == 5 and Counter(2**40).init_state() == \
        I32_MAX
    assert Counter(3).cache_key() != Counter(4).cache_key()


def _bump(h, rng):
    h = list(h)
    idx = [j for j, op in enumerate(h) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = h[j].value
        h[j] = h[j].replace(value=(v[0], v[1] + 1) if isinstance(v, tuple)
                            else v + 1)
    return h


def _counter_handmade():
    """decr / decr-and-get, info and fail completions, get, and values
    clamped at the int32 edges."""
    return [
        build_history([(0, "invoke", "add", 5), (0, "ok", "add", 5),
                       (1, "invoke", "decr", 2), (1, "info", "decr", 2),
                       (2, "invoke", "decr-and-get", 1),
                       (2, "ok", "decr-and-get", (1, 2)),
                       (3, "invoke", "add-and-get", 4),
                       (3, "info", "add-and-get", 4),
                       (4, "invoke", "get", None), (4, "ok", "get", 6),
                       (5, "invoke", "add", 9), (5, "fail", "add", 9),
                       (6, "invoke", "read", None), (6, "info", "read", None),
                       (7, "invoke", "add", 2**40),
                       (8, "invoke", "read", None), (8, "ok", "read", -2**40)
                       ])]


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "per_pair"])
@pytest.mark.parametrize("kind", ["counter", "queue"])
def test_encodings_byte_identical(monkeypatch, kind, vector):
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    rng = random.Random(17)
    port, ref = _models(kind)
    hs = []
    for i in range(16):
        h = random_valid_history(rng, kind, n_ops=rng.randint(20, 120),
                                 n_procs=rng.randint(1, 5), crash_p=0.2,
                                 max_crashes=3)
        hs.append(_bump(h, rng) if i % 2 else h)
    if kind == "counter":
        hs += _counter_handmade()
        hs.append(offset_counter_history(hs[0], 2**31 - 10))
    for h in hs:
        mine, theirs = encode_history(h, port), ref_enc(h, ref)
        assert np.array_equal(mine.events, theirs.events)
        assert mine.events.dtype == np.int32
        assert np.array_equal(mine.op_index, theirs.op_index)
        assert np.array_equal(mine.proc, theirs.proc)
        assert (mine.n_slots, mine.n_ops) == (theirs.n_slots, theirs.n_ops)


@pytest.mark.parametrize("vector", ["1", "0"], ids=["columnar", "per_pair"])
def test_queue_field_limits_raise_like_reference(monkeypatch, vector):
    monkeypatch.setenv("JGRAFT_ENCODE_VECTOR", vector)
    bad_ticket = build_history([(0, "invoke", "enqueue", None),
                                (0, "ok", "enqueue", TICKET_MAX + 1)])
    for model, enc in ((TicketQueue(), encode_history),
                       (RefQueue(), ref_enc)):
        with pytest.raises(ValueError, match="ticket"):
            enc(bad_ticket, model)
    ok_ticket = build_history([(0, "invoke", "enqueue", None),
                               (0, "ok", "enqueue", TICKET_MAX)])
    assert np.array_equal(encode_history(ok_ticket, TicketQueue()).events,
                          ref_enc(ok_ticket, RefQueue()).events)


def test_queue_rejects_more_crashed_ops_than_the_field_holds():
    """TICKET_MAX + 1 crashed enqueues carry no ticket to validate; the
    columnar encoder counts them and refuses, as the reference's does."""
    h = build_history([(p, "invoke", "enqueue", None)
                       for p in range(TICKET_MAX + 1)])
    for model, enc in ((TicketQueue(), encode_history),
                       (RefQueue(), ref_enc)):
        with pytest.raises(ValueError, match="exceed"):
            enc(h, model)
