"""The port's mask-mode scan and grouping against the reference's.

Inputs are the REFERENCE's own encodings, plans and packed arrays
(carried across by `interop`), so these tests never depend on the port's
encoder. `mask_scan_plain` must equal, row for row, the reference's XLA
mask kernel (`make_dense_batch_checker(model, "mask", W, 1, macro_p=…)`,
run on CPU JAX as the reference's own tests run it), the reference's
host oracle and the port's copy of it, for the counter and the queue at
every window W = 1..12, in both row formats, with valid and invalid
histories in each case; and the XLA kernel on arbitrary rows (slots out
of range, shared slots, int32 edges). `dense_plans_grouped` must give
the reference's groups, kinds, `rest` and `val_of`, with and without the
merge knobs. Verdicts are booleans: the tolerance is exact equality. The
CUDA kernel itself is held to the plain version by the card-only tests
in tests/test_torch_kernels_gpu.py.
"""

import functools
import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.wgl_cpu import check_encoded_cpu
from jepsen_jgroups_raft_tpu.history.packing import (encode_history,
                                                     pack_batch,
                                                     pack_macro_batch,
                                                     pad_batch_bucketed)
from jepsen_jgroups_raft_tpu.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu.models.counter import Counter as RefCounter
from jepsen_jgroups_raft_tpu.models.queuemodel import TicketQueue as RefQueue
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu.models.setmodel import GSet as RefGSet
from jepsen_jgroups_raft_tpu.ops import dense_scan as ref_ds
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker.wgl_cpu import (
    check_encoded_cpu as port_oracle)
from jepsen_jgroups_raft_tpu_torch.history.synth import (
    offset_counter_history, random_mask_rows)
from jepsen_jgroups_raft_tpu_torch.models import (CasRegister, Counter,
                                                  GSet, TicketQueue)
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as port_ds
from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (DenseLayout,
                                                          mask_layout,
                                                          mask_scan,
                                                          mask_scan_plain)

torch.set_num_threads(1)

MODELS = {"counter": (Counter, RefCounter), "queue": (TicketQueue, RefQueue),
          "register": (CasRegister, RefReg), "set": (GSet, RefGSet)}


def _bump(h, rng):
    """One ok observation (read, add-and-get, enqueue, dequeue ticket)
    raised by 1000, beyond what the crashed ops could explain."""
    h = list(h)
    idx = [j for j, op in enumerate(h) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = h[j].value
        h[j] = h[j].replace(value=(v[0], v[1] + 1000)
                            if isinstance(v, tuple) else v + 1000)
    return h


def _window_encodings(kind, W, n, n_ops, seed, model=None):
    """Reference encodings of n histories with windows up to W, the
    first exactly W (up to 5 processes, the rest of the window held by
    crashed ops); odd ones with one observation bumped."""
    rng = random.Random(seed)
    model = model or MODELS[kind][1]()
    n_procs, crashes = min(W, 5), max(W - 5, 0)
    top, rest = None, []
    while top is None or len(rest) < n - 1:
        h = random_valid_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                                 crash_p=0.5 if crashes else 0.0,
                                 max_crashes=crashes)
        w = encode_history(h, model).n_slots
        if w == W and top is None:
            top = h
        elif w <= W and len(rest) < n - 1:
            rest.append(h)
    return [encode_history(_bump(h, rng) if i % 2 else h, model)
            for i, h in enumerate([top] + rest)]


def _wide(kind):
    """A history whose window (14, or 13 for the register) is beyond
    both kinds' caps: crashed ops that never retire, then a read."""
    from jepsen_jgroups_raft_tpu.history.synth import build_history

    if kind == "register":  # a chain of crashed CAS the prune keeps
        rows = [(0, "invoke", "write", 0), (0, "ok", "write", 0)]
        rows += [(k + 1, "invoke", "cas", (k, k + 1)) for k in range(12)]
        return build_history(rows + [(20, "invoke", "read", None),
                                     (20, "ok", "read", 12)])
    if kind == "set":  # 14 crashed adds, then a read: window 15
        rows = [(k, "invoke", "add", k % 7) for k in range(14)]
        return build_history(rows + [(20, "invoke", "read", None),
                                     (20, "ok", "read", list(range(7)))])
    f = "add" if kind == "counter" else "enqueue"
    rows = [(k, "invoke", f, 1 if kind == "counter" else None)
            for k in range(13)]
    g, v = ("read", 13) if kind == "counter" else ("dequeue", 0)
    return build_history(rows + [(20, "invoke", g, None), (20, "ok", g, v)])


def _xla(ref_model, W, batch):
    ev, (vo,), B = pad_batch_bucketed(
        batch["events"], (np.zeros((len(batch["events"]), 1), np.int32),))
    kern = ref_ds.make_dense_batch_checker(ref_model, "mask", W, 1,
                                           macro_p=batch.get("macro_p"))
    return np.asarray(kern(ev, vo)[0])[:B]


def _plain(model, W, batch):
    ok = mask_scan_plain(torch.from_numpy(batch["events"]), W,
                         batch.get("macro_p"),
                         torch.from_numpy(batch["n_events"]), model=model)
    assert ok.dtype == torch.bool
    return ok.numpy()


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", range(1, 13), ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind", ["counter", "queue"])
def test_plain_matches_xla_mask_and_oracles(kind, W, macro):
    port_m, ref_m = (c() for c in MODELS[kind][:2])
    encs = _window_encodings(kind, W, 8, 40, 10 * W + macro)
    plan = ref_ds.dense_plan(ref_m, encs)
    assert (plan.kind, plan.n_slots, plan.n_states) == ("mask", W, 1)
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    ok = _plain(port_m, W, batch)
    oracle = [check_encoded_cpu(e, ref_m).valid for e in encs]
    assert ok.tolist() == _xla(ref_m, W, batch).tolist() == oracle
    assert oracle == [port_oracle(interop.encoding_from_reference(e),
                                  port_m).valid for e in encs]
    assert 0 < sum(oracle) < len(oracle)  # both polarities


def _set_mask_encodings(W, n, seed):
    """Reference encodings of n set histories that ride the mask kernel
    (more than 4 adds, each of a fresh element) with windows up to W,
    the first exactly W; odd ones with element 31 added to one read."""
    rng = random.Random(seed)
    m = RefGSet()
    n_procs, crashes = min(W, 5), max(W - 5, 0)
    top, rest = None, []
    while top is None or len(rest) < n - 1:
        h = list(random_valid_history(rng, "set", n_ops=rng.randint(8, 16),
                                      n_procs=n_procs,
                                      crash_p=0.5 if crashes else 0.0,
                                      max_crashes=crashes, value_range=31))
        e = encode_history(h, m)
        if e.n_slots > W or m.dense_domain(e.events) is not None or \
                not m.mask_eligible(e.events):
            continue
        if e.n_slots == W and top is None:
            top = h
        elif len(rest) < n - 1:
            rest.append(h)
    out = []
    for i, h in enumerate([top] + rest):
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read"]
        if i % 2 and reads:
            j = rng.choice(reads)
            h[j] = h[j].replace(value=sorted(h[j].value) + [31])
        out.append(encode_history(h, m))
    return out


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", range(1, 13), ids=lambda w: f"W{w}")
def test_plain_set_matches_xla_mask_and_oracles(W, macro):
    """The set on the mask kernel: single-bit deltas whose subset sums
    equal the OR, for the histories `mask_eligible` proves additive."""
    encs = _set_mask_encodings(W, 8, 70 + 2 * W + macro)
    plan = ref_ds.dense_plan(RefGSet(), encs)
    assert (plan.kind, plan.n_slots, plan.n_states) == ("mask", W, 1)
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    ok = _plain(GSet(), W, batch)
    oracle = [check_encoded_cpu(e, RefGSet()).valid for e in encs]
    assert ok.tolist() == _xla(RefGSet(), W, batch).tolist() == oracle
    assert 0 < sum(oracle) < len(oracle)


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
def test_plain_counter_across_int32_boundary(macro):
    """A counter started 40 below 2^31 crosses into negative states."""
    offset = 2**31 - 40
    port_m, ref_m = Counter(offset), RefCounter(offset)
    rng = random.Random(4)
    hs = []
    for i in range(12):
        h = offset_counter_history(random_valid_history(
            rng, "counter", n_ops=60, n_procs=4, crash_p=0.2,
            max_crashes=2), offset)
        hs.append(_bump(h, rng) if i % 2 else h)
    encs = [encode_history(h, ref_m) for h in hs]
    assert any(((e.events[:, 2] == 0) & (e.events[:, 3] < 0)).any()
               for e in encs)  # a read observed a wrapped value
    W = max(e.n_slots for e in encs)
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    ok = _plain(port_m, W, batch)
    oracle = [check_encoded_cpu(e, ref_m).valid for e in encs]
    assert ok.tolist() == _xla(ref_m, W, batch).tolist() == oracle
    assert 0 < sum(oracle) < len(oracle)


@pytest.mark.parametrize("P", [None, 4], ids=["legacy", "P4"])
@pytest.mark.parametrize("W", [3, 12], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind,init", [("counter", 0), ("queue", 0),
                                       ("counter", 2**31 - 3)],
                         ids=["counter", "queue", "counter_near_2^31"])
def test_plain_matches_xla_mask_on_arbitrary_rows(kind, init, W, P):
    """Rows the packer never emits: the reference's clipped-column sums,
    summed shared-slot latches and wrapping arithmetic, held bitwise."""
    port_m = Counter(init) if kind == "counter" else TicketQueue()
    ref_m = RefCounter(init) if kind == "counter" else RefQueue()
    rng = np.random.default_rng(100 * W + (P or 0) + init % 7)
    B, E = 32, 32
    ev = random_mask_rows(rng, B, E, W, P, kind)
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0  # EV_PAD past the end
    ok = _plain(port_m, W, {"events": ev, "n_events": n_events,
                            "macro_p": P})
    ref_ok = _xla(ref_m, W, {"events": ev, "macro_p": P})
    assert ok.tolist() == ref_ok.tolist()
    assert 0 < int(ok.sum()) < B


@functools.lru_cache(maxsize=None)
def _grouping_batch(kind):
    """Windows 1..12 and one beyond both kinds' caps (rest), small
    straggler buckets (merging) and LONG histories (> MERGE_MAX_EVENTS
    events); the register batch also holds domains too wide for W = 9
    or 10 (rest)."""
    rng = random.Random(2025)
    m = MODELS[kind][1]()
    shapes = [(1, 0, 20, 40), (2, 0, 5, 40), (3, 2, 30, 40), (4, 3, 10, 40),
              (5, 4, 6, 40), (5, 6, 4, 40), (5, 8, 3, 60), (4, 2, 3, 3000),
              (2, 1, 2, 3000)]
    encs = []
    for k, (n_procs, crashes, n, n_ops) in enumerate(shapes):
        short_set = kind == "set" and n_ops < 3000 and k % 3
        if short_set:  # few adds over 32 elements: many are distinct
            n_ops = 14
        for _ in range(n):
            kw = ({"value_range": 15} if kind == "register" else
                  {"value_range": 32 if short_set else 3}
                  if kind == "set" else {})
            h = random_valid_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                                     crash_p=0.5, max_crashes=crashes, **kw)
            encs.append(encode_history(h, m))
    return encs + [encode_history(_wide(kind), m)]


KNOBS = {"default": {}, "merge_long": {"JGRAFT_MERGE_LONG": "1"},
         "merge_all": {"JGRAFT_MERGE_ALL": "1"},
         "merge_all_long_off": {"JGRAFT_MERGE_ALL": "1",
                                "JGRAFT_MERGE_LONG": "0"}}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("kind", ["counter", "queue", "register", "set"])
def test_dense_plans_grouped_matches_reference(monkeypatch, kind, knobs):
    for k in ("JGRAFT_MERGE_LONG", "JGRAFT_MERGE_ALL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in KNOBS[knobs].items():
        monkeypatch.setenv(k, v)
    encs = _grouping_batch(kind)
    port_m, ref_m = (c() for c in MODELS[kind][:2])
    ref_groups, ref_rest = ref_ds.dense_plans_grouped(ref_m, encs)
    port_groups, port_rest = port_ds.dense_plans_grouped(
        port_m, [interop.encoding_from_reference(e) for e in encs])
    assert port_rest == ref_rest and ref_rest
    assert len(port_groups) == len(ref_groups) >= 2
    assert any(e.n_events > port_ds.MERGE_MAX_EVENTS for e in encs)
    for (pi, pp), (ri, rp) in zip(port_groups, ref_groups):
        assert pi == ri
        assert (pp.kind, pp.n_slots, pp.n_states, pp.kernel_tag) == \
            (rp.kind, rp.n_slots, rp.n_states, rp.kernel_tag)
        assert np.array_equal(pp.val_of, rp.val_of)
        assert pp.val_of.dtype == np.int32
    # the set: ≤ 4 distinct adds → domain, distinct fresh bits → mask,
    # re-adds → rest
    want = {"register": {"domain"}, "set": {"domain", "mask"}}.get(
        kind, {"mask"})
    assert {p.kind for _, p in port_groups} == want


@pytest.mark.parametrize("kind", ["counter", "queue"])
def test_dense_plan_falls_back_to_mask_mode(kind):
    port_m, ref_m = (c() for c in MODELS[kind][:2])
    encs = _grouping_batch(kind)
    inside = [e for e in encs if e.n_slots <= 12]
    rp = ref_ds.dense_plan(ref_m, inside)
    pp = port_ds.dense_plan(port_m, [interop.encoding_from_reference(e)
                                     for e in inside])
    assert (pp.kind, pp.n_slots, pp.n_states, pp.kernel_tag) == \
        (rp.kind, rp.n_slots, rp.n_states, rp.kernel_tag) == \
        ("mask", max(e.n_slots for e in inside), 1, "dense-mask")
    assert np.array_equal(pp.val_of, rp.val_of)
    assert port_ds.dense_plan(port_m, [
        interop.encoding_from_reference(e) for e in encs]) is None
    assert ref_ds.dense_plan(ref_m, encs) is None


def test_mask_layout_places_ballot_words():
    """Mask m's legality bit, built by the ballot of group g = m >> 5 in
    the kernel, lands where the frontier keeps mask m: lane g & 31, word
    g >> 5, bit m & 31."""
    for W in range(1, 13):
        lay = mask_layout(W)
        assert lay == DenseLayout(W, 0)
        assert (lay.words, lay.lanes) == (1 << max(W - 10, 0),
                                          1 << min(max(W - 5, 0), 5))
        for m in range(1 << W):
            g = m >> 5
            assert lay.locate(m) == (g & 31, g >> 5, m & 31)
        assert [lay.slot_pass(w)[0] for w in range(W)] == \
            [("field" if w < 5 else "lane" if w < 10 else "word")
             for w in range(W)]
    for bad in (0, 13):
        with pytest.raises(ValueError):
            mask_layout(bad)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    encs = _window_encodings("counter", 6, 8, 30, 3)
    batch = pack_macro_batch(encs)
    port_ds.reset_launch_counts()
    ok = mask_scan(torch.from_numpy(batch["events"]), 6, batch["macro_p"],
                   torch.from_numpy(batch["n_events"]), model=Counter())
    assert ok.tolist() == _plain(Counter(), 6, batch).tolist()
    assert port_ds.launch_counts() == {"dense_scan": 0, "mask_scan": 0}
