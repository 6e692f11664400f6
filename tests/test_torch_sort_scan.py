"""The port's sort-frontier scan against the reference's sort kernel.

Inputs are the REFERENCE's own encodings and packed arrays (histories
from its generator, or the port's burst generator's rows rebuilt as
reference histories), so these tests never depend on the port's encoder.
`sort_scan_plain` must equal, row for row and on both flags (ok and
overflow), the reference's `make_batch_checker` (its XLA sort kernel,
run on CPU JAX as the reference's own tests run it), for the four
models, at windows in the exact buckets up to 16 and the word buckets 31
and 63 (K = 1 and 2 mask words, and 3 and 4 on arbitrary rows), C ∈ {2,
4, 8, 64}, both row formats, valid and corrupted histories. Rows that
overflow are compared too: short histories with C near their frontier
make rows that overflow and still end ok, which pins which C entries a
round keeps. Verdicts and flags are booleans: the tolerance is exact
equality. The CUDA kernel itself is held to the plain version by the
card-only tests in tests/test_torch_kernels_gpu.py.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.history.packing import (encode_history,
                                                     pack_batch,
                                                     pack_macro_batch,
                                                     pad_batch_bucketed)
from jepsen_jgroups_raft_tpu.history.synth import (build_history,
                                                   random_valid_history)
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu.ops import linear_scan as ref_ls
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.history.synth import (burst_history,
                                                         random_mask_rows,
                                                         sort_edge_cases)
from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as port_ls
from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import (bucket_slots,
                                                           sort_scan,
                                                           sort_scan_plain)

torch.set_num_threads(1)

KINDS = {"register": "cas-register", "counter": "counter", "queue": "queue",
         "set": "set"}


def _models(kind):
    ref = REF_MODELS[KINDS[kind]]()
    return interop.model_from_reference(ref), ref


def _bump(h, rng):
    """One ok observation changed: a number raised by 1, a set read
    given element 31 (or losing it)."""
    h = list(h)
    idx = [j for j, op in enumerate(h) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = h[j].value
        if isinstance(v, list):
            v = sorted(set(v) ^ {31})
        elif isinstance(v, tuple):
            v = (v[0], v[1] + 1)
        else:
            v = v + 1
        h[j] = h[j].replace(value=v)
    return h


def _histories(kind, n, n_ops, n_procs, crash_p, max_crashes, seed,
               corrupt=True, **kw):
    rng = random.Random(seed)
    hs = [random_valid_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                               crash_p=crash_p, max_crashes=max_crashes,
                               **kw) for _ in range(n)]
    return [_bump(h, rng) if corrupt and i % 2 else h
            for i, h in enumerate(hs)]


def _bursts(kind, n, n_ops, seed):
    """Burst histories (every op open at once) rebuilt as reference
    histories, odd ones corrupted."""
    rng = random.Random(seed)
    vr = 32 if kind == "set" else 3
    out = []
    for i in range(n):
        h = burst_history(rng, kind, n_ops, value_range=vr)
        rows = [(op.process, op.type, op.f, op.value) for op in h]
        h = build_history(rows)
        out.append(_bump(h, rng) if i % 2 else h)
    return out


def _ref(ref_m, C, W, batch):
    ev, _, B = pad_batch_bucketed(batch["events"])
    kern = ref_ls.make_batch_checker(ref_m, C, W,
                                     macro_p=batch.get("macro_p"))
    ok, of = kern(ev)
    return np.asarray(ok)[:B], np.asarray(of)[:B]


def _plain(port_m, C, W, batch, n_events=None):
    ne = batch.get("n_events") if n_events is None else n_events
    ok, of = sort_scan_plain(torch.from_numpy(batch["events"]), W, C,
                             batch.get("macro_p"),
                             None if ne is None else torch.from_numpy(ne),
                             model=port_m)
    assert ok.dtype == of.dtype == torch.bool
    return ok.numpy(), of.numpy()


def _compare(kind, encs, C, macro, W=None):
    port_m, ref_m = _models(kind)
    W = W or bucket_slots(max(e.n_slots for e in encs))
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    ok, of = _plain(port_m, C, W, batch)
    r_ok, r_of = _ref(ref_m, C, W, batch)
    assert ok.tolist() == r_ok.tolist()
    assert of.tolist() == r_of.tolist()
    return ok, of


# (window target, C, macro rows): histories whose windows fall in the
# exact buckets, then bursts that fill the 31- and 63-slot buckets
WINDOW_CASES = [(3, 2, False), (5, 4, True), (8, 8, False), (12, 64, True),
                (16, 8, True), (31, 4, False), (63, 8, True)]


@pytest.mark.parametrize("W,C,macro", WINDOW_CASES,
                         ids=[f"W{w}_C{c}_{'macro' if m else 'legacy'}"
                              for w, c, m in WINDOW_CASES])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_reference_sort_kernel(kind, W, C, macro):
    _, ref_m = _models(kind)
    if W <= 16:
        hs = _histories(kind, 6, 40, min(W, 5), 0.5 if W > 5 else 0.1,
                        max(W - 5, 0), 100 * W + C,
                        **({"value_range": 32} if kind == "set" else {}))
        hs.append(_bursts(kind, 1, W, W)[0])
    else:
        hs = _bursts(kind, 3, W - 2, W)
    encs = [encode_history(h, ref_m) for h in hs]
    assert max(e.n_slots for e in encs) <= W
    assert bucket_slots(max(e.n_slots for e in encs)) == W or kind == \
        "register"  # a failed CAS leaves the register's burst narrower
    _compare(kind, encs, C, macro, W)


# (kind, C): the 12-op shape keeps frontiers near C, so rows overflow
# and some still end ok
KEEP_ORDER = [("set", 8), ("counter", 4), ("counter", 8), ("register", 4),
              ("register", 8), ("queue", 4), ("queue", 8)]


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("kind,C", KEEP_ORDER,
                         ids=[f"{k}_C{c}" for k, c in KEEP_ORDER])
def test_overflowed_rows_match_reference(kind, C, macro):
    """Rows that overflow and end ok exist only if the kept entries are
    the reference's: a different choice changes which rows survive."""
    _, ref_m = _models(kind)
    hs = _histories(kind, 64, 12, 4, 0.0, 0, 11, corrupt=False)
    encs = [encode_history(h, ref_m) for h in hs]
    ok, of = _compare(kind, encs, C, macro)
    assert (of & ok).any() and (of & ~ok).any()


@pytest.mark.parametrize("W,P,C", [(6, 3, 4), (12, None, 8), (40, 16, 4),
                                   (70, None, 2), (100, 2, 2)],
                         ids=["W6_P3_C4", "W12_legacy_C8", "W40_P16_C4",
                              "W70_legacy_C2", "W100_P2_C2"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_reference_on_arbitrary_rows(kind, W, P, C):
    """Rows the packer never emits: slots out of range (a FORCE of one
    kills every configuration), re-opened and shared slots (summed in a
    macro row), unknown kinds and opcodes, int32 edges."""
    port_m, ref_m = _models(kind)
    rng = np.random.default_rng(W * 31 + (P or 0) + len(kind))
    B, E = 12, 24
    ev = random_mask_rows(rng, B, E, W, P, kind)
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0
    batch = {"events": ev, "macro_p": P}
    ok, of = _plain(port_m, C, W, batch, n_events)
    r_ok, r_of = _ref(ref_m, C, W, batch)
    assert ok.tolist() == r_ok.tolist() and of.tolist() == r_of.tolist()
    assert (ok | of).any() and not ok.all()


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_dedup_compact_keeps_the_reference_entries(K):
    """The compaction alone, on random parents and candidates with
    duplicates, empty entries, and a state at both int32 edges: the same
    kept entries in the same order, count and grew."""
    rng = np.random.default_rng(K)
    C, N = 6, 40
    for _ in range(8):
        masks = rng.integers(0, 4, size=(N, K)).astype(np.uint32)
        masks[:, K - 1] &= 0x7FFFFFFF
        masks[rng.random(N) < 0.2] = 0xFFFFFFFF
        states = rng.choice([-2**31, -1, 0, 1, 2**31 - 1],
                            size=N).astype(np.int32)
        dup = rng.integers(0, N, size=N // 4)
        masks[dup[1:]] = masks[dup[:-1]]
        states[dup[1:]] = states[dup[:-1]]
        tags = (np.arange(N) >= C).astype(np.int32)
        r_m, r_s, _, r_of, r_grew = ref_ls._dedup_compact(masks, states, tags,
                                                          C)
        p_m, p_s, count, grew = port_ls._dedup_compact(
            torch.from_numpy(masks.astype(np.int64))[None],
            torch.from_numpy(states)[None],
            torch.from_numpy(tags.astype(np.int64))[None], C)
        assert p_m[0].numpy().tolist() == np.asarray(r_m).astype(
            np.int64).tolist()
        assert p_s[0].numpy().tolist() == np.asarray(r_s).tolist()
        assert bool(count[0] > C) == bool(r_of)
        assert bool(grew[0]) == bool(r_grew)


def test_bucket_slots_and_caps_match_reference():
    for n in list(range(0, 128)):
        assert bucket_slots(n) == ref_ls.bucket_slots(n)
    with pytest.raises(ValueError):
        bucket_slots(128)
    assert (port_ls.MAX_SLOTS, port_ls.DEFAULT_N_CONFIGS,
            port_ls.SLOT_BUCKETS, port_ls.SLOT_EXACT_MAX) == \
        (ref_ls.MAX_SLOTS, ref_ls.DEFAULT_N_CONFIGS, ref_ls.SLOT_BUCKETS,
         ref_ls.SLOT_EXACT_MAX)
    assert [port_ls.mask_words(w) for w in (1, 31, 32, 63, 64, 127)] == \
        [1, 1, 2, 2, 3, 4]


def test_wrapper_takes_plain_version_for_cpu_tensors():
    port_m, ref_m = _models("set")
    encs = [encode_history(h, ref_m)
            for h in _histories("set", 6, 30, 4, 0.1, 2, 3)]
    batch = pack_macro_batch(encs)
    W = bucket_slots(max(e.n_slots for e in encs))
    port_ls.reset_launch_counts()
    ok, of = sort_scan(torch.from_numpy(batch["events"]), W, 8,
                       batch["macro_p"], torch.from_numpy(batch["n_events"]),
                       model=port_m)
    p_ok, p_of = _plain(port_m, 8, W, batch)
    assert ok.tolist() == p_ok.tolist() and of.tolist() == p_of.tolist()
    assert port_ls.launch_counts() == {"sort_scan": 0}


def test_plain_refuses_shapes_beyond_the_caps():
    ev = torch.zeros((1, 2, 5), dtype=torch.int32)
    for W, C in ((0, 4), (128, 4), (4, 0)):
        with pytest.raises(ValueError):
            sort_scan_plain(ev, W, C, model=_models("set")[0])


# ------------------------------------------- what the CUDA kernel relies on
# The kernel (ops/csrc/sort_scan.cu) keeps its frontier in no order and
# deduplicates by hashing, so the plain version it is held to must be a
# function of each round's entries as a set.


def _random_entries(rng, K, N, n_parents):
    masks = rng.integers(0, 4, size=(N, K)).astype(np.uint32)
    masks[:, K - 1] &= 0x7FFFFFFF
    masks[rng.random(N) < 0.2] = 0xFFFFFFFF
    states = rng.choice([-2**31, -1, 0, 1, 2**31 - 1], size=N).astype(np.int32)
    dup = rng.integers(0, N, size=N // 4)
    masks[dup[1:]] = masks[dup[:-1]]
    states[dup[1:]] = states[dup[:-1]]
    tags = (np.arange(N) >= n_parents).astype(np.int64)
    return masks.astype(np.int64), states, tags


def _dedup(masks, states, tags, C):
    m, s, count, grew = port_ls._dedup_compact(
        torch.from_numpy(masks)[None], torch.from_numpy(states)[None],
        torch.from_numpy(tags)[None], C)
    return m[0].tolist(), s[0].tolist(), int(count[0]), bool(grew[0])


@pytest.mark.parametrize("where", ["below", "at", "above"])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_dedup_compact_is_a_function_of_the_multiset(K, where):
    """Permuting the rows of (masks, states, tags) leaves the kept
    entries, the distinct count and grew unchanged, with C below, at and
    above the distinct count."""
    rng = np.random.default_rng(40 + K)
    N = 48
    for trial in range(6):
        masks, states, tags = _random_entries(rng, K, N, 6 + trial)
        live = masks[:, K - 1] != 0xFFFFFFFF
        d = len({(tuple(m), int(s)) for m, s, ok in
                 zip(masks.tolist(), states, live) if ok})
        C = {"below": max(d - 1, 1), "at": d, "above": min(d + 1, N)}[where]
        want = _dedup(masks, states, tags, C)
        assert want[2] == d
        for _ in range(3):
            p = rng.permutation(N)
            assert _dedup(masks[p], states[p], tags[p], C) == want


def _frontier_set(carry, lay, K):
    masks = lay.view(carry, "masks").reshape(carry.shape[0], -1, K)
    states = lay.view(carry, "states")
    return [sorted((tuple(m), s) for m, s in zip(mr.tolist(), sr.tolist())
                   if m[K - 1] != -1)
            for mr, sr in zip(masks, states)]


@pytest.mark.parametrize("kind,W,C", [("register", 8, 8), ("counter", 8, 64),
                                      ("queue", 12, 8), ("set", 8, 64),
                                      ("list-append", 5, 8),
                                      ("register", 31, 4),
                                      ("set", 12, 16), ("counter", 40, 8)])
def test_chunk_plain_is_a_function_of_the_frontier_set(kind, W, C):
    """sort_chunk_plain from a carry whose live frontier entries are
    permuted gives the same four flags and, as a set, the same frontier,
    chunk after chunk."""
    from jepsen_jgroups_raft_tpu_torch.history.packing import \
        encode_history as port_encode
    from jepsen_jgroups_raft_tpu_torch.history.packing import \
        pack_batch as port_pack
    from jepsen_jgroups_raft_tpu_torch.models import MODELS

    m = MODELS[KINDS.get(kind, kind)]()
    rng = random.Random(W * 7 + C)
    vr = {"value_range": 32} if kind == "set" else {}
    hs = [burst_history(rng, kind, W - j, **vr) for j in range(2)] + \
        [random_valid_history(rng, kind, n_ops=30, n_procs=min(W, 5),
                              crash_p=0.3, max_crashes=max(W - 5, 0), **vr)
         for _ in range(4)]
    batch = port_pack([port_encode(h, m) for h in hs])
    ev = torch.from_numpy(batch["events"])
    ne = torch.from_numpy(batch["n_events"])
    K, lay = port_ls.mask_words(W), port_ls.sort_carry_layout(W, C)
    carry = port_ls.sort_chunk_init(ne, W, C, m)
    prng = np.random.default_rng(W + C)
    permuted = 0
    for lo in range(0, int(ev.shape[1]), 6):
        rows = ev[:, lo:lo + 6].contiguous()
        out = port_ls.sort_chunk_plain(carry, rows, W, C, model=m, width=6)
        shuffled = carry.clone()
        masks = lay.view(shuffled, "masks").reshape(len(hs), C, K)
        states = lay.view(shuffled, "states")
        for b in range(len(hs)):
            n = int((masks[b, :, K - 1] != -1).sum())
            p = torch.from_numpy(prng.permutation(n))
            masks[b, :n] = masks[b, p].clone()
            states[b, :n] = states[b, p].clone()
            permuted += n > 1
        lay.view(shuffled, "masks")[:] = masks.reshape(len(hs), C * K)
        got = port_ls.sort_chunk_plain(shuffled, rows, W, C, model=m,
                                       width=6)
        for a, b in zip(out[1:], got[1:]):
            assert a.tolist() == b.tolist()
        assert _frontier_set(out[0], lay, K) == _frontier_set(got[0], lay, K)
        carry = out[0]
    assert permuted > 0


EDGE_CASES = [c for c in sort_edge_cases()
              if c[1] <= 9 or c[0] == "high_W63_w6_C64"]


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_edge_cases_match_reference(case):
    """The kernel's edge cases on the CPU: candidates that collide on one
    key, keys that differ only in the state or only in the highest key
    field, distinct counts of exactly C and C + 1, C from 1 to 512. The
    plain version equals the reference's sort kernel on both flags."""
    name, W, C, ev, ne, P = case
    port_m, ref_m = _models("register")
    batch = {"events": ev, "macro_p": P}
    ok, of = _plain(port_m, C, W, batch, ne)
    r_ok, r_of = _ref(ref_m, C, W, batch)
    assert ok.tolist() == r_ok.tolist() and of.tolist() == r_of.tolist()
    kind, w = name.split("_")[0], int(name.split("_w")[1].split("_")[0])
    distinct = {"illegal": 1, "state": 1 + w * 2 ** (w - 1)}.get(kind,
                                                                 2 ** w)
    assert of.tolist() == [distinct > C] * len(ne)
