"""Card-only tests of the port's CUDA kernels (marker `gpu`).

The hand-written kernels have no CPU mode, so every test here skips
with a reason where torch.cuda is unavailable. The file imports only
the port, so on the card it runs without the conftest that pins JAX to
the host:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Each kernel is held bitwise to its plain PyTorch version on the same
inputs (verdicts are booleans: tolerance is exact equality).
"""

import os
import random

import numpy as np
import pytest
import torch

# tests/conftest.py's pins, which --noconftest skips: the kernel suites
# run with the lin fast path off (at the default knobs the host
# certifier decides most valid rows before any launch) and no measured
# gate state
os.environ.setdefault("JGRAFT_LIN_FASTPATH", "0")
os.environ.setdefault("JGRAFT_AUTOTUNE", "0")

from jepsen_jgroups_raft_tpu_torch.checker import schedule
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.checker.schedule import (DenseLaunch,
                                                            run_dense_groups)
from jepsen_jgroups_raft_tpu_torch.history.packing import (encode_history,
                                                           pack_batch,
                                                           pack_macro_batch)
from jepsen_jgroups_raft_tpu_torch.history.synth import (
    build_history, burst_history, offset_counter_history, random_mask_rows,
    random_valid_history, sort_edge_cases)
from jepsen_jgroups_raft_tpu_torch.models import (MODELS, Counter, GSet,
                                                  TicketQueue)
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls
from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import carry_mismatch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _histories(seed, n, n_ops, n_procs, max_crashes, value_range, crash_p):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = list(random_valid_history(rng, "register", n_ops=n_ops,
                                      n_procs=n_procs, crash_p=crash_p,
                                      max_crashes=max_crashes,
                                      value_range=value_range))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        if i % 2 and reads:
            j = rng.choice(reads)
            h[j] = h[j].replace(value=h[j].value + 1)
        out.append(h)
    return out


CONFIGS = {
    # name: (histories, launch window, domain table size)
    "W10_S8": (lambda: _histories(1, 24, 120, 5, 5, 7, 0.3), 10, 8),
    "W9_S16": (lambda: _histories(2, 24, 120, 5, 4, 15, 0.3), 9, 16),
    "W5_S4": (lambda: _histories(3, 32, 150, 3, 2, 3, 0.1), 5, 4),
    "W8_S4": (lambda: _histories(4, 32, 150, 5, 3, 3, 0.3), 8, 4),
}


def _group(hists, W, S, macro, dev):
    """(events, val_of, n_events, macro_p, widest history window) of one
    group launched at window W with a table of S ids."""
    m = CasRegister()
    encs = [encode_history(h, m) for h in hists]
    plan = ds.dense_plan(m, encs)
    assert plan is not None and plan.n_slots <= W and plan.n_states <= S
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    val_of = torch.from_numpy(plan.val_of)
    if S > val_of.shape[1]:  # pad the table with its id-0 value
        val_of = torch.cat([val_of, val_of[:, :1].expand(
            -1, S - val_of.shape[1])], dim=1).contiguous()
    return (torch.from_numpy(batch["events"]).to(dev), val_of.to(dev),
            torch.from_numpy(batch["n_events"]).to(dev),
            batch.get("macro_p"), max(e.n_slots for e in encs))


def _inputs(name, macro, dev):
    make, W, S = CONFIGS[name]
    ev, vo, ne, P, _ = _group(make(), W, S, macro, dev)
    return ev, vo, W, P, ne


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_dense_scan_kernel_matches_plain(cuda, name, macro):
    ev, vo, W, P, ne = _inputs(name, macro, cuda)
    before = ds.launch_counts()["dense_scan"]
    ok = ds.dense_scan(ev, vo, W, macro_p=P, n_events=ne)
    torch.cuda.synchronize()
    assert ds.launch_counts()["dense_scan"] == before + 1
    plain = ds.dense_scan_plain(ev, vo, W, macro_p=P, n_events=ne)
    assert ok.device.type == "cuda" and ok.dtype == torch.bool
    assert ok.cpu().tolist() == plain.cpu().tolist()
    assert 0 < int(plain.sum()) < len(plain)  # both polarities


def _cap_histories(seed, W, S, n, n_ops):
    """n histories whose windows reach up to W slots over at most S
    values (up to 5 processes, the rest of the window from crashed ops),
    odd ones with one read corrupted; S = 1: one process reading nil,
    odd histories read a 1 once."""
    rng = random.Random(seed)
    if S == 1:
        return [build_history([r for k in range(n_ops) for r in (
            (0, "invoke", "read", None),
            (0, "ok", "read", 1 if (i % 2 and k == n_ops // 2) else None))])
            for i in range(n)]
    n_procs, crashes = min(W, 5), max(W - 5, 0)
    out = []
    for i in range(n):
        h = list(random_valid_history(rng, "register", n_ops=n_ops,
                                      n_procs=n_procs,
                                      crash_p=0.5 if crashes else 0.0,
                                      max_crashes=crashes,
                                      value_range=S - 1))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        if i % 2 and reads:
            j = rng.choice(reads)
            h[j] = h[j].replace(value=h[j].value + 1)
        out.append(h)
    return out


#: every window at the largest domain the caps allow, and W = 1 / S = 1:
#: a case on each in-word / lane / register-word boundary of the layout
WINDOWS = [(W, min(16, 8192 >> W)) for W in range(1, 11)] + [(1, 1)]


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W,S", WINDOWS,
                         ids=[f"W{w}_S{s}" for w, s in WINDOWS])
def test_dense_scan_kernel_every_window(cuda, W, S, macro):
    ev, vo, ne, P, top = _group(_cap_histories(100 + W, W, S, 24, 150), W,
                                S, macro, cuda)
    assert top == W  # some history uses the top slot's layout kind
    ok = ds.dense_scan(ev, vo, W, macro_p=P, n_events=ne)
    torch.cuda.synchronize()
    plain = ds.dense_scan_plain(ev, vo, W, macro_p=P, n_events=ne)
    assert ok.cpu().tolist() == plain.cpu().tolist()
    assert 0 < int(plain.sum()) < len(plain)  # both polarities


def test_run_dense_groups_overlapped_matches_plain_per_group(cuda):
    specs = [(2, 16, 30, 50, False), (6, 16, 24, 120, True),
             (10, 8, 24, 150, True), (1, 1, 12, 30, True)]
    launches = []
    for k, (W, S, n, n_ops, macro) in enumerate(specs):
        ev, vo, ne, P, _ = _group(_cap_histories(200 + k, W, S, n, n_ops),
                                  W, S, macro, cuda)
        launches.append(DenseLaunch(events=ev, val_of=vo, n_events=ne,
                                    n_slots=W, macro_p=P))
    before = ds.launch_counts()["dense_scan"]
    run = run_dense_groups(launches, CasRegister(), timed=True)
    assert ds.launch_counts()["dense_scan"] == before + len(launches)
    assert len(run.kernel_ms) == len(launches) and run.span_ms > 0
    for ln, ok in zip(launches, run.ok):
        plain = ds.dense_scan_plain(ln.events, ln.val_of, ln.n_slots,
                                    macro_p=ln.macro_p,
                                    n_events=ln.n_events)
        assert ok.tolist() == plain.cpu().tolist()


def _random_rows(rng, B, E, W, P, vals):
    """Event rows that stray from what the packer emits while keeping
    most frontiers alive: mostly writes (always legal) on free slots and
    FORCEs of open slots, but also slots out of range (ignored at OPEN,
    clipped at FORCE), re-opened slots, payloads sharing a slot in one
    macro row, n_opens past P or negative, padding and unknown kinds,
    opcodes and values outside the model and the domain."""
    R = 5 if P is None else 3 + 4 * P
    ev = np.zeros((B, E, R), dtype=np.int32)
    pool = np.concatenate([vals, [7, -5]])

    def slot(among, p_among):
        if among and rng.random() < p_among:
            return int(rng.choice(among))
        return int(rng.integers(-2, W + 2))

    def op():
        f = int(rng.choice([1, 0, 2, 3], p=[.85, .05, .05, .05]))
        a = rng.choice(vals if rng.random() < 0.97 else pool)
        return f, int(a), int(rng.choice(pool))

    for h in range(B):
        open_ = set()
        for e in range(E):
            free = [w for w in range(W) if w not in open_]
            kind = int(rng.choice([0, 1, 2, 3], p=[.05, .45, .45, .05]))
            if kind == 2 and P is None and not open_ and rng.random() < .9:
                kind = 1
            opens = []
            if P is None and kind == 1:
                opens = [(slot(free, 0.85), *op())]
                ev[h, e, :5] = (1, *opens[0])
            elif P is not None:
                n = int(rng.integers(0, min(len(free), P) + 1))
                opens = [(slot(free, 0.85), *op()) for _ in range(n)]
                for j, pay in enumerate(opens):
                    ev[h, e, 3 + 4 * j:7 + 4 * j] = pay
                ev[h, e, 2] = n if rng.random() < 0.9 else \
                    int(rng.choice([-1, P + 2]))
            open_ |= {q for q, *_ in opens if 0 <= q < W}
            ev[h, e, 0] = kind
            if kind == 2:
                f = slot(sorted(open_), 0.97)
                ev[h, e, 1] = f
                open_.discard(f)
    return ev


@pytest.mark.parametrize("P", [None, 3, 16], ids=["legacy", "P3", "P16"])
@pytest.mark.parametrize("W,S", [(3, 3), (6, 16), (10, 8)],
                         ids=["W3_S3", "W6_S16", "W10_S8"])
def test_dense_scan_kernel_matches_plain_on_arbitrary_rows(cuda, W, S, P):
    rng = np.random.default_rng(10 * W + S + (P or 0))
    B, E = 96, 48
    vals = np.resize(np.array([-2**31, 0, 1, 2, 3, 4, 5, 6], np.int32), S)
    val_of = np.tile(vals, (B, 1))
    ev = _random_rows(rng, B, E, W, P, vals)
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0  # EV_PAD past the end
    ev = torch.from_numpy(ev).to(cuda)
    vo = torch.from_numpy(val_of).to(cuda)
    ne = torch.from_numpy(n_events).to(cuda)
    ok = ds.dense_scan(ev, vo, W, macro_p=P, n_events=ne)
    torch.cuda.synchronize()
    plain = ds.dense_scan_plain(ev, vo, W, macro_p=P, n_events=ne)
    assert ok.cpu().tolist() == plain.cpu().tolist()
    assert 0 < int(plain.sum()) < B  # both polarities


def test_dense_scan_rows_past_n_events_are_not_read(cuda):
    ev, vo, W, P, ne = _inputs("W5_S4", True, cuda)
    # FORCE rows of slot 0 after every history's end: read, they would
    # kill most frontiers (slot 0 is rarely held open at the end)
    junk = torch.zeros_like(ev[:, :5])
    junk[:, :, 0] = 2
    ok = ds.dense_scan(torch.cat([ev, junk], 1).contiguous(), vo, W,
                       macro_p=P, n_events=ne)
    ref = ds.dense_scan(ev, vo, W, macro_p=P, n_events=ne)
    torch.cuda.synchronize()
    assert ok.cpu().tolist() == ref.cpu().tolist()


def test_dense_scan_refuses_bad_inputs(cuda):
    ev, vo, W, P, ne = _inputs("W5_S4", True, cuda)
    with pytest.raises(TypeError):
        ds.dense_scan(ev.to(torch.int64), vo, W, macro_p=P, n_events=ne)
    with pytest.raises(ValueError):
        ds.dense_scan(ev[:, :, ::2], vo, W, macro_p=P, n_events=ne)
    with pytest.raises(ValueError):
        ds.dense_scan(ev, vo, 11, macro_p=P, n_events=ne)
    with pytest.raises(ValueError):
        ds.dense_scan(ev, vo.cpu(), W, macro_p=P, n_events=ne)


def test_check_histories_on_card_matches_cpu(cuda):
    hs = _histories(9, 48, 200, 5, 3, 3, 0.1)
    m = CasRegister()
    on_card = check_histories(hs, m)
    on_host = check_histories(hs, m, device="cpu")
    keys = ("valid?", "kernel", "decided-tier", "op-count",
            "concurrency-window")
    assert [{k: r[k] for k in keys} for r in on_card] == \
        [{k: r[k] for k in keys} for r in on_host]


# ------------------------------------------------------------ mask mode

MASK_MODELS = {"counter": Counter, "queue": TicketQueue}


def _corrupt_observation(h, rng, bump=1000):
    """One ok read / add-and-get / enqueue / dequeue observation changed:
    a number raised by `bump` (1000: beyond what the crashed ops could
    explain), a set read given element 31 (or losing it)."""
    idx = [j for j, op in enumerate(h) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = h[j].value
        v = (sorted(set(v) ^ {31}) if isinstance(v, list) else
             (v[0], v[1] + bump) if isinstance(v, tuple) else v + bump)
        h[j] = h[j].replace(value=v)
    return h


def _mask_histories(kind, W, n, n_ops, seed):
    """n counter or queue histories with windows up to W, the first
    exactly W (up to 5 processes, the rest of the window from crashed
    ops); odd ones with one observation bumped. Returns (histories,
    encodings)."""
    rng = random.Random(seed)
    m = MASK_MODELS[kind]()
    n_procs, crashes = min(W, 5), max(W - 5, 0)
    top, rest = None, []
    while top is None or len(rest) < n - 1:
        h = list(random_valid_history(rng, kind, n_ops=n_ops,
                                      n_procs=n_procs,
                                      crash_p=0.5 if crashes else 0.0,
                                      max_crashes=crashes))
        w = encode_history(h, m).n_slots
        if w == W and top is None:
            top = h
        elif w <= W and len(rest) < n - 1:
            rest.append(h)
    hists = [_corrupt_observation(h, rng) if i % 2 else h
             for i, h in enumerate([top] + rest)]
    return hists, [encode_history(h, m) for h in hists]


def _mask_group(encs, macro, dev):
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    return (torch.from_numpy(batch["events"]).to(dev),
            torch.from_numpy(batch["n_events"]).to(dev),
            batch.get("macro_p"))


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", range(1, 13), ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind", list(MASK_MODELS))
def test_mask_scan_kernel_every_window(cuda, kind, W, macro):
    m = MASK_MODELS[kind]()
    _, encs = _mask_histories(kind, W, 24, 100, 300 + W)
    ev, ne, P = _mask_group(encs, macro, cuda)
    before = ds.launch_counts()["mask_scan"]
    ok = ds.mask_scan(ev, W, P, ne, model=m)
    torch.cuda.synchronize()
    assert ds.launch_counts()["mask_scan"] == before + 1
    plain = ds.mask_scan_plain(ev, W, P, ne, model=m)
    assert ok.device.type == "cuda" and ok.dtype == torch.bool
    assert ok.cpu().tolist() == plain.cpu().tolist()
    assert 0 < int(plain.sum()) < len(plain)  # both polarities


@pytest.mark.parametrize("P", [None, 3, 16], ids=["legacy", "P3", "P16"])
@pytest.mark.parametrize("W", [1, 5, 6, 10, 12], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind,init", [("counter", 0), ("queue", 0),
                                       ("counter", 2**31 - 3)],
                         ids=["counter", "queue", "counter_near_2^31"])
def test_mask_scan_kernel_matches_plain_on_arbitrary_rows(cuda, kind, init,
                                                          W, P):
    m = Counter(init) if kind == "counter" else TicketQueue()
    rng = np.random.default_rng(1000 * W + (P or 0))
    B, E = 96, 48
    ev = random_mask_rows(rng, B, E, W, P, kind)
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0  # EV_PAD past the end
    ev = torch.from_numpy(ev).to(cuda)
    ne = torch.from_numpy(n_events).to(cuda)
    ok = ds.mask_scan(ev, W, P, ne, model=m)
    torch.cuda.synchronize()
    plain = ds.mask_scan_plain(ev, W, P, ne, model=m)
    assert ok.cpu().tolist() == plain.cpu().tolist()
    assert 0 < int(plain.sum()) < B  # both polarities


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
def test_mask_scan_counter_crosses_int32_boundary(cuda, macro):
    """Counter histories started 40 below 2^31: the sums wrap to negative
    values mid-history, in the kernel as in the plain version."""
    offset = 2**31 - 40
    m = Counter(offset)
    hists, _ = _mask_histories("counter", 8, 32, 120, 77)
    encs = [encode_history(offset_counter_history(h, offset), m)
            for h in hists]
    assert any(((e.events[:, 3] < 0) & (e.events[:, 2] == 0)).any()
               for e in encs)  # some read observed a wrapped value
    ev, ne, P = _mask_group(encs, macro, cuda)
    W = max(e.n_slots for e in encs)
    ok = ds.mask_scan(ev, W, P, ne, model=m)
    torch.cuda.synchronize()
    plain = ds.mask_scan_plain(ev, W, P, ne, model=m)
    assert ok.cpu().tolist() == plain.cpu().tolist()
    assert 0 < int(plain.sum()) < len(plain)


def test_mask_scan_refuses_bad_inputs(cuda):
    _, encs = _mask_histories("counter", 5, 8, 40, 5)
    ev, ne, P = _mask_group(encs, True, cuda)
    with pytest.raises(ValueError):
        ds.mask_scan(ev, 13, P, ne, model=Counter())
    with pytest.raises(ValueError):
        ds.mask_scan(ev, 5, P, ne, model=CasRegister())
    with pytest.raises(TypeError):
        ds.mask_scan(ev.to(torch.int64), 5, P, ne, model=Counter())
    with pytest.raises(ValueError):
        ds.mask_scan(ev, 5, P, ne.cpu(), model=Counter())


def test_run_dense_groups_domain_and_mask_groups_together(cuda):
    """Register domain groups and counter / queue mask groups launched
    back to back in one run_dense_groups call (each mask group carries
    its own model), each against its plain version."""
    launches = []
    for k, (W, S, n, n_ops, macro) in enumerate([(6, 16, 24, 120, True),
                                                 (3, 4, 16, 60, False)]):
        ev, vo, ne, P, _ = _group(_cap_histories(400 + k, W, S, n, n_ops),
                                  W, S, macro, cuda)
        launches.append(DenseLaunch(events=ev, val_of=vo, n_events=ne,
                                    n_slots=W, macro_p=P))
    for kind, W, macro in (("counter", 8, True), ("queue", 12, True),
                           ("counter", 2, False)):
        _, encs = _mask_histories(kind, W, 16, 80, 500 + W)
        ev, ne, P = _mask_group(encs, macro, cuda)
        launches.append(DenseLaunch(
            events=ev, val_of=torch.zeros((ev.shape[0], 1),
                                          dtype=torch.int32, device=cuda),
            n_events=ne, n_slots=W, macro_p=P, tag="dense-mask",
            kind="mask", model=MASK_MODELS[kind]()))
    before = ds.launch_counts()
    run = run_dense_groups(launches, CasRegister(), timed=True)
    after = ds.launch_counts()
    assert after["dense_scan"] - before["dense_scan"] == 2
    assert after["mask_scan"] - before["mask_scan"] == 3
    assert len(run.kernel_ms) == len(launches) and run.span_ms > 0
    for ln, ok in zip(launches, run.ok):
        if ln.kind == "mask":
            plain = ds.mask_scan_plain(ln.events, ln.n_slots, ln.macro_p,
                                       ln.n_events, model=ln.model)
        else:
            plain = ds.dense_scan_plain(ln.events, ln.val_of, ln.n_slots,
                                        macro_p=ln.macro_p,
                                        n_events=ln.n_events)
        assert ok.tolist() == plain.cpu().tolist()
        assert 0 < int(plain.sum()) < len(plain)


@pytest.mark.parametrize("kind", list(MASK_MODELS))
def test_check_histories_mask_on_card_matches_cpu(cuda, kind):
    hists, _ = _mask_histories(kind, 8, 48, 200, 9)
    m = MASK_MODELS[kind]()
    on_card = check_histories(hists, m)
    on_host = check_histories(hists, m, device="cpu")
    keys = ("valid?", "kernel", "decided-tier", "op-count",
            "concurrency-window")
    assert [{k: r[k] for k in keys} for r in on_card] == \
        [{k: r[k] for k in keys} for r in on_host]
    assert {r["decided-tier"] for r in on_card} == {"mask"}


def _counter10_histories(W, n, n_ops, seed):
    """n counter histories of upstream's documented concurrency (10
    processes, crash_p 0.05, at most 3 crashes) with windows up to W, the
    first exactly W; odd ones with one observation bumped."""
    rng = random.Random(seed)
    m = Counter()
    top, rest = None, []
    while top is None or len(rest) < n - 1:
        h = list(random_valid_history(rng, "counter", n_ops=n_ops, n_procs=10,
                                      crash_p=0.05, max_crashes=3))
        w = encode_history(h, m).n_slots
        if w == W and top is None:
            top = h
        elif w <= W and len(rest) < n - 1:
            rest.append(h)
    hists = [_corrupt_observation(h, rng) if i % 2 else h
             for i, h in enumerate([top] + rest)]
    return [encode_history(h, m) for h in hists]


def _kernel_and_plain(ev, ne, W, P, m):
    ok = ds.mask_scan(ev, W, P, ne, model=m)
    torch.cuda.synchronize()
    plain = ds.mask_scan_plain(ev, W, P, ne, model=m)
    assert ok.cpu().tolist() == plain.cpu().tolist()
    return plain


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", [10, 11, 12], ids=lambda w: f"W{w}")
def test_mask_scan_kernel_ten_processes(cuda, W, macro):
    ev, ne, P = _mask_group(_counter10_histories(W, 24, 300, 600 + W), macro,
                            cuda)
    plain = _kernel_and_plain(ev, ne, W, P, Counter())
    assert 0 < int(plain.sum()) < len(plain)


def test_mask_scan_kernel_queue_thousand_rows(cuda):
    """A queue group of 1000 histories at W = 8: two warps on most SM
    sub-partitions, as the suite's queue batch puts them."""
    _, encs = _mask_histories("queue", 8, 1000, 60, 71)
    ev, ne, P = _mask_group(encs, True, cuda)
    plain = _kernel_and_plain(ev, ne, 8, P, TicketQueue())
    assert 0 < int(plain.sum()) < len(plain)


@pytest.mark.parametrize("P", [None, 4], ids=["legacy", "P4"])
@pytest.mark.parametrize("W", [3, 8, 12], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind", list(MASK_MODELS))
def test_mask_scan_kernel_always_legal_rows(cuda, kind, W, P):
    """Rows whose every op is always legal (counter adds, crashed
    enqueues): no slot is built; a few rows FORCE a slot never opened,
    so both polarities show."""
    rng = np.random.default_rng(50 * W + (P or 0))
    B, E = 64, 40
    R = 5 if P is None else 3 + 4 * P
    ev = np.zeros((B, E, R), dtype=np.int32)
    for h in range(B):
        open_ = set()
        for e in range(E):
            free = [w for w in range(W) if w not in open_]
            if free and (not open_ or rng.random() < 0.5):
                n = 1 if P is None else int(rng.integers(1, min(len(free),
                                                                P) + 1))
                slots = rng.choice(free, size=n, replace=False)
                for j, q in enumerate(slots):
                    pay = (int(q), 1, int(rng.integers(-3, 4)), 0)
                    if P is None:
                        ev[h, e] = (1, *pay)
                    else:
                        ev[h, e, 3 + 4 * j:7 + 4 * j] = pay
                if P is not None:
                    ev[h, e, :3] = (1, 0, n)
                open_ |= {int(q) for q in slots}
            else:
                q = int(rng.choice(sorted(open_)))
                if h % 4 == 3 and e == E // 2:
                    q = min(free) if free else q  # a slot never opened
                ev[h, e, :2] = (2, q)
                open_.discard(q)
    ev_t = torch.from_numpy(ev).to(cuda)
    ne = torch.full((B,), E, dtype=torch.int32, device=cuda)
    m = MASK_MODELS[kind]()
    stats: dict = {}
    ds.mask_scan_plain(ev_t, W, P, ne, model=m, stats=stats)
    assert stats["ballots_lazy"] == 0 and stats["closures"] > 0
    plain = _kernel_and_plain(ev_t, ne, W, P, m)
    assert 0 < int(plain.sum()) < B


@pytest.mark.parametrize("kind,W", [("counter", 5), ("counter", 8),
                                    ("queue", 8), ("counter", 12)])
def test_mask_scan_profile_counts_match_plain(cuda, kind, W):
    """The instrumented build's verdicts equal the plain version's, and
    its closing FORCEs and ballots equal the plain version's `closures`
    and `ballots_lazy`; it is not counted as a launch of the main
    kernel."""
    if W == 12:
        encs = _counter10_histories(W, 16, 200, 800)
    else:
        _, encs = _mask_histories(kind, W, 32, 200, 810)
    ev, ne, P = _mask_group(encs, True, cuda)
    m = MASK_MODELS[kind]()
    before = ds.launch_counts()
    ok, prof = ds.mask_scan_profile(ev, W, P, ne, model=m)
    torch.cuda.synchronize()
    assert ds.launch_counts() == before
    stats: dict = {}
    plain = ds.mask_scan_plain(ev, W, P, ne, model=m, stats=stats)
    assert ok.cpu().tolist() == plain.cpu().tolist()
    c = dict(zip(ds.MASK_PROFILE_FIELDS, prof.sum(0).cpu().tolist()))
    assert c["closures"] == stats["closures"]
    assert c["ballots"] == stats["ballots_lazy"]
    assert c["rows"] > 0 and c["legality_cycles"] > 0


# ------------------------------------------------------- the sort ladder

SORT_KINDS = {"register": "cas-register", "counter": "counter",
              "queue": "queue", "set": "set"}
SORT_WINDOWS = list(range(1, 17)) + [31, 63, 95, 127]
SORT_CAPS = (4, 64, 256)


def _sort_histories(kind, W, n, seed):
    """n histories for sort window W: random ones with windows up to W
    (up to 5 processes, the rest crashed ops) and bursts (every op open
    at once) that reach W; odd ones corrupted."""
    rng = random.Random(seed)
    vr = {"value_range": 32} if kind == "set" else {}
    hs = []
    if W <= 16:
        hs = [list(random_valid_history(rng, kind, n_ops=24,
                                        n_procs=min(W, 5),
                                        crash_p=0.3 if W > 5 else 0.1,
                                        max_crashes=max(W - 5, 0), **vr))
              for _ in range(n - 1)]
    for j in range(n - len(hs)):
        hs.append(list(burst_history(rng, kind, max(W - 3 * j, 1), **vr)))
    return [_corrupt_observation(h, rng, 1) if i % 2 else h
            for i, h in enumerate(hs)]


def _sort_group(kind, hists, macro, dev):
    m = MODELS[SORT_KINDS[kind]]()
    encs = [encode_history(h, m) for h in hists]
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    return (m, torch.from_numpy(batch["events"]).to(dev),
            torch.from_numpy(batch["n_events"]).to(dev),
            batch.get("macro_p"), max(e.n_slots for e in encs))


def _sort_kernel_and_plain(ev, ne, W, C, P, m):
    before = ls.launch_counts()["sort_scan"]
    ok, of = ls.sort_scan(ev, W, C, P, ne, model=m)
    torch.cuda.synchronize()
    assert ls.launch_counts()["sort_scan"] == before + 1
    assert ok.device == ev.device and ok.dtype == of.dtype == torch.bool
    p_ok, p_of = ls.sort_scan_plain(ev, W, C, P, ne, model=m)
    assert ok.cpu().tolist() == p_ok.cpu().tolist()
    assert of.cpu().tolist() == p_of.cpu().tolist()
    return p_ok.cpu(), p_of.cpu()


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", SORT_WINDOWS, ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind", list(SORT_KINDS))
def test_sort_scan_kernel_every_window(cuda, kind, W, macro):
    C = SORT_CAPS[SORT_WINDOWS.index(W) % len(SORT_CAPS)]
    m, ev, ne, P, widest = _sort_group(
        kind, _sort_histories(kind, W, 6, 900 + W), macro, cuda)
    assert widest <= W and (ls.bucket_slots(widest) == W or
                            kind == "register")
    _sort_kernel_and_plain(ev, ne, W, C, P, m)


OVERFLOW_CASES = [("set", 8), ("counter", 8), ("register", 4),
                  ("register", 8), ("queue", 8)]


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("kind,C", OVERFLOW_CASES,
                         ids=[f"{k}_C{c}" for k, c in OVERFLOW_CASES])
def test_sort_scan_kernel_overflowed_rows(cuda, kind, C, macro):
    """Short histories with C near their frontier: rows that overflow
    and end ok, and rows that overflow and do not, equal the plain
    version's (the kept entries are the same)."""
    rng = random.Random(11)
    hs = [random_valid_history(rng, kind, n_ops=12, n_procs=4, crash_p=0.0,
                               max_crashes=0) for _ in range(64)]
    m, ev, ne, P, widest = _sort_group(kind, hs, macro, cuda)
    ok, of = _sort_kernel_and_plain(ev, ne, ls.bucket_slots(widest), C, P, m)
    assert (of & ok).any() and (of & ~ok).any()


@pytest.mark.parametrize("P", [None, 3, 16], ids=["legacy", "P3", "P16"])
@pytest.mark.parametrize("W", [1, 6, 12, 40, 127], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind,init", [("counter", None), ("queue", None),
                                       ("set", None), ("register", None),
                                       ("counter", 2**31 - 3)],
                         ids=["counter", "queue", "set", "register",
                              "counter_near_2^31"])
def test_sort_scan_kernel_matches_plain_on_arbitrary_rows(cuda, kind, init,
                                                          W, P):
    m = MODELS[SORT_KINDS[kind]](init) if init is not None else \
        MODELS[SORT_KINDS[kind]]()
    rng = np.random.default_rng(7 * W + (P or 0))
    B, E = 32, 32
    ev = random_mask_rows(rng, B, E, W, P, kind)
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0
    _sort_kernel_and_plain(torch.from_numpy(ev).to(cuda),
                           torch.from_numpy(n_events).to(cuda), W,
                           4 if W > 12 else 64, P, m)


def test_sort_scan_refuses_bad_inputs(cuda):
    m, ev, ne, P, _ = _sort_group("set", _sort_histories("set", 5, 4, 3),
                                  True, cuda)
    for W, C in ((0, 4), (128, 4), (5, 0), (5, ls.MAX_CONFIGS + 1)):
        with pytest.raises(ValueError):
            ls.sort_scan(ev, W, C, P, ne, model=m)
    with pytest.raises(TypeError):
        ls.sort_scan(ev.to(torch.int64), 5, 4, P, ne, model=m)
    with pytest.raises(ValueError):
        ls.sort_scan(ev, 5, 4, P, ne.cpu(), model=m)
    with pytest.raises(ValueError):
        ls.sort_scan(ev, 5, 4, None, ne, model=m)  # macro rows, legacy P


def test_sort_scan_rows_past_n_events_are_not_read(cuda):
    m, ev, ne, P, W = _sort_group("set", _sort_histories("set", 6, 6, 4),
                                  True, cuda)
    want = _sort_kernel_and_plain(ev, ne, W, 64, P, m)
    junk = torch.cat([ev, torch.full_like(ev[:, :5], 2)], dim=1)
    ok, of = ls.sort_scan(junk.contiguous(), W, 64, P, ne, model=m)
    assert [ok.cpu().tolist(), of.cpu().tolist()] == \
        [want[0].tolist(), want[1].tolist()]


SORT_EDGES = sort_edge_cases()


@pytest.mark.parametrize("case", SORT_EDGES, ids=[c[0] for c in SORT_EDGES])
def test_sort_scan_kernel_edge_cases(cuda, case):
    """Candidates that collide on one key, keys that differ only in the
    state or only in the highest key field (K up to 4, W = 127), distinct
    counts of exactly C and C + 1, C from 1 to 512: bitwise to the plain
    version (run on the card)."""
    name, W, C, ev, ne, P = case
    _sort_kernel_and_plain(torch.from_numpy(ev).to(cuda),
                           torch.from_numpy(ne).to(cuda), W, C, P,
                           CasRegister())


@pytest.mark.parametrize("threads,smem_cap", [(32, None), (64, None),
                                              (128, None), (1024, None),
                                              (32, 1), (256, 8192)],
                         ids=["t32", "t64", "t128", "t1024", "t32_tiled",
                              "t256_tiled"])
def test_sort_scan_kernel_at_other_shapes(cuda, threads, smem_cap):
    """Other block shapes, and tiles cut small by a shared-memory cap
    (rounds tile after tile, selects between tiles): the flags do not
    move."""
    for kind, W, C in (("set", 8, 64), ("register", 12, 8),
                       ("queue", 31, 16), ("counter", 63, 4)):
        m, ev, ne, P, widest = _sort_group(
            kind, _sort_histories(kind, W, 6, 300 + W), True, cuda)
        shape = ls.sort_shape(W, C, threads, smem_cap)
        assert shape[0] == min(threads, 1024 if W < 32 else 512)
        ok, of, launch = ls.sort_scan_launcher(ev, W, C, P, ne, model=m,
                                               shape=shape)
        launch(torch.cuda.current_stream(cuda))
        p_ok, p_of = ls.sort_scan_plain(ev, W, C, P, ne, model=m)
        assert ok.cpu().tolist() == p_ok.cpu().tolist()
        assert of.cpu().tolist() == p_of.cpu().tolist()


def test_sort_scan_refuses_bad_shapes(cuda):
    """A block that is not whole warps, a tile past 8 a thread, or a
    hash table smaller than twice what a round can hold is refused at
    launch and raises; nothing runs in its place."""
    m, ev, ne, P, W = _sort_group("set", _sort_histories("set", 6, 4, 5),
                                  True, cuda)
    threads, tile, tlog, _ = ls.sort_shape(W, 64)
    for bad in ((48, tile, tlog), (threads, 8 * threads + 1, tlog + 4),
                (threads, tile, tlog - 1), (2048, tile, tlog)):
        before = ls.launch_counts()["sort_scan"]
        ok, of, launch = ls.sort_scan_launcher(ev, W, 64, P, ne, model=m,
                                               shape=bad)
        with pytest.raises(RuntimeError):
            launch(torch.cuda.current_stream(cuda))
        assert ls.launch_counts()["sort_scan"] == before


CHUNK_EDGES = [c for c in SORT_EDGES
               if c[1] <= 9 or c[0] in ("high_W63_w6_C64",
                                        "high_W127_w6_C64")]


@pytest.mark.parametrize("case", CHUNK_EDGES,
                         ids=[c[0] for c in CHUNK_EDGES])
def test_sort_chunk_kernel_edge_cases(cuda, case):
    """The chunk form on the edge cases, chunks of 1 and 4 rows: flags and
    the canonical frontier after every launch."""
    name, W, C, ev, ne, P = case
    m = CasRegister()
    ev, ne = torch.from_numpy(ev).to(cuda), torch.from_numpy(ne).to(cuda)
    init, step = ls.make_sort_chunk_checker(m, C, W, macro_p=P)
    lay = ls.sort_carry_layout(W, C)
    for chunk in (1, 4):
        _chunks_kernel_and_plain(step, init(ne), ev, lay, chunk,
                                 ls.CHUNK_LAUNCHES, "sort_scan_chunk")


@pytest.mark.parametrize("W", [3, 8, 12], ids=lambda w: f"W{w}")
def test_set_through_dense_and_mask_kernels(cuda, W):
    """The set's device step in dense_scan.cu (few distinct adds) and
    mask_scan.cu (distinct fresh elements) against the plain versions."""
    rng = random.Random(40 + W)
    m = GSet()
    groups = {"domain": [], "mask": []} if W <= 10 else {"mask": []}
    while min(len(g) for g in groups.values()) < 12:
        h = list(random_valid_history(
            rng, "set", n_ops=rng.randint(8, 40), n_procs=min(W, 5),
            crash_p=0.4 if W > 5 else 0.0, max_crashes=max(W - 5, 0),
            value_range=rng.choice([3, 31])))
        e = encode_history(h, m)
        if e.n_slots > W:
            continue
        kind = ("domain" if m.dense_domain(e.events) is not None
                else "mask" if m.mask_eligible(e.events) else None)
        if kind in groups and len(groups[kind]) < 12:
            reads = [j for j, op in enumerate(h) if op.type == "ok"
                     and op.f == "read"]
            if len(groups[kind]) % 2 and reads:  # a never-added element
                j = rng.choice(reads)
                h[j] = h[j].replace(value=sorted(h[j].value) + [31])
            groups[kind].append(encode_history(h, m))
    for kind, encs in groups.items():
        plan = ds.dense_plan(m, encs)
        assert plan is not None and plan.kind == kind
        batch = pack_macro_batch(encs)
        ev = torch.from_numpy(batch["events"]).to(cuda)
        ne = torch.from_numpy(batch["n_events"]).to(cuda)
        if kind == "domain":
            vo = torch.from_numpy(plan.val_of).to(cuda)
            ok = ds.dense_scan(ev, vo, plan.n_slots, batch["macro_p"], ne, m)
            plain = ds.dense_scan_plain(ev, vo, plan.n_slots,
                                        batch["macro_p"], ne, m)
        else:
            ok = ds.mask_scan(ev, plan.n_slots, batch["macro_p"], ne,
                              model=m)
            plain = ds.mask_scan_plain(ev, plan.n_slots, batch["macro_p"],
                                       ne, model=m)
        torch.cuda.synchronize()
        assert ok.cpu().tolist() == plain.cpu().tolist()
        assert 0 < int(plain.sum()) < len(plain)


def test_check_histories_set_on_card_matches_cpu(cuda):
    """A set batch that takes all three kernels (domain, mask, the sort
    ladder at both rungs) on the card, against the plain versions."""
    rng = random.Random(77)
    hs = []
    for n_ops, vr in ((24, 3), (14, 31), (200, 32)):
        for i in range(12):
            h = list(random_valid_history(rng, "set", n_ops=n_ops, n_procs=5,
                                          crash_p=0.05, max_crashes=3,
                                          value_range=vr))
            hs.append(_corrupt_observation(h, rng, 1) if i % 3 == 1 else h)
    m = GSet()
    ds.reset_launch_counts()
    ls.reset_launch_counts()
    on_card = check_histories(hs, m)
    # the ladder's rungs run the chunked wavefront by default
    assert ls.chunk_launch_counts()["sort_scan_chunk"] > 0
    on_host = check_histories(hs, m, device="cpu")
    keys = ("valid?", "kernel", "decided-tier", "op-count",
            "concurrency-window")
    assert [{k: r.get(k) for k in keys} for r in on_card] == \
        [{k: r.get(k) for k in keys} for r in on_host]
    assert {"dense", "sort"} <= {r["decided-tier"] for r in on_card}


# ------------------------------------------------------- segment_scan (B6)

from jepsen_jgroups_raft_tpu_torch.history.synth import \
    random_segment_inputs  # noqa: E402
from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss  # noqa: E402


def _segment_inputs(seed, W, S, K, E, n_crashed, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a).to(dev) for a in random_segment_inputs(
        rng, K, E, W, S, n_crashed)]


@pytest.mark.parametrize("W,S", [(W, min(16, 8192 >> W))
                                 for W in range(1, 11)] + [(3, 1), (6, 4)])
def test_segment_scan_kernel_matches_plain(cuda, W, S):
    for n_crashed in range(0, min(W, 4) + 1):
        ev, vals, sm, st, n_ev = _segment_inputs(
            100 * W + n_crashed, W, S, 6, 160, n_crashed, cuda)
        before = ss.launch_counts()["segment_scan"]
        F = ss.segment_scan(ev, vals, sm, st, W, n_ev)
        torch.cuda.synchronize()
        assert ss.launch_counts()["segment_scan"] == before + 1
        plain = ss.segment_scan_plain(ev, vals, sm, st, W, n_ev)
        assert F.shape == plain.shape == (6, sm.shape[1], 1 << W, S)
        assert F.dtype == torch.bool
        assert torch.equal(F.cpu(), plain.cpu()), (W, S, n_crashed)
        live = plain.flatten(2).any(dim=2)
        assert not live[:, -1].any() and not live[:, -2].any()


#: every (W, field_log2) the launcher instantiates, at S = 2^field_log2
SEGMENT_LAYOUTS = [(W, lf) for W in range(1, 11) for lf in range(5)
                   if W + lf <= 13]


def _segment_case(seed, W, S, NB, dev, K=4, E=160):
    """K segments at (W, S) with NB seeds: the crash set's basis first,
    then more seeds drawn from it (so every CTA of a wide NB has live
    runs), then padded (-1) and out-of-frontier seeds; segment 1 has no
    real rows, segment 2 starts with a FORCE of slot 0 (every seed
    without bit 0 dies there), the others real lengths of their own."""
    rng = np.random.default_rng(seed)
    c = min(W, 2)
    ev, vals, sm0, st0, ne = random_segment_inputs(rng, K, E, W, S, c)
    sm = np.full((K, NB), -1, np.int32)
    st = np.zeros((K, NB), np.int32)
    n0 = min(NB, sm0.shape[1])
    sm[:, :n0], st[:, :n0] = sm0[:, :n0], st0[:, :n0]
    if NB > n0:
        extra = NB - n0
        sm[:, n0:] = rng.integers(0, 1 << c, size=(K, extra))
        st[:, n0:] = rng.integers(0, S, size=(K, extra))
        sm[:, -3:] = -1
        sm[:, -1] = 1 << W
    if K > 2:
        ne[1] = 0
        ev[2, 0] = (2, 0, 0, 0, 0)  # EV_FORCE of slot 0, nothing open
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (ev, vals, sm, st, ne)]


@pytest.mark.parametrize("W,lf", SEGMENT_LAYOUTS,
                         ids=lambda x: str(x))
def test_segment_scan_every_layout_and_shape(cuda, W, lf):
    """Every instantiation at NB = 1, 16 and 256 (runs a warp, warps a
    CTA and CTAs a segment as `segment_shape` gives them): bitwise to the
    plain version, with runs that live, runs that die at the first
    FORCE, padded seeds and a segment without rows."""
    S = 1 << lf
    for NB in (1, 16, 256):
        shape = ss.segment_shape(W, S, NB)
        ev, vals, sm, st, ne = _segment_case(1000 * W + 10 * lf + NB, W, S,
                                             NB, cuda)
        F = ss.segment_scan(ev, vals, sm, st, W, ne)
        torch.cuda.synchronize()
        plain = ss.segment_scan_plain(ev, vals, sm, st, W, ne)
        assert torch.equal(F.cpu(), plain.cpu()), (W, S, NB, shape)
        live = plain.flatten(2).any(dim=2).cpu()
        seeded = (sm >= 0) & (sm < (1 << W))
        # no rows: the seed itself survives
        assert torch.equal(live[1], seeded[1].cpu())
        if NB >= 16:
            assert live.any() and not live.all()
        att = ss.segment_attributes(W, S, 4, NB, 160)
        assert att["seeds_per_warp"] == shape.seeds_per_warp
        assert att["blocks"] == 4 * shape.ctas_per_segment
        assert att["threads"] == 32 * shape.warps
        assert att["local_bytes"] == 0


def test_segment_scan_rows_beyond_one_tile(cuda):
    """Segments longer than one tile of SEGMENT_MAX_TILE_ROWS rows: the
    CTA prepares and walks them tile by tile, the latched rows and open
    slots carried across; at S = 16 a tile takes more than 48 KB of
    shared memory (the kernel opts in). Bitwise to the plain version."""
    for W, S, c in ((5, 4, 2), (8, 2, 3), (6, 16, 1)):
        rng = np.random.default_rng(W)
        E = 2 * ss.SEGMENT_MAX_TILE_ROWS + 300
        arrays = random_segment_inputs(rng, 3, E, W, S, c, bad_read=0.0002,
                                       stray=0.0002)
        ev, vals, sm, st, ne = (torch.from_numpy(a).to(cuda)
                                for a in arrays)
        F = ss.segment_scan(ev, vals, sm, st, W, ne)
        torch.cuda.synchronize()
        plain = ss.segment_scan_plain(ev, vals, sm, st, W, ne)
        assert torch.equal(F.cpu(), plain.cpu()), (W, S)
        assert plain[0].any()


def test_segment_scan_refuses_other_shapes(cuda):
    """The C entry point refuses warps a CTA outside 1..8."""
    from jepsen_jgroups_raft_tpu_torch.ops import _build

    lib = _build.load("segment_scan")
    ev, vals, sm, st, ne = _segment_case(5, 4, 4, 16, cuda)
    out = torch.empty((4, 16, 2), dtype=torch.int32, device=cuda)
    for warps in (0, 9):
        rc = lib.segment_scan_launch(
            *(t.data_ptr() for t in (ev, vals, sm, st, ne, out)), 4, 16,
            160, 4, 4, 2, 0, warps, cuda.index or 0,
            torch.cuda.current_stream().cuda_stream)
        assert rc == -8
        assert "warps" in _build.error_string("segment_scan", rc)


def test_segmented_batch_on_card_matches_cpu(cuda):
    """Register histories through check_segmented_batch on the card and
    on the host: the same plans on both (no CPU cell budget bites at
    this size) and the same verdicts; corrupted reads INVALID."""
    rng = random.Random(31)
    m = CasRegister()
    encs = []
    for i in range(8):
        h = list(random_valid_history(rng, "register", n_ops=300, n_procs=4,
                                      crash_p=0.03, max_crashes=2))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        if i % 2 and reads:
            j = rng.choice(reads)
            h[j] = h[j].replace(value=h[j].value + 10)
        encs.append(encode_history(h, m))
    ss.reset_launch_counts()
    on_card = ss.check_segmented_batch(encs, m, block_events=40,
                                       min_events=0)
    assert ss.launch_counts()["segment_scan"] == 1
    on_host = ss.check_segmented_batch(encs, m, block_events=40,
                                       min_events=0, device="cpu")
    assert on_card == on_host
    assert [r["valid"] for r in on_card] == [i % 2 == 0 for i in range(8)]


def test_race_raises_when_the_kernel_fails(cuda, monkeypatch):
    """A kernel that raises on the card under "race" makes the call
    raise after both threads end: no host verdict stands in for it."""
    from jepsen_jgroups_raft_tpu_torch.checker import linearizable

    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(linearizable, "run_dense_groups", broken)
    monkeypatch.setattr(linearizable, "run_chunked", broken)
    hs = _histories(6, 4, 120, 5, 3, 3, 0.1)
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        check_histories(hs, CasRegister(), algorithm="race")


def test_race_and_wide_auto_on_card_match_cpu(cuda):
    """"race" on the card (the device engine on a thread and a stream of
    its own, against the DFS) gives the host's verdicts, and auto's wide
    rows (W > 12: fast DFS, then the card's ladder) the host's verdicts,
    algorithms and tiers."""
    rng = random.Random(5)
    m = CasRegister()
    hs = _histories(6, 12, 120, 5, 3, 3, 0.1)
    raced = check_histories(hs, m, algorithm="race")
    on_host = check_histories(hs, m, algorithm="race", device="cpu")
    assert [r["valid?"] for r in raced] == [r["valid?"] for r in on_host]
    assert all(r.get("raced") for r in raced)
    wide = []
    while len(wide) < 6:
        h = list(random_valid_history(rng, "counter", n_ops=300, n_procs=10,
                                      crash_p=0.1, max_crashes=4))
        if encode_history(h, Counter()).n_slots > 12:
            wide.append(_corrupt_observation(h, rng) if len(wide) % 2
                        else h)
    keys = ("valid?", "algorithm", "decided-tier")
    ours = check_histories(wide, Counter())
    ref = check_histories(wide, Counter(), device="cpu")
    assert [{k: r.get(k) for k in keys} for r in ours] == \
        [{k: r.get(k) for k in keys} for r in ref]


# ------------------------------------------- the closure kernels (B7, B8)

from jepsen_jgroups_raft_tpu_torch.checker import anomaly, cycle  # noqa: E402
from jepsen_jgroups_raft_tpu_torch.history import synth  # noqa: E402
from jepsen_jgroups_raft_tpu_torch.ops import _build  # noqa: E402
from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc  # noqa: E402

#: every node bucket the cycle tier emits, word-partial ones included
CYCLE_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384,
                 512, 768, 1024, 1536, 2048, 3072, 4096)


#: graph kinds the closure kernels are held to their plain versions on:
#: the first five, then a dense random digraph (p = 0.5), the
#: complete digraph and the empty one
CYCLE_KINDS = ("random", "dag", "chain", "cycle", "padded", "dense",
               "complete", "empty")


def _cycle_graphs(N, seed):
    """Random digraphs, a dense DAG, a long chain, a planted N-cycle,
    zero-padded rows, a dense random digraph, the complete and the empty
    digraph, nodes shuffled: [G, N, N] int32 (no DAG or padded graph
    above 2048 nodes, where the plain version is slow)."""
    kinds = tuple(k for k in CYCLE_KINDS
                  if N <= 2048 or k not in ("dag", "padded"))
    rng = np.random.default_rng(seed)
    out = []
    for kind in kinds:
        n = max(2, N - N // 5) if kind == "padded" else N
        if kind in ("random", "padded"):
            g = (rng.random((n, n)) < 1.5 / n).astype(np.int32)
        elif kind == "dag":
            g = np.triu((rng.random((n, n)) < 0.3).astype(np.int32), 1)
        elif kind == "dense":
            g = (rng.random((n, n)) < 0.5).astype(np.int32)
        elif kind in ("complete", "empty"):
            g = np.full((n, n), int(kind == "complete"), np.int32)
        else:
            g = np.zeros((n, n), np.int32)
            g[np.arange(n - 1), np.arange(1, n)] = 1
            if kind == "cycle":
                g[n - 1, 0] = 1
        np.fill_diagonal(g, 0)
        p = rng.permutation(n)
        full = np.zeros((N, N), np.int32)
        full[:n, :n] = g[np.ix_(p, p)]
        out.append(full)
    return np.stack(out), kinds


def _closure_kernel_and_plain(adj, N, tile=None):
    name = "cycle_closure" if N <= 512 else "cycle_closure_tiled"
    before = cc.launch_counts()[name]
    has, closed = cc.cycle_closure(adj, tile)
    torch.cuda.synchronize()
    assert cc.launch_counts()[name] == before + 1
    assert has.device == adj.device and has.dtype == torch.bool
    p_has, p_closed = cc.closure_plain(adj, tile)
    assert has.cpu().tolist() == p_has.cpu().tolist()
    assert torch.equal(closed, p_closed)
    return has.cpu()


@pytest.mark.parametrize("N", CYCLE_BUCKETS, ids=lambda n: f"N{n}")
def test_cycle_closure_kernel_every_bucket(cuda, N):
    adj, kinds = _cycle_graphs(N, N)
    has = _closure_kernel_and_plain(torch.from_numpy(adj).to(cuda), N)
    assert has[kinds.index("cycle")] and not has[kinds.index("chain")]
    assert not has[kinds.index("empty")]
    assert bool(has[kinds.index("complete")]) == (N > 1)
    flags = [cycle.host_has_cycle(g) for g in adj]
    assert has.tolist() == flags


#: (N, tile) reaching every form `closure_shape` gives: the warp form at
#: 64 … 128 nodes, the panel form at 256 and 512, the tiled form at every
#: kernel tile at 768 and 1024
EVERY_FORM = [(N, None) for N in (64, 96, 128, 256, 512)] + \
    [(N, T) for N in (768, 1024) for T in cc.KERNEL_TILES]


@pytest.mark.parametrize("N,T", EVERY_FORM, ids=str)
def test_cycle_closure_every_form(cuda, N, T):
    """Every form of `closure_shape` against the plain version, bitwise,
    on every kind of graph (more graphs than a block of the warp form
    holds, so blocks fill and a last one is partial)."""
    adj, kinds = _cycle_graphs(N, 5 * N + (T or 0))
    adj = np.concatenate([adj] * 3)[:2 * len(kinds) + 1]
    has = _closure_kernel_and_plain(torch.from_numpy(adj).to(cuda), N, T)
    assert has.tolist() == [cycle.host_has_cycle(g) for g in adj]


@pytest.mark.parametrize("entry,args,code", [
    ("cycle_closure_launch", (70000, 96), -1),       # batch beyond 65535
    ("cycle_closure_launch", (2, 0), -2),            # N beyond 1..512
    ("cycle_closure_launch", (2, 768), -2),
    ("cycle_closure_tiled_launch", (2, 512, 256), -3),   # N ≤ 512
    ("cycle_closure_tiled_launch", (2, 4352, 256), -3),  # N > 4096
    ("cycle_closure_tiled_launch", (2, 768, 512), -4),   # tile beyond 256
    ("cycle_closure_tiled_launch", (2, 1024, 48), -4),   # tile not a kernel's
    ("cycle_closure_tiled_launch", (2, 1536, 1024), -4),
], ids=str)
def test_cycle_closure_refused_shape_raises(cuda, entry, args, code):
    """A launch the entry points refuse returns its code, with its
    message, and launches nothing."""
    lib = _build.load("cycle_closure")
    buf = torch.zeros((4 << 20,), dtype=torch.int32, device=cuda)
    has = torch.zeros((70000,), dtype=torch.bool, device=cuda)
    before = buf.clone()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    ptrs = ((buf.data_ptr(), buf.data_ptr(), has.data_ptr())
            if entry == "cycle_closure_launch"
            else (buf.data_ptr(), has.data_ptr()))
    rc = getattr(lib, entry)(*ptrs, *args, cuda.index or 0, stream)
    torch.cuda.synchronize()
    assert rc == code
    word = {-1: "batch", -2: "monolithic", -3: "blocked", -4: "tile"}[code]
    assert word in _build.error_string("cycle_closure", rc)
    assert torch.equal(buf, before) and not bool(has.any())


@pytest.mark.parametrize("N,T", [(768, 128), (1024, 32), (1024, 64),
                                 (1536, 512), (2048, 16)],
                         ids=lambda x: str(x))
def test_cycle_closure_tiled_kernel_at_other_tiles(cuda, N, T):
    adj, _ = _cycle_graphs(N, N + T)
    _closure_kernel_and_plain(torch.from_numpy(adj).to(cuda), N, T)


def test_cycle_closure_bits_on_card_match_host_packing(cuda):
    """Host-packed bit rows (the tier's path) through the kernels."""
    for N in (48, 768):
        adj, _ = _cycle_graphs(N, 3)
        bits = torch.from_numpy(cc.pack_adjacency(list(adj), N)).to(cuda)
        has, closed = cc.cycle_closure_bits(bits, N)
        p_has, p_closed = cc.closure_plain(torch.from_numpy(adj), None)
        assert has.cpu().tolist() == p_has.tolist()
        assert np.array_equal(cc.unpack_adjacency(closed.cpu().numpy(), N),
                              p_closed.numpy())


def test_cycle_closure_refuses_bad_inputs(cuda):
    bits = torch.zeros((2, 96, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        cc.cycle_closure_bits(bits, 4097)
    with pytest.raises(ValueError):
        cc.cycle_closure_bits(bits, 64)  # shape is [B, 96, 3]
    with pytest.raises(TypeError):
        cc.cycle_closure_bits(bits.to(torch.int64), 96)
    with pytest.raises(ValueError):
        cc.cycle_closure_bits(bits[:, :, :2], 96)


def test_cycle_closure_broken_build_raises(cuda, tmp_path, monkeypatch):
    """A CUDA tensor with a kernel source that does not compile raises:
    no plain version stands in for the kernel."""
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.glob("*.cuh"):
        (src / f.name).write_text(f.read_text())
    (src / "cycle_closure.cu").write_text(
        (_build.CSRC / "cycle_closure.cu").read_text() + "\n#error broken\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_build._LIBS, "cycle_closure", raising=False)
    adj = torch.zeros((1, 8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="build failed"):
        cc.cycle_closure(adj)


def test_find_cycles_on_card_matches_cpu(cuda, monkeypatch):
    """Every arm of the tier on the card gives the host's rows,
    witnesses included; the kernel arm launches B7 and B8."""
    rng = random.Random(3)
    m = CasRegister()
    encs = []
    for n_ops in (40, 60, 900, 1000):
        for i in range(3):
            h = list(random_valid_history(rng, "register", n_ops=n_ops,
                                          n_procs=5, crash_p=0.05,
                                          max_crashes=3))
            if i == 1:
                rows, _ = synth.plant_stale_read(h, rng)
                h = list(build_history(rows))
            encs.append(encode_history(h, m))
    want = cycle.find_cycles(encs, m, device="cpu")
    assert sum(1 for c in want if c and "cycle" in c) >= 4
    for env in ({}, {"JGRAFT_CYCLE_KERNEL": "1"},
                {"JGRAFT_CYCLE_KERNEL": "1", "JGRAFT_CYCLE_CONDENSE": "0"}):
        for k in ("JGRAFT_CYCLE_KERNEL", "JGRAFT_CYCLE_CONDENSE"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        cc.reset_launch_counts()
        assert cycle.find_cycles(encs, m) == want
        if env:
            assert min(cc.launch_counts().values()) >= 1


def test_sequential_rung_on_card_matches_cpu(cuda, monkeypatch):
    monkeypatch.setenv("JGRAFT_GREEDY_CERTIFY", "0")
    monkeypatch.setenv("JGRAFT_CYCLE_KERNEL", "1")
    rng = random.Random(9)
    hs = []
    for i in range(12):
        h = list(random_valid_history(rng, "register", n_ops=100,
                                      n_procs=5, crash_p=0.05,
                                      max_crashes=3, value_range=5))
        if i % 3 == 0:
            rows, _ = synth.plant_stale_read(h, rng)
            h = list(build_history(rows))
        hs.append(h)
    keys = ("valid?", "algorithm", "decided-tier", "cycle", "sc-refuted",
            "consistency")
    for rung in ("sequential", "session"):
        cc.reset_launch_counts()
        ours = check_histories(hs, CasRegister(), consistency=rung)
        assert cc.launch_counts()["cycle_closure"] >= 1
        host = check_histories(hs, CasRegister(), device="cpu",
                               consistency=rung)
        assert [{k: r.get(k) for k in keys} for r in ours] == \
            [{k: r.get(k) for k in keys} for r in host]


def test_anomaly_rung_on_card_matches_host(cuda, monkeypatch):
    rows = synth.listappend_txn_rows(random.Random(23), 900, 12, 5)
    for plants in ((), ("G-single",), ("G-single", "G1c")):
        r = rows
        for j, kind in enumerate(plants):
            r = synth.plant_anomaly(r, kind, f"p{j}", 100 + 10 * j)
        h = build_history(r)
        host = anomaly.certify_history(h, kernel=False)
        for condense in ("1", "0"):
            monkeypatch.setenv("JGRAFT_CYCLE_CONDENSE", condense)
            assert anomaly.certify_history(h) == host


# ------------------------------------------ list-append on the sort kernel


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", [1, 4, 8, 12, 16], ids=lambda w: f"W{w}")
def test_sort_scan_list_append_twin(cuda, W, macro):
    m = MODELS["list-append"]()
    rng = random.Random(70 + W)
    hs = [list(random_valid_history(rng, "list-append", n_ops=30,
                                    n_procs=min(W, 5),
                                    crash_p=0.3 if W > 5 else 0.1,
                                    max_crashes=max(W - 5, 0)))
          for _ in range(6)]
    encs = [encode_history(h, m) for h in hs]
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    _sort_kernel_and_plain(torch.from_numpy(batch["events"]).to(cuda),
                           torch.from_numpy(batch["n_events"]).to(cuda),
                           ls.bucket_slots(max(e.n_slots for e in encs)),
                           64, batch.get("macro_p"), m)


@pytest.mark.parametrize("P", [None, 3, 16], ids=["legacy", "P3", "P16"])
@pytest.mark.parametrize("W", [1, 6, 12, 40, 127], ids=lambda w: f"W{w}")
def test_sort_scan_list_append_twin_on_arbitrary_rows(cuda, W, P):
    """Negative states, states past 32^5 and products past int32: the
    signed bound and the wrapping product of models.cuh."""
    m = MODELS["list-append"]()
    rng = np.random.default_rng(11 * W + (P or 0))
    B, E = 32, 32
    ev = synth.random_mask_rows(rng, B, E, W, P, "list-append")
    n_events = rng.integers(0, E + 1, size=B, dtype=np.int32)
    ev[np.arange(E)[None, :] >= n_events[:, None]] = 0
    _sort_kernel_and_plain(torch.from_numpy(ev).to(cuda),
                           torch.from_numpy(n_events).to(cuda), W,
                           4 if W > 12 else 64, P, m)


# ---------------------------------------- election safety (B9's last)

from jepsen_jgroups_raft_tpu_torch.checker import recorded  # noqa: E402
from jepsen_jgroups_raft_tpu_torch.checker.independent import \
    IndependentLinearizable  # noqa: E402
from jepsen_jgroups_raft_tpu_torch.models import leader  # noqa: E402
from jepsen_jgroups_raft_tpu_torch.ops import \
    election_safety as es  # noqa: E402


def _election_rows(N, seed, B=12):
    """[B, N, 2] rows: safe, a planted conflict early / in the middle /
    last, one leader repeated, padding, negative terms with two
    leaders."""
    rng = np.random.default_rng(seed)
    obs = synth.election_observation_rows(rng, B, N,
                                          n_terms=max(2, min(N // 3, 4096)))
    for b in range(B):
        kind = b % 7
        if kind in (1, 2, 3) and N > 1:
            j = {1: 1, 2: N // 2, 3: N - 1}[kind]
            obs[b, j] = (obs[b, 0, 0], obs[b, 0, 1] + 1)
        elif kind == 4:
            obs[b] = obs[b, 0]
        elif kind == 5:
            obs[b, int(rng.integers(0, N + 1)):] = -1
        elif kind == 6:
            obs[b, : (N + 1) // 2, 0] = -1 - (np.arange((N + 1) // 2) % 2)
    return obs


def _election_kernel_and_plain(obs, valid_len=None):
    before = es.launch_counts()["election_safety"]
    safe = leader.check_election_safety(obs, valid_len)
    torch.cuda.synchronize()
    assert es.launch_counts()["election_safety"] == before + 1
    assert safe.device == obs.device and safe.dtype == torch.bool
    want = leader.check_election_safety_plain(obs, valid_len)
    assert safe.cpu().tolist() == want.cpu().tolist()
    return safe.cpu().tolist()


@pytest.mark.parametrize("N", [1, 2, 31, 32, 33, 1024, 4096, 8192, 8193,
                               65536], ids=lambda n: f"N{n}")
def test_election_safety_kernel_matches_plain(cuda, N):
    """The form `election_form(N)` gives (both sides of its boundary at
    8192), and the global form on the same rows where the shared form
    takes them: bitwise to the plain version, valid_len cuts and rows
    whose terms are all negative included."""
    rows = _election_rows(N, N, B=14)
    rows[13, :, 0] = -1 - (np.arange(N) % 3)  # every term negative
    obs = torch.from_numpy(rows).to(cuda)
    got = _election_kernel_and_plain(obs)
    assert got[13] is True
    if N > 1:
        assert not all(got) and any(got)
    vl = torch.from_numpy(np.random.default_rng(N).integers(
        -1, N + 2, size=obs.shape[0]).astype(np.int32)).to(cuda)
    _election_kernel_and_plain(obs, vl)
    if es.election_form(N) == "shared":
        for v in (None, vl):
            safe, launch = es.election_safety_launcher(obs, v, form="global")
            launch(torch.cuda.current_stream())
            want = leader.check_election_safety_plain(obs, v)
            assert safe.cpu().tolist() == want.cpu().tolist()
    else:
        with pytest.raises(RuntimeError, match="2\\^14"):
            es.election_safety_launcher(obs, form="shared")[1](
                torch.cuda.current_stream())


def test_election_safety_kernel_matches_np_on_runs(cuda):
    m = leader.MajorityLeaderModel()
    rows = []
    for seed in range(6):
        h = synth.election_history(random.Random(seed), n_ops=400)
        obs, _ = m.pooled(h, {})
        rows.append(obs)
    n = max(len(o) for o in rows)
    batch = np.full((len(rows), n, 2), -1, np.int32)
    for i, o in enumerate(rows):
        batch[i, :len(o)] = o
    got = _election_kernel_and_plain(torch.from_numpy(batch).to(cuda))
    assert got == [leader.check_election_safety_np(o)[0] for o in rows]


def test_election_safety_refuses_bad_inputs(cuda):
    obs = torch.zeros((2, 8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        es.election_safety(obs.to(torch.int64))
    with pytest.raises(ValueError):
        es.election_safety(torch.zeros((2, 8, 3), dtype=torch.int32,
                                       device=cuda))
    with pytest.raises(ValueError):
        es.election_safety(torch.zeros(33, dtype=torch.int32,
                                       device=cuda)[1:].view(2, 8, 2))
    with pytest.raises(ValueError):
        es.election_safety(obs, torch.zeros(3, dtype=torch.int32,
                                            device=cuda))
    assert es.election_safety(obs[:, :0].contiguous()).tolist() == \
        [True, True]


def test_election_safety_broken_build_raises(cuda, tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.glob("*.cuh"):
        (src / f.name).write_text(f.read_text())
    (src / "election_safety.cu").write_text(
        (_build.CSRC / "election_safety.cu").read_text() +
        "\n#error broken\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_build._LIBS, "election_safety", raising=False)
    obs = torch.zeros((1, 8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="build failed"):
        leader.check_election_safety(obs)


def test_check_recorded_on_card_matches_cpu(cuda, tmp_path):
    runs = [synth.keyed_register_run(tmp_path, 20260729 + 23, n_keys=64,
                                     n_wide=2),
            synth.counter_run(tmp_path, 3, n_ops=300),
            synth.election_run(tmp_path, 4, n_ops=300)]
    ours = recorded.check_recorded(runs, device=cuda)
    want = recorded.check_recorded(runs, device="cpu")
    strip = ("time-s", "histories-per-sec")
    assert {k: v for k, v in ours.items() if k not in strip} == \
        {k: v for k, v in want.items() if k not in strip}
    assert ours["valid?"] is True


def test_independent_linearizable_on_card_matches_cpu(cuda):
    h = synth.keyed_register_history(random.Random(5), n_keys=40, n_wide=2)
    ops = list(h)
    j = max(i for i, op in enumerate(ops) if op.type == "ok"
            and op.f == "read" and op.value[0] == 7)
    k, v = ops[j].value
    ops[j] = ops[j].replace(value=(k, 17 if v is None else v + 11))
    ours = IndependentLinearizable(CasRegister, device=cuda).check({}, ops)
    want = IndependentLinearizable(CasRegister, device="cpu").check({}, ops)
    assert ours["valid?"] is False
    assert ours["key-count"] == want["key-count"] == 40
    for k, r in want["results"].items():
        assert {x: v for x, v in ours["results"][k].items()
                if x != "time-s"} == \
            {x: v for x, v in r.items() if x != "time-s"}, k


# ------------------------------------------- the chunk forms (B1, B4, B5)


def _chunks_kernel_and_plain(step, carry, ev, lay, chunk, counts, name):
    """Chain `step` (a chunk pair's step_fn) on the card and on the CPU
    from the same carry over ev [B, E, R] in chunks of `chunk` rows: after
    every launch the four flags are equal and the carries agree
    (`carry_mismatch` 0); halfway, both recompact to the rows i with i
    mod 4 < 2 (carry and events gathered; the fixtures corrupt the odd
    rows, so both polarities stay). Each launch adds one to
    counts[name]. Returns the plain version's last (ok, overflow)."""
    ck, cp = carry.to(ev.device), carry.cpu()
    evk, evp = ev, ev.cpu()
    E = int(ev.shape[1])
    n_launch = -(-E // chunk)
    out = None
    for i in range(n_launch):
        if i == n_launch // 2 and ck.shape[0] > 1:
            idx = torch.tensor([r for r in range(int(ck.shape[0]))
                                if r % 4 < 2])
            ck, evk = (t.index_select(0, idx.to(ev.device)) for t in (ck, evk))
            cp, evp = (t.index_select(0, idx) for t in (cp, evp))
        lo = i * chunk
        before = counts[name]
        ok_k = step(ck, evk[:, lo:lo + chunk], chunk)
        torch.cuda.synchronize()
        assert counts[name] == before + 1
        out = step(cp, evp[:, lo:lo + chunk], chunk)
        for a, b in zip(ok_k[1:], out[1:]):
            assert a.device.type == "cuda" and a.dtype == torch.bool
            assert a.cpu().tolist() == b.tolist(), (chunk, i)
        assert carry_mismatch(lay, ok_k[0].cpu(), out[0]) == 0, (chunk, i)
        ck, cp = ok_k[0], out[0]
    return out[3], out[4]


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W,S", WINDOWS,
                         ids=[f"W{w}_S{s}" for w, s in WINDOWS])
def test_dense_chunk_kernel_matches_plain(cuda, W, S, macro):
    """B1's chunk form against dense_chunk_plain at chunks 1, 32 and
    128: flags and carry after every launch, a recompaction halfway."""
    ev, vo, ne, P, _ = _group(_cap_histories(300 + W, W, S, 12, 60), W, S,
                              macro, cuda)
    init, step = ds.make_dense_chunk_checker(CasRegister(), "domain", W, S,
                                             macro_p=P)
    lay = ds.dense_carry_layout(W, S)
    oks = set()
    for chunk in (1, 32, 128):
        ok, _ = _chunks_kernel_and_plain(step, init(vo, ne), ev, lay, chunk,
                                         ds.CHUNK_LAUNCHES, "dense_scan_chunk")
        oks.update(ok.tolist())
    assert oks == {True, False} or S == 1


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", [1, 3, 5, 8, 10, 12], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind", list(MASK_MODELS))
def test_mask_chunk_kernel_matches_plain(cuda, kind, W, macro):
    """B4's chunk form against mask_chunk_plain at chunks 1, 32 and 128
    (the carry's sums kept as column totals on both sides)."""
    m = MASK_MODELS[kind]()
    _, encs = _mask_histories(kind, W, 8, 60, 500 + W)
    ev, ne, P = _mask_group(encs, macro, cuda)
    init, step = ds.make_dense_chunk_checker(m, "mask", W, 1, macro_p=P)
    lay = ds.mask_carry_layout(W)
    for chunk in (1, 32, 128):
        _chunks_kernel_and_plain(step, init(None, ne), ev, lay, chunk,
                                 ds.CHUNK_LAUNCHES, "mask_scan_chunk")


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("W", [1, 8, 31, 127], ids=lambda w: f"W{w}")
@pytest.mark.parametrize("kind", list(SORT_KINDS) + ["list-append"])
def test_sort_chunk_kernel_matches_plain(cuda, kind, W, macro):
    """B5's chunk form against sort_chunk_plain at chunks 1, 32 and 128,
    C = 64 (and C = 4 at W = 8, where rows overflow): flags and the
    canonical frontier after every launch."""
    m = MODELS[SORT_KINDS.get(kind, kind)]()
    hs = _sort_histories(kind, W, 6, 700 + W) if kind != "list-append" \
        else [list(burst_history(random.Random(W + j), "list-append",
                                 max(W - 3 * j, 1))) for j in range(6)]
    encs = [encode_history(h, m) for h in hs]
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    ev = torch.from_numpy(batch["events"]).to(cuda)
    ne = torch.from_numpy(batch["n_events"]).to(cuda)
    for C in ((64, 4) if W == 8 else (64,)):
        init, step = ls.make_sort_chunk_checker(m, C, W,
                                                macro_p=batch.get("macro_p"))
        lay = ls.sort_carry_layout(W, C)
        for chunk in (1, 32, 128):
            _chunks_kernel_and_plain(step, init(ne), ev, lay, chunk,
                                     ls.CHUNK_LAUNCHES, "sort_scan_chunk")


def test_chunk_kernels_refuse_bad_inputs(cuda):
    """A carry of the wrong length or device, or rows that are not
    contiguous, raise before any launch."""
    ev, vo, ne, P, _ = _group(_cap_histories(5, 4, 4, 4, 20), 4, 4, False,
                              cuda)
    init, step = ds.make_dense_chunk_checker(CasRegister(), "domain", 4, 4)
    carry = init(vo, ne)
    with pytest.raises(ValueError):
        step(carry[:, :-1].contiguous(), ev)
    with pytest.raises(ValueError):
        step(carry.cpu(), ev)
    with pytest.raises(ValueError):
        step(carry, ev[:, :, :4])
    with pytest.raises(ValueError):
        step(carry, ev, int(ev.shape[1]) - 1)


def test_set_element_31_clamp_on_card(cuda):
    """The reference's element-31 clamp (ROADMAP Queue C) on the sort
    kernel: a read of {31} that misses a completed add of 5 is VALID in
    the one-shot and the chunk form, as on the plain version and the
    reference (tests/test_torch_set.py)."""
    m = GSet()
    rows = [(0, "invoke", "add", 5), (0, "ok", "add", 5),
            (1, "invoke", "add", 31), (1, "ok", "add", 31),
            (2, "invoke", "read", None), (2, "ok", "read", [31])]
    enc = encode_history(build_history(rows), m)
    W = ls.bucket_slots(enc.n_slots)
    for pack in (pack_batch, pack_macro_batch):
        b = pack([enc])
        ev = torch.from_numpy(b["events"]).to(cuda)
        ne = torch.from_numpy(b["n_events"]).to(cuda)
        ok, of = ls.sort_scan(ev, W, 64, b.get("macro_p"), ne, model=m)
        assert ok.cpu().tolist() == [True] and of.cpu().tolist() == [False]
        init, step = ls.make_sort_chunk_checker(m, 64, W, b.get("macro_p"))
        carry = init(ne)
        for lo in range(int(ev.shape[1])):
            carry, _, _, ok, of = step(carry, ev[:, lo:lo + 1])
        assert ok.cpu().tolist() == [True] and of.cpu().tolist() == [False]


@pytest.mark.parametrize("kind", ["register", "counter", "set"])
def test_chunked_check_on_card_matches_cpu(cuda, kind, monkeypatch):
    """check_histories at the default chunk on the card: the CPU's result
    dicts ("chunked" included, less "time-s") and wavefront counters,
    the chunk kernels launched; at JGRAFT_SCAN_CHUNK=0 the one-shot
    kernels, the same verdicts and no "chunked" stamp."""
    monkeypatch.delenv("JGRAFT_SCAN_CHUNK", raising=False)
    model = MODELS[SORT_KINDS[kind]]()
    rng = random.Random(61)
    vr = {"value_range": 32} if kind == "set" else {}
    hs = [_corrupt_observation(list(random_valid_history(
        rng, kind, n_ops=120, n_procs=5, crash_p=0.05, max_crashes=3,
        **vr)), rng, 1) if i % 3 == 1 else random_valid_history(
        rng, kind, n_ops=120, n_procs=5, crash_p=0.05, max_crashes=3, **vr)
        for i in range(24)]
    keys = ("chunks_run", "evicted_rows", "groups_run",
            "groups_early_exited")

    def run(dev):
        schedule.consume_stats()
        rs = check_histories(hs, model, device=dev)
        st = schedule.consume_stats()
        return ([{k: v for k, v in r.items() if k != "time-s"} for r in rs],
                [st[k] for k in keys])

    ds.reset_launch_counts()
    ls.reset_launch_counts()
    on_card, host = run(None), run("cpu")
    assert on_card == host
    chunk_launches = sum(ds.chunk_launch_counts().values()) + \
        ls.chunk_launch_counts()["sort_scan_chunk"]
    assert chunk_launches > 0 and on_card[1][2] > 0
    monkeypatch.setenv("JGRAFT_SCAN_CHUNK", "0")
    one_shot = run(None)
    assert [r["valid?"] for r in one_shot[0]] == \
        [r["valid?"] for r in on_card[0]]
    assert not any("chunked" in r for r in one_shot[0])
    assert one_shot[1][2] == 0


# ------------------------------------------------ B10: the batch mesh

#: 16384 and 16385: both sides of the standalone's one-block limit
VERDICT_SIZES = (0, 1, 31, 32, 33, 1000, 16384, 16385, 1 << 20)


def _verdict_flags(cuda, B, offsets=(0, 0, 0), seed=0):
    gen = torch.Generator().manual_seed(seed * 131 + B)
    u = torch.rand((3, B + 16), generator=gen)
    flags = (u < torch.tensor([[0.7], [0.3], [0.8]])).to(cuda)
    return [flags[r, o:o + B] for r, o in enumerate(offsets)]


@pytest.mark.parametrize("mode", ["dense", "sort"])
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (3, 5, 7),
                                     (16, 0, 9), (15, 15, 15)],
                         ids=lambda o: "off" + "-".join(map(str, o)))
@pytest.mark.parametrize("B", VERDICT_SIZES, ids=lambda b: f"B{b}")
def test_verdict_counts_matches_plain(cuda, B, offsets, mode):
    """The standalone entry at each size and offset, bitwise: one block
    up to 16384 rows, a grid above; through the launcher too, on a
    poisoned output (the one block stores, the grid zeroes first)."""
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    ok, ovf, real = _verdict_flags(cuda, B, offsets)
    before = vc.launch_counts()["verdict_counts"]
    got = vc.verdict_counts(ok, ovf, real, mode)
    want = vc.verdict_counts_plain(ok, ovf, real, mode)
    torch.cuda.synchronize()
    assert got.device == ok.device and got.dtype == torch.int64
    assert got.tolist() == want.tolist()
    assert vc.launch_counts()["verdict_counts"] == before + 1
    out, launch = vc.verdict_counts_launcher(ok, ovf, real, mode)
    out.fill_(-1)  # neither form may rely on zeroed memory
    launch(torch.cuda.current_stream())
    torch.cuda.synchronize()
    assert out.tolist() == want.tolist()


def test_verdict_counts_stream_handle_is_the_current_stream(cuda):
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    index = torch.cuda.current_device()
    side = torch.cuda.Stream()
    assert vc._stream_handle(index) == \
        torch.cuda.current_stream().cuda_stream
    with torch.cuda.stream(side):
        assert vc._stream_handle(index) == side.cuda_stream


def test_verdict_counts_refuses_bad_inputs(cuda):
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    ok, ovf, real = _verdict_flags(cuda, 64)
    with pytest.raises(ValueError, match="ok on"):
        vc.verdict_counts(ok, ovf.cpu(), real)
    with pytest.raises(ValueError, match="contiguous"):
        vc.verdict_counts(ok[::2], ovf[::2], real[::2])
    with pytest.raises(TypeError, match="bool"):
        vc.verdict_counts(ok.to(torch.uint8), ovf, real)
    with pytest.raises(ValueError, match="mode"):
        vc.verdict_counts(ok, ovf, real, "psum")


def test_verdict_counts_broken_build_raises(cuda, tmp_path, monkeypatch):
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    src = tmp_path / "csrc"
    src.mkdir()
    for f in _build.CSRC.glob("*.cuh"):
        (src / f.name).write_text(f.read_text())
    (src / "verdict_counts.cu").write_text(
        (_build.CSRC / "verdict_counts.cu").read_text() + "\n#error broken\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_build._LIBS, "verdict_counts", raising=False)
    with pytest.raises(RuntimeError, match="build failed"):
        vc.verdict_counts(*_verdict_flags(cuda, 8))


def _mesh_batch(kind, n=40, n_ops=120):
    rng = random.Random(77)
    model = {"register": CasRegister(), "counter": Counter()}[kind]
    hs = []
    for i in range(n):
        h = list(random_valid_history(rng, kind, n_ops=n_ops, n_procs=5,
                                      crash_p=0.05, max_crashes=3))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        if i % 3 == 0 and reads:
            j = rng.choice(reads)
            h[j] = h[j].replace(value=h[j].value + 10**6)
        hs.append(h)
    return model, [encode_history(h, model) for h in hs]


@pytest.mark.parametrize("kind", ["register", "counter"])
@pytest.mark.parametrize("arm", ["dense", "dense-defer", "ladder",
                                 "pinned", "macro-ladder"])
def test_check_batch_sharded_on_card_matches_cpu(cuda, kind, arm):
    """Every arm of `parallel.mesh.check_batch_sharded` gives on the card
    the flags and counts it gives on the CPU (the plain versions), and no
    arm launches `verdict_counts`: the dense arms count in their scan
    kernel's epilogue (one launch of it), the ladder on the host."""
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_plan
    from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import bucket_slots
    from jepsen_jgroups_raft_tpu_torch.parallel.mesh import \
        check_batch_sharded

    model, encs = _mesh_batch(kind)
    macro = arm.startswith("dense") or arm == "macro-ladder"
    batch = (pack_macro_batch if macro else pack_batch)(encs)
    kw = {"macro_p": batch.get("macro_p")}
    if arm.startswith("dense"):
        kw.update(dense=dense_plan(model, encs), defer=arm == "dense-defer")
    else:
        kw["n_slots"] = bucket_slots(max(e.n_slots for e in encs))
        if arm == "pinned":
            kw["n_configs"] = 64
    def launches():
        return (vc.launch_counts()["verdict_counts"],
                sum(ds.launch_counts().values()),
                sum(ds.count_launch_counts().values()))

    before = launches()

    def run(device):
        out = check_batch_sharded(model, batch["events"], device=device,
                                  **kw)
        return out() if kw.get("defer") else out

    on_card, on_cpu = run(cuda), run("cpu")
    assert launches() == (before[0], before[1], before[2] +
                          (1 if arm.startswith("dense") else 0))
    for a, b in zip(on_card, on_cpu):
        assert np.array_equal(a, b)
    assert 0 < on_card[2] < len(encs)


@pytest.mark.parametrize("kind", ["register", "counter"])
def test_launch_dense_groups_counts_on_card(cuda, kind):
    """`checker.schedule.launch_dense_groups` with counts: two pending
    groups on the card, finalized in reverse order, give the CPU's
    verdicts and counts, from one counting scan launch a group and no
    `verdict_counts` launch."""
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        DenseLaunch, launch_dense_groups)
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_plan

    model, encs = _mesh_batch(kind)
    plan = dense_plan(model, encs)
    batch = pack_macro_batch(encs)
    halves = (slice(0, 17), slice(17, len(encs)))

    def pending(device):
        return [launch_dense_groups([DenseLaunch(
            events=torch.from_numpy(batch["events"][h]).to(device),
            val_of=torch.from_numpy(plan.val_of[h]).to(device),
            n_events=None, n_slots=plan.n_slots, macro_p=batch["macro_p"],
            kind=plan.kind)], model, counts=True) for h in halves]

    def launches():
        return (vc.launch_counts()["verdict_counts"],
                sum(ds.launch_counts().values()),
                sum(ds.count_launch_counts().values()))

    before = launches()
    on_card = [f() for f in reversed(pending(cuda))]
    assert launches() == (before[0], before[1], before[2] + 2)
    on_cpu = [f() for f in reversed(pending("cpu"))]
    for a, b in zip(on_card, on_cpu):
        assert np.array_equal(a.ok[0], b.ok[0])
        assert a.counts[0].tolist() == b.counts[0].tolist() == \
            [int(b.ok[0].sum()), 0]


# ------------------------------------- B10 fused: the scans' counting option

#: batch sizes of the fused counts: one row, a warp's worth around a
#: block's edges, the north star's batch
FUSED_SIZES = (1, 31, 32, 33, 1000)
#: B1's (W, S) of the fused tests: the north star's register groups
#: (W 5..8, S 4: field width 2), the set's dense domains (S up to 16:
#: field width 4) at every window they reach, and the other field widths
FUSED_DENSE = ([(w, 4) for w in (5, 6, 7, 8)] +
               [(w, 16) for w in range(1, 10)] + [(1, 1), (4, 2), (10, 8)])
#: B4's (kind, W): the counter and the queue, and the counter at
#: upstream's 10 processes (W 10..12)
FUSED_MASK = [("counter", 1), ("counter", 5), ("queue", 5), ("queue", 12),
              ("counter", 10), ("counter", 11), ("counter", 12)]
#: B5's windows: K = W // 32 + 1 = 1..4 mask words
FUSED_SORT = (8, 40, 70, 127)


def _tiled(rows, dev):
    """A batch of max(FUSED_SIZES) rows: `rows` repeated (cheaper to make
    than as many distinct random rows), on the card."""
    B = max(FUSED_SIZES)
    return torch.from_numpy(np.resize(rows, (B,) + rows.shape[1:])).to(dev)


def _fused_real(cuda, B):
    gen = torch.Generator().manual_seed(B)
    return (torch.rand(B, generator=gen) < 0.7).to(cuda)


def _assert_fused(counts, flags, mode, real):
    """counts equal verdict_counts_plain of the launch's own flags,
    bitwise (real None: every row)."""
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    ok = flags[0]
    ovf = flags[1] if len(flags) > 1 else torch.zeros_like(ok)
    want = vc.verdict_counts_plain(
        ok, ovf, torch.ones_like(ok) if real is None else real, mode)
    assert counts.dtype == torch.int64 and counts.device == ok.device
    assert counts.tolist() == want.tolist()


@pytest.mark.parametrize("W,S", FUSED_DENSE,
                         ids=[f"W{w}_S{s}" for w, s in FUSED_DENSE])
def test_dense_fused_counts_match_plain(cuda, W, S):
    """B1's counting instance at each size, with and without `real`: its
    verdicts equal the non-counting launch's and its counts the plain
    counts of those verdicts, bitwise."""
    rng = np.random.default_rng(40 * W + S)
    vals = np.resize(np.array([-2**31, 0, 1, 2, 3, 4, 5, 6], np.int32), S)
    B, E = max(FUSED_SIZES), 32
    ev = _tiled(_random_rows(rng, 128, E, W, 3, vals), cuda)
    vo = torch.from_numpy(np.tile(vals, (B, 1))).to(cuda)
    for b in FUSED_SIZES:
        want = ds.dense_scan(ev[:b], vo[:b], W, macro_p=3)
        for real in (None, _fused_real(cuda, b)):
            before = (ds.launch_counts()["dense_scan"],
                      ds.count_launch_counts()["dense_scan_count"])
            ok, counts = ds.dense_scan(ev[:b], vo[:b], W, macro_p=3,
                                       counts=True, real=real)
            torch.cuda.synchronize()
            assert (ds.launch_counts()["dense_scan"],
                    ds.count_launch_counts()["dense_scan_count"]) == \
                (before[0], before[1] + 1)
            assert torch.equal(ok, want)
            _assert_fused(counts, [ok], "dense", real)


@pytest.mark.parametrize("kind,W", FUSED_MASK,
                         ids=[f"{k}_W{w}" for k, w in FUSED_MASK])
def test_mask_fused_counts_match_plain(cuda, kind, W):
    m = Counter() if kind == "counter" else TicketQueue()
    rng = np.random.default_rng(60 * W + len(kind))
    ev = _tiled(random_mask_rows(rng, 128, 32, W, 3, kind), cuda)
    for b in FUSED_SIZES:
        want = ds.mask_scan(ev[:b], W, 3, model=m)
        for real in (None, _fused_real(cuda, b)):
            ok, counts = ds.mask_scan(ev[:b], W, 3, model=m, counts=True,
                                      real=real)
            torch.cuda.synchronize()
            assert torch.equal(ok, want)
            _assert_fused(counts, [ok], "dense", real)


@pytest.mark.parametrize("W", FUSED_SORT, ids=lambda w: f"W{w}")
def test_sort_fused_counts_match_plain(cuda, W):
    """B5's counting instance (K = 1..4) in sort mode: n_valid counts ok
    rows that did not overflow."""
    m = MODELS[SORT_KINDS["register"]]()
    rng = np.random.default_rng(80 + W)
    C = 4
    ev = _tiled(random_mask_rows(rng, 128, 24, W, 3, "register"), cuda)
    for b in FUSED_SIZES:
        want = ls.sort_scan(ev[:b], W, C, 3, model=m)
        for real in (None, _fused_real(cuda, b)):
            ok, of, counts = ls.sort_scan(ev[:b], W, C, 3, model=m,
                                          counts=True, real=real)
            torch.cuda.synchronize()
            assert torch.equal(ok, want[0]) and torch.equal(of, want[1])
            _assert_fused(counts, [ok, of], "sort", real)
    assert bool((want[1] & want[0]).any() or (want[1] & ~want[0]).any())


def test_fused_counts_of_groups_on_side_streams(cuda):
    """`launch_dense_groups(counts=True)` with six groups on six side
    streams, domain and mask: each group's counts are its own verdicts'
    (a counter or ticket shared between launches would mix them)."""
    specs = [(2, 16, 30, 50), (6, 16, 24, 120), (10, 8, 24, 150),
             (1, 1, 12, 30), (5, 4, 40, 100), (8, 4, 40, 100)]
    launches = []
    for k, (W, S, n, n_ops) in enumerate(specs):
        ev, vo, ne, P, _ = _group(_cap_histories(500 + k, W, S, n, n_ops),
                                  W, S, True, cuda)
        launches.append(DenseLaunch(events=ev, val_of=vo, n_events=ne,
                                    n_slots=W, macro_p=P))
    _, encs = _mask_histories("counter", 7, 33, 80, 41)
    ev, ne, P = _mask_group(encs, True, cuda)
    launches.append(DenseLaunch(events=ev, val_of=None, n_events=ne,
                                n_slots=7, macro_p=P, kind="mask",
                                model=Counter()))
    run = schedule.launch_dense_groups(launches, CasRegister(),
                                       counts=True)()
    assert len(run.counts) == len(launches)
    for ok, c in zip(run.ok, run.counts):
        assert c.tolist() == [int(ok.sum()), 0]
    assert len({c[0] for c in run.counts}) > 1


@pytest.mark.parametrize("lib,stem,regs,instances", [
    ("dense_scan", "dense_scan_warp", 246, 49),
    ("mask_scan", "mask_scan_warp", 168, 36),
    ("sort_scan", "sort_scan_block", 64, 4)], ids=["B1", "B4", "B5"])
def test_fused_counts_keep_the_scans_registers(cuda, lib, stem, regs,
                                               instances):
    """The non-counting instances keep the registers they had before the
    counts existed (B1 246, B4 168 at most, B5 at most 64); every
    instance, counting or not, has no spill and no stack."""
    for x in (lib, f"{lib}_count"):
        if x in _build.SIGNATURES:
            _build.load(x)
    assert _build.SCAN_TEMPLATES[lib] == stem
    plain, counting = _build.ptxas_by_count(lib)
    assert len(plain) == len(counting) == instances
    most = max(r["registers"] for r in plain.values())
    assert most == regs if lib != "sort_scan" else most <= regs
    for name, r in {**plain, **counting}.items():
        assert r["spill_bytes"] == 0 and r["stack_bytes"] == 0, name


# ------------------------------------------------ the streaming carry


@pytest.mark.parametrize("kind", ["register", "set", "list-append"])
def test_carried_scan_on_card_matches_plain(cuda, kind):
    """`CarriedScan` on the card (B5's chunk entry point, one row a
    launch) against the same feeds on the plain version: flags and
    launches equal after every feed, the carry bitwise equal wherever it
    is defined (`carry_mismatch`: all of it while the row is ok); a corrupted
    register stream decides at the same feed on both and launches
    nothing after it."""
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import CarriedScan

    rng = random.Random(len(kind))
    model = MODELS[{"register": "cas-register"}.get(kind, kind)]()
    kw = {"value_range": 32} if kind == "set" else {}
    for trial in range(3):
        h = list(random_valid_history(rng, kind, n_ops=200, n_procs=5,
                                      crash_p=0.05, max_crashes=2, **kw))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        if kind == "register" and trial == 2 and reads:
            j = reads[len(reads) // 2]
            h[j] = h[j].replace(value=h[j].value + 1000)
        enc = encode_history(h, model, prune=False)
        card = CarriedScan(model, enc.n_slots, n_configs=64, device=cuda)
        plain = CarriedScan(model, enc.n_slots, n_configs=64, device="cpu")
        lo = 0
        while lo < enc.n_events:
            hi = min(enc.n_events, lo + rng.randrange(1, 120))
            ls.reset_launch_counts()
            before = card.launches
            card.feed(enc.events[lo:hi])
            plain.feed(enc.events[lo:hi])
            # the card's launches went through the kernel's wrapper
            assert ls.chunk_launch_counts()["sort_scan_chunk"] == \
                card.launches - before
            assert (card.ok, card.overflow, card.launches) == \
                (plain.ok, plain.overflow, plain.launches)
            # every field where both are defined: a decided row's slot
            # state is not (the kernel stops at its first dead FORCE)
            assert carry_mismatch(ls.sort_carry_layout(card.slots_cap, 64),
                                  card.carry.cpu(), plain.carry) == 0
            lo = hi
        if kind == "register" and trial == 2:
            assert card.decided and not card.ok


def _list_append_with_bad_reads():
    """48 list-append histories (the sort ladder's rows), a quarter with
    one ok read made to observe a list it never held."""
    rng = random.Random(61)
    hs = []
    for i in range(48):
        h = list(random_valid_history(rng, "list-append", n_ops=120,
                                      n_procs=5, crash_p=0.05,
                                      max_crashes=2))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read"]
        if i % 4 == 0 and reads:
            j = rng.choice(reads)
            v = list(h[j].value)
            h[j] = h[j].replace(value=v[:-1] if v else [1])
        hs.append(h)
    return hs


@pytest.mark.parametrize("family", ["dense", "sort"])
def test_tuned_check_histories_on_card_matches_untuned(cuda, tmp_path,
                                                       monkeypatch, family):
    """`check_histories` on the card with plans measured into a fresh
    store (the gates lowered so that every window group or ladder rung
    measures), then loaded in a fresh process, gives the untuned check's
    result dicts row for row: register groups (the dense family), and
    list-append rows with bad reads (the sort ladder, every row on its
    tier, the plans applied the sort family's)."""
    from jepsen_jgroups_raft_tpu_torch.checker import autotune

    if family == "dense":
        hs = []
        for cfg in ("W5_S4", "W8_S4"):
            hs += CONFIGS[cfg][0]()
        model = CasRegister()
    else:
        hs, model = _list_append_with_bad_reads(), MODELS["list-append"]()

    def strip(rs):
        return [{k: v for k, v in r.items() if k != "time-s"} for r in rs]

    monkeypatch.setenv("JGRAFT_AUTOTUNE", "0")
    base = strip(check_histories(hs, model, device=cuda))
    if family == "sort":
        assert {r["valid?"] for r in base} == {True, False}
        assert {r.get("decided-tier") for r in base} == {"sort"}
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "1")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_STORE", str(tmp_path))
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_ROWS", "8")
    monkeypatch.setenv("JGRAFT_AUTOTUNE_MIN_CELLS", "64")
    autotune.reset_for_tests()
    try:
        assert strip(check_histories(hs, model, device=cuda)) == base
        assert autotune.snapshot_counters()["plans_measured"] >= 1
        autotune.reset_for_tests()
        assert strip(check_histories(hs, model, device=cuda)) == base
        c = autotune.snapshot_counters()
        assert c["plans_loaded"] >= 1 and c["plans_measured"] == 0
        if family == "sort":
            assert {e["signature"][0] for e in autotune.applied_log()} \
                == {"sort"}
    finally:
        autotune.reset_for_tests()


@pytest.mark.parametrize("workers", [1, 2])
def test_service_on_card_checks_register_and_counter(cuda, tmp_path,
                                                     workers):
    """A small checking service on the card (`service.CheckingService`,
    one worker or two shard executors on this one device): a register
    batch and a counter batch, half their rows corrupted, coalesced from
    several requests. The dense and mask kernels' launch counts move,
    no batch is degraded, and every verdict and decided tier equals
    `check_histories` on the card."""
    from jepsen_jgroups_raft_tpu_torch.history.ops import History
    from jepsen_jgroups_raft_tpu_torch.service import CheckingService

    reg = _histories(11, 16, 60, 3, 1, 3, 0.1)
    rng = random.Random(12)
    cnt = []
    for i in range(16):
        h = list(random_valid_history(rng, "counter", n_ops=60, n_procs=3))
        reads = [j for j, op in enumerate(h) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        if i % 2 and reads:
            j = rng.choice(reads)
            h[j] = h[j].replace(value=h[j].value + 10**6)
        cnt.append(h)
    want = {"register": check_histories(reg, CasRegister(), device=cuda),
            "counter": check_histories(cnt, Counter(), device=cuda)}
    svc = CheckingService(journal_dir=str(tmp_path / "journal"),
                          device=cuda, n_workers=workers, autostart=False)
    reqs = [(w, svc.submit([History(h) for h in hs[i:i + 4]],
                           workload=w))
            for w, hs in (("register", reg), ("counter", cnt))
            for i in range(0, len(hs), 4)]
    ds.reset_launch_counts()
    ls.reset_launch_counts()
    svc.start()
    try:
        for _, r in reqs:
            assert r.wait(300), r.status
        st = svc.stats()
    finally:
        svc.shutdown()
    launches = {**ds.launch_counts(), **ds.chunk_launch_counts()}
    assert launches["dense_scan"] + launches["dense_scan_chunk"] > 0
    assert launches["mask_scan"] + launches["mask_scan_chunk"] > 0
    assert st["degraded_batches"] == 0
    assert max(r.stats["batched_requests"] for _, r in reqs) >= 2
    for w in ("register", "counter"):
        got = [x for kind, r in reqs if kind == w for x in r.results]
        assert [(x["valid?"], x["decided-tier"]) for x in got] == \
            [(x["valid?"], x["decided-tier"]) for x in want[w]]
        assert not any("platform-degraded" in x for x in got)
    assert False in [x["valid?"] for x in want["register"]]


def test_service_watchdog_zombie_and_replacement_on_their_own_streams(
        cuda):
    """The watchdog gives up on a batch wedged before its launch and
    spawns a replacement worker; the next batch then runs on the
    replacement's CUDA stream while the released zombie launches its own
    batch on the old worker's stream. Both answers equal
    `check_histories` on the card: neither thread's kernels corrupt the
    other's."""
    import threading
    import time

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
        check_encoded
    from jepsen_jgroups_raft_tpu_torch.history.ops import History
    from jepsen_jgroups_raft_tpu_torch.service import CheckingService

    hs = _histories(21, 32, 120, 5, 3, 7, 0.2)
    first, second = hs[:16], hs[16:]
    want = check_histories(hs, CasRegister(), device=cuda)
    release = threading.Event()
    zombie = {}

    def hanging(encs, model, algorithm="auto", **kw):
        if not zombie:
            zombie["stream"] = torch.cuda.current_stream(cuda)
            release.wait(60)   # wedged before its launch
            zombie["results"] = check_encoded(
                encs, model, algorithm=algorithm, device=cuda,
                distribute=False, **kw)
            return zombie["results"]
        zombie.setdefault("replacement", torch.cuda.current_stream(cuda))
        return check_encoded(encs, model, algorithm=algorithm, device=cuda,
                             distribute=False, **kw)

    svc = CheckingService(device=cuda, batch_wait=0.0, check_fn=hanging,
                          watchdog_margin_s=0.25)
    try:
        a = svc.submit([History(h) for h in first], workload="register",
                       deadline_ms=100)
        assert a.wait(120) and a.status == "done"
        b = svc.submit([History(h) for h in second], workload="register")
        release.set()
        assert b.wait(120) and b.status == "done"
        deadline = time.monotonic() + 120
        while "results" not in zombie:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        release.set()
        svc.shutdown()
    assert zombie["stream"] != zombie["replacement"]
    assert [x["valid?"] for x in a.results] == \
        [x["valid?"] for x in want[:16]]
    assert all("watchdog" in x["platform-degraded"] for x in a.results)
    assert [(x["valid?"], x["decided-tier"]) for x in b.results] == \
        [(x["valid?"], x["decided-tier"]) for x in want[16:]]
    assert [(x["valid?"], x["decided-tier"]) for x in zombie["results"]] \
        == [(x["valid?"], x["decided-tier"]) for x in want[:16]]


def _scan_launches() -> int:
    return sum({**ds.launch_counts(), **ds.chunk_launch_counts(),
                **ls.launch_counts(), **ls.chunk_launch_counts()}.values())


def test_service_cluster_two_replicas_and_a_handoff_on_card(
        cuda, tmp_path, monkeypatch):
    """Two replicas of a cluster on the card, in one process. Replica r0
    admits four requests (half their rows corrupted) and dies; r1 claims
    its WAL and checks every request on the card: the scans launch, the
    verdicts and tiers equal `check_histories` on the card, nothing is
    degraded and every verdict is published. A third replica then
    answers each request from the shared store with no batch and no
    launch."""
    import time

    from jepsen_jgroups_raft_tpu_torch.history.ops import History
    from jepsen_jgroups_raft_tpu_torch.service import CheckingService

    monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
    hs = _histories(41, 16, 60, 3, 1, 3, 0.1)
    want = check_histories(hs, CasRegister(), device=cuda)
    cdir = str(tmp_path / "cluster")
    dead = CheckingService(device=cuda, cluster_dir=cdir, replica_id="r0",
                           lease_ttl_s=0.2, batch_wait=0.0, autostart=False)
    reqs = [dead.submit([History(h) for h in hs[i:i + 4]],
                        workload="register") for i in range(0, 16, 4)]
    dead._journal.close()
    survivor = CheckingService(device=cuda, cluster_dir=cdir,
                               replica_id="r1", batch_wait=0.0)
    time.sleep(0.4)
    ds.reset_launch_counts()
    ls.reset_launch_counts()
    try:
        assert survivor.cluster.handoff_scan() == 1
        outs = [survivor.get(r.id) for r in reqs]
        for x in outs:
            assert x is not None and x.wait(300) and x.status == "done"
        deadline = time.monotonic() + 60
        while survivor.stats()["store_puts"] < 4:  # published after done
            assert time.monotonic() < deadline, survivor.stats()
            time.sleep(0.02)
        st = survivor.stats()
    finally:
        survivor.shutdown()
    assert _scan_launches() > 0
    got = [x for r in outs for x in r.results]
    assert [(x["valid?"], x["decided-tier"]) for x in got] == \
        [(x["valid?"], x["decided-tier"]) for x in want]
    assert not any("platform-degraded" in x for x in got)
    assert st["degraded_batches"] == 0 and st["handoff_requests"] == 4
    assert st["store_puts"] == 4
    reader = CheckingService(device=cuda, cluster_dir=cdir,
                             replica_id="r2", batch_wait=0.0)
    ds.reset_launch_counts()
    ls.reset_launch_counts()
    try:
        again = [reader.submit([History(h) for h in hs[i:i + 4]],
                               workload="register") for i in range(0, 16, 4)]
        rst = reader.stats()
    finally:
        reader.shutdown()
    assert all(r.status == "done" and r.cached for r in again)
    assert rst["store_hits"] == 4 and rst["batches"] == 0
    assert _scan_launches() == 0
    assert [x["valid?"] for r in again for x in r.results] == \
        [x["valid?"] for x in want]
