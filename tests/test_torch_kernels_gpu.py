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

from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.checker.schedule import (DenseLaunch,
                                                            run_dense_groups)
from jepsen_jgroups_raft_tpu_torch.history.packing import (encode_history,
                                                           pack_batch,
                                                           pack_macro_batch)
from jepsen_jgroups_raft_tpu_torch.history.synth import (
    build_history, burst_history, offset_counter_history, random_mask_rows,
    random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import (MODELS, Counter, GSet,
                                                  TicketQueue)
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

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
    assert ls.launch_counts()["sort_scan"] > 0
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


def _cycle_graphs(N, seed):
    """Random digraphs, a dense DAG, a long chain, a planted N-cycle and
    zero-padded rows, nodes shuffled: [G, N, N] int32 (three graphs above
    2048 nodes, where the plain version is slow)."""
    kinds = (("random", "chain", "cycle") if N > 2048 else
             ("random", "dag", "chain", "cycle", "padded"))
    rng = np.random.default_rng(seed)
    out = []
    for kind in kinds:
        n = max(2, N - N // 5) if kind == "padded" else N
        if kind in ("random", "padded"):
            g = (rng.random((n, n)) < 1.5 / n).astype(np.int32)
        elif kind == "dag":
            g = np.triu((rng.random((n, n)) < 0.3).astype(np.int32), 1)
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
    flags = [cycle.host_has_cycle(g) for g in adj]
    assert has.tolist() == flags


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


@pytest.mark.parametrize("N", [1, 2, 31, 32, 33, 1024, 4096, 65536],
                         ids=lambda n: f"N{n}")
def test_election_safety_kernel_matches_plain(cuda, N):
    obs = torch.from_numpy(_election_rows(N, N)).to(cuda)
    got = _election_kernel_and_plain(obs)
    if N > 1:
        assert not all(got) and any(got)
    vl = torch.from_numpy(np.random.default_rng(N).integers(
        0, N + 1, size=obs.shape[0]).astype(np.int32)).to(cuda)
    _election_kernel_and_plain(obs, vl)


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
