"""Card-only tests of the port's CUDA kernels (marker `gpu`).

The hand-written kernels have no CPU mode, so every test here skips
with a reason where torch.cuda is unavailable. The file imports only
the port, so on the card it runs without the conftest that pins JAX to
the host:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Each kernel is held bitwise to its plain PyTorch version on the same
inputs (verdicts are booleans: tolerance is exact equality).
"""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.history.packing import (encode_history,
                                                           pack_batch,
                                                           pack_macro_batch)
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds

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


def _inputs(name, macro, dev):
    make, W, S = CONFIGS[name]
    m = CasRegister()
    encs = [encode_history(h, m) for h in make()]
    plan = ds.dense_plan(m, encs)
    assert plan is not None and plan.n_slots <= W and plan.n_states <= S
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    val_of = torch.from_numpy(plan.val_of)
    if S > val_of.shape[1]:  # pad the table with its id-0 value
        val_of = torch.cat([val_of, val_of[:, :1].expand(
            -1, S - val_of.shape[1])], dim=1).contiguous()
    return (torch.from_numpy(batch["events"]).to(dev), val_of.to(dev), W,
            batch.get("macro_p"),
            torch.from_numpy(batch["n_events"]).to(dev))


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
