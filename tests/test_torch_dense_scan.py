"""The port's dense scan against the reference's.

Inputs are the REFERENCE's own encodings, plans and packed arrays
(carried across by `interop`), so these tests never depend on the port's
encoder. `dense_scan_plain` must equal, row for row, the reference XLA
dense kernel (`make_dense_batch_checker`), the Pallas kernel in interpret
mode (as tests/test_pallas_scan.py runs it) and the host oracle
`check_encoded_cpu`, in both row formats, at windows W = 1..8 and domain
sizes S = 1, 4 and 16. Verdicts are booleans: the tolerance is exact
equality. The window grouping must give the reference's groups, `rest`
and `val_of`. The CUDA kernel itself is held to the plain version by the
card-only tests in tests/test_torch_kernels_gpu.py.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.wgl_cpu import check_encoded_cpu
from jepsen_jgroups_raft_tpu.history.ops import INFO, INVOKE, OK, History, Op
from jepsen_jgroups_raft_tpu.history.packing import (encode_history,
                                                     pack_batch,
                                                     pack_macro_batch,
                                                     pad_batch_bucketed)
from jepsen_jgroups_raft_tpu.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu.models.setmodel import GSet as RefGSet
from jepsen_jgroups_raft_tpu.ops import dense_scan as ref_ds
from jepsen_jgroups_raft_tpu.ops.pallas_scan import make_pallas_batch_checker
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker.wgl_cpu import (
    check_encoded_cpu as port_oracle)
from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
from jepsen_jgroups_raft_tpu_torch.models.setmodel import GSet
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as port_ds
from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (dense_scan,
                                                          dense_scan_plain)

torch.set_num_threads(1)


def _h(rows):
    h = History()
    for r in rows:
        h.append(Op(*r))
    return h


def _corrupt_read(h, rng):
    ops = list(h)
    reads = [j for j, op in enumerate(ops)
             if op.type == OK and op.f == "read" and op.value is not None]
    if reads:
        j = rng.choice(reads)
        ops[j] = ops[j].replace(value=ops[j].value + 1)
    return ops


GOLDENS = [
    _h([(0, INVOKE, "write", 1), (0, OK, "write", 1),
        (1, INVOKE, "read", None), (1, OK, "read", 1)]),       # valid
    _h([(0, INVOKE, "write", 1), (0, OK, "write", 1),
        (1, INVOKE, "read", None), (1, OK, "read", 2)]),       # invalid
    _h([(0, INVOKE, "write", 7), (0, INFO, "write", 7),
        (1, INVOKE, "read", None), (1, OK, "read", 7)]),       # info ok
    _h([(0, INVOKE, "cas", (0, 3)), (0, OK, "cas", (0, 3))]),  # cas≠init
]


def _random(seed, n, n_ops, n_procs, max_crashes, value_range, crash_p):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = random_valid_history(rng, "register", n_ops=n_ops,
                                 n_procs=n_procs, crash_p=crash_p,
                                 max_crashes=max_crashes,
                                 value_range=value_range)
        out.append(_corrupt_read(h, rng) if i % 2 else h)
    return out


def _reads_only(n):
    """S = 1: one process reading nil; odd histories read a 1 once."""
    return [_h([r for k in range(6) for r in
                ((0, INVOKE, "read", None),
                 (0, OK, "read", 1 if (i % 2 and k == 3) else None))])
            for i in range(n)]


# name -> (histories, expected window range, expected S)
CASES = {
    "goldens_W1": (lambda: GOLDENS, (1, 2), 2),
    "random24_W<=7_S4": (lambda: _random(99, 24, 40, 4, 3, 3, 0.15),
                         (4, 7), 4),
    "W8_S4": (lambda: _random(0, 12, 60, 5, 3, 3, 0.6), (8, 8), 4),
    "S16": (lambda: _random(5, 12, 30, 3, 1, 15, 0.2), (2, 4), 16),
    "S1_W1": (lambda: _reads_only(8), (1, 1), 1),
}


def _ref_inputs(hists, macro):
    """Reference encodings, plan and packed batch -> numpy arrays."""
    m = RefReg()
    encs = [encode_history(h, m) for h in hists]
    plan = ref_ds.dense_plan(m, encs)
    assert plan is not None and plan.kind == "domain"
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    return encs, plan, batch


def _plain(plan, batch):
    p = interop.plan_from_reference(plan)
    ok = dense_scan_plain(torch.from_numpy(batch["events"]),
                          torch.from_numpy(p.val_of), p.n_slots,
                          macro_p=batch.get("macro_p"),
                          n_events=torch.from_numpy(batch["n_events"]),
                          model=CasRegister())
    assert ok.dtype == torch.bool
    return ok.numpy()


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_xla_dense_and_oracle(case, macro):
    make, (w_lo, w_hi), S = CASES[case]
    encs, plan, batch = _ref_inputs(make(), macro)
    assert w_lo <= plan.n_slots <= w_hi and plan.n_states == S
    ok = _plain(plan, batch)
    ev, (val_of,), B = pad_batch_bucketed(batch["events"], (plan.val_of,))
    ref_kernel = ref_ds.make_dense_batch_checker(
        RefReg(), "domain", plan.n_slots, plan.n_states,
        macro_p=batch.get("macro_p"))
    ref_ok = np.asarray(ref_kernel(ev, val_of)[0])[:B]
    oracle = [check_encoded_cpu(e, RefReg()).valid for e in encs]
    assert ok.tolist() == ref_ok.tolist() == oracle
    # the port's oracle copy agrees on the carried-across encodings
    assert oracle == [port_oracle(interop.encoding_from_reference(e),
                                  CasRegister()).valid for e in encs]
    assert 0 < sum(oracle) < len(oracle) or case == "S16"


def _set_domain(seed, n, n_ops, n_procs, max_crashes, value_range):
    """Set histories with at most 4 distinct adds (a dense domain of up
    to 16 states); odd ones with one observed element dropped."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = list(random_valid_history(rng, "set", n_ops=n_ops,
                                      n_procs=n_procs, crash_p=0.3,
                                      max_crashes=max_crashes,
                                      value_range=value_range))
        reads = [j for j, op in enumerate(h) if op.type == OK
                 and op.f == "read" and op.value]
        if i % 2 and reads:
            j = rng.choice(reads)
            h[j] = h[j].replace(value=h[j].value[1:])
        out.append(h)
    return out


SET_CASES = {  # name -> (histories, expected window range, expected S)
    "set_W<=6_S8": (lambda: _set_domain(31, 16, 40, 4, 2, 3), (3, 6), 8),
    "set_W<=9_S16": (lambda: _set_domain(32, 12, 40, 5, 4, 4), (6, 9), 16),
}


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("case", list(SET_CASES))
def test_plain_set_domain_matches_xla_dense_and_oracle(case, macro):
    """The set on the dense-domain scan (its OR step through the same
    transition rows), against the reference's XLA kernel and oracle."""
    make, (w_lo, w_hi), S = SET_CASES[case]
    encs = [encode_history(h, RefGSet()) for h in make()]
    plan = ref_ds.dense_plan(RefGSet(), encs)
    assert plan.kind == "domain" and w_lo <= plan.n_slots <= w_hi
    assert plan.n_states == S
    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    p = interop.plan_from_reference(plan)
    ok = dense_scan_plain(torch.from_numpy(batch["events"]),
                          torch.from_numpy(p.val_of), p.n_slots,
                          macro_p=batch.get("macro_p"),
                          n_events=torch.from_numpy(batch["n_events"]),
                          model=GSet()).numpy()
    ev, (val_of,), B = pad_batch_bucketed(batch["events"], (plan.val_of,))
    ref_kernel = ref_ds.make_dense_batch_checker(
        RefGSet(), "domain", plan.n_slots, plan.n_states,
        macro_p=batch.get("macro_p"))
    ref_ok = np.asarray(ref_kernel(ev, val_of)[0])[:B]
    oracle = [check_encoded_cpu(e, RefGSet()).valid for e in encs]
    assert ok.tolist() == ref_ok.tolist() == oracle
    assert 0 < sum(oracle) < len(oracle)


@pytest.mark.parametrize("macro", [False, True], ids=["legacy", "macro"])
@pytest.mark.parametrize("case", ["goldens_W1", "random24_W<=7_S4"])
def test_plain_matches_pallas_interpret(case, macro):
    make, _, _ = CASES[case]
    encs, plan, batch = _ref_inputs(make(), macro)
    ev, (val_of,), B = pad_batch_bucketed(batch["events"], (plan.val_of,))
    kern = make_pallas_batch_checker(RefReg(), plan.n_slots, plan.n_states,
                                     ev.shape[1], interpret=True,
                                     macro_p=batch.get("macro_p"))
    pallas_ok = np.asarray(kern(ev, val_of)[0])[:B]
    assert _plain(plan, batch).tolist() == pallas_ok.tolist()
    if case == "goldens_W1":
        assert pallas_ok.tolist() == [True, False, True, False]


def test_padded_rows_and_wider_window_do_not_change_verdicts():
    """EV_PAD rows past n_events, a wider launch window and a padded
    domain table (repeated id 0) leave every verdict unchanged."""
    encs, plan, batch = _ref_inputs(CASES["random24_W<=7_S4"][0](), True)
    base = _plain(plan, batch)
    ev = np.concatenate([batch["events"],
                         np.zeros_like(batch["events"][:, :9])], axis=1)
    vo = np.concatenate([plan.val_of, np.repeat(plan.val_of[:, :1], 4, 1)],
                        axis=1)
    wide = dense_scan_plain(torch.from_numpy(ev), torch.from_numpy(vo),
                            plan.n_slots + 1, macro_p=batch["macro_p"],
                            model=CasRegister())
    assert wide.numpy().tolist() == base.tolist()


def _mixed_batch():
    """Windows 1..9 with small straggler buckets (merging), domains up to
    16 values, LONG histories (> MERGE_MAX_EVENTS events, which
    JGRAFT_MERGE_LONG=1 pools) and histories beyond the caps (rest)."""
    rng = random.Random(2024)
    hs = []
    for n_procs, crashes, vr, n, n_ops in (
            (1, 0, 3, 20, 50), (2, 0, 3, 5, 50), (3, 2, 3, 30, 50),
            (4, 3, 7, 10, 50), (5, 4, 15, 6, 50), (6, 6, 3, 3, 50),
            (3, 1, 40, 4, 50), (4, 2, 3, 3, 3000), (2, 1, 3, 2, 3000)):
        for _ in range(n):
            hs.append(random_valid_history(rng, "register", n_ops=n_ops,
                                           n_procs=n_procs, crash_p=0.5,
                                           max_crashes=crashes,
                                           value_range=vr))
    return [encode_history(h, RefReg()) for h in hs]


@pytest.mark.parametrize("merge_long", [None, "1"])
def test_dense_plans_grouped_matches_reference(monkeypatch, merge_long):
    if merge_long is None:
        monkeypatch.delenv("JGRAFT_MERGE_LONG", raising=False)
    else:
        monkeypatch.setenv("JGRAFT_MERGE_LONG", merge_long)
    encs = _mixed_batch()
    ref_groups, ref_rest = ref_ds.dense_plans_grouped(RefReg(), encs)
    port_groups, port_rest = port_ds.dense_plans_grouped(
        CasRegister(), [interop.encoding_from_reference(e) for e in encs])
    assert sorted(port_rest) == sorted(ref_rest) and ref_rest
    assert len(port_groups) == len(ref_groups) >= 3
    assert any(e.n_events > port_ds.MERGE_MAX_EVENTS for e in encs)
    for (pi, pp), (ri, rp) in zip(port_groups, ref_groups):
        rp = interop.plan_from_reference(rp)
        assert pi == ri
        assert (pp.kind, pp.n_slots, pp.n_states) == \
            (rp.kind, rp.n_slots, rp.n_states)
        assert np.array_equal(pp.val_of, rp.val_of)
        assert pp.val_of.dtype == np.int32


def test_dense_plan_matches_reference():
    encs = _mixed_batch()
    ok_encs = encs[:40]
    rp = ref_ds.dense_plan(RefReg(), ok_encs)
    pp = port_ds.dense_plan(CasRegister(), [
        interop.encoding_from_reference(e) for e in ok_encs])
    assert (pp.n_slots, pp.n_states) == (rp.n_slots, rp.n_states)
    assert np.array_equal(pp.val_of, rp.val_of)
    assert port_ds.dense_plan(CasRegister(), [
        interop.encoding_from_reference(e) for e in encs]) is None
    assert ref_ds.dense_plan(RefReg(), encs) is None


def test_wrapper_takes_plain_version_for_cpu_tensors():
    encs, plan, batch = _ref_inputs(GOLDENS, True)
    port_ds.reset_launch_counts()
    ok = dense_scan(torch.from_numpy(batch["events"]),
                    torch.from_numpy(plan.val_of), plan.n_slots,
                    macro_p=batch["macro_p"],
                    n_events=torch.from_numpy(batch["n_events"]))
    assert ok.tolist() == [True, False, True, False]
    assert port_ds.launch_counts() == {"dense_scan": 0,
                                       "mask_scan": 0}  # no kernel ran
