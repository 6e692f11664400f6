#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA):

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. stamp   — torch / CUDA / nvcc versions, the card's name and power limit
  2. build   — nvcc builds every kernel of the path from this checkout's
               sources (into build/torch_kernels/)
  3. kernel  — each kernel against its plain PyTorch version, bitwise, on
               random window groups at the cap corners, both row formats,
               valid and invalid histories
  4. main    — the north-star check through the port's `check_histories`
               on the card: 1000 CAS-register histories of 1000 ops (5
               processes, crash_p 0.05, at most 3 crashes, seed 20260729);
               warm-up, then best of 3; all must be VALID, no row may take
               the host tier, the kernel's launch count must be above 0
  5. invalid — 64 of those histories with one read corrupted: kernel,
               plain version and host oracle must agree row for row, and
               every corrupted row must be INVALID

Then the kernels' summary line, the card's `nvidia-smi` name and power
limit, and as the last line {"ok": true, "device": {...}}. Exits non-zero
without a CUDA device, and when the port's package is not beside it.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

SEED = 20260729
N_HISTORIES = 1000
N_OPS = 1000
N_PROCS = 5
CRASH_P = 0.05
MAX_CRASHES = 3
VALUE_RANGE = 3  # history/synth.py's default: a domain of ≤ 4 values
N_INVALID = 64

#: H100 SXM rates: HBM3 bandwidth, and the CUDA-core (non-tensor) peak
#: used for the kernel's bit operations.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

KERNEL_SOURCE = "jepsen_jgroups_raft_tpu_torch/ops/csrc/dense_scan.cu"
KERNEL_REPLACES = "jepsen_jgroups_raft_tpu/ops/pallas_scan.py:102"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def corrupt_read(ops, rng, bump: int):
    """Raise one ok read's value by `bump` (the reference tests'
    `_maybe_corrupt_read` with a chosen bump); returns (ops, changed)."""
    ops = list(ops)
    reads = [j for j, op in enumerate(ops)
             if op.type == "ok" and op.f == "read" and op.value is not None]
    if not reads:
        return ops, False
    j = rng.choice(reads)
    ops[j] = ops[j].replace(value=ops[j].value + bump)
    return ops, True


def group_tensors(encs, plan, macro: bool, dev, W=None, S=None):
    """(events, val_of, n_events, macro_p) tensors on `dev` for one
    group, optionally widened to window W and domain table size S."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        pack_batch, pack_macro_batch)

    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    val_of = plan.val_of
    if S is not None and S > val_of.shape[1]:
        pad = np.repeat(val_of[:, :1], S - val_of.shape[1], axis=1)
        val_of = np.concatenate([val_of, pad], axis=1)
    return (torch.from_numpy(batch["events"]).to(dev),
            torch.from_numpy(np.ascontiguousarray(val_of)).to(dev),
            torch.from_numpy(batch["n_events"]).to(dev),
            batch.get("macro_p"), W or plan.n_slots)


def phase_kernel(dev, model):
    """Kernel vs plain version at the cap corners, both row formats,
    both polarities. Returns (rows compared, max |kernel - plain|)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        build_history, random_valid_history)
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_plan, dense_scan, dense_scan_plain)

    rng = random.Random(SEED + 1)

    def synth(n, n_ops, n_procs, max_crashes, value_range, crash_p):
        hs = []
        for i in range(n):
            h = random_valid_history(rng, "register", n_ops=n_ops,
                                     n_procs=n_procs, crash_p=crash_p,
                                     max_crashes=max_crashes,
                                     value_range=value_range)
            if i % 2:
                h, _ = corrupt_read(h, rng, 1)
            hs.append(h)
        return hs

    def reads_only(n, n_ops):
        # W = 1, S = 1: one process reading nil; odd rows read a 1
        hs = []
        for i in range(n):
            rows = []
            for k in range(n_ops):
                v = 1 if (i % 2 and k == n_ops // 2) else None
                rows += [(0, "invoke", "read", None), (0, "ok", "read", v)]
            hs.append(build_history(rows))
        return hs

    corners = [
        ("W10_S8", synth(48, 160, 5, 5, 7, 0.3), 10, 8),
        ("W9_S16", synth(48, 160, 5, 4, 15, 0.3), 9, 16),
        ("W1_S1", reads_only(32, 40), 1, 1),
        ("north_star", synth(64, 300, N_PROCS, MAX_CRASHES, VALUE_RANGE,
                             CRASH_P), None, None),
    ]
    compared, max_err = 0, 0
    for name, hists, W, S in corners:
        encs = [encode_history(h, model) for h in hists]
        plan = dense_plan(model, encs)
        if plan is None or plan.n_slots > (W or plan.n_slots) or \
                plan.n_states > (S or plan.n_states):
            raise AssertionError(f"{name}: corner histories do not fit "
                                 f"(plan {plan and (plan.n_slots, plan.n_states)})")
        for macro in (False, True):
            ev, vo, ne, P, Wk = group_tensors(encs, plan, macro, dev, W, S)
            ok_k = dense_scan(ev, vo, Wk, macro_p=P, n_events=ne,
                              model=model)
            torch.cuda.synchronize()
            ok_p = dense_scan_plain(ev, vo, Wk, macro_p=P, n_events=ne,
                                    model=model)
            err = int((ok_k.int() - ok_p.int()).abs().max())
            n_valid = int(ok_p.sum())
            emit("kernel", case=name, rows=int(ev.shape[0]),
                 events=int(ev.shape[1]), row_ints=int(ev.shape[2]),
                 W=int(Wk), S=int(vo.shape[1]), macro_p=P,
                 valid=n_valid, invalid=int(ev.shape[0]) - n_valid,
                 max_abs_err=err)
            if err != 0:
                raise AssertionError(f"{name}: kernel disagrees with the "
                                     f"plain version")
            if n_valid in (0, int(ev.shape[0])):
                raise AssertionError(f"{name}: both polarities expected")
            compared += int(ev.shape[0])
            max_err = max(max_err, err)
    return compared, max_err


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
            check_encoded, check_histories)
        from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
            DenseLaunch, consume_tiers, run_dense_groups)
        from jepsen_jgroups_raft_tpu_torch.checker.wgl_cpu import (
            check_encoded_cpu)
        from jepsen_jgroups_raft_tpu_torch.history.packing import (
            encode_history, pack_macro_batch)
        from jepsen_jgroups_raft_tpu_torch.history.synth import (
            random_valid_history)
        from jepsen_jgroups_raft_tpu_torch.models.register import CasRegister
        from jepsen_jgroups_raft_tpu_torch.ops import _build
        from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
            dense_plans_grouped, dense_scan_plain, launch_counts,
            reset_launch_counts)
        from jepsen_jgroups_raft_tpu_torch.platform import toolchain_stamp
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    model = CasRegister()
    stamp = toolchain_stamp()
    emit("stamp", **stamp)

    # 2. build from this checkout's sources
    build_s = _build.build(["dense_scan"])
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.get("dense_scan", "")
             .splitlines() if "registers" in ln or "smem" in ln]
    emit("build", seconds=build_s, kernels=["dense_scan"], ptxas=ptxas)

    # 3. kernel against its plain version at the cap corners
    t0 = time.perf_counter()
    compared, corner_err = phase_kernel(dev, model)
    emit("kernel_summary", rows_compared=compared, max_abs_err=corner_err,
         seconds=time.perf_counter() - t0)

    # 4. the main path: the north-star batch through check_histories
    t0 = time.perf_counter()
    rng = random.Random(SEED)
    histories = [random_valid_history(rng, "register", n_ops=N_OPS,
                                      n_procs=N_PROCS, crash_p=CRASH_P,
                                      max_crashes=MAX_CRASHES)
                 for _ in range(N_HISTORIES)]
    synth_s = time.perf_counter() - t0
    check_histories(histories, model, device=dev)  # warm-up
    consume_tiers()
    walls, launches = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = check_histories(histories, model, device=dev)
        walls.append(time.perf_counter() - t0)
        launches = launch_counts()
        if launches["dense_scan"] <= 0:
            raise AssertionError("main path launched no dense_scan kernel")
    tiers = consume_tiers()
    n_valid = sum(1 for r in results if r["valid?"] is True)
    host_rows = sum(1 for r in results if r.get("decided-tier") != "dense")
    if n_valid != N_HISTORIES:
        raise AssertionError(f"verdict guard: {n_valid} of {N_HISTORIES} "
                             f"VALID (every history is valid by "
                             f"construction)")
    if host_rows or "host" in tiers:
        raise AssertionError(f"{host_rows} rows left the dense kernel")

    # breakdown of one run: encode, group + pack, kernel per group
    t0 = time.perf_counter()
    encs = [encode_history(h, model) for h in histories]
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grouped, rest = dense_plans_grouped(model, encs)
    batches = [pack_macro_batch([encs[i] for i in idxs])
               for idxs, _ in grouped]
    pack_s = time.perf_counter() - t0
    launch_list = [DenseLaunch(
        events=torch.from_numpy(b["events"]).to(dev),
        val_of=torch.from_numpy(plan.val_of).to(dev),
        n_events=torch.from_numpy(b["n_events"]).to(dev),
        n_slots=plan.n_slots, macro_p=b["macro_p"])
        for b, (_, plan) in zip(batches, grouped)]
    group_ms = None
    for _ in range(3):
        run = run_dense_groups(launch_list, model, timed=True)
        group_ms = run.kernel_ms if group_ms is None else \
            [min(a, b) for a, b in zip(group_ms, run.kernel_ms)]
    kernel_ms = sum(group_ms)
    scan_steps = int(sum(int(b["n_events"].sum()) for b in batches))

    # the plain version on the same groups: its time, bitwise agreement,
    # and the work this run's data needed (for the bound)
    plain_oks, group_stats = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ln in launch_list:
        g: dict = {}
        plain_oks.append(dense_scan_plain(
            ln.events, ln.val_of, ln.n_slots, macro_p=ln.macro_p,
            n_events=ln.n_events, model=model, stats=g))
        group_stats.append(g)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    main_err = max(int((torch.from_numpy(k).int() - p.cpu().int())
                       .abs().max()) for k, p in zip(run.ok, plain_oks))
    if main_err != 0:
        raise AssertionError("main-path groups: kernel disagrees with the "
                             "plain version")

    # bound: the bytes the kernel must move (the real event rows, val_of
    # and n_events read once, ok written once) against the bit operations
    # this data needed (closure: one OR per (mask, source state) of each
    # open slot's pass; FORCE: one word per mask; latch: S² compares per
    # opened op)
    bytes_moved, ops = 0, 0
    for ln, b, g in zip(launch_list, batches, group_stats):
        B, _, R = (int(x) for x in ln.events.shape)
        S, M = int(ln.val_of.shape[1]), 1 << ln.n_slots
        bytes_moved += int(b["n_events"].sum()) * R * 4 + B * (S * 4 + 5)
        n_opens = int(ln.events[:, :, 2].clamp(min=0).sum())
        ops += (g["slot_passes"] * (M // 2) * S + g["force_rows"] * M
                + n_opens * S * S)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / CORE_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    sweeps = sum(g["sweeps"] for g in group_stats)
    slot_passes = sum(g["slot_passes"] for g in group_stats)
    force_rows = sum(g["force_rows"] for g in group_stats)
    best = min(walls)
    emit("main", histories=N_HISTORIES, ops_per_history=N_OPS,
         valid=n_valid, host_rows=host_rows, rest=len(rest),
         groups=len(grouped),
         windows=[int(p.n_slots) for _, p in grouped],
         group_rows=[len(i) for i, _ in grouped],
         states=[int(p.n_states) for _, p in grouped],
         macro_p=[int(b["macro_p"]) for b in batches],
         synth_s=synth_s, check_s_reps=walls, check_s_best=best,
         hist_per_s=N_HISTORIES / best, encode_s=encode_s, pack_s=pack_s,
         kernel_ms_per_group=group_ms, kernel_ms=kernel_ms,
         plain_ms=plain_ms, scan_steps=scan_steps,
         closure_sweeps=sweeps, slot_passes=slot_passes,
         force_rows=force_rows, bytes_moved=bytes_moved,
         bit_ops=ops, bound_ms=bound_ms, bound_by=bound_by,
         launches=launches, tiers=tiers, device=stamp["device_name"],
         power=stamp["nvidia_smi"])

    # 5. invalid subset: guaranteed-invalid corruption (the bumped read
    # leaves the value domain), kernel vs plain vs host oracle
    rng = random.Random(SEED + 2)
    bad = []
    for h in histories[:N_INVALID]:
        ops_, changed = corrupt_read(h, rng, VALUE_RANGE + 1)
        if not changed:
            raise AssertionError("a north-star history without an ok read")
        bad.append(ops_)
    bad_encs = [encode_history(h, model) for h in bad]
    res = check_encoded(bad_encs, model, device=dev)
    k_ok = [r["valid?"] is True for r in res]
    sub_groups, sub_rest = dense_plans_grouped(model, bad_encs)
    p_ok = [None] * len(bad_encs)
    for idxs, plan in sub_groups:
        ev, vo, ne, P, W = group_tensors([bad_encs[i] for i in idxs], plan,
                                         True, dev)
        ok_p = dense_scan_plain(ev, vo, W, macro_p=P, n_events=ne,
                                model=model).cpu().tolist()
        for j, i in enumerate(idxs):
            p_ok[i] = bool(ok_p[j])
    o_ok = [check_encoded_cpu(e, model).valid for e in bad_encs]
    emit("invalid", rows=len(bad_encs), kernel_invalid=k_ok.count(False),
         plain_invalid=p_ok.count(False), oracle_invalid=o_ok.count(False),
         rest=len(sub_rest),
         tiers=sorted({r.get("decided-tier") for r in res}))
    if sub_rest or any(r.get("decided-tier") != "dense" for r in res):
        raise AssertionError("invalid subset left the dense kernel")
    if k_ok != p_ok or k_ok != o_ok or any(k_ok):
        raise AssertionError("invalid subset: kernel, plain version and "
                             "host oracle disagree, or a corrupted row "
                             "passed")

    print(json.dumps({"kernels": [{
        "name": "dense_scan", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": int(launches["dense_scan"]),
        "max_abs_err": float(max(corner_err, main_err)),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
