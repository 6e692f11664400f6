#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA):

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:
  1. stamp   — torch / CUDA / nvcc versions, the card's name and power limit
  2. build   — nvcc builds every kernel of the paths (dense_scan,
               mask_scan, sort_scan, segment_scan, cycle_closure: B7 and
               B8, election_safety) and the instrumented
               mask_scan_profile from this checkout's sources into
               build/torch_kernels/, one nvcc per library, started
               together; ptxas's report for each; the paths' kernels must
               show no spill bytes and no stack frame
  3. kernel  — dense_scan against its plain PyTorch version, bitwise, at
               every window W = 1..10 with the largest domain S the caps
               allow, at W = 1 / S = 1 and at the north-star shape, both
               row formats, valid and invalid histories in each case
  4. mask_kernel — mask_scan against its plain version, bitwise: counter
               and queue groups at every window W = 1..12, both row
               formats, both polarities; 10-process counter groups at
               W = 10..12 (250 ops); a counter group that crosses
               2^31; arbitrary rows (slots out of range, shared slots,
               int32 edges) for the counter, the queue and a counter
               started near 2^31
  5. groups  — register domain groups and counter / queue mask groups that
               differ in W, macro width P and length E, launched together
               through `run_dense_groups` (one stream each): every group's
               verdicts equal the plain version's on that group alone
  6. main    — the north-star check through the port's `check_histories`
               on the card: 1000 CAS-register histories of 1000 ops (5
               processes, crash_p 0.05, at most 3 crashes, seed 20260729);
               warm-up, then best of 3; all must be VALID, every row on the
               dense tier, dense_scan's launch count (reset before each
               run) above 0. Then the breakdown: encode, group + pack, the
               overlapped span of the groups, each group's time alone, its
               ns per row, the plain version's time and the bound
  7. profile — one check under torch.profiler: the device's busy share of
               the check's wall (a trace without device time fails)
  8. invalid — 64 of those histories with one read corrupted: kernel,
               plain version and host oracle must agree row for row, and
               every corrupted row must be INVALID
  9. counter_main, queue_main — the reference suite's counter and queue
               shapes (bench.py configs 2 and 7): 1000 histories of 1000
               ops, 5 processes, crash_p 0.05, at most 3 crashes, seed
               20260729, through `check_histories` on the card, measured
               as `main`; all VALID, every row on the mask tier, 0 host
               rows, mask_scan's launch count above 0
 10. counter10_main — the counter at upstream's documented concurrency
               (10 processes, crash_p 0.05, at most 3 crashes, 1000 ops,
               seed 20260729 + 10): the first 1000 histories whose window
               is within the mask cap (12; the number drawn is printed),
               measured as `main`, groups at W = 10..12
 11. counter_invalid — 64 of the counter histories with one read
               corrupted: kernel, plain version and host oracle agree row
               for row, every corrupted row INVALID
 12. mask_profile — the instrumented mask kernel (built with
               -DMASK_SCAN_PROFILE, never on a main path) on the counter's
               W = 8 group, the queue group (also its first rows alone,
               one per SM sub-partition) and the 10-process W = 12 group:
               SM cycles by phase
               (ring wait, latch, legality, sweeps, FORCE), ballots per
               closing FORCE, cycles per ballot; its ballots must equal
               the plain version's `ballots_lazy`
 13. sort_kernel — sort_scan against its plain version, bitwise on ok
               and overflow: the five models (list-append included) at
               every kernel window 1..16
               and 31, 63, 95, 127 (histories up to the window, bursts
               that fill it), C in {4, 64, 256}, the row format
               alternating, valid and corrupted; short histories with C near their frontier
               (rows that overflow and end ok, rows that overflow and do
               not: both counts must be above 0); arbitrary rows (slots
               out of range, shared slots, int32 edges)
 14. set_main — the reference suite's set shape (bench.py config 6:
               1000 histories of 1000 ops, 5 processes, crash_p 0.05, at
               most 3 crashes, value_range 32, seed 20260729) through
               `check_histories` on the card, measured as `main`: all
               VALID, every row on the sort tier, 0 host rows, sort_scan's
               launch count above 0; then each rung of the ladder (C = 64,
               then the rows that overflowed at C = 256): rows, kernel ms,
               ns per row, the plain version's time and bitwise flags
 15. set_invalid — 64 of those histories with one read made impossible
               (it misses an element whose add completed before the read
               began): kernel, plain ladder and host oracle agree row for
               row, every row INVALID
 16. segment_kernel — segment_scan against its plain version, bitwise on
               every bit of the final frontiers: W = 1..10 at the largest
               S the caps allow and W = 3 / S = 1, segments of 2048 rows
               at W = 7..10 (512 below), crash sets of 0..4 slots, dead
               seeds, mixed real lengths
 17. long_main — the reference suite's long histories (bench.py configs
               5 and 4: one 100k-op register history, crash_p 0.01, and
               16 of 10k ops, crash_p 0.02; 5 processes, at most 4
               crashes, seeded from SEED) through `check_histories` on the
               card with JGRAFT_SEGMENT=1 and =0, best of 3 each: all
               VALID, the segmented arm on "dense-seg" with more than one
               segment and segment_scan launched; encode / plan / kernel /
               compose times; both arms on the first 1 / 2 / 4 / 8 of
               config 4's histories; with JGRAFT_SEGMENT unset (the
               card's default) config 5 must take the segmented scan and
               config 4 the monolithic one; for config 5, segment_scan alone
               against its plain version on the path's own tensors
               (bitwise) and the bound
 18. long_invalid — config 5 with one late read moved outside the
               domain: INVALID on both arms and on the plain version
 19. wide_auto — the first 16 of the 10-process counter histories
               counter10_main drops (W > 12) through `auto` on the card:
               all VALID, none UNKNOWN, tier counts
 20. lin_fastpath — the first 256 north-star histories with
               JGRAFT_LIN_FASTPATH unset (the default) against 0:
               verdicts identical; certified, gated and kernel rows, both
               walls
 21. cycle_kernel — B7 (cycle_closure, N ≤ 512) and B8
               (cycle_closure_tiled) against their plain versions, bitwise
               on every bit of the closure and on has_cycle (also against
               the host DFS), at every bucket 4 … 4096: random digraphs,
               dense DAGs, a long chain, a planted N-cycle, padded rows;
               the kernel timed alone, the plain version, and at N = 512,
               1024, 4096 the library yardstick (⌈log₂N⌉ bf16 `torch.bmm`
               squarings, never on a path)
 22. sequential_main — check_histories at consistency="sequential" on
               upstream's per-key shape (1000 histories of 100 ops, 5
               processes, values in [0, 5), crash_p 0.05) and on the first
               256 north-star histories, 64 of each with a late stale
               read: the default knobs (cycle-arm store in a fresh
               directory), JGRAFT_CYCLE_KERNEL=1, =1 with
               JGRAFT_GREEDY_CERTIFY=0 (every row reaches B7 or B8), the
               host DFS arm; planted rows INVALID on the cycle tier with a
               real cycle, the rest VALID, identical across arms
 23. session_evidence — the planted rows at consistency="session": every
               one carries sc-refuted; the forced kernel arm launched
 24. anomaly_main — certify_history on the reference's transactional A/B
               shape (2000 ops, 24 keys, 5 processes) with planted
               G-single and G1c, G-single alone, and clean: condensation
               on (B7), JGRAFT_CYCLE_CONDENSE=0 (B8 at bucket 2048) and
               kernel=False identical, the expected class each
 25. listappend_main — bench.py config 9: 1000 list-append histories of
               1000 ops (5 processes, crash_p 0.05, at most 3 crashes)
               through check_histories, measured as set_main: all VALID
               on the sort tier, each rung bitwise against the plain
               ladder
Then B7 and B8 on the batches the sequential path gave them (kernel
against plain, bitwise; kernel, plain and library times; the bound).
 26. election_kernel — B9's election-safety kernel against its plain
               version, bitwise, at N = 1, 2, 31, 32, 33, 1024, 4096 and
               65536 (all safe; a second leader planted early, in the
               middle and last; one observation repeated; a padded tail;
               negative terms), also cut by a valid_len; timed alone at
               512 runs × 4096 pooled observations beside the plain
               version and the bound; and on the pooled observations of
               16 election runs written to a store (8 with a planted
               second leader), held to `check_election_safety_np`
 27. recorded_main — BASELINE config 3 from a store: the 512-key
               multi-register run (16 ops a key, 10 threads, 8 keys with
               windows over 12; seed 20260729 + 23), a counter run and an
               election run with views, re-checked by `check_recorded` on
               the card (warm-up, best of 3): all VALID, dense_scan,
               mask_scan and sort_scan launched, the tiers; per key
               through `IndependentLinearizable`, the 8 wide keys on the
               fast DFS; algorithm "cpu" gives the same verdicts and
               n-unknown; the election run's pooled observations through
               the election kernel beside the host verdict (its main
               path); the `check` CLI in a subprocess (rc 0, the same
               verdicts); a copy with one key's read corrupted: INVALID,
               that key named, a counterexample attached
 28. keyed_main — BASELINE config 4 (16 register histories of 10k ops)
               tupled into one history through `IndependentLinearizable`
               on the card: per key equal to `check_histories`

Every phase but lin_fastpath runs with JGRAFT_LIN_FASTPATH=0 (set at
the start), as the reference's test suite runs: at the default knobs
the host certifier decides most valid rows before any kernel.

Then the kernels' summary line (dense_scan, mask_scan, sort_scan,
segment_scan, cycle_closure, cycle_closure_tiled, election_safety; each
with its library's ptxas registers and spill bytes), the card's
`nvidia-smi` name and power limit, and as the last line {"ok": true, "device": {...}}. Exits non-zero
without a CUDA device, and when the port's package is not beside it.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 20260729
N_HISTORIES = 1000
N_OPS = 1000
N_PROCS = 5
CRASH_P = 0.05
MAX_CRASHES = 3
VALUE_RANGE = 3  # history/synth.py's default: a domain of ≤ 4 values
N_INVALID = 64
#: upstream's documented "5 nodes, concurrency 10" (doc/intro.md:34-37):
#: counter histories of 10 processes, crash_p 0.05, at most 3 crashes
COUNTER10_SHAPE = (10, CRASH_P, MAX_CRASHES)
#: ops per history of mask_kernel's 10-process groups (cut from N_OPS to
#: keep the script inside half its time limit; counter10_main still
#: holds its full-size groups to the plain version)
COUNTER10_KERNEL_OPS = 250
#: warp schedulers (sub-partitions) per SM on Hopper
SUB_PARTITIONS_PER_SM = 4

#: H100 SXM rates: HBM3 bandwidth, and the CUDA-core (non-tensor) peak
#: used for the kernels' 32-bit integer operations.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
#: the fewest integer operations one mask-mode legality evaluation takes
#: per mask (ops/csrc/models.cuh): the mask's state, one add off a
#: neighbouring mask's, then one compare — the counter's `state == a`
#: (or `state == b - a`, b - a taken once per slot), the queue's field
#: compare `(state & field) == a << 15`, one AND and the compare
LEGAL_STEP_OPS = {"counter": 2, "queue": 3}

#: the reference suite's set workload (bench.py:1013-1017): elements
#: drawn from 32
SET_VALUE_RANGE = 32
#: the sort kernel's windows: exact up to 16, then the word buckets
SORT_WINDOWS = tuple(range(1, 17)) + (31, 63, 95, 127)
SORT_CAPS = (4, 64, 256)

#: kernel name -> (source in the repo, the TPU-side program it replaces)
KERNELS = {
    "dense_scan": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/dense_scan.cu",
                   "jepsen_jgroups_raft_tpu/ops/pallas_scan.py:102"),
    "mask_scan": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/mask_scan.cu",
                  "jepsen_jgroups_raft_tpu/ops/dense_scan.py:577"),
    "sort_scan": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/sort_scan.cu",
                  "jepsen_jgroups_raft_tpu/ops/linear_scan.py:138"),
    "segment_scan": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/segment_scan.cu",
                     "jepsen_jgroups_raft_tpu/ops/segment_scan.py:188"),
    "cycle_closure": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/cycle_closure.cu",
                      "jepsen_jgroups_raft_tpu/ops/kernel_ir.py:371"),
    "cycle_closure_tiled": (
        "jepsen_jgroups_raft_tpu_torch/ops/csrc/cycle_closure.cu",
        "jepsen_jgroups_raft_tpu/ops/kernel_ir.py:431"),
    "election_safety": (
        "jepsen_jgroups_raft_tpu_torch/ops/csrc/election_safety.cu",
        "jepsen_jgroups_raft_tpu/models/leader.py:163"),
}
#: kernels built into another kernel's library (ops/_build.py names)
KERNEL_LIBRARY = {"cycle_closure_tiled": "cycle_closure"}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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


def cap_histories(rng, W: int, S: int, n: int, n_ops: int):
    """n register histories whose windows reach up to W slots over a
    domain of at most S values: up to 5 processes, the rest of the window
    held by crashed ops. Odd histories get one read corrupted. S = 1: one
    process reading nil, odd histories read a 1 once."""
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        build_history, random_valid_history)

    if S == 1:
        hs = []
        for i in range(n):
            rows = []
            for k in range(n_ops):
                v = 1 if (i % 2 and k == n_ops // 2) else None
                rows += [(0, "invoke", "read", None), (0, "ok", "read", v)]
            hs.append(build_history(rows))
        return hs
    n_procs = min(W, 5)
    crashes = W - n_procs
    hs = []
    for i in range(n):
        h = random_valid_history(rng, "register", n_ops=n_ops,
                                 n_procs=n_procs,
                                 crash_p=0.5 if crashes else 0.0,
                                 max_crashes=crashes, value_range=S - 1)
        if i % 2:
            h, _ = corrupt_read(h, rng, 1)
        hs.append(h)
    return hs


def group_tensors(encs, plan, macro: bool, dev, W=None, S=None):
    """(events, val_of, n_events, macro_p, W) for one group on `dev`,
    optionally widened to window W and domain table size S."""
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


def encode_group(hists, model, W=None, S=None, name="group"):
    """Encodings and dense plan of one group; the plan must fit window W
    and table size S, and some history must reach W (so the top slot's
    layout kind is exercised)."""
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_plan

    encs = [encode_history(h, model) for h in hists]
    plan = dense_plan(model, encs)
    if plan is None or plan.n_slots > (W or plan.n_slots) or \
            plan.n_states > (S or plan.n_states):
        raise AssertionError(f"{name}: histories do not fit (plan "
                             f"{plan and (plan.n_slots, plan.n_states)})")
    if W is not None and max(e.n_slots for e in encs) != W:
        raise AssertionError(f"{name}: no history reaches window {W}")
    return encs, plan


def phase_kernel(dev, model):
    """Kernel vs plain version at every window W = 1..10 (largest S the
    caps allow), W = 1 / S = 1 and the north-star shape, both row
    formats, both polarities. Returns (rows compared, max |kernel -
    plain|)."""
    from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import (
        DENSE_MAX_CELLS, DENSE_MAX_SLOTS, DENSE_MAX_STATES)
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_layout, dense_scan, dense_scan_plain)
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_valid_history)

    rng = random.Random(SEED + 1)
    corners = []
    for W in range(1, DENSE_MAX_SLOTS + 1):
        S = min(DENSE_MAX_STATES, DENSE_MAX_CELLS >> W)
        corners.append((f"W{W}_S{S}", cap_histories(rng, W, S, 32, 100),
                        W, S))
    corners.append(("W1_S1", cap_histories(rng, 1, 1, 32, 40), 1, 1))
    north = []
    for i in range(64):
        h = random_valid_history(rng, "register", n_ops=300,
                                 n_procs=N_PROCS, crash_p=CRASH_P,
                                 max_crashes=MAX_CRASHES)
        north.append(corrupt_read(h, rng, 1)[0] if i % 2 else h)
    corners.append(("north_star", north, None, None))
    compared, max_err = 0, 0
    for name, hists, W, S in corners:
        encs, plan = encode_group(hists, model, W, S, name)
        for macro in (False, True):
            ev, vo, ne, P, Wk = group_tensors(encs, plan, macro, dev, W, S)
            ok_k = dense_scan(ev, vo, Wk, macro_p=P, n_events=ne,
                              model=model)
            sync(dev)
            ok_p = dense_scan_plain(ev, vo, Wk, macro_p=P, n_events=ne,
                                    model=model)
            err = int((ok_k.int() - ok_p.int()).abs().max())
            n_valid = int(ok_p.sum())
            layout = dense_layout(Wk, int(vo.shape[1]))
            emit("kernel", case=name, rows=int(ev.shape[0]),
                 events=int(ev.shape[1]), row_ints=int(ev.shape[2]),
                 W=int(Wk), S=int(vo.shape[1]), macro_p=P,
                 layout={"field_log2": layout.field_log2,
                         "lanes": layout.lanes, "words": layout.words,
                         "passes": [layout.slot_pass(w)[0]
                                    for w in range(Wk)]},
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


def corrupt_observation(ops, rng, bump: int):
    """Change one ok observation (a read, an add-and-get's new value, an
    enqueue's or dequeue's ticket): a number raised by `bump`, a set
    read given element 31 (or losing it)."""
    ops = list(ops)
    idx = [j for j, op in enumerate(ops) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = ops[j].value
        v = (sorted(set(v) ^ {31}) if isinstance(v, list) else
             (v[0], v[1] + bump) if isinstance(v, tuple) else v + bump)
        ops[j] = ops[j].replace(value=v)
    return ops


def mask_histories(rng, kind: str, W: int, n: int, n_ops: int,
                   shape=None):
    """n counter or queue histories with windows up to W, the first
    exactly W; odd ones with one observation raised by 1000. `shape` is
    (processes, crash_p, max crashes); by default up to 5 processes and
    the rest of the window held by crashed ops."""
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_valid_history)
    from jepsen_jgroups_raft_tpu_torch.models import MODELS

    m = MODELS[kind]()
    n_procs, crash_p, crashes = shape or (min(W, 5), 0.5 if W > 5 else 0.0,
                                          max(W - 5, 0))
    top, rest = None, []
    while top is None or len(rest) < n - 1:
        h = random_valid_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                                 crash_p=crash_p, max_crashes=crashes)
        w = encode_history(h, m).n_slots
        if w == W and top is None:
            top = h
        elif w <= W and len(rest) < n - 1:
            rest.append(h)
    return [corrupt_observation(h, rng, 1000) if i % 2 else list(h)
            for i, h in enumerate([top] + rest)]


def mask_tensors(encs, macro: bool, dev):
    """(events, n_events, macro_p) of one mask group on `dev`."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        pack_batch, pack_macro_batch)

    batch = pack_macro_batch(encs) if macro else pack_batch(encs)
    return (torch.from_numpy(batch["events"]).to(dev),
            torch.from_numpy(batch["n_events"]).to(dev),
            batch.get("macro_p"))


def phase_mask_kernel(dev):
    """mask_scan against its plain version: counter and queue groups at
    every window W = 1..12 (both row formats, both polarities), counter
    groups of upstream's 10-process shape at W = 10..12, a counter group
    across 2^31, and arbitrary rows. Returns (rows compared, max |kernel -
    plain|)."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        offset_counter_history, random_mask_rows)
    from jepsen_jgroups_raft_tpu_torch.models import Counter, TicketQueue
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        mask_layout, mask_scan, mask_scan_plain)

    rng = random.Random(SEED + 4)
    compared, max_err = 0, 0

    def check(name, ev, ne, W, P, model):
        nonlocal compared, max_err
        ok_k = mask_scan(ev, W, P, ne, model=model)
        sync(dev)
        ok_p = mask_scan_plain(ev, W, P, ne, model=model)
        err = int((ok_k.int() - ok_p.int()).abs().max())
        n_valid = int(ok_p.sum())
        lay = mask_layout(W)
        emit("mask_kernel", case=name, model=model.name,
             init_state=int(model.init_state()), rows=int(ev.shape[0]),
             events=int(ev.shape[1]), row_ints=int(ev.shape[2]), W=W,
             macro_p=P, layout={"lanes": lay.lanes, "words": lay.words},
             valid=n_valid, invalid=int(ev.shape[0]) - n_valid,
             max_abs_err=err)
        if err != 0:
            raise AssertionError(f"mask_kernel/{name}: kernel disagrees "
                                 f"with the plain version")
        if n_valid in (0, int(ev.shape[0])):
            raise AssertionError(f"mask_kernel/{name}: both polarities "
                                 f"expected")
        compared += int(ev.shape[0])
        max_err = max(max_err, err)

    for kind, model in (("counter", Counter()), ("queue", TicketQueue())):
        for W in range(1, 13):
            encs = [encode_history(h, model)
                    for h in mask_histories(rng, kind, W, 24, 100)]
            for macro in (False, True):
                ev, ne, P = mask_tensors(encs, macro, dev)
                check(f"{kind}_W{W}_{'macro' if macro else 'legacy'}", ev,
                      ne, W, P, model)
    for W in (10, 11, 12):  # upstream's documented concurrency
        encs = [encode_history(h, Counter()) for h in mask_histories(
            rng, "counter", W, 24, COUNTER10_KERNEL_OPS, COUNTER10_SHAPE)]
        for macro in (False, True):
            ev, ne, P = mask_tensors(encs, macro, dev)
            check(f"counter10_W{W}_{'macro' if macro else 'legacy'}", ev, ne,
                  W, P, Counter())
    offset = 2**31 - 40  # the counter crosses 2^31 mid-history
    model = Counter(offset)
    encs = [encode_history(offset_counter_history(h, offset), model)
            for h in mask_histories(rng, "counter", 8, 32, 120)]
    for macro in (False, True):
        ev, ne, P = mask_tensors(encs, macro, dev)
        check(f"counter_across_2^31_{'macro' if macro else 'legacy'}", ev,
              ne, max(e.n_slots for e in encs), P, model)
    B, E = 96, 48
    for kind, model in (("counter", Counter()), ("queue", TicketQueue()),
                        ("counter", Counter(2**31 - 3))):
        for W in (1, 6, 12):
            for P in (None, 3, 16):
                nrng = np.random.default_rng(SEED + 1000 * W + (P or 0))
                ev = random_mask_rows(nrng, B, E, W, P, kind)
                n_events = nrng.integers(0, E + 1, size=B, dtype=np.int32)
                ev[np.arange(E)[None, :] >= n_events[:, None]] = 0
                check(f"rows_{kind}_{int(model.init_state())}_W{W}_P{P}",
                      torch.from_numpy(ev).to(dev), torch.from_numpy(
                          n_events).to(dev), W, P, model)
    return compared, max_err


def phase_groups(dev, model):
    """Register domain groups and counter / queue mask groups that differ
    in W, P and E, launched together through run_dense_groups (each mask
    group carries its own model); each must equal its plain version on
    that group alone. Returns (rows compared, {kernel: max |kernel -
    plain|})."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        DenseLaunch, run_dense_groups)
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.models import MODELS
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_scan_plain, launch_counts, mask_scan_plain)

    t0 = time.perf_counter()
    rng = random.Random(SEED + 3)
    specs = [  # (name, W, S, histories, ops each, macro rows)
        ("W2_S16_legacy", 2, 16, 40, 60, False),
        ("W6_S16_macro", 6, 16, 32, 150, True),
        ("W10_S8_macro", 10, 8, 24, 100, True),
        ("W1_S1_macro", 1, 1, 16, 30, True)]
    launches, names = [], []
    for name, W, S, n, n_ops, macro in specs:
        encs, plan = encode_group(cap_histories(rng, W, S, n, n_ops), model,
                                  W, S, name)
        ev, vo, ne, P, Wk = group_tensors(encs, plan, macro, dev, W, S)
        launches.append(DenseLaunch(events=ev, val_of=vo, n_events=ne,
                                    n_slots=Wk, macro_p=P))
        names.append(name)
    for kind, W, n, n_ops, macro in (("counter", 8, 32, 150, True),
                                     ("queue", 12, 24, 100, True),
                                     ("counter", 3, 40, 60, False)):
        m = MODELS[kind]()
        encs = [encode_history(h, m)
                for h in mask_histories(rng, kind, W, n, n_ops)]
        ev, ne, P = mask_tensors(encs, macro, dev)
        launches.append(DenseLaunch(
            events=ev, val_of=torch.zeros((ev.shape[0], 1),
                                          dtype=torch.int32, device=dev),
            n_events=ne, n_slots=W, macro_p=P, tag="dense-mask",
            kind="mask", model=m))
        names.append(f"{kind}_W{W}_{'macro' if macro else 'legacy'}")
    before = launch_counts()
    run = run_dense_groups(launches, model, timed=dev.type == "cuda")
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    want = {"dense_scan": len(specs),
            "mask_scan": len(launches) - len(specs)}
    if dev.type == "cuda" and launched != want:
        raise AssertionError(f"groups: launches {launched}, expected {want}")
    rows, max_err = 0, {"dense_scan": 0, "mask_scan": 0}
    for name, ln, ok in zip(names, launches, run.ok):
        if ln.kind == "mask":
            kernel = "mask_scan"
            plain = mask_scan_plain(ln.events, ln.n_slots, ln.macro_p,
                                    ln.n_events, model=ln.model)
        else:
            kernel = "dense_scan"
            plain = dense_scan_plain(ln.events, ln.val_of, ln.n_slots,
                                     macro_p=ln.macro_p,
                                     n_events=ln.n_events, model=model)
        plain = plain.cpu().numpy()
        err = int(np.abs(ok.astype(int) - plain.astype(int)).max())
        emit("groups", case=name, kind=ln.kind, rows=int(ln.events.shape[0]),
             events=int(ln.events.shape[1]),
             row_ints=int(ln.events.shape[2]), W=ln.n_slots,
             macro_p=ln.macro_p, valid=int(plain.sum()), max_abs_err=err)
        if err != 0 or plain.all() or not plain.any():
            raise AssertionError(f"groups/{name}: kernel disagrees with "
                                 f"the plain version, or one polarity only")
        rows += len(plain)
        max_err[kernel] = max(max_err[kernel], err)
    emit("groups_summary", groups=len(launches), rows_compared=rows,
         max_abs_err=max_err, launches=launched,
         kernel_ms_per_group=run.kernel_ms, span_ms=run.span_ms,
         seconds=time.perf_counter() - t0)
    return rows, max_err


def phase_profile(dev, model, histories):
    """Busy share of the card over one check, read from a torch.profiler
    trace: the union of the device events' intervals over the check's
    host wall (profiler on). A trace without device time fails the
    phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)

    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        check_histories(histories, model, device=dev)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and e.device_type == DeviceType.CUDA:
            by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + t / 1e3
    if not spans:
        raise AssertionError("profile: the trace holds no device time")
    share = busy / wall_us
    emit("profile", device_events=len(spans), device_busy_ms=busy / 1e3,
         check_wall_ms=wall_us / 1e3, busy_share=share,
         device_ms_by_name=by_name)
    return share


def suite_histories(kind: str, **kw):
    """The suite shape: N_HISTORIES histories of N_OPS ops, N_PROCS
    processes, crash_p CRASH_P, at most MAX_CRASHES crashes, seed SEED
    (`kw`: the generator's other arguments, e.g. value_range). Returns
    (histories, seconds to make them)."""
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_valid_history)

    t0 = time.perf_counter()
    rng = random.Random(SEED)
    hs = [random_valid_history(rng, kind, n_ops=N_OPS, n_procs=N_PROCS,
                               crash_p=CRASH_P, max_crashes=MAX_CRASHES,
                               **kw)
          for _ in range(N_HISTORIES)]
    return hs, time.perf_counter() - t0


def counter10_histories():
    """Counter histories at upstream's documented concurrency: N_OPS ops,
    COUNTER10_SHAPE, seed SEED + 10; the first N_HISTORIES whose window
    is within the mask cap (12). Returns (histories, histories drawn,
    windows of the drawn, seconds, the drawn histories beyond the cap
    — `wide_auto`'s input)."""
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_valid_history)
    from jepsen_jgroups_raft_tpu_torch.models import Counter
    from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import (
        MASK_DENSE_MAX_SLOTS)

    t0 = time.perf_counter()
    rng = random.Random(SEED + 10)
    n_procs, crash_p, crashes = COUNTER10_SHAPE
    m, kept, wide, windows = Counter(), [], [], {}
    while len(kept) < N_HISTORIES:
        h = random_valid_history(rng, "counter", n_ops=N_OPS, n_procs=n_procs,
                                 crash_p=crash_p, max_crashes=crashes)
        w = encode_history(h, m).n_slots
        windows[w] = windows.get(w, 0) + 1
        (kept if w <= MASK_DENSE_MAX_SLOTS else wide).append(h)
    return kept, sum(windows.values()), dict(sorted(windows.items())), \
        time.perf_counter() - t0, wide


def phase_mask_profile(dev, paths: dict):
    """The instrumented mask kernel (`mask_scan_profile`) on the main
    paths' own groups — the counter suite's W = 8 group, the queue group,
    the 10-process counter's W = 12 group — and on the queue group's
    first rows, one per SM sub-partition (the card's SMs × 4; the whole
    group puts two warps on most): per phase, the share of the
    SM cycles; ballots per closing FORCE and cycles per ballot. Its
    verdicts must equal the plain version's, its closing FORCEs the plain
    version's, and its ballots `mask_scan_plain`'s `ballots_lazy` (below
    the full tables' count)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        DenseLaunch, run_dense_groups)
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        MASK_PROFILE_FIELDS, mask_scan_profile)

    phases = ("ring", "latch", "legality", "sweep", "force")
    cycle_fields = [f"{p}_cycles" for p in phases]
    count_fields = [k for k in MASK_PROFILE_FIELDS if k not in cycle_fields]
    sub_partitions = (torch.cuda.get_device_properties(dev)
                      .multi_processor_count * SUB_PARTITIONS_PER_SM)

    def summed(prof):
        return dict(zip(MASK_PROFILE_FIELDS, prof.sum(0).cpu().tolist()))

    def profile(name, ln, model, plain_ok=None, g=None):
        ok, prof = mask_scan_profile(ln.events, ln.n_slots, ln.macro_p,
                                     ln.n_events, model=model)
        sync(dev)
        c = summed(prof)
        total = sum(c[k] for k in cycle_fields)
        B, M = int(ln.events.shape[0]), 1 << ln.n_slots
        full = None if g is None else \
            g["legal_steps"] * max(M // 32, 1) // M
        line = {
            "case": name, "model": model.name, "rows": B, "W": ln.n_slots,
            "sub_partitions": sub_partitions,
            "warps_per_subpartition": B / sub_partitions,
            "cycles": total, "cycles_per_row": total / max(c["rows"], 1),
            "share": {p: c[f"{p}_cycles"] / total for p in phases},
            **{k: c[k] for k in count_fields},
            "ballots_per_closure": c["ballots"] / max(c["closures"], 1),
            "full_ballots_per_closure": None if full is None
            else full / max(c["closures"], 1),
            "cycles_per_ballot": c["legality_cycles"] / max(c["ballots"], 1),
            "sweep_cycles_per_sweep": c["sweep_cycles"] / max(c["sweeps"], 1),
            "plain": None if g is None else {
                k: g[k] for k in ("closures", "ballots_lazy", "legal_needed",
                                  "legal_steps")},
            "ballots_full": full}
        emit("mask_profile", **line)
        if plain_ok is not None:
            if not torch.equal(ok.cpu(), plain_ok.cpu()):
                raise AssertionError(f"mask_profile/{name}: verdicts differ "
                                     f"from the plain version")
            if c["closures"] != g["closures"] or \
                    c["ballots"] != g["ballots_lazy"] or \
                    c["ballots"] > full:
                raise AssertionError(f"mask_profile/{name}: closing FORCEs "
                                     f"or ballots differ from the plain "
                                     f"version's count")
        return prof

    for path, W in (("counter_main", 8), ("queue_main", 8),
                    ("counter10_main", 12)):
        x = paths[path]
        ks = [k for k, ln in enumerate(x["groups"]) if ln.n_slots == W]
        if not ks:
            raise AssertionError(f"mask_profile: {path} has no W = {W} group")
        k = ks[0]
        ln, model = x["groups"][k], x["model"]
        prof = profile(f"{path}_W{W}", ln, model, x["plain_oks"][k],
                       x["group_stats"][k])
        if path != "queue_main":
            continue
        # the same first rows alone, at most one warp per sub-partition:
        # their cycles per ballot in the full group and alone, and both
        # launches' kernel times
        n = min(sub_partitions, int(ln.events.shape[0]))
        head = DenseLaunch(events=ln.events[:n].contiguous(),
                           val_of=ln.val_of[:n].contiguous(),
                           n_events=ln.n_events[:n].contiguous(),
                           n_slots=ln.n_slots, macro_p=ln.macro_p,
                           tag=ln.tag, kind=ln.kind)
        alone = profile(f"{path}_W{W}_first{n}", head, model)
        in_full, by_self = summed(prof[:n]), summed(alone)
        ms = {"all": [], "first": []}
        for _ in range(3):
            for key, grp in (("all", ln), ("first", head)):
                ms[key].append(run_dense_groups([grp], model,
                                                timed=True).kernel_ms[0])
        emit("mask_profile_contention", case=f"{path}_W{W}", rows_first=n,
             rows_all=int(ln.events.shape[0]),
             cycles_per_ballot_first_in_all=in_full["legality_cycles"]
             / max(in_full["ballots"], 1),
             cycles_per_ballot_first_alone=by_self["legality_cycles"]
             / max(by_self["ballots"], 1),
             cycles_per_row_first_in_all=sum(in_full[k] for k in cycle_fields)
             / max(in_full["rows"], 1),
             cycles_per_row_first_alone=sum(by_self[k] for k in cycle_fields)
             / max(by_self["rows"], 1),
             kernel_ms_all=min(ms["all"]), kernel_ms_first=min(ms["first"]))


def run_path(phase: str, dev, model, histories, synth_s: float, tier: str,
             kernel: str, ptxas: dict, n_ops: int = N_OPS) -> dict:
    """Drive one main path through check_histories on the card: a
    warm-up, then best of 3, each run with the launch counts set to 0
    just before it and read just after (the path's kernel must have
    launched). Guards: every history VALID (valid by construction),
    every row on `tier`. Then the breakdown of one run: encode, group +
    pack, the kernels overlapped (span, per group) and each group alone,
    ns per row, the plain version's time and bitwise agreement on the
    same groups, and the bound from the work this run's data needed.
    Emits the phase's line; returns the kernels-line numbers, and the
    groups' launches, plain stats and verdicts and times alone (for
    `phase_mask_profile`)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        DenseLaunch, consume_tiers, run_dense_groups)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        encode_history, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_plans_grouped, dense_scan_plain, launch_counts,
        mask_scan_plain, reset_launch_counts)

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
        if launches[kernel] <= 0:
            raise AssertionError(f"{phase}: the path launched no {kernel} "
                                 f"kernel")
    tiers = consume_tiers()
    n = len(histories)
    n_valid = sum(1 for r in results if r["valid?"] is True)
    host_rows = sum(1 for r in results if r.get("decided-tier") != tier)
    if n_valid != n:
        raise AssertionError(f"{phase} verdict guard: {n_valid} of {n} "
                             f"VALID (every history is valid by "
                             f"construction)")
    if host_rows or "host" in tiers:
        raise AssertionError(f"{phase}: {host_rows} rows left the {tier} "
                             f"tier")

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
        n_slots=plan.n_slots, macro_p=b["macro_p"], tag=plan.kernel_tag,
        kind=plan.kind)
        for b, (_, plan) in zip(batches, grouped)]
    group_ms, span_ms, alone_ms = None, None, None
    for _ in range(3):
        run = run_dense_groups(launch_list, model, timed=True)
        group_ms = run.kernel_ms if group_ms is None else \
            [min(a, b) for a, b in zip(group_ms, run.kernel_ms)]
        span_ms = run.span_ms if span_ms is None else \
            min(span_ms, run.span_ms)
        alone = [run_dense_groups([ln], model, timed=True).kernel_ms[0]
                 for ln in launch_list]
        alone_ms = alone if alone_ms is None else \
            [min(a, b) for a, b in zip(alone_ms, alone)]
    longest = [int(b["n_events"].max()) for b in batches]
    ns_per_row = [ms * 1e6 / r for ms, r in zip(alone_ms, longest)]
    scan_steps = int(sum(int(b["n_events"].sum()) for b in batches))

    # the plain version on the same groups: its time, bitwise agreement,
    # and the work this run's data needed (for the bound)
    plain_oks, group_stats = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ln in launch_list:
        g: dict = {}
        if ln.kind == "mask":
            plain_oks.append(mask_scan_plain(
                ln.events, ln.n_slots, ln.macro_p, ln.n_events, model=model,
                stats=g))
        else:
            plain_oks.append(dense_scan_plain(
                ln.events, ln.val_of, ln.n_slots, macro_p=ln.macro_p,
                n_events=ln.n_events, model=model, stats=g))
        group_stats.append(g)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((torch.from_numpy(k).int() - p.cpu().int()).abs().max())
              for k, p in zip(run.ok, plain_oks))
    if err != 0:
        raise AssertionError(f"{phase} groups: kernel disagrees with the "
                             f"plain version")

    # bound: the bytes the kernel must move (the real event rows and
    # n_events read once, val_of read once by the domain kernel, ok
    # written once) against the 32-bit integer operations this data
    # needed. The frontier is a bitset of M·S bits (S = 1 for a mask
    # group), so its passes count words: a closure pass, one operation
    # per word of its M/2 source masks' bits and per state plane (S);
    # a FORCE, one per word of the frontier. Latch: S² compares per
    # opened op (domain) or one per op (mask). The mask kernel's
    # legality is element-wise: LEGAL_STEP_OPS per (mask of the closed
    # frontier, open slot whose op is not always legal) of each closing
    # FORCE — the entries the closure can read, not the reference's
    # full tables
    bytes_moved, ops = 0, 0
    for ln, b, g in zip(launch_list, batches, group_stats):
        B, _, R = (int(x) for x in ln.events.shape)
        M = 1 << ln.n_slots
        n_opens = int(ln.events[:, :, 2].clamp(min=0).sum())
        bytes_moved += int(b["n_events"].sum()) * R * 4 + B * 5
        if ln.kind == "mask":
            ops += (g["slot_passes"] * max(M // 64, 1)
                    + g["force_rows"] * max(M // 32, 1)
                    + g["legal_needed"] * LEGAL_STEP_OPS[model.name]
                    + n_opens)
        else:
            S = int(ln.val_of.shape[1])
            bytes_moved += B * S * 4
            ops += (g["slot_passes"] * max(M * S // 64, 1) * S
                    + g["force_rows"] * max(M * S // 32, 1)
                    + n_opens * S * S)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / CORE_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    best = min(walls)
    stats = {k: sum(g.get(k, 0) for g in group_stats)
             for k in ("sweeps", "slot_passes", "force_rows", "closures",
                       "legal_steps", "legal_needed", "ballots_lazy")}
    emit(phase, model=model.name, histories=n, ops_per_history=n_ops,
         valid=n_valid, host_rows=host_rows, rest=len(rest),
         groups=len(grouped), kinds=sorted({p.kind for _, p in grouped}),
         windows=[int(p.n_slots) for _, p in grouped],
         group_rows=[len(i) for i, _ in grouped],
         states=[int(p.n_states) for _, p in grouped],
         macro_p=[int(b["macro_p"]) for b in batches],
         synth_s=synth_s, check_s_reps=walls, check_s_best=best,
         hist_per_s=n / best, encode_s=encode_s, pack_s=pack_s,
         kernel_span_ms=span_ms, kernel_ms_per_group=group_ms,
         kernel_ms_alone=alone_ms, kernel_ms_alone_sum=sum(alone_ms),
         longest_rows=longest, ns_per_row=ns_per_row,
         plain_ms=plain_ms, scan_steps=scan_steps,
         closure_sweeps=stats["sweeps"], slot_passes=stats["slot_passes"],
         force_rows=stats["force_rows"], closures=stats["closures"],
         legal_steps=stats["legal_steps"],
         legal_needed=stats["legal_needed"],
         ballots_lazy=stats["ballots_lazy"], bytes_moved=bytes_moved,
         word_ops=ops, bound_ms=bound_ms,
         bound_by="bytes" if t_bytes >= t_ops else "operations",
         spill_bytes=ptxas["spill_store_bytes"] + ptxas["spill_load_bytes"],
         max_registers=ptxas["max_registers"], launches=launches,
         tiers=tiers, device=torch.cuda.get_device_name(dev),
         power=nvidia_smi_line())
    return {"launches": int(launches[kernel]), "max_abs_err": err,
            "ms": span_ms, "plain_ms": plain_ms, "t_bytes": t_bytes,
            "t_ops": t_ops, "groups": launch_list, "group_stats": group_stats,
            "plain_oks": plain_oks, "ms_alone": alone_ms}


def phase_invalid(dev, model, bad, tier: str, kernel_plain, name: str):
    """Corrupted histories: kernel (check_encoded on the card), plain
    version (per group on the same device) and host oracle agree row for
    row, every row INVALID, every row on `tier`. Returns max |kernel -
    plain|."""
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_encoded)
    from jepsen_jgroups_raft_tpu_torch.checker.wgl_cpu import (
        check_encoded_cpu)
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_plans_grouped)

    bad_encs = [encode_history(h, model) for h in bad]
    res = check_encoded(bad_encs, model, device=dev)
    k_ok = [r["valid?"] is True for r in res]
    sub_groups, sub_rest = dense_plans_grouped(model, bad_encs)
    p_ok = [None] * len(bad_encs)
    for idxs, plan in sub_groups:
        ok_p = kernel_plain([bad_encs[i] for i in idxs], plan)
        for j, i in enumerate(idxs):
            p_ok[i] = bool(ok_p[j])
    o_ok = [check_encoded_cpu(e, model).valid for e in bad_encs]
    emit(name, rows=len(bad_encs), kernel_invalid=k_ok.count(False),
         plain_invalid=p_ok.count(False), oracle_invalid=o_ok.count(False),
         rest=len(sub_rest),
         tiers=sorted({r.get("decided-tier") for r in res}))
    if sub_rest or any(r.get("decided-tier") != tier for r in res):
        raise AssertionError(f"{name}: the subset left the {tier} tier")
    if k_ok != p_ok or k_ok != o_ok or any(k_ok):
        raise AssertionError(f"{name}: kernel, plain version and host "
                             f"oracle disagree, or a corrupted row passed")
    return 0


def sort_histories(rng, kind: str, W: int, n: int):
    """n histories for sort window W: random ones with windows up to W
    (up to 5 processes, the rest crashed ops) and bursts (every op open
    at once) that reach W; odd ones corrupted."""
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        burst_history, random_valid_history)

    vr = {"value_range": SET_VALUE_RANGE} if kind == "set" else {}
    hs = []
    if W <= 16:
        hs = [random_valid_history(rng, kind, n_ops=24, n_procs=min(W, 5),
                                   crash_p=0.3 if W > 5 else 0.1,
                                   max_crashes=max(W - 5, 0), **vr)
              for _ in range(n - 1)]
    for j in range(n - len(hs)):
        hs.append(burst_history(rng, kind, max(W - 3 * j, 1), **vr))
    bad = (corrupt_list_read if kind == "list-append" else
           (lambda h, r: corrupt_observation(h, r, 1)))
    return [bad(h, rng) if i % 2 else list(h) for i, h in enumerate(hs)]


def corrupt_list_read(ops, rng):
    """A list-append history with one ok read made to observe a list it
    never held: its last element dropped ([1] for an empty list)."""
    ops = list(ops)
    idx = [j for j, op in enumerate(ops) if op.type == "ok"
           and op.f == "read"]
    if idx:
        j = rng.choice(idx)
        v = list(ops[j].value)
        ops[j] = ops[j].replace(value=v[:-1] if v else [1])
    return ops


def phase_sort_kernel(dev):
    """sort_scan against sort_scan_plain, bitwise on both flags: the five
    models (list-append included) at every window of SORT_WINDOWS (C cycling through SORT_CAPS,
    the row format alternating), short histories with C near their
    frontier (both formats), and arbitrary rows. Returns (rows compared,
    max |kernel - plain|, {rows that overflowed and ended ok, and not})."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_mask_rows, random_valid_history)
    from jepsen_jgroups_raft_tpu_torch.models import MODELS
    from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import (
        bucket_slots, sort_scan, sort_scan_plain)

    rng = random.Random(SEED + 7)
    kinds = {"set": "set", "counter": "counter", "register": "cas-register",
             "queue": "queue", "list-append": "list-append"}
    compared, max_err = 0, 0
    overflowed = {"ok": 0, "not_ok": 0}

    def check(name, ev, ne, W, C, P, model):
        nonlocal compared, max_err
        ok_k, of_k = sort_scan(ev, W, C, P, ne, model=model)
        sync(dev)
        ok_p, of_p = sort_scan_plain(ev, W, C, P, ne, model=model)
        err = max(int((ok_k.int() - ok_p.int()).abs().max()),
                  int((of_k.int() - of_p.int()).abs().max()))
        emit("sort_kernel", case=name, model=model.name,
             rows=int(ev.shape[0]), events=int(ev.shape[1]),
             row_ints=int(ev.shape[2]), W=W, C=C, macro_p=P,
             valid=int(ok_p.sum()), overflow=int(of_p.sum()),
             overflow_ok=int((of_p & ok_p).sum()), max_abs_err=err)
        if err != 0:
            raise AssertionError(f"sort_kernel/{name}: kernel disagrees "
                                 f"with the plain version")
        compared += int(ev.shape[0])
        max_err = max(max_err, err)
        return ok_p, of_p

    def tensors(encs, macro):
        ev, ne, P = mask_tensors(encs, macro, dev)
        return ev, ne, P, max(e.n_slots for e in encs)

    for k, (kind, key) in enumerate(kinds.items()):
        m = MODELS[key]()
        for i, W in enumerate(SORT_WINDOWS):
            C = SORT_CAPS[(i + k) % len(SORT_CAPS)]
            encs = [encode_history(h, m)
                    for h in sort_histories(rng, kind, W, 6)]
            for macro in ((i + k) % 2 == 1,):
                ev, ne, P, widest = tensors(encs, macro)
                if widest > W or (bucket_slots(widest) != W and
                                  kind != "register"):
                    raise AssertionError(f"sort_kernel: {kind} W={W} "
                                         f"histories reach {widest}")
                check(f"{kind}_W{W}_C{C}_{'macro' if macro else 'legacy'}",
                      ev, ne, W, C, P, m)
        # the 12-op shape: frontiers near C, so rows overflow and some
        # still end ok
        srng = random.Random(11)
        encs = [encode_history(random_valid_history(
            srng, kind, n_ops=12, n_procs=4, crash_p=0.0, max_crashes=0), m)
            for _ in range(64)]
        for C in (4, 8):
            for macro in (False, True):
                ev, ne, P, widest = tensors(encs, macro)
                ok_p, of_p = check(f"{kind}_12ops_C{C}_"
                                   f"{'macro' if macro else 'legacy'}",
                                   ev, ne, bucket_slots(widest), C, P, m)
                overflowed["ok"] += int((of_p & ok_p).sum())
                overflowed["not_ok"] += int((of_p & ~ok_p).sum())
    B, E = 32, 32
    for kind, key, init in (("counter", "counter", None),
                            ("queue", "queue", None), ("set", "set", None),
                            ("register", "cas-register", None),
                            ("counter", "counter", 2**31 - 3),
                            ("list-append", "list-append", None)):
        m = MODELS[key]() if init is None else MODELS[key](init)
        for i, W in enumerate((1, 6, 12, 40, 127)):
            P = (None, 3, 16)[i % 3]
            nrng = np.random.default_rng(SEED + 10 * W + (P or 0))
            ev = random_mask_rows(nrng, B, E, W, P, kind)
            n_events = nrng.integers(0, E + 1, size=B, dtype=np.int32)
            ev[np.arange(E)[None, :] >= n_events[:, None]] = 0
            check(f"rows_{kind}_{int(m.init_state())}_W{W}_P{P}",
                  torch.from_numpy(ev).to(dev),
                  torch.from_numpy(n_events).to(dev), W,
                  64 if W <= 12 else 4, P, m)
    if not overflowed["ok"] or not overflowed["not_ok"]:
        raise AssertionError(f"sort_kernel: rows that overflowed and ended "
                             f"ok / not ok: {overflowed}; both expected")
    return compared, max_err, overflowed


def plain_ladder(encs, model, dev, stats=None):
    """The sort ladder's verdicts from the plain version: per row True
    (ok at a rung), False (not ok, no overflow) or None (overflowed at the
    top rung). Returns (verdicts, per rung (rows, plain ms, ok, overflow))."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        SORT_LADDER)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import (
        bucket_slots, sort_scan_plain)

    W = bucket_slots(max(e.n_slots for e in encs))
    verdicts = [None] * len(encs)
    remaining, rungs = list(range(len(encs))), []
    for C in SORT_LADDER:
        b = pack_macro_batch([encs[i] for i in remaining])
        ev = torch.from_numpy(b["events"]).to(dev)
        ne = torch.from_numpy(b["n_events"]).to(dev)
        sync(dev)
        t0 = time.perf_counter()
        ok, of = sort_scan_plain(ev, W, C, b["macro_p"], ne, model=model,
                                 stats=stats)
        ok, of = ok.cpu().numpy(), of.cpu().numpy()
        rungs.append((len(remaining), (time.perf_counter() - t0) * 1e3, ok,
                      of))
        escalate = []
        for j, i in enumerate(remaining):
            if ok[j] or not of[j]:
                verdicts[i] = bool(ok[j])
            else:
                escalate.append(i)
        remaining = escalate
        if not remaining:
            break
    return verdicts, rungs


def run_sort_path(phase: str, dev, model, histories, synth_s: float,
                  ptxas: dict, **extra) -> dict:
    """A ladder path (the set, list-append) through check_histories on
    the card, as `run_path` measures the others: warm-up, best of 3 with the launch counts set to
    0 just before each run and read just after; guards: every history
    VALID, every row on the sort tier, 0 host rows, sort_scan launched.
    Then the ladder's breakdown: encode, pack, each rung's rows, kernel
    ms (CUDA events, best of 3) and ns per row, escalations, the plain
    version's time and bitwise flags on the same rungs, and the bound
    from the work this run's data needed. Returns the kernels-line
    numbers."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        SORT_LADDER, check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        consume_tiers, run_sort_rung)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        encode_history, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

    check_histories(histories, model, device=dev)  # warm-up
    consume_tiers()
    walls, launches = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        ds.reset_launch_counts()
        ls.reset_launch_counts()
        t0 = time.perf_counter()
        results = check_histories(histories, model, device=dev)
        walls.append(time.perf_counter() - t0)
        launches = {**ds.launch_counts(), **ls.launch_counts()}
        if launches["sort_scan"] <= 0:
            raise AssertionError(f"{phase}: the path launched no sort_scan "
                                 f"kernel")
    tiers = consume_tiers()
    n = len(histories)
    n_valid = sum(1 for r in results if r["valid?"] is True)
    off_tier = sum(1 for r in results if r.get("decided-tier") != "sort")
    if n_valid != n:
        raise AssertionError(f"{phase} verdict guard: {n_valid} of {n} "
                             f"VALID (every history is valid by "
                             f"construction)")
    if off_tier or "host" in tiers:
        raise AssertionError(f"{phase}: {off_tier} rows left the sort tier")

    t0 = time.perf_counter()
    encs = [encode_history(h, model) for h in histories]
    encode_s = time.perf_counter() - t0
    W = ls.bucket_slots(max(e.n_slots for e in encs))
    windows = {}
    for e in encs:
        windows[e.n_slots] = windows.get(e.n_slots, 0) + 1
    remaining, rungs, pack_s = list(range(n)), [], 0.0
    bytes_moved = 0
    for C in SORT_LADDER:
        t0 = time.perf_counter()
        b = pack_macro_batch([encs[i] for i in remaining])
        pack_s += time.perf_counter() - t0
        ev = torch.from_numpy(b["events"]).to(dev)
        ne = torch.from_numpy(b["n_events"]).to(dev)
        ms = []
        for _ in range(3):
            run = run_sort_rung(ev, ne, W, C, b["macro_p"], model,
                                timed=True)
            ms.append(run.kernel_ms)
        B, _, R = (int(x) for x in ev.shape)
        bytes_moved += int(b["n_events"].sum()) * R * 4 + B * 4 + 2 * B
        longest = int(b["n_events"].max())
        escalate = [i for j, i in enumerate(remaining)
                    if not run.ok[j] and run.overflow[j]]
        rungs.append({"C": C, "rows": B, "macro_p": int(b["macro_p"]),
                      "events": int(ev.shape[1]), "longest_rows": longest,
                      "kernel_ms_reps": ms, "kernel_ms": min(ms),
                      "ns_per_row": min(ms) * 1e6 / longest,
                      "valid": int(run.ok.sum()),
                      "overflow": int(run.overflow.sum()),
                      "escalated": len(escalate),
                      "ok": run.ok, "overflow_flags": run.overflow})
        remaining = escalate
        if not remaining:
            break
    # the plain version on the same rungs: time, bitwise flags, and the
    # work the data needed
    g: dict = {}
    _, plain = plain_ladder(encs, model, dev, stats=g)
    err = 0
    for r, (rows, p_ms, p_ok, p_of) in zip(rungs, plain):
        r["plain_ms"] = p_ms
        err = max(err, int(np.abs(r.pop("ok").astype(int)
                                  - p_ok.astype(int)).max()),
                  int(np.abs(r.pop("overflow_flags").astype(int)
                             - p_of.astype(int)).max()))
    if err != 0 or len(plain) != len(rungs):
        raise AssertionError(f"{phase} rungs: kernel disagrees with the "
                             f"plain version")
    # bound: the event rows and n_events read once and both flags written
    # once per rung, against the operations this data needed: per closure
    # round, a model step per (live configuration, open slot) and one
    # dedup probe per legal candidate (the plain version's count)
    ops = g["steps"] + g["candidates"]
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / CORE_OPS_PER_S
    best = min(walls)
    ms_total = sum(r["kernel_ms"] for r in rungs)
    plain_ms = sum(r["plain_ms"] for r in rungs)
    emit(phase, model=model.name, histories=n, ops_per_history=N_OPS,
         **extra, valid=n_valid, host_rows=off_tier,
         windows=dict(sorted(windows.items())), kernel_window=W,
         synth_s=synth_s, check_s_reps=walls, check_s_best=best,
         hist_per_s=n / best, encode_s=encode_s, pack_s=pack_s,
         rungs=rungs, kernel_ms=ms_total, plain_ms=plain_ms,
         plain_stats=g, bytes_moved=bytes_moved, ops=ops,
         bound_ms=max(t_bytes, t_ops) * 1e3,
         bound_by="bytes" if t_bytes >= t_ops else "operations",
         spill_bytes=ptxas["spill_store_bytes"] + ptxas["spill_load_bytes"],
         max_registers=ptxas["max_registers"], launches=launches,
         tiers=tiers, device=torch.cuda.get_device_name(dev),
         power=nvidia_smi_line())
    return {"launches": int(launches["sort_scan"]), "max_abs_err": err,
            "ms": ms_total, "plain_ms": plain_ms, "t_bytes": t_bytes,
            "t_ops": t_ops}


def corrupt_set_read(ops, rng):
    """The first ok read invoked after some add of element e completed,
    with e dropped from what it observed: no linearization explains it
    (the add takes effect before the read begins, and a set only grows).
    Only a drop that changes the read's encoded mask counts: the model
    encodes element 31 as the int32 clamp 0x7FFFFFFF (as the reference
    does), which hides every other element of a membership holding 31.
    Returns (ops, changed)."""
    from jepsen_jgroups_raft_tpu_torch.models.setmodel import element_mask

    ops = list(ops)
    done, seen_at = set(), {}
    for j, op in enumerate(ops):
        if op.type == "invoke" and op.f == "read":
            seen_at[op.process] = set(done)
        elif op.type == "ok" and op.f == "add":
            done.add(op.value)
        elif op.type == "ok" and op.f == "read":
            drops = [e for e in sorted(seen_at.get(op.process, ()))
                     if element_mask(sorted(set(op.value) - {e}))
                     != element_mask(op.value)]
            if drops:
                e = rng.choice(drops)
                ops[j] = op.replace(value=sorted(set(op.value) - {e}))
                return ops, True
    return ops, False


def phase_set_invalid(dev, histories):
    """Set histories with one impossible read: the kernel (check_encoded
    on the card), the plain ladder and the host oracle agree row for row,
    every row INVALID and on the sort tier. Returns max |kernel - plain|."""
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_encoded)
    from jepsen_jgroups_raft_tpu_torch.checker.wgl_cpu import (
        check_encoded_cpu)
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.models import GSet

    model = GSet()
    rng = random.Random(SEED + 6)
    bad = []
    for h in histories[:N_INVALID]:
        ops_, changed = corrupt_set_read(h, rng)
        if not changed:
            raise AssertionError("a set history without a read after a "
                                 "completed add")
        bad.append(ops_)
    encs = [encode_history(h, model) for h in bad]
    res = check_encoded(encs, model, device=dev)
    k_ok = [r["valid?"] for r in res]
    p_ok, _ = plain_ladder(encs, model, dev)
    o_ok = [check_encoded_cpu(e, model).valid for e in encs]
    emit("set_invalid", rows=len(encs), kernel_invalid=k_ok.count(False),
         plain_invalid=p_ok.count(False), oracle_invalid=o_ok.count(False),
         tiers=sorted({r.get("decided-tier") for r in res}))
    if any(r.get("decided-tier") != "sort" for r in res):
        raise AssertionError("set_invalid: a row left the sort tier")
    if k_ok != p_ok or k_ok != o_ok or any(k_ok):
        raise AssertionError("set_invalid: kernel, plain version and host "
                             "oracle disagree, or a corrupted row passed")
    return 0


#: the reference suite's long-history configurations (bench.py:998-1009):
#: 4 — 16 register histories of 10k ops (crash_p 0.02, ≤ 4 crashes);
#: 5 — one register history of 100k ops (crash_p 0.01, ≤ 4 crashes),
#: BASELINE.json's "long-history stress"; 5 processes each
LONG_CONFIGS = {"config5": (1, 100_000, 0.01, 4),
                "config4": (16, 10_000, 0.02, 4)}
#: long_main also times both arms on the first 1, 2, 4 and 8 histories of
#: config 4: with config 4's 16, the row counts behind
#: `SEGMENT_MAX_LONG_ROWS`, the card's routing default
LONG_SWEEP_ROWS = (1, 2, 4, 8)
#: segment_kernel: rows per segment — the configs' E_seg at the windows
#: their histories reach (W = 7..10), a quarter of it below (the plain
#: version, a Python loop per row, is the phase's cost) — and segments
SEGMENT_KERNEL_ROWS = 2048
SEGMENT_KERNEL_FULL_W = 7
SEGMENT_KERNEL_K = 4
#: wide_auto: the first histories of the drawn W > 12 set (all 405 took
#: 414 s of host DFS on the H100's host, 64 took 72.5 s: past the
#: script's time budget; 16 since the cycle and anomaly phases came;
#: PERF.md §4)
WIDE_AUTO_ROWS = 16
#: wide_auto also checks rows the fast DFS cannot decide, so that auto
#: sends them to the sort ladder on the card: INVALID counter chains
#: (history/synth.chained_bursts) of (window, bursts, seed); at window
#: 20 and 400 bursts (16k events) the fast DFS runs out and the ladder
#: decides at C = 256
WIDE_AUTO_CHAINS = ((20, 400, 1), (20, 400, 2))
#: lin_fastpath: rows of the north-star batch, as the reference's row
#: (bench.py:752-807) caps them
LIN_FASTPATH_ROWS = 256


def phase_segment_kernel(dev):
    """segment_scan against its plain version, bitwise on every bit of
    the final frontiers: every window W = 1..10 at the largest S the caps
    allow (and W = 3 / S = 1), segments of SEGMENT_KERNEL_ROWS rows from
    W = SEGMENT_KERNEL_FULL_W up and a quarter of that below, crash sets
    of 0..4 slots, dead seeds, mixed real lengths. Returns
    (runs compared, live runs, max |kernel - plain|)."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_segment_inputs)
    from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss

    runs = live = err = 0
    cases = [(W, min(16, 8192 >> W)) for W in range(1, 11)] + [(3, 1)]
    for W, S in cases:
        c = W % 5 if W > 4 else min(W, (W * 3) % 5)
        E = SEGMENT_KERNEL_ROWS if W >= SEGMENT_KERNEL_FULL_W and S > 1 \
            else SEGMENT_KERNEL_ROWS // 4
        # reads and cas that miss, and rows with a slot out of range, at
        # rates low enough that many 2048-row runs keep a frontier
        ev, vals, sm, st, ne = (torch.from_numpy(a).to(dev) for a in
                                random_segment_inputs(
                                    np.random.default_rng(SEED + 100 * W),
                                    SEGMENT_KERNEL_K, E, W, S, c,
                                    bad_read=0.0005, stray=0.0005))
        F = ss.segment_scan(ev, vals, sm, st, W, ne)
        plain = ss.segment_scan_plain(ev, vals, sm, st, W, ne)
        sync(dev)
        e = int((F.int() - plain.int()).abs().max())
        err = max(err, e)
        runs += F.shape[0] * F.shape[1]
        live += int(plain.flatten(2).any(dim=2).sum())
        emit("segment_kernel_case", W=W, S=S, crashed=c, rows=E,
             runs=F.shape[0] * F.shape[1], max_abs_err=e,
             live_runs=int(plain.flatten(2).any(dim=2).sum()),
             bits_set=int(plain.sum()))
        if e:
            raise AssertionError(f"segment_kernel W={W} S={S}: kernel "
                                 f"disagrees with the plain version")
    if not live:
        raise AssertionError("segment_kernel: no run kept a frontier")
    return runs, live, err


def long_histories(name: str):
    """Suite config 4 or 5 (LONG_CONFIGS), seeded from SEED. Returns
    (histories, seconds)."""
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_valid_history)

    n, n_ops, crash_p, crashes = LONG_CONFIGS[name]
    t0 = time.perf_counter()
    rng = random.Random(SEED + (5 if name == "config5" else 4))
    hs = [random_valid_history(rng, "register", n_ops=n_ops, n_procs=N_PROCS,
                               crash_p=crash_p, max_crashes=crashes)
          for _ in range(n)]
    return hs, time.perf_counter() - t0


def reset_all_launch_counts() -> None:
    from jepsen_jgroups_raft_tpu_torch.ops import (dense_scan,
                                                   election_safety,
                                                   linear_scan,
                                                   segment_scan)

    for mod in (dense_scan, linear_scan, segment_scan, election_safety):
        mod.reset_launch_counts()


def all_launch_counts() -> dict:
    from jepsen_jgroups_raft_tpu_torch.ops import (dense_scan,
                                                   election_safety,
                                                   linear_scan,
                                                   segment_scan)

    return {**dense_scan.launch_counts(), **linear_scan.launch_counts(),
            **segment_scan.launch_counts(),
            **election_safety.launch_counts()}


def with_env(name: str, value, fn):
    """fn() with environment variable `name` set to `value` (None:
    unset), restored afterwards."""
    import os

    prior = os.environ.get(name)
    try:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        return fn()
    finally:
        if prior is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prior


def run_long_arm(dev, model, hs, arm: str) -> dict:
    """check_histories on the card with JGRAFT_SEGMENT=arm: a warm-up,
    then best of 3, the launch counts set to 0 just before each run and
    read just after. Guards: every history VALID; the segmented arm
    decides every row as "dense-seg" with more than one segment and
    launches segment_scan; the monolithic arm decides them on the dense
    tier and launches dense_scan."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)

    def go():
        check_histories(hs, model, device=dev)  # warm-up
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            reset_all_launch_counts()
            t0 = time.perf_counter()
            rs = check_histories(hs, model, device=dev)
            walls.append(time.perf_counter() - t0)
            launches = all_launch_counts()
        return walls, rs, launches

    walls, rs, launches = with_env("JGRAFT_SEGMENT", arm, go)
    kernel = "dense-seg" if arm == "1" else "dense"
    lib = "segment_scan" if arm == "1" else "dense_scan"
    if not all(r["valid?"] is True for r in rs):
        raise AssertionError(f"long_main arm {arm}: a history is not VALID")
    if any(r.get("kernel") != kernel or r.get("decided-tier") != "dense"
           for r in rs):
        raise AssertionError(f"long_main arm {arm}: a row left {kernel}: "
                             f"{[r.get('kernel') for r in rs]}")
    if arm == "1" and not all(r["segments"] > 1 for r in rs):
        raise AssertionError("long_main: a history ran as one segment")
    if launches[lib] <= 0:
        raise AssertionError(f"long_main arm {arm}: no {lib} launch")
    return {"walls": walls, "best": min(walls), "launches": launches,
            "segments": [r.get("segments") for r in rs]}


def phase_long_main(dev) -> dict:
    """Suite configs 5 and 4 through check_histories on the card, the
    segmented arm (JGRAFT_SEGMENT=1) and the monolithic one (=0), best of
    3 each; then, for config 5, the segmented path's own kernel inputs:
    encode / plan / kernel / compose times, segment_scan alone (CUDA
    events, best of 3) against its plain version on the same tensors
    (bitwise on every table bit, with the work it did), and the bound.
    Returns the kernels-line numbers of segment_scan (config 5), and
    config 5's history and tables for `long_invalid`."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        SEGMENT_MAX_LONG_ROWS, check_histories)
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister
    from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss

    model = CasRegister()
    out = {}
    for name in ("config5", "config4"):
        hs, synth_s = long_histories(name)
        t0 = time.perf_counter()
        encs = [encode_history(h, model) for h in hs]
        encode_s = time.perf_counter() - t0
        arms = {arm: run_long_arm(dev, model, hs, arm) for arm in ("1", "0")}
        # JGRAFT_SEGMENT unset: the card's default routing, segmented for
        # up to SEGMENT_MAX_LONG_ROWS long rows (config 5), monolithic
        # beyond (config 4)
        default = with_env("JGRAFT_SEGMENT", None, lambda: check_histories(
            hs, model, device=dev))
        want = "dense-seg" if len(hs) <= SEGMENT_MAX_LONG_ROWS else "dense"
        if {r.get("kernel") for r in default} != {want}:
            raise AssertionError(f"long_main {name}: the default routing "
                                 f"did not take {want}")
        stats: dict = {}
        ss.check_segmented_batch(encs, model, device=dev, stats=stats)
        batch = ss.prepare_segment_batch(encs, model, device=dev)
        line = {"config": name, "histories": len(hs),
                "ops_per_history": LONG_CONFIGS[name][1],
                "events": [e.n_events for e in encs],
                "windows": sorted({e.n_slots for e in encs}),
                "synth_s": synth_s, "encode_s": encode_s,
                "segmented_s_reps": arms["1"]["walls"],
                "segmented_s_best": arms["1"]["best"],
                "monolithic_s_reps": arms["0"]["walls"],
                "monolithic_s_best": arms["0"]["best"],
                "segmented_over_monolithic":
                    arms["1"]["best"] / arms["0"]["best"],
                "segments": arms["1"]["segments"],
                "launches_segmented": arms["1"]["launches"],
                "launches_monolithic": arms["0"]["launches"],
                "plan_s": stats.get("plan_s"),
                "kernel_and_copy_s": stats.get("kernel_s"),
                "compose_s": stats.get("compose_s"),
                "K": int(batch.events.shape[0]), "NB": batch.NB,
                "W": batch.W, "S": batch.S, "E_seg": batch.E_seg}
        if name == "config4":
            line["rows_sweep"] = {
                n: {arm_name: run_long_arm(dev, model, hs[:n], arm)["best"]
                    for arm_name, arm in (("segmented_s_best", "1"),
                                          ("monolithic_s_best", "0"))}
                for n in LONG_SWEEP_ROWS}
        if name == "config5":
            ev, vo, sm, st, ne = batch.tensors(dev)
            times = []
            for _ in range(3):
                a, b = torch.cuda.Event(True), torch.cuda.Event(True)
                a.record()
                F = ss.segment_scan(ev, vo, sm, st, batch.W, ne, model)
                b.record()
                sync(dev)
                times.append(a.elapsed_time(b))
            g: dict = {}
            sync(dev)
            t0 = time.perf_counter()
            plain = ss.segment_scan_plain(ev, vo, sm, st, batch.W, ne, model,
                                          stats=g)
            sync(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = int((F.int() - plain.int()).abs().max())
            if err:
                raise AssertionError("long_main config5: segment_scan "
                                     "disagrees with its plain version")
            verdict = ss.compose_segment_tables(batch, F.cpu().numpy())
            if [r["valid"] for r in verdict] != [True]:
                raise AssertionError("long_main config5: composed tables "
                                     "not VALID")
            # bound: the segments' real rows (5 int32 each), n_events,
            # val_of and the seeds read once, the packed tables written
            # once; operations as the plain version counted them over
            # the runs still alive (a closure pass: one per word of the
            # M·S/2 source bits per state plane; a FORCE, one per
            # frontier word; a latch, S² compares)
            M, S = 1 << batch.W, batch.S
            K, NB = int(ev.shape[0]), int(sm.shape[1])
            words = ss.segment_words(batch.W, (S - 1).bit_length())
            bytes_moved = (int(ne.sum()) * 20 + K * 4 + K * S * 4
                           + K * NB * 8 + K * NB * words * 4)
            ops = (g["slot_passes"] * max(M * S // 64, 1) * S
                   + g["force_rows"] * max(M * S // 32, 1)
                   + g["opens"] * S * S)
            t_bytes = bytes_moved / HBM_BYTES_PER_S
            t_ops = ops / CORE_OPS_PER_S
            line.update(kernel_ms_reps=times, kernel_ms=min(times),
                        plain_ms=plain_ms, max_abs_err=err,
                        runs=K * NB,
                        live_runs=int(plain.flatten(2).any(dim=2).sum()),
                        plain_stats=g, bytes_moved=bytes_moved,
                        word_ops=ops, bound_ms=max(t_bytes, t_ops) * 1e3,
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
            out["line"] = {"launches": int(
                arms["1"]["launches"]["segment_scan"]), "max_abs_err": err,
                "ms": min(times), "plain_ms": plain_ms, "t_bytes": t_bytes,
                "t_ops": t_ops}
            out["config5"] = hs[0]
        emit("long_main", **line, device=torch.cuda.get_device_name(dev),
             power=nvidia_smi_line())
    return out


def late_corrupt_read(ops, rng, bump: int):
    """Raise one ok read among the last tenth of a history by `bump`
    (VALUE_RANGE + 1 moves it outside the domain); returns ops."""
    ops = list(ops)
    reads = [j for j, op in enumerate(ops) if j >= len(ops) * 9 // 10
             and op.type == "ok" and op.f == "read" and op.value is not None]
    if not reads:
        raise AssertionError("no late ok read to corrupt")
    j = rng.choice(reads)
    ops[j] = ops[j].replace(value=ops[j].value + bump)
    return ops


def phase_long_invalid(dev, history) -> int:
    """Config 5's history with one late read moved outside the domain:
    INVALID on the segmented arm, on the monolithic arm and on the plain
    version of the segmented path (segment_scan_plain's tables, composed
    on the host). Returns max |kernel - plain| over the tables."""
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister
    from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss

    model = CasRegister()
    bad = late_corrupt_read(history, random.Random(SEED + 7),
                            VALUE_RANGE + 1)
    arms = {}
    for arm in ("1", "0"):
        [r] = with_env("JGRAFT_SEGMENT", arm, lambda: check_histories(
            [bad], model, device=dev))
        arms[arm] = (r["valid?"], r.get("kernel"), r.get("segments"))
    batch = ss.prepare_segment_batch([encode_history(bad, model)], model,
                                     device=dev)
    ev, vo, sm, st, ne = batch.tensors(dev)
    F = ss.segment_scan(ev, vo, sm, st, batch.W, ne, model)
    plain = ss.segment_scan_plain(ev, vo, sm, st, batch.W, ne, model)
    err = int((F.int() - plain.int()).abs().max())
    [p] = ss.compose_segment_tables(batch, plain.cpu().numpy())
    emit("long_invalid", segmented=arms["1"], monolithic=arms["0"],
         plain_valid=p["valid"], segments=p["segments"], max_abs_err=err)
    if arms["1"][:2] != (False, "dense-seg") or \
            arms["0"][:2] != (False, "dense") or p["valid"] or err:
        raise AssertionError("long_invalid: an arm or the plain version "
                             "did not answer INVALID, or the tables differ")
    return err


def phase_wide_auto(dev, wide):
    """The first WIDE_AUTO_ROWS of the 10-process counter histories that
    counter10_main drops (W > 12) through check_histories under auto on
    the card: all VALID, none UNKNOWN; the tier counts and the wall.
    Then the WIDE_AUTO_CHAINS rows, which the fast DFS cannot decide:
    all INVALID on the sort tier under auto, with sort_scan launched,
    as the full-budget DFS answers on the host."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.dfs_cpu import (
        check_encoded_dfs)
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        DEFAULT_DFS_BUDGET, check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import consume_tiers
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import chained_bursts
    from jepsen_jgroups_raft_tpu_torch.models import Counter

    drawn = len(wide)
    wide = wide[:WIDE_AUTO_ROWS]
    consume_tiers()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    rs = check_histories(wide, Counter(), device=dev)
    wall = time.perf_counter() - t0
    tiers = consume_tiers()
    by = {}
    for r in rs:
        key = f"{r.get('algorithm')}/{r.get('decided-tier')}"
        by[key] = by.get(key, 0) + 1
    n_valid = sum(1 for r in rs if r["valid?"] is True)
    n_unknown = sum(1 for r in rs if r["valid?"] == "unknown")
    emit("wide_auto", histories=len(rs), drawn_wide=drawn, valid=n_valid,
         unknown=n_unknown,
         windows=sorted({r.get("concurrency-window") for r in rs}),
         algorithm_tier=by, tiers=tiers, check_s=wall,
         launches=all_launch_counts(),
         device=torch.cuda.get_device_name(dev))
    if n_valid != len(rs) or n_unknown:
        raise AssertionError(f"wide_auto: {n_valid} VALID and {n_unknown} "
                             f"UNKNOWN of {len(rs)}")

    chains = [chained_bursts(random.Random(SEED + seed), w, n, off=1)
              for w, n, seed in WIDE_AUTO_CHAINS]
    consume_tiers()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    rs = check_histories(chains, Counter(), device=dev)
    wall = time.perf_counter() - t0
    launches = all_launch_counts()
    t0 = time.perf_counter()
    host = [check_encoded_dfs(encode_history(h, Counter()), Counter(),
                              max_steps=DEFAULT_DFS_BUDGET).valid
            for h in chains]
    host_s = time.perf_counter() - t0
    view = [(r["valid?"], r.get("decided-tier")) for r in rs]
    emit("wide_auto_chains", histories=len(rs),
         windows=[r.get("concurrency-window") for r in rs],
         events=[encode_history(h, Counter()).n_events for h in chains],
         verdict_tier=view, host_dfs=host, check_s=wall, host_dfs_s=host_s,
         tiers=consume_tiers(), launches=launches)
    if view != [(False, "sort")] * len(rs) or any(host) or \
            not launches.get("sort_scan"):
        raise AssertionError("wide_auto: a chain was not INVALID on the "
                             "sort tier, the host DFS disagreed, or "
                             "sort_scan was never launched")


def phase_lin_fastpath(dev, histories):
    """The first LIN_FASTPATH_ROWS north-star histories through
    check_encoded on the card, the gate's store in a fresh directory
    under build/: with JGRAFT_LIN_FASTPATH at 0 (warm-up, then one
    timed run), then with it unset (the default) twice — the first run
    on an empty gate tries the host certifier, the second routes by what
    the first measured (certify wall per row against hit rate × the
    device's wall per row). Verdicts identical; certified, gated and
    kernel rows and the walls of every run."""
    import shutil
    from pathlib import Path

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_encoded, consume_fastpath_counters)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import consume_tiers
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister

    model = CasRegister()
    encs = [encode_history(h, model)
            for h in histories[:LIN_FASTPATH_ROWS]]
    store = Path(__file__).resolve().parent / "build" / "chip_smoke_autotune"
    shutil.rmtree(store, ignore_errors=True)

    def timed():
        consume_tiers()
        consume_fastpath_counters()
        t0 = time.perf_counter()
        rs = check_encoded(encs, model, device=dev)
        dt = time.perf_counter() - t0
        fp = consume_fastpath_counters()
        return {"s": dt, "rs": rs, "tiers": consume_tiers(),
                "certified_rows": fp["rows_certified"],
                "scanned_rows": fp["rows_scanned"],
                "gated_rows": fp["rows_gated"],
                "certify_wall_s": fp["certify_wall_s"],
                "kernel_rows": sum(1 for r in rs
                                   if r.get("algorithm") == "torch")}

    def off():
        check_encoded(encs, model, device=dev)  # warm-up
        return timed()

    def default():
        return [timed(), timed()]

    runs = {}
    runs["off"] = with_env("JGRAFT_AUTOTUNE_STORE", str(store),
                           lambda: with_env("JGRAFT_LIN_FASTPATH", "0", off))
    runs["first"], runs["second"] = with_env(
        "JGRAFT_AUTOTUNE_STORE", str(store),
        lambda: with_env("JGRAFT_LIN_FASTPATH", None, default))
    shutil.rmtree(store, ignore_errors=True)
    verdicts = {k: [r["valid?"] for r in v.pop("rs")]
                for k, v in runs.items()}
    identical = verdicts["first"] == verdicts["second"] == verdicts["off"]
    for run in runs.values():
        run["decided_by_tier"] = {k: v["rows"]
                                  for k, v in run.pop("tiers").items()}
    emit("lin_fastpath", rows=len(encs), off_s=runs["off"]["s"],
         first_s=runs["first"]["s"], second_s=runs["second"]["s"],
         second_over_off=runs["second"]["s"] / max(runs["off"]["s"], 1e-9),
         runs=runs, verdicts_identical=identical)
    if not identical or runs["first"]["scanned_rows"] == 0:
        raise AssertionError("lin_fastpath: verdicts differ, or the fast "
                             "path never ran at the default knobs")


# ----------------------------------------------- the cycle and anomaly tiers

#: the cycle tier's node buckets: the monolithic closure (B7) up to 512
#: nodes, the blocked one (B8) above
CYCLE_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384,
                 512, 768, 1024, 1536, 2048, 3072, 4096)
#: buckets where the library yardstick (bf16 `torch.bmm` squaring) is timed
CYCLE_LIBRARY_BUCKETS = (512, 1024, 4096)
#: sequential_main's sizes: upstream's per-key shape (`--ops-per-key
#: 100`, raft.clj:24-27): histories, ops, processes, values in [0, n);
#: and bench.py's sequential-rung row, the first 256 north-star
#: histories (bench.py:712). SEQ_PLANTED histories of each carry a late
#: stale read.
SEQ_UPSTREAM = (1000, 100, 5, 5)
SEQ_BENCH_ROWS = 256
SEQ_PLANTED = 64
#: anomaly_main: the reference's transactional cycle A/B shape
#: (scripts/ab_cycle.py:50-72 at --n-ops 2000 --n-keys 24): ops, keys,
#: processes
ANOMALY_SHAPE = (2000, 24, 5)


def with_envs(env: dict, fn):
    """fn() with every variable of `env` set (None: unset), restored
    afterwards."""
    items = list(env.items())
    if not items:
        return fn()
    (name, value), rest = items[0], dict(items[1:])
    return with_env(name, value, lambda: with_envs(rest, fn))


def event_ms(fn, reps: int = 3) -> float:
    """Least device time of fn() over `reps` runs, by CUDA events, after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return min(times)


def cycle_graphs(N: int, seed: int):
    """[G, N, N] int32 test graphs of bucket N: a random digraph (1.5
    edges a node), a dense DAG, a long chain, a planted N-cycle and a
    zero-padded random graph, nodes shuffled (the first three only above
    2048 nodes, where the plain version takes seconds). Returns (graphs,
    kinds)."""
    import numpy as np

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


def closure_library(adj):
    """The yardstick, never on a path: the closure as ⌈log₂N⌉ `torch.bmm`
    calls in bf16 (fp32 accumulation; 0/1 inputs and integer sums ≤ N are
    exact enough that `> 0` is) with binarization after each."""
    import torch

    n = int(adj.shape[-1])
    a = (adj != 0).to(torch.bfloat16)
    for _ in range(max(1, (max(n, 2) - 1).bit_length())):
        a = ((a > 0) | (torch.bmm(a, a) > 0)).to(torch.bfloat16)
    return a > 0


def closure_bound(B: int, N: int) -> tuple:
    """(seconds by bytes, seconds by operations) of closing B graphs of
    bucket N: their bit matrices read and written once, and N³/32 32-bit
    word operations per graph (one Warshall pass)."""
    nw = (N + 31) // 32
    return ((2 * B * N * nw * 4 + B) / HBM_BYTES_PER_S,
            B * N ** 3 / 32 / CORE_OPS_PER_S)


def closure_measure(dev, N: int, adj, tile=None,
                    library: bool = True) -> dict:
    """On one batch adj [B, N, N] (on the card): the kernel against its
    plain version, bitwise on every bit of `closed` and on has_cycle; the
    kernel's device time alone on packed bits, the plain version's and
    (with `library`) the library yardstick's (CUDA events), the bound."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc

    has, closed = cc.cycle_closure(adj, tile)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    p_has, p_closed = cc.closure_plain(adj, tile)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    err = max(int((closed - p_closed).abs().max()) if closed.numel() else 0,
              int((has.int() - p_has.int()).abs().max()) if has.numel()
              else 0)
    bits = cc.pack_bits(adj)
    kernel_ms = event_ms(lambda: cc.cycle_closure_bits(bits, N, tile))
    out = {"N": N, "graphs": int(adj.shape[0]), "max_abs_err": err,
           "library_err": 0, "has_cycle": has.cpu().tolist(),
           "kernel_ms": kernel_ms, "plain_ms": plain_ms}
    if library:
        lib = closure_library(adj)
        out["library_err"] = int((lib.int() - p_closed).abs().max()) \
            if lib.numel() else 0
        out["library_ms"] = event_ms(lambda: closure_library(adj), reps=2)
    out["t_bytes"], out["t_ops"] = closure_bound(int(adj.shape[0]), N)
    return out


def phase_cycle_kernel(dev) -> dict:
    """B7 and B8 against their plain versions on the card at every bucket
    of CYCLE_BUCKETS, bitwise on every bit of `closed` and on has_cycle,
    has_cycle also against the host DFS; the kernel timed alone, the
    plain version and (at CYCLE_LIBRARY_BUCKETS) the library yardstick.
    Returns the largest disagreement and the library times."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.cycle import host_has_cycle

    max_err, library = 0, {}
    for N in CYCLE_BUCKETS:
        adj, kinds = cycle_graphs(N, SEED + N)
        m = closure_measure(dev, N, torch.from_numpy(adj).to(dev),
                            library=N in CYCLE_LIBRARY_BUCKETS)
        host = [host_has_cycle(g) for g in adj]
        if "library_ms" in m:
            library[N] = m["library_ms"]
        emit("cycle_kernel", kernel="cycle_closure" if N <= 512
             else "cycle_closure_tiled", kinds=list(kinds),
             host_has_cycle=host, **m,
             bound_ms=max(m["t_bytes"], m["t_ops"]) * 1e3)
        if m["max_abs_err"] or m["library_err"] or m["has_cycle"] != host \
                or not m["has_cycle"][kinds.index("cycle")] \
                or m["has_cycle"][kinds.index("chain")]:
            raise AssertionError(f"cycle_kernel N={N}: the kernel, its "
                                 f"plain version, the yardstick or the host "
                                 f"DFS disagree")
        max_err = max(max_err, m["max_abs_err"])
    return {"max_abs_err": max_err, "library_ms": library}


def cycle_counts() -> dict:
    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc

    return cc.launch_counts()


def add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def real_cycle(witness, enc, model) -> bool:
    """Whether a witness (history op indices) is a cycle of the row's
    dependency graph: every consecutive pair, wrapping, an edge."""
    from jepsen_jgroups_raft_tpu_torch.checker.cycle import build_sc_graph

    g = build_sc_graph(enc, model)
    if not witness or g is None or "adj" not in g:
        return False
    node = {op: i for i, op in enumerate(g["op_index"])}
    if any(w not in node for w in witness):
        return False
    path = [node[w] for w in witness]
    return all(g["adj"][path[i], path[(i + 1) % len(path)]]
               for i in range(len(path)))


def planted_histories(hs, rng):
    """`hs` with a late stale read planted in the first SEQ_PLANTED
    histories that admit one (`synth.plant_stale_read`). Returns
    (histories, indices of the planted)."""
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        build_history, plant_stale_read)

    out, planted = [], []
    for i, h in enumerate(hs):
        if len(planted) < SEQ_PLANTED:
            rows, _ = plant_stale_read(h, rng)
            if rows is not None:
                out.append(build_history(rows))
                planted.append(i)
                continue
        out.append(list(h))
    if len(planted) < SEQ_PLANTED:
        raise AssertionError("sequential_main: too few histories admit a "
                             "planted stale read")
    return out, planted


def run_rung(dev, hs, model, rung: str, env: dict,
             algorithm: str = "auto") -> dict:
    """check_histories at `rung` on the card under `env`, the launch
    counts and tier and run counters set to 0 just before and read just
    after."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        consume_stats, consume_tiers)
    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc

    def go():
        torch.cuda.synchronize()
        reset_all_launch_counts()
        cc.reset_launch_counts()
        consume_tiers()
        consume_stats()
        t0 = time.perf_counter()
        rs = check_histories(hs, model, algorithm, device=dev,
                             consistency=rung)
        dt = time.perf_counter() - t0
        stats = consume_stats()
        return {"results": rs, "s": dt,
                "launches": {**all_launch_counts(), **cycle_counts()},
                "tiers": {k: v["rows"] for k, v in consume_tiers().items()},
                "cycle": {k: v for k, v in stats.items()
                          if k.startswith("cycle_")}}

    return with_envs(env, go)


def phase_sequential_main(dev, north_star) -> dict:
    """The sequential rung on the card at two sizes (SEQ_UPSTREAM, and
    the first SEQ_BENCH_ROWS north-star histories), SEQ_PLANTED of each
    with a late stale read. Arms: the default knobs (the cycle-arm store
    in a fresh directory: the run measures the buckets it meets on first
    contact), JGRAFT_CYCLE_KERNEL=1, =1
    with JGRAFT_GREEDY_CERTIFY=0 (every row reaches B7 or B8), and the
    host DFS arm (=0). Guards: planted rows INVALID on the cycle tier
    with a real cycle as witness, every other row VALID, verdicts
    identical across arms (witnesses too between the kernel and DFS
    arms), B7 / B8 launched in the kernel arms; and `find_cycles` called
    directly, its kernel arm equal to its DFS arm row for row. Returns the planted
    subsets, the launches and the batches each kernel got (for the
    kernels line)."""
    import shutil
    from pathlib import Path

    from jepsen_jgroups_raft_tpu_torch.checker.cycle import (build_sc_graph,
                                                             find_cycles)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        bucket_rows, encode_history)
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_valid_history)
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister
    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc

    model = CasRegister()
    n_h, n_ops, n_procs, vr = SEQ_UPSTREAM
    rng = random.Random(SEED + 11)
    upstream = [random_valid_history(rng, "register", n_ops=n_ops,
                                     n_procs=n_procs, crash_p=CRASH_P,
                                     max_crashes=MAX_CRASHES, value_range=vr)
                for _ in range(n_h)]
    store = Path(__file__).resolve().parent / "build" / "chip_smoke_cycle"
    out = {"planted": {}, "launches": {}, "batches": {}}
    for size, base, kernel in (("upstream", upstream, "cycle_closure"),
                               ("bench", north_star[:SEQ_BENCH_ROWS],
                                "cycle_closure_tiled")):
        hs, planted = planted_histories(base, random.Random(SEED + 12))
        encs = [encode_history(h, model) for h in hs]
        shutil.rmtree(store, ignore_errors=True)
        arms = (("default", {"JGRAFT_AUTOTUNE_STORE": str(store)}),
                ("kernel", {"JGRAFT_CYCLE_KERNEL": "1"}),
                ("kernel_all", {"JGRAFT_CYCLE_KERNEL": "1",
                                "JGRAFT_GREEDY_CERTIFY": "0"}),
                ("dfs", {"JGRAFT_CYCLE_KERNEL": "0"}))
        runs = {}
        for arm, env in arms:
            runs[arm] = run_rung(dev, hs, model, "sequential", env)
            if arm != "dfs":
                add_counts(out["launches"], cycle_counts())
        shutil.rmtree(store, ignore_errors=True)
        verdicts = {a: [r["valid?"] for r in run["results"]]
                    for a, run in runs.items()}
        want = [i not in set(planted) for i in range(len(hs))]
        bad = []
        for arm, run in runs.items():
            if verdicts[arm] != want:
                bad.append(f"{arm}: verdicts")
            for i in planted:
                r = run["results"][i]
                if r.get("decided-tier") != "cycle" or \
                        not real_cycle(r.get("cycle"), encs[i], model):
                    bad.append(f"{arm}: planted row {i} {r}")
                    break
        if [r.get("cycle") for r in runs["kernel"]["results"]] != \
                [r.get("cycle") for r in runs["dfs"]["results"]]:
            bad.append("kernel and dfs witnesses differ")
        launched = runs["kernel_all"]["launches"][kernel]
        if launched <= 0 or runs["kernel"]["launches"][kernel] <= 0:
            bad.append(f"{kernel} not launched")
        # find_cycles called directly as well (a rung could hide a
        # failure of the tier): its kernel arm against its host DFS arm,
        # row for row, witnesses included
        def direct():
            cc.reset_launch_counts()
            return find_cycles(encs, model, device=dev), cycle_counts()

        got, counts = with_envs({"JGRAFT_CYCLE_KERNEL": "1"}, direct)
        add_counts(out["launches"], counts)
        host = with_envs({"JGRAFT_CYCLE_KERNEL": "0"},
                         lambda: find_cycles(encs, model, device=dev))
        if got != host or counts[kernel] <= 0:
            bad.append(f"find_cycles: kernel arm differs from the host DFS "
                       f"arm or launched no {kernel}")
        # the batches the kernel arms hand each closure kernel: every
        # row's graph, bucketed as find_cycles buckets them
        graphs = [build_sc_graph(e, model) for e in encs]
        buckets: dict = {}
        for g in graphs:
            if g is not None and "adj" in g and g["n"] >= 2:
                buckets.setdefault(bucket_rows(g["n"], 4), []).append(
                    g["adj"])
        n_graphs = sum(len(v) for v in buckets.values())
        if n_graphs != len(hs):
            bad.append(f"{n_graphs} of {len(hs)} rows build a graph")
        out["batches"][kernel] = buckets
        out["planted"][size] = [hs[i] for i in planted]
        emit("sequential_main", size=size, histories=len(hs),
             planted=len(planted),
             buckets={N: len(v) for N, v in sorted(buckets.items())},
             arms={a: {"s": run["s"], "hist_per_s": len(hs) / run["s"],
                       "tiers": run["tiers"], "launches": run["launches"],
                       "cycle_counters": run["cycle"]}
                   for a, run in runs.items()},
             verdicts_identical=not bad)
        if bad:
            raise AssertionError(f"sequential_main/{size}: {bad[:3]}")
    return out


def phase_session_evidence(dev, planted: dict) -> dict:
    """The planted subsets at the session rung on the card, with the
    closure kernel forced (JGRAFT_CYCLE_KERNEL=1) and at the default
    knobs (the cycle-arm store in a fresh directory): every planted row
    carries sc-refuted with its cycle, the verdicts and the evidence
    flags agree, and the forced run launched the kernel. The session
    rung defers a write's FORCE to its process's next read, so the
    1000-op rows reach windows of 32–42 slots; the phase checks on the
    card alone (algorithm "dense": the ladder's undecided rows report
    UNKNOWN instead of taking the host DFS), since the evidence, not the
    verdict, is what it holds. Returns the forced runs' launches."""
    import shutil
    from pathlib import Path

    from jepsen_jgroups_raft_tpu_torch.models import CasRegister

    model = CasRegister()
    store = Path(__file__).resolve().parent / "build" / "chip_smoke_cycle"
    launches: dict = {}
    for size, hs in planted.items():
        shutil.rmtree(store, ignore_errors=True)
        runs = {arm: run_rung(dev, hs, model, "session", env, "dense")
                for arm, env in (("kernel", {"JGRAFT_CYCLE_KERNEL": "1"}),
                                 ("default", {"JGRAFT_AUTOTUNE_STORE":
                                              str(store)}))}
        shutil.rmtree(store, ignore_errors=True)
        add_counts(launches, runs["kernel"]["launches"])
        ok = all(r.get("sc-refuted") is True and r.get("sc-cycle")
                 and r.get("consistency") == "session"
                 for run in runs.values() for r in run["results"])
        same = [(r["valid?"], r.get("sc-refuted")) for r in
                runs["kernel"]["results"]] == \
            [(r["valid?"], r.get("sc-refuted")) for r in
             runs["default"]["results"]]
        closures = runs["kernel"]["launches"]["cycle_closure"] + \
            runs["kernel"]["launches"]["cycle_closure_tiled"]
        emit("session_evidence", size=size, histories=len(hs),
             sc_refuted=sum(1 for r in runs["kernel"]["results"]
                            if r.get("sc-refuted")),
             verdicts={str(v): sum(1 for r in runs["kernel"]["results"]
                                   if r["valid?"] == v)
                       for v in (True, False, "unknown")},
             arms={a: {"s": run["s"], "launches": run["launches"],
                       "tiers": run["tiers"]} for a, run in runs.items()},
             identical=same)
        if not ok or not same or closures <= 0:
            raise AssertionError(f"session_evidence/{size}: evidence "
                                 f"missing, arms differ or no closure "
                                 f"kernel launched")
    return launches


def phase_anomaly_main(dev) -> dict:
    """certify_history on the card on histories of the reference's
    transactional A/B shape (ANOMALY_SHAPE): two with a planted G-single
    and a planted G1c (the sharper G1c is the verdict), one with a
    planted G-single alone and a clean one (whose reachability closure
    the direct arm needs). Arms: condensation on (the planted SCCs' closure
    on B7), JGRAFT_CYCLE_CONDENSE=0 (the whole graph's closure at bucket
    2048 on B8) and kernel=False (host). Classes and witnesses identical
    across arms, each history's expected class. Returns the launches."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.anomaly import certify_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        build_history, listappend_txn_rows, plant_anomaly)
    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc

    n_ops, n_keys, n_procs = ANOMALY_SHAPE
    cases = []
    for j, (plants, want) in enumerate(((("G-single", "G1c"), ["G1c"]),
                                        (("G-single", "G1c"), ["G1c"]),
                                        (("G-single",), ["G-single"]),
                                        ((), []))):
        rows = listappend_txn_rows(random.Random(SEED + 19 + j), n_ops,
                                   n_keys, n_procs)
        for k, kind in enumerate(plants):
            rows = plant_anomaly(rows, kind, f"planted-{k}", 100 + 10 * k)
        cases.append((build_history(rows), list(plants), want))
    launches: dict = {}
    lines = []
    for h, plants, want in cases:
        arms = {}
        for arm, env, kernel in (("condensed", {"JGRAFT_CYCLE_CONDENSE": None},
                                  None),
                                 ("direct", {"JGRAFT_CYCLE_CONDENSE": "0"},
                                  None),
                                 ("host", {"JGRAFT_CYCLE_CONDENSE": None},
                                  False)):
            def go():
                torch.cuda.synchronize()
                cc.reset_launch_counts()
                t0 = time.perf_counter()
                r = certify_history(h, kernel=kernel, device=dev)
                return r, time.perf_counter() - t0, cc.launch_counts()

            r, dt, counts = with_envs(env, go)
            if kernel is None:
                add_counts(launches, counts)
            arms[arm] = {"result": r, "s": dt, "launches": counts}
        results = [a["result"] for a in arms.values()]
        same = all(r == results[0] for r in results)
        classes = sorted(results[0]["anomalies"])
        lines.append({"plants": plants, "nodes": results[0].get("nodes"),
                      "classes": classes, "identical": same,
                      "arms": {a: {"s": v["s"], "launches": v["launches"]}
                               for a, v in arms.items()}})
        if not same or classes != want or \
                results[0]["valid?"] is not (not want):
            raise AssertionError(f"anomaly_main {plants}: arms differ or "
                                 f"classes {classes} != {want}")
    emit("anomaly_main", histories=len(cases), ops=n_ops, keys=n_keys,
         processes=n_procs, cases=lines, launches=launches)
    if launches.get("cycle_closure", 0) <= 0 or \
            launches.get("cycle_closure_tiled", 0) <= 0:
        raise AssertionError(f"anomaly_main: B7 and B8 must both launch: "
                             f"{launches}")
    return launches


def closure_line(dev, kernel: str, batches: dict, launches: int,
                 err: int) -> dict:
    """A kernels-line entry for a closure kernel from the batches the main
    path gave it (one per bucket): kernel bitwise against its plain
    version on each, device times summed, bound from these inputs."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops.cycle_closure import (
        pack_adjacency, unpack_adjacency)

    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "t_bytes": 0.0,
             "t_ops": 0.0}
    per = []
    for N, graphs in sorted(batches.items()):
        adj = torch.from_numpy(unpack_adjacency(
            pack_adjacency(graphs, N), N).astype("int32")).to(dev)
        m = closure_measure(dev, N, adj)
        err = max(err, m["max_abs_err"], m["library_err"])
        per.append({k: m[k] for k in ("N", "graphs", "kernel_ms",
                                      "plain_ms", "library_ms")})
        total["ms"] += m["kernel_ms"]
        total["plain_ms"] += m["plain_ms"]
        total["library_ms"] += m["library_ms"]
        total["t_bytes"] += m["t_bytes"]
        total["t_ops"] += m["t_ops"]
        del adj
        torch.cuda.empty_cache()
    emit("closure_main_path", kernel=kernel, batches=per, **total,
         max_abs_err=err)
    if err:
        raise AssertionError(f"{kernel}: disagrees with its plain version "
                             f"on the main path's batches")
    return {"launches": launches, "max_abs_err": err, **total}


#: election_kernel: the kernel against its plain version at these row
#: lengths (each with every case of `election_cases`), then timed at the
#: users' size: 512 election runs × 4096 pooled observations
ELECTION_NS = (1, 2, 31, 32, 33, 1024, 4096, 65536)
ELECTION_BATCH = (512, 4096)
#: election runs written for the agreement with the host check (half
#: with a planted second leader), and their ops
ELECTION_RUNS = 16
ELECTION_RUN_OPS = 1000
#: the fewest 32-bit operations the kernel does per observation: the
#: term's multiply-shift hash and the compare of the slot's term
ELECTION_OPS_PER_OBS = 3
#: recorded_main's store: bench.py's recorded config 3 (512 keys of 16
#: ops, 10 threads a key, values in [0, 5), 8 timeout-polluted keys), a
#: counter run (suite config 2's shape) and an election run with views
RECORDED_SEED = SEED + 23


def election_cases(N: int, seed: int):
    """[7, N, 2] int32 rows of pooled observations and their kinds: all
    safe; one planted second leader early, in the middle and last; one
    observation repeated; a padded tail; negative terms with two
    leaders (ignored by the check)."""
    import numpy as np

    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        election_observation_rows)

    kinds = ("safe", "early", "middle", "last", "repeated", "padded",
             "negative")
    rng = np.random.default_rng(seed)
    obs = election_observation_rows(rng, len(kinds), N,
                                    n_terms=max(2, min(N // 3, 4096)))
    for b, kind in enumerate(kinds):
        if kind in ("early", "middle", "last") and N > 1:
            j = {"early": 1, "middle": N // 2, "last": N - 1}[kind]
            obs[b, j] = (obs[b, 0, 0], obs[b, 0, 1] + 1)
        elif kind == "repeated":
            obs[b] = obs[b, 0]
        elif kind == "padded":
            obs[b, int(rng.integers(0, N + 1)):] = -1
        elif kind == "negative":
            half = (N + 1) // 2
            obs[b, :half, 0] = -1 - (np.arange(half) % 2)
    return obs, kinds


def plant_second_leader(history, rng):
    """A copy of an election history in which one ok views op also
    reports, for one of its nodes, another leader at that node's term."""
    ops = list(history)
    cands = [j for j, op in enumerate(ops) if op.type == "ok"
             and op.f == "views"
             and any(v[1] is not None for v in op.value)]
    j = rng.choice(cands)
    node, _, term = rng.choice([v for v in ops[j].value if v[1] is not None])
    ops[j] = ops[j].replace(value=list(ops[j].value) + [(node, "zz", term)])
    return ops


def pad_observations(rows):
    """[R, max N, 2] int32 numpy batch of per-run observation arrays,
    padded with (-1, -1)."""
    import numpy as np

    n = max(1, max(len(o) for o in rows))
    out = np.full((len(rows), n, 2), -1, np.int32)
    for i, o in enumerate(rows):
        out[i, :len(o)] = o
    return out


def phase_election_kernel(dev, root) -> dict:
    """B9's election-safety kernel against its plain version, bitwise,
    at every length of ELECTION_NS on every case of `election_cases`
    (also cut by a valid_len); timed alone at ELECTION_BATCH (CUDA
    events) beside the plain version and the bound; and on the pooled
    observations of ELECTION_RUNS election runs written to `root` (half
    with a planted second leader) and loaded back, held to the host's
    `check_election_safety_np`. Returns the kernels-line numbers."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.core.store import load_history
    from jepsen_jgroups_raft_tpu_torch.history import synth
    from jepsen_jgroups_raft_tpu_torch.history.ops import History
    from jepsen_jgroups_raft_tpu_torch.models.leader import (
        MajorityLeaderModel, check_election_safety,
        check_election_safety_np, check_election_safety_plain)
    from jepsen_jgroups_raft_tpu_torch.ops.election_safety import (
        election_safety)

    def both(obs, valid_len=None):
        got = check_election_safety(obs, valid_len).cpu()
        want = check_election_safety_plain(obs, valid_len).cpu()
        return got.tolist(), int((got != want).sum())

    err, compared = 0, 0
    for N in ELECTION_NS:
        obs, kinds = election_cases(N, SEED + N)
        t = torch.from_numpy(obs).to(dev)
        got, bad = both(t)
        vl = torch.from_numpy(np.random.default_rng(N).integers(
            0, N + 1, size=len(kinds)).astype(np.int32)).to(dev)
        _, bad_vl = both(t, vl)
        err = max(err, bad, bad_vl)
        compared += 2 * len(kinds)
        expect = {"safe": True, "repeated": True, "padded": True}
        if N > 1:
            expect.update(early=False, middle=False, last=False)
        view = dict(zip(kinds, got))
        emit("election_kernel", N=N, verdicts=view, mismatches=bad,
             mismatches_valid_len=bad_vl)
        if bad or bad_vl or any(view[k] is not v for k, v in expect.items()):
            raise AssertionError(f"election_kernel N={N}: the kernel and "
                                 f"its plain version disagree, or a case "
                                 f"has the wrong verdict: {view}")

    B, N = ELECTION_BATCH
    rng = np.random.default_rng(SEED + 24)
    obs = synth.election_observation_rows(rng, B, N)
    planted = np.arange(B) % 8 == 3
    for b in np.flatnonzero(planted):
        j = int(rng.integers(1, N))
        obs[b, j] = (obs[b, 0, 0], obs[b, 0, 1] + 1)
    t = torch.from_numpy(obs).to(dev)
    got, bad = both(t)
    if bad or got != (~planted).tolist():
        raise AssertionError("election_kernel: the users' size batch "
                             "disagrees with its plain version or with "
                             "its planted rows")
    kernel_ms = event_ms(lambda: election_safety(t), reps=10)
    plain_ms = event_ms(lambda: check_election_safety_plain(t), reps=3)
    t_bytes = (8 * B * N + B) / HBM_BYTES_PER_S
    t_ops = ELECTION_OPS_PER_OBS * B * N / CORE_OPS_PER_S

    runs, want = [], []
    prng = random.Random(SEED + 26)
    for i in range(ELECTION_RUNS):
        h = synth.election_history(random.Random(SEED + 27 + i),
                                   n_ops=ELECTION_RUN_OPS)
        if i % 2:
            h = plant_second_leader(h, prng)
        runs.append(synth.write_run(root, f"election-{i}", "election",
                                    History(h)))
        want.append(i % 2 == 0)
    pooled = [MajorityLeaderModel().pooled(load_history(d).client_ops(),
                                           {})[0] for d in runs]
    host = [check_election_safety_np(o)[0] for o in pooled]
    got, bad = both(torch.from_numpy(pad_observations(pooled)).to(dev))
    emit("election_kernel_runs", runs=len(runs),
         observations=[len(o) for o in pooled], kernel=got, host_np=host,
         mismatches=bad)
    if bad or got != host or host != want:
        raise AssertionError("election_kernel: the kernel disagrees with "
                             "check_election_safety_np on the runs")
    emit("election_kernel_timed", rows=B, observations=N,
         kernel_ms=kernel_ms, plain_ms=plain_ms,
         bound_ms=max(t_bytes, t_ops) * 1e3, t_bytes=t_bytes, t_ops=t_ops,
         cases_compared=compared)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "t_bytes": t_bytes, "t_ops": t_ops, "library_ms": None}


def corrupt_keyed_read(run_dir, dst, key: int) -> None:
    """A copy of multi-register run `run_dir` in `dst` with key `key`'s
    last ok read moved outside the register's values [0, 5)."""
    from pathlib import Path

    dst.mkdir(parents=True)
    for name in ("test.json", "results.json"):
        (dst / name).write_text((Path(run_dir) / name).read_text())
    ops = [json.loads(line) for line in
           (Path(run_dir) / "history.jsonl").read_text().splitlines()]
    j = max(i for i, o in enumerate(ops) if o["type"] == "ok"
            and o["f"] == "read" and o["value"][0] == key)
    v = ops[j]["value"][1]
    ops[j]["value"][1] = 17 if v is None else v + 11
    (dst / "history.jsonl").write_text(
        "".join(json.dumps(o) + "\n" for o in ops))


def phase_recorded_main(dev, root) -> dict:
    """BASELINE config 3 re-checked from a store on the card: the
    512-key multi-register run, a counter run and an election run with
    views written through the port's store, then `check_recorded` (a
    warm-up, then best of 3, the launch counts set to 0 just before each
    run and read just after): all VALID, dense_scan, mask_scan and
    sort_scan launched. Per key through IndependentLinearizable: the 8
    wide keys (W > 12) on the reference's tier (fast DFS, "dfs" /
    "host"). Guard: the verdicts and n-unknown of algorithm "cpu". The
    election run's pooled observations through the election kernel
    beside the host verdict (its main-path launch). Then the `check`
    CLI in a subprocess (rc 0, the same verdicts), and a copy with one
    key's read corrupted: INVALID, that key named, a counterexample."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.independent import (
        IndependentLinearizable)
    from jepsen_jgroups_raft_tpu_torch.checker.recorded import (
        check_recorded)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import consume_tiers
    from jepsen_jgroups_raft_tpu_torch.core.store import load_history
    from jepsen_jgroups_raft_tpu_torch.history import synth
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister
    from jepsen_jgroups_raft_tpu_torch.models.leader import (
        MajorityLeaderModel, check_election_safety,
        check_election_safety_np)

    t0 = time.perf_counter()
    runs = [synth.keyed_register_run(root, RECORDED_SEED),
            synth.counter_run(root, RECORDED_SEED + 1),
            synth.election_run(root, RECORDED_SEED + 2)]
    synth_s = time.perf_counter() - t0
    check_recorded(runs, device=dev)  # warm-up
    walls = []
    for _ in range(3):
        consume_tiers()
        torch.cuda.synchronize()
        reset_all_launch_counts()
        t0 = time.perf_counter()
        summary = check_recorded(runs, device=dev)
        walls.append(time.perf_counter() - t0)
        launches = all_launch_counts()
        tiers = consume_tiers()
    if summary["valid?"] is not True or summary["n-unknown"] or \
            summary["n-valid"] != summary["histories"]:
        raise AssertionError(f"recorded_main: not all VALID: {summary}")
    for k in ("dense_scan", "mask_scan", "sort_scan"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"recorded_main: no {k} launch: "
                                 f"{launches}")

    keyed = IndependentLinearizable(CasRegister, device=dev).check(
        {}, load_history(runs[0]))
    by = {}
    for r in keyed["results"].values():
        key = f"{r.get('algorithm')}/{r.get('decided-tier')}"
        by[key] = by.get(key, 0) + 1
    wide = {k: (r["algorithm"], r["decided-tier"],
                r["concurrency-window"])
            for k, r in keyed["results"].items()
            if r["concurrency-window"] > 12}
    if keyed["valid?"] is not True or len(wide) != 8 or \
            any(v[:2] != ("dfs", "host") for v in wide.values()):
        raise AssertionError(f"recorded_main: a key is not VALID or a "
                             f"wide key left the fast DFS tier: {wide}")

    guard = check_recorded(runs, algorithm="cpu", device=dev)
    if guard["run-verdicts"] != summary["run-verdicts"] or \
            guard["n-unknown"] != summary["n-unknown"]:
        raise AssertionError(f"recorded_main: algorithm cpu disagrees: "
                             f"{guard}")

    pooled, _ = MajorityLeaderModel().pooled(
        load_history(runs[2]).client_ops(), {})
    obs = torch.from_numpy(pad_observations([pooled])).to(dev)
    reset_all_launch_counts()
    safe = check_election_safety(obs).cpu().tolist()
    election_launches = all_launch_counts()["election_safety"]
    if safe != [check_election_safety_np(pooled)[0]] or \
            safe != [summary["run-verdicts"][str(runs[2])]]:
        raise AssertionError("recorded_main: the election kernel's verdict "
                             "differs from the host's")

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "jepsen_jgroups_raft_tpu_torch", "check",
                          str(root)], cwd=here, env=env,
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    cli = json.loads(out.stdout) if out.returncode == 0 else {}
    mine = {d: v for d, v in cli.get("run-verdicts", {}).items()
            if d in summary["run-verdicts"]}
    if out.returncode != 0 or mine != summary["run-verdicts"]:
        raise AssertionError(f"recorded_main: the check CLI exited "
                             f"{out.returncode} or its verdicts differ: "
                             f"{out.stderr[-2000:]}")

    key = random.Random(RECORDED_SEED + 3).randrange(512)
    bad = root / "corrupted" / "run"
    corrupt_keyed_read(runs[0], bad, key)
    bad_summary = check_recorded([bad], device=dev)
    bad_keyed = IndependentLinearizable(CasRegister, device=dev).check(
        {"store_dir": str(bad)}, load_history(bad))
    named = [k for k, r in bad_keyed["results"].items()
             if r["valid?"] is not True]
    ce = bad_keyed["results"].get(str(key), {}).get("counterexample", {})
    if bad_summary["valid?"] is not False or \
            bad_summary["n-invalid"] != 1 or named != [str(key)] or \
            not ce.get("minimal-ops") or "file" not in ce:
        raise AssertionError(f"recorded_main: the corrupted key {key} was "
                             f"not named INVALID with a counterexample: "
                             f"{bad_summary}, {named}")
    emit("recorded_main", runs=len(runs), histories=summary["histories"],
         synth_s=synth_s, walls=walls, check_s_best=min(walls),
         hist_per_s=summary["histories"] / min(walls),
         time_s=summary["time-s"], tiers=tiers, launches=launches,
         keyed_algorithm_tier=by, wide_keys=wide,
         cpu_guard_time_s=guard["time-s"], cli_s=cli_s,
         election_kernel_verdict=safe, election_launches=election_launches,
         corrupted_key=key,
         counterexample_minimal_ops=ce["minimal-op-count"],
         device=torch.cuda.get_device_name(dev))
    return {"election_launches": election_launches}


def phase_keyed_main(dev) -> dict:
    """BASELINE config 4 (bench.py:998-1003: 16 register histories of
    10k ops, 5 processes, crash_p 0.02, ≤ 4 crashes; long_main's
    histories) tupled into one multi-key history and checked through
    IndependentLinearizable on the card; per key valid?, algorithm,
    decided-tier, kernel, op-count and window must equal
    `check_histories` on the same sub-histories."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.independent import (
        IndependentLinearizable)
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.history.ops import History, Op
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister

    hs, synth_s = long_histories("config4")
    tupled = History()
    for k, h in enumerate(hs):
        for op in h:
            tupled.append(Op(process=1000 * k + op.process, type=op.type,
                             f=op.f, value=(k, op.value),
                             time=len(tupled)))
    reset_all_launch_counts()
    t0 = time.perf_counter()
    keyed = IndependentLinearizable(CasRegister, device=dev).check(
        {}, tupled)
    keyed_s = time.perf_counter() - t0
    launches = all_launch_counts()
    t0 = time.perf_counter()
    want = check_histories(hs, CasRegister(), device=dev)
    direct_s = time.perf_counter() - t0
    fields = ("valid?", "algorithm", "decided-tier", "kernel", "op-count",
              "concurrency-window")
    got = [{f: keyed["results"][str(k)].get(f) for f in fields}
           for k in range(len(hs))]
    exp = [{f: r.get(f) for f in fields} for r in want]
    emit("keyed_main", keys=len(hs), ops=len(tupled), synth_s=synth_s,
         keyed_s=keyed_s, check_histories_s=direct_s, launches=launches,
         tiers=sorted({(r["kernel"], r["decided-tier"]) for r in got}),
         device=torch.cuda.get_device_name(dev))
    if got != exp or keyed["valid?"] is not True:
        raise AssertionError("keyed_main: IndependentLinearizable differs "
                             "from check_histories on config 4")
    return {}


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
        from jepsen_jgroups_raft_tpu_torch.models import (CasRegister,
                                                          Counter, GSet,
                                                          ListAppend,
                                                          TicketQueue)
        from jepsen_jgroups_raft_tpu_torch.ops import _build
        from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
            dense_scan_plain, mask_scan_plain)
        from jepsen_jgroups_raft_tpu_torch.platform import toolchain_stamp
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2

    # the phases that drive a kernel hold every row on its kernel's tier,
    # so they run with the lin fast path off, as the reference's test
    # suite does; `lin_fastpath` runs the default knobs on its own
    os.environ["JGRAFT_LIN_FASTPATH"] = "0"
    dev = torch.device("cuda")
    model = CasRegister()
    stamp = toolchain_stamp()
    emit("stamp", **stamp)

    # 2. build every kernel from this checkout's sources, and the
    # instrumented mask kernel, in parallel
    path_libs = list(dict.fromkeys(KERNEL_LIBRARY.get(k, k)
                                   for k in KERNELS))
    libs = [*path_libs, "mask_scan_profile"]
    build_s = _build.build(libs)
    ptxas = {k: _build.ptxas_report(k) for k in libs}
    emit("build", seconds=build_s, kernels=libs, ptxas=ptxas)
    for k, rep in ptxas.items():
        if rep["functions"] == 0:
            raise AssertionError(f"no ptxas report for {k}")
        if k in path_libs and (rep["spill_store_bytes"]
                               + rep["spill_load_bytes"] or
                               rep["max_stack_bytes"]):
            raise AssertionError(f"{k} spills or uses a stack: {rep}")

    # 3. dense_scan against its plain version at every window
    t0 = time.perf_counter()
    compared, corner_err = phase_kernel(dev, model)
    emit("kernel_summary", rows_compared=compared, max_abs_err=corner_err,
         seconds=time.perf_counter() - t0)

    # 4. mask_scan against its plain version
    t0 = time.perf_counter()
    compared, mask_err = phase_mask_kernel(dev)
    emit("mask_kernel_summary", rows_compared=compared,
         max_abs_err=mask_err, seconds=time.perf_counter() - t0)

    # 5. domain and mask groups launched together
    _, groups_err = phase_groups(dev, model)

    # 6. the main path: the north-star batch through check_histories
    histories, synth_s = suite_histories("register")
    line = {"dense_scan": run_path("main", dev, model, histories, synth_s,
                                   "dense", "dense_scan",
                                   ptxas["dense_scan"])}

    # 7. the card's busy share over one check, from a profiler trace
    phase_profile(dev, model, histories)

    # 8. invalid subset: guaranteed-invalid corruption (the bumped read
    # leaves the value domain), kernel vs plain vs host oracle
    def dense_plain(encs, plan):
        ev, vo, ne, P, W = group_tensors(encs, plan, True, dev)
        return dense_scan_plain(ev, vo, W, macro_p=P, n_events=ne,
                                model=model).cpu().tolist()

    def mask_plain(m):
        def run(encs, plan):
            ev, ne, P = mask_tensors(encs, True, dev)
            return mask_scan_plain(ev, plan.n_slots, P, ne,
                                   model=m).cpu().tolist()
        return run

    rng = random.Random(SEED + 2)
    bad = []
    for h in histories[:N_INVALID]:
        ops_, changed = corrupt_read(h, rng, VALUE_RANGE + 1)
        if not changed:
            raise AssertionError("a north-star history without an ok read")
        bad.append(ops_)
    phase_invalid(dev, model, bad, "dense", dense_plain, "invalid")

    # 9. the counter and queue paths: the suite's shapes on the mask kernel
    paths = {}
    counter_histories = None
    for phase, kind, m in (("counter_main", "counter", Counter()),
                           ("queue_main", "queue", TicketQueue())):
        hs, synth_s = suite_histories(kind)
        if kind == "counter":
            counter_histories = hs
        paths[phase] = run_path(phase, dev, m, hs, synth_s, "mask",
                                "mask_scan", ptxas["mask_scan"])
        paths[phase]["model"] = m
    mask_line = list(paths.values())

    # 10. the counter at upstream's documented concurrency (10 processes):
    # windows 10..13, the rows within the mask cap
    hs, drawn, windows, synth_s, counter10_wide = counter10_histories()
    emit("counter10_synth", kept=len(hs), drawn=drawn, windows=windows,
         seconds=synth_s)
    paths["counter10_main"] = run_path("counter10_main", dev, Counter(), hs,
                                       synth_s, "mask", "mask_scan",
                                       ptxas["mask_scan"])
    paths["counter10_main"]["model"] = Counter()

    # 11. counter invalid subset: a read raised by 10^6 (beyond any sum
    # of the history's adds), kernel vs plain vs host oracle
    rng = random.Random(SEED + 5)
    bad = []
    for h in counter_histories[:N_INVALID]:
        ops_, changed = corrupt_read(h, rng, 10**6)
        if not changed:
            raise AssertionError("a counter history without an ok read")
        bad.append(ops_)
    m = Counter()
    phase_invalid(dev, m, bad, "mask", mask_plain(m), "counter_invalid")

    # 12. the instrumented mask kernel on the paths' own groups
    phase_mask_profile(dev, paths)

    # 13. sort_scan against its plain version
    t0 = time.perf_counter()
    compared, sort_err, overflowed = phase_sort_kernel(dev)
    emit("sort_kernel_summary", rows_compared=compared, max_abs_err=sort_err,
         overflowed_and_ok=overflowed["ok"],
         overflowed_and_not_ok=overflowed["not_ok"],
         seconds=time.perf_counter() - t0)

    # 14. the set path: the suite's set shape through the sort ladder
    set_hs, synth_s = suite_histories("set", value_range=SET_VALUE_RANGE)
    line["sort_scan"] = run_sort_path("set_main", dev, GSet(), set_hs,
                                      synth_s, ptxas["sort_scan"],
                                      value_range=SET_VALUE_RANGE)

    # 15. set invalid subset: kernel vs plain ladder vs host oracle
    phase_set_invalid(dev, set_hs)

    # 16. segment_scan against its plain version at full segment size
    t0 = time.perf_counter()
    runs, live, seg_err = phase_segment_kernel(dev)
    emit("segment_kernel_summary", runs_compared=runs, live_runs=live,
         max_abs_err=seg_err, seconds=time.perf_counter() - t0)

    # 17. suite configs 5 and 4, segmented and monolithic, on the card
    t0 = time.perf_counter()
    long = phase_long_main(dev)
    line["segment_scan"] = long["line"]
    emit("long_main_summary", seconds=time.perf_counter() - t0)

    # 18. config 5 with one late read outside the domain
    t0 = time.perf_counter()
    seg_err = max(seg_err, phase_long_invalid(dev, long["config5"]))
    emit("long_invalid_summary", seconds=time.perf_counter() - t0)

    # 19. the 10-process counter histories beyond the mask cap, under auto
    t0 = time.perf_counter()
    phase_wide_auto(dev, counter10_wide)
    emit("wide_auto_summary", seconds=time.perf_counter() - t0)

    # 20. the north-star batch at the default knobs against the fast
    # path off
    t0 = time.perf_counter()
    phase_lin_fastpath(dev, histories)
    emit("lin_fastpath_summary", seconds=time.perf_counter() - t0)

    # 21. B7 and B8 against their plain versions at every bucket
    t0 = time.perf_counter()
    ck = phase_cycle_kernel(dev)
    emit("cycle_kernel_summary", max_abs_err=ck["max_abs_err"],
         library_ms=ck["library_ms"], seconds=time.perf_counter() - t0)

    # 22. the sequential rung at upstream's per-key shape and bench.py's
    # row, planted stale reads refuted by the cycle tier
    t0 = time.perf_counter()
    seq = phase_sequential_main(dev, histories)
    cycle_launches = dict(seq["launches"])
    emit("sequential_main_summary", seconds=time.perf_counter() - t0)

    # 23. the planted rows' sc-refuted evidence at the session rung
    t0 = time.perf_counter()
    add_counts(cycle_launches, phase_session_evidence(dev, seq["planted"]))
    emit("session_evidence_summary", seconds=time.perf_counter() - t0)

    # 24. the transactional anomaly rung at the reference's A/B shape
    t0 = time.perf_counter()
    add_counts(cycle_launches, phase_anomaly_main(dev))
    emit("anomaly_main_summary", seconds=time.perf_counter() - t0)

    # 25. list-append (bench.py config 9) through the sort ladder
    t0 = time.perf_counter()
    la_hs, synth_s = suite_histories("list-append")
    la_line = run_sort_path("listappend_main", dev, ListAppend(), la_hs,
                            synth_s, ptxas["sort_scan"])
    for k in ("launches", "ms", "plain_ms", "t_bytes", "t_ops"):
        line["sort_scan"][k] += la_line[k]
    line["sort_scan"]["max_abs_err"] = max(line["sort_scan"]["max_abs_err"],
                                           la_line["max_abs_err"])
    emit("listappend_main_summary", seconds=time.perf_counter() - t0)

    # the closure kernels' numbers on the batches the main path gave them
    t0 = time.perf_counter()
    for name in ("cycle_closure", "cycle_closure_tiled"):
        line[name] = closure_line(dev, name, seq["batches"][name],
                                  cycle_launches.get(name, 0),
                                  ck["max_abs_err"])
    emit("closure_main_path_summary", seconds=time.perf_counter() - t0)

    # 26-28: B9's election-safety kernel; the re-check of recorded runs
    # (BASELINE config 3) and the per-key checker (config 4), each store
    # written to a directory of its own
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        t0 = time.perf_counter()
        line["election_safety"] = phase_election_kernel(
            dev, Path(tmp) / "elections")
        emit("election_kernel_summary", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        rec = phase_recorded_main(dev, Path(tmp) / "recorded")
        line["election_safety"]["launches"] = rec["election_launches"]
        emit("recorded_main_summary", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_keyed_main(dev)
    emit("keyed_main_summary", seconds=time.perf_counter() - t0)

    line["mask_scan"] = {
        "launches": sum(x["launches"] for x in mask_line),
        "max_abs_err": max(x["max_abs_err"] for x in mask_line),
        "ms": sum(x["ms"] for x in mask_line),
        "plain_ms": sum(x["plain_ms"] for x in mask_line),
        "t_bytes": sum(x["t_bytes"] for x in mask_line),
        "t_ops": sum(x["t_ops"] for x in mask_line)}
    errs = {"dense_scan": max(corner_err, groups_err["dense_scan"]),
            "mask_scan": max(mask_err, groups_err["mask_scan"]),
            "sort_scan": sort_err, "segment_scan": seg_err,
            "cycle_closure": 0, "cycle_closure_tiled": 0,
            "election_safety": 0}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        x = line[name]
        rep = ptxas[KERNEL_LIBRARY.get(name, name)]
        if x["launches"] <= 0:
            raise AssertionError(f"{name}: never launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": x["launches"],
            "max_abs_err": float(max(errs[name], x["max_abs_err"])),
            "ms": x["ms"], "plain_ms": x["plain_ms"],
            "bound_ms": max(x["t_bytes"], x["t_ops"]) * 1e3,
            "bound_by": "bytes" if x["t_bytes"] >= x["t_ops"]
            else "operations",
            "library_ms": x.get("library_ms"),
            "registers": rep["max_registers"],
            "spill_bytes": rep["spill_store_bytes"] +
            rep["spill_load_bytes"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
