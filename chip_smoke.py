#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA):

    python3 chip_smoke.py
    python3 chip_smoke.py --only segment,election   # one kernel's phase

With `--only`, only the named phases run, each after building just the
libraries it needs: `segment` measures B6 on config 5 as long_main does
(wrapper and device-only ms, bitwise against the plain version, the
tables composed to VALID, the bound, the launch shape and the
instrumented build's profile); `election` runs phase 26; `mesh` and
`cluster` run phases 29 and 30 (`mesh` on a north-star batch of its
own); `service_cluster` runs phase 6e on a north-star batch of its own.
They end with
the card's `nvidia-smi` line and {"ok": true, "only": [...], ...}, and
print no kernels line. With no arguments every phase runs:

Phases, each printing JSON lines (`t_s`: seconds since the start); any
failure exits non-zero. The north-star batch is made on the host while
nvcc builds. Phases 3, 29a, 4-5, 13, 13b, 16, 21 and 29b (each kernel
against its plain version on its own cases) run in a second process on
the same card, their lines printed when it ends, while this one makes the other
suites' batches and runs 8, 11, 15, 19, 20, 22-24, 27 and 28 (host
walls; no time on the card is taken in them); the phases that time the
card run after both, in the order 6, 6b, 6c, 6d, 6e, 7, 9, 10, 12, 14,
17, 18, 25, the closure kernels' line, 26, 29, 30:
  1. stamp   — torch / CUDA / nvcc versions, the card's name and power limit
  2. build   — nvcc builds every kernel of the paths (dense_scan,
               mask_scan, sort_scan — each with its chunk entry point,
               segment_scan, cycle_closure: B7 and B8, election_safety,
               verdict_counts: B10)
               and the instrumented builds mask_scan_profile and
               segment_scan_profile (never on a main path) from this
               checkout's sources into
               build/torch_kernels/, one nvcc per library, started
               together; ptxas's report for each, each library's nvcc
               seconds, and the one-shot scans' instances with and
               without the counting flag (registers, stack, spills); the
               paths' kernels must show no spill bytes and no stack frame
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
               on the card at the default chunk (JGRAFT_SCAN_CHUNK unset:
               the chunked wavefront over the chunk kernels): 1000
               CAS-register histories of 1000 ops (5 processes, crash_p
               0.05, at most 3 crashes, seed 20260729); best of
               MAIN_REPS (no warm-up); all must be VALID, every row on
               the dense tier, dense_scan_chunk's launch count (reset
               before each run) above 0; chunks_run, evicted_rows,
               groups_early_exited. Then the breakdown: encode, group +
               pack, the one-shot kernels' overlapped span, each group's
               time alone, its ns per row, the plain version's time and
               the bound; the same groups through `run_chunked` (verdicts
               bitwise equal to the one-shot groups', kernel span,
               launches per group); the chunk kernel on the largest
               group's first launch against its plain version (time,
               bound); and one check at JGRAFT_SCAN_CHUNK=0 (the one-shot
               path's wall and launches)
 6b. autotune_main — the same batch through `check_histories` with the
               launch plans on (JGRAFT_AUTOTUNE=1) and an empty store: a
               check that measures every bucket that passes the gates,
               then, the process's plans dropped, one that loads them;
               each bucket's signature, its candidates' sample times
               (ms), the chosen plan and its sources; the store counters
               and the chunk launches by kernel of each check; both walls
               beside main's untuned best; then, the plans in memory, a
               check of the batch with phase 8's 64 corrupted rows in
               place of its first (those INVALID, the rest VALID, every
               row on the dense tier), which must apply a plan. Then the
               chosen plan's first launch on the largest group (packed
               under the plan; the whole schedule at scan_chunk 0)
               against the plain chunk form, flags and carry bitwise: its
               ms and bound beside main's untuned chunk launch. Fails if
               a verdict differs, if the first check measures nothing, if
               the second measures, or if it loads nothing
 6c. stream  — streaming sessions: 64 north-star histories and 16 with one
               read out of the domain, their crashed invocations given
               the info rows a live run records (`record_crashes`; the
               event streams do not move), fed 50 history rows an append
               through `IncrementalEncoder`, `StreamingCertifier` and
               `CarriedScan` (B5's chunk entry point, one row a launch,
               C = 256), and one history fed whole (a backlog): every
               settled stream equal to the one-shot encode, the final
               (ok, overflow) equal to one `run_sort_rung` over the whole
               streams at the same C and W, each corrupted session's ok
               falling at the first append whose prefix a one-shot scan
               finds dead, no launch after a session decided, the backlog
               in more than one launch, the verdicts equal to
               `check_histories`'; appends and launches per session, the
               median and p99 ms of `CarriedScan.feed` and of a whole
               append, one B = 1 launch against its plain version (the
               wrapper's and the device's ms, the bound), and the sessions
               the certifier carried to the end
 6d. service — the checking service on the card (`service/`): 8 tenant
               threads over HTTP (half binary frames, half JSON), 8
               histories a request: 512 north-star histories, 32 + 32
               corrupted register and set rows (phases 8, 15) and 64
               counter rows; 16 stream sessions (4 corrupted); 64 + 16
               rows at the default knobs (the fast lane); 32 requests
               replayed from a crashed journal. Verdicts and tiers equal
               to `check_histories`', nothing degraded
 6e. service_cluster — graftd's cluster tier: two replicas in this
               process share a cluster dir (leases, the shared result
               store, WAL handoff), each over HTTP; 8 tenants with routing
               clients send 256 fresh north-star histories (32
               corrupted), 8 a request; every request resubmitted to each
               replica (store hits, no batch, no launch); r0 restarted
               with its workers off admits 32 fresh requests and opens
               a stream session (a corrupted history, half appended),
               then dies, its last lease 0.5 s; r1 claims its WAL, checks them on the card, and a
               client resumes the session there; a third replica past
               JGRAFT_SERVICE_SHED_DEPTH=1 answers a 429 with the
               cluster's best retry-after. Verdicts and tiers equal to
               `check_histories`', nothing degraded; hist/s, latency p50 /
               p99, requests a replica, store hits, batches and launches
               on resubmission, handoff requests and streams, seconds
  7. profile — one check under torch.profiler: the device's busy share of
               the check's wall (a trace without device time fails)
  8. invalid — 64 of those histories with one read corrupted: kernel,
               plain version and host oracle must agree row for row, and
               every corrupted row must be INVALID
  9. counter_main, queue_main — the reference suite's counter and queue
               shapes (bench.py configs 2 and 7): 250 (SUITE_ROWS; the
               suite's 1000 cut) histories of 1000 ops, 5 processes,
               crash_p 0.05, at most 3 crashes, seed 20260729, through
               `check_histories` on the card, measured as `main` (the
               counter with the one-shot arm and the measured chunk
               launch); all VALID, every row on the mask
               tier, 0 host rows, mask_scan_chunk's launch count above 0
 10. counter10_main — the counter at upstream's documented concurrency
               (10 processes, crash_p 0.05, at most 3 crashes, 1000 ops,
               seed 20260729 + 10): the first 250 histories whose window
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
               that fill it), C in {1, 4, 64, 256, 512}, the row format
               alternating, valid and corrupted; short histories with C
               near their frontier (rows that overflow and end ok, rows
               that overflow and do not: both counts must be above 0);
               arbitrary rows (slots out of range, shared slots, int32
               edges); hand-written rows (`synth.sort_edge_cases`:
               candidates colliding on one key, keys that differ only in
               the state or only in the highest key field up to K = 4,
               distinct counts of exactly C and C + 1, C = 1 … 512); four
               groups at other block shapes and cut tiles
 13b. chunk_kernel — the chunk forms against their plain versions,
               flags and carry compared after every launch, one
               recompaction (carry and events gathered) halfway: B1 at
               W = 1..10 with the largest S, B4 at W = 1..12 for the
               counter and the queue, B5 for the five models at W = 1, 8,
               31, 127 (C = 64; C = 4 too at W = 8) and on the
               hand-written edge rows; chunks of 32 and 128 rows in both
               row formats, of 1 row in one (alternating)
 14. set_main — the reference suite's set shape (bench.py config 6:
               250 histories of 1000 ops, 5 processes, crash_p 0.05, at
               most 3 crashes, value_range 32, seed 20260729) through
               `check_histories` on the card, measured as `main`: all
               VALID, every row on the sort tier, 0 host rows,
               sort_scan_chunk's launch count above 0; then each rung of
               the ladder (C = 64, then the rows that overflowed at C =
               256): rows, one-shot kernel ms, ns per row, mean closure
               rounds a row and ns per round, the launch shape and the
               rung's ms at every block size of SORT_SHAPE_THREADS (flags
               unchanged), the rung
               through `run_chunked` (flags bitwise equal, span,
               launches), the plain version's time and bitwise flags; the
               C = 64 rung's first chunk launch against its plain version;
               one check at JGRAFT_SCAN_CHUNK=0
 14b. autotune_set — the set batch at JGRAFT_AUTOTUNE=1 as autotune_main
               runs the north star (the sort ladder's rungs ask
               `tuned_sort_plan`): measuring, loading, and the batch with
               phase 15's corrupted rows in place of its first (those
               INVALID, the rest VALID); then the mixed batch's C = 64
               rung under its loaded plan through `run_chunked` against
               the untuned rung's one-shot `run_sort_rung`, ok and
               overflow bitwise. Fails as autotune_main, or if no sort
               plan was measured
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
               (bitwise) and the bound; the wrapper call's ms and the
               kernel's device-only ms, its launch shape
               (`segment_shape`), and the instrumented build
               (`segment_scan_profile`, bitwise): SM cycles by
               phase, closures, sweeps and slot images, registers,
               resident warps an SM, waves and the chain floor
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
               dense DAGs, a long chain, a planted N-cycle, padded rows,
               dense random digraphs (p = 0.5), the complete and the
               empty digraph, at the launch shape `closure_shape` gives
               each bucket (the warp form to 128 nodes, the panel form
               to 512, the tiled form above); the kernel timed, the plain
               version, and at N = 512,
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
 25. listappend_main — bench.py config 9: 250 list-append histories of
               1000 ops (5 processes, crash_p 0.05, at most 3 crashes)
               through check_histories, measured as set_main: all VALID
               on the sort tier, each rung bitwise against the plain
               ladder
Then B7 and B8 on the batches the sequential path gave them (64 / 96
and 768 / 1024 nodes): kernel against plain, bitwise; the wrapper
call's, the kernels' device-only, plain and library times; the bound;
per bucket the shape, ms per launch and per graph, ptxas's registers
and shared memory of each kernel the launch runs, the closure's
density and (B8) the share of fold work the kernel skips on this data
with the LOP3 floor of the work it does: `closure_main_path`.
 26. election_kernel — B9's election-safety kernel against its plain
               version, bitwise, at N = 1, 2, 31, 32, 33, 1024, 4096,
               8192, 8193 and 65536 (all safe; a second leader planted
               early, in the middle and last; one observation repeated; a
               padded tail; negative terms), also cut by a valid_len, in
               `election_form(N)`'s form and, where that is the shared
               one, in the global form too; timed at 512 runs × 4096
               pooled observations (the wrapper call, and each form's
               kernels alone) beside the plain version and the bound,
               and at 16 × 65536 (the global form); and on the pooled
               observations of
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
 29. mesh    — B10 on the north-star batch of `main` (encoded again):
               `parallel.mesh.check_batch_sharded(dense=plan,
               defer=True)` over every window group, blocking once
               (bench.py's one-shot arm), and the sort ladder with no plan
               on all 1000 rows (legacy rows, bench.py's `n_slots`); the
               `rest` rows, where the groups leave any, in the first arm:
               the first arm 1000 VALID and equal row for row to the
               groups' `run_chunked` verdicts; the ladder no row INVALID,
               each row it decides VALID, the rows that overflow C = 256
               undecided and counted on the host (about half: the
               reference's ladder leaves the same rows); no
               verdict_counts launch in either arm (the first arm counts
               in its scans' epilogues, one counting launch a group; the
               phase fails on any); the one-shot arm's walls beside
               `run_dense_groups`' on the same groups (in turns, 5 runs
               each, tensors copied inside both); the standalone
               verdict_counts driven once on the arm's verdicts, equal
               to the fused counts; what counting adds
               to each group's one-shot B1 launch (median of 20 each,
               in turns) and, from set_main, to B5's C = 64 rung, with
               the counts of those launches (and of one with a `real`
               mask with holes) held bitwise against the plain counts of
               their own flags, and the plain count and one
               `torch.count_nonzero` timed on the same flags; then
               verdict_counts timed at B = 1000 (the wrapper call and
               its host parts — checks, allocation, ctypes launch —,
               the kernel alone, the plain version, one
               `torch.count_nonzero` of the masked products), at 16384
               and 16385 rows (the kernel alone: one block, then the
               grid after its memset) and at 2^20, beside the bound
 29a. verdict_counts_edges (in the checks' process, after phase 3) —
               verdict_counts against its plain version, bitwise, in both
               modes at B = 0, 1, 31, 32, 33, 1000, 16384, 16385 and 2^20,
               on sliced flags at unaligned offsets, through the wrapper
               and the launcher (on a poisoned output); the fused counts of B1, B4 and B5 (every
               instance the north star and the set use, K = 1..4) at
               B = 1, 31, 32, 33, 1000 with and without `real`, bitwise
               against the plain counts of the same launch's verdicts
               (~10 s); 29b, the last of that process: the device
               operations a standalone call enqueues (the profiler)
 30. cluster — `parallel.launch.launch_local_cluster(2, ...)` running
               `parallel.selfcheck` on this card: both ranks on cuda:0
               under gloo (two ranks share the card), each with the same
               128 register histories of 1000 ops (5 processes, every 8th
               with a read out of its domain; cut from 1000 to keep the
               phase short), checked through `check_histories` (the seam
               shards them, `run_sharded`) and counted by
               `check_batch_global` (with a 128-history counter batch):
               every rank's verdicts equal one process's
               `check_histories` on the card (its 3-row check too, and
               `run_sharded` of one row, which leaves rank 0's shard
               empty), and its counts `check_batch_sharded`'s; then the
               batch again with a result store both ranks share
               (`selfcheck --result-store`: `run_sharded`'s detail
               exchange): no row a "remote-shard" stub, the other rank's
               shard read from the store, one detail record a row

Every phase but lin_fastpath runs with JGRAFT_LIN_FASTPATH=0 (set at
the start), as the reference's test suite runs: at the default knobs
the host certifier decides most valid rows before any kernel. Every
phase runs with JGRAFT_AUTOTUNE=0 (no launch plan and no cycle-arm
store: the launches the phases always measured) but autotune_main,
autotune_set, lin_fastpath and the "default" arms of sequential_main
and session_evidence, which lift the pin; JGRAFT_AUTOTUNE_STORE names a
fresh directory under build/ for the whole run, so no plan of an
earlier run is loaded, and each of those phases measures into a
directory of its own; lin_fastpath measures its plans before its arms.

Then the kernels' summary line (dense_scan, mask_scan, sort_scan,
segment_scan, cycle_closure, cycle_closure_tiled, election_safety,
verdict_counts_fused (B10 in the scans' epilogues: the one-shot arm's
counting launches; its ms what counting adds to the slowest group, its
plain and library ms the plain count and `torch.count_nonzero` of that
group's flags), dense_scan_chunk, mask_scan_chunk, sort_scan_chunk; each with its
library's ptxas registers and spill bytes; a one-shot kernel's launches
are its JGRAFT_SCAN_CHUNK=0 arms', a chunk kernel's the default runs'
of every path, and its ms, plain ms and bound one measured launch's;
dense_scan_chunk and sort_scan_chunk give their launches by path,
`launches_by_path`: the wavefront paths, autotune_main, autotune_set
and, for sort_scan_chunk, the streaming sessions, whose B = 1 launch is
its `stream_launch`, and the service's arms (`service`, and
`service_cluster`: the cluster phase's wave and handoff); dense_scan_chunk's `tuned_launch` is the largest
north-star group's launch under its plan),
the card's
`nvidia-smi` name and power limit, and as the last line {"ok": true, "device": {...}}. Exits non-zero
without a CUDA device, and when the port's package is not beside it.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

T0 = time.perf_counter()
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
#: histories in each batch of the suites beside the north star (the
#: counter, the queue, the 10-process counter, the set, list-append):
#: cut from N_HISTORIES to keep the script inside half its time limit.
#: Their rows keep the suite's shape (N_OPS ops, the same processes and
#: crashes), so their kernels and plain versions run at the same widths
#: and lengths
SUITE_ROWS = 250
#: warp schedulers (sub-partitions) per SM on Hopper
SUB_PARTITIONS_PER_SM = 4

#: H100 SXM rates: HBM3 bandwidth, and the CUDA-core (non-tensor) peak
#: used for the kernels' 32-bit integer operations.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
#: 32-bit bitwise operations (LOP3) an SM completes a clock on compute
#: capability 9.0 (the CUDA C++ Programming Guide's throughput table):
#: the closure folds' own floor, beside the bound at CORE_OPS_PER_S
LOP3_PER_CLOCK_PER_SM = 64
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
SORT_CAPS = (1, 4, 64, 256, 512)
#: block sizes the ladder's rungs are timed at beside the default shape
#: (set_main, listappend_main): the record of the shapes tried
SORT_SHAPE_THREADS = (32, 64, 128, 256, 512, 1024)

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
    # B10's standalone entry: built, checked and timed (phase 29), not on
    # the kernels line (OFF_PATH)
    "verdict_counts": (
        "jepsen_jgroups_raft_tpu_torch/ops/csrc/verdict_counts.cu",
        "jepsen_jgroups_raft_tpu/parallel/mesh.py:141"),
    # B10's counts in the epilogues of B1, B4 and B5 (their one-shot
    # entries' counting instances): the shared routine
    "verdict_counts_fused": (
        "jepsen_jgroups_raft_tpu_torch/ops/csrc/verdict_counts.cuh",
        "jepsen_jgroups_raft_tpu/parallel/mesh.py:171"),
    # the chunk entry points of B1, B4 and B5 (one kernel body each, carry in
    # and out): the reference's chunk forms
    "dense_scan_chunk": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/dense_scan.cu",
                         "jepsen_jgroups_raft_tpu/ops/dense_scan.py:755"),
    "mask_scan_chunk": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/mask_scan.cu",
                        "jepsen_jgroups_raft_tpu/ops/dense_scan.py:755"),
    "sort_scan_chunk": ("jepsen_jgroups_raft_tpu_torch/ops/csrc/sort_scan.cu",
                        "jepsen_jgroups_raft_tpu/ops/linear_scan.py:351"),
}
#: kernels no main path launches: the standalone verdict_counts counts
#: flags already in memory, and since the scans count in their epilogues
#: no path calls it. Its numbers go on the `mesh` line, not the kernels
#: line.
OFF_PATH = ("verdict_counts",)
#: kernels built into another kernel's library (ops/_build.py names)
KERNEL_LIBRARY = {"cycle_closure_tiled": "cycle_closure",
                  "verdict_counts_fused": "dense_scan_count",
                  "dense_scan_chunk": "dense_scan",
                  "mask_scan_chunk": "mask_scan",
                  "sort_scan_chunk": "sort_scan"}
#: the libraries of B1's and B4's counting instances (the scans'
#: `counts=True` option), built beside the plain ones
COUNT_LIBRARIES = ("dense_scan_count", "mask_scan_count")
#: timed runs of each main path's check; the best is kept. No warm-up
#: run, to keep the script inside half its time limit: the first timed
#: run stands for it
MAIN_REPS = 2
#: the longest wait for the kernels' checks against their plain versions
#: (`finish_kernel_checks`; they took ~270 s alone)
KERNEL_CHECKS_TIMEOUT_S = 900
#: chunk sizes chunk_kernel holds the chunk forms to their plain
#: versions at (128 is the reference's default JGRAFT_SCAN_CHUNK)
CHUNK_SIZES = (1, 32, 128)


def emit(phase: str, **kw) -> None:
    """One JSON line; `t_s`: seconds since the script started."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - T0}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """Card 0's highest SM clock in Hz (nvidia-smi's clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def lop3_per_s() -> float:
    """LOP3s a second of card 0: LOP3_PER_CLOCK_PER_SM x its SMs x its
    highest SM clock (nvidia-smi's clocks.max.sm)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return LOP3_PER_CLOCK_PER_SM * sms * sm_clock_hz()


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


def suite_histories(kind: str, n: int = N_HISTORIES, **kw):
    """The suite shape: n histories of N_OPS ops, N_PROCS processes,
    crash_p CRASH_P, at most MAX_CRASHES crashes, seed SEED (`kw`: the
    generator's other arguments, e.g. value_range). Returns (histories,
    seconds to make them)."""
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_valid_history)

    t0 = time.perf_counter()
    rng = random.Random(SEED)
    hs = [random_valid_history(rng, kind, n_ops=N_OPS, n_procs=N_PROCS,
                               crash_p=CRASH_P, max_crashes=MAX_CRASHES,
                               **kw)
          for _ in range(n)]
    return hs, time.perf_counter() - t0


def counter10_histories():
    """Counter histories at upstream's documented concurrency: N_OPS ops,
    COUNTER10_SHAPE, seed SEED + 10; the first SUITE_ROWS whose window
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
    while len(kept) < SUITE_ROWS:
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
             kernel: str, ptxas: dict, n_ops: int = N_OPS,
             one_shot: bool = False, measure_chunk: bool = False) -> dict:
    """Drive one main path through check_histories on the card at the
    default chunk (the wavefront over the chunk kernels): best of
    MAIN_REPS (no warm-up: the first run stands for it), each run with
    the launch counts set to 0 just before it and read just after (the
    path's chunk kernel must have launched), with its wavefront
    counters. Guards: every history VALID (valid by construction), every
    row on `tier`. Then the breakdown of
    one run: encode, group + pack, the one-shot kernels overlapped (span,
    per group) and each group alone, ns per row, the plain version's
    time and bitwise agreement on the same groups, the bound from the
    work this run's data needed; the same groups through `run_chunked`
    (best of 3 kernel spans), its verdicts bitwise equal to the one-shot
    groups', its launches per group. `one_shot`: one more check at
    JGRAFT_SCAN_CHUNK=0 (the one-shot path: its wall and launches).
    `measure_chunk`: the chunk kernel on its largest group's first
    wavefront launch (`measure_chunk_launch`). Emits the phase's line;
    returns the kernels-line numbers, and the groups' launches, plain
    stats and verdicts and times alone (for `phase_mask_profile`)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        DenseLaunch, build_dense_launches, consume_stats, consume_tiers,
        run_chunked, run_dense_groups)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        bucket_rows, encode_history, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        MERGE_MAX_EVENTS, chunk_launch_counts, dense_plans_grouped,
        dense_scan_plain, launch_counts, make_dense_chunk_checker,
        mask_scan_plain, reset_launch_counts)

    import numpy as np

    chunk_kernel = kernel + "_chunk"
    consume_tiers()
    walls, launches, wave = [], None, None
    for _ in range(MAIN_REPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        consume_stats()
        t0 = time.perf_counter()
        results = check_histories(histories, model, device=dev)
        walls.append(time.perf_counter() - t0)
        wave = consume_stats()
        launches = {**launch_counts(), **chunk_launch_counts()}
        if launches[chunk_kernel] <= 0:
            raise AssertionError(f"{phase}: the path launched no "
                                 f"{chunk_kernel} kernel")
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
    plain_oks, group_stats, group_plain_ms = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ln in launch_list:
        g: dict = {}
        t1 = time.perf_counter()
        if ln.kind == "mask":
            plain_oks.append(mask_scan_plain(
                ln.events, ln.n_slots, ln.macro_p, ln.n_events, model=model,
                stats=g))
        else:
            plain_oks.append(dense_scan_plain(
                ln.events, ln.val_of, ln.n_slots, macro_p=ln.macro_p,
                n_events=ln.n_events, model=model, stats=g))
        torch.cuda.synchronize()
        group_plain_ms.append((time.perf_counter() - t1) * 1e3)
        group_stats.append(g)
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

    # the same groups through the wavefront: verdicts bitwise equal to
    # the one-shot groups', kernel span (best of 3), launches per group
    triples = [(idxs, plan, b) for (idxs, plan), b in zip(grouped, batches)]
    chunked, outs = None, None
    for _ in range(3):
        chunk_launches, subs = build_dense_launches(model, triples,
                                                    device=dev)
        timer: dict = {}
        outs = run_chunked(chunk_launches, record_stats=False, timer=timer)
        chunked = timer["span_ms"] if chunked is None else \
            min(chunked, timer["span_ms"])
    by_rows = {tuple(idxs): j for j, (idxs, _) in enumerate(grouped)}
    for sub, out in zip(subs, outs):
        if not (out.ok == run.ok[by_rows[tuple(sub)]]).all():
            raise AssertionError(f"{phase}: the wavefront's verdicts differ "
                                 f"from the one-shot groups'")
    chunk_line = {"max_abs_err": 0}
    if measure_chunk:
        j = max(range(len(launch_list)),
                key=lambda k: int(launch_list[k].events.shape[0]))
        ln, b = launch_list[j], batches[j]
        W, S = ln.n_slots, int(ln.val_of.shape[1])
        E = int(ln.events.shape[1])
        init, step = make_dense_chunk_checker(model, ln.kind, W, S,
                                              macro_p=ln.macro_p)
        width = first_span(b["n_events"], 128,
                           E if b["legacy_events"] > MERGE_MAX_EVENTS
                           else bucket_rows(E, 32))
        plain, work, lay = dense_chunk_fns(model, ln.kind, W, S, ln.macro_p)
        # a first launch over the group's whole schedule is the one-shot
        # scan of the group: its plain run above stands for the chunk
        # form's
        p_ok = plain_oks[j].cpu().numpy()
        given = ((p_ok, np.zeros_like(p_ok), group_plain_ms[j],
                  group_stats[j]) if width >= E else None)
        chunk_line = measure_chunk_launch(
            dev, chunk_kernel, step, plain, init(ln.val_of, ln.n_events),
            ln.events, ln.n_events, width, lay, work, given=given)
    arm = None
    if one_shot:
        def go():
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            rs = check_histories(histories, model, device=dev)
            return time.perf_counter() - t0, rs, launch_counts()

        wall, rs, one_launches = with_env("JGRAFT_SCAN_CHUNK", "0", go)
        if [r["valid?"] for r in rs] != [r["valid?"] for r in results] or \
                any("chunked" in r for r in rs) or \
                one_launches[kernel] <= 0:
            raise AssertionError(f"{phase}: the one-shot arm differs, or "
                                 f"launched no {kernel}")
        arm = {"check_s": wall, "launches": one_launches}
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
         chunks_run=wave["chunks_run"], evicted_rows=wave["evicted_rows"],
         groups_run=wave["groups_run"],
         groups_early_exited=wave["groups_early_exited"],
         wavefront={"span_ms": chunked,
                    "kernel_ms_per_group": [o.kernel_ms for o in outs],
                    "launches_per_group": [o.chunks_run for o in outs],
                    "evicted_per_group": [o.evicted_rows for o in outs],
                    "early_exit": [o.early_exit for o in outs],
                    "group_rows": [len(x) for x in subs]},
         chunk_launch=chunk_line, one_shot_arm=arm,
         tiers=tiers, device=torch.cuda.get_device_name(dev),
         power=nvidia_smi_line())
    return {"launches": int(arm["launches"][kernel]) if arm else 0,
            "max_abs_err": err, "ms": span_ms, "plain_ms": plain_ms,
            "t_bytes": t_bytes, "t_ops": t_ops, "check_s_best": best,
            "verdicts": [r["valid?"] for r in results], "groups": launch_list,
            "group_stats": group_stats, "plain_oks": plain_oks,
            "ms_alone": alone_ms,
            "chunk": dict(chunk_line, launches=int(launches[chunk_kernel]))}


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
    models (list-append included) at every window of SORT_WINDOWS (C
    cycling through SORT_CAPS, the row format alternating), short
    histories with C near their frontier (both formats), arbitrary rows,
    the hand-written edge cases (`synth.sort_edge_cases`) and four groups
    at other block shapes and cut tiles. Returns (rows compared, max
    |kernel - plain|, {rows that overflowed and ended ok, and not})."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import (
        random_mask_rows, random_valid_history, sort_edge_cases)
    from jepsen_jgroups_raft_tpu_torch.models import MODELS
    from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import (
        bucket_slots, sort_scan, sort_scan_launcher, sort_scan_plain,
        sort_shape)

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
    # hand-written rows: candidates that collide on one key, keys that
    # differ only in the state or only in the highest key field, distinct
    # counts of exactly C and C + 1, C from 1 to 512
    reg = MODELS["cas-register"]()
    for name, W, C, ev, ne, P in sort_edge_cases():
        check(f"edge_{name}", torch.from_numpy(ev).to(dev),
              torch.from_numpy(ne).to(dev), W, C, P, reg)
    # other block shapes and tiles cut small (rounds tile after tile)
    for kind, W, C in (("set", 8, 64), ("queue", 31, 16),
                       ("list-append", 12, 8), ("counter", 127, 4)):
        m = MODELS[kinds[kind]]()
        encs = [encode_history(h, m) for h in sort_histories(rng, kind, W, 6)]
        ev, ne, P, _ = tensors(encs, True)
        p_ok, p_of = sort_scan_plain(ev, W, C, P, ne, model=m)
        for threads, cap in ((32, None), (32, 1), (256, 8192), (1024, None)):
            shape = sort_shape(W, C, threads, cap)
            ok_k, of_k, launch = sort_scan_launcher(ev, W, C, P, ne, model=m,
                                                    shape=shape)
            launch(torch.cuda.current_stream(dev))
            sync(dev)
            err = max(int((ok_k.int() - p_ok.int()).abs().max()),
                      int((of_k.int() - p_of.int()).abs().max()))
            emit("sort_kernel", case=f"shape_{kind}_W{W}_C{C}",
                 model=m.name, rows=int(ev.shape[0]), W=W, C=C, macro_p=P,
                 shape=list(shape), max_abs_err=err)
            if err != 0:
                raise AssertionError(f"sort_kernel: shape {shape} disagrees "
                                     f"with the plain version")
            compared += int(ev.shape[0])
    if not overflowed["ok"] or not overflowed["not_ok"]:
        raise AssertionError(f"sort_kernel: rows that overflowed and ended "
                             f"ok / not ok: {overflowed}; both expected")
    return compared, max_err, overflowed


def chunk_chain(step, plain, carry, ev, lay, chunk: int, counts: dict,
                name: str):
    """Chain a chunk kernel (`step`, a chunk pair's step_fn) and its plain
    version (`plain`(carry, events, width)) on the card from the same
    carry over ev [B, E, R] in slices of `chunk` rows. After every launch
    the four flags must be equal and the carries agree (`carry_mismatch`
    0: a decided row's slot state is the one thing left undefined);
    halfway both recompact to the rows i with i mod 4 < 2 (carry and
    events gathered, as the wavefront does), so odd (corrupted) and even
    rows stay. Every kernel step must add one to counts[name]. Returns
    (launches, the plain version's last ok)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import carry_mismatch

    ck = cp = carry
    evk = evp = ev
    n = -(-int(ev.shape[1]) // chunk)
    ok = None
    for i in range(n):
        if i == n // 2 and int(ck.shape[0]) > 1:
            idx = torch.tensor([r for r in range(int(ck.shape[0]))
                                if r % 4 < 2], device=ev.device)
            ck, evk, cp, evp = (t.index_select(0, idx)
                                for t in (ck, evk, cp, evp))
        lo = i * chunk
        before = counts[name]
        outk = step(ck, evk[:, lo:lo + chunk], chunk)
        if counts[name] != before + 1:
            raise AssertionError(f"{name}: a chunk step did not launch once")
        outp = plain(cp, evp[:, lo:lo + chunk], chunk)
        sync(ev.device)
        err = carry_mismatch(lay, outk[0], outp[0]) + sum(
            int((a != b).sum()) for a, b in zip(outk[1:], outp[1:]))
        if err:
            raise AssertionError(f"{name}: chunk {i} of {n} at chunk size "
                                 f"{chunk}: {err} entries differ from the "
                                 f"plain version")
        ck, cp, ok = outk[0], outp[0], outp[3]
    return n, ok.cpu()


def phase_chunk_kernel(dev) -> dict:
    """The chunk forms against their plain versions on the card after
    every launch (`chunk_chain`): B1 at W = 1..10 with the largest S the
    caps allow, B4 at W = 1..12 for the counter and the queue, B5 for
    the five models at W = 1, 8, 31, 127 (C = 64, and C = 4 at W = 8,
    where rows overflow) and the hand-written edge cases
    (`synth.sort_edge_cases`). Every case runs chunks of 128 rows and,
    alternating, of 32 or of 1 row (of 1 only where W ≤ 8), in both row
    formats, but B5 at W = 31 and 127 in one format (alternating by
    model): the plain version costs ~35 ms an event there on a host
    core. Returns max |kernel - plain| per chunk kernel (0, or the phase
    fails)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.history.synth import sort_edge_cases
    from jepsen_jgroups_raft_tpu_torch.models import MODELS, CasRegister
    from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls
    from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import (
        DENSE_MAX_CELLS, DENSE_MAX_SLOTS, DENSE_MAX_STATES,
        MASK_DENSE_MAX_SLOTS)

    rng = random.Random(SEED + 11)
    out = {}
    counts = {"dense_scan_chunk": ds.CHUNK_LAUNCHES,
              "mask_scan_chunk": ds.CHUNK_LAUNCHES,
              "sort_scan_chunk": ls.CHUNK_LAUNCHES}

    def run(name, cases):
        t0 = time.perf_counter()
        launches, oks, configs, sizes = 0, set(), 0, set()
        turn = {False: 0, True: 0}  # per row format: 1 row, then 32
        for step, plain, carry, ev, lay, macro, one in cases():
            configs += 1
            second = 1 if one and turn[macro] == 0 else 32
            turn[macro] ^= 1
            for chunk in (128, second):
                n, ok = chunk_chain(step, plain, carry, ev, lay, chunk,
                                    counts[name], name)
                launches += n
                oks.update(ok.tolist())
                sizes.add((chunk, macro))
        if oks != {True, False} or len(sizes) != 6:
            raise AssertionError(f"{name}: both polarities and every chunk "
                                 f"size in both row formats expected")
        emit("chunk_kernel", kernel=name, configs=configs,
             launches_compared=launches, chunk_sizes=sorted(sizes),
             max_abs_err=0, seconds=time.perf_counter() - t0)
        out[name] = 0

    def dense_cases():
        m = CasRegister()
        for W in range(1, DENSE_MAX_SLOTS + 1):
            S = min(DENSE_MAX_STATES, DENSE_MAX_CELLS >> W)
            encs = [encode_history(h, m)
                    for h in cap_histories(rng, W, S, 8, 30)]
            plan = ds.dense_plan(m, encs)
            if plan.n_slots > W or plan.n_states > S:
                raise AssertionError(f"chunk_kernel: W{W} S{S} overflows")
            for macro in (False, True):
                ev, vo, ne, P, _ = group_tensors(encs, plan, macro, dev, W, S)
                init, step = ds.make_dense_chunk_checker(m, "domain", W, S,
                                                         macro_p=P)

                def plain(c, e, w, W=W, S=S, P=P):
                    return ds.dense_chunk_plain(c, e, W, S, P, m, w)
                yield (step, plain, init(vo, ne), ev,
                       ds.dense_carry_layout(W, S), macro, True)

    def mask_cases():
        for kind in ("counter", "queue"):
            m = MODELS[kind]()
            for W in range(1, MASK_DENSE_MAX_SLOTS + 1):
                encs = [encode_history(h, m)
                        for h in mask_histories(rng, kind, W, 8, 40)]
                for macro in (False, True):
                    ev, ne, P = mask_tensors(encs, macro, dev)
                    init, step = ds.make_dense_chunk_checker(m, "mask", W, 1,
                                                             macro_p=P)

                    def plain(c, e, w, W=W, P=P, m=m):
                        return ds.mask_chunk_plain(c, e, W, P, model=m,
                                                   width=w)
                    yield (step, plain, init(None, ne), ev,
                           ds.mask_carry_layout(W), macro, W <= 8)

    def sort_cases():
        for kind, key in (("register", "cas-register"),
                          ("counter", "counter"), ("queue", "queue"),
                          ("set", "set"), ("list-append", "list-append")):
            m = MODELS[key]()
            for W in (1, 8, 31, 127):
                encs = [encode_history(h, m)
                        for h in sort_histories(rng, kind, W, 6)]
                for macro in ((False, True) if W <= 8 else
                              ((len(key) + W) % 2 == 1,)):
                    ev, ne, P = mask_tensors(encs, macro, dev)
                    for C in ((64, 4) if W == 8 else (64,)):
                        init, step = ls.make_sort_chunk_checker(m, C, W,
                                                                macro_p=P)

                        def plain(c, e, w, W=W, C=C, P=P, m=m):
                            return ls.sort_chunk_plain(c, e, W, C, P,
                                                       model=m, width=w)
                        yield (step, plain, init(ne), ev,
                               ls.sort_carry_layout(W, C), macro, W <= 8)
        m = CasRegister()
        for _, W, C, ev, ne, P in sort_edge_cases():
            ev, ne = torch.from_numpy(ev).to(dev), torch.from_numpy(ne).to(dev)
            init, step = ls.make_sort_chunk_checker(m, C, W, macro_p=P)

            def plain(c, e, w, W=W, C=C, P=P):
                return ls.sort_chunk_plain(c, e, W, C, P, model=m, width=w)
            yield (step, plain, init(ne), ev, ls.sort_carry_layout(W, C),
                   P is not None, True)

    run("dense_scan_chunk", dense_cases)
    run("mask_scan_chunk", mask_cases)
    run("sort_scan_chunk", sort_cases)
    return out


def first_span(n_events, chunk: int, e_sched: int) -> int:
    """Width of a group's first wavefront launch (checker/schedule.py
    `_span_chunks` from a fresh group): up to the first boundary where a
    row can retire, a power-of-two number of chunks."""
    first = int(min(n_events)) if len(n_events) else 0
    p = max(1, -(-first // chunk))
    p = min(p, -(-e_sched // chunk))
    return (1 << (p.bit_length() - 1) if p > 1 else 1) * chunk


def dense_chunk_fns(model, kind: str, W: int, S: int, macro_p) -> tuple:
    """The plain chunk form of a dense group's kernel (B1 for a domain
    group, B4 for a mask group) as `measure_chunk_launch` calls it, the
    32-bit operations its counted work needs (the bound, as `run_path`
    counts it for the one-shot kernels), and its carry layout."""
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_carry_layout, dense_chunk_plain, mask_carry_layout,
        mask_chunk_plain)

    if kind == "mask":
        def plain(c, e, w, st):
            return mask_chunk_plain(c, e, W, macro_p, model=model, width=w,
                                    stats=st)

        def work(g, sl):
            M = 1 << W
            return (g["slot_passes"] * max(M // 64, 1)
                    + g["force_rows"] * max(M // 32, 1)
                    + g["legal_needed"] * LEGAL_STEP_OPS[model.name]
                    + int(sl[:, :, 2].clamp(min=0).sum()))
        return plain, work, mask_carry_layout(W)

    def plain(c, e, w, st):
        return dense_chunk_plain(c, e, W, S, macro_p, model, w, st)

    def work(g, sl):
        MS = (1 << W) * S
        return (g["slot_passes"] * max(MS // 64, 1) * S
                + g["force_rows"] * max(MS // 32, 1)
                + int(sl[:, :, 2].clamp(min=0).sum()) * S * S)
    return plain, work, dense_carry_layout(W, S)


def measure_chunk_launch(dev, name: str, step, plain, carry, ev, ne,
                         width: int, lay, work, given=None) -> dict:
    """One launch of a chunk kernel at a main path's shape (a group's
    first wavefront launch): its time by CUDA events (best of 3), its
    plain version's time on the card and agreement (flags and carry),
    and the bound: the carry read and written, the real event rows and
    the flags at HBM_BYTES_PER_S, against `work(stats)`, the 32-bit
    operations the plain version counted, at CORE_OPS_PER_S. `given`
    (ok, overflow, plain ms, stats): a launch that covers its rows'
    whole schedule from a fresh carry is the one-shot scan, so the
    caller's one-shot plain run of the same rows stands for the plain
    version (the flags are compared; the carry is held to the plain
    chunk form by `chunk_kernel`)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops.kernel_ir import carry_mismatch

    sl = ev[:, :width]
    ms = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        outk = step(carry, sl, width)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    if given is None:
        stats: dict = {}
        sync(dev)
        t0 = time.perf_counter()
        outp = plain(carry, sl, width, stats)
        sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = carry_mismatch(lay, outk[0], outp[0]) + sum(
            int((a != b).sum()) for a, b in zip(outk[1:], outp[1:]))
    else:
        p_ok, p_of, plain_ms, stats = given
        if not bool(outk[2].all()):
            raise AssertionError(f"{name}: `given` needs a launch over the "
                                 f"whole schedule")
        err = int((outk[3].cpu().numpy() != p_ok).sum()) + \
            int((outk[4].cpu().numpy() != p_of).sum())
    if err:
        raise AssertionError(f"{name}: the main path's launch differs from "
                             f"the plain version ({err} entries)")
    B, _, R = (int(x) for x in ev.shape)
    rows = int(ne.clamp(min=0, max=width).sum())
    bytes_moved = 2 * carry.numel() * 4 + rows * R * 4 + 4 * B
    ops = work(stats, sl)
    return {"rows": B, "width": width, "carry_ints": int(carry.shape[1]),
            "kernel_ms_reps": ms, "ms": min(ms), "plain_ms": plain_ms,
            "bytes": bytes_moved, "ops": ops,
            "t_bytes": bytes_moved / HBM_BYTES_PER_S,
            "t_ops": ops / CORE_OPS_PER_S, "max_abs_err": err}


def plain_ladder(encs, model, dev, stats=None, rung_stats=None):
    """The sort ladder's verdicts from the plain version: per row True
    (ok at a rung), False (not ok, no overflow) or None (overflowed at the
    top rung). Returns (verdicts, per rung (rows, plain ms, ok, overflow)).
    `stats` accumulates the plain version's work counters over the
    rungs; `rung_stats`, a list, gets each rung's own."""
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
        one: dict = {}
        ok, of = sort_scan_plain(ev, W, C, b["macro_p"], ne, model=model,
                                 stats=one)
        if rung_stats is not None:
            rung_stats.append(one)
        if stats is not None:
            for k, v in one.items():
                stats[k] = stats.get(k, 0) + v
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
                  ptxas: dict, one_shot: bool = False,
                  measure_chunk: bool = False, measure_fused: bool = False,
                  **extra) -> dict:
    """A ladder path (the set, list-append) through check_histories on
    the card at the default chunk, as `run_path` measures the others:
    best of MAIN_REPS (no warm-up) with the launch counts set to 0 just
    before each run and read just after; guards: every history VALID,
    every row on the sort tier, 0 host rows, sort_scan_chunk launched.
    Then the ladder's breakdown: encode, pack, each rung's rows, one-shot
    kernel ms (CUDA events, best of 3) and ns per row, escalations, the
    rung through `run_chunked` (flags bitwise equal to the one-shot
    rung's, its kernel span and launches), the plain version's time and
    bitwise flags on the same rungs, and the bound from the work this
    run's data needed. `one_shot` and `measure_chunk` as `run_path`'s
    (the measured launch: the C = 64 rung's first). `measure_fused`: what
    the counting option adds to the first rung's one-shot launch
    (`fused_added`), under "fused". Returns the kernels-line numbers."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        SORT_LADDER, check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        ChunkLaunch, consume_stats, consume_tiers, run_chunked,
        run_sort_rung)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        bucket_rows, encode_history, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

    consume_tiers()
    walls, launches, wave = [], None, None
    for _ in range(MAIN_REPS):
        torch.cuda.synchronize()
        ds.reset_launch_counts()
        ls.reset_launch_counts()
        consume_stats()
        t0 = time.perf_counter()
        results = check_histories(histories, model, device=dev)
        walls.append(time.perf_counter() - t0)
        wave = consume_stats()
        launches = {**ds.launch_counts(), **ls.launch_counts(),
                    **ds.chunk_launch_counts(), **ls.chunk_launch_counts()}
        if launches["sort_scan_chunk"] <= 0:
            raise AssertionError(f"{phase}: the path launched no "
                                 f"sort_scan_chunk kernel")
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
    # the plain version on the same rungs: time, flags, and the work the
    # data needed
    g: dict = {}
    rung_stats: list = []
    _, plain = plain_ladder(encs, model, dev, stats=g, rung_stats=rung_stats)
    remaining, rungs, pack_s = list(range(n)), [], 0.0
    bytes_moved = 0
    chunk_line = {"max_abs_err": 0}
    fused = None
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
        # the rung through the wavefront: the one-shot rung's flags
        init, step = ls.make_sort_chunk_checker(model, C, W,
                                                macro_p=b["macro_p"])
        e_sched = bucket_rows(int(ev.shape[1]), 32)
        timer: dict = {}
        [out] = run_chunked([ChunkLaunch(
            events=b["events"], n_events=b["n_events"], init_fn=init,
            step_fn=step, e_sched=e_sched, device=dev, tag="sort")],
            record_stats=False, timer=timer)
        if not ((out.ok == run.ok).all() and
                (out.overflow == run.overflow).all()):
            raise AssertionError(f"{phase}: the wavefront's flags differ "
                                 f"from the one-shot rung's at C = {C}")
        if measure_fused and not rungs:
            fused = dict(fused_added(
                ls.sort_scan_launcher(ev, W, C, b["macro_p"], ne,
                                      model=model)[-1],
                lambda real: ls.sort_scan_launcher(
                    ev, W, C, b["macro_p"], ne, model=model, counts=True,
                    real=real), "sort"), C=C, W=W)
        if measure_chunk and not rungs:
            lay = ls.sort_carry_layout(W, C)
            width = first_span(b["n_events"], 128, e_sched)

            def chunk_plain(c, e, w, st):
                return ls.sort_chunk_plain(c, e, W, C, b["macro_p"],
                                           model=model, width=w, stats=st)
            # a first launch over the whole rung is the one-shot rung: its
            # plain run above stands for the chunk form's
            given = ((plain[0][2], plain[0][3], plain[0][1], rung_stats[0])
                     if width >= int(ev.shape[1]) else None)
            chunk_line = measure_chunk_launch(
                dev, "sort_scan_chunk", step, chunk_plain, init(ne), ev, ne,
                width, lay, lambda st, sl: st["steps"] + st["candidates"],
                given=given)
        # the mean closure rounds a row (the plain version's count) and
        # the kernel's time per round of a row; the rung at other shapes
        rounds = rung_stats[len(rungs)]["rounds"]
        per_row = rounds / max(B, 1)
        shapes = rung_shapes(phase, ev, ne, W, C, b["macro_p"], model,
                             run.ok, run.overflow)
        rungs.append({"C": C, "rows": B, "macro_p": int(b["macro_p"]),
                      "events": int(ev.shape[1]), "longest_rows": longest,
                      "kernel_ms_reps": ms, "kernel_ms": min(ms),
                      "ns_per_row": min(ms) * 1e6 / longest,
                      "rounds": rounds, "mean_rounds_a_row": per_row,
                      "ns_per_round": min(ms) * 1e6 / max(per_row, 1e-9),
                      "shape": list(ls.sort_shape(W, C)),
                      "ms_by_threads": shapes,
                      "valid": int(run.ok.sum()),
                      "overflow": int(run.overflow.sum()),
                      "escalated": len(escalate),
                      "wavefront": {"span_ms": timer["span_ms"],
                                    "kernel_ms": out.kernel_ms,
                                    "launches": out.chunks_run,
                                    "evicted": out.evicted_rows,
                                    "early_exit": out.early_exit},
                      "ok": run.ok, "overflow_flags": run.overflow})
        remaining = escalate
        if not remaining:
            break
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
    arm = None
    if one_shot:
        def go():
            torch.cuda.synchronize()
            ls.reset_launch_counts()
            t0 = time.perf_counter()
            rs = check_histories(histories, model, device=dev)
            return time.perf_counter() - t0, rs, ls.launch_counts()

        wall, rs, one_launches = with_env("JGRAFT_SCAN_CHUNK", "0", go)
        if [r["valid?"] for r in rs] != [r["valid?"] for r in results] or \
                one_launches["sort_scan"] <= 0:
            raise AssertionError(f"{phase}: the one-shot arm differs, or "
                                 f"launched no sort_scan")
        arm = {"check_s": wall, "launches": one_launches}
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
         chunks_run=wave["chunks_run"], evicted_rows=wave["evicted_rows"],
         groups_run=wave["groups_run"],
         groups_early_exited=wave["groups_early_exited"],
         chunk_launch=chunk_line, one_shot_arm=arm,
         tiers=tiers, device=torch.cuda.get_device_name(dev),
         power=nvidia_smi_line())
    return {"launches": int(arm["launches"]["sort_scan"]) if arm else 0,
            "max_abs_err": err, "ms": ms_total, "plain_ms": plain_ms,
            "t_bytes": t_bytes, "t_ops": t_ops, "fused": fused,
            "chunk": dict(chunk_line,
                          launches=int(launches["sort_scan_chunk"]))}


def rung_shapes(phase: str, ev, ne, W: int, C: int, P, model, ok,
                overflow) -> dict:
    """One ladder rung's kernel at each block size of SORT_SHAPE_THREADS
    the kernel takes at this W (its default tile rule): best of 3 ms by
    CUDA events; the flags must equal the default shape's (ok and
    overflow, host numpy)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

    out = {}
    stream = torch.cuda.current_stream(ev.device)
    for threads in SORT_SHAPE_THREADS:
        shape = ls.sort_shape(W, C, threads)
        if shape[0] != threads:
            continue
        ms = []
        for _ in range(3):
            k_ok, k_of, launch = ls.sort_scan_launcher(
                ev, W, C, P, ne, model=model, shape=shape)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record(stream)
            launch(stream)
            b.record(stream)
            b.synchronize()
            ms.append(a.elapsed_time(b))
        if (k_ok.cpu().numpy() != ok).any() or \
                (k_of.cpu().numpy() != overflow).any():
            raise AssertionError(f"{phase}: the rung at C = {C} gives "
                                 f"other flags at {threads} threads")
        out[str(threads)] = min(ms)
    return out


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
    every row INVALID and on the sort tier. Returns the corrupted
    histories."""
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
    return bad


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


def segment_profile(dev, batch, model, F) -> dict:
    """B6's instrumented build (`segment_scan_profile`, never on a main
    path) on a segment batch: SM cycles by phase summed over the launch's
    warps and their shares, closures a live warp, sweeps and slot images
    a closure; the launch's residency (the instantiation's registers,
    local bytes, threads and dynamic shared bytes a block, blocks and
    warps an SM can hold and the warps its busiest SM holds, the SMs
    used, the waves); and the chain floor: the longest warp's rows × the
    fewest cycles a row of any live warp (its own phases, not the wait
    for the CTA's others), at the card's highest SM clock — what one
    warp's serial chain of events costs at the least, beside the bound
    that treats the runs' operations as independent. Its tables must
    equal F, the kernel's, bit for bit."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops.segment_scan import (
        SEGMENT_PROFILE_FIELDS, segment_attributes, segment_scan_profile)

    ev, vo, sm, st, ne = batch.tensors(dev)
    Fp, prof = segment_scan_profile(ev, vo, sm, st, batch.W, ne, model)
    sync(dev)
    if not torch.equal(Fp, F):
        raise AssertionError("segment_profile: the instrumented build's "
                             "tables differ from the kernel's")
    p = prof.cpu().numpy().astype(np.float64)
    col = {k: i for i, k in enumerate(SEGMENT_PROFILE_FIELDS)}
    phases = ("stage", "latch", "closure", "force", "tail")
    # a warp's own chain: every phase but the wait for the CTA's others
    cyc = sum(p[:, col[f"{x}_cycles"]] for x in phases[:-1])
    rows = p[:, col["rows"]]
    live = rows > 0
    total = {k: float(p[:, i].sum()) for k, i in col.items()}
    all_cycles = sum(total[f"{x}_cycles"] for x in phases)
    cpr = cyc[live] / rows[live]
    clock = sm_clock_hz()
    K, NB = int(sm.shape[0]), int(sm.shape[1])
    att = segment_attributes(batch.W, batch.S, K, NB, int(ev.shape[1]))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_wave = max(att["blocks_per_sm"], 1) * sms
    longest = float(rows.max()) if live.any() else 0.0
    warps = att["threads"] // 32
    return {
        "runs": K * NB, "warps": len(p), "live_warps": int(live.sum()),
        **total,
        "share": {x: total[f"{x}_cycles"] / max(all_cycles, 1.0)
                  for x in phases},
        "closures_per_live_warp": total["closures"] / max(live.sum(), 1),
        "sweeps_per_closure": total["sweeps"] / max(total["closures"], 1),
        "images_per_closure": total["images"] / max(total["closures"], 1),
        "cycles_per_row_min": float(cpr.min()) if live.any() else None,
        "cycles_per_row_median": float(np.median(cpr))
        if live.any() else None,
        "cycles_per_row_all": all_cycles / max(total["rows"], 1.0),
        "longest_run_rows": longest, "sm_clock_hz": clock,
        "chain_floor_ms": (longest * float(cpr.min()) / clock * 1e3
                           if live.any() else 0.0),
        "attributes": att,
        "warps_per_sm_limit": att["blocks_per_sm"] * warps,
        "warps_per_sm_used": min(att["blocks_per_sm"],
                                 -(-att["blocks"] // sms)) * warps,
        "sms_used": min(sms, att["blocks"]),
        "waves": -(-att["blocks"] // per_wave)}


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
                                                   segment_scan,
                                                   verdict_counts)

    for mod in (dense_scan, linear_scan, segment_scan, election_safety,
                verdict_counts):
        mod.reset_launch_counts()


def all_launch_counts() -> dict:
    from jepsen_jgroups_raft_tpu_torch.ops import (dense_scan,
                                                   election_safety,
                                                   linear_scan,
                                                   segment_scan,
                                                   verdict_counts)

    return {**dense_scan.launch_counts(), **linear_scan.launch_counts(),
            **dense_scan.chunk_launch_counts(),
            **linear_scan.chunk_launch_counts(),
            **dense_scan.count_launch_counts(),
            **linear_scan.count_launch_counts(),
            **segment_scan.launch_counts(),
            **election_safety.launch_counts(),
            **verdict_counts.launch_counts()}


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
    lib = "segment_scan" if arm == "1" else "dense_scan_chunk"
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


def segment_kernel_timed(dev, batch, model) -> tuple:
    """segment_scan on a segment batch's own tensors (config 5's in
    long_main): the wrapper call (CUDA events, best of 3) against its
    plain version (bitwise on every table bit, with the work it did), the
    tables composed to VALID, the bound; the kernel's device-only ms
    (its C entry point on a held stream), its launch shape, and the
    instrumented build's profile, residency and chain floor. Returns the
    fields for long_main's line and the kernels-line numbers (launches
    left to the caller)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss

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
        raise AssertionError("segment_scan disagrees with its plain "
                             "version on the batch")
    verdict = ss.compose_segment_tables(batch, F.cpu().numpy())
    if not verdict or not all(r["valid"] for r in verdict):
        raise AssertionError("segment_scan: composed tables not VALID")
    # bound: the segments' real rows (5 int32 each), n_events, val_of and
    # the seeds read once, the packed tables written once; operations as
    # the plain version counted them over the runs still alive (a closure
    # pass: one per word of the M·S/2 source bits per state plane; a
    # FORCE, one per frontier word; a latch, S² compares)
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
    _, launch = ss.segment_scan_launcher(ev, vo, sm, st, batch.W, ne, model)
    device_ms = launch_device_ms(launch)
    prof = segment_profile(dev, batch, model, F)
    fields = dict(kernel_ms_reps=times, kernel_ms=min(times),
                  device_ms=device_ms,
                  shape=list(ss.segment_shape(batch.W, S, NB)),
                  profile=prof, plain_ms=plain_ms, max_abs_err=err,
                  runs=K * NB,
                  live_runs=int(plain.flatten(2).any(dim=2).sum()),
                  plain_stats=g, bytes_moved=bytes_moved, word_ops=ops,
                  bound_ms=max(t_bytes, t_ops) * 1e3,
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
    return fields, {"max_abs_err": err, "ms": min(times),
                    "device_ms": device_ms, "plain_ms": plain_ms,
                    "t_bytes": t_bytes, "t_ops": t_ops,
                    "chain_floor_ms": prof["chain_floor_ms"]}


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
            timed, out["line"] = segment_kernel_timed(dev, batch, model)
            out["line"]["launches"] = int(
                arms["1"]["launches"]["segment_scan"])
            line.update(timed)
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
            not launches.get("sort_scan_chunk"):
        raise AssertionError("wide_auto: a chain was not INVALID on the "
                             "sort tier, the host DFS disagreed, or "
                             "sort_scan_chunk was never launched")


def phase_lin_fastpath(dev, histories):
    """The first LIN_FASTPATH_ROWS north-star histories through
    check_encoded on the card at JGRAFT_AUTOTUNE's default (1; the run's
    pin lifted), the store in a fresh directory under build/: first one
    check with JGRAFT_LIN_FASTPATH at 0 that measures the launch plans
    into the store (and stands for the warm-up), so that the arms
    compare the gate alone under the same plans; then with the fast path
    at 0 (one timed run), then with it unset (the default) twice — the
    first run on an empty gate tries the host certifier, the second
    routes by the hit rate the first measured, as the reference's gate
    does (a bucket under JGRAFT_LIN_FASTPATH_MIN_HIT goes kernel-first).
    Verdicts identical; certified, gated and kernel rows, the walls of
    every run and the plan counters of the measuring check."""
    from jepsen_jgroups_raft_tpu_torch.checker import autotune
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
    plans: dict = {}

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
        # the launch plans every arm uses, measured before the arms
        autotune.reset_for_tests()
        check_encoded(encs, model, device=dev)
        plans.update(autotune.consume_counters())
        return timed()

    def default():
        return [timed(), timed()]

    runs = {}
    with_plans = {"JGRAFT_AUTOTUNE": None, "JGRAFT_AUTOTUNE_STORE": str(store)}
    runs["off"] = with_envs({**with_plans, "JGRAFT_LIN_FASTPATH": "0"}, off)
    runs["first"], runs["second"] = with_envs(
        {**with_plans, "JGRAFT_LIN_FASTPATH": None}, default)
    autotune.reset_for_tests()
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
         runs=runs, verdicts_identical=identical,
         plans_measured_before_arms=plans)
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


#: GPU clock cycles `torch.cuda._sleep` holds the stream for while the
#: host enqueues one timed closure launch (~1 ms)
HOLD_CYCLES = 2_000_000


def closure_kernel_ms(bits, N: int, tile=None, reps: int = 5) -> float:
    """Device time of one closure launch's kernels alone (not the
    wrapper's allocations, nor the copy B8's wrapper makes to close in
    place): least over `reps`, after a warm-up, of CUDA events recorded
    around a call of the C entry point on a stream that
    `torch.cuda._sleep` keeps busy while the host enqueues event, launch
    and event, so that the events bracket the kernels and nothing of the
    host. Each launch starts from a fresh copy of `bits`, made before the
    events. Reported as `device_ms` beside the wrapper call's `ms`."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import _build
    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import _device_index

    lib = _build.load("cycle_closure")
    B = int(bits.shape[0])
    out = torch.empty_like(bits)
    has = torch.empty((B,), dtype=torch.bool, device=bits.device)
    dev = _device_index(bits.device)
    stream = torch.cuda.current_stream(bits.device)

    def launch():
        if N > 512:
            return lib.cycle_closure_tiled_launch(
                out.data_ptr(), has.data_ptr(), B, N, cc._kernel_tile(N, tile),
                dev, stream.cuda_stream)
        return lib.cycle_closure_launch(
            bits.data_ptr(), out.data_ptr(), has.data_ptr(), B, N, dev,
            stream.cuda_stream)

    times = []
    for _ in range(reps + 1):
        out.copy_(bits)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        rc = launch()
        b.record()
        b.synchronize()
        if rc != 0:
            raise AssertionError(f"closure launch at N={N} refused: {rc}")
        times.append(a.elapsed_time(b))
    return min(times[1:])


def launch_device_times(launch, reps: int) -> list:
    """`launch_device_ms`'s device times of launch(stream), every one of
    `reps` runs (no warm-up)."""
    import torch

    stream = torch.cuda.current_stream()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        launch(stream)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def launch_device_ms(launch, reps: int = 5) -> float:
    """Device time of one kernel launch alone: least over `reps`, after a
    warm-up, of CUDA events recorded around launch(stream) — a call of
    the kernel's C entry point, not its Python wrapper — on a stream that
    `torch.cuda._sleep` keeps busy while the host enqueues event, launch
    and event, so that the events bracket the kernel and nothing of the
    host. Reported as `device_ms` beside the wrapper call's `ms`."""
    return min(launch_device_times(launch, reps + 1)[1:])


def fold_work(adj, N: int, tile=None) -> dict:
    """B8's fold work on one batch adj [B, N, N] (on the card), counted on
    the plain version's blocked Floyd-Warshall state at the kernel's tile
    T: per pivot block kb, the row panel's folds read C = D* (the closed
    diagonal tile) for N/T - 1 tiles, the rest's read C = A[ib, kb] (as
    it stands before the column panel's fold, a lower bound of what the
    kernel reads) for N/T tiles each. A unit is one warp's 32 rows times
    one 32-pivot word of C: 32 x 32 x T/32 LOP3s, skipped when that word
    is zero in all 32 rows. Returns the share of units skipped and the
    LOP3s of the units done plus the diagonal tiles' dense closure."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc

    B = int(adj.shape[0])
    t = cc._kernel_tile(N, tile)
    nt, tw = N // t, t // 32
    a = (adj != 0).to(torch.float32)

    def live(c):
        """nonzero (warp, 32-pivot word) units of C [B, R, T]."""
        return int((c.reshape(B, -1, 32, tw, 32).amax(dim=(2, 4)) > 0).sum())

    def closed(x):
        return ((x + (torch.bmm(x, x) > 0)) > 0).to(torch.float32)

    done = total = 0
    for kb in range(nt):
        o = kb * t
        d = a[:, o:o + t, o:o + t]
        for _ in range(max(1, (t - 1).bit_length())):
            d = closed(d)
        done += live(d) * (nt - 1)
        total += B * tw * tw * (nt - 1)
        row = ((a[:, o:o + t, :] + (torch.bmm(d, a[:, o:o + t, :]) > 0))
               > 0).to(torch.float32)
        a[:, o:o + t, :] = row
        col = a[:, :, o:o + t].clone()
        rest = torch.cat([col[:, :o], col[:, o + t:]], dim=1)
        done += live(rest) * nt
        total += B * (nt - 1) * tw * tw * nt
        col = ((col + (torch.bmm(col, d) > 0)) > 0).to(torch.float32)
        a[:, :, o:o + t] = col
        a = ((a + (torch.bmm(col, row) > 0)) > 0).to(torch.float32)
    return {"tile": t, "skipped_share": 1 - done / max(1, total),
            "lop3": done * 32 * 32 * tw + B * nt * t ** 3 // 32}


def cycle_graphs(N: int, seed: int):
    """[G, N, N] int32 test graphs of bucket N: a random digraph (1.5
    edges a node), a dense DAG, a long chain, a planted N-cycle, a
    zero-padded random graph, a dense random digraph
    (p = 0.5), the complete and the empty digraph, nodes shuffled (no
    DAG or padded graph above 2048 nodes, where the plain version takes
    seconds). Returns (graphs, kinds)."""
    import numpy as np

    kinds = (("random", "chain", "cycle") if N > 2048 else
             ("random", "dag", "chain", "cycle", "padded")) + \
        ("dense", "complete", "empty")
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
    wrapper call's time on packed bits, the plain version's and (with
    `library`) the library yardstick's (CUDA events), the bound, and the
    closure's density (set bits over B N^2)."""
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
           "shape": list(cc.closure_shape(N, tile)),
           "density": float(p_closed.float().mean())
           if p_closed.numel() else 0.0,
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
    of CYCLE_BUCKETS (every form of `closure_shape`), bitwise on every
    bit of `closed` and on has_cycle, has_cycle also against the host
    DFS; the kernel timed, the plain version and (at
    CYCLE_LIBRARY_BUCKETS) the library yardstick.
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
                or m["has_cycle"][kinds.index("chain")] \
                or m["has_cycle"][kinds.index("empty")]:
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
    with a late stale read. Arms: the default knobs (the run's
    JGRAFT_AUTOTUNE pin lifted; the store, launch plans and cycle arms,
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
        arms = (("default", {"JGRAFT_AUTOTUNE": None,
                             "JGRAFT_AUTOTUNE_STORE": str(store)}),
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
    knobs (the run's JGRAFT_AUTOTUNE pin lifted, the store in a fresh
    directory): every planted row
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
                                 ("default", {"JGRAFT_AUTOTUNE": None,
                                              "JGRAFT_AUTOTUNE_STORE":
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


def closure_functions(N: int, shape, tile=None) -> list:
    """(ptxas entry-function name fragment, dynamic shared memory bytes)
    of each kernel a closure launch of `shape` runs at bucket N (see
    ops/csrc/cycle_closure.cu)."""
    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc

    nw = cc.words_per_row(N)
    if shape.form == "warp":
        return [(f"closure_warpILi{nw}E", 0)]
    if shape.form == "panels":
        mw = 1 << (nw - 1).bit_length()
        return [(f"closure_panelsILi{mw}E",
                 (32 * mw + 32 * nw * (nw | 1)) * 4)]
    tw = cc._kernel_tile(N, tile) // 32
    return [(f"close_diagonalILi{tw}E", 0),
            (f"fold_tilesILi{tw}E", 0)]


def closure_resources(N: int, shape, tile=None) -> list:
    """ptxas's registers, static shared memory, stack and spill bytes of
    each kernel of a closure launch, with its dynamic shared memory."""
    from jepsen_jgroups_raft_tpu_torch.ops import _build

    funcs = _build.ptxas_functions("cycle_closure")
    out = []
    for frag, dyn in closure_functions(N, shape, tile):
        hit = [dict(v, function=k) for k, v in funcs.items() if frag in k]
        if len(hit) != 1:
            raise AssertionError(f"ptxas report: {len(hit)} functions "
                                 f"match {frag}")
        out.append(dict(hit[0], dynamic_smem_bytes=dyn))
    return out


def closure_line(dev, kernel: str, batches: dict, launches: int,
                 err: int) -> dict:
    """A kernels-line entry for a closure kernel from the batches the main
    path gave it (one per bucket): kernel bitwise against its plain
    version on each; the wrapper calls' event-timed ms summed as `ms`,
    as every kernel's `ms` is timed, and the kernels' device-only times
    (`closure_kernel_ms`) as `device_ms`; bound from these inputs. Per
    bucket also the closure's density, the LOP3 floor of the dense fold
    (N^3/32 word operations a graph at `lop3_per_s`) and, for B8, the
    share of fold units skipped on this data and the LOP3 floor of the
    work done (`fold_work`)."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc
    from jepsen_jgroups_raft_tpu_torch.ops.cycle_closure import (
        pack_adjacency, unpack_adjacency)

    rate = lop3_per_s()
    total = {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
             "library_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0}
    per = []
    for N, graphs in sorted(batches.items()):
        adj = torch.from_numpy(unpack_adjacency(
            pack_adjacency(graphs, N), N).astype("int32")).to(dev)
        m = closure_measure(dev, N, adj)
        err = max(err, m["max_abs_err"], m["library_err"])
        shape = cc.closure_shape(N)
        dev_ms = closure_kernel_ms(cc.pack_bits(adj), N)
        B = m["graphs"]
        row = {**{k: m[k] for k in ("N", "graphs", "plain_ms", "library_ms",
                                    "density")},
               "ms": m["kernel_ms"], "device_ms": dev_ms,
               "shape": list(shape),
               "device_us_per_graph": dev_ms * 1e3 / max(1, B),
               "dense_lop3_floor_ms": B * N ** 3 / 32 / rate * 1e3,
               "kernels": closure_resources(N, shape)}
        if shape.form == "tiled":
            work = fold_work(adj, N)
            row.update(fold_skipped_share=work["skipped_share"],
                       lop3_floor_ms=work["lop3"] / rate * 1e3)
        per.append(row)
        total["ms"] += m["kernel_ms"]
        total["device_ms"] += dev_ms
        total["plain_ms"] += m["plain_ms"]
        total["library_ms"] += m["library_ms"]
        total["t_bytes"] += m["t_bytes"]
        total["t_ops"] += m["t_ops"]
        del adj
        torch.cuda.empty_cache()
    emit("closure_main_path", kernel=kernel, batches=per, **total,
         lop3_per_s=rate, max_abs_err=err)
    if err:
        raise AssertionError(f"{kernel}: disagrees with its plain version "
                             f"on the main path's batches")
    return {"launches": launches, "max_abs_err": err, **total}


#: election_kernel: the kernel against its plain version at these row
#: lengths (each with every case of `election_cases`), then timed at the
#: users' size: 512 election runs × 4096 pooled observations
ELECTION_NS = (1, 2, 31, 32, 33, 1024, 4096, 8192, 8193, 65536)
ELECTION_BATCH = (512, 4096)
#: election_kernel also times the global form at one N it takes alone
#: (rows × observations)
ELECTION_LARGE = (16, 65536)
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
    from jepsen_jgroups_raft_tpu_torch.ops import election_safety as es
    from jepsen_jgroups_raft_tpu_torch.ops.election_safety import (
        election_safety)

    def both(obs, valid_len=None):
        got = check_election_safety(obs, valid_len).cpu()
        want = check_election_safety_plain(obs, valid_len).cpu()
        return got.tolist(), int((got != want).sum())

    def global_form(obs, valid_len=None):
        # the global form on rows the shared form takes: against the plain
        # version, outside the launch count
        safe, launch = es.election_safety_launcher(obs, valid_len,
                                                   form="global")
        launch(torch.cuda.current_stream())
        want = check_election_safety_plain(obs, valid_len).cpu()
        return int((safe.cpu() != want).sum())

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
        if es.election_form(N) == "shared":
            bad_global = global_form(t) + global_form(t, vl)
            err = max(err, bad_global)
            compared += 2 * len(kinds)
            if bad_global:
                raise AssertionError(f"election_kernel N={N}: the global "
                                     f"form disagrees with the plain "
                                     f"version")
        expect = {"safe": True, "repeated": True, "padded": True}
        if N > 1:
            expect.update(early=False, middle=False, last=False)
        view = dict(zip(kinds, got))
        emit("election_kernel", N=N, form=es.election_form(N),
             verdicts=view, mismatches=bad, mismatches_valid_len=bad_vl)
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
    # each form's kernels alone on these rows (the global form's memsets
    # included), its verdicts bitwise
    device_ms = {}
    for form in ("shared", "global"):
        safe, launch = es.election_safety_launcher(t, form=form)
        device_ms[form] = launch_device_ms(launch, reps=10)
        if safe.cpu().tolist() != got:
            raise AssertionError(f"election_kernel: the {form} form's "
                                 f"verdicts differ at the users' size")
    # the global form where it is the only one: ELECTION_LARGE
    LB, LN = ELECTION_LARGE
    large = synth.election_observation_rows(rng, LB, LN)
    large[3, LN - 1] = (large[3, 0, 0], large[3, 0, 1] + 1)
    lt = torch.from_numpy(large).to(dev)
    lgot, lbad = both(lt)
    if lbad or lgot[3] or es.election_form(LN) != "global":
        raise AssertionError("election_kernel: the large rows disagree "
                             "with the plain version")
    _, llaunch = es.election_safety_launcher(lt)
    large_line = {"rows": LB, "observations": LN, "form": "global",
                  "ms": event_ms(lambda: election_safety(lt), reps=10),
                  "device_ms": launch_device_ms(llaunch, reps=10),
                  "bound_ms": (8 * LB * LN + LB) / HBM_BYTES_PER_S * 1e3}

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
         form=es.election_form(N), kernel_ms=kernel_ms,
         device_ms=device_ms, plain_ms=plain_ms,
         bound_ms=max(t_bytes, t_ops) * 1e3, t_bytes=t_bytes, t_ops=t_ops,
         cases_compared=compared, large=large_line)
    return {"max_abs_err": err, "ms": kernel_ms,
            "device_ms": device_ms[es.election_form(N)],
            "plain_ms": plain_ms, "t_bytes": t_bytes, "t_ops": t_ops,
            "library_ms": None}


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
    for k in ("dense_scan_chunk", "mask_scan_chunk", "sort_scan_chunk"):
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


#: B10's edge sizes: verdict_counts is held to its plain version, bitwise,
#: at each, in both modes, on flags sliced at unaligned offsets too
#: (16384 / 16385: both sides of its one-block limit), in both grid forms
VERDICT_SIZES = (0, 1, 31, 32, 33, 1000, 16384, 16385, 1 << 20)
#: batch sizes of the scans' fused counts (one row, a warp's worth around
#: a block's edges, the north star's batch), with and without `real`
FUSED_SIZES = (1, 31, 32, 33, 1000)
#: B1's (W, S) of the fused checks: the north star's groups (S 4), the
#: set's dense domains (S 16), the other field widths
FUSED_DENSE = ((5, 4), (6, 4), (7, 4), (8, 4), (3, 16), (6, 16), (9, 16),
               (1, 1), (4, 2), (10, 8))
#: B4's (kind, W) of the fused checks, the 10-process counter at W 10..12
FUSED_MASK = (("counter", 5), ("queue", 5), ("counter", 10),
              ("counter", 12))
#: B5's windows of the fused checks: K = 1..4 mask words
FUSED_SORT = (8, 40, 70, 127)
#: launches timed for a fused count's added time (median of each arm)
FUSED_REPS = 20
#: wrapper calls the host parts of verdict_counts are timed over
HOST_PART_REPS = 200
#: (ok, overflow, real) start offsets of the sliced flags: equal offsets
#: take the 16-byte loads after a scalar head, unequal ones the scalar loop
VERDICT_OFFSETS = ((0, 0, 0), (1, 1, 1), (3, 5, 7), (16, 0, 9), (15, 15, 15))
#: 32-bit operations a row of verdict_counts: ok & ~overflow & real (3),
#: overflow & real (1), two adds
VERDICT_OPS_PER_ROW = 6
#: the cluster phase's batch: CLUSTER_HISTORIES histories of N_OPS ops on
#: each of two ranks (cut from N_HISTORIES: two processes start on the
#: card and the phase stays short)
CLUSTER_HISTORIES = 128
CLUSTER_SEED = SEED + 40


def device_ops_per_call(fn, calls: int = 10):
    """Device operations (kernels and memsets) a call of fn() enqueues, as
    torch.profiler's device events over `calls` calls; None when the
    profiler shows no device event at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ops) / calls if ops else None


def fused_counts_edges(dev) -> int:
    """The scans' counting option on the card: B1 at FUSED_DENSE, B4 at
    FUSED_MASK, B5 at FUSED_SORT, each at FUSED_SIZES with and without a
    `real` mask, on arbitrary rows (`synth.random_mask_rows`, 32 rows
    repeated to 1000): the verdicts equal the non-counting launch's and
    the counts `verdict_counts_plain` of those verdicts, bitwise. Returns
    the comparisons made."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.history.synth import random_mask_rows
    from jepsen_jgroups_raft_tpu_torch.models import (CasRegister, Counter,
                                                      TicketQueue)
    from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls
    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    top = max(FUSED_SIZES)
    rng = np.random.default_rng(SEED + 42)

    def rows(W, kind, E):
        ev = random_mask_rows(rng, 32, E, W, 3, kind)
        return torch.from_numpy(np.resize(ev, (top,) + ev.shape[1:])).to(dev)

    cases = []
    for W, S in FUSED_DENSE:
        vals = np.resize(np.array([-2**31, 0, 1, 2, 3, 4, 5, 6], np.int32), S)
        ev = rows(W, "register", 32)
        vo = torch.from_numpy(np.tile(vals, (top, 1))).to(dev)
        cases.append((f"dense_W{W}_S{S}", "dense",
                      lambda b, ev=ev, vo=vo, W=W, **kw: ds.dense_scan(
                          ev[:b], vo[:b], W, 3, **kw)))
    for kind, W in FUSED_MASK:
        m = Counter() if kind == "counter" else TicketQueue()
        ev = rows(W, kind, 32)
        cases.append((f"mask_{kind}_W{W}", "dense",
                      lambda b, ev=ev, W=W, m=m, **kw: ds.mask_scan(
                          ev[:b], W, 3, model=m, **kw)))
    for W in FUSED_SORT:
        ev = rows(W, "register", 24)
        cases.append((f"sort_W{W}", "sort",
                      lambda b, ev=ev, W=W, **kw: ls.sort_scan(
                          ev[:b], W, 4, 3, model=CasRegister(), **kw)))
    gen = torch.Generator().manual_seed(SEED + 43)
    compared = 0
    for name, mode, scan in cases:
        for b in FUSED_SIZES:
            want = scan(b)
            want = list(want) if mode == "sort" else [want]
            for real in (None, (torch.rand(b, generator=gen) < 0.7).to(dev)):
                *flags, counts = scan(b, counts=True, real=real)
                plain = vc.verdict_counts_plain(
                    flags[0], flags[1] if mode == "sort" else
                    torch.zeros_like(flags[0]),
                    torch.ones_like(flags[0]) if real is None else real,
                    mode)
                torch.cuda.synchronize()
                if not (all(torch.equal(a, w) for a, w in zip(flags, want))
                        and torch.equal(counts, plain)):
                    raise AssertionError(
                        f"fused counts of {name} at B={b} (real "
                        f"{real is not None}): {counts.tolist()} != "
                        f"{plain.tolist()}, or the verdicts moved")
                compared += 1
    return compared


def verdict_counts_edges(dev) -> dict:
    """B10 against its plain counts on the card, bitwise: verdict_counts in
    both modes at VERDICT_SIZES, each on three flag rows cut from one
    tensor at VERDICT_OFFSETS, through the wrapper and the launcher (its
    output poisoned first); then the scans' fused counts
    (`fused_counts_edges`). Returns the comparisons made."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    gen = torch.Generator().manual_seed(SEED + 41)
    compared = 0
    for B in VERDICT_SIZES:
        u = torch.rand((3, B + 16), generator=gen)
        flags = (u < torch.tensor([[0.7], [0.3], [0.8]])).to(dev)
        for o in VERDICT_OFFSETS:
            ok, ovf, real = (flags[r, o[r]:o[r] + B] for r in range(3))
            for mode in ("dense", "sort"):
                want = vc.verdict_counts_plain(ok, ovf, real, mode)
                out, launch = vc.verdict_counts_launcher(ok, ovf, real,
                                                         mode)
                out.fill_(-1)
                launch(torch.cuda.current_stream())
                got = [vc.verdict_counts(ok, ovf, real, mode), out]
                torch.cuda.synchronize()
                if not all(torch.equal(g, want) for g in got):
                    raise AssertionError(
                        f"verdict_counts differs from its plain version at "
                        f"B={B}, offsets {o}, {mode}: "
                        f"{[g.tolist() for g in got]} != {want.tolist()}")
                compared += 1
    return {"compared": compared, "fused_compared": fused_counts_edges(dev)}


def verdict_counts_ops(dev) -> dict:
    """The device operations a standalone verdict_counts call enqueues at
    B = 1000 (one block) and at 16385 rows (the grid: a memset and the
    kernel), by the profiler (`device_ops_per_call`). A profiler session
    slows the process's later launches, so this runs after every phase
    of its process."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    gen = torch.Generator().manual_seed(SEED + 44)
    flags = (torch.rand((3, 16385), generator=gen) < 0.5).to(dev)
    return {"ops_per_call": device_ops_per_call(
                lambda: vc.verdict_counts(*flags[:, :1000], "sort")),
            "grid_ops_per_call": device_ops_per_call(
                lambda: vc.verdict_counts(*flags, "sort"))}


def fused_added(plain_launch, counting, mode: str) -> dict:
    """What the counting option adds to one scan launch of a main path,
    on its inputs, and whether its counts are right there.
    `plain_launch`: the non-counting instance's launch; `counting(real)`:
    the counting instance's launcher with that `real` mask, (flags...,
    counts, launch). Each arm's device time (`launch_device_times`, the
    counting arm's memset included; `real` None, as the main path
    launches it), FUSED_REPS of each in turns after a warm-up: the
    medians and their difference, also as a share of the plain arm's.
    Then the counts of the last timed launch, and of one launch with a
    `real` mask with holes, equal `verdict_counts_plain` of that launch's
    own flags, bitwise (`mode` "dense" or "sort"); and on the main path's
    flags the plain count (`counts_plain_ms`) and one
    `torch.count_nonzero` of the masked products (`counts_library_ms`):
    the work the epilogue does, done apart."""
    import statistics

    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    *flags, counts, counting_launch = counting(None)
    plain_launch(torch.cuda.current_stream())
    counting_launch(torch.cuda.current_stream())
    plain, timed = [], []
    for _ in range(FUSED_REPS):
        plain += launch_device_times(plain_launch, 1)
        timed += launch_device_times(counting_launch, 1)
    p, c = statistics.median(plain), statistics.median(timed)
    ok = flags[0]
    ovf = flags[1] if mode == "sort" else torch.zeros_like(ok)
    every = torch.ones_like(ok)
    gen = torch.Generator().manual_seed(SEED + 45)
    holes = (torch.rand(ok.shape[0], generator=gen) < 0.7).to(ok.device)
    *h_flags, h_counts, h_launch = counting(holes)
    h_counts.fill_(-1)
    h_launch(torch.cuda.current_stream())
    checks = ((counts, vc.verdict_counts_plain(ok, ovf, every, mode)),
              (h_counts, vc.verdict_counts_plain(
                  h_flags[0], h_flags[1] if mode == "sort" else ovf, holes,
                  mode)))
    torch.cuda.synchronize()
    for (got, want), real in zip(checks, ("every row", "holes")):
        if not torch.equal(got, want):
            raise AssertionError(f"fused counts {got.tolist()} != the plain "
                                 f"counts {want.tolist()} of the launch's "
                                 f"own flags (real: {real})")
    if not all(torch.equal(a, b) for a, b in zip(flags, h_flags)):
        raise AssertionError("fused counts: the verdicts moved with `real`")
    prods = torch.stack([ok & ~ovf if mode == "sort" else ok, ovf])
    return {"plain_ms": p, "counting_ms": c, "added_ms": c - p,
            "added_share": (c - p) / p, "rows": int(ok.shape[0]),
            "counts_compared": len(checks),
            "counts_plain_ms": event_ms(
                lambda: vc.verdict_counts_plain(ok, ovf, every, mode),
                reps=20),
            "counts_library_ms": event_ms(
                lambda: torch.count_nonzero(prods, dim=1), reps=20)}


def host_parts(ok, ovf, real) -> dict:
    """The host side of a `verdict_counts` call in its three parts, each
    the median of HOST_PART_REPS timed calls (perf_counter, µs): the
    checks (`_check`), the output's allocation, and the ctypes launch
    (the current stream's handle and the C entry point, which enqueues
    the kernel)."""
    import statistics

    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    index = ok.get_device()
    out = torch.empty((2,), dtype=torch.int64, device=ok.device)
    parts = {"check_us": lambda: vc._check(ok, ovf, real, "sort"),
             "alloc_us": lambda: torch.empty((2,), dtype=torch.int64,
                                             device=ok.device),
             "launch_us": lambda: vc._launch(ok, ovf, real, out,
                                             int(ok.shape[0]), 1, index,
                                             vc._stream_handle(index))}
    got = {}
    for name, fn in parts.items():
        times = []
        for _ in range(HOST_PART_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        got[name] = statistics.median(times)
        torch.cuda.synchronize()
    return got


def verdict_counts_timed(dev, ok, ovf, real) -> dict:
    """verdict_counts on the north-star flags [B]: the wrapper call, the
    kernel alone (`launch_device_ms`: one block, no memset), the plain
    version, one `torch.count_nonzero` of the two masked products (the
    library yardstick, never on a path), the wrapper's host parts
    (`host_parts`); the kernel alone on both sides of its one-block limit
    (16384 rows: one block; 16385: a memset, then the grid) and at 2^20
    rows; the bound from 3·B bytes read, 16 written and
    VERDICT_OPS_PER_ROW·B operations."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.ops import verdict_counts as vc

    B = int(ok.shape[0])
    _, launch = vc.verdict_counts_launcher(ok, ovf, real, "sort")
    prods = torch.stack([ok & ~ovf & real, ovf & real])
    big = (torch.rand((3, 1 << 20), device=dev) < 0.5)

    def alone(rows):
        return launch_device_ms(vc.verdict_counts_launcher(
            *big[:, :rows], "sort")[1], reps=20)

    return {
        "B": B,
        "ms": event_ms(lambda: vc.verdict_counts(ok, ovf, real, "sort"),
                       reps=20),
        "device_ms": launch_device_ms(launch, reps=20),
        "device_ms_16384": alone(16384),
        "device_ms_16385": alone(16385),
        "plain_ms": event_ms(
            lambda: vc.verdict_counts_plain(ok, ovf, real, "sort"), reps=20),
        "library_ms": event_ms(lambda: torch.count_nonzero(prods, dim=1),
                               reps=20),
        "host": host_parts(ok, ovf, real),
        "t_bytes": (3 * B + 16) / HBM_BYTES_PER_S,
        "t_ops": VERDICT_OPS_PER_ROW * B / CORE_OPS_PER_S,
        "device_ms_1m": alone(1 << 20),
        "bound_ms_1m": (3 * (1 << 20) + 16) / HBM_BYTES_PER_S * 1e3,
    }


def phase_mesh(dev, model, histories, fused_sort=None) -> dict:
    """Phase 29: B10 on the north-star batch (see the module docstring).
    `fused_sort`: what the counting option added to B5's launch on the
    set's C = 64 rung (`run_sort_path`). Returns the kernels-line numbers
    of verdict_counts_fused (the standalone's are on the `mesh` line)."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_encoded)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        DenseLaunch, build_dense_launches, run_chunked, run_dense_groups)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        encode_history, pack_batch, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_plans_grouped)
    from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import bucket_slots
    from jepsen_jgroups_raft_tpu_torch.ops.verdict_counts import (
        verdict_counts)
    from jepsen_jgroups_raft_tpu_torch.parallel.mesh import (
        check_batch_sharded)

    n = len(histories)
    t0 = time.perf_counter()
    encs = [encode_history(h, model) for h in histories]
    encode_s = time.perf_counter() - t0
    grouped, rest = dense_plans_grouped(model, encs)
    batches = [pack_macro_batch([encs[i] for i in idxs])
               for idxs, _ in grouped]
    n_slots = bucket_slots(max(e.n_slots for e in encs))
    rest_ev = pack_batch([encs[i] for i in rest])["events"] if rest else None
    # the wavefront's verdicts on the same groups (and rows)
    launches, subs = build_dense_launches(
        model, [(idxs, plan, b) for (idxs, plan), b
                in zip(grouped, batches)], device=dev)
    want = np.zeros((n,), dtype=bool)
    for sub, out in zip(subs, run_chunked(launches)):
        want[sub] = out.ok
    if rest:
        want[rest] = [r["valid?"] is True for r in
                      check_encoded([encs[i] for i in rest], model,
                                    device=dev)]

    def one_shot():
        fins = [check_batch_sharded(model, b["events"], dense=plan,
                                    defer=True, macro_p=b["macro_p"],
                                    device=dev)
                for b, (_, plan) in zip(batches, grouped)]
        if rest:
            fins.append(check_batch_sharded(model, rest_ev, n_slots=n_slots,
                                            defer=True, device=dev))
        return [f() for f in fins]

    def groups_run():
        return run_dense_groups([DenseLaunch(
            events=torch.from_numpy(b["events"]).to(dev),
            val_of=torch.from_numpy(plan.val_of).to(dev),
            n_events=torch.from_numpy(b["n_events"]).to(dev),
            n_slots=plan.n_slots, macro_p=b["macro_p"], tag=plan.kernel_tag,
            kind=plan.kind) for b, (_, plan) in zip(batches, grouped)], model)

    def timed(fn, reps=5):
        fn()  # warm-up
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return walls

    # the main path of B10: the launch counts set to 0 just before each
    # arm's drive and read just after
    reset_all_launch_counts()
    t0 = time.perf_counter()
    outs = one_shot()
    arm_s = time.perf_counter() - t0
    arm_launches = all_launch_counts()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    l_ok, l_ovf, l_valid, l_unknown = check_batch_sharded(
        model, pack_batch(encs)["events"], n_slots=n_slots, device=dev)
    ladder_s = time.perf_counter() - t0
    ladder_launches = all_launch_counts()
    got = np.zeros((n,), dtype=bool)
    for (idxs, _), (ok, _, _, _) in zip(grouped, outs):
        got[idxs] = ok
    if rest:
        got[rest] = outs[-1][0]
    n_valid = sum(o[2] for o in outs)
    n_unknown = sum(o[3] for o in outs)
    if (n_valid, n_unknown) != (n, 0) or not np.array_equal(got, want) \
            or not want.all():
        raise AssertionError(f"mesh one-shot arm: {n_valid} VALID, "
                             f"{n_unknown} UNKNOWN of {n}; "
                             f"{int((got != want).sum())} rows differ from "
                             "run_chunked")
    # The ladder cannot hold every register frontier: at C = 256 about
    # half of these rows overflow undecided, in the reference's ladder as
    # in this one (tests/test_torch_mesh.py). Every row it decides must be
    # VALID, as run_chunked's, and none INVALID.
    undecided = l_ovf & ~l_ok
    if l_valid + l_unknown != n or not np.array_equal(l_ok | undecided,
                                                      want) \
            or l_unknown != int(undecided.sum()):
        raise AssertionError(f"mesh ladder arm: {l_valid} VALID, "
                             f"{l_unknown} UNKNOWN of {n}, "
                             f"{int((~l_ok & ~l_ovf).sum())} INVALID")
    # one counting launch a group in the one-shot arm (B1's, or B4's for
    # a mask group), counted apart from the instances that do not count
    arm_counting = arm_launches["dense_scan_count"] + \
        arm_launches["mask_scan_count"]
    if arm_counting != len(grouped):
        raise AssertionError(f"mesh one-shot arm: {arm_counting} counting "
                             f"scan launches, expected one a group "
                             f"({len(grouped)})")
    if ladder_launches["sort_scan"] < 1:
        raise AssertionError("mesh ladder arm: sort_scan launched "
                             f"{ladder_launches['sort_scan']} times, "
                             "expected 1 or more")
    # the one-shot arm counts in its scans' epilogues and the ladder on
    # the host: no path launches verdict_counts
    if ladder_launches["verdict_counts"] or arm_launches["verdict_counts"]:
        raise AssertionError("mesh: verdict_counts launched "
                             f"{arm_launches['verdict_counts']} times in "
                             "the one-shot arm, "
                             f"{ladder_launches['verdict_counts']} in the "
                             "ladder (expected 0 and 0)")
    # the standalone entry, driven once as a user calls it (counts set to
    # 0 just before, read just after), on the one-shot arm's verdicts:
    # it must agree with the counts the scans made in their epilogues
    flags = [torch.from_numpy(x).to(dev) for x in
             (got, np.zeros((n,), dtype=bool), np.ones((n,), dtype=bool))]
    reset_all_launch_counts()
    standalone = verdict_counts(*flags, "dense").tolist()
    standalone_launches = all_launch_counts()
    if standalone != [n_valid, n_unknown] or \
            standalone_launches["verdict_counts"] != 1:
        raise AssertionError(f"mesh: verdict_counts of the arm's verdicts "
                             f"{standalone} != the fused counts "
                             f"{[n_valid, n_unknown]}, or it launched "
                             f"{standalone_launches['verdict_counts']} times")
    # in turns (groups, arm, arm, groups): the two differ by where the
    # copies and launches are queued, which the card's spread can hide
    groups_walls = timed(groups_run)
    arm_walls = timed(one_shot) + timed(one_shot)
    groups_walls += timed(groups_run)
    # what counting adds to each north-star group's one-shot B1 launch
    fused_dense = []
    for b, (_, plan) in zip(batches, grouped):
        ln = DenseLaunch(
            events=torch.from_numpy(b["events"]).to(dev),
            val_of=torch.from_numpy(plan.val_of).to(dev),
            n_events=torch.from_numpy(b["n_events"]).to(dev),
            n_slots=plan.n_slots, macro_p=b["macro_p"], kind=plan.kind)
        fused_dense.append(dict(
            fused_added(ln.launcher(model)[-1],
                        group_counting(ln, model), "dense"),
            W=plan.n_slots))
    vline = verdict_counts_timed(dev, *flags)
    emit("mesh", histories=n, encode_s=encode_s,
         groups=[len(idxs) for idxs, _ in grouped], rest_rows=len(rest),
         n_slots=n_slots, one_shot_s=arm_s, one_shot_launches=arm_launches,
         one_shot_walls_s=arm_walls, run_dense_groups_walls_s=groups_walls,
         ladder_s=ladder_s, ladder_launches=ladder_launches,
         ladder_overflowed=int(l_ovf.sum()), ladder_valid=l_valid,
         ladder_unknown=l_unknown, n_valid=n_valid,
         standalone_launches=standalone_launches["verdict_counts"],
         fused_added_dense=fused_dense, fused_added_sort=fused_sort,
         verdict_counts=vline, power=nvidia_smi_line())
    worst = max(fused_dense, key=lambda x: x["added_ms"])
    # the fused form's line: its launches the one-shot arm's counting
    # launches; its ms the time counting adds to the north star's group
    # launch that it slows most, its plain and library ms the same counts
    # of that group's flags done apart; its work is reading `real` (none
    # here: every row real) and writing 16 bytes a launch
    fused = {"launches": arm_counting, "max_abs_err": 0,
             "ms": worst["added_ms"], "added_share": worst["added_share"],
             "plain_ms": worst["counts_plain_ms"],
             "library_ms": worst["counts_library_ms"],
             "t_bytes": 16 * len(grouped) / HBM_BYTES_PER_S,
             "t_ops": 2 * n / CORE_OPS_PER_S}
    return {"verdict_counts_fused": fused}


def group_counting(ln, model):
    """counting(real): the counting launcher of a dense group
    (`checker.schedule.DenseLaunch`) with that `real` mask, for
    `fused_added`."""
    from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds

    def counting(real):
        if ln.kind == "mask":
            return ds.mask_scan_launcher(ln.events, ln.n_slots, ln.macro_p,
                                         ln.n_events, model=model,
                                         counts=True, real=real)
        return ds.dense_scan_launcher(ln.events, ln.val_of, ln.n_slots,
                                      ln.macro_p, ln.n_events, model,
                                      counts=True, real=real)

    return counting


def phase_cluster(dev, model) -> None:
    """Phase 30: two ranks on this card through `launch_local_cluster`
    (see the module docstring)."""
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        encode_history, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.models import Counter
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_plan
    from jepsen_jgroups_raft_tpu_torch.parallel.launch import (
        launch_local_cluster)
    from jepsen_jgroups_raft_tpu_torch.parallel.mesh import (
        check_batch_sharded)
    from jepsen_jgroups_raft_tpu_torch.parallel.selfcheck import seeded_batch

    from jepsen_jgroups_raft_tpu_torch.history.packing import shard_bounds

    shape = ["--histories", str(CLUSTER_HISTORIES), "--ops", str(N_OPS),
             "--procs", str(N_PROCS), "--wide", "0", "--corrupt-every",
             "8", "--seed", str(CLUSTER_SEED)]
    store = tempfile.mkdtemp(prefix="chip-smoke-result-store-")
    t0 = time.perf_counter()
    try:
        outs = launch_local_cluster(
            2, [sys.executable, "-m",
                "jepsen_jgroups_raft_tpu_torch.parallel.selfcheck", *shape,
                "--macro", "1", "--algorithms", "auto", "--global",
                "--device", dev.type, "--result-store", store],
            env_extra={"PYTHONPATH": str(Path(__file__).resolve().parent),
                       "JGRAFT_LIN_FASTPATH": "0"}, timeout_s=300)
        detail_records = len(list((Path(store) / "detail").rglob("*.json")))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    cluster_s = time.perf_counter() - t0
    ranks = []
    for rank, (rc, out) in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("SELFCHECK ")]
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"cluster rank {rank} exited {rc}:\n"
                                 f"{out[-3000:]}")
        ranks.append(json.loads(lines[0][len("SELFCHECK "):]))
    hs = seeded_batch(CLUSTER_SEED, CLUSTER_HISTORIES, N_OPS, N_PROCS, 0, 8)
    t0 = time.perf_counter()
    single = [r["valid?"] for r in
              with_env("JGRAFT_MACRO_EVENTS", "1",
                       lambda: check_histories(hs, model, "auto",
                                               device=dev))]
    single_s = time.perf_counter() - t0

    def counts(m, batch):
        encs = [encode_history(h, m) for h in batch]
        packed = pack_macro_batch(encs)
        return list(check_batch_sharded(
            m, packed["events"], dense=dense_plan(m, encs),
            macro_p=packed["macro_p"], device=dev)[2:])

    want = {"register": counts(model, hs),
            "counter": counts(Counter(), seeded_batch(
                CLUSTER_SEED + 1, CLUSTER_HISTORIES, N_OPS, N_PROCS,
                kind="counter"))}
    if not (0 < sum(single) < len(single)):
        raise AssertionError("cluster: the batch should hold VALID and "
                             "INVALID rows")
    for r in ranks:
        [check] = r["checks"].values()
        if check["verdicts"] != single:
            raise AssertionError(f"cluster rank {r['rank']}: verdicts "
                                 "differ from one process's")
        if {k: list(v) for k, v in r["global"].items()} != want:
            raise AssertionError(f"cluster rank {r['rank']}: global "
                                 f"counts {r['global']} != {want}")
        if r["tiny"] != single[:3] or r["empty_shard"] != single[:1]:
            raise AssertionError(f"cluster rank {r['rank']}: the 3-row "
                                 "or the empty-shard check differs")
        # the result-store arm: every row of the other rank's shard is its
        # owner's whole result, read from the store
        lo, hi = shard_bounds(CLUSTER_HISTORIES, len(ranks), r["rank"])
        arm = r["store"]
        if arm["verdicts"] != single or "remote-shard" in arm["kernels"] \
                or arm["store_rows"] != CLUSTER_HISTORIES - (hi - lo):
            raise AssertionError(
                f"cluster rank {r['rank']}: the result-store arm's "
                f"verdicts differ, or {arm['kernels'].count('remote-shard')}"
                f" stubs and {arm['store_rows']} rows from the store")
    if detail_records != CLUSTER_HISTORIES:
        raise AssertionError(f"cluster: {detail_records} detail records "
                             f"for {CLUSTER_HISTORIES} rows")
    emit("cluster", ranks=len(ranks), histories=CLUSTER_HISTORIES,
         devices=[r["device"] for r in ranks],
         rank_seconds=[r["seconds"] for r in ranks], cluster_s=cluster_s,
         single_process_s=single_s, n_valid=sum(single), counts=want,
         stub_rows=[r["checks"][next(iter(r["checks"]))]["kernels"]
                    .count("remote-shard") for r in ranks],
         remote_rows=[r["store"]["kernels"].count("remote-shard")
                      for r in ranks],
         store_rows=[r["store"]["store_rows"] for r in ranks],
         detail_records=detail_records)


def phase_mesh_alone(dev) -> None:
    """`--only mesh`: phase 29 on a north-star batch of its own, after
    B10's edges (the kernels' checks of the full run)."""
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister

    t0 = time.perf_counter()
    emit("verdict_counts_edges", **verdict_counts_edges(dev),
         seconds=time.perf_counter() - t0)
    histories, synth_s = suite_histories("register")
    emit("mesh_synth", seconds=synth_s)
    phase_mesh(dev, CasRegister(), histories)
    emit("verdict_counts_ops", **verdict_counts_ops(dev))


def phase_cluster_alone(dev) -> None:
    """`--only cluster`: phase 30, alone."""
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister

    phase_cluster(dev, CasRegister())


def phase_service_cluster_alone(dev) -> None:
    """`--only service_cluster`: phase 6e on a north-star batch of its
    own, with phase 8's corrupted rows."""
    histories, synth_s = suite_histories("register")
    emit("service_cluster_synth", seconds=synth_s)
    rng = random.Random(SEED + 2)
    bad_north = [corrupt_read(h, rng, VALUE_RANGE + 1)[0]
                 for h in histories[:N_INVALID]]
    phase_service_cluster(dev, histories, bad_north)


def phase_segment_timed(dev) -> None:
    """`--only segment`: config 5's segment batch through
    `segment_kernel_timed` (as long_main measures it), alone."""
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister
    from jepsen_jgroups_raft_tpu_torch.ops import segment_scan as ss

    model = CasRegister()
    hs, synth_s = long_histories("config5")
    batch = ss.prepare_segment_batch(
        [encode_history(h, model) for h in hs], model, device=dev)
    fields, _ = segment_kernel_timed(dev, batch, model)
    emit("segment_timed", config="config5", synth_s=synth_s,
         K=int(batch.events.shape[0]), NB=batch.NB, W=batch.W, S=batch.S,
         E_seg=batch.E_seg, **fields, power=nvidia_smi_line())


def phase_election_alone(dev) -> None:
    """`--only election`: phase 26 (election_kernel), alone."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        phase_election_kernel(dev, Path(tmp) / "elections")


#: phases that `--only NAME[,NAME...]` runs on their own, each with the
#: libraries it builds: the quick measurement of one kernel, a phase of
#: the full run cut to it (no kernels line)
ONLY = {"segment": (("segment_scan", "segment_scan_profile"),
                    phase_segment_timed),
        "election": (("election_safety",), phase_election_alone),
        "mesh": (("dense_scan", "mask_scan", "sort_scan", "verdict_counts",
                  *COUNT_LIBRARIES), phase_mesh_alone),
        "cluster": (("dense_scan", "mask_scan", "sort_scan",
                     "verdict_counts", *COUNT_LIBRARIES),
                    phase_cluster_alone),
        "service_cluster": (("dense_scan", "mask_scan", "sort_scan",
                             "segment_scan", "cycle_closure"),
                            phase_service_cluster_alone)}


def kernel_checks(dev, model) -> dict:
    """Phases 3, 29a, 4-5, 13, 13b, 16, 21 and 29b: each kernel against
    its plain version on the shapes of its own cases (nothing in them
    times the card for the kernels line). Returns each kernel's max
    |kernel - plain| (0, or a phase fails), and B10's edges and device
    operations a call under "verdict_counts_edges"."""
    # 3. dense_scan against its plain version at every window
    t0 = time.perf_counter()
    compared, corner_err = phase_kernel(dev, model)
    emit("kernel_summary", rows_compared=compared, max_abs_err=corner_err,
         seconds=time.perf_counter() - t0)

    # 29a. B10, standalone and fused into B1, B4 and B5, against the plain
    # counts
    t0 = time.perf_counter()
    edges = verdict_counts_edges(dev)
    emit("verdict_counts_edges", **edges, seconds=time.perf_counter() - t0)

    # 4. mask_scan against its plain version
    t0 = time.perf_counter()
    compared, mask_err = phase_mask_kernel(dev)
    emit("mask_kernel_summary", rows_compared=compared,
         max_abs_err=mask_err, seconds=time.perf_counter() - t0)

    # 5. domain and mask groups launched together
    _, groups_err = phase_groups(dev, model)

    # 13. sort_scan against its plain version
    t0 = time.perf_counter()
    compared, sort_err, overflowed = phase_sort_kernel(dev)
    emit("sort_kernel_summary", rows_compared=compared, max_abs_err=sort_err,
         overflowed_and_ok=overflowed["ok"],
         overflowed_and_not_ok=overflowed["not_ok"],
         seconds=time.perf_counter() - t0)

    # 13b. the chunk forms against their plain versions after every launch
    t0 = time.perf_counter()
    chunk_errs = phase_chunk_kernel(dev)
    emit("chunk_kernel_summary", max_abs_err=max(chunk_errs.values()),
         seconds=time.perf_counter() - t0)

    # 16. segment_scan against its plain version at full segment size
    t0 = time.perf_counter()
    runs, live, seg_err = phase_segment_kernel(dev)
    emit("segment_kernel_summary", runs_compared=runs, live_runs=live,
         max_abs_err=seg_err, seconds=time.perf_counter() - t0)

    # 21. B7 and B8 against their plain versions at every bucket
    t0 = time.perf_counter()
    ck = phase_cycle_kernel(dev)
    emit("cycle_kernel_summary", max_abs_err=ck["max_abs_err"],
         library_ms=ck["library_ms"], seconds=time.perf_counter() - t0)

    # 29b. the device operations of a standalone verdict_counts call (last:
    # the profiler slows what runs after it)
    t0 = time.perf_counter()
    edges.update(verdict_counts_ops(dev))
    emit("verdict_counts_ops", **edges, seconds=time.perf_counter() - t0)
    return {"dense_scan": max(corner_err, groups_err["dense_scan"]),
            "mask_scan": max(mask_err, groups_err["mask_scan"]),
            "sort_scan": sort_err, "segment_scan": seg_err,
            "cycle_closure": ck["max_abs_err"],
            "cycle_closure_tiled": ck["max_abs_err"], **chunk_errs,
            "verdict_counts_fused": 0,
            "verdict_counts_edges": edges}


def kernel_checks_child(conn, out: str, t0: float) -> None:
    """`kernel_checks` in a process of its own (see `start_kernel_checks`):
    its lines go to the file `out`, its result or its traceback to
    `conn`. `t0`: the parent's start, so that `t_s` reads alike."""
    import traceback

    import torch

    from jepsen_jgroups_raft_tpu_torch.models import CasRegister

    global T0
    T0 = t0
    sys.stdout = open(out, "w", buffering=1)
    try:
        conn.send(("ok", kernel_checks(torch.device("cuda"),
                                       CasRegister())))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        raise
    finally:
        sys.stdout.flush()


def start_kernel_checks(tmp: str):
    """Start `kernel_checks` in a spawned process on the same card, beside
    this one's host phases (the kernels are built; the process loads
    them). Returns (process, its end of the pipe, its output file)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    out = str(Path(tmp) / "kernel_checks.jsonl")
    proc = ctx.Process(target=kernel_checks_child, args=(send, out, T0))
    proc.start()
    send.close()
    return proc, recv, out


def finish_kernel_checks(proc, recv, out: str) -> dict:
    """Wait for `start_kernel_checks`' process (at most
    KERNEL_CHECKS_TIMEOUT_S), print its lines, and return its result;
    fails if it failed, died or outlived the wait."""
    status, value = "error", "no result: the process timed out or died"
    if recv.poll(KERNEL_CHECKS_TIMEOUT_S):
        try:
            status, value = recv.recv()
        except EOFError:
            pass
    proc.join(60)
    with open(out) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()
    if status != "ok" or proc.exitcode != 0:
        raise AssertionError(f"the kernels' checks against their plain "
                             f"versions failed (exit {proc.exitcode}): "
                             f"{value}")
    return value


# ----------------------------------------- the plan store and the stream

#: stream: the north-star sessions fed append by append (the first
#: STREAM_VALID histories as they are, the next STREAM_CORRUPT with one
#: read moved out of the domain), the history rows an append carries, and
#: the B = 1 launch's timed reps
STREAM_VALID = 64
STREAM_CORRUPT = 16
STREAM_APPEND_ROWS = 50
STREAM_LAUNCH_REPS = 20
#: the append from which a session's launch is timed alone (a frontier
#: and a window the session has grown into)
STREAM_TIMED_APPEND = 20


def plan_buckets(store: Path, applied: list) -> list:
    """Each plan file under `store`: its bucket's signature, each
    candidate's sample times in ms, the chosen plan, and the sources it
    was applied from (`applied`: the applied logs of the checks)."""
    out = []
    for path in sorted(store.rglob("*.json")):
        raw = json.loads(path.read_text())
        sig = raw["signature"]
        out.append({
            "signature": sig, "file": path.name,
            "samples_ms": {k: [t * 1e3 for t in ts]
                           for k, ts in raw["samples"].items()},
            "plan": raw["plan"],
            "sources": [e["source"] for e in applied
                        if e["signature"] == sig]})
    return out


def tuned_checks(dev, model, histories, want: list, mixed, want_mixed: list,
                 store: Path) -> dict:
    """`check_histories` at JGRAFT_AUTOTUNE=1 with `store` emptied: a
    measuring check of `histories`, then, the process's plans dropped, a
    loading check of them, then a check of `mixed` (the batch with
    corrupted rows in place of its first ones) under the plans in
    memory; each with the launch counts set to 0 just before it and
    read just after, its store counters, the plans it applied, its wall
    and its verdicts against `want` / `want_mixed` (every row on one
    tier). Fails if a verdict differs, if the first check
    measures nothing, if the second measures or loads nothing, or if the
    mixed check applies no plan. Returns the runs and the buckets."""
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker import autotune
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import consume_stats

    shutil.rmtree(store, ignore_errors=True)
    runs: dict = {}
    applied: list = []

    def check(name, hs, expect):
        torch.cuda.synchronize()
        reset_all_launch_counts()
        consume_stats()
        seq = autotune.applied_seq()
        t0 = time.perf_counter()
        rs = check_histories(hs, model, device=dev)
        wall = time.perf_counter() - t0
        log = autotune.applied_since(seq)
        applied.extend(log)
        runs[name] = {"check_s": wall,
                      "counters": autotune.consume_counters(),
                      "plans_applied": len(log),
                      "launches": {k: v for k, v in
                                   all_launch_counts().items() if v},
                      "chunks_run": consume_stats()["chunks_run"],
                      "tiers": sorted({str(r.get("decided-tier"))
                                       for r in rs}),
                      "invalid": sum(1 for r in rs if r["valid?"] is False),
                      "verdicts_equal": [r["valid?"] for r in rs] == expect}

    def go():
        autotune.reset_for_tests()
        check("measuring", histories, want)
        # a fresh process: the plans in memory dropped, the store kept
        autotune.reset_for_tests()
        check("loading", histories, want)
        check("mixed", mixed, want_mixed)

    with_envs({"JGRAFT_AUTOTUNE": "1", "JGRAFT_AUTOTUNE_STORE": str(store)},
              go)
    first, second, third = runs["measuring"], runs["loading"], runs["mixed"]
    if not all(r["verdicts_equal"] and len(r["tiers"]) == 1
               for r in runs.values()) or \
            first["counters"]["plans_measured"] == 0 or \
            second["counters"]["plans_measured"] or \
            not second["counters"]["plans_loaded"] or \
            not third["plans_applied"]:
        raise AssertionError(f"tuned checks: a verdict differs, a row left "
                             f"the tier, the first check measured nothing, "
                             f"the second measured or loaded nothing, or "
                             f"the mixed batch ran under no plan: {runs}")
    return {"runs": runs, "buckets": plan_buckets(store, applied)}


def tuned_env(store: Path, fn):
    """fn() with the launch plans on and `store` as the store."""
    return with_envs({"JGRAFT_AUTOTUNE": "1",
                      "JGRAFT_AUTOTUNE_STORE": str(store)}, fn)


def phase_autotune_main(dev, model, histories, untuned: dict, bad) -> dict:
    """6b. The north-star batch through `check_histories` at
    JGRAFT_AUTOTUNE=1 with an empty store (a directory of its own):
    `tuned_checks`, its mixed batch the north star with phase 8's
    corrupted rows (`bad`, each INVALID by the host oracle there) in
    place of its first ones. Prints each bucket's signature, its
    candidates' sample times, the chosen plan and its sources; the store
    counters, walls and chunk launches by kernel of each check, beside
    `main`'s untuned best (`untuned`: main's best wall, verdicts and its
    chunk launch). Then the chosen plan's launch on the largest group
    (the plan loaded, the group packed under it, its first wavefront
    launch, the whole schedule under a plan of scan_chunk 0) against the
    plain chunk form, flags and carry bitwise (`measure_chunk_launch`):
    its ms and bound beside the untuned launch's. Returns the chunk
    launches of the checks by kernel, and the tuned launch's numbers."""
    from dataclasses import asdict

    import torch

    from jepsen_jgroups_raft_tpu_torch.checker import autotune
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        build_dense_launches)
    from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_plans_grouped)

    store = Path(os.environ["JGRAFT_AUTOTUNE_STORE"]) / "autotune_main"
    mixed = list(bad) + list(histories[len(bad):])
    want_mixed = [False] * len(bad) + untuned["verdicts"][len(bad):]
    got = tuned_checks(dev, model, histories, untuned["verdicts"], mixed,
                       want_mixed, store)

    def tuned_launch():
        # the largest group as `_dense_pass` forms it, under its plan
        encs = [encode_history(h, model) for h in histories]
        grouped, _ = dense_plans_grouped(model, encs)
        idxs, plan = max(grouped, key=lambda g: len(g[0]))
        sub = [encs[i] for i in idxs]
        tuned = autotune.tuned_group_plan(model, plan, sub, device=dev)
        if tuned is None:
            raise AssertionError("autotune_main: the largest group has no "
                                 "plan")
        batch = autotune.pack_group(sub, tuned)
        [ln], _ = build_dense_launches(model, [(idxs, plan, batch, tuned)],
                                       device=dev)
        W, S = plan.n_slots, int(plan.val_of.shape[1])
        plain, work, lay = dense_chunk_fns(model, plan.kind, W, S,
                                           batch.get("macro_p"))
        ev = torch.from_numpy(batch["events"]).to(dev)
        ne = torch.from_numpy(batch["n_events"]).to(dev)
        vo = torch.from_numpy(plan.val_of).to(dev)
        width = first_span(batch["n_events"], ln.chunk, ln.e_sched)
        line = measure_chunk_launch(
            dev, "dense_scan_chunk", ln.step_fn, plain, ln.init_fn(vo, ne),
            ev, ne, width, lay, work)
        return dict(line, plan=asdict(tuned), chunk=ln.chunk,
                    e_sched=ln.e_sched, macro_p=batch.get("macro_p"),
                    window=W, states=S)

    launch = tuned_env(store, tuned_launch)
    shutil.rmtree(store, ignore_errors=True)
    first, second = got["runs"]["measuring"], got["runs"]["loading"]
    emit("autotune_main", histories=len(histories), buckets=got["buckets"],
         **got["runs"], untuned_best_s=untuned["check_s_best"],
         measuring_over_untuned=first["check_s"] / untuned["check_s_best"],
         loading_over_untuned=second["check_s"] / untuned["check_s_best"],
         corrupted_rows=len(bad), tuned_launch=launch,
         untuned_launch=untuned["chunk_launch"],
         device=torch.cuda.get_device_name(dev), power=nvidia_smi_line())
    out: dict = {}
    for r in got["runs"].values():
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return {"launches": out, "tuned_launch": launch}


def phase_autotune_set(dev, histories, bad) -> dict:
    """14b. The set suite (every row VALID on the sort tier, `set_main`)
    through `check_histories` at JGRAFT_AUTOTUNE=1: `tuned_checks`, the
    sort ladder's rungs asking `tuned_sort_plan`, its mixed batch the
    suite with phase 15's corrupted rows (`bad`) in place of its first
    ones. Then, the plans in memory, the mixed batch's C = 64 rung as
    `_sort_pass` launches it under its plan (packed under it, one
    `run_chunked`) against the untuned rung's one-shot `run_sort_rung`,
    ok and overflow bitwise. Returns the chunk launches of the checks by
    kernel."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker import autotune
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        ChunkLaunch, run_chunked, run_sort_rung)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        bucket_rows, encode_history, pack_macro_batch)
    from jepsen_jgroups_raft_tpu_torch.models import GSet
    from jepsen_jgroups_raft_tpu_torch.ops.linear_scan import (
        bucket_slots, make_sort_chunk_checker)

    model = GSet()
    store = Path(os.environ["JGRAFT_AUTOTUNE_STORE"]) / "autotune_set"
    mixed = list(bad) + list(histories[len(bad):])
    want = [True] * len(histories)
    want_mixed = [False] * len(bad) + want[len(bad):]
    got = tuned_checks(dev, model, histories, want, mixed, want_mixed, store)

    def rung():
        encs = [encode_history(h, model) for h in mixed]
        W, C = bucket_slots(max(e.n_slots for e in encs)), 64
        tuned = autotune.tuned_sort_plan(model, encs, C, W, device=dev)
        if tuned is None:
            raise AssertionError("autotune_set: the C = 64 rung has no plan")
        batch = autotune.pack_group(encs, tuned)
        init_fn, step_fn = make_sort_chunk_checker(
            model, C, W, macro_p=batch.get("macro_p"))
        e_sched = bucket_rows(batch["events"].shape[1], 32)
        timer: dict = {}
        [out] = run_chunked([ChunkLaunch(
            events=batch["events"], n_events=batch["n_events"],
            init_fn=init_fn, step_fn=step_fn, e_sched=e_sched, device=dev,
            tag="sort", chunk=tuned.scan_chunk or max(e_sched, 1))],
            record_stats=False, timer=timer)
        base = pack_macro_batch(encs)
        one = run_sort_rung(torch.from_numpy(base["events"]).to(dev),
                            torch.from_numpy(base["n_events"]).to(dev),
                            W, C, base.get("macro_p"), model)
        diff = int((np.asarray(out.ok) != np.asarray(one.ok)).sum()
                   + (np.asarray(out.overflow)
                      != np.asarray(one.overflow)).sum())
        return {"W": W, "C": C, "plan": {"scan_chunk": tuned.scan_chunk,
                                         "macro_p": tuned.macro_p},
                "launches": out.chunks_run, "span_ms": timer.get("span_ms"),
                "ok": int(np.asarray(out.ok).sum()),
                "overflow": int(np.asarray(out.overflow).sum()),
                "flags_differ": diff}

    flags = tuned_env(store, rung)
    shutil.rmtree(store, ignore_errors=True)
    emit("autotune_set", histories=len(histories), buckets=got["buckets"],
         **got["runs"], corrupted_rows=len(bad), tuned_rung=flags,
         device=torch.cuda.get_device_name(dev), power=nvidia_smi_line())
    if flags["flags_differ"] or not any(
            b["signature"][0] == "sort" for b in got["buckets"]):
        raise AssertionError("autotune_set: the tuned rung's flags differ "
                             "from the untuned rung's, or no sort plan was "
                             "measured")
    out: dict = {}
    for r in got["runs"].values():
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def record_crashes(ops) -> list:
    """The history as Jepsen's runner records it live: an invocation left
    with no completion (a crashed worker) gets an info row where its
    worker was replaced, just before the first invocation of a process
    id not seen before it (else at the end), so that a stream settles
    past it. The event stream is unchanged: an info row, like a missing
    completion, makes the pair a crashed one."""
    done = set()
    last = {}
    for j, op in enumerate(ops):
        if op.type == "invoke":
            last[op.process] = j
        else:
            done.add(last.pop(op.process))
    dangling = set(last.values())
    out, seen, due = [], set(), []
    for j, op in enumerate(ops):
        if op.type == "invoke" and op.process not in seen and due:
            out.extend(due)
            due = []
        seen.add(op.process)
        out.append(op)
        if j in dangling:
            due.append(op.replace(type="info", index=-1))
    return out + due


def pct(xs, q: float) -> float:
    """The q-quantile of xs (nearest rank)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(-(-q * len(xs) // 1)) - 1))]


def phase_stream(dev, histories) -> dict:
    """6c. Streaming sessions on the card: STREAM_VALID north-star
    histories and STREAM_CORRUPT with one read out of the domain, their
    crashed invocations given info rows (`record_crashes`), each fed
    STREAM_APPEND_ROWS history rows an append through
    `IncrementalEncoder` -> `StreamingCertifier` and `CarriedScan` (B5's
    chunk entry point, one row a launch; a window that outgrows the
    carry rebuilds it wider and re-feeds the settled stream, as a
    session does), and one more history fed whole in one append (a
    backlog). The launch counts are set to 0 just before the sessions
    and read just after. Fails if a stream differs from the one-shot
    encode, if a final (ok, overflow) differs from one `run_sort_rung`
    over the whole streams at the same C and W, if a corrupted session's
    ok falls at another append than the first whose prefix a one-shot
    scan finds dead (one launch a session, its rows the prefixes), if a
    session launches after it decided, if the backlog takes one launch,
    or if a verdict differs from `check_histories`'. Prints appends and
    launches per session, the median and p99 ms of `CarriedScan.feed`
    and of a whole append, the B = 1 launch against its plain version
    (the wrapper's ms, the device's ms by CUDA events, the bound), and
    how many sessions the certifier carried to the end. Returns the
    kernels-line numbers of the stream path."""
    import numpy as np
    import torch

    from jepsen_jgroups_raft_tpu_torch.checker.consistency import (
        StreamingCertifier)
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.checker.schedule import (
        STREAM_FEED_CHUNK, CarriedScan, run_sort_rung)
    from jepsen_jgroups_raft_tpu_torch.history.packing import (
        IncrementalEncoder, bucket_rows, encode_history)
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister
    from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

    model = CasRegister()
    rng = random.Random(SEED + 60)
    sessions = [list(h) for h in histories[:STREAM_VALID]]
    for h in histories[STREAM_VALID:STREAM_VALID + STREAM_CORRUPT]:
        ops_, changed = corrupt_read(h, rng, VALUE_RANGE + 1)
        if not changed:
            raise AssertionError("stream: a history without an ok read")
        sessions.append(ops_)
    sessions.append(list(histories[STREAM_VALID + STREAM_CORRUPT]))
    # the rows as a live run records them (the synthesizer leaves half of
    # its crashed invocations with no completion row, which would hold a
    # stream back to its end); the encodings must not move
    given = sessions
    sessions = [record_crashes(ops) for ops in given]
    corrupt = set(range(STREAM_VALID, STREAM_VALID + STREAM_CORRUPT))
    backlog = len(sessions) - 1

    feed_ms, append_ms, out = [], [], []
    snap = None
    torch.cuda.synchronize()
    ls.reset_launch_counts()
    t_phase = time.perf_counter()
    for s, ops in enumerate(sessions):
        rows = len(ops) if s == backlog else STREAM_APPEND_ROWS
        enc, cert = IncrementalEncoder(model), StreamingCertifier(model)
        scan, settled, prefix = None, [], []
        launches, fell, after = 0, None, 0
        for a, lo in enumerate(range(0, len(ops), rows)):
            t0 = time.perf_counter()
            ev, _, _ = enc.feed(ops[lo:lo + rows],
                                final=lo + rows >= len(ops))
            if ev.shape[0]:
                settled.append(ev)
                if cert.certified:
                    cert.feed(ev)
            if scan is not None and scan.decided:
                n0 = ls.CHUNK_LAUNCHES["sort_scan_chunk"]
                scan.feed(ev)
                after += ls.CHUNK_LAUNCHES["sort_scan_chunk"] - n0
            elif ev.shape[0]:
                t1 = time.perf_counter()
                if scan is None or not scan.fits(enc.n_slots):
                    if scan is not None:
                        launches += scan.launches
                    scan = CarriedScan(model, enc.n_slots, device=dev)
                    scan.feed(np.concatenate(settled))
                else:
                    if snap is None or snap[0] < STREAM_TIMED_APPEND:
                        span = ev[:STREAM_FEED_CHUNK]
                        pad = np.zeros((bucket_rows(span.shape[0], 32), 5),
                                       dtype=np.int32)
                        pad[:span.shape[0]] = span
                        snap = (a, s, scan.carry.clone(), pad,
                                span.shape[0], scan.slots_cap,
                                scan.n_configs)
                    scan.feed(ev)
                feed_ms.append((time.perf_counter() - t1) * 1e3)
                if scan.decided:
                    fell = a
            append_ms.append((time.perf_counter() - t0) * 1e3)
            prefix.append(sum(e.shape[0] for e in settled))
        launches += scan.launches
        out.append({"appends": len(prefix), "launches": launches,
                    "after_decided": after, "fell": fell,
                    "ok": scan.ok, "overflow": scan.overflow,
                    "certified": cert.certified,
                    "stream": np.concatenate(settled), "prefix": prefix})
    stream_s = time.perf_counter() - t_phase
    counted = ls.chunk_launch_counts()["sort_scan_chunk"]
    if counted != sum(o["launches"] for o in out):
        raise AssertionError("stream: the launch count disagrees with the "
                             "sessions' launches")

    # every stream is the one-shot encode; final flags against one
    # run_sort_rung over the whole streams, by kernel window
    seconds = {"sessions": stream_s}
    t0 = time.perf_counter()
    C = ls.DEFAULT_N_CONFIGS
    encs = [encode_history(ops, model, prune=False) for ops in given]
    for o, e in zip(out, encs):
        if not np.array_equal(o["stream"], e.events):
            raise AssertionError("stream: a settled stream differs from the "
                                 "one-shot encode of the history as given")
    by_w: dict = {}
    for j, e in enumerate(encs):
        by_w.setdefault(ls.bucket_slots(max(e.n_slots, 1)), []).append(j)
    mismatched = 0
    for W, js in by_w.items():
        E = max(encs[j].n_events for j in js)
        ev = np.zeros((len(js), E, 5), dtype=np.int32)
        for k, j in enumerate(js):
            ev[k, :encs[j].n_events] = encs[j].events
        ne = np.array([encs[j].n_events for j in js], dtype=np.int32)
        run = run_sort_rung(torch.from_numpy(ev).to(dev),
                            torch.from_numpy(ne).to(dev), W, C, None, model)
        for k, j in enumerate(js):
            mismatched += (bool(run.ok[k]), bool(run.overflow[k])) != \
                (out[j]["ok"], out[j]["overflow"])
    seconds["one_shot"] = time.perf_counter() - t0
    # a corrupted session falls at the first append whose prefix is dead
    t0 = time.perf_counter()
    wrong_fall = 0
    for j in sorted(corrupt):
        e, o = encs[j], out[j]
        # row k: the stream's first prefix[k] events, EV_PAD after them
        ev = np.zeros((len(o["prefix"]),) + e.events.shape, dtype=np.int32)
        for k, n in enumerate(o["prefix"]):
            ev[k, :n] = e.events[:n]
        run = run_sort_rung(
            torch.from_numpy(ev).to(dev),
            torch.tensor(o["prefix"], dtype=torch.int32, device=dev),
            ls.bucket_slots(max(e.n_slots, 1)), C, None, model)
        dead = np.flatnonzero(~run.ok)
        wrong_fall += (int(dead[0]) if dead.size else None) != o["fell"]
    seconds["prefixes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # a session's verdict: VALID once certified or ok; INVALID once ok
    # fell with no overflow; a frontier that overflowed C escalates (a
    # session runs the whole ladder on it at its end: check_histories'
    # verdict by construction, so it is counted, not compared)
    rs = check_histories(given, model, device=dev)
    verdict = [True if o["certified"] or o["ok"] else
               (False if not o["overflow"] else None) for o in out]
    escalated = sum(v is None for v in verdict)
    differ = sum(v is not None and r["valid?"] != v
                 for r, v in zip(rs, verdict))

    seconds["check_histories"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the B = 1 launch against its plain version, as the path made it:
    # the first one at a session's STREAM_TIMED_APPEND-th append or
    # later (else the last one before it)
    snap_append, snap_session, carry, pad, n_real, W, Cs = snap
    init, step = ls.make_sort_chunk_checker(model, Cs, W)
    ev = torch.from_numpy(pad[None]).to(dev)
    ne = torch.tensor([n_real], dtype=torch.int32, device=dev)

    def plain(c, e, w, st):
        return ls.sort_chunk_plain(c, e, W, Cs, None, model=model, width=w,
                                   stats=st)

    launch_line = measure_chunk_launch(
        dev, "sort_scan_chunk", step, plain, carry, ev, ne, pad.shape[0],
        ls.sort_carry_layout(W, Cs),
        lambda st, sl: st["steps"] + st["candidates"])
    launch = ls.sort_chunk_launcher(carry, ev, W, Cs, model=model)[2]
    launch_line["device_ms_reps"] = launch_device_times(
        launch, STREAM_LAUNCH_REPS + 1)[1:]
    launch_line["device_ms"] = min(launch_line["device_ms_reps"])
    launch_line.update(W=W, C=Cs, real_events=n_real, session=snap_session,
                       append=snap_append)

    seconds["b1_launch"] = time.perf_counter() - t0
    appends = [o["appends"] for o in out]
    per = [o["launches"] for o in out]
    emit("stream", sessions=len(sessions), corrupted=len(corrupt),
         append_rows=STREAM_APPEND_ROWS, stream_s=stream_s,
         seconds=seconds,
         info_rows_added=sum(len(a) - len(b)
                             for a, b in zip(sessions, given)),
         appends_per_session={"min": min(appends), "max": max(appends),
                              "sum": sum(appends)},
         launches_per_session={"min": min(per), "max": max(per),
                               "sum": sum(per), "counted": counted},
         backlog={"events": int(encs[backlog].n_events),
                  "launches": out[backlog]["launches"]},
         feed_ms={"median": pct(feed_ms, 0.5), "p99": pct(feed_ms, 0.99),
                  "n": len(feed_ms)},
         append_ms={"median": pct(append_ms, 0.5),
                    "p99": pct(append_ms, 0.99), "n": len(append_ms)},
         b1_launch=launch_line,
         b1_bound_ms=max(launch_line["t_bytes"], launch_line["t_ops"]) * 1e3,
         certifier_carried=sum(o["certified"] for o in out),
         decided_sessions=sum(o["fell"] is not None for o in out),
         escalated_sessions=escalated,
         launches_after_decided=sum(o["after_decided"] for o in out),
         final_flags_mismatched=mismatched, wrong_fall=wrong_fall,
         verdicts_differ=differ, kernel_windows=sorted(by_w),
         device=torch.cuda.get_device_name(dev), power=nvidia_smi_line())
    if mismatched or wrong_fall or differ or \
            any(o["after_decided"] for o in out) or \
            out[backlog]["launches"] < 2 or \
            any(out[j]["fell"] is None for j in corrupt):
        raise AssertionError("stream: a final flag, an append where ok "
                             "fell or a verdict differs, a session launched "
                             "after it decided, a corrupted session never "
                             "decided, or the backlog took one launch")
    return dict(launch_line, launches=counted)


# ------------------------------------------------------- the service

#: service: the north-star histories the main arm submits, the corrupted
#: rows beside them (the first SERVICE_CORRUPT_EACH of phase 8's register
#: rows and of phase 15's set rows), suite config 2's counter histories
#: (the mask kernel's share), histories a request, and tenant threads
#: (half send binary frames, half JSON)
SERVICE_VALID = 512
SERVICE_CORRUPT_EACH = 32
SERVICE_COUNTER = 64
SERVICE_PER_REQUEST = 8
SERVICE_TENANTS = 8
#: the stream arm: sessions over HTTP (the last SERVICE_STREAM_CORRUPT of
#: them on corrupted histories) at STREAM_APPEND_ROWS rows an append
SERVICE_STREAMS = 16
SERVICE_STREAM_CORRUPT = 4
#: the default-knob arm: valid and corrupted histories
SERVICE_DEFAULT_VALID = 64
SERVICE_DEFAULT_CORRUPT = 16
#: the restart arm: admitted requests a restart replays
SERVICE_RESTART = 32
#: the longest wait for one request or one session of the phase
SERVICE_WAIT_S = 300.0


def service_requests(workload: str, hists: list, expected: list) -> list:
    """(workload, op-dict rows of each history, expected result of each)
    per request of SERVICE_PER_REQUEST histories."""
    rows = [[op.to_dict() for op in h] for h in hists]
    n = SERVICE_PER_REQUEST
    return [(workload, rows[i:i + n], expected[i:i + n])
            for i in range(0, len(rows), n)]


def service_wait(cl, rec: dict) -> dict:
    """Poll a submitted request's record until it is terminal."""
    deadline = time.monotonic() + SERVICE_WAIT_S
    while rec.get("status") not in ("done", "failed", "cancelled"):
        if time.monotonic() > deadline:
            raise AssertionError(f"service: request {rec['id']} still "
                                 f"{rec.get('status')}")
        rec = cl.result(rec["id"], wait_s=10.0)
    return rec


def service_verdicts_match(rec: dict, expected: list, tiers: bool) -> bool:
    """Whether a request's results equal the one-shot results, by
    verdict (and by decided tier with `tiers`)."""
    got = rec.get("results") or []
    if len(got) != len(expected):
        return False
    keys = ("valid?", "decided-tier") if tiers else ("valid?",)
    return all(g.get(k) == e.get(k) for g, e in zip(got, expected)
               for k in keys)


def service_tenants(port: int, requests: list, n_tenants: int,
                    replicas=()) -> tuple:
    """Submit `requests` from n_tenants threads, each with its own
    ServiceClient (even tenants binary frames, odd JSON; with `replicas`,
    the other replicas' URLs, a routing client), each request waited for
    before the tenant sends its next (closed loop). Returns (records in
    request order, client-side latencies in ms, wall s)."""
    from jepsen_jgroups_raft_tpu_torch.service import ServiceClient

    recs: list = [None] * len(requests)
    lat: list = [None] * len(requests)
    errors: list = []

    def tenant(k: int) -> None:
        cl = ServiceClient(f"http://127.0.0.1:{port}",
                           replicas=list(replicas), timeout=60.0)
        try:
            for i in range(k, len(requests), n_tenants):
                workload, rows, _ = requests[i]
                t0 = time.perf_counter()
                rec = cl.submit(rows, workload=workload,
                                binary=k % 2 == 0)
                recs[i] = service_wait(cl, rec)
                lat[i] = (time.perf_counter() - t0) * 1e3
        except BaseException as e:  # noqa: BLE001 — raised after the join
            errors.append(e)
        finally:
            cl.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=tenant, args=(k,))
               for k in range(n_tenants)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return recs, lat, wall


def service_streams(port: int, sessions: list) -> tuple:
    """One thread a session over HTTP, STREAM_APPEND_ROWS rows an
    append. Returns (final records, append latencies in ms, the
    sessions whose violation surfaced on an append before finish)."""
    from jepsen_jgroups_raft_tpu_torch.service import ServiceClient

    finals: list = [None] * len(sessions)
    lat: list = []
    mid = []
    errors: list = []
    lock = threading.Lock()

    def run(s: int) -> None:
        cl = ServiceClient(f"http://127.0.0.1:{port}", timeout=60.0)
        try:
            sess = cl.stream(workload="register")
            ops = [op.to_dict() for op in sessions[s]]
            seen = False
            for lo in range(0, len(ops), STREAM_APPEND_ROWS):
                t0 = time.perf_counter()
                st = sess.append(ops[lo:lo + STREAM_APPEND_ROWS])
                dt = (time.perf_counter() - t0) * 1e3
                with lock:
                    lat.append(dt)
                seen = seen or st.get("violation") is not None
            finals[s] = sess.finish()
            if seen:
                with lock:
                    mid.append(s)
        except BaseException as e:  # noqa: BLE001 — raised after the join
            errors.append(e)
        finally:
            cl.close()

    threads = [threading.Thread(target=run, args=(s,))
               for s in range(len(sessions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return finals, lat, sorted(mid)


def service_degraded(recs) -> int:
    """Results among `recs` that carry a platform-degraded stamp."""
    return sum(1 for rec in recs for r in rec.get("results") or []
               if "platform-degraded" in r)


def phase_service(dev, histories, bad_north, bad_set, counters) -> dict:
    """6d. The checking service on the card (`service/`): tenants submit
    over HTTP, the scheduler coalesces their requests into
    `check_encoded` batches on the card and demultiplexes the verdicts.

    Main arm (lin fast path off): SERVICE_TENANTS tenant threads, each
    with its own ServiceClient, half sending binary frames and half JSON,
    submit SERVICE_VALID north-star histories, the corrupted register
    and set rows and SERVICE_COUNTER counter histories,
    SERVICE_PER_REQUEST histories a request. Stream arm: SERVICE_STREAMS
    sessions over HTTP. Default arm: SERVICE_DEFAULT_VALID valid and
    SERVICE_DEFAULT_CORRUPT corrupted histories at the default knobs (the
    fast lane on). Restart arm: SERVICE_RESTART requests admitted to a
    service that never runs them; a second service on a copy of its
    journal (the journal as a crash leaves it: submit records, no
    terminal marker) replays them.

    Fails if a main-arm verdict or decided tier differs from
    `check_histories` on the same histories on this card, if a stream's
    or a default-arm verdict differs from it, if a corrupted row is not
    INVALID, if no batch coalesced two requests, if B1's or B5's
    launches over the main arm (B5's over the stream arm) are 0, if a
    result is degraded or a batch is, if the binary and JSON fingerprints
    of the same histories differ, or if a replayed verdict differs from
    its first answer. The launch counts are set to 0 just before each
    arm and read just after. Returns each arm's launches by kernel."""
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.models import (CasRegister, Counter,
                                                      GSet)
    from jepsen_jgroups_raft_tpu_torch.service import (CheckingService,
                                                       ServiceClient,
                                                       serve_in_thread)

    reg, gset, ctr = CasRegister(), GSet(), Counter()
    valid = [list(h) for h in histories[:SERVICE_VALID]]
    bad_reg = bad_north[:SERVICE_CORRUPT_EACH]
    bad_s = bad_set[:SERVICE_CORRUPT_EACH]
    cnt = [list(h) for h in counters[:SERVICE_COUNTER]]
    t0 = time.perf_counter()
    one_reg = check_histories(valid + bad_reg, reg, device=dev)
    one_set = check_histories(bad_s, gset, device=dev)
    one_ctr = check_histories(cnt, ctr, device=dev)
    oneshot_s = time.perf_counter() - t0
    requests = (service_requests("register", valid + bad_reg, one_reg)
                + service_requests("set", bad_s, one_set)
                + service_requests("counter", cnt, one_ctr))
    n_valid_req = SERVICE_VALID // SERVICE_PER_REQUEST
    corrupt_req = set(range(n_valid_req, n_valid_req + 2 * (
        SERVICE_CORRUPT_EACH // SERVICE_PER_REQUEST)))
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-service-"))
    out: dict = {}
    try:
        # ---- main arm
        svc = CheckingService(journal_dir=str(tmp / "journal"), device=dev)
        httpd, port, _ = serve_in_thread(svc)
        try:
            reset_all_launch_counts()
            recs, lat, wall = service_tenants(port, requests,
                                              SERVICE_TENANTS)
            main_launches = {k: v for k, v in all_launch_counts().items()
                             if v}
            cl = ServiceClient(f"http://127.0.0.1:{port}")
            workload, rows, _ = requests[0]
            fp = {lane: cl.submit(rows, workload=workload,
                                  binary=lane == "binary")["fingerprint"]
                  for lane in ("binary", "json")}
            st = cl.stats()
            cl.close()
        finally:
            httpd.shutdown()
            httpd.server_close()
            svc.shutdown()
        per_batch = [r["service-stats"]["batched_requests"] for r in recs]
        rows_batch = [r["service-stats"]["batch_rows"] for r in recs]
        # each batch's check wall (its `check_encoded` on the card and the
        # demultiplexing), once a batch: the rest of the arm's wall is
        # HTTP, JSON, encode, journal and the linger
        batch_walls = {r["service-stats"]["batch_seq"]:
                       r["service-stats"]["batch_wall_s"] for r in recs}
        bad_match = [i for i, (rec, req) in enumerate(zip(recs, requests))
                     if not service_verdicts_match(rec, req[2], True)]
        corrupt_ok = all(r["valid?"] is False for i in corrupt_req
                         for r in recs[i]["results"])
        n_hist = sum(len(r[1]) for r in requests)
        b1 = main_launches.get("dense_scan", 0) + main_launches.get(
            "dense_scan_chunk", 0)
        b5 = main_launches.get("sort_scan", 0) + main_launches.get(
            "sort_scan_chunk", 0)
        emit("service_main", requests=len(requests), histories=n_hist,
             batches=st["batches"], batched_requests_max=max(per_batch),
             batched_requests_mean=st["batch_occupancy_mean"],
             rows_per_batch_max=max(rows_batch),
             rows_per_batch_mean=st["batch_rows"] / max(st["batches"], 1),
             hist_per_s=n_hist / wall, wall_s=wall,
             batch_wall_sum_s=sum(batch_walls.values()),
             batch_wall_max_s=max(batch_walls.values()),
             oneshot_check_s=oneshot_s,
             latency_p50_ms=pct(lat, 0.5), latency_p99_ms=pct(lat, 0.99),
             server_p50_latency_s=st.get("p50_latency_s"),
             server_p99_latency_s=st.get("p99_latency_s"),
             launches=main_launches, degraded_batches=st["degraded_batches"],
             degraded_results=service_degraded(recs),
             decided_tier=st["decided_tier"], mismatched=bad_match,
             fingerprints_equal=fp["binary"] == fp["json"],
             journal_append_p50_ms=st.get("journal_append_p50_ms"))
        if bad_match:
            raise AssertionError(f"service_main: requests {bad_match} "
                                 "differ from check_histories")
        if not corrupt_ok:
            raise AssertionError("service_main: a corrupted row passed")
        if max(per_batch) < 2:
            raise AssertionError("service_main: no batch coalesced two "
                                 "requests")
        if b1 <= 0 or b5 <= 0:
            raise AssertionError(f"service_main: B1 {b1} / B5 {b5} "
                                 "launches")
        if st["degraded_batches"] or service_degraded(recs):
            raise AssertionError("service_main: a degraded batch")
        if fp["binary"] != fp["json"]:
            raise AssertionError("service_main: binary and JSON "
                                 "fingerprints differ")
        out["main"] = main_launches

        # ---- stream arm
        rng = random.Random(SEED + 70)
        n_ok = SERVICE_STREAMS - SERVICE_STREAM_CORRUPT
        sessions = [list(h) for h in
                    histories[SERVICE_VALID:SERVICE_VALID + n_ok]]
        sessions += bad_north[SERVICE_CORRUPT_EACH:SERVICE_CORRUPT_EACH
                              + SERVICE_STREAM_CORRUPT]
        sessions = [record_crashes(ops) for ops in sessions]
        one_stream = check_histories(sessions, reg, device=dev)
        svc = CheckingService(device=dev)
        httpd, port, _ = serve_in_thread(svc)
        try:
            reset_all_launch_counts()
            t0 = time.perf_counter()
            finals, alat, mid = service_streams(port, sessions)
            stream_wall = time.perf_counter() - t0
            stream_launches = {k: v for k, v in
                               all_launch_counts().items() if v}
            sst = svc.stats()
        finally:
            httpd.shutdown()
            httpd.server_close()
            svc.shutdown()
        differ = [s for s, (f, o) in enumerate(zip(finals, one_stream))
                  if f["valid?"] != o["valid?"]]
        emit("service_stream", sessions=len(sessions),
             appends=len(alat), append_p50_ms=pct(alat, 0.5),
             append_p99_ms=pct(alat, 0.99), decided_mid_stream=len(mid),
             mid_stream_sessions=mid, wall_s=stream_wall,
             launches=stream_launches, differ=differ,
             stream_violations=sst["stream_violations"])
        if differ:
            raise AssertionError(f"service_stream: sessions {differ} "
                                 "differ from the one-shot check")
        if any(finals[s]["valid?"] is not False
               for s in range(n_ok, len(sessions))):
            raise AssertionError("service_stream: a corrupted session "
                                 "passed")
        if stream_launches.get("sort_scan_chunk", 0) <= 0:
            raise AssertionError("service_stream: B5 never launched")
        out["stream"] = stream_launches

        # ---- default arm: the fast lane on
        lo = SERVICE_VALID + n_ok
        dvalid = [list(h) for h in
                  histories[lo:lo + SERVICE_DEFAULT_VALID]]
        c0 = SERVICE_CORRUPT_EACH + SERVICE_STREAM_CORRUPT
        dbad = bad_north[c0:c0 + SERVICE_DEFAULT_CORRUPT]
        one_def = check_histories(dvalid + dbad, reg, device=dev)
        dreqs = service_requests("register", dvalid + dbad, one_def)

        def default_arm():
            svc = CheckingService(device=dev)
            httpd, port, _ = serve_in_thread(svc)
            try:
                reset_all_launch_counts()
                recs, _, wall = service_tenants(port, dreqs,
                                                SERVICE_TENANTS)
                launches = {k: v for k, v in all_launch_counts().items()
                            if v}
                return recs, wall, svc.stats(), launches
            finally:
                httpd.shutdown()
                httpd.server_close()
                svc.shutdown()

        drecs, dwall, dst, out["default"] = with_env(
            "JGRAFT_LIN_FASTPATH", None, default_arm)
        dbad_req = range(SERVICE_DEFAULT_VALID // SERVICE_PER_REQUEST,
                         len(dreqs))
        dmis = [i for i, (rec, req) in enumerate(zip(drecs, dreqs))
                if not service_verdicts_match(rec, req[2], False)]
        emit("service_default", requests=len(dreqs),
             fastlane_requests=dst["fastpath_requests"],
             batches=dst["batches"], wall_s=dwall,
             decided_tier=dst["decided_tier"], mismatched=dmis,
             launches=out["default"],
             degraded_batches=dst["degraded_batches"])
        if dmis or any(r["valid?"] is not False for i in dbad_req
                       for r in drecs[i]["results"]):
            raise AssertionError("service_default: a verdict differs or a "
                                 "corrupted row passed")
        if dst["degraded_batches"] or service_degraded(drecs):
            raise AssertionError("service_default: a degraded batch")

        # ---- restart arm
        rreqs = requests[:SERVICE_RESTART]
        held = CheckingService(journal_dir=str(tmp / "held"), device=dev,
                               autostart=False)
        ids = [held.submit(rows, workload=w).id for w, rows, _ in rreqs]
        # the journal as a crash right now leaves it: every submit record
        # fsync'd, no terminal marker (the shutdown below writes FAILED
        # markers into the original, as a clean stop does)
        shutil.copytree(tmp / "held", tmp / "crashed")
        held.shutdown()
        t0 = time.perf_counter()
        reset_all_launch_counts()
        again = CheckingService(journal_dir=str(tmp / "crashed"),
                                device=dev)
        try:
            replayed = []
            for rid in ids:
                r = again.get(rid)
                if r is None or not r.wait(SERVICE_WAIT_S):
                    raise AssertionError(f"service_restart: request {rid} "
                                         "not replayed")
                replayed.append(r)
            out["restart"] = {k: v for k, v in all_launch_counts().items()
                              if v}
            rst = again.stats()
        finally:
            again.shutdown()
        restart_s = time.perf_counter() - t0
        rmis = [i for i, (r, req) in enumerate(zip(replayed, rreqs))
                if not (r.replayed and service_verdicts_match(
                    {"results": r.results}, req[2], True))]
        emit("service_restart", admitted=len(ids),
             replayed=rst["recovered_requests"], seconds=restart_s,
             mismatched=rmis, launches=out["restart"],
             degraded_batches=rst["degraded_batches"])
        if rst["recovered_requests"] != len(ids) or rmis:
            raise AssertionError("service_restart: a request was not "
                                 "replayed, or its verdict differs from "
                                 "its first answer")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


#: the cluster phase: the wave's valid and corrupted north-star histories
#: (256 in all, SERVICE_PER_REQUEST a request), the handoff's requests
#: (HANDOFF_PER_REQUEST histories each, the last HANDOFF_CORRUPT_REQUESTS
#: requests corrupted), where each arm's histories start in the
#: north-star batch, and the leases' times
CLUSTER_WAVE_VALID = 224
CLUSTER_WAVE_CORRUPT = 32
CLUSTER_WAVE_AT = 600
HANDOFF_REQUESTS = 32
HANDOFF_PER_REQUEST = 4
HANDOFF_CORRUPT_REQUESTS = 2
HANDOFF_AT = CLUSTER_WAVE_AT + CLUSTER_WAVE_VALID
SHED_AT = HANDOFF_AT + HANDOFF_REQUESTS * HANDOFF_PER_REQUEST
DEAD_LEASE_TTL_S = 0.5
CLUSTER_SKEW_S = 0.2


def phase_service_cluster(dev, histories, bad_north) -> dict:
    """6e. graftd's cluster tier on the card (`service/cluster.py`,
    `service/store.py`): two replicas in this process share a fresh
    cluster dir, each served over HTTP and advertising its URL in its
    lease (the reference's `bench.py --service --replicas 2`, cut to a
    phase). Result caches are off (capacity 0), so a repeat is a store
    hit, not an LRU one.

    Wave: SERVICE_TENANTS tenants, each with a routing client
    (`replicas=[...]`, affinity first; even tenants binary frames), send
    CLUSTER_WAVE_VALID fresh north-star histories and CLUSTER_WAVE_CORRUPT
    corrupted ones, SERVICE_PER_REQUEST a request. Resubmission: every
    request of the wave to each replica directly, as binary frames.
    Handoff: replica r0 is
    stopped and started again with its workers off and its heartbeat on
    (the same id and WAL), admits HANDOFF_REQUESTS
    fresh requests and opens one stream session (a corrupted history, its
    first half appended), and dies (its heartbeat stopped after a last
    lease of DEAD_LEASE_TTL_S, its journal closed, the lease left to
    expire); r1's cluster agent claims the WAL, r1 checks the requests on
    the card, and a client resumes the session on r1 and finishes it.
    Shedding: a third replica with JGRAFT_SERVICE_SHED_DEPTH=1 and a
    request queued answers the next with a 429 carrying the cluster's
    best retry-after.

    Fails if a wave or handoff verdict or decided tier differs from
    `check_histories` on the same histories on this card, if a corrupted
    row is not INVALID, if a replica took no wave request, if a result or
    a batch is degraded, if a resubmission is not a store hit or makes a
    batch or a launch, if a handoff request or the stream is not claimed,
    if B1's launches over the wave or the handoff (B5's over the stream)
    are 0, if the stream's verdict differs from its one-shot check, or if
    the 429's retry-after is not the cluster's best. The launch counts
    are set to 0 just before each arm and read just after. Returns each
    arm's launches by kernel."""
    from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
        check_histories)
    from jepsen_jgroups_raft_tpu_torch.models import CasRegister
    from jepsen_jgroups_raft_tpu_torch.service import (CheckingService,
                                                       ServiceClient,
                                                       ServiceError,
                                                       serve_in_thread)

    reg = CasRegister()
    lo, hi = CLUSTER_WAVE_AT, CLUSTER_WAVE_AT + CLUSTER_WAVE_VALID
    wave_h = [list(h) for h in histories[lo:hi]] + \
        bad_north[:CLUSTER_WAVE_CORRUPT]
    n_handoff_ok = (HANDOFF_REQUESTS - HANDOFF_CORRUPT_REQUESTS) \
        * HANDOFF_PER_REQUEST
    handoff_h = [list(h) for h in
                 histories[HANDOFF_AT:HANDOFF_AT + n_handoff_ok]] + \
        bad_north[CLUSTER_WAVE_CORRUPT:CLUSTER_WAVE_CORRUPT
                  + HANDOFF_CORRUPT_REQUESTS * HANDOFF_PER_REQUEST]
    stream_h = record_crashes(bad_north[-1])
    one_wave = check_histories(wave_h, reg, device=dev)
    one_handoff = check_histories(handoff_h, reg, device=dev)
    [one_stream] = check_histories([stream_h], reg, device=dev)
    requests = service_requests("register", wave_h, one_wave)
    rows = [[op.to_dict() for op in h] for h in handoff_h]
    n = HANDOFF_PER_REQUEST
    handoff_reqs = [(rows[i:i + n], one_handoff[i:i + n])
                    for i in range(0, len(rows), n)]
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-cluster-"))
    cdir = str(tmp / "cluster")
    out: dict = {}
    t_phase = time.perf_counter()
    old_skew = os.environ.get("JGRAFT_CLUSTER_SKEW_S")
    os.environ["JGRAFT_CLUSTER_SKEW_S"] = str(CLUSTER_SKEW_S)
    replicas, fronts = [], []
    dead = None

    def serve(svc):
        httpd, port, _ = serve_in_thread(svc)
        fronts.append(httpd)
        svc.cluster.set_url(f"http://127.0.0.1:{port}")
        return port

    def stop(httpd, svc):
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()

    try:
        for k in range(2):
            replicas.append(CheckingService(
                device=dev, cluster_dir=cdir, replica_id=f"r{k}",
                cache_capacity=0))
        ports = [serve(svc) for svc in replicas]
        urls = [svc.cluster.url for svc in replicas]

        # ---- wave
        s0 = [svc.stats() for svc in replicas]
        reset_all_launch_counts()
        recs, lat, wall = service_tenants(ports[0], requests,
                                          SERVICE_TENANTS,
                                          replicas=urls[1:])
        out["wave"] = {k: v for k, v in all_launch_counts().items() if v}
        s1 = [svc.stats() for svc in replicas]
        per_replica = [b["submitted"] - a["submitted"]
                       for a, b in zip(s0, s1)]
        mism = [i for i, (rec, req) in enumerate(zip(recs, requests))
                if not service_verdicts_match(rec, req[2], True)]
        n_ok_req = CLUSTER_WAVE_VALID // SERVICE_PER_REQUEST
        corrupt_ok = all(r["valid?"] is False
                         for rec in recs[n_ok_req:] for r in rec["results"])
        deadline = time.monotonic() + SERVICE_WAIT_S
        while sum(svc.stats()["store_puts"] for svc in replicas) \
                < len(requests):  # published after each request is done
            if time.monotonic() > deadline:
                raise AssertionError("service_cluster: the wave's "
                                     "verdicts were not all published")
            time.sleep(0.05)

        # ---- resubmission: each request to each replica directly, as
        # binary frames (the JSON lane's fingerprint, service_main; the
        # lane skips the server's JSON parse and encode)
        s0 = [svc.stats() for svc in replicas]
        reset_all_launch_counts()
        t0 = time.perf_counter()
        cached = 0
        for url in urls:
            direct = ServiceClient(url, timeout=60.0)
            try:
                for workload, rws, _ in requests:
                    rec = direct.submit(rws, workload=workload, binary=True)
                    cached += bool(rec.get("cached")) \
                        and rec.get("status") == "done"
            finally:
                direct.close()
        resubmit_s = time.perf_counter() - t0
        resubmit_launches = sum(all_launch_counts().values())
        s1 = [svc.stats() for svc in replicas]
        store_hits = sum(b["store_hits"] - a["store_hits"]
                         for a, b in zip(s0, s1))
        resubmit_batches = sum(b["batches"] - a["batches"]
                               for a, b in zip(s0, s1))

        # ---- handoff: r0 restarts with its workers off, admits (its
        # heartbeat keeping the lease alive), then dies: the heartbeat
        # stops after one last renewal at DEAD_LEASE_TTL_S, the journal
        # is closed
        stop(fronts[0], replicas[0])
        dead = CheckingService(device=dev, cluster_dir=cdir,
                               replica_id="r0", cache_capacity=0,
                               autostart=False)
        dead.cluster.start()
        ids = [dead.submit(rws, workload="register").id
               for rws, _ in handoff_reqs]
        sid = "handoff-stream"
        srows = [op.to_dict() for op in stream_h]
        half = (len(srows) // 2 // STREAM_APPEND_ROWS) * STREAM_APPEND_ROWS
        dead.streams.open(workload="register", session_id=sid)
        seq = 1
        for a in range(0, half, STREAM_APPEND_ROWS):
            dead.streams.append(sid, seq, srows[a:a + STREAM_APPEND_ROWS],
                                n_bytes=0)
            seq += 1
        reset_all_launch_counts()
        dead.cluster._stop.set()
        dead.cluster._thread.join(10)
        dead.cluster.lease_ttl = DEAD_LEASE_TTL_S
        dead.cluster.renew_lease()
        dead._journal.close()  # dies: no terminal marker, no renewal
        t_dead = time.perf_counter()
        survivor = replicas[1]
        while survivor.stats()["handoff_claims"] < 1:
            if time.perf_counter() - t_dead > 60:
                raise AssertionError("service_cluster: r0's WAL was not "
                                     "claimed")
            time.sleep(0.02)
        claim_s = time.perf_counter() - t_dead
        adopted = []
        for rid in ids:
            r = survivor.get(rid)
            if r is None or not r.wait(SERVICE_WAIT_S):
                raise AssertionError(f"service_cluster: request {rid} not "
                                     "adopted or not finished")
            adopted.append(r)
        handoff_s = time.perf_counter() - t_dead
        cl = ServiceClient(urls[1], timeout=60.0)
        try:
            sess = cl.stream(workload="register", session_id=sid,
                             resume=True)
            resumed_at = sess.seq
            for a in range(half, len(srows), STREAM_APPEND_ROWS):
                sess.append(srows[a:a + STREAM_APPEND_ROWS])
            final = sess.finish()
        finally:
            cl.close()
        out["handoff"] = {k: v for k, v in all_launch_counts().items()
                          if v}
        hst = survivor.stats()
        hmis = [i for i, (r, req) in enumerate(zip(adopted, handoff_reqs))
                if r.status != "done" or not service_verdicts_match(
                    {"results": r.results}, req[1], True)]

        # ---- shedding: a third replica past its shed depth, beside the
        # idle r1 (its lease renewed now, so it advertises its idle
        # retry-after)
        survivor.cluster.renew_lease()
        os.environ["JGRAFT_SERVICE_SHED_DEPTH"] = "1"
        try:
            shed = CheckingService(device=dev, cluster_dir=cdir,
                                   replica_id="r2", cache_capacity=0,
                                   autostart=False)
        finally:
            del os.environ["JGRAFT_SERVICE_SHED_DEPTH"]
        shed_port = serve(shed)
        try:
            scl = ServiceClient(f"http://127.0.0.1:{shed_port}",
                                max_attempts=1, timeout=60.0)
            first = scl.submit([[op.to_dict() for op in
                                 histories[SHED_AT]]], workload="register")
            own = shed._retry_after()
            best = shed.cluster.best_retry_after(own)
            try:
                scl.submit([[op.to_dict() for op in histories[SHED_AT + 1]]],
                           workload="register")
                shed_status, shed_retry = 202, None
            except ServiceError as e:
                shed_status, shed_retry = e.status, e.retry_after_s
            scl.close()
        finally:
            stop(fronts[-1], shed)
        degraded = service_degraded(recs) + sum(
            1 for r in adopted for x in r.results or []
            if "platform-degraded" in x)
        st = [svc.stats() for svc in replicas]
        emit("service_cluster", replicas=2, requests=len(requests),
             histories=len(wave_h), hist_per_s=len(wave_h) / wall,
             wall_s=wall, latency_p50_ms=pct(lat, 0.5),
             latency_p99_ms=pct(lat, 0.99),
             requests_per_replica=per_replica, mismatched=mism,
             launches=out["wave"],
             resubmissions=len(urls) * len(requests), cached=cached,
             store_hits=store_hits, resubmit_batches=resubmit_batches,
             resubmit_launches=resubmit_launches, resubmit_s=resubmit_s,
             handoff_admitted=len(ids),
             handoff_requests=hst["handoff_requests"],
             handoff_streams=hst["handoff_streams"],
             handoff_claims=hst["handoff_claims"], claim_s=claim_s,
             handoff_s=handoff_s, handoff_mismatched=hmis,
             handoff_launches=out["handoff"], stream_resumed_at=resumed_at,
             stream_valid=final.get("valid?"),
             stream_expected=one_stream["valid?"],
             shed_status=shed_status, shed_retry_after_s=shed_retry,
             shed_own_retry_after_s=own, shed_best_retry_after_s=best,
             shed_first=first.get("status"),
             degraded_results=degraded,
             degraded_batches=sum(x["degraded_batches"] for x in st),
             live_replicas=st[1]["live_replicas"],
             seconds=time.perf_counter() - t_phase)
        if mism or not corrupt_ok:
            raise AssertionError(f"service_cluster: wave requests {mism} "
                                 "differ from check_histories, or a "
                                 "corrupted row passed")
        if min(per_replica) <= 0:
            raise AssertionError(f"service_cluster: a replica took no wave "
                                 f"request ({per_replica})")
        if degraded or any(x["degraded_batches"] for x in st):
            raise AssertionError("service_cluster: a degraded result")
        if cached != len(urls) * len(requests) \
                or store_hits != len(urls) * len(requests) \
                or resubmit_batches or resubmit_launches:
            raise AssertionError(
                f"service_cluster: resubmission {cached} cached, "
                f"{store_hits} store hits, {resubmit_batches} batches, "
                f"{resubmit_launches} launches")
        if hst["handoff_requests"] != len(ids) or hmis \
                or hst["handoff_streams"] != 1:
            raise AssertionError(
                f"service_cluster: handoff took {hst['handoff_requests']} "
                f"of {len(ids)} requests and {hst['handoff_streams']} "
                f"streams; {hmis} differ from check_histories")
        b1 = {arm: c.get("dense_scan_chunk", 0) + c.get("dense_scan", 0)
              for arm, c in out.items()}
        if min(b1.values()) <= 0 or \
                out["handoff"].get("sort_scan_chunk", 0) <= 0:
            raise AssertionError(f"service_cluster: launches {out}")
        if resumed_at != seq or final.get("valid?") != one_stream["valid?"]:
            raise AssertionError(
                f"service_cluster: the claimed stream resumed at "
                f"{resumed_at} (want {seq}) with {final.get('valid?')}")
        if shed_status != 429 or shed_retry != best or best >= own:
            raise AssertionError(
                f"service_cluster: shed {shed_status} with retry-after "
                f"{shed_retry} (own {own}, cluster's best {best})")
    finally:
        for httpd in fronts:
            httpd.shutdown()
            httpd.server_close()
        if dead is not None:
            # its WAL belongs to r1 now: the stop writes nothing there
            dead._journal = None
            dead.shutdown()
        for svc in replicas:
            svc.shutdown()
        if old_skew is None:
            os.environ.pop("JGRAFT_CLUSTER_SKEW_S", None)
        else:
            os.environ["JGRAFT_CLUSTER_SKEW_S"] = old_skew
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def run_phases(dev, model, ptxas: dict, histories: list,
               synth_s: float) -> list:
    """Phases 3-30 of the full run, on the kernels `main` built;
    `histories`: the north-star batch (made in `synth_s` seconds, beside
    the build). The kernels' checks against their plain versions run in
    a second process on the card (`start_kernel_checks`) while this one
    makes the suites' batches and runs the phases whose numbers are
    host walls: 8, 11, 15, 19, 20, 22-24, 27 and 28. The phases that time
    the card run after both. Returns the kernels line."""
    from jepsen_jgroups_raft_tpu_torch.models import (Counter, GSet,
                                                      ListAppend,
                                                      TicketQueue)
    from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import (
        dense_scan_plain, mask_scan_plain)

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

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        proc, recv, out = start_kernel_checks(tmp)
        try:
            # the suites' batches beside the north star
            suites = {kind: suite_histories(kind, SUITE_ROWS)
                      for kind in ("counter", "queue", "list-append")}
            suites["set"] = suite_histories("set", SUITE_ROWS,
                                            value_range=SET_VALUE_RANGE)
            c10, drawn, windows, c10_synth_s, counter10_wide = \
                counter10_histories()
            emit("counter10_synth", kept=len(c10), drawn=drawn,
                 windows=windows, seconds=c10_synth_s)

            # 8. invalid subset: guaranteed-invalid corruption (the bumped
            # read leaves the value domain), kernel vs plain vs host oracle
            rng = random.Random(SEED + 2)
            bad_north = []
            for h in histories[:N_INVALID]:
                ops_, changed = corrupt_read(h, rng, VALUE_RANGE + 1)
                if not changed:
                    raise AssertionError("a north-star history without an "
                                         "ok read")
                bad_north.append(ops_)
            phase_invalid(dev, model, bad_north, "dense", dense_plain,
                          "invalid")

            # 11. counter invalid subset: a read raised by 10^6 (beyond any
            # sum of the history's adds), kernel vs plain vs host oracle
            rng = random.Random(SEED + 5)
            bad = []
            for h in suites["counter"][0][:N_INVALID]:
                ops_, changed = corrupt_read(h, rng, 10**6)
                if not changed:
                    raise AssertionError("a counter history without an ok "
                                         "read")
                bad.append(ops_)
            m = Counter()
            phase_invalid(dev, m, bad, "mask", mask_plain(m),
                          "counter_invalid")

            # 15. set invalid subset: kernel vs plain ladder vs host oracle
            bad_set = phase_set_invalid(dev, suites["set"][0])

            # 19. the 10-process counter histories beyond the mask cap,
            # under auto
            t0 = time.perf_counter()
            phase_wide_auto(dev, counter10_wide)
            emit("wide_auto_summary", seconds=time.perf_counter() - t0)

            # 20. the north-star batch at the default knobs against the
            # fast path off
            t0 = time.perf_counter()
            phase_lin_fastpath(dev, histories)
            emit("lin_fastpath_summary", seconds=time.perf_counter() - t0)

            # 22. the sequential rung at upstream's per-key shape and
            # bench.py's row, planted stale reads refuted by the cycle tier
            t0 = time.perf_counter()
            seq = phase_sequential_main(dev, histories)
            cycle_launches = dict(seq["launches"])
            emit("sequential_main_summary", seconds=time.perf_counter() - t0)

            # 23. the planted rows' sc-refuted evidence at the session rung
            t0 = time.perf_counter()
            add_counts(cycle_launches,
                       phase_session_evidence(dev, seq["planted"]))
            emit("session_evidence_summary",
                 seconds=time.perf_counter() - t0)

            # 24. the transactional anomaly rung at the reference's A/B
            # shape
            t0 = time.perf_counter()
            add_counts(cycle_launches, phase_anomaly_main(dev))
            emit("anomaly_main_summary", seconds=time.perf_counter() - t0)

            # 27-28: the re-check of recorded runs (BASELINE config 3) and
            # the per-key checker (config 4)
            t0 = time.perf_counter()
            rec = phase_recorded_main(dev, Path(tmp) / "recorded")
            emit("recorded_main_summary", seconds=time.perf_counter() - t0)
            t0 = time.perf_counter()
            phase_keyed_main(dev)
            emit("keyed_main_summary", seconds=time.perf_counter() - t0)

            errs = finish_kernel_checks(proc, recv, out)
        finally:
            if proc.is_alive():
                proc.terminate()
            proc.join()

        # 6. the main path: the north-star batch through check_histories
        line = {"dense_scan": run_path("main", dev, model, histories,
                                       synth_s, "dense", "dense_scan",
                                       ptxas["dense_scan"], one_shot=True,
                                       measure_chunk=True)}
        line["dense_scan_chunk"] = line["dense_scan"].pop("chunk")
        untuned = {k: line["dense_scan"].pop(k)
                   for k in ("check_s_best", "verdicts")}
        untuned["chunk_launch"] = {k: v for k, v in
                                   line["dense_scan_chunk"].items()
                                   if k != "launches"}

        # 6b. the main path with its launch plans: measured, then loaded,
        # then on the batch with phase 8's corrupted rows
        t0 = time.perf_counter()
        tuned = phase_autotune_main(dev, model, histories, untuned,
                                    bad_north)
        tuned_launches = {"autotune_main": tuned["launches"]}
        emit("autotune_main_summary", seconds=time.perf_counter() - t0)

        # 6c. streaming sessions on the north-star histories
        t0 = time.perf_counter()
        stream = phase_stream(dev, histories)
        emit("stream_summary", seconds=time.perf_counter() - t0)

        # 6d. the checking service on the card: tenants over HTTP, the
        # stream sessions, the default knobs and a restart
        t0 = time.perf_counter()
        service = phase_service(dev, histories, bad_north, bad_set,
                                suites["counter"][0])
        emit("service_summary", seconds=time.perf_counter() - t0)

        # 6e. the service's cluster tier: two replicas, the shared store,
        # a handoff and shedding
        t0 = time.perf_counter()
        service_cluster = phase_service_cluster(dev, histories, bad_north)
        emit("service_cluster_summary", seconds=time.perf_counter() - t0)

        # 7. the card's busy share over one check, from a profiler trace
        phase_profile(dev, model, histories)

        # 9. the counter and queue paths: the suite's shapes on the mask
        # kernel
        paths = {}
        for phase, kind, m in (("counter_main", "counter", Counter()),
                               ("queue_main", "queue", TicketQueue())):
            hs, kind_synth_s = suites[kind]
            paths[phase] = run_path(phase, dev, m, hs, kind_synth_s, "mask",
                                    "mask_scan", ptxas["mask_scan"],
                                    one_shot=kind == "counter",
                                    measure_chunk=kind == "counter")
            paths[phase]["model"] = m

        # 10. the counter at upstream's documented concurrency (10
        # processes): windows 10..13, the rows within the mask cap
        paths["counter10_main"] = run_path("counter10_main", dev, Counter(),
                                           c10, c10_synth_s, "mask",
                                           "mask_scan", ptxas["mask_scan"])
        paths["counter10_main"]["model"] = Counter()
        mask_line = list(paths.values())

        # 12. the instrumented mask kernel on the paths' own groups
        phase_mask_profile(dev, paths)

        # 14. the set path: the suite's set shape through the sort ladder
        set_hs, set_synth_s = suites["set"]
        line["sort_scan"] = run_sort_path("set_main", dev, GSet(), set_hs,
                                          set_synth_s, ptxas["sort_scan"],
                                          one_shot=True, measure_chunk=True,
                                          measure_fused=True,
                                          value_range=SET_VALUE_RANGE)
        line["sort_scan_chunk"] = line["sort_scan"].pop("chunk")
        fused_sort = line["sort_scan"].pop("fused")

        # 14b. the set path with its launch plans (the sort ladder's)
        t0 = time.perf_counter()
        tuned_launches["autotune_set"] = phase_autotune_set(
            dev, set_hs, bad_set)
        emit("autotune_set_summary", seconds=time.perf_counter() - t0)

        # 17. suite configs 5 and 4, segmented and monolithic, on the card
        t0 = time.perf_counter()
        long = phase_long_main(dev)
        line["segment_scan"] = long["line"]
        emit("long_main_summary", seconds=time.perf_counter() - t0)

        # 18. config 5 with one late read outside the domain
        t0 = time.perf_counter()
        errs["segment_scan"] = max(errs["segment_scan"],
                                   phase_long_invalid(dev, long["config5"]))
        emit("long_invalid_summary", seconds=time.perf_counter() - t0)

        # 25. list-append (bench.py config 9) through the sort ladder
        t0 = time.perf_counter()
        la_hs, la_synth_s = suites["list-append"]
        la_line = run_sort_path("listappend_main", dev, ListAppend(), la_hs,
                                la_synth_s, ptxas["sort_scan"])
        for k in ("launches", "ms", "plain_ms", "t_bytes", "t_ops"):
            line["sort_scan"][k] += la_line[k]
        line["sort_scan"]["max_abs_err"] = max(
            line["sort_scan"]["max_abs_err"], la_line["max_abs_err"])
        line["sort_scan_chunk"]["launches"] += la_line["chunk"]["launches"]
        emit("listappend_main_summary", seconds=time.perf_counter() - t0)

        # the closure kernels' numbers on the batches the main path gave
        # them
        t0 = time.perf_counter()
        for name in ("cycle_closure", "cycle_closure_tiled"):
            line[name] = closure_line(dev, name, seq["batches"][name],
                                      cycle_launches.get(name, 0),
                                      errs["cycle_closure"])
        emit("closure_main_path_summary", seconds=time.perf_counter() - t0)

        # 26: B9's election-safety kernel, its store in a directory of its
        # own; its launches on the main path are the recorded re-check's
        t0 = time.perf_counter()
        line["election_safety"] = phase_election_kernel(
            dev, Path(tmp) / "elections")
        line["election_safety"]["launches"] = rec["election_launches"]
        emit("election_kernel_summary", seconds=time.perf_counter() - t0)

    # 29-30: B10, the batch mesh on the north-star batch, and two ranks on
    # this card
    t0 = time.perf_counter()
    line.update(phase_mesh(dev, model, histories, fused_sort))
    errs.pop("verdict_counts_edges")  # on its own lines
    emit("mesh_summary", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_cluster(dev, model)
    emit("cluster_summary", seconds=time.perf_counter() - t0)

    line["mask_scan"] = {
        "launches": sum(x["launches"] for x in mask_line),
        "max_abs_err": max(x["max_abs_err"] for x in mask_line),
        "ms": sum(x["ms"] for x in mask_line),
        "plain_ms": sum(x["plain_ms"] for x in mask_line),
        "t_bytes": sum(x["t_bytes"] for x in mask_line),
        "t_ops": sum(x["t_ops"] for x in mask_line)}
    line["mask_scan_chunk"] = dict(
        paths["counter_main"]["chunk"],
        launches=sum(x["chunk"]["launches"] for x in paths.values()))
    line["mask_scan_chunk"]["launches_by_path"] = {
        "wavefront": line["mask_scan_chunk"]["launches"]}
    # the chunk kernels' launches by path: the main paths' wavefront, the
    # main path and the set path under their launch plans (autotune_main,
    # autotune_set; samples included) and the streaming sessions (stream,
    # B5 one row a launch)
    for name in ("dense_scan_chunk", "sort_scan_chunk"):
        x = line[name]
        x["launches_by_path"] = {"wavefront": x["launches"],
                                 **{path: n.get(name, 0) for path, n in
                                    tuned_launches.items()}}
    # the tuned launch: the main path's largest group under its plan
    line["dense_scan_chunk"]["tuned_launch"] = {
        k: tuned["tuned_launch"][k] for k in ("ms", "plain_ms", "t_bytes",
                                              "t_ops", "max_abs_err",
                                              "rows", "width", "plan")}
    line["sort_scan_chunk"]["launches_by_path"]["stream"] = \
        stream["launches"]
    # the checking service's launches (all four of its arms; the
    # cluster phase's wave and handoff under a path of their own), each
    # under the kernel that made them: a chunk form's on its chunk line
    # (summed from launches_by_path below), any other kernel's added to
    # its line's launches beside those of its other paths
    for path, arms in (("service", service),
                       ("service_cluster", service_cluster)):
        path_launches: dict = {}
        for counts in arms.values():
            for k, n in counts.items():
                path_launches[k] = path_launches.get(k, 0) + n
        for name, n in sorted(path_launches.items()):
            x = line.get(name)
            if x is None:
                raise AssertionError(f"{path}: launches of {name}, which "
                                     "the kernels line does not list")
            if not name.endswith("_chunk"):
                x.setdefault("launches_by_path",
                             {"other_paths": x["launches"]})
                x["launches"] += n
            x["launches_by_path"][path] = n
    line["sort_scan_chunk"]["stream_launch"] = {
        k: stream[k] for k in ("ms", "device_ms", "plain_ms", "t_bytes",
                               "t_ops", "max_abs_err", "W", "C",
                               "real_events")}
    for name in ("dense_scan_chunk", "mask_scan_chunk", "sort_scan_chunk"):
        x = line[name]
        x["launches"] = sum(x["launches_by_path"].values())
        x["max_abs_err"] = max(x["max_abs_err"], *(
            x.get(k, {}).get("max_abs_err", 0)
            for k in ("stream_launch", "tuned_launch")))
    errs.update(election_safety=0)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name in OFF_PATH:
            continue
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
            "device_ms": x.get("device_ms"),
            "chain_floor_ms": x.get("chain_floor_ms"),
            "launches_by_path": x.get("launches_by_path"),
            "stream_launch": x.get("stream_launch"),
            "tuned_launch": x.get("tuned_launch"),
            "registers": rep["max_registers"],
            "spill_bytes": rep["spill_store_bytes"] +
            rep["spill_load_bytes"]})
    return kernels


def scan_instances(libs) -> dict:
    """ptxas's report of the scan libraries among `libs`, split by the
    counting flag (`_build.ptxas_by_count`): instances, most registers,
    stack and spill bytes."""
    from jepsen_jgroups_raft_tpu_torch.ops import _build

    out = {}
    for lib in _build.SCAN_TEMPLATES:
        if lib not in libs:
            continue
        for flag, funcs in zip(("plain", "counting"),
                               _build.ptxas_by_count(lib)):
            rs = list(funcs.values())
            out[f"{lib}_{flag}"] = {
                "instances": len(rs),
                "max_registers": max((r["registers"] for r in rs),
                                     default=0),
                "stack_bytes": sum(r["stack_bytes"] for r in rs),
                "spill_bytes": sum(r["spill_bytes"] for r in rs)}
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or \
                not set(argv[1].split(",")) <= set(ONLY):
            print(f"usage: chip_smoke.py [--only "
                  f"{{{','.join(ONLY)}}}[,...]]", file=sys.stderr)
            return 2
        only = list(dict.fromkeys(argv[1].split(",")))
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
        from jepsen_jgroups_raft_tpu_torch.models import CasRegister
        from jepsen_jgroups_raft_tpu_torch.ops import _build
        from jepsen_jgroups_raft_tpu_torch.platform import toolchain_stamp
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2

    # the phases that drive a kernel hold every row on its kernel's tier,
    # so they run with the lin fast path off, as the reference's test
    # suite does; `lin_fastpath` runs the default knobs on its own. The
    # launch plans and the cycle-arm store are off too, so the phases
    # measure the launches they always did (`autotune_main`,
    # `autotune_set`, `lin_fastpath` and the default arms of
    # `sequential_main` and `session_evidence` turn them on), and the
    # store is a fresh directory of this run
    os.environ["JGRAFT_LIN_FASTPATH"] = "0"
    os.environ["JGRAFT_AUTOTUNE"] = "0"
    store = Path(__file__).resolve().parent / "build" / "chip_smoke_store"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    os.environ["JGRAFT_AUTOTUNE_STORE"] = str(store)
    dev = torch.device("cuda")
    model = CasRegister()
    stamp = toolchain_stamp()
    emit("stamp", **stamp)
    if only is not None:
        libs = list(dict.fromkeys(k for x in only for k in ONLY[x][0]))
        emit("build", seconds=_build.build(libs), kernels=libs,
             seconds_by_library=dict(_build.BUILD_SECONDS),
             ptxas={k: _build.ptxas_report(k) for k in libs},
             scan_instances=scan_instances(libs))
        for x in only:
            t0 = time.perf_counter()
            ONLY[x][1](dev)
            emit(f"{x}_summary", seconds=time.perf_counter() - t0)
        print(nvidia_smi_line(), flush=True)
        print(json.dumps({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 2. build every kernel from this checkout's sources, and the
    # instrumented mask kernel, in parallel
    path_libs = list(dict.fromkeys([*(KERNEL_LIBRARY.get(k, k)
                                      for k in KERNELS), *COUNT_LIBRARIES]))
    libs = [*path_libs, "mask_scan_profile", "segment_scan_profile"]
    # in parallel; the north-star batch is made on the host meanwhile
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(_build.build, libs)
        histories, synth_s = suite_histories("register")
        build_s = building.result()
    ptxas = {k: _build.ptxas_report(k) for k in libs}
    emit("build", seconds=build_s, kernels=libs,
         seconds_by_library=dict(_build.BUILD_SECONDS), ptxas=ptxas,
         scan_instances=scan_instances(libs),
         cycle_closure_functions=_build.ptxas_functions("cycle_closure"))
    for k, rep in ptxas.items():
        if rep["functions"] == 0:
            raise AssertionError(f"no ptxas report for {k}")
        if k in path_libs and (rep["spill_store_bytes"]
                               + rep["spill_load_bytes"] or
                               rep["max_stack_bytes"]):
            raise AssertionError(f"{k} spills or uses a stack: {rep}")

    kernels = run_phases(dev, model, ptxas, histories, synth_s)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
