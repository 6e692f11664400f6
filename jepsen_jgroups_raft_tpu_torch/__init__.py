"""PyTorch/CUDA port of the Jepsen harness and its history checker,
for an NVIDIA H100.

A second package beside `jepsen_jgroups_raft_tpu` (the JAX reference,
which it never imports). Histories are encoded and macro-packed on the
host, grouped by kernel kind and concurrency window, and verified by
hand-written CUDA kernels: the dense-domain scan
(`ops/csrc/dense_scan.cu`) for the CAS register, the north-star
workload, the mask-mode scan (`ops/csrc/mask_scan.cu`) for the counter
and the ticket queue, the sort-frontier ladder (`ops/csrc/sort_scan.cu`)
for every other row with a window ≤ 127, and the segmented scan
(`ops/csrc/segment_scan.cu`) for long histories. Host tiers decide what
the kernels cannot (a DFS, the frontier oracle), and at the default
knobs a host witness certifier decides most valid rows first. The
weaker rungs (sequential, session) relax the encodings and refute by
dependency cycle, and the transactional anomaly rung certifies
list-append histories, both through the closure kernels
(`ops/csrc/cycle_closure.cu`). Recorded runs are re-checked from the
store (`checker/recorded.py`, the `check` CLI), multi-key histories per
key in one batch (`checker/independent.py`), and election safety has a
batched check on the card (`ops/csrc/election_safety.cu`). The checking
service (`service/`, graftd) batches many tenants' submissions onto
the card over HTTP; N replicas sharing a cluster directory behave as
one service. The harness (`core/runner.py`, the `test` CLI) deploys a
Raft cluster (the native tier as local processes, or the in-process
SUT), drives the workload's clients under injected faults, records the
history and checks it on the card.

Layout (mirrors the reference's module paths):
  platform.py          env knobs, `resolve_device`, `toolchain_stamp`
  history/             op records, encoding, macro packing, synthesis
  core/                the store's on-disk format (the reference's),
                       the test runner, composition, the DB protocol,
                       the results browser
  cli.py, __main__.py  `python -m jepsen_jgroups_raft_tpu_torch test`,
                       `... serve`, `... check`, `... serve-checker`
  client/, generator/  the client protocol and error taxonomy; the
                       generator algebra
  workload/, nemesis/  the workloads; the fault packages
  sut/, native/,       the in-process SUT; the native tier's build and
  deploy/              ctypes client; the local multi-process cluster
  models/              the model protocol, register, counter, queue,
                       set, list-append, the election-safety models
  ops/kernel_ir.py     caps, macro row layout, plain-torch step parts
  ops/dense_scan.py    grouping, the kernel wrappers `dense_scan` and
                       `mask_scan` and their plain versions
  ops/linear_scan.py   the sort ladder's kernel wrapper `sort_scan`
  ops/segment_scan.py  long-history planning and composition, the
                       kernel wrapper `segment_scan`
  ops/cycle_closure.py the closure kernels' wrapper `cycle_closure`
                       and their plain versions
  ops/election_safety.py the election-safety kernel's wrapper
  ops/csrc/            CUDA sources, built by ops/_build.py at first use
  checker/             `check_histories`, the lin fast path, the host
                       tiers, the consistency rungs and the cycle tier,
                       the anomaly rung, counterexamples, tier stats,
                       the per-key checker, recorded runs, the counter's
                       interval tier, the set and queue analyses, the
                       perf and stats checkers
  service/             graftd: admission, frames, journal, scheduler,
                       streams, the daemon, HTTP front and client; the
                       cluster tier (result store, leases, handoff)
  interop.py           reading reference encodings, plans and graphs by
                       duck type

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
