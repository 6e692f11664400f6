"""PyTorch/CUDA port of the history checker, for an NVIDIA H100.

A second package beside `jepsen_jgroups_raft_tpu` (the JAX reference,
which it never imports). The port carries the north-star check: CAS
register histories are encoded and macro-packed on the host, grouped by
concurrency window, and verified by a hand-written CUDA dense-domain
scan kernel (`ops/csrc/dense_scan.cu`), one thread block per history.

Layout (mirrors the reference's module paths):
  platform.py          env knobs, `resolve_device`, `toolchain_stamp`
  history/             op records, encoding, macro packing, synthesis
  models/              the model protocol and the CAS register
  ops/kernel_ir.py     caps, macro row layout, plain-torch step parts
  ops/dense_scan.py    window grouping, `dense_scan` (kernel wrapper)
                       and `dense_scan_plain` (its plain version)
  ops/csrc/            CUDA sources, built by ops/_build.py at first use
  checker/             `check_histories`, the host oracle, tier stats
  interop.py           reading reference encodings and plans by duck type

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
