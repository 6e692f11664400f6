"""Device kernels of the port.

* `kernel_ir`  — eligibility caps, the macro row layout, the plain
  PyTorch step parts (latch, closure fixpoint, FORCE) the plain version
  of every dense kernel is built from, and the chunk-carry contract
  (`CarryLayout`, `chunk_scan`).
* `dense_scan` — grouping by kind and window (`dense_plans_grouped`),
  the CUDA kernel wrappers `dense_scan` (dense-domain scan) and
  `mask_scan` (mask-mode scan) and their plain versions
  `dense_scan_plain`, `mask_scan_plain`; their chunk forms
  (`make_dense_chunk_checker`: `dense_chunk`, `mask_chunk` and the
  plain `dense_chunk_plain`, `mask_chunk_plain`).
* `linear_scan` — the sort-frontier ladder: window buckets
  (`bucket_slots`), the CUDA kernel wrapper `sort_scan` and its plain
  version `sort_scan_plain`; the chunk form (`make_sort_chunk_checker`:
  `sort_chunk`, `sort_chunk_plain`).
* `segment_scan` — long histories cut at quiescent boundaries: the
  planner and host composition (`check_segmented_batch`), the CUDA
  kernel wrapper `segment_scan` (one CTA per segment or group of its
  seeds, at `segment_shape`) and its plain version `segment_scan_plain`.
* `cycle_closure` — batched boolean transitive closure for the cycle
  tier: the CUDA kernel wrapper `cycle_closure` (B7 monolithic, B8
  blocked) and its plain versions `cycle_closure_plain`,
  `cycle_closure_tiled_plain`.
* `election_safety` — election safety over batches of (term, leader)
  rows: the CUDA kernel wrapper `election_safety` (its plain version is
  `models.leader.check_election_safety_plain`).
* `verdict_counts` — B10's per-shard verdict counts (n_valid,
  n_unknown): made by the scans' counting option (`dense_scan`,
  `mask_scan`, `sort_scan` with ``counts=True``: the kernels' epilogue,
  csrc/verdict_counts.cuh), or of flags already in memory by the CUDA
  kernel wrapper `verdict_counts`; the plain version
  `verdict_counts_plain`.
* `_build`     — nvcc build of `csrc/*.cu` at first use, ctypes binding.
"""

from .dense_scan import (  # noqa: F401
    DensePlan,
    dense_plan,
    dense_plans_grouped,
)
