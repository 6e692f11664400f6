"""Checker layer of the port: the linearizable check over the CUDA
kernels, in the reference's order — the lin fast path (host witness
certifier, `certify_batch` / `consistency`, gated by `autotune`), the
segmented, dense, mask and sort kernels (their wavefront launches under
`autotune`'s measured plans), and the host tiers (`dfs_cpu`, the
frontier oracle `wgl_cpu`) —; the weaker rungs (`consistency`) with the
exact cycle tier (`cycle`); the transactional anomaly rung (`anomaly`);
counterexamples (`counterexample`, `timeline`), the brute-force oracle
of the tests (`brute`), and tier attribution (`schedule`); the
streaming carry (`schedule.CarriedScan`,
`consistency.StreamingCertifier`); the per-key independent checker
(`independent`), the re-check of recorded runs (`recorded`), the
counter's interval tier (`counter_bounds`), the set and queue
analyses (`set_queue`), and the run-level perf and stats checkers
(`perf`, `stats`)."""

from .base import Checker, compose, VALID, INVALID, UNKNOWN  # noqa: F401
from .wgl_cpu import check_encoded_cpu, CpuCheckResult  # noqa: F401
from .linearizable import (  # noqa: F401
    LinearizableChecker,
    check_encoded,
    check_histories,
)
from .independent import (  # noqa: F401
    IndependentChecker,
    IndependentLinearizable,
    split_by_key,
)
from .stats import StatsChecker, UnhandledExceptionsChecker  # noqa: F401
from .perf import PerfChecker  # noqa: F401
