"""Checker layer of the port: the linearizable check over the dense and
mask-mode CUDA kernels, the host frontier oracle, and tier
attribution."""

from .base import Checker, compose, VALID, INVALID, UNKNOWN  # noqa: F401
from .wgl_cpu import check_encoded_cpu, CpuCheckResult  # noqa: F401
from .linearizable import (  # noqa: F401
    LinearizableChecker,
    check_encoded,
    check_histories,
)
