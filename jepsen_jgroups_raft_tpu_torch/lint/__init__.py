"""graftlint on the port: project-native static analysis of
``jepsen_jgroups_raft_tpu_torch`` (and ``native/src``).

The JAX package's fifteen analyzers, each with its own copy here (this
package imports neither ``jax``, ``torch`` nor the JAX package, and
never imports the code it reads):

* thirteen copied, their scopes on this package: :mod:`.taxonomy`,
  :mod:`.lock_discipline` (``native/src``), and the CFG/dataflow tier
  under :mod:`.flow` — ``heal``, ``resource``, ``guarded``,
  ``lockorder``, ``crashproto``, ``envknobs``, ``fingerprint``,
  ``degraded``, ``knobclass``, ``tierstamp``, ``lockstep``;
* two redesigned for PyTorch and the Hopper kernels:
  :mod:`.jit_hygiene` (analyzer ``sync``, rule ``host-sync``: host syncs
  of card tensors on the hot path, each a fix or a pragma with its
  reason) and :mod:`.flow.kernel_contract` (analyzer ``kernel``: the
  CUDA sources' caps against the Python constants, dynamic shared
  memory over the legal domain, launch bounds and block sizes).

CLI: ``python -m jepsen_jgroups_raft_tpu_torch.lint [paths]`` — with
``--format json`` (SARIF 2.1.0) and a regression baseline
(``--baseline`` / ``--update-baseline``); ``--list-rules`` names what
was redesigned. README.md, "graftlint on the port", documents it.
"""

from .base import Finding, SourceFile  # noqa: F401
from .cli import main, run  # noqa: F401
