"""Batch parallelism for the checker: the port of the reference's
`jepsen_jgroups_raft_tpu/parallel/`.

Every history is an independent linearizability problem, so the batch
axis splits cleanly. On one H100 a process's share of a batch is one
launch of a scan kernel over all its rows, followed by B10's verdict
counts (`mesh`); across processes the rows are split into contiguous
shards, the verdicts exchanged through the process group's store and the
counts summed by ``all_reduce`` (`distributed`), with local clusters
started by `launch`.
"""

from .mesh import (  # noqa: F401
    check_batch_sharded,
    make_mesh,
    sharded_batch_checker,
)
