"""Check one seeded batch on every rank of a cluster: the drive of the
distributed path.

Run once per rank with torchrun's environment (or through
`launch.launch_local_cluster`, which sets it):

    python -m jepsen_jgroups_raft_tpu_torch.parallel.selfcheck \\
        --histories 16 --ops 30 --device cpu

Every rank builds the same batch (`seeded_batch`: register histories,
every `--corrupt-every`-th with one read raised out of its domain, then
`--wide` histories of 16 processes whose windows pass the dense caps),
checks it through `checker.linearizable.check_histories` — inside the
cluster the seam shards it (`distributed.run_sharded`) — once per
``JGRAFT_MACRO_EVENTS`` value of `--macro` and per `--algorithms`
entry, checks its first three rows through `check_histories`, its first
row through `run_sharded` (across two ranks, rank 0's shard is then
empty), and with `--global` counts the register rows and a counter batch of the
same shape with `distributed.check_batch_global`. With `--result-store
DIR` it checks the batch once more (the first `--macro` value and
`--algorithms` entry) with ``JGRAFT_RESULT_STORE=DIR``, a directory every
rank shares, so the other ranks' rows come back as their owners' full
results (the detail exchange of `run_sharded`). The last line is
``SELFCHECK {json}``: the verdicts, the kernel tags of the rank's rows
and the counts, the rank's `placement_granularity` and the cluster's
`global_mesh`, and under ``store`` the store arm's verdicts, kernel
tags, rows read from the store and whole result list. Exit 0 iff the
process group came up and every check
returned; the process group is torn down (a barrier, then
`destroy_process_group`) before `main` returns.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

from ..checker.linearizable import check_histories, check_encoded
from ..history.packing import encode_history
from ..history.synth import random_valid_history
from ..models import Counter, CasRegister
from . import distributed


def corrupt_read(ops, rng: random.Random, bump: int):
    """Raise one ok read's value by `bump`; returns (ops, changed)."""
    ops = list(ops)
    reads = [j for j, op in enumerate(ops)
             if op.type == "ok" and op.f == "read" and op.value is not None]
    if not reads:
        return ops, False
    j = rng.choice(reads)
    ops[j] = ops[j].replace(value=ops[j].value + bump)
    return ops, True


def seeded_batch(seed: int, n_histories: int, n_ops: int, n_procs: int = 5,
                 n_wide: int = 0, corrupt_every: int = 3,
                 kind: str = "register") -> list:
    """The batch every rank builds alike: `n_histories` histories of
    `n_ops` ops over `n_procs` processes (crash_p 0.05, at most 3
    crashes), every `corrupt_every`-th register history (0: none) with
    one read raised by 4 (out of the value domain: INVALID), then
    `n_wide` register histories of 16 processes and up to 10 crashes."""
    rng = random.Random(seed)
    hs = []
    for i in range(n_histories):
        h = random_valid_history(rng, kind, n_ops=n_ops, n_procs=n_procs,
                                 crash_p=0.05, max_crashes=3)
        if kind == "register" and corrupt_every and i % corrupt_every == 0:
            h, _ = corrupt_read(h, rng, 4)
        hs.append(h)
    for _ in range(n_wide):
        hs.append(random_valid_history(rng, "register", n_ops=n_ops,
                                       n_procs=16, max_crashes=10))
    return hs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="selfcheck")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--histories", type=int, default=12)
    ap.add_argument("--ops", type=int, default=30)
    ap.add_argument("--procs", type=int, default=5)
    ap.add_argument("--wide", type=int, default=4)
    ap.add_argument("--corrupt-every", type=int, default=3)
    ap.add_argument("--macro", default="1,0")
    ap.add_argument("--algorithms", default="dense,auto")
    ap.add_argument("--global", dest="global_", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--result-store", default=None,
                    help="a directory every rank shares: check the batch "
                         "once more with JGRAFT_RESULT_STORE set to it")
    args = ap.parse_args(argv)
    if not distributed.maybe_init_distributed(device=args.device):
        print("selfcheck: no cluster (torchrun's environment is absent "
              "or wrong)", file=sys.stderr)
        return 2
    try:
        out = _run(args)
    finally:
        distributed.shutdown_distributed()
    print("SELFCHECK " + json.dumps(out), flush=True)
    return 0


def _run(args) -> dict:
    """Every check of `main` on this rank; the result line's object."""
    dev = distributed.rank_device()
    model = CasRegister()
    hs = seeded_batch(args.seed, args.histories, args.ops, args.procs,
                      args.wide, args.corrupt_every)
    out = {"rank": distributed.process_index(),
           "world": distributed.process_count(), "device": str(dev),
           "granularity": distributed.placement_granularity(),
           "global_mesh": [[r, str(d)] for r, d in distributed.global_mesh()],
           "checks": {}}
    t0 = time.perf_counter()
    for macro in args.macro.split(","):
        os.environ["JGRAFT_MACRO_EVENTS"] = macro
        for alg in args.algorithms.split(","):
            rs = check_histories(hs, model, algorithm=alg, device=dev)
            out["checks"][f"macro={macro},{alg}"] = {
                "verdicts": [r["valid?"] for r in rs],
                "kernels": [r.get("kernel", r.get("algorithm"))
                            for r in rs]}
    out["tiny"] = [r["valid?"] for r in
                   check_histories(hs[:3], model, algorithm="dense",
                                   device=dev)]
    encs = [encode_history(hs[0], model)]
    out["empty_shard"] = [r["valid?"] for r in distributed.run_sharded(
        encs, lambda sub: check_encoded(sub, model, "dense", dev,
                                        distribute=False))]
    if args.global_:
        reg = [encode_history(h, model) for h in hs[:args.histories]]
        counter = [encode_history(h, Counter()) for h in seeded_batch(
            args.seed + 1, args.histories, args.ops, args.procs,
            kind="counter")]
        out["global"] = {
            "register": distributed.check_batch_global(model, reg),
            "counter": distributed.check_batch_global(Counter(), counter)}
    if args.result_store:
        from ..core.store import _jsonable

        os.environ["JGRAFT_MACRO_EVENTS"] = args.macro.split(",")[0]
        os.environ["JGRAFT_RESULT_STORE"] = args.result_store
        try:
            rs = check_histories(hs, model,
                                 algorithm=args.algorithms.split(",")[0],
                                 device=dev)
        finally:
            del os.environ["JGRAFT_RESULT_STORE"]
        out["store"] = {
            "verdicts": [r["valid?"] for r in rs],
            "kernels": [r.get("kernel", r.get("algorithm")) for r in rs],
            "store_rows": sum(r.get("detail-source") == "result-store"
                              for r in rs),
            "results": _jsonable(rs)}
    out["seconds"] = time.perf_counter() - t0
    return out


if __name__ == "__main__":
    sys.exit(main())
