"""Command-line entry point of the port: re-check recorded runs, and
serve the checking service.

    python -m jepsen_jgroups_raft_tpu_torch check PATH... [--workload W]
        [--algorithm A] [--device D]
    python -m jepsen_jgroups_raft_tpu_torch serve-checker [--host H]
        [--port P] [--store DIR] [--queue N] [--batch-wait-ms MS]
        [--workers N] [--cluster-dir DIR] [--replica-id ID] [--device D]

The reference's `check` subcommand (`jepsen_jgroups_raft_tpu/cli.py`
`cmd_check`): PATH is a run dir (it holds history.jsonl) or a store root,
under which every run dir is found (the `latest` symlinks skipped). The
runs are re-verified as one batch per model family
(`checker/recorded.check_recorded`) and the summary is printed as JSON.
Exit status: 0 when every run is valid, 1 when one is not (or is
unknown), 2 when no run dir is found, 3 when the device asked for (by
default the card) is not there. ``--device`` takes the place of the
reference's ``--platform``: the card unless ``--device cpu`` is given;
without a card the command does not fall back to the CPU.

``serve-checker`` is the reference's (`cmd_serve_checker`): graftd
(`service/`) in the foreground, on the card unless ``--device cpu``;
it exits 3 when the device asked for is not there. With
``--cluster-dir`` it runs as one replica (``--replica-id``) of the
cluster sharing that directory: the shared result store, leases, load
shedding and the WAL handoff (`service/cluster.py`). The harness
subcommands (test, serve, search) are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .checker.linearizable import ALGORITHMS

#: the reference's workload names (its `workload.WORKLOADS`), the choices
#: of ``--workload``; `checker/recorded.WORKLOAD_MODELS` says which of
#: them a stored run can be re-checked as
WORKLOADS = ("single-register", "multi-register", "counter", "election",
             "set", "queue", "list-append")


def find_run_dirs(paths) -> list:
    """Run dirs named by `paths`: each path that holds history.jsonl, and
    every run dir beneath the others (sorted, `latest` skipped)."""
    run_dirs = []
    for p in paths:
        p = Path(p)
        if (p / "history.jsonl").exists():
            run_dirs.append(p)
        else:
            run_dirs.extend(sorted(
                d.parent for d in p.glob("**/history.jsonl")
                if not d.parent.name == "latest"))
    return run_dirs


def cmd_check(args) -> int:
    """Re-verify recorded runs: store → load → per-key split → one batch
    on the device (BASELINE config #3's shape)."""
    from .platform import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"check: {e}", file=sys.stderr)
        return 3
    run_dirs = find_run_dirs(args.paths)
    if not run_dirs:
        print("no run dirs (history.jsonl) found", file=sys.stderr)
        return 2
    from .checker.recorded import check_recorded
    summary = check_recorded(run_dirs, workload=args.workload,
                             algorithm=args.algorithm, device=device)
    print(json.dumps(summary, indent=2, default=str))
    return 0 if summary["valid?"] is True else 1


def cmd_serve_checker(args) -> int:
    """graftd: the always-on multi-tenant checking daemon — queued
    admission, cross-request batching over the chunked scan on the
    card, the host-ladder degrade arm. Trace records land under
    ``--store``."""
    from .platform import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"serve-checker: {e}", file=sys.stderr)
        return 3
    from .service.http import serve_checker
    return serve_checker(store_root=args.store, host=args.host,
                         port=args.port, queue_capacity=args.queue,
                         batch_wait=(args.batch_wait_ms / 1000.0
                                     if args.batch_wait_ms is not None
                                     else None),
                         n_workers=args.workers,
                         cluster_dir=args.cluster_dir,
                         replica_id=args.replica_id, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="jepsen_jgroups_raft_tpu_torch",
        description="PyTorch/CUDA port of the history checker")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check",
                       help="re-verify recorded runs as one device batch")
    c.add_argument("paths", nargs="+",
                   help="run dirs or store roots to load")
    c.add_argument("--workload", default=None, choices=sorted(WORKLOADS),
                   help="override the workload recorded in test.json")
    c.add_argument("--algorithm", default="auto", choices=list(ALGORITHMS))
    c.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions on the host)")
    c.set_defaults(fn=cmd_check)
    sc = sub.add_parser("serve-checker",
                        help="graftd: always-on multi-tenant checking "
                             "daemon (HTTP+JSON, cross-request batching)")
    sc.add_argument("--store", default="store",
                    help="trace-record and journal root")
    sc.add_argument("--host", default="0.0.0.0")
    sc.add_argument("--port", type=int, default=8091)
    sc.add_argument("--queue", type=int, default=None,
                    help="admission queue capacity "
                         "(default: JGRAFT_SERVICE_QUEUE or 64)")
    sc.add_argument("--batch-wait-ms", type=int, default=None,
                    help="batch-formation linger "
                         "(default: JGRAFT_SERVICE_BATCH_WAIT_MS or 50)")
    sc.add_argument("--workers", type=int, default=None,
                    help="worker shards on the device, each on a CUDA "
                         "stream of its own "
                         "(default: JGRAFT_SERVICE_WORKERS or 1)")
    sc.add_argument("--cluster-dir", default=None,
                    help="shared cluster directory: run as one replica "
                         "of a graftd cluster (result store, leases, "
                         "journal handoff; default: "
                         "JGRAFT_SERVICE_CLUSTER_DIR or single-replica)")
    sc.add_argument("--replica-id", default=None,
                    help="this replica's id in the cluster "
                         "(default: JGRAFT_SERVICE_REPLICA_ID or "
                         "<name>-<pid>)")
    sc.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions on the host)")
    sc.set_defaults(fn=cmd_serve_checker)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
