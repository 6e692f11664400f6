"""Command-line entry point of the port: re-check recorded runs.

    python -m jepsen_jgroups_raft_tpu_torch check PATH... [--workload W]
        [--algorithm A] [--device D]

The reference's `check` subcommand (`jepsen_jgroups_raft_tpu/cli.py`
`cmd_check`): PATH is a run dir (it holds history.jsonl) or a store root,
under which every run dir is found (the `latest` symlinks skipped). The
runs are re-verified as one batch per model family
(`checker/recorded.check_recorded`) and the summary is printed as JSON.
Exit status: 0 when every run is valid, 1 when one is not (or is
unknown), 2 when no run dir is found, 3 when the device asked for (by
default the card) is not there. ``--device`` takes the place of the
reference's ``--platform``: the card unless ``--device cpu`` is given;
without a card the command does not fall back to the CPU. The harness
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
