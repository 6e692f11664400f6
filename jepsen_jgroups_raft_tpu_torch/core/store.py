"""Result persistence.

Equivalent of jepsen's store/ layer (SURVEY.md §2.3 "History & store"):
every run writes an immutable directory
``store/<test-name>/<timestamp>/`` containing the full history
(history.jsonl), the checker results (results.json), and the serializable
test parameters (test.json); ``store/<name>/latest`` symlinks the newest
run. A copy of the reference's `core/store.py`, byte for byte in what it
writes and reads, so a store written by either package loads in the
other; the port re-checks stored runs (`checker/recorded.py`, the
`check` subcommand of `python -m jepsen_jgroups_raft_tpu_torch`).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Union

from ..history.ops import History, Op

DEFAULT_ROOT = "store"


def store_root(test: dict) -> Path:
    return Path(test.get("store_root", DEFAULT_ROOT))


def _jsonable(x):
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, set):
        return sorted(_jsonable(v) for v in x)
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    return repr(x)


def prepare_dir(test: dict) -> str:
    """Create the run directory up front (before checkers run) so
    artifact-producing checkers (timeline HTML, perf SVG) have somewhere
    to write."""
    ts = time.strftime("%Y%m%dT%H%M%S", time.localtime(test.get("start_time",
                                                                time.time())))
    d = store_root(test) / str(test.get("name", "test")) / ts
    n = 0
    while d.exists():  # same-second reruns
        n += 1
        d = d.with_name(f"{ts}-{n}")
    d.mkdir(parents=True)
    return str(d)


def save_test(test: dict, history: History, results: dict) -> str:
    d = Path(test.get("store_dir") or prepare_dir(test))

    with open(d / "history.jsonl", "w") as f:
        for op in history:
            f.write(json.dumps(_jsonable(op.to_dict())) + "\n")
    with open(d / "results.json", "w") as f:
        json.dump(_jsonable(results), f, indent=2)
    skip = {"history", "results", "client", "nemesis", "generator", "checker",
            "db", "store_dir"}
    with open(d / "test.json", "w") as f:
        json.dump({k: _jsonable(v) for k, v in test.items() if k not in skip},
                  f, indent=2)

    latest = d.parent / "latest"
    try:
        if latest.is_symlink() or latest.exists():
            latest.unlink()
        latest.symlink_to(d.name)
    except OSError:
        pass  # symlinks unavailable (exotic fs) — nonfatal
    return str(d)


def load_history(run_dir: Union[str, Path]) -> History:
    h = History()
    with open(Path(run_dir) / "history.jsonl") as f:
        for line in f:
            d = json.loads(line)
            if isinstance(d.get("value"), list):
                d["value"] = tuple(d["value"])
            h.append(Op.from_dict(d))
    return h
