"""Command-line entry point of the port: run tests, browse results,
re-check recorded runs, and serve the checking service.

    python -m jepsen_jgroups_raft_tpu_torch test [flags]
    python -m jepsen_jgroups_raft_tpu_torch serve [--store DIR] [--host H]
        [--port P]
    python -m jepsen_jgroups_raft_tpu_torch check PATH... [--workload W]
        [--algorithm A] [--device D]
    python -m jepsen_jgroups_raft_tpu_torch serve-checker [--host H]
        [--port P] [--store DIR] [--queue N] [--batch-wait-ms MS]
        [--workers N] [--cluster-dir DIR] [--replica-id ID] [--device D]
    python -m jepsen_jgroups_raft_tpu_torch search [--families F,...]
        [--population N] [--generations N] [--survivors N]
        [--edit-space N] [--seed S] [--corpus-dir DIR] [--arm A]
        [--consistency C] [--n-ops N] [--recall K] [--service-url URL]
        [--device D]

``test`` is the reference's (`jepsen_jgroups_raft_tpu/cli.py`
`cmd_test`, the reference's single-test-cmd, raft.clj:94-101): it
deploys a cluster, drives the workload's clients under the nemesis,
records the history, checks it and stores the run; its flags are the
reference's (raft.clj:14-51 plus jepsen's built-ins), its exit status 0
iff every run's verdict is VALID (an unknown verdict, a checker that
raised among them, fails the command). Three flags differ:
``--device`` takes the place of ``--platform`` and is resolved before
any cluster is built (the card unless ``--device cpu`` is given; without
a card the command prints the error and exits 3, and no node starts);
``--algorithm`` takes the port's engines (`checker.linearizable.
ALGORITHMS`); ``--seed`` (new) seeds the workload's op draws, the
stagger, the nemesis schedule and the in-memory SUT's latencies.
``--deploy`` runs the reference's three tiers: ``local`` (the native
cluster as local processes, the default), ``inmemory`` (the in-process
SUT) and ``ssh`` (remote hosts over ssh/scp with iptables partitions,
`deploy/ssh.py`; ``--ssh-user``, ``--ssh-private-key``). ``serve`` is
the reference's results browser.

``check`` is the reference's `cmd_check`: PATH is a run dir (it holds
history.jsonl) or a store root, under which every run dir is found (the
`latest` symlinks skipped). The runs are re-verified as one batch per
model family (`checker/recorded.check_recorded`) and the summary is
printed as JSON. Exit status: 0 when every run is valid, 1 when one is
not (or is unknown), 2 when no run dir is found, 3 when the device asked
for (by default the card) is not there. ``--device`` takes the place of
the reference's ``--platform``: the card unless ``--device cpu`` is
given; without a card the command does not fall back to the CPU.

``serve-checker`` is the reference's (`cmd_serve_checker`): graftd
(`service/`) in the foreground, on the card unless ``--device cpu``;
it exits 3 when the device asked for is not there. With
``--cluster-dir`` it runs as one replica (``--replica-id``) of the
cluster sharing that directory: the shared result store, leases, load
shedding and the WAL handoff (`service/cluster.py`).

``search`` is the reference's (`cmd_search`): graftsearch, the
coverage-guided scenario search (`search/`) over the checking service,
the same flags and ``JGRAFT_SEARCH_*`` knobs; ``--recall K`` plants K
violations and reports recall per CPU-minute instead. The report is
printed as JSON and the exit status is 0; a check request that fails
raises. ``--device`` takes the place of ``--platform`` and is resolved
first: the in-process service runs on the card unless ``--device cpu``
is given, and without a card the command exits 3 with nothing run.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from pathlib import Path

from .checker.linearizable import ALGORITHMS
from .core.compose import DEFAULTS
from .nemesis.package import FAULTS, SCHEDULES, SPECIALS
from .workload import WORKLOADS

# workload → native state machine (identify-state-machine, server.clj:103-109)
# The scenario tier's set/queue live in one register of the replicated
# map (CAS retry loops — workload/set.py, workload/queue.py), so they
# ride the "map" SM on every deployment tier.
WORKLOAD_SM = {
    "single-register": "map",
    "multi-register": "map",
    "counter": "counter",
    "election": "election",
    "set": "map",
    "queue": "map",
}

#: the deployment tiers (the reference's three)
DEPLOYS = ("local", "inmemory", "ssh")


def _add_test_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--workload", "-w", default=DEFAULTS["workload"],
                   choices=sorted(WORKLOADS),
                   help="workload name (raft.clj:29-33)")
    p.add_argument("--nemesis", default=None,
                   help="comma-separated faults %s, workload-paired "
                        "schedules %s, or special %s "
                        "(raft.clj:35-39, nemesis.clj:8-29); set/queue "
                        "default to their paired schedule when omitted"
                        % (sorted(FAULTS), sorted(SCHEDULES),
                           sorted(SPECIALS)))
    p.add_argument("--rate", type=float, default=DEFAULTS["rate"],
                   help="approximate ops/sec (raft.clj:19-22)")
    p.add_argument("--ops-per-key", type=int, default=DEFAULTS["ops_per_key"],
                   help="op cap per key (raft.clj:24-27)")
    p.add_argument("--interval", type=float, default=DEFAULTS["interval"],
                   help="seconds between nemesis ops (raft.clj:41-44)")
    p.add_argument("--operation-timeout", type=float,
                   default=DEFAULTS["operation_timeout"],
                   help="client op timeout, seconds (raft.clj:48-51)")
    p.add_argument("--stale-reads", action="store_true",
                   help="allow dirty local reads (raft.clj:14-17; "
                        "quorum_reads = not stale_reads, raft.clj:92)")
    p.add_argument("--weak-election", action="store_true",
                   help="election workload: drop back to the reference-"
                        "parity single-client model (leader.clj:58-62) "
                        "instead of the default cross-node majority "
                        "checker")
    p.add_argument("--time-limit", type=float, default=DEFAULTS["time_limit"],
                   help="main-phase duration, seconds")
    p.add_argument("--quiesce", type=float, default=DEFAULTS["quiesce"],
                   help="post-phase quiet period, seconds (raft.clj:86-90's "
                        "sleep 10)")
    p.add_argument("--concurrency", type=int, default=DEFAULTS["concurrency"],
                   help="client worker count")
    p.add_argument("--test-count", type=int, default=1,
                   help="number of runs")
    p.add_argument("--node", action="append", default=None,
                   help="node name (repeatable)")
    p.add_argument("--nodes-file", default=None,
                   help="file with one node name per line")
    p.add_argument("--store", default="store",
                   help="results directory root")
    p.add_argument("--algorithm", default="auto", choices=list(ALGORITHMS),
                   help="linearizability engine (race = kernel vs DFS, "
                        "first finisher wins, the knossos.competition "
                        "analogue)")
    p.add_argument("--consistency", default="linearizable",
                   choices=["linearizable", "sequential", "session"],
                   help="consistency ladder rung for the workload's "
                        "frontier checker (checker/consistency.py): "
                        "weaker rungs drop real-time edges, keep "
                        "per-process order, and decide measurably "
                        "cheaper")
    p.add_argument("--device", default=None,
                   help="torch device of the post-run check (default: the "
                        "CUDA card; 'cpu' runs the kernels' plain versions "
                        "on the host)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the workload's ops, the stagger, the "
                        "nemesis schedule and the in-memory SUT "
                        "(default: unseeded)")
    p.add_argument("--deploy", default="local", choices=list(DEPLOYS),
                   help="SUT deployment tier: local native processes, "
                        "in-process fake, or ssh remote hosts")
    p.add_argument("--ssh-user", default="root",
                   help="the ssh tier's remote user")
    p.add_argument("--ssh-private-key", default=None,
                   help="identity file for the ssh tier (running.md:88)")
    p.add_argument("--election-ms", type=int, default=300)
    p.add_argument("--heartbeat-ms", type=int, default=100)
    p.add_argument("--repl-timeout-ms", type=int, default=30000,
                   help="server-side replication timeout "
                        "(server/src/jgroups/raft/server.clj:37)")
    p.add_argument("--compact-every", type=int, default=0,
                   help="server snapshots + compacts its log after this "
                        "many applied entries (0 = off); lagging/new "
                        "members catch up via InstallSnapshot")


def _nodes_from(args) -> list:
    if args.node:
        return list(args.node)
    if args.nodes_file:
        lines = Path(args.nodes_file).read_text().splitlines()
        return [ln.strip() for ln in lines if ln.strip()]
    return [f"n{i}" for i in range(1, 6)]


def _build_deployment(args, nodes):
    """Returns (db, net, conn_factory, shutdown_fn)."""
    if args.deploy == "inmemory":
        from .core.db import InMemoryDB, InMemoryNet
        from .sut.inmemory import InMemoryCluster, LatencyPlan
        cluster = InMemoryCluster(nodes, LatencyPlan(seed=args.seed))
        return (InMemoryDB(cluster), InMemoryNet(cluster), cluster.conn,
                cluster.shutdown)
    if args.deploy == "ssh":
        from .deploy.ssh import IptablesNet, RemoteRaftCluster, RemoteRaftDB
        cluster = RemoteRaftCluster(
            nodes, sm=WORKLOAD_SM[args.workload], ssh_user=args.ssh_user,
            ssh_key=args.ssh_private_key,
            election_ms=args.election_ms, heartbeat_ms=args.heartbeat_ms,
            repl_timeout_ms=args.repl_timeout_ms,
            compact_every=args.compact_every)
        return (RemoteRaftDB(cluster, seed=args.seed),
                IptablesNet(cluster), cluster.conn_factory(),
                cluster.shutdown)
    from .deploy.local import BlockNet, LocalCluster, LocalRaftDB
    cluster = LocalCluster(
        nodes, sm=WORKLOAD_SM[args.workload], election_ms=args.election_ms,
        heartbeat_ms=args.heartbeat_ms,
        repl_timeout_ms=args.repl_timeout_ms,
        compact_every=args.compact_every)
    return (LocalRaftDB(cluster, seed=args.seed), BlockNet(cluster),
            cluster.conn_factory(), cluster.shutdown)


def _terminate_as_exit(signum, frame):
    # SIGTERM unwinds like an exception, so the `finally` that kills the
    # cluster's node processes runs
    raise SystemExit(128 + signum)


def cmd_test(args) -> int:
    """Deploy, run, check and store `--test-count` runs; the reference's
    `cmd_test` with the device resolved first."""
    from .core.compose import compose_test
    from .core.runner import run_test
    from .platform import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"test: {e}", file=sys.stderr)
        return 3
    nodes = _nodes_from(args)
    main_thread = threading.current_thread() is threading.main_thread()
    old_term = (signal.signal(signal.SIGTERM, _terminate_as_exit)
                if main_thread else None)
    ok = True
    try:
        for i in range(args.test_count):
            db, net, conn_factory, shutdown = _build_deployment(args, nodes)
            try:
                opts = {
                    "nodes": nodes,
                    "workload": args.workload,
                    "nemesis": args.nemesis,
                    "rate": args.rate,
                    "ops_per_key": args.ops_per_key,
                    "interval": args.interval,
                    "operation_timeout": args.operation_timeout,
                    "stale_reads": args.stale_reads,
                    "time_limit": args.time_limit,
                    "quiesce": args.quiesce,
                    "concurrency": args.concurrency,
                    "conn_factory": conn_factory,
                    "store_root": args.store,
                    "algorithm": args.algorithm,
                    "consistency": args.consistency,
                    "device": device,
                    "seed": args.seed,
                }
                if args.workload == "election":
                    # Default-on majority model: wired whenever the
                    # deployment can snapshot every node's view (the
                    # local cluster can); --weak-election drops back to
                    # reference parity.
                    opts["weak_election"] = args.weak_election
                    probe = getattr(db, "cluster", None)
                    probe = getattr(probe, "views_probe", None)
                    if probe is not None:
                        opts["views_probe"] = probe
                test = compose_test(opts, db=db, net=net)
                test = run_test(test)
            finally:
                shutdown()
            res = test["results"]
            # Strict: "unknown" (checker budget exceeded / checker
            # crashed, a kernel's failure among them) is NOT a pass —
            # jepsen's CLI likewise fails the command on any non-true
            # analysis.
            verdict = res.get("valid?")
            valid = verdict is True
            ok = ok and valid
            label = {True: "VALID", False: "INVALID"}.get(
                verdict, f"UNKNOWN ({verdict})")
            print(f"run {i + 1}/{args.test_count}: {label}  "
                  f"store={test.get('store_dir')}")
            if not valid:
                print(json.dumps(res, indent=2, default=str)[:4000])
    finally:
        if main_thread:
            signal.signal(signal.SIGTERM, old_term)
    print("Everything looks good!" if ok else "Analysis invalid! (ノಥ益ಥ)ノ")
    return 0 if ok else 1


def cmd_serve(args) -> int:
    from .core.serve import serve
    return serve(args.store, host=args.host, port=args.port)


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


def cmd_search(args) -> int:
    """graftsearch: coverage-guided scenario search. Default mode runs
    the open-ended generation loop and prints the run report; --recall K
    plants K known violations first and reports found-vs-missed per
    CPU-minute. The device is resolved before anything runs."""
    from .platform import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"search: {e}", file=sys.stderr)
        return 3
    from .search.driver import SearchDriver, search_config_from_env
    from .search.recall import run_recall

    overrides = {}
    for flag, key in (("population", "population"),
                      ("generations", "generations"),
                      ("survivors", "survivors"),
                      ("edit_space", "edit_space"),
                      ("seed", "seed"),
                      ("corpus_dir", "corpus_dir")):
        v = getattr(args, flag)
        if v is not None:
            overrides[key] = v
    if args.arm is not None:
        overrides["guided"] = args.arm == "guided"
    overrides["families"] = tuple(
        f.strip() for f in args.families.split(",") if f.strip())
    overrides["consistency"] = args.consistency
    overrides["n_ops"] = args.n_ops
    overrides["device"] = device
    if args.service_url:
        overrides["service_url"] = args.service_url
    cfg = search_config_from_env(**overrides)
    if args.recall:
        rep = run_recall(cfg, k=args.recall).to_dict()
    else:
        rep = SearchDriver(cfg).run()
    print(json.dumps(rep, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="jepsen_jgroups_raft_tpu_torch",
        description="PyTorch/CUDA port of the Jepsen harness and its "
                    "history checker")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("test", help="run a test (single-test-cmd analogue)")
    _add_test_flags(t)
    t.set_defaults(fn=cmd_test)
    s = sub.add_parser("serve", help="results web server (serve-cmd)")
    s.add_argument("--store", default="store")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8080)
    s.set_defaults(fn=cmd_serve)
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
    se = sub.add_parser(
        "search",
        help="graftsearch: coverage-guided scenario search over graftd "
             "(mutation registry + verdict-signal fitness + minimized "
             "corpus under store/search/)")
    se.add_argument("--families",
                    default="register,set,queue,list-append",
                    help="comma-separated model families to search")
    se.add_argument("--population", type=int, default=None,
                    help="candidates per generation "
                         "(default: JGRAFT_SEARCH_POP or 48)")
    se.add_argument("--generations", type=int, default=None,
                    help="default: JGRAFT_SEARCH_GENERATIONS or 8")
    se.add_argument("--survivors", type=int, default=None,
                    help="survivor pool size "
                         "(default: JGRAFT_SEARCH_SURVIVORS or 12)")
    se.add_argument("--edit-space", type=int, default=None,
                    help="mutation edit-seed space "
                         "(default: JGRAFT_SEARCH_EDIT_SPACE or 24)")
    se.add_argument("--seed", type=int, default=None,
                    help="run seed (default: JGRAFT_SEARCH_SEED or 0); "
                         "same seed => identical corpus fingerprints")
    se.add_argument("--corpus-dir", default=None,
                    help="corpus root (default: JGRAFT_SEARCH_DIR or "
                         "store/search)")
    se.add_argument("--arm", choices=["guided", "random"], default=None,
                    help="override JGRAFT_SEARCH_GUIDED (random = the "
                         "blind-mutation ablation arm)")
    se.add_argument("--consistency", default="linearizable")
    se.add_argument("--n-ops", type=int, default=20,
                    help="base-history length per scenario")
    se.add_argument("--recall", type=int, default=None, metavar="K",
                    help="plant K known violations and report recall "
                         "per CPU-minute instead of open-ended search")
    se.add_argument("--service-url", default=None,
                    help="evaluate through a running graftd daemon "
                         "(binary frames for non-transactional "
                         "workloads); default: in-process service")
    se.add_argument("--device", default=None,
                    help="torch device of the in-process service "
                         "(default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    se.set_defaults(fn=cmd_search)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
