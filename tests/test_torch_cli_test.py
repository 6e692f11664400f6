"""The port's `test` and `serve` subcommands
(`python -m jepsen_jgroups_raft_tpu_torch test|serve`).

`test --deploy inmemory --device cpu` runs, verifies, stores a run dir
and exits 0; without a card and without ``--device`` it prints the error
and exits 3 before any cluster is built or node started; a check that
raises exits 1; an unknown workload and a reference-only algorithm are
refused; `--deploy ssh` builds the port's ssh tier with the reference's
arguments, after the device is resolved. `serve`'s index lists the runs with
their verdicts exactly as the reference's does, and its HTTP server
stays inside the store root (the reference's tests/test_cli.py
shape)."""

import json
import threading
import urllib.error
import urllib.request
from functools import partial
from http.server import ThreadingHTTPServer

import pytest
import torch

from jepsen_jgroups_raft_tpu.core import serve as ref_serve
from jepsen_jgroups_raft_tpu_torch import cli
from jepsen_jgroups_raft_tpu_torch.checker import independent
from jepsen_jgroups_raft_tpu_torch.core import serve
from jepsen_jgroups_raft_tpu_torch.deploy import local
from jepsen_jgroups_raft_tpu_torch.sut import inmemory

torch.set_num_threads(1)

FAST = ["--time-limit", "1", "--quiesce", "0.1", "--rate", "40",
        "--concurrency", "3", "--operation-timeout", "0.3",
        "--interval", "0.3", "--node", "n1", "--node", "n2", "--node", "n3"]


def test_inmemory_cpu_run_exits_0_and_stores_a_run(tmp_path, capsys):
    store = tmp_path / "store"
    rc = cli.main(["test", "--deploy", "inmemory", "--device", "cpu",
                   "--nemesis", "partition", "--seed", "5",
                   "--store", str(store), *FAST])
    out = capsys.readouterr().out
    assert rc == 0, out[-3000:]
    assert "Everything looks good!" in out and "VALID" in out
    runs = serve._run_dirs(store)
    assert len(runs) == 1
    res = json.loads((runs[0] / "results.json").read_text())
    assert res["valid?"] is True
    assert res["decided-tiers"]["decided-rows"]
    assert (runs[0] / "history.jsonl").stat().st_size > 0
    test = json.loads((runs[0] / "test.json").read_text())
    assert test["opts"]["workload"] == "single-register"


def test_without_a_card_exits_3_and_starts_no_node(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []

    def refuse(*a, **kw):
        built.append(a)
        raise AssertionError("a cluster was built")

    monkeypatch.setattr(local, "LocalCluster", refuse)
    monkeypatch.setattr(inmemory, "InMemoryCluster", refuse)
    for deploy in ("local", "inmemory"):
        rc = cli.main(["test", "--workload", "single-register",
                       "--nemesis", "partition", "--deploy", deploy,
                       "--concurrency", "10", "--rate", "10",
                       "--time-limit", "30", "--quiesce", "2"])
        assert rc == 3
        assert "no CUDA device" in capsys.readouterr().err
    assert built == []


def test_a_check_that_raises_fails_the_command(tmp_path, monkeypatch,
                                               capsys):
    def boom(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(independent, "check_keyed", boom)
    rc = cli.main(["test", "--deploy", "inmemory", "--device", "cpu",
                   "--store", str(tmp_path / "store"), *FAST])
    out = capsys.readouterr().out
    assert rc == 1
    assert "UNKNOWN" in out and "kernel launch failed" in out
    assert "Analysis invalid!" in out


def test_unknown_workload_and_reference_algorithms_are_refused(capsys):
    with pytest.raises(SystemExit):
        cli.main(["test", "--workload", "nope"])
    for algorithm in ("jax", "pallas"):
        with pytest.raises(SystemExit):
            cli.main(["test", "--algorithm", algorithm, "--device", "cpu"])
    capsys.readouterr()


class _Built(Exception):
    pass


def _recording_cluster(calls):
    def build(*args, **kw):
        calls.append((args, kw))
        raise _Built()

    return build


SSH_FLAGS = ["--deploy", "ssh", "--ssh-user", "admin",
             "--ssh-private-key", "/keys/id_ed25519", "--election-ms", "150",
             "--heartbeat-ms", "50", "--repl-timeout-ms", "3000",
             "--compact-every", "512", "--workload", "counter",
             "--node", "h1", "--node", "h2", "--node", "h3"]


def test_ssh_deploy_builds_the_ports_remote_cluster(monkeypatch):
    """`test --deploy ssh` builds the port's RemoteRaftCluster with the
    arguments the reference's CLI gives its own."""
    from jepsen_jgroups_raft_tpu import cli as ref_cli
    from jepsen_jgroups_raft_tpu.deploy import ssh as ref_ssh
    from jepsen_jgroups_raft_tpu_torch.deploy import ssh

    port_calls, ref_calls = [], []
    monkeypatch.setattr(ssh, "RemoteRaftCluster",
                        _recording_cluster(port_calls))
    monkeypatch.setattr(ref_ssh, "RemoteRaftCluster",
                        _recording_cluster(ref_calls))
    with pytest.raises(_Built):
        cli.main(["test", *SSH_FLAGS, "--device", "cpu"])
    with pytest.raises(_Built):
        ref_cli.main(["test", *SSH_FLAGS])
    assert port_calls == ref_calls
    assert port_calls == [((["h1", "h2", "h3"],), {
        "sm": "counter", "ssh_user": "admin",
        "ssh_key": "/keys/id_ed25519", "election_ms": 150,
        "heartbeat_ms": 50, "repl_timeout_ms": 3000,
        "compact_every": 512})]


def test_ssh_deploy_without_a_card_exits_3_and_builds_nothing(monkeypatch,
                                                              capsys):
    from jepsen_jgroups_raft_tpu_torch.deploy import ssh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    monkeypatch.setattr(ssh, "RemoteRaftCluster", _recording_cluster(calls))
    assert cli.main(["test", *SSH_FLAGS]) == 3
    assert "no CUDA device" in capsys.readouterr().err
    assert calls == []


def _store(tmp_path):
    run = tmp_path / "store" / "t" / "20260729T000000"
    run.mkdir(parents=True)
    (run / "results.json").write_text(json.dumps({"valid?": True}))
    (run / "history.jsonl").write_text("")
    bad = tmp_path / "store" / "t" / "20260729T000001"
    bad.mkdir(parents=True)
    (bad / "results.json").write_text(json.dumps({"valid?": False}))
    unknown = tmp_path / "store" / "u" / "20260729T000002"
    unknown.mkdir(parents=True)
    (unknown / "results.json").write_text(json.dumps({"valid?": "unknown"}))
    (tmp_path / "store" / "t" / "latest").symlink_to("20260729T000001")
    return tmp_path / "store"


def test_serve_index_lists_runs_as_the_reference(tmp_path):
    root = _store(tmp_path)
    page = serve._index_html(root)
    assert "20260729T000000" in page and "valid" in page
    assert "INVALID" in page and "history.jsonl" in page
    assert "unknown" in page
    assert page == ref_serve._index_html(root)
    assert serve._run_dirs(root) == ref_serve._run_dirs(root)


def test_serve_http_end_to_end(tmp_path):
    root = _store(tmp_path)
    (tmp_path / "secret.txt").write_text("outside the store root")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), partial(
        serve._Handler, store_root=root.resolve()))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        index = urllib.request.urlopen(f"{base}/", timeout=5).read().decode()
        assert "t/20260729T000000" in index and "INVALID" in index
        body = urllib.request.urlopen(
            f"{base}/t/20260729T000000/results.json", timeout=5).read()
        assert json.loads(body) == {"valid?": True}
        for evil in ("/../secret.txt", "/%2e%2e/secret.txt"):
            try:
                body = urllib.request.urlopen(f"{base}{evil}",
                                              timeout=5).read()
                assert b"outside the store root" not in body
            except urllib.error.HTTPError:
                pass
    finally:
        httpd.shutdown()
        httpd.server_close()
