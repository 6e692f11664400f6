"""The port's interpreter (`core/runner.py`) against the reference's.

The reference's tests/test_runner.py cases run on both runners (process
retirement after an info op, monotonic times, a worker that survives a
non-client exception, a half-open client closed when its setup fails);
a one-worker run of the same flaky client records histories equal in
index, process, type, f, value and error; and a stored run crosses
between the packages both ways: a run dir the port's `run_test` wrote
loads with the reference's `load_history` into an equal history and
re-checks in the reference, and a reference run dir loads and re-checks
in the port."""

import json
import threading

import pytest
import torch

import jepsen_jgroups_raft_tpu.checker.recorded as ref_recorded
import jepsen_jgroups_raft_tpu.client.base as ref_client
import jepsen_jgroups_raft_tpu.client.errors as ref_errors
import jepsen_jgroups_raft_tpu.core.compose as ref_compose
import jepsen_jgroups_raft_tpu.core.db as ref_db
import jepsen_jgroups_raft_tpu.core.runner as ref_runner
import jepsen_jgroups_raft_tpu.core.store as ref_store
import jepsen_jgroups_raft_tpu.generator.base as ref_gb
import jepsen_jgroups_raft_tpu.sut.inmemory as ref_sut
import jepsen_jgroups_raft_tpu_torch.checker.recorded as recorded
import jepsen_jgroups_raft_tpu_torch.client.base as client
import jepsen_jgroups_raft_tpu_torch.client.errors as errors
import jepsen_jgroups_raft_tpu_torch.core.compose as compose
import jepsen_jgroups_raft_tpu_torch.core.db as db
import jepsen_jgroups_raft_tpu_torch.core.runner as runner
import jepsen_jgroups_raft_tpu_torch.core.store as store
import jepsen_jgroups_raft_tpu_torch.generator.base as gb
import jepsen_jgroups_raft_tpu_torch.sut.inmemory as sut

torch.set_num_threads(1)

#: one package's runner, client base, errors and generators
PORT = {"run_test": runner.run_test, "Client": client.Client,
        "errors": errors, "gb": gb}
REF = {"run_test": ref_runner.run_test, "Client": ref_client.Client,
       "errors": ref_errors, "gb": ref_gb}
PACKAGES = {"port": PORT, "reference": REF}


def flaky_client(pkg, fail_at=3):
    class FlakyClient(pkg["Client"]):
        """Times out on the `fail_at`-th invoke overall."""

        def __init__(self):
            self.count = 0
            self.lock = threading.Lock()

        def open(self, test, node):
            return self  # shared on purpose: we count globally

        def invoke(self, test, op):
            with self.lock:
                self.count += 1
                c = self.count
            if c == fail_at:
                raise pkg["errors"].ClientTimeout("injected")
            return op.replace(type="ok")

    return FlakyClient()


def buggy_client(pkg):
    class BuggyClient(pkg["Client"]):
        def __init__(self):
            self.count = 0
            self.lock = threading.Lock()

        def open(self, test, node):
            return self

        def invoke(self, test, op):
            with self.lock:
                self.count += 1
                c = self.count
            if c == 2:
                raise ValueError("workload bug")
            return op.replace(type="ok")

    return BuggyClient()


def setup_fails_client(pkg):
    class SetupFailsClient(pkg["Client"]):
        def __init__(self):
            self.lock = threading.Lock()
            self.opened = []
            self.closed = []
            self.fail_setups = 1

        def open(self, test, node):
            conn = SetupFailsClient.__new__(SetupFailsClient)
            conn.parent = self
            with self.lock:
                self.opened.append(conn)
            return conn

        def setup(self, test):
            parent = self.parent
            with parent.lock:
                if parent.fail_setups > 0:
                    parent.fail_setups -= 1
                    raise RuntimeError("injected setup failure")

        def invoke(self, test, op):
            return op.replace(type="ok")

        def close(self, test):
            with self.parent.lock:
                self.parent.closed.append(self)

    return SetupFailsClient()


def _writes(pkg, n):
    g = pkg["gb"]
    return g.Clients(g.Limit(n, g.Repeat({"f": "write", "value": 1})))


@pytest.mark.parametrize("which", sorted(PACKAGES))
def test_process_retires_after_info(which, tmp_path):
    pkg = PACKAGES[which]
    test = pkg["run_test"]({
        "name": "retire", "nodes": ["n1"], "concurrency": 1,
        "client": flaky_client(pkg), "generator": _writes(pkg, 6),
        "idempotent": set(), "store_root": str(tmp_path / "store")})
    h = test["history"]
    assert len([op for op in h if op.type == "info"]) == 1
    assert [op.process for op in h if op.type == "invoke"] == \
        [0, 0, 0, 1, 1, 1]
    assert [op.index for op in h] == list(range(len(h)))
    pending = set()
    for op in h:
        if op.type == "invoke":
            assert op.process not in pending
            pending.add(op.process)
        else:
            assert op.process in pending
            pending.remove(op.process)
    assert not pending


@pytest.mark.parametrize("which", sorted(PACKAGES))
def test_generator_time_monotonic(which):
    pkg = PACKAGES[which]
    test = pkg["run_test"]({
        "name": "mono", "nodes": ["n1"], "concurrency": 3,
        "client": flaky_client(pkg), "generator": _writes(pkg, 20),
        "store": False})
    times = [op.time for op in test["history"]]
    assert times == sorted(times) and all(t >= 0 for t in times)


@pytest.mark.parametrize("which", sorted(PACKAGES))
def test_worker_survives_non_client_exception(which):
    pkg = PACKAGES[which]
    test = pkg["run_test"]({
        "name": "buggy", "nodes": ["n1"], "concurrency": 1,
        "client": buggy_client(pkg), "generator": _writes(pkg, 5),
        "store": False})
    h = test["history"]
    infos = [op for op in h if op.type == "info"]
    assert len(infos) == 1 and "ValueError" in infos[0].error
    assert len([op for op in h if op.type == "ok"]) == 4


@pytest.mark.parametrize("which", sorted(PACKAGES))
def test_half_open_client_closed_when_setup_fails(which):
    pkg = PACKAGES[which]
    proto = setup_fails_client(pkg)
    test = pkg["run_test"]({
        "name": "half-open", "nodes": ["n1"], "concurrency": 1,
        "client": proto, "generator": _writes(pkg, 3), "store": False})
    assert proto.fail_setups == 0
    assert set(map(id, proto.closed)) == set(map(id, proto.opened))
    assert [op.type for op in test["history"]
            if op.type in ("ok", "fail")].count("ok") >= 2


def _rows(h):
    return [(op.index, op.process, op.type, op.f, op.value, op.error)
            for op in h]


@pytest.mark.parametrize("fail_at", [1, 3, 5])
def test_one_worker_histories_equal_the_reference(fail_at):
    """One worker: the interleaving is fixed, so the two runners record
    the same history up to the times."""
    def run(pkg):
        g = pkg["gb"]
        gen = g.Clients(g.Limit(8, g.Mix(
            [{"f": "write", "value": v} for v in range(4)]
            + [lambda t, c: {"f": "read", "value": None}] * 4, seed=fail_at)))
        return pkg["run_test"]({
            "name": "one", "nodes": ["n1"], "concurrency": 1,
            "client": flaky_client(pkg, fail_at), "generator": gen,
            "idempotent": {"read"}, "store": False})["history"]

    mine, ref = run(PORT), run(REF)
    assert _rows(mine) == _rows(ref)
    assert len(mine) == 16


RUN_OPTS = {"workload": "single-register", "nemesis": "partition",
            "nodes": ["n1", "n2", "n3"], "rate": 60.0, "interval": 0.3,
            "time_limit": 1.0, "quiesce": 0.1, "concurrency": 3,
            "operation_timeout": 0.3, "render_plots": False}


def _port_run(root, seed):
    c = sut.InMemoryCluster(RUN_OPTS["nodes"], sut.LatencyPlan(seed=seed))
    try:
        test = compose.compose_test(
            {**RUN_OPTS, "conn_factory": c.conn, "store_root": str(root),
             "device": "cpu"}, db=db.InMemoryDB(c), net=db.InMemoryNet(c),
            seed=seed)
        return runner.run_test(test)
    finally:
        c.shutdown()


def _ref_run(root, seed):
    c = ref_sut.InMemoryCluster(RUN_OPTS["nodes"],
                                ref_sut.LatencyPlan(seed=seed))
    try:
        test = ref_compose.compose_test(
            {**RUN_OPTS, "conn_factory": c.conn, "store_root": str(root)},
            db=ref_db.InMemoryDB(c), net=ref_db.InMemoryNet(c), seed=seed)
        return ref_runner.run_test(test)
    finally:
        c.shutdown()


def _dicts(h):
    return [op.to_dict() for op in h]


def _verdicts(summary):
    return {k: v for k, v in summary.items()
            if k not in ("time-s", "histories-per-sec", "run-verdicts")}


def test_port_run_dir_loads_and_rechecks_in_the_reference(tmp_path):
    test = _port_run(tmp_path / "store", 31)
    d = test["store_dir"]
    assert test["results"]["valid?"] is True
    assert _dicts(ref_store.load_history(d)) == _dicts(store.load_history(d))
    # in memory a value nests tuples; the store writes them as lists
    assert json.loads(json.dumps(_dicts(store.load_history(d)))) == \
        json.loads(json.dumps(_dicts(test["history"])))
    saved = json.loads((tmp_path / "store" / test["name"] / "latest" /
                        "results.json").read_text())
    assert saved["valid?"] is True and "decided-tiers" in saved
    ref = ref_recorded.check_recorded([d])
    mine = recorded.check_recorded([d], device="cpu")
    assert ref["valid?"] is True
    assert _verdicts(mine) == _verdicts(ref)


def test_reference_run_dir_loads_and_rechecks_in_the_port(tmp_path):
    test = _ref_run(tmp_path / "store", 32)
    d = test["store_dir"]
    assert test["results"]["valid?"] is True
    assert _dicts(store.load_history(d)) == _dicts(ref_store.load_history(d))
    mine = recorded.check_recorded([d], device="cpu")
    assert mine["valid?"] is True
    assert _verdicts(mine) == _verdicts(ref_recorded.check_recorded([d]))
