"""The port's multi-process runtime (`parallel.distributed`, `parallel.
launch`) on the CPU: shard cuts equal to the reference's, the defensive
parse of torchrun's environment, the backend rule, the seam in
`check_encoded`, and a real two-process gloo cluster whose verdicts and
global counts must equal a single-process run of the port and the
reference's `check_histories` — and, with a shared result store, whose
whole result lists must equal a single-process run's.

Tolerance: exact — cuts, verdicts and counts compared for equality."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu.parallel import distributed as ref_dist
from jepsen_jgroups_raft_tpu_torch import platform as plat
from jepsen_jgroups_raft_tpu_torch.checker import autotune
from jepsen_jgroups_raft_tpu_torch.checker import linearizable as lin
from jepsen_jgroups_raft_tpu_torch.history import packing
from jepsen_jgroups_raft_tpu_torch.history.packing import (encode_history,
                                                           pack_macro_batch)
from jepsen_jgroups_raft_tpu_torch.models import CasRegister, Counter
from jepsen_jgroups_raft_tpu_torch.ops.dense_scan import dense_plan
from jepsen_jgroups_raft_tpu_torch.parallel import distributed, launch, mesh
from jepsen_jgroups_raft_tpu_torch.parallel.selfcheck import seeded_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def clean_degrade_note():
    """The malformed-env paths record a process-wide degrade note (first
    note wins); restore it for the tests that follow."""
    saved = plat._DEGRADED_NOTE
    plat._DEGRADED_NOTE = None
    yield
    plat._DEGRADED_NOTE = saved


@pytest.fixture
def no_cluster_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


# -------------------------------------------------------------- shard cuts


def test_shard_bounds_balanced():
    assert distributed.shard_bounds(8, 2, 0) == (0, 4)
    assert distributed.shard_bounds(8, 2, 1) == (4, 8)


def test_shard_bounds_uneven_cover_every_row():
    for n in (1, 2, 3, 5, 7):
        for rows in (0, 1, 5, 13, 100):
            cuts = [distributed.shard_bounds(rows, n, i) for i in range(n)]
            assert cuts[0][0] == 0 and cuts[-1][1] == rows
            for (a, b), (c, _) in zip(cuts, cuts[1:]):
                assert b == c and a <= b


def test_shard_bounds_fewer_rows_than_shards():
    cuts = [distributed.shard_bounds(2, 4, i) for i in range(4)]
    assert cuts[-1][1] == 2
    assert sum(hi - lo for lo, hi in cuts) == 2


def test_shard_bounds_equal_the_reference():
    for rows in (0, 1, 2, 3, 7, 16, 100, 1001):
        for n in (1, 2, 3, 4, 8):
            for i in range(n):
                assert distributed.shard_bounds(rows, n, i) == \
                    ref_dist.shard_bounds(rows, n, i, 1)


def test_shard_bounds_bad_index_and_defaults():
    with pytest.raises(ValueError, match="out of range"):
        distributed.shard_bounds(8, 2, 2)
    # the cuts are the history layer's: the packers and the runtime share
    # one function
    assert distributed.shard_bounds is packing.shard_bounds


def test_packing_imports_no_runtime():
    """The history layer's shard cuts import nothing of the parallel
    layer above it."""
    code = ("import sys\n"
            "from jepsen_jgroups_raft_tpu_torch.history import packing\n"
            "assert packing.shard_bounds(5, 2, 1) == (2, 5)\n"
            "bad = [m for m in sys.modules if m.startswith("
            "'jepsen_jgroups_raft_tpu_torch.parallel')]\n"
            "assert not bad, bad\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]


# ------------------------------------------------------- torchrun's env


def test_parse_cluster_env_absent(no_cluster_env):
    assert distributed.parse_cluster_env() is None
    assert distributed.maybe_init_distributed(device="cpu") is False


def test_parse_cluster_env_complete(monkeypatch, no_cluster_env):
    for k, v in zip(ENV_KEYS, ("10.0.0.1", "29500", "4", "3", "1", "2")):
        monkeypatch.setenv(k, v)
    assert distributed.parse_cluster_env() == distributed.ClusterEnv(
        "10.0.0.1", 29500, 4, 3, 1, 2)
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    # one host: the local rank is the rank, the host holds the world
    assert distributed.parse_cluster_env()[4:] == (3, 4)


@pytest.mark.parametrize("bad", [{"WORLD_SIZE": "two"}, {"RANK": "x"},
                                 {"MASTER_PORT": ""},
                                 {"LOCAL_RANK": "1.5"}])
def test_parse_cluster_env_malformed_is_loud_not_fatal(
        monkeypatch, caplog, clean_degrade_note, no_cluster_env, bad):
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1",
           "WORLD_SIZE": "2", "RANK": "0", **bad}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with caplog.at_level("WARNING"):
        assert distributed.parse_cluster_env() is None
    assert any("malformed" in r.message for r in caplog.records)
    assert "malformed" in plat.degraded_note()
    assert distributed.maybe_init_distributed(device="cpu") is False


@pytest.mark.parametrize("bad", [{"RANK": "5"}, {"WORLD_SIZE": "0"},
                                 {"MASTER_PORT": "70000"},
                                 {"LOCAL_RANK": "2", "LOCAL_WORLD_SIZE": "2"},
                                 {"LOCAL_WORLD_SIZE": "3"}])
def test_parse_cluster_env_inconsistent(monkeypatch, caplog,
                                        clean_degrade_note, no_cluster_env,
                                        bad):
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1",
           "WORLD_SIZE": "2", "RANK": "1", **bad}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with caplog.at_level("WARNING"):
        assert distributed.parse_cluster_env() is None
    assert any("inconsistent" in r.message for r in caplog.records)
    assert "inconsistent" in plat.degraded_note()


def test_distributed_gate(monkeypatch):
    monkeypatch.setenv("JGRAFT_DISTRIBUTED", "0")
    assert distributed.distributed_enabled() is False
    assert distributed.wavefront_active() is False
    monkeypatch.setenv("JGRAFT_DISTRIBUTED", "garbage")
    assert distributed.distributed_enabled() is True  # the default, loudly
    monkeypatch.delenv("JGRAFT_DISTRIBUTED")
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert distributed.wavefront_active() is False


# ---------------------------------------------------------- backend rule


@pytest.mark.parametrize("cards,local_world,rank,want", [
    (1, 1, 0, ("nccl", "cuda:0")),
    (4, 4, 3, ("nccl", "cuda:3")),
    (4, 2, 1, ("nccl", "cuda:1")),
    (1, 2, 1, ("gloo", "cuda:0")),   # two ranks share one card
    (2, 3, 2, ("gloo", "cuda:0")),
])
def test_backend_rule(monkeypatch, cards, local_world, rank, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, dev = distributed.choose_backend(rank, local_world)
    assert (backend, str(dev)) == want
    # every rank of the host reaches the same backend
    assert {distributed.choose_backend(r, local_world)[0]
            for r in range(local_world)} == {want[0]}
    assert distributed.choose_backend(rank, local_world, "cpu") == \
        ("gloo", torch.device("cpu"))


def test_backend_rule_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.choose_backend(0, 2, "cpu")[0] == "gloo"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.choose_backend(0, 2)


# ------------------------------------------------------ single process


def test_single_process_touches_no_wire(monkeypatch):
    def no_store():
        raise AssertionError("the store was touched")

    monkeypatch.setattr(distributed, "_store", no_store)
    seen = []

    def check(rows):
        seen.append(len(rows))
        return [{"valid?": True} for _ in rows]

    assert len(distributed.run_sharded(list(range(5)), check)) == 5
    assert seen == [5]
    assert distributed.collectives_supported() is False
    with pytest.raises(RuntimeError, match="collectives unsupported"):
        distributed.check_batch_global(CasRegister(), [])


@pytest.mark.parametrize("rank", [0, 1])
def test_run_sharded_one_row_leaves_an_empty_shard(monkeypatch, rank):
    """Two processes, one row: rank 0 checks nothing and sends an empty
    payload, rank 1 checks the row; both return its verdict."""
    from jepsen_jgroups_raft_tpu_torch.checker.base import INVALID

    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    sent = []

    def exchange_i64(codes, tag=None):
        sent.append(list(codes))
        mine = np.asarray(codes, dtype=np.int64)
        theirs = np.asarray([] if rank else [0], dtype=np.int64)
        return [mine, theirs] if rank == 0 else [theirs, mine]

    monkeypatch.setattr(distributed, "exchange_i64", exchange_i64)
    seen = []

    def check(rows):
        seen.append(list(rows))
        return [{"valid?": INVALID} for _ in rows]

    [r] = distributed.run_sharded(["row"], check)
    assert seen == ([[]] if rank == 0 else [["row"]])
    assert sent == ([[]] if rank == 0 else [[0]])
    assert r["valid?"] is INVALID
    assert (r.get("kernel") == "remote-shard") is (rank == 0)


def test_exchange_needs_a_process_group():
    with pytest.raises(RuntimeError, match="not initialized"):
        distributed.barrier("x")
    with pytest.raises(RuntimeError, match="not initialized"):
        distributed.exchange_i64([1, 2])


def test_remote_stub_keys_are_the_reference():
    for code in (0, 1, 2):
        ours = distributed._remote_result(code, 1)
        theirs = ref_dist._remote_result(code, 1)
        assert set(ours) == set(theirs)
        assert {k: v for k, v in ours.items() if k != "algorithm"} == \
            {k: v for k, v in theirs.items() if k != "algorithm"}
        assert ours["algorithm"] == "torch" and \
            ours["kernel"] == "remote-shard"
        assert distributed._verdict_code(ours) == code


# ------------------------------------------------------ check_encoded's seam


@pytest.fixture
def fake_cluster(monkeypatch):
    """The seam as a two-process cluster would see it, in one process:
    run_sharded records its calls and checks every row locally; the seam
    names the model and algorithm the detail exchange keys over."""
    calls = []

    def run_sharded(encs, check_local, model=None, algorithm="auto"):
        assert model is not None and isinstance(algorithm, str)
        calls.append(len(encs))
        return check_local(list(encs))

    monkeypatch.setattr(distributed, "wavefront_active", lambda: True)
    monkeypatch.setattr(distributed, "run_sharded", run_sharded)
    return calls


def _encs(n=6):
    return [encode_history(h, CasRegister())
            for h in seeded_batch(3, n, 30, n_wide=0, corrupt_every=0)]


def test_seam_routes_batches_through_run_sharded(fake_cluster):
    encs = _encs()
    rs = lin.check_encoded(encs, CasRegister(), device="cpu")
    assert fake_cluster == [len(encs)] and all(r["valid?"] for r in rs)
    lin.check_encoded(encs, CasRegister(), device="cpu", distribute=False)
    lin.check_encoded(encs[:1], CasRegister(), device="cpu")
    assert fake_cluster == [len(encs)]  # distribute=False, one row: local
    hs = seeded_batch(3, 4, 30, n_wide=0, corrupt_every=0)
    lin.check_histories(hs, CasRegister(), device="cpu",
                        consistency="sequential")
    lin.check_histories(hs, CasRegister(), device="cpu",
                        consistency="sequential", distribute=False)
    assert all(n > 0 for n in fake_cluster)


def test_sharded_batches_stay_kernel_first(monkeypatch, fake_cluster,
                                           tmp_path):
    """With the lin fast path on, a sharded batch skips it (every row on
    the kernel), unless the gate store is shared."""
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "1")
    monkeypatch.delenv("JGRAFT_LINFP_DIR", raising=False)
    assert autotune.linfp_shared_dir() is None
    encs = _encs()
    lin.consume_fastpath_counters()
    rs = lin.check_encoded(encs, CasRegister(), device="cpu")
    assert {r["decided-tier"] for r in rs} == {"dense"}
    assert lin.consume_fastpath_counters().get("rows_scanned", 0) == 0
    assert fake_cluster == [len(encs)]
    monkeypatch.setenv("JGRAFT_LINFP_DIR", str(tmp_path))
    monkeypatch.setenv("JGRAFT_AUTOTUNE", "0")
    rs = lin.check_encoded(encs, CasRegister(), device="cpu")
    assert lin.consume_fastpath_counters().get("rows_scanned", 0) == \
        len(encs)


# ------------------------------------------------- two processes, for real


def _expected(hs, monkeypatch):
    """Single-process verdicts of the worker's checks (no cluster here:
    the seam is inert) and the reference's."""
    model = CasRegister()
    ours, theirs = {}, {}
    for macro in ("1", "0"):
        monkeypatch.setenv("JGRAFT_MACRO_EVENTS", macro)
        for alg, ref_alg in (("dense", "jax"), ("auto", "auto")):
            key = f"macro={macro},{alg}"
            ours[key] = [r["valid?"] for r in
                         lin.check_histories(hs, model, alg, device="cpu")]
            theirs[key] = [r["valid?"] for r in
                           ref_check(hs, RefReg(), algorithm=ref_alg)]
    monkeypatch.setenv("JGRAFT_MACRO_EVENTS", "0")  # the worker's last
    tiny = [r["valid?"] for r in
            lin.check_histories(hs[:3], model, "dense", device="cpu")]
    return ours, theirs, tiny


def _counts(model, hs):
    encs = [encode_history(h, model) for h in hs]
    plan = dense_plan(model, encs)
    return list(mesh.check_batch_sharded(
        model, pack_macro_batch(encs)["events"], device="cpu",
        dense=plan, macro_p=pack_macro_batch(encs)["macro_p"])[2:])


def test_two_process_gloo_cluster(monkeypatch):
    """selfcheck on two ranks over gloo on the CPU: through the seam every
    rank returns the whole batch's verdicts, equal to one process's and
    to the reference's (dense rows, corrupted rows, wide sort-rung rows,
    macro on and off, a 3-row batch, a 1-row batch whose first shard is
    empty), and
    check_batch_global's counts equal one process's on both ranks."""
    outs = launch.launch_local_cluster(
        2, [sys.executable, "-m",
            "jepsen_jgroups_raft_tpu_torch.parallel.selfcheck",
            "--device", "cpu", "--global"],
        env_extra={"PYTHONPATH": str(ROOT), "JGRAFT_LIN_FASTPATH": "0",
                   "JGRAFT_AUTOTUNE": "0"},
        timeout_s=120)
    got = []
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-3000:]}"
        [line] = [ln for ln in out.splitlines()
                  if ln.startswith("SELFCHECK ")]
        got.append(json.loads(line[len("SELFCHECK "):]))
    hs = seeded_batch(11, 12, 30, n_wide=4, corrupt_every=3)
    ours, theirs, tiny = _expected(hs, monkeypatch)
    assert ours == theirs
    assert {False, True} <= set(ours["macro=1,dense"])
    counts = {"register": _counts(CasRegister(), hs[:12]),
              "counter": _counts(Counter(), seeded_batch(
                  12, 12, 30, kind="counter"))}
    for rank, r in enumerate(got):
        assert (r["rank"], r["world"], r["device"]) == (rank, 2, "cpu")
        assert {k: v["verdicts"] for k, v in r["checks"].items()} == ours
        kernels = r["checks"]["macro=1,dense"]["kernels"]
        lo, hi = distributed.shard_bounds(len(hs), 2, rank)
        assert all(k == "remote-shard" for i, k in enumerate(kernels)
                   if not lo <= i < hi)
        assert not any(k == "remote-shard" for k in kernels[lo:hi])
        assert r["tiny"] == tiny and r["empty_shard"] == tiny[:1]
        assert {k: list(v) for k, v in r["global"].items()} == counts


#: result fields that time the check (they differ from run to run), and
#: the two the detail exchange adds to a remote row
TIMING_FIELDS = ("time-s",)
EXCHANGE_FIELDS = ("process", "detail-source")


def test_two_process_gloo_cluster_with_a_result_store(monkeypatch,
                                                       tmp_path):
    """selfcheck on two ranks over gloo with `--result-store` (the ranks'
    JGRAFT_RESULT_STORE): every rank's whole result list equals one
    process's check of the batch, once the timing fields and the two
    fields the exchange adds are dropped; no row is a "remote-shard"
    stub, and every row of the other rank's shard came from the store,
    each as its owner's result."""
    store = tmp_path / "store"
    outs = launch.launch_local_cluster(
        2, [sys.executable, "-m",
            "jepsen_jgroups_raft_tpu_torch.parallel.selfcheck",
            "--device", "cpu", "--macro", "1", "--algorithms", "auto",
            "--result-store", str(store)],
        env_extra={"PYTHONPATH": str(ROOT), "JGRAFT_LIN_FASTPATH": "0",
                   "JGRAFT_AUTOTUNE": "0"},
        timeout_s=120)
    got = []
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-3000:]}"
        [line] = [ln for ln in out.splitlines()
                  if ln.startswith("SELFCHECK ")]
        got.append(json.loads(line[len("SELFCHECK "):]))
    hs = seeded_batch(11, 12, 30, n_wide=4, corrupt_every=3)
    monkeypatch.setenv("JGRAFT_MACRO_EVENTS", "1")
    monkeypatch.delenv("JGRAFT_RESULT_STORE", raising=False)
    from jepsen_jgroups_raft_tpu_torch.core.store import _jsonable

    def strip(rows):
        return [{k: v for k, v in r.items()
                 if k not in TIMING_FIELDS + EXCHANGE_FIELDS} for r in rows]

    single = strip(_jsonable(lin.check_histories(hs, CasRegister(), "auto",
                                                 device="cpu")))
    assert {False, True} <= {r["valid?"] for r in single}
    for rank, r in enumerate(got):
        arm = r["store"]
        assert strip(arm["results"]) == single
        assert "remote-shard" not in arm["kernels"]
        lo, hi = distributed.shard_bounds(len(hs), 2, rank)
        sources = [x.get("detail-source") for x in arm["results"]]
        owners = [x.get("process") for x in arm["results"]]
        assert arm["store_rows"] == len(hs) - (hi - lo)
        for i in range(len(hs)):
            if lo <= i < hi:
                assert sources[i] is None and owners[i] is None
            else:
                assert sources[i] == "result-store" and owners[i] == 1 - rank
        # the plain arm of the same run, without the store, kept its stubs
        kernels = r["checks"]["macro=1,auto"]["kernels"]
        assert kernels.count("remote-shard") == len(hs) - (hi - lo)
    assert len(list((store / "detail").rglob("*.json"))) == len(hs)


# ------------------------------------------------------------ the launcher


def test_child_env_is_torchrun(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    env = launch.cluster_child_env(1, 3, 4321, {"JGRAFT_X": "1"})
    assert [env[k] for k in ENV_KEYS] == ["127.0.0.1", "4321", "3", "1",
                                          "1", "3"]
    assert env["JGRAFT_X"] == "1" and "XLA_FLAGS" not in env
    assert env["OMP_NUM_THREADS"] == "1"  # torchrun's default
    assert "OMP_NUM_THREADS" not in launch.cluster_child_env(0, 1, 4321)
    monkeypatch.setenv("OMP_NUM_THREADS", "4")
    assert launch.cluster_child_env(0, 2, 4321)["OMP_NUM_THREADS"] == "4"
    assert 0 < launch.free_coordinator_port() < 65536


def test_launcher_kills_at_its_deadline(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text("import os, time\n"
                      "print('up', flush=True)\n"
                      "time.sleep(0 if os.environ['RANK'] == '0' else 60)\n")
    outs = launch.launch_local_cluster(2, [sys.executable, str(script)],
                                       timeout_s=3)
    assert outs[0][0] == 0 and "killed" not in outs[0][1]
    assert outs[1][0] != 0 and "[killed: no exit in 3s]" in outs[1][1]
    assert outs[1][1].startswith("up")


def test_selfcheck_main_tears_its_group_down(monkeypatch):
    """selfcheck's `main` returns with no process group up (a barrier,
    then destroy_process_group), so no rank can abort at exit with its
    group still alive; the store and device chosen at init are
    forgotten too. One rank, gloo on the CPU."""
    import torch.distributed as dist

    from jepsen_jgroups_raft_tpu_torch.parallel import selfcheck

    env = launch.cluster_child_env(0, 1, launch.free_coordinator_port())
    for k in ENV_KEYS:
        monkeypatch.setenv(k, env[k])
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "0")
    assert not dist.is_initialized()
    rc = selfcheck.main(["--device", "cpu", "--histories", "3", "--ops",
                         "12", "--wide", "0", "--macro", "1",
                         "--algorithms", "dense"])
    assert rc == 0
    assert not dist.is_initialized()
    assert distributed._STATE == {}
