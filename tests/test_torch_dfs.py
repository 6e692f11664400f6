"""The port's host tiers against the reference: the DFS engine and the
brute-force oracle on all four models, auto's wide-window order (fast
DFS, device, host), the "dfs" and "race" algorithms, and the
counterexample that LinearizableChecker attaches to an INVALID verdict.
The reference runs under the suite's pins (JGRAFT_LIN_FASTPATH=0,
JGRAFT_AUTOTUNE=0); the port on device="cpu". Exact equality."""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import brute as ref_brute
from jepsen_jgroups_raft_tpu.checker import counterexample as ref_ce
from jepsen_jgroups_raft_tpu.checker import dfs_cpu as ref_dfs
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    LinearizableChecker as RefChecker
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu_torch.checker import brute, counterexample, dfs_cpu
from jepsen_jgroups_raft_tpu_torch.checker.base import INVALID
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import (
    LinearizableChecker, check_histories)
from jepsen_jgroups_raft_tpu_torch.history.ops import History
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import (build_history,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import MODELS

torch.set_num_threads(1)

#: synthesizer kind → model name in both packages' MODELS
KINDS = {"register": "cas-register", "counter": "counter", "queue": "queue",
         "set": "set"}


def _corrupt(h, rng):
    """One ok observation changed: a number raised by 1000, a queue
    ticket moved, a set read toggling element 30."""
    idx = [j for j, op in enumerate(h) if op.type == "ok"
           and op.value is not None
           and op.f in ("read", "add-and-get", "enqueue", "dequeue")]
    if idx:
        j = rng.choice(idx)
        v = h[j].value
        v = (sorted(set(v) ^ {30}) if isinstance(v, list) else
             (v[0], v[1] + 1000) if isinstance(v, tuple) else v + 1000)
        h[j] = h[j].replace(value=v)
    return h


def _histories(kind, seed, n, n_ops, n_procs=4, crash_p=0.15,
               max_crashes=3):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        h = list(random_valid_history(
            rng, kind, n_ops=n_ops, n_procs=n_procs, crash_p=crash_p,
            max_crashes=max_crashes,
            **({"value_range": 6} if kind == "set" else {})))
        out.append(_corrupt(h, rng) if i % 2 else h)
    return out


def _dfs_view(r):
    return (r.valid, r.configs_explored, r.max_frontier,
            r.failing_op_index, r.witness)


@pytest.mark.parametrize("kind", list(KINDS))
def test_dfs_equals_reference(kind):
    m, rm = MODELS[KINDS[kind]](), REF_MODELS[KINDS[kind]]()
    verdicts = []
    for h in _histories(kind, 3, 10, 60):
        ours = dfs_cpu.check_encoded_dfs(encode_history(h, m), m,
                                         witness=True)
        theirs = ref_dfs.check_encoded_dfs(ref_enc(h, rm), rm, witness=True)
        assert _dfs_view(ours) == _dfs_view(theirs)
        verdicts.append(ours.valid)
    assert True in verdicts and False in verdicts


@pytest.mark.parametrize("kind", list(KINDS))
def test_dfs_budget_runs_out_at_the_same_step(kind):
    m, rm = MODELS[KINDS[kind]](), REF_MODELS[KINDS[kind]]()
    h = _histories(kind, 4, 1, 80)[0]
    full = dfs_cpu.check_encoded_dfs(encode_history(h, m), m)
    budget = max(full.configs_explored // 2, 3)
    with pytest.raises(dfs_cpu.SearchBudgetExceeded) as ours:
        dfs_cpu.check_encoded_dfs(encode_history(h, m), m, max_steps=budget)
    with pytest.raises(ref_dfs.SearchBudgetExceeded) as theirs:
        ref_dfs.check_encoded_dfs(ref_enc(h, rm), rm, max_steps=budget)
    assert ours.value.steps == theirs.value.steps == budget + 1
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kind", list(KINDS))
def test_brute_equals_reference_and_dfs(kind):
    m, rm = MODELS[KINDS[kind]](), REF_MODELS[KINDS[kind]]()
    verdicts = []
    for h in _histories(kind, 5, 12, 7, n_procs=3, crash_p=0.3,
                        max_crashes=2):
        ours = brute.check_brute(h, m)
        assert ours is ref_brute.check_brute(h, rm)
        assert ours is dfs_cpu.check_encoded_dfs(encode_history(h, m),
                                                 m).valid
        verdicts.append(ours)
    assert True in verdicts and False in verdicts


def _crashed_adds(n, read):
    """The counter history of ROADMAP Queue C: process k invokes add 1<<k
    and crashes (k < n), then process 100 reads `read` (window n + 1)."""
    rows = []
    for k in range(n):
        rows += [(k, "invoke", "add", 1 << k), (k, "info", "add", 1 << k)]
    rows += [(100, "invoke", "read", None), (100, "ok", "read", read)]
    return build_history(rows)


def test_wide_crashed_counter_decides_on_the_dfs_tier():
    """20 crashed adds then a read of their sum: W = 21, a frontier of
    2^20 configurations for the host oracle (it overflows), one witness
    for the DFS. Both packages: VALID on the dfs algorithm, host tier."""
    from jepsen_jgroups_raft_tpu.models.counter import Counter as RefCounter
    from jepsen_jgroups_raft_tpu_torch.models import Counter

    h = _crashed_adds(20, (1 << 20) - 1)
    [ours] = check_histories([h], Counter(), device="cpu")
    [theirs] = ref_check([h], RefCounter())
    for r in (ours, theirs):
        assert r["concurrency-window"] == 21
        assert (r["valid?"], r["algorithm"], r["decided-tier"]) == \
            (True, "dfs", "host")
    assert ours["configs-explored"] == theirs["configs-explored"]


def _wide_batch(seed=21):
    """Histories with windows 13..20 on the register and the counter
    (5 processes, the rest of the window crashed), odd ones corrupted."""
    rng = random.Random(seed)
    out = []
    for W in range(13, 21):
        for kind in ("register", "counter"):
            while True:
                h = list(random_valid_history(rng, kind, n_ops=40,
                                              n_procs=5, crash_p=0.7,
                                              max_crashes=W - 5))
                m = MODELS[KINDS[kind]]()
                if encode_history(h, m).n_slots >= 13:
                    break
            out.append((kind, _corrupt(h, rng) if len(out) % 2 else h))
    return out


def test_wide_windows_take_the_reference_tiers():
    """Row for row over windows 13..20: the same verdict, algorithm and
    decided tier as the reference under auto."""
    views = set()
    for kind, h in _wide_batch():
        name = KINDS[kind]
        [ours] = check_histories([h], MODELS[name](), device="cpu")
        [theirs] = ref_check([h], REF_MODELS[name]())
        view = (ours["valid?"], ours["algorithm"], ours["decided-tier"])
        assert view == (theirs["valid?"], theirs["algorithm"],
                        theirs["decided-tier"])
        assert ours["concurrency-window"] == theirs["concurrency-window"]
        views.add(view)
    assert {v[0] for v in views} == {True, False}


def test_rows_the_fast_dfs_leaves_take_the_ladder(monkeypatch):
    """Under auto, a wide row whose fast DFS runs out goes on to the
    sort ladder, which decides it, in both packages
    (the fast budget is cut in both so that a short chain runs it
    out)."""
    from jepsen_jgroups_raft_tpu.checker import linearizable as ref_lin
    from jepsen_jgroups_raft_tpu_torch.checker import linearizable
    from jepsen_jgroups_raft_tpu_torch.history.synth import chained_bursts

    monkeypatch.setattr(linearizable, "FAST_DFS_BUDGET", 200)
    monkeypatch.setattr(ref_lin, "FAST_DFS_BUDGET", 200)
    hs = [chained_bursts(random.Random(1), 16, 6, off=1),
          chained_bursts(random.Random(2), 16, 6, off=1)]
    ours = check_histories(hs, MODELS["counter"](), device="cpu")
    theirs = ref_check(hs, REF_MODELS["counter"]())
    assert [(r["valid?"], r["decided-tier"]) for r in ours] == \
        [(r["valid?"], r["decided-tier"]) for r in theirs] == \
        [(False, "sort")] * 2


@pytest.mark.parametrize("algorithm", ["dfs", "race"])
def test_dfs_and_race_algorithms(algorithm):
    """"dfs" gives the reference's verdicts, algorithm and explored
    counts; "race" gives the reference's verdicts (its winner may
    differ from run to run)."""
    m, rm = MODELS["cas-register"](), REF_MODELS["cas-register"]()
    hs = _histories("register", 8, 8, 60) + [build_history([])]
    ours = check_histories(hs, m, algorithm=algorithm, device="cpu")
    theirs = ref_check(hs, rm, algorithm=algorithm)
    assert [r["valid?"] for r in ours] == [r["valid?"] for r in theirs]
    assert {r["valid?"] for r in ours} == {True, False}
    if algorithm == "dfs":
        for r, t in zip(ours, theirs):
            assert (r["algorithm"], r.get("configs-explored"),
                    r.get("failing-op-index")) == \
                (t["algorithm"], t.get("configs-explored"),
                 t.get("failing-op-index"))
    else:
        assert all(r.get("raced") for r in ours[:-1])


def test_race_raises_when_the_device_pass_fails(monkeypatch):
    """A device pass that raises under "race" is raised again after both
    threads end; the host never answers in its place."""
    from jepsen_jgroups_raft_tpu_torch.checker import linearizable

    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(linearizable, "_device_pass", broken)
    hs = _histories("register", 8, 4, 60)
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        check_histories(hs, MODELS["cas-register"](), algorithm="race",
                        device="cpu")


def _ref_history(ops):
    """The same ops as a reference History (it takes dicts)."""
    return RefHistory([op.to_dict() for op in ops])


def _invalid(kind, seed):
    rng = random.Random(seed)
    while True:
        h = _corrupt(list(random_valid_history(
            rng, kind, n_ops=24, n_procs=3, crash_p=0.1, max_crashes=1)),
            rng)
        m = MODELS[KINDS[kind]]()
        if not dfs_cpu.check_encoded_dfs(encode_history(h, m), m).valid:
            return h


@pytest.mark.parametrize("kind", ["register", "counter"])
def test_counterexample_equals_reference(kind):
    """attach_counterexample (kernel verdict: no failing op yet, so it
    re-searches on the host frontier and minimizes) and
    minimize_counterexample alone give the reference's dicts."""
    m, rm = MODELS[KINDS[kind]](), REF_MODELS[KINDS[kind]]()
    for seed in range(3):
        h = _invalid(kind, 30 + seed)
        ours = counterexample.attach_counterexample(
            {"valid?": INVALID}, History(h), m)
        theirs = ref_ce.attach_counterexample(
            {"valid?": False}, _ref_history(h), rm)
        assert ours == theirs
        assert "minimal-ops" in ours["counterexample"]
        fi = ours["failing-op-index"]
        ours = counterexample.minimize_counterexample(
            {"valid?": INVALID, "failing-op-index": fi}, History(h), m)
        theirs = ref_ce.minimize_counterexample(
            {"valid?": False, "failing-op-index": fi}, _ref_history(h),
            rm)
        assert ours == theirs


def test_counterexample_refuses_an_unported_rung():
    """The weak rungs are ported: a counterexample at "sequential" or
    "session" is searched on the rung's relaxed stream and equals the
    reference's (it raised before the rungs came)."""
    m, rm = MODELS["cas-register"](), REF_MODELS["cas-register"]()
    h = _invalid("register", 40)
    for rung in ("sequential", "session"):
        ours = counterexample.attach_counterexample(
            {"valid?": INVALID}, History(h), m, consistency=rung)
        theirs = ref_ce.attach_counterexample(
            {"valid?": False}, _ref_history(h), rm, consistency=rung)
        assert ours == theirs


def test_checker_returns_reference_keys(tmp_path):
    """LinearizableChecker.check on a valid and an invalid register
    history: the reference's keys, values and counterexample, and the
    same HTML timeline written into the store dir."""
    m, rm = MODELS["cas-register"](), REF_MODELS["cas-register"]()
    good = _histories("register", 12, 1, 30)[0]
    bad = _invalid("register", 41)
    for h in (good, bad):
        ours = LinearizableChecker(m, device="cpu").check(
            {"store_dir": str(tmp_path / "ours")}, h)
        theirs = RefChecker(rm).check({"store_dir": str(tmp_path / "ref")},
                                      _ref_history(h))
        for r in (ours, theirs):
            r.pop("time-s", None)
        ours_file = ours.get("counterexample", {}).pop("file", None)
        theirs_file = theirs.get("counterexample", {}).pop("file", None)
        # the device's algorithm is "torch" where the reference's is
        # "jax"; both stamp "chunked" from their wavefronts
        skip = {"algorithm"}
        assert {k: v for k, v in ours.items() if k not in skip} == \
            {k: v for k, v in theirs.items() if k not in skip}
        assert (ours_file is None) == (theirs_file is None)
    (tmp_path / "ours").mkdir()
    (tmp_path / "ref").mkdir()
    ours = LinearizableChecker(m, device="cpu").check(
        {"store_dir": str(tmp_path / "ours")}, bad)
    theirs = RefChecker(rm).check({"store_dir": str(tmp_path / "ref")},
                                  _ref_history(bad))
    assert ours["counterexample"]["file"].endswith("counterexample.html")
    assert (tmp_path / "ours" / "counterexample.html").read_text() == \
        (tmp_path / "ref" / "counterexample.html").read_text()
