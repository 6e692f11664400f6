"""The port's transactional anomaly rung against the reference's
checker/anomaly.py.

`build_txn_graph` and `certify_history` give the reference's graphs and
result dicts (classes and witnesses) on the planted G0, G1c and G-single
fixtures, a clean history, duplicate elements, crashed appends (observed
and not), and histories of the reference's transactional cycle A/B shape
(`synth.listappend_txn_rows`, with anomalies planted on keys of their
own). The condensed and direct arms agree with each other and with the
reference; the kernel arm (the closure's plain version on device="cpu")
agrees with the host arm; the checker façade, the submission merge and
the node-cap skip match. Exact equality throughout.
"""

import random

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import anomaly as ref_anomaly
from jepsen_jgroups_raft_tpu.checker import cycle as ref_cycle
from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu.models import CasRegister as RefCasRegister
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker import anomaly, cycle, schedule
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import (ANOMALY_ROWS,
                                                         build_history,
                                                         listappend_txn_rows,
                                                         plant_anomaly)
from jepsen_jgroups_raft_tpu_torch.models import CasRegister

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _drain_reference_counters():
    """The reference's counters are process-wide, and its own tests read
    their totals: leave none of this file's reference calls in them."""
    yield
    ref_schedule.consume_stats()
    ref_schedule.consume_tiers()


DUPLICATES = (
    (1, "invoke", "append", ("x", 1)), (1, "ok", "append", ("x", [1])),
    (2, "invoke", "append", ("x", 1)), (2, "ok", "append", ("x", [1])),
    (3, "invoke", "append", ("x", 2)), (3, "ok", "append", ("x", [1, 2])),
    (4, "invoke", "read", ("x", None)), (4, "ok", "read", ("x", [1])),
)
CRASHED_UNSEEN = (
    (1, "invoke", "append", ("x", 1)), (1, "ok", "append", ("x", [1])),
    (2, "invoke", "append", ("x", 2)), (2, "info", "append", None),
    (3, "invoke", "read", ("x", None)), (3, "ok", "read", ("x", [1])),
)
CRASHED_SEEN = (
    (1, "invoke", "append", ("x", 1)), (1, "ok", "append", ("x", [1])),
    (2, "invoke", "append", ("x", 2)), (2, "info", "append", None),
    (3, "invoke", "read", ("x", None)), (3, "ok", "read", ("x", [1, 2])),
)


def _txn(n_ops, n_keys, seed, plants=()):
    rows = listappend_txn_rows(random.Random(seed), n_ops, n_keys, 5)
    for j, kind in enumerate(plants):
        rows = plant_anomaly(rows, kind, f"planted-{j}", 100 + 10 * j)
    return rows


FIXTURES = {**{k: tuple(v) for k, v in ANOMALY_ROWS.items()},
            "duplicates": DUPLICATES, "crashed-unseen": CRASHED_UNSEEN,
            "crashed-seen": CRASHED_SEEN,
            "serial": _txn(160, 5, 23),
            "serial+G-single": _txn(160, 5, 24, ("G-single",)),
            "serial+G-single+G1c": _txn(160, 5, 25, ("G-single", "G1c")),
            "serial+G0": _txn(120, 4, 26, ("G0",))}


def _ref_history(rows):
    h = RefHistory()
    for i, (p, typ, f, v) in enumerate(rows):
        h.append(RefOp(process=p, type=typ, f=f, value=v, time=i))
    return h


def _both(name):
    rows = FIXTURES[name]
    return build_history(rows), _ref_history(rows)


def test_planted_fixtures_are_the_reference_tests():
    """ANOMALY_ROWS are the reference suite's fixtures, class for class."""
    import test_anomaly as ref_tests

    for kind, fn in (("G0", ref_tests._g0_history),
                     ("G1c", ref_tests._g1c_history),
                     ("G-single", ref_tests._gsingle_history),
                     ("clean", ref_tests._clean_history)):
        assert [tuple(r) for r in ANOMALY_ROWS[kind]] == \
            [(o.process, o.type, o.f, o.value) for o in fn()]


def test_serial_rows_are_the_reference_ab_shape():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / \
        "ab_cycle.py"
    spec = importlib.util.spec_from_file_location("ab_cycle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert listappend_txn_rows(random.Random(23), 300, 7, 5) == \
        mod._serial_listappend_rows(random.Random(23), 300, 7, 5)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_build_txn_graph_matches_reference(name):
    h, rh = _both(name)
    g = anomaly.build_txn_graph(h)
    r = interop.graph_from_reference(ref_anomaly.build_txn_graph(rh))
    assert (g["n"], g["op_index"]) == (r["n"], r["op_index"])
    assert g["adj"].tobytes() == r["adj"].tobytes()
    for k in anomaly.PLANE_NAMES:
        assert g["planes"][k].tobytes() == r["planes"][k].tobytes()


def _classes(r):
    return r["valid?"], sorted(r["anomalies"])


WANT = {"G0": (False, ["G0"]), "G1c": (False, ["G1c"]),
        "G-single": (False, ["G-single"]), "clean": (True, []),
        "serial": (True, []), "serial+G-single": (False, ["G-single"]),
        "serial+G-single+G1c": (False, ["G1c"]),
        "serial+G0": (False, ["G0"])}


@pytest.mark.parametrize("condense", ["1", "0"], ids=["condensed",
                                                      "direct"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_certify_history_matches_reference(name, condense, monkeypatch):
    monkeypatch.setenv("JGRAFT_CYCLE_CONDENSE", condense)
    h, rh = _both(name)
    ours = anomaly.certify_history(h, device="cpu")
    assert ours == ref_anomaly.certify_history(rh)
    if name in WANT:
        assert _classes(ours) == WANT[name]
    monkeypatch.setenv("JGRAFT_CYCLE_CONDENSE",
                       "0" if condense == "1" else "1")
    assert anomaly.certify_history(h, device="cpu") == ours


@pytest.mark.parametrize("name", ["G-single", "clean", "serial",
                                  "serial+G-single", "duplicates"])
@pytest.mark.parametrize("condense", ["1", "0"], ids=["condensed",
                                                      "direct"])
def test_kernel_arm_matches_host_arm(name, condense, monkeypatch):
    """The G-single closure through the kernel arm (its plain version on
    the CPU) gives the host arm's answer and the reference kernel arm's."""
    monkeypatch.setenv("JGRAFT_CYCLE_CONDENSE", condense)
    h, rh = _both(name)
    schedule.consume_stats()
    host = anomaly.certify_history(h, kernel=False)
    kern = anomaly.certify_history(h, kernel=True, device="cpu")
    assert kern == host == ref_anomaly.certify_history(rh, kernel=True)


def test_gsingle_witness_names_the_rw_edge():
    h, _ = _both("G-single")
    w = anomaly.certify_history(h, device="cpu")["anomalies"]["G-single"]
    u, v = w["rw-edge"]
    assert w["cycle"][0] == u and w["cycle"][1] == v


def test_register_planes_certify_as_reference():
    """The register graph's planes (build_sc_graph want_planes) through
    certify_planes, both arms."""
    rows = [(0, "invoke", "write", 1), (0, "ok", "write", 1),
            (0, "invoke", "write", 2), (0, "ok", "write", 2),
            (1, "invoke", "read", None), (1, "ok", "read", 2),
            (1, "invoke", "read", None), (1, "ok", "read", 1)]
    m, rm = CasRegister(), RefCasRegister()
    g = cycle.build_sc_graph(encode_history(build_history(rows), m), m,
                             want_planes=True)
    r = ref_cycle.build_sc_graph(ref_enc(_ref_history(rows), rm), rm,
                                 want_planes=True)
    for kernel in (False, True):
        assert anomaly.certify_planes(g, kernel, torch.device("cpu")) == \
            ref_anomaly.certify_planes(r, kernel)


def test_checker_facade_submission_and_skip(monkeypatch):
    hs = [_both(k) for k in ("G1c", "clean", "serial")]
    checker = anomaly.TxnAnomalyChecker(device="cpu")
    for h, rh in hs:
        assert checker.check({}, h) == \
            ref_anomaly.TxnAnomalyChecker().check({}, rh)
    assert anomaly.certify_submission([h for h, _ in hs]) == \
        ref_anomaly.certify_submission([rh for _, rh in hs])
    monkeypatch.setenv("JGRAFT_CYCLE_MAX_OPS", "2")
    h, rh = _both("G0")
    schedule.consume_stats()
    with schedule.stats_scope() as scope:
        r = anomaly.certify_history(h, device="cpu")
    assert r == ref_anomaly.certify_history(rh)
    assert r["valid?"] == "unknown" and r["cycle-skipped-size"] > 2
    assert scope["cycle_size_skips"] == 1


def test_empty_and_foreign_histories():
    h = build_history([(0, "invoke", "write", 1), (0, "ok", "write", 1)])
    assert anomaly.certify_history(h, device="cpu") == \
        ref_anomaly.certify_history(_ref_history(
            [(0, "invoke", "write", 1), (0, "ok", "write", 1)])) == \
        {"valid?": True, "anomalies": {}, "nodes": 0}
