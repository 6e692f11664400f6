"""The port's streaming sessions (`service.stream`) against the
reference's, on the CPU.

* After every append, the session state (unit states, next seq, the
  violation and its segment, every per-unit result) equals the
  reference's session fed the same segments, up to the stream's
  algorithm name (``torch-stream`` where the reference says
  ``jax-stream``); wherever a unit carries the sort scan, its carry
  equals the reference's field for field (`interop.carry_fields`
  against `interop.reference_carry_fields`), with (ok, overflow, fed,
  launches). Both the certifier path (the default) and the carried
  kernel (``JGRAFT_STREAM_GREEDY_MAX_EVENTS=0``) are held.
* The final verdict equals the reference's and the one-shot check's.
* A stream the reference's daemon journaled and left unfinished resumes
  in the port's daemon and finishes with the reference's verdict.
* The binary lane gives the JSON lane's verdicts; a weaker rung is
  refused at open, as in the reference.
* A dead replica's open session is claimed by a surviving replica of
  the cluster, re-journaled there and finished with the state, carry
  and verdict of the reference's uninterrupted session.

Tolerance: exact equality.
"""

import random
import shutil
import time

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.service import CheckingService as RefService
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.service import (CheckingService,
                                                   ServiceClient,
                                                   serve_in_thread)
from jepsen_jgroups_raft_tpu_torch.service.request import history_from_dicts

torch.set_num_threads(1)

KIND = {"register": "cas-register", "counter": "counter", "set": "set"}
CUT = 12  # rows an append


def _rows(kind, seed, n_ops=30, corrupt=False):
    kw = {"value_range": 32} if kind == "set" else {}
    ops = list(random_valid_history(random.Random(seed), kind, n_ops=n_ops,
                                    n_procs=3, crash_p=0.0, **kw))
    if corrupt:
        reads = [j for j, op in enumerate(ops) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        j = reads[len(reads) // 3]
        ops[j] = ops[j].replace(value=ops[j].value + 7)
    return [op.to_dict() for op in ops]


def _normalize(x):
    """The state with the stream's algorithm name made the reference's."""
    if isinstance(x, dict):
        return {k: ("jax-stream" if v == "torch-stream" else _normalize(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_normalize(v) for v in x]
    return x


def _ref_carry(scan, model):
    rc = scan.carry
    rcn = {"inner": [np.asarray(x) if not isinstance(x, tuple)
                     else tuple(np.asarray(y) for y in x)
                     for x in rc["inner"]],
           "left": np.asarray(rc["left"])}
    return interop.reference_carry_fields("sort", rcn, model)


def _check_carries(ours, theirs, model) -> int:
    """Hold every unit's carry to the reference's; returns how many
    units carried a scan."""
    held = 0
    for u, v in zip(ours.units, theirs.units):
        assert (u.scan is None) == (v.scan is None)
        if u.scan is None:
            continue
        held += 1
        assert (u.scan.ok, u.scan.overflow, u.scan.fed, u.scan.launches) \
            == (v.scan.ok, v.scan.overflow, v.scan.fed, v.scan.launches)
        got = interop.carry_fields("sort", u.scan.carry, u.scan.slots_cap,
                                   u.scan.n_configs)
        for k, want in _ref_carry(v.scan, model).items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    return held


CASES = {
    # name: (kind, seed, corrupt, kernel carry)
    "register-kernel": ("register", 1, False, True),
    "register-invalid-kernel": ("register", 2, True, True),
    "counter-kernel": ("counter", 3, False, True),
    "set-kernel": ("set", 4, False, True),
    "register-certifier": ("register", 5, False, False),
    "register-invalid-certifier": ("register", 6, True, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_states_and_carries_equal_reference(name, monkeypatch):
    kind, seed, corrupt, kernel = CASES[name]
    if kernel:
        monkeypatch.setenv("JGRAFT_STREAM_GREEDY_MAX_EVENTS", "0")
    rows = _rows(kind, seed, corrupt=corrupt)
    port = CheckingService(device="cpu", autostart=False)
    ref = RefService(autostart=False)
    carried = 0
    violation_at = None
    try:
        for svc in (port, ref):
            svc.streams.open(workload=kind, session_id="s")
        for seq, lo in enumerate(range(0, len(rows), CUT), 1):
            seg = rows[lo:lo + CUT]
            got = port.streams.append("s", seq, seg, n_bytes=0)
            want = ref.streams.append("s", seq, seg, n_bytes=0)
            assert _normalize(got) == want, seq
            if violation_at is None and "violation" in got:
                violation_at = seq
            carried += _check_carries(port.streams._get("s"),
                                      ref.streams._get("s"),
                                      MODELS[KIND[kind]]())
        got = port.streams.finish("s")
        want = ref.streams.finish("s")
    finally:
        port.shutdown()
        ref.shutdown()
    assert _normalize(got) == want
    [alone] = check_histories([history_from_dicts(rows)],
                              MODELS[KIND[kind]](), device="cpu")
    assert got["valid?"] == alone["valid?"] == (not corrupt)
    # a valid row carries the sort scan between appends on the kernel
    # path and never on the certifier's (a corrupted row's scan decides
    # and is freed at the append where the violation settles)
    if not corrupt:
        assert (carried > 0) == kernel
    else:
        assert violation_at is not None and violation_at < seq
    if kernel:
        assert got["results"][0]["algorithm"] == "torch-stream"


def test_reference_stream_resumes_in_the_port(tmp_path, monkeypatch):
    """A session the reference's daemon journaled (open + two segments)
    and left unfinished: the port's daemon on its WAL resumes it, takes
    the rest, and finishes with the verdict the reference's daemon
    gives resuming a copy of the same WAL."""
    monkeypatch.setenv("JGRAFT_STREAM_GREEDY_MAX_EVENTS", "0")
    rows = _rows("register", 7, corrupt=True)
    held = RefService(journal_dir=str(tmp_path / "ref"), autostart=False)
    held.streams.open(workload="register", session_id="s")
    for seq in (1, 2):
        held.streams.append("s", seq, rows[(seq - 1) * CUT:seq * CUT],
                            n_bytes=0)
    held._journal.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "copy")

    def resume(svc):
        try:
            st = svc.streams.open(session_id="s", resume=True)
            assert st["next_seq"] == 3 and st["resumed"]
            for seq, lo in enumerate(range(2 * CUT, len(rows), CUT), 3):
                svc.streams.append("s", seq, rows[lo:lo + CUT], n_bytes=0)
            return svc.streams.finish("s")
        finally:
            svc.shutdown()

    got = resume(CheckingService(journal_dir=str(tmp_path / "ref"),
                                 device="cpu", autostart=False))
    want = resume(RefService(journal_dir=str(tmp_path / "copy"),
                             autostart=False))
    assert _normalize(got) == want
    assert got["valid?"] is False and got["resumed"] is True


def test_binary_and_json_streams_agree_over_http(tmp_path):
    """Over HTTP, a valid and a corrupted history streamed on the JSON
    lane and on the binary lane: the same final verdicts, equal to the
    one-shot check's; the corrupted one surfaces mid-stream."""
    svc = CheckingService(device="cpu", journal_dir=str(tmp_path / "j"),
                          batch_wait=0.0)
    httpd, port, _ = serve_in_thread(svc)
    cl = ServiceClient(f"http://127.0.0.1:{port}", timeout=30.0)
    finals = {}
    mid = {}
    try:
        for corrupt in (False, True):
            rows = _rows("register", 8, corrupt=corrupt)
            for binary in (False, True):
                s = cl.stream(workload="register", binary=binary)
                seen = False
                for lo in range(0, len(rows), CUT):
                    st = s.append(rows[lo:lo + CUT])
                    seen = seen or st.get("violation") is not None
                finals[corrupt, binary] = s.finish()["valid?"]
                mid[corrupt, binary] = seen
    finally:
        cl.close()
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()
    assert finals == {(False, False): True, (False, True): True,
                      (True, False): False, (True, True): False}
    assert mid[True, False] and mid[True, True]


@pytest.mark.parametrize("rung", ["sequential", "session"])
def test_weak_rung_stream_is_refused(rung):
    svc = CheckingService(device="cpu", autostart=False)
    ref = RefService(autostart=False)
    try:
        for s in (svc, ref):
            with pytest.raises(ValueError, match="linearizable rung"):
                s.streams.open(workload="register", consistency=rung)
    finally:
        svc.shutdown()
        ref.shutdown()


def _but_resumed(state):
    """A session state without its ``resumed`` flag (the one field in
    which a revived session differs from an uninterrupted one)."""
    return {k: v for k, v in state.items() if k != "resumed"}


def test_survivor_claims_a_dead_replicas_open_session(tmp_path,
                                                       monkeypatch):
    """A port replica of a cluster dies with an open session (two
    appends journaled, the lease left to expire); a surviving replica
    claims its WAL, re-journals the session under its own, and the
    session resumes there on the next append. After every later append
    the revived session's state and carried sort scan equal the
    reference's uninterrupted session fed the same segments, and the
    final verdict equals it and the one-shot check's."""
    monkeypatch.setenv("JGRAFT_STREAM_GREEDY_MAX_EVENTS", "0")
    monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
    rows = _rows("register", 9, corrupt=True)
    segs = [rows[lo:lo + CUT] for lo in range(0, len(rows), CUT)]
    assert len(segs) >= 3
    cdir = tmp_path / "cluster"
    victim = CheckingService(cluster_dir=str(cdir), replica_id="r0",
                             lease_ttl_s=0.1, device="cpu", autostart=False)
    victim.streams.open(workload="register", session_id="claimed")
    for seq, seg in enumerate(segs[:2], 1):
        victim.streams.append("claimed", seq, seg, n_bytes=0)
    victim._journal.close()  # dies: no terminal, the lease expires
    ref = RefService(autostart=False)
    ref.streams.open(workload="register", session_id="claimed")
    for seq, seg in enumerate(segs[:2], 1):
        ref.streams.append("claimed", seq, seg, n_bytes=0)
    time.sleep(0.2)
    # the survivor's own agent first scans seconds after its start
    survivor = CheckingService(cluster_dir=str(cdir), replica_id="r1",
                               lease_ttl_s=5.0, device="cpu")
    try:
        assert survivor.cluster.handoff_scan() == 1
        st = survivor.stats()
        assert st["handoff_streams"] == 1 and st["handoff_claims"] == 1
        assert survivor.streams.status("claimed")["status"] == "incomplete"
        # re-journaled under the survivor's own WAL, the claim removed
        assert sorted(p.name for p in (cdir / "journal").iterdir()) == \
            ["r1"]
        assert survivor._journal.stream_records("claimed") is not None
        for seq, seg in enumerate(segs[2:], 3):
            got = survivor.streams.append("claimed", seq, seg, n_bytes=0)
            want = ref.streams.append("claimed", seq, seg, n_bytes=0)
            assert got.get("resumed") is True and not want.get("resumed")
            assert _normalize(_but_resumed(got)) == _but_resumed(want), seq
            _check_carries(survivor.streams._get("claimed"),
                           ref.streams._get("claimed"), MODELS[KIND[
                               "register"]]())
        got = survivor.streams.finish("claimed")
        want = ref.streams.finish("claimed")
    finally:
        survivor.shutdown()
        ref.shutdown()
    assert _normalize(_but_resumed(got)) == _but_resumed(want)
    assert got["resumed"] is True
    [alone] = check_histories([history_from_dicts(rows)],
                              MODELS["cas-register"](), device="cpu")
    assert got["valid?"] == alone["valid?"] is False
