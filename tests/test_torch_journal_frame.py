"""The port's binary frames and admission journal against the
reference's, on the CPU.

* Frames: `encode_submit_frame` and `encode_segment_frame` give bytes
  identical to the reference's for the same encodings (every workload,
  both lanes' metadata); a frame the reference encoded decodes in the
  port to the same arrays and admits to the reference's fingerprint; a
  torn or rotted frame is refused.
* Journal records: a reference submit record decodes in the port to the
  same request (encodings, fingerprint, model, rung); a terminal record
  is the reference's.
* Cross-replay, the state carried across: a WAL written by the
  reference's daemon, its requests admitted and held before execution,
  is replayed by the port's daemon with the reference's verdicts (the
  reference's own daemon replaying a copy of the same WAL), and a WAL
  the port wrote replays in the reference's daemon. A torn tail costs
  one record.

Tolerance: exact equality (bytes, arrays, verdicts, tiers).
"""

import json
import random
import shutil

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.service import CheckingService as RefService
from jepsen_jgroups_raft_tpu.service import frame as ref_frame
from jepsen_jgroups_raft_tpu.service import journal as ref_journal
from jepsen_jgroups_raft_tpu.service import request as ref_request
from jepsen_jgroups_raft_tpu_torch.history.packing import IncrementalEncoder
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.service import CheckingService
from jepsen_jgroups_raft_tpu_torch.service import frame as port_frame
from jepsen_jgroups_raft_tpu_torch.service.admission import admit_frame
from jepsen_jgroups_raft_tpu_torch.service import journal as port_journal
from jepsen_jgroups_raft_tpu_torch.service import request as port_request

torch.set_num_threads(1)

WAIT_S = 120.0
KINDS = ("register", "counter", "queue", "set", "list-append")


def _rows(kind, seed, n_ops=24, corrupt=False):
    """Op dicts of a random valid history of `kind` (3 processes; a
    list-append history keyed by 0); `corrupt` moves one ok read out of
    any reachable value."""
    kw = {"value_range": 32} if kind == "set" else {}
    ops = list(random_valid_history(random.Random(seed), kind, n_ops=n_ops,
                                    n_procs=3, crash_p=0.1, **kw))
    if kind == "list-append":
        ops = [op.replace(value=(0, op.value)) for op in ops]
    if corrupt:
        reads = [j for j, op in enumerate(ops) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        j = reads[len(reads) // 2]
        ops[j] = ops[j].replace(value=ops[j].value + 7)
    return [op.to_dict() for op in ops]


# ---------------------------------------------------------------- frames


@pytest.mark.parametrize("rung", ["linearizable", "sequential"])
@pytest.mark.parametrize("kind", KINDS)
def test_submit_frame_bytes_equal_reference(kind, rung):
    """The same admitted submission packed by both packages: identical
    bytes, with and without the optional header fields."""
    hs = [_rows(kind, 10 + i) for i in range(2)]
    theirs = ref_request.admit(hs, kind, consistency=rung)
    ours = port_request.admit(hs, kind, consistency=rung)
    labels = [lab for lab, _ in theirs.units]
    for kw in ({}, {"deadline_ms": 1500.0, "priority": 3,
                    "fingerprint": theirs.fingerprint}):
        want = ref_frame.encode_submit_frame(kind, "auto", rung, labels,
                                             theirs.encs, **kw)
        got = port_frame.encode_submit_frame(kind, "auto", rung, labels,
                                             ours.encs, **kw)
        assert got == want


def test_segment_frame_bytes_equal_reference():
    """A binary stream's segments (the port's incremental encoder's
    settled suffixes and counters) pack to the reference's bytes."""
    m = MODELS["cas-register"]()
    rows = _rows("register", 30, n_ops=40)
    enc = IncrementalEncoder(m)
    ops = list(port_request.history_from_dicts(rows))
    for seq, lo in enumerate(range(0, len(ops), 15), 1):
        final = lo + 15 >= len(ops)
        ev, oi, pr = enc.feed(ops[lo:lo + 15], final=final)
        units = [{"events": ev, "op_index": oi, "proc": pr,
                  "n_slots": enc.n_slots, "n_ops": enc.n_ops,
                  "consumed": enc.consumed, "final": final}]
        assert port_frame.encode_segment_frame("s1", seq, units) == \
            ref_frame.encode_segment_frame("s1", seq, units)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_frame_decodes_in_the_port(kind):
    """A frame the reference encoded: the port decodes the same labels
    and arrays, and admits it to the reference's fingerprint."""
    hs = [_rows(kind, 50 + i) for i in range(2)]
    theirs = ref_request.admit(hs, kind)
    labels = [lab for lab, _ in theirs.units]
    raw = ref_frame.encode_submit_frame(kind, "auto", "linearizable",
                                        labels, theirs.encs,
                                        fingerprint=theirs.fingerprint)
    fr = port_frame.decode_frame(raw)
    assert (fr.workload, fr.labels, fr.fingerprint) == \
        (kind, labels, theirs.fingerprint)
    for a, b in zip(fr.encs, theirs.encs):
        np.testing.assert_array_equal(a.events, b.events)
        np.testing.assert_array_equal(a.op_index, b.op_index)
        assert (a.n_slots, a.n_ops) == (b.n_slots, b.n_ops)
    req = admit_frame(raw)
    assert req.fingerprint == theirs.fingerprint
    assert "fingerprint_mismatch" not in req.stats


@pytest.mark.parametrize("damage", ["torn", "rot", "magic"])
def test_damaged_frames_are_refused(damage):
    hs = [_rows("register", 60)]
    req = port_request.admit(hs, "register")
    raw = bytearray(port_frame.encode_submit_frame(
        "register", "auto", "linearizable", ["h0"], req.encs))
    if damage == "torn":
        raw = raw[:-7]
    elif damage == "rot":
        raw[len(raw) // 2] ^= 0x40
    else:
        raw[0:4] = b"XXXX"
    with pytest.raises(port_frame.FrameError):
        port_frame.decode_frame(bytes(raw))
    with pytest.raises(ref_frame.FrameError):
        ref_frame.decode_frame(bytes(raw))


# --------------------------------------------------------------- records


def test_reference_submit_record_decodes_in_the_port():
    """A reference submit record (as its WAL holds it, JSON round trip)
    rebuilds in the port with the same encodings and identity; the
    terminal record of a clean DONE is the reference's."""
    hs = [_rows("counter", 70 + i) for i in range(2)]
    ref_req = ref_request.admit(hs, "counter", consistency="sequential")
    rec = json.loads(json.dumps(ref_journal.encode_submit(ref_req)))
    got = port_journal.decode_request(rec)
    assert (got.id, got.workload, type(got.model).__name__, got.algorithm,
            got.consistency, got.fingerprint, got.replayed) == \
        (ref_req.id, "counter", "Counter", "auto", "sequential",
         ref_req.fingerprint, True)
    for a, b in zip(got.encs, ref_req.encs):
        np.testing.assert_array_equal(a.events, b.events)
        np.testing.assert_array_equal(a.proc, b.proc)
    assert port_request.fingerprint_encodings(
        got.model, "auto", got.encs, "sequential") == ref_req.fingerprint
    results = [{"valid?": True, "decided-tier": "mask"}] * 2
    ref_req.finish("done", results=results)
    got.finish("done", results=results)
    assert port_journal.encode_terminal(got) == \
        ref_journal.encode_terminal(ref_req)


def test_torn_tail_costs_one_record(tmp_path):
    """A torn last line in the port's journal: the intact records
    replay, the torn one is counted."""
    j = port_journal.AdmissionJournal(tmp_path)
    reqs = [port_request.admit([_rows("register", 80 + i)], "register")
            for i in range(3)]
    for r in reqs:
        j.append_submit(r)
    j.close()
    raw = (tmp_path / "wal.jsonl").read_bytes()
    (tmp_path / "wal.jsonl").write_bytes(raw[:-40])
    out = port_journal.AdmissionJournal(tmp_path).replay()
    assert [r.id for r in out["unfinished"]] == [r.id for r in reqs[:2]]
    assert out["skipped"] == 1


# ----------------------------------------------------------- cross-replay


def _submissions():
    out = []
    for i in range(3):
        out.append(("register", [_rows("register", 90 + 2 * i + k,
                                       corrupt=(i + k) % 3 == 1)
                                 for k in range(2)]))
    out.append(("counter", [_rows("counter", 99)]))
    return out


def _hold(service, subs):
    """Admit `subs` to a service that never runs them (autostart off),
    then drop it without a shutdown: its WAL holds the submit records and
    no terminal marker, as a crash leaves it."""
    ids = [service.submit(s, workload=w).id for w, s in subs]
    service._journal.close()
    return ids


def _replay(service, ids):
    try:
        out = []
        for rid in ids:
            r = service.get(rid)
            assert r is not None and r.wait(WAIT_S), rid
            assert r.replayed
            out.append([(x["valid?"], x["decided-tier"])
                        for x in r.results])
        assert service.stats()["recovered_requests"] == len(ids)
        return out
    finally:
        service.shutdown()


def test_reference_wal_replays_in_the_port(tmp_path):
    """The reference's daemon admits and holds; the port's daemon on the
    WAL replays every request with the verdicts the reference's daemon
    gives replaying a copy of the same WAL."""
    subs = _submissions()
    ids = _hold(RefService(journal_dir=str(tmp_path / "ref"),
                           autostart=False), subs)
    shutil.copytree(tmp_path / "ref", tmp_path / "copy")
    ours = _replay(CheckingService(journal_dir=str(tmp_path / "ref"),
                                   device="cpu", batch_wait=0.0), ids)
    theirs = _replay(RefService(journal_dir=str(tmp_path / "copy"),
                                batch_wait=0.0), ids)
    assert ours == theirs
    assert (False, "dense") in [u for r in ours for u in r]


def test_port_wal_replays_in_the_reference(tmp_path):
    """The reverse: a WAL the port's daemon wrote replays in the
    reference's daemon with the port's own replayed verdicts."""
    subs = _submissions()
    ids = _hold(CheckingService(journal_dir=str(tmp_path / "port"),
                                device="cpu", autostart=False), subs)
    shutil.copytree(tmp_path / "port", tmp_path / "copy")
    theirs = _replay(RefService(journal_dir=str(tmp_path / "port"),
                                batch_wait=0.0), ids)
    ours = _replay(CheckingService(journal_dir=str(tmp_path / "copy"),
                                   device="cpu", batch_wait=0.0), ids)
    assert ours == theirs
