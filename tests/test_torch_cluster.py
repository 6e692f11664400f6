"""The port's cluster tier (`service.store`, `service.cluster`, the
cluster branches of `service.daemon`, the detail exchange of
`parallel.distributed.run_sharded`) against the reference's, on the CPU.

Every class of the reference's tests/test_cluster.py, on the port:
N `CheckingService` replicas (``device="cpu"``: the kernels' plain
versions) share one cluster dir; faults are injected in process (journal
handles dropped, leases left to expire). A fingerprint checked on one
replica answers on another with no batch; a dead replica's WAL is claimed
by exactly one survivor and every accepted entry reaches the verdict a
direct check gives; corrupt entries and torn leases cost one entry; a
degraded verdict never reaches another replica; without a cluster dir
the daemon is a single replica.

Across packages (the formats are the reference's):

* store entries and detail records: the same bytes from either
  package's `ResultStore`, each read by the other's;
* leases: each package reads the other's, and a port lease is the
  reference's canonical serialisation;
* `detail_fingerprint` equal for the same encodings;
* a port replica answers from a reference replica's store entry and the
  reference's from the port's, with no batch;
* a port survivor adopts a dead reference replica's WAL and answers
  with the reference's `check_histories` verdicts; a request under an
  algorithm the port does not offer ("jax") is not deleted: the claimed
  dir stays, and a reference replica later claims and checks it;
* `/stats` carries the reference's cluster keys.

On a card (faked here, as tests/test_torch_service.py does): a failed
adopted check fails its request, never degraded; a replica whose
kernels do not build raises before it joins.

Tolerance: exact equality (booleans, tier names, bytes, hex digests).
Leases: TTLs of 0.1-5 s, every wait bounded by its own deadline.
"""

import contextlib
import json
import os
import random
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check_histories
from jepsen_jgroups_raft_tpu.history.packing import \
    encode_history as ref_encode
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu.service import CheckingService as RefService
from jepsen_jgroups_raft_tpu.service import ResultStore as RefStore
from jepsen_jgroups_raft_tpu.service import cluster as ref_cluster
from jepsen_jgroups_raft_tpu.service import request as ref_request
from jepsen_jgroups_raft_tpu.service import store as ref_store
from jepsen_jgroups_raft_tpu_torch.checker import linearizable as lin
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.history.synth import (build_history,
                                                         random_valid_history)
from jepsen_jgroups_raft_tpu_torch.models import MODELS, CasRegister
from jepsen_jgroups_raft_tpu_torch.ops import _build
from jepsen_jgroups_raft_tpu_torch.parallel import distributed
from jepsen_jgroups_raft_tpu_torch.service import (CheckingService,
                                                   QueueFull, ResultStore,
                                                   ServiceClient,
                                                   ServiceError,
                                                   serve_in_thread)
from jepsen_jgroups_raft_tpu_torch.service.cluster import (lease_expired,
                                                           live_replicas,
                                                           read_lease)
from jepsen_jgroups_raft_tpu_torch.service.request import history_from_dicts
from jepsen_jgroups_raft_tpu_torch.service.store import (
    _crc_entry, detail_fingerprint, is_degraded)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0  # upper bound on one request, not a sleep


def valid_hist(n_ops=20, seed=7):
    """Op-dict rows of a valid register history (3 processes)."""
    return random_valid_history(random.Random(seed), "register",
                                n_ops=n_ops, crash_p=0.0).to_dicts()


def invalid_hist(n_ops=20, salt=0):
    """Op-dict rows of a register history whose last read is impossible."""
    rows = []
    for i in range(n_ops - 1):
        v = salt * 100_000 + i
        rows += [(0, "invoke", "write", v), (0, "ok", "write", v)]
    rows += [(1, "invoke", "read", None), (1, "ok", "read", -7)]
    return build_history(rows).to_dicts()


def direct(hists):
    """The port's one-shot verdicts of op-dict histories."""
    return [r["valid?"] for r in check_histories(
        [history_from_dicts(h) for h in hists], CasRegister(), device="cpu")]


def make_replica(cluster_dir, rid, **kw):
    kw.setdefault("store_root", None)
    kw.setdefault("batch_wait", 0.0)
    kw.setdefault("lease_ttl_s", 5.0)
    kw.setdefault("device", "cpu")
    return CheckingService(cluster_dir=str(cluster_dir), replica_id=rid,
                           **kw)


def make_ref_replica(cluster_dir, rid, **kw):
    kw.setdefault("store_root", None)
    kw.setdefault("batch_wait", 0.0)
    kw.setdefault("lease_ttl_s", 5.0)
    return RefService(cluster_dir=str(cluster_dir), replica_id=rid, **kw)


def wait_for(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


RESULTS = [{"valid?": True, "algorithm": "torch", "op-count": 4,
            "counterexample": {"minimal-op-count": 2,
                               "ops": [{"f": "write", "value": 1}]}}]


# ------------------------------------------------------------ ResultStore


class TestResultStore:
    def test_roundtrip_preserves_full_results(self, tmp_path):
        store = ResultStore(tmp_path)
        assert store.put("ab" * 32, RESULTS) is True
        got = store.get("ab" * 32)
        assert got == RESULTS
        assert got is not RESULTS and got[0] is not RESULTS[0]  # copies

    def test_miss_is_none(self, tmp_path):
        assert ResultStore(tmp_path).get("cd" * 32) is None

    def test_degraded_never_stored(self, tmp_path):
        store = ResultStore(tmp_path)
        bad = [dict(RESULTS[0], **{"platform-degraded": "host ladder"})]
        assert is_degraded(bad)
        assert store.put("ab" * 32, bad) is False
        assert store.get("ab" * 32) is None
        assert store.put_detail("ab" * 32, bad[0]) is False
        assert store.get_detail("ab" * 32) is None

    def test_torn_tail_skipped_loudly_then_healed(self, tmp_path, caplog):
        store = ResultStore(tmp_path)
        fp = "ab" * 32
        store.put(fp, RESULTS)
        path = store._entry_path("results", fp)
        raw = path.read_bytes()
        path.write_bytes(raw[:len(raw) // 2])  # torn tail
        with caplog.at_level("WARNING", logger="jgraft.service"):
            assert store.get(fp) is None
        assert any("corrupt entry" in r.message for r in caplog.records)
        assert store.stats()["store_corrupt_skipped"] == 1
        assert store.put(fp, RESULTS) is True  # heal via atomic replace
        assert store.get(fp) == RESULTS

    def test_crc_mismatch_skipped(self, tmp_path):
        store = ResultStore(tmp_path)
        fp = "ab" * 32
        store.put(fp, RESULTS)
        path = store._entry_path("results", fp)
        rec = json.loads(path.read_bytes())
        rec["results"][0]["valid?"] = False  # rot the payload, keep crc
        path.write_text(json.dumps(rec))
        assert store.get(fp) is None
        assert store.stats()["store_corrupt_skipped"] == 1

    def test_newer_version_skipped_not_misparsed(self, tmp_path):
        store = ResultStore(tmp_path)
        fp = "ab" * 32
        rec = {"v": 99, "fingerprint": fp, "results": RESULTS}
        rec["crc"] = _crc_entry(rec)
        path = store._entry_path("results", fp)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec))
        assert store.get(fp) is None
        assert store.stats()["store_corrupt_skipped"] == 1

    def test_first_wins_loser_discards(self, tmp_path):
        store = ResultStore(tmp_path)
        fp = "ab" * 32
        assert store.put(fp, RESULTS) is True
        other = [{"valid?": False, "algorithm": "torch"}]
        assert store.put(fp, other) is False  # discarded, not replaced
        assert store.get(fp) == RESULTS
        assert store.stats()["store_put_discards"] == 1

    def test_concurrent_writer_race_one_valid_entry(self, tmp_path):
        """Two writers racing one fingerprint: the entry is whole and
        valid (atomic temp+replace), and one writer saw the other."""
        fp = "ab" * 32
        payloads = [[{"valid?": True, "writer": k}] for k in range(2)]
        stores = [ResultStore(tmp_path) for _ in range(2)]
        barrier = threading.Barrier(2)

        def racer(k):
            barrier.wait()
            for _ in range(50):
                stores[k].put(fp, payloads[k])

        ts = [threading.Thread(target=racer, args=(k,)) for k in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert stores[0].get(fp) in payloads
        counts = [s.stats() for s in stores]
        assert sum(c["store_put_discards"] for c in counts) >= 1
        assert all(c["store_corrupt_skipped"] == 0 for c in counts)

    def test_detail_records_roundtrip(self, tmp_path):
        store = ResultStore(tmp_path)
        model = CasRegister()
        enc = encode_history(history_from_dicts(valid_hist()), model)
        key = detail_fingerprint(model, "auto", enc)
        assert key == detail_fingerprint(model, "auto", enc)  # stable
        enc2 = encode_history(history_from_dicts(valid_hist(seed=9)), model)
        assert key != detail_fingerprint(model, "auto", enc2)
        assert store.put_detail(key, RESULTS[0]) is True
        assert store.get_detail(key) == RESULTS[0]

    @pytest.mark.parametrize("kind", ["results", "detail"])
    def test_entries_are_the_reference_bytes_both_ways(self, tmp_path,
                                                       kind):
        """The same entry from either package's store is the same file;
        each package reads the entry the other wrote."""
        fp = "ef" * 32
        ours, theirs = ResultStore(tmp_path / "p"), RefStore(tmp_path / "r")
        if kind == "results":
            assert ours.put(fp, RESULTS) and theirs.put(fp, RESULTS)
        else:
            assert ours.put_detail(fp, RESULTS[0])
            assert theirs.put_detail(fp, RESULTS[0])
        mine = ours._entry_path(kind, fp)
        assert mine.read_bytes() == theirs._entry_path(kind, fp).read_bytes()
        assert mine.relative_to(tmp_path / "p") == \
            theirs._entry_path(kind, fp).relative_to(tmp_path / "r")
        cross_ours, cross_theirs = ResultStore(tmp_path / "r"), \
            RefStore(tmp_path / "p")
        if kind == "results":
            assert cross_ours.get(fp) == cross_theirs.get(fp) == RESULTS
        else:
            assert cross_ours.get_detail(fp) == \
                cross_theirs.get_detail(fp) == RESULTS[0]
        assert _crc_entry({"a": 1}) == ref_store._crc_entry({"a": 1})

    @pytest.mark.parametrize("kind,algorithm", [
        ("cas-register", "auto"), ("cas-register", "dense"),
        ("counter", "auto"), ("queue", "auto"), ("set", "auto")])
    def test_detail_fingerprint_equals_reference(self, kind, algorithm):
        synth = {"cas-register": "register"}.get(kind, kind)
        kw = {"value_range": 32} if kind == "set" else {}
        for seed in range(3):
            h = random_valid_history(random.Random(seed), synth, n_ops=30,
                                     n_procs=3, crash_p=0.1, **kw)
            rh = ref_request.history_from_dicts(h.to_dicts())
            got = detail_fingerprint(MODELS[kind](), algorithm,
                                     encode_history(h, MODELS[kind]()))
            want = ref_store.detail_fingerprint(
                REF_MODELS[kind](), algorithm,
                ref_encode(rh, REF_MODELS[kind]()))
            assert got == want


# ------------------------------------------------------- leases and skew


class TestLeases:
    def test_renew_and_read(self, tmp_path):
        svc = make_replica(tmp_path, "ra", autostart=False)
        lease = read_lease(tmp_path / "leases" / "ra.json")
        assert lease is not None and lease["replica"] == "ra"
        assert not lease_expired(lease, skew_s=0.0)
        assert [x["replica"] for x in live_replicas(tmp_path)] == ["ra"]
        svc.shutdown()
        # clean shutdown removes the lease — nothing advertises a ghost
        assert read_lease(tmp_path / "leases" / "ra.json") is None

    def test_expiry_is_one_sided_under_clock_skew(self):
        now = 1_000_000.0
        lease = {"renewed_wall": now - 10.0, "ttl_s": 5.0}
        assert not lease_expired(lease, now=now, skew_s=6.0)
        assert lease_expired(lease, now=now, skew_s=4.0)
        future = {"renewed_wall": now + 30.0, "ttl_s": 5.0}
        assert not lease_expired(future, now=now, skew_s=0.0)

    def test_corrupt_lease_skipped_loudly(self, tmp_path, caplog):
        svc = make_replica(tmp_path, "ra", autostart=False)
        (tmp_path / "leases" / "rb.json").write_text("{torn", "utf-8")
        (tmp_path / "leases" / "rc.json").write_text(
            json.dumps({"v": 1, "replica": "rc", "renewed_wall": 1.0,
                        "ttl_s": 5.0, "crc": "00000000"}))  # bad crc
        with caplog.at_level("WARNING", logger="jgraft.service"):
            live = live_replicas(tmp_path)
        assert [x["replica"] for x in live] == ["ra"]
        assert sum("lease" in r.message for r in caplog.records) >= 2
        svc.shutdown()

    def test_leases_cross_packages(self, tmp_path):
        """A port replica's lease is the reference's canonical bytes and
        the reference reads it; the port reads a reference replica's."""
        ours = make_replica(tmp_path, "ra", autostart=False)
        theirs = make_ref_replica(tmp_path, "rb", autostart=False)
        try:
            raw = (tmp_path / "leases" / "ra.json").read_bytes()
            rec = json.loads(raw)
            assert raw == json.dumps(rec, sort_keys=True,
                                     separators=(",", ":")).encode()
            ref_rec = ref_cluster.read_lease(tmp_path / "leases" / "rb.json")
            assert set(rec) == set(ref_rec)
            assert ref_cluster.read_lease(tmp_path / "leases" / "ra.json") \
                == read_lease(tmp_path / "leases" / "ra.json")
            assert read_lease(tmp_path / "leases" / "rb.json") == ref_rec
            assert [x["replica"] for x in live_replicas(tmp_path)] == \
                [x["replica"] for x in ref_cluster.live_replicas(tmp_path)] \
                == ["ra", "rb"]
        finally:
            ours.shutdown()
            theirs.shutdown()


# ------------------------------------------------- cross-replica caching


class TestSharedStore:
    def test_replica_b_answers_replica_a_fingerprint(self, tmp_path):
        """Replica B completes a fingerprint first checked on replica A
        at ADMISSION — store hit, zero batches, full results — with the
        verdicts of a direct check."""
        hists = [valid_hist(seed=3), invalid_hist(salt=3)]
        want = direct(hists)
        a = make_replica(tmp_path, "ra")
        try:
            reqs = [a.submit([h], workload="register") for h in hists]
            for r in reqs:
                assert r.wait(WAIT_S)
            wait_for(lambda: a.stats()["store_puts"] >= 2, a.stats())
        finally:
            a.shutdown()
        b = make_replica(tmp_path, "rb")
        try:
            outs = [b.submit([h], workload="register") for h in hists]
            assert all(o.status == "done" and o.cached for o in outs)
            st = b.stats()
            assert st["store_hits"] == 2 and st["batches"] == 0, st
            assert [o.verdict() for o in outs] == want
            assert all(o.results for o in outs)
        finally:
            b.shutdown()

    def test_degraded_verdicts_never_cross_replicas(self, tmp_path):
        """A batch that degraded to the host ladder completes locally
        (stamped) and never becomes a fleet-wide cache entry."""
        calls = {"n": 0}

        def flaky(encs, model, algorithm="auto", **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device failure")
            return lin.check_encoded(encs, model, algorithm=algorithm, **kw)

        a = make_replica(tmp_path, "ra", check_fn=flaky)
        try:
            req = a.submit([valid_hist(seed=5)], workload="register")
            assert req.wait(WAIT_S) and req.status == "done"
            assert all("platform-degraded" in r for r in req.results)
            assert a.stats()["store_puts"] == 0
        finally:
            a.shutdown()
        assert not list((tmp_path / "results").rglob("*.json"))
        b = make_replica(tmp_path, "rb", check_fn=flaky)
        try:
            out = b.submit([valid_hist(seed=5)], workload="register")
            assert out.wait(WAIT_S) and out.status == "done"
            assert not out.cached  # re-checked, not served the stamp
            assert b.stats()["store_hits"] == 0
        finally:
            b.shutdown()

    def test_recovery_warms_from_store_without_rechecking(self, tmp_path):
        """A cold-restarted replica whose WAL holds unfinished entries
        short-circuits every fingerprint the fleet already verified."""
        h = valid_hist(seed=6)
        b = make_replica(tmp_path, "rb", autostart=False, lease_ttl_s=300.0)
        queued = b.submit([h], workload="register")
        assert queued.status == "queued"
        b._journal.close()
        a = make_replica(tmp_path, "ra")
        try:
            assert a.submit([h], workload="register").wait(WAIT_S)
            wait_for(lambda: a.stats()["store_puts"] >= 1, a.stats())
        finally:
            a.shutdown()
        b2 = make_replica(tmp_path, "rb", autostart=False, lease_ttl_s=300.0)
        try:
            st = b2.stats()
            assert st["recovered_requests"] == 0, st  # nothing requeued
            assert st["store_hits"] == 1 and st["batches"] == 0, st
            out = b2.get(queued.id)
            assert out is not None and out.status == "done"
            assert out.verdict() is True
        finally:
            b2.shutdown()

    def test_store_serves_across_packages(self, tmp_path):
        """The reference's replica answers at admission from a verdict
        the port's replica published, and the port's from the
        reference's, each with the writer's results and no batch."""
        h_port, h_ref = valid_hist(seed=14), invalid_hist(salt=14)
        a = make_replica(tmp_path, "ra")
        try:
            first = a.submit([h_port], workload="register")
            assert first.wait(WAIT_S) and first.status == "done"
            wait_for(lambda: a.stats()["store_puts"] >= 1, a.stats())
        finally:
            a.shutdown()
        # a verdict the reference computed, published by its store
        fp = ref_request.admit([h_ref], "register").fingerprint
        ref_results = [{"valid?": False, "algorithm": "jax",
                        "kernel": "dense", "op-count": 20}]
        assert RefStore(tmp_path).put(fp, ref_results)
        theirs = make_ref_replica(tmp_path, "rb")
        ours = make_replica(tmp_path, "rc")
        try:
            got = theirs.submit([h_port], workload="register")
            assert got.status == "done" and got.cached
            assert got.results == first.results
            assert theirs.stats()["store_hits"] == 1
            mine = ours.submit([h_ref], workload="register")
            assert mine.status == "done" and mine.cached
            assert mine.results == ref_results  # the writer's tags stay
            st = ours.stats()
            assert st["store_hits"] == 1 and st["batches"] == 0
        finally:
            theirs.shutdown()
            ours.shutdown()


# --------------------------------------------------------------- handoff


class TestJournalHandoff:
    def _accept_and_die(self, tmp_path, rid, hists, factory=make_replica,
                        algorithm="auto"):
        """A replica that accepts `hists` and dies with everything still
        pending: autostart=False (no worker, no heartbeat), journal
        handle dropped; its lease expires on its own."""
        svc = factory(tmp_path, rid, autostart=False, lease_ttl_s=0.1)
        reqs = [svc.submit([h], workload="register", algorithm=algorithm)
                for h in hists]
        assert all(r.status == "queued" for r in reqs)
        svc._journal.close()
        return svc, reqs

    def test_survivor_adopts_and_finishes(self, tmp_path, monkeypatch):
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        hists = [valid_hist(seed=21), invalid_hist(salt=21),
                 valid_hist(seed=22)]
        want = direct(hists)
        _dead, reqs = self._accept_and_die(tmp_path, "ra", hists)
        time.sleep(0.2)  # ttl 0.1 + skew 0.05 — the lease expires
        b = make_replica(tmp_path, "rb")
        try:
            assert b.cluster.handoff_scan() == 1
            adopted = [b.get(r.id) for r in reqs]
            assert all(x is not None for x in adopted)
            for x in adopted:
                assert x.wait(WAIT_S) and x.status == "done"
            assert [x.verdict() for x in adopted] == want
            st = b.stats()
            assert st["handoff_claims"] == 1
            assert st["handoff_requests"] == len(hists)
            assert sorted(p.name for p in
                          (tmp_path / "journal").iterdir()) == ["rb"]
            assert sorted(p.name for p in
                          (tmp_path / "leases").glob("*.json")) \
                == ["rb.json"]
        finally:
            b.shutdown()

    def test_claim_is_exclusive_under_race(self, tmp_path, monkeypatch):
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        self._accept_and_die(tmp_path, "ra", [valid_hist(seed=31)])
        time.sleep(0.2)
        b = make_replica(tmp_path, "rb")
        c = make_replica(tmp_path, "rc")
        try:
            barrier = threading.Barrier(2)
            claims = [0, 0]

            def scan(k, svc):
                barrier.wait()
                claims[k] = svc.cluster.handoff_scan()

            ts = [threading.Thread(target=scan, args=(0, b)),
                  threading.Thread(target=scan, args=(1, c))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert sum(claims) == 1, claims
            assert (b.stats()["handoff_claims"]
                    + c.stats()["handoff_claims"]) == 1
        finally:
            b.shutdown()
            c.shutdown()

    def test_claim_is_exclusive_under_stress(self, tmp_path, monkeypatch):
        """Eight survivors (more than this host's workers) scan at once
        with a shortened switch interval: one claims the dead WAL, every
        request is adopted once, and no claim dir is left."""
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        _dead, reqs = self._accept_and_die(
            tmp_path, "ra", [valid_hist(seed=35 + i) for i in range(3)])
        time.sleep(0.2)
        survivors = [make_replica(tmp_path, f"s{k}", autostart=False)
                     for k in range(8)]
        barrier = threading.Barrier(len(survivors))
        claims = [0] * len(survivors)

        def scan(k):
            barrier.wait()
            claims[k] = survivors[k].cluster.handoff_scan()

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ts = [threading.Thread(target=scan, args=(k,))
                  for k in range(len(survivors))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert not any(t.is_alive() for t in ts)
        finally:
            sys.setswitchinterval(old)
            for svc in survivors:
                svc.shutdown()
        assert sum(claims) == 1, claims
        assert sum(svc.stats()["handoff_requests"] for svc in survivors) \
            == len(reqs)
        assert not [p for p in (tmp_path / "journal").iterdir()
                    if ".claim." in p.name]

    def test_adopted_duplicate_attaches_not_reexecutes(self, tmp_path,
                                                       monkeypatch):
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        h = valid_hist(seed=41)
        svc = make_replica(tmp_path, "ra", autostart=False, lease_ttl_s=0.1)
        first = svc.submit([h], workload="register")
        dup = svc.submit([h], workload="register")
        assert dup.attached_to == first.id
        svc._journal.close()
        time.sleep(0.2)
        b = make_replica(tmp_path, "rb")
        try:
            assert b.cluster.handoff_scan() == 1
            out_p, out_d = b.get(first.id), b.get(dup.id)
            assert out_p.wait(WAIT_S) and out_d.wait(WAIT_S)
            assert out_p.status == "done" and out_d.status == "done"
            assert out_p.verdict() is True and out_d.verdict() is True
            st = b.stats()
            assert st["handoff_requests"] == 2
            assert st["batches"] <= 1  # one execution for both
        finally:
            b.shutdown()

    def test_restart_republishes_lease_before_heartbeat(self, tmp_path):
        a = make_replica(tmp_path, "ra", autostart=False)
        a.shutdown()
        assert read_lease(tmp_path / "leases" / "ra.json") is None
        a.start()
        try:
            lease = read_lease(tmp_path / "leases" / "ra.json")
            assert lease is not None and not lease_expired(lease)
            b = make_replica(tmp_path, "rb")
            try:
                assert b.cluster.handoff_scan() == 0  # ra is LIVE
            finally:
                b.shutdown()
        finally:
            a.shutdown()

    def test_legacy_journal_migrates_when_clustering_enabled(
            self, tmp_path):
        store, cdir = tmp_path / "store", tmp_path / "clu"
        s1 = CheckingService(store_root=str(store), name="graftd",
                             batch_wait=0.0, autostart=False, device="cpu")
        req = s1.submit([valid_hist(seed=55)], workload="register")
        s1._journal.close()
        legacy = store / "graftd" / "journal" / "wal.jsonl"
        assert legacy.exists()
        s2 = CheckingService(store_root=str(store), name="graftd",
                             cluster_dir=str(cdir), replica_id="up",
                             batch_wait=0.0, lease_ttl_s=5.0, device="cpu")
        try:
            assert not legacy.exists()
            out = s2.get(req.id)
            assert out is not None and out.wait(WAIT_S)
            assert out.status == "done" and out.verdict() is True
            assert s2.stats()["recovered_requests"] == 1
        finally:
            s2.shutdown()

    def test_live_lease_is_never_claimed(self, tmp_path):
        a = make_replica(tmp_path, "ra", autostart=False)
        a.submit([valid_hist(seed=51)], workload="register")
        b = make_replica(tmp_path, "rb")
        try:
            assert b.cluster.handoff_scan() == 0
            assert (tmp_path / "journal" / "ra").exists()
        finally:
            b.shutdown()
            a.shutdown()

    def test_port_survivor_adopts_a_reference_replicas_wal(
            self, tmp_path, monkeypatch):
        """A reference replica accepts three requests and dies; a port
        replica claims its WAL and answers every original id with the
        reference's `check_histories` verdicts."""
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        hists = [valid_hist(seed=61), invalid_hist(salt=61),
                 valid_hist(seed=62)]
        want = [r["valid?"] for r in ref_check_histories(
            [ref_request.history_from_dicts(h) for h in hists],
            REF_MODELS["cas-register"]())]
        assert want == direct(hists)
        _dead, reqs = self._accept_and_die(tmp_path, "ra", hists,
                                           factory=make_ref_replica)
        time.sleep(0.2)
        b = make_replica(tmp_path, "rb")
        try:
            assert b.cluster.handoff_scan() == 1
            adopted = [b.get(r.id) for r in reqs]
            for x in adopted:
                assert x is not None and x.wait(WAIT_S)
                assert x.status == "done"
                assert x.fingerprint == reqs[adopted.index(x)].fingerprint
            assert [x.verdict() for x in adopted] == want
            assert b.stats()["handoff_requests"] == 3
            assert sorted(p.name for p in
                          (tmp_path / "journal").iterdir()) == ["rb"]
        finally:
            b.shutdown()

    def test_jax_record_keeps_its_claimed_dir(self, tmp_path, monkeypatch):
        """A dead reference replica's WAL holds one request under
        "jax", which the port does not offer, and one under "auto". The
        port survivor adopts and checks the "auto" one, keeps the
        claimed dir (nothing it could not take is deleted) and does not
        re-adopt it; once the survivor dies too, a reference replica
        claims the dir and checks the "jax" request."""
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        dead = make_ref_replica(tmp_path, "ra", autostart=False,
                                lease_ttl_s=0.1)
        jax_req = dead.submit([invalid_hist(salt=71)], workload="register",
                              algorithm="jax")
        auto_req = dead.submit([valid_hist(seed=71)], workload="register")
        dead._journal.close()
        time.sleep(0.2)
        b = make_replica(tmp_path, "rb")
        try:
            assert b.cluster.handoff_scan() == 1
            out = b.get(auto_req.id)
            assert out is not None and out.wait(WAIT_S)
            assert out.status == "done" and out.verdict() is True
            assert b.get(jax_req.id) is None
            kept = tmp_path / "journal" / "ra.claim.rb"
            assert (kept / "wal.jsonl").exists()
            assert b.cluster.handoff_scan() == 0  # kept, not re-adopted
            st = b.stats()
            assert st["handoff_requests"] == 1 and st["handoff_claims"] == 1
        finally:
            # the survivor dies: its heartbeat stops after a last lease
            # of 0.1 s, which is left to expire
            b.cluster._stop.set()
            b.cluster._thread.join(10)
            b.cluster.lease_ttl = 0.1
            b.cluster.renew_lease()
        time.sleep(0.3)
        c = make_ref_replica(tmp_path, "rc")
        try:
            assert c.cluster.handoff_scan() >= 1
            got = c.get(jax_req.id)
            assert got is not None and got.wait(120)
            assert got.status == "done" and got.verdict() is False
            assert not kept.exists()
        finally:
            c.shutdown()
            b.shutdown()


# ------------------------------------------------ the card, no fallback


def _card_replica(monkeypatch, tmp_path, rid, check, **kw):
    """A replica on the card's default check path, on a host without a
    card (tests/test_torch_service.py's `_card_service`)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda names: 0.0)
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(lin, "check_encoded", check)
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "0")
    svc = make_replica(tmp_path, rid, device="cuda", **kw)
    monkeypatch.setattr(svc.scheduler, "launch_scope",
                        contextlib.nullcontext)
    return svc


class TestCardReplicas:
    def test_failed_adopted_check_fails_its_request(self, tmp_path,
                                                    monkeypatch):
        """A request adopted by a replica on the card whose check path
        fails is failed with the cause: no degraded result, nothing in
        the shared store."""
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        dead = make_replica(tmp_path, "ra", autostart=False, lease_ttl_s=0.1)
        req = dead.submit([valid_hist(seed=81)], workload="register")
        dead._journal.close()
        time.sleep(0.2)

        def broken(encs, model, **kw):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

        b = _card_replica(monkeypatch, tmp_path, "rb", broken)
        try:
            assert b.cluster.handoff_scan() == 1
            out = b.get(req.id)
            assert out.wait(WAIT_S) and out.status == "failed"
            assert "device path failed" in out.error and out.results is None
            st = b.stats()
            assert st["degraded_batches"] == 0 and st["store_puts"] == 0
        finally:
            b.shutdown()
        assert not list((tmp_path / "results").rglob("*.json"))

    def test_adopted_check_on_the_card_path(self, tmp_path, monkeypatch):
        """The card's default path (here its plain versions) answers
        adopted requests with the direct verdicts and publishes them."""
        monkeypatch.setenv("JGRAFT_CLUSTER_SKEW_S", "0.05")
        hists = [valid_hist(seed=82), invalid_hist(salt=82)]
        want = direct(hists)
        _dead = make_replica(tmp_path, "ra", autostart=False,
                             lease_ttl_s=0.1)
        reqs = [_dead.submit([h], workload="register") for h in hists]
        _dead._journal.close()
        time.sleep(0.2)
        real = lin.check_encoded

        def on_host(encs, model, device=None, **kw):
            return real(encs, model, device="cpu", **kw)

        b = _card_replica(monkeypatch, tmp_path, "rb", on_host)
        try:
            assert b.scheduler.host_degrade is False
            assert b.cluster.handoff_scan() == 1
            outs = [b.get(r.id) for r in reqs]
            for x in outs:
                assert x.wait(WAIT_S) and x.status == "done"
            assert [x.verdict() for x in outs] == want
            assert not any("platform-degraded" in r for x in outs
                           for r in x.results)
            wait_for(lambda: b.stats()["store_puts"] >= 2, b.stats())
        finally:
            b.shutdown()

    def test_replica_whose_kernels_fail_to_build_never_joins(
            self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(_build, "nvcc_path", lambda: None)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
        before = {t.name for t in threading.enumerate()}
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            make_replica(tmp_path / "clu", "rx", device="cuda")
        assert not (tmp_path / "clu" / "leases" / "rx.json").exists()
        assert not (tmp_path / "clu" / "journal" / "rx").exists()
        assert not any(t.name.startswith("rx")
                       for t in threading.enumerate()
                       if t.name not in before)


# ----------------------------------------------------- shedding and 429s


class TestLoadShedding:
    def test_shed_answers_clusters_best_retry_after(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setenv("JGRAFT_SERVICE_SHED_DEPTH", "1")
        idle = make_replica(tmp_path, "rb")  # advertises ~0.5 s
        loaded = make_replica(tmp_path, "ra", autostart=False)
        try:
            loaded.submit([valid_hist(seed=91)], workload="register")
            with pytest.raises(QueueFull) as ei:
                loaded.submit([invalid_hist(salt=91)], workload="register")
            assert ei.value.retry_after_s == pytest.approx(0.5, abs=0.2)
            assert loaded.stats()["rejected"] == 1
        finally:
            idle.shutdown()
            loaded.shutdown()

    def test_shed_disabled_by_default(self, tmp_path):
        svc = make_replica(tmp_path, "ra", autostart=False)
        try:
            assert svc.cluster.shed_depth == 0
            for i in range(5):
                svc.submit([invalid_hist(salt=100 + i)],
                           workload="register")
            assert svc.queue.depth == 5  # nothing shed below capacity
        finally:
            svc.shutdown()


# ------------------------------------------------------- client routing


class _ScriptedTransport:
    """Replaces ServiceClient._call_once: answers per-netloc from a
    script and records every netloc the client tries."""

    def __init__(self, client, script):
        self.calls = []
        self.script = script

        def fake(method, path, body=None, netloc=None):
            self.calls.append(netloc)
            return self.script[netloc]()

        client._call_once = fake


def _raise(exc):
    def fn():
        raise exc
    return fn


class TestClientRouting:
    def _client(self, **kw):
        kw.setdefault("max_attempts", 3)
        kw.setdefault("backoff_base_s", 0.0)
        kw.setdefault("backoff_cap_s", 0.0)
        return ServiceClient("http://a:1", replicas=["http://b:2"], **kw)

    def test_attempt_cap_is_cluster_global_for_status_retries(
            self, monkeypatch):
        cl = self._client()
        full = ServiceError(429, {"error": "full", "retry_after_s": 0.0})
        tr = _ScriptedTransport(cl, {"a:1": _raise(full),
                                     "b:2": _raise(full)})
        monkeypatch.setattr(time, "sleep", lambda s: None)
        with pytest.raises(ServiceError):
            cl._call("POST", "/submit", {})
        assert len(tr.calls) == 3  # == max_attempts, NOT 3 per replica

    def test_attempt_cap_is_cluster_global_for_conn_failures(
            self, monkeypatch):
        cl = self._client()
        tr = _ScriptedTransport(cl, {
            "a:1": _raise(ConnectionError("down")),
            "b:2": _raise(ConnectionError("down"))})
        monkeypatch.setattr(time, "sleep", lambda s: None)
        with pytest.raises(ConnectionError):
            cl._call("POST", "/submit", {})
        assert len(tr.calls) == 3

    def test_retry_after_floors_the_next_replica_too(self, monkeypatch):
        sleeps = []
        monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
        cl = self._client()
        answers = iter([_raise(ServiceError(
            429, {"error": "full", "retry_after_s": 5.0}))])
        ok = {"id": "x", "status": "queued"}
        tr = _ScriptedTransport(cl, {})
        tr.script = {"a:1": lambda: next(answers)(), "b:2": lambda: ok}
        assert cl._call("POST", "/submit", {}) == ok
        assert tr.calls[0] != tr.calls[1]  # moved to the other replica
        assert sleeps and sleeps[0] >= 5.0  # floor honored across it

    def test_conn_failover_is_immediate(self, monkeypatch):
        sleeps = []
        monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
        cl = self._client()
        ok = {"id": "x", "status": "queued"}
        tr = _ScriptedTransport(cl, {
            "a:1": _raise(ConnectionError("down")), "b:2": lambda: ok})
        assert cl._call("POST", "/submit", {}) == ok
        assert len(tr.calls) == 2 and not sleeps
        assert cl.failovers == 1

    def test_affinity_routing_is_stable_and_spreads(self):
        cl = ServiceClient("http://a:1",
                           replicas=["http://b:2", "http://c:3"])
        r1 = cl._route("fingerprint-one")
        assert r1 == cl._route("fingerprint-one")  # deterministic
        heads = {cl._route(f"fp-{i}")[0] for i in range(64)}
        assert len(heads) == 3  # rendezvous spreads across the fleet

    def test_result_404_fails_over_to_the_adopting_replica(self, tmp_path):
        a = make_replica(tmp_path, "ra")
        b = make_replica(tmp_path, "rb")
        ha, pa, _ = serve_in_thread(a)
        hb, pb, _ = serve_in_thread(b)
        try:
            rec = ServiceClient(f"http://127.0.0.1:{pa}").submit(
                [valid_hist(seed=101)], workload="register")
            fleet = ServiceClient(f"http://127.0.0.1:{pb}",
                                  replicas=[f"http://127.0.0.1:{pa}"])
            out = fleet.result(rec["id"], wait_s=WAIT_S)
            assert out["status"] == "done"
            with pytest.raises(ServiceError) as ei:
                fleet.result("no-such-id")
            assert ei.value.status == 404
        finally:
            ha.shutdown(); ha.server_close()
            hb.shutdown(); hb.server_close()
            a.shutdown(); b.shutdown()

    def test_single_url_client_unchanged(self):
        cl = ServiceClient("http://a:1")
        assert cl.netlocs == ["a:1"] and cl.netloc == "a:1"
        assert cl._route("anything") == ["a:1"]


# ------------------------------------------- the detail exchange


class TestDetailExchange:
    def _fake_two_processes(self, monkeypatch, peer_code):
        monkeypatch.setattr(distributed, "process_count", lambda: 2)
        monkeypatch.setattr(distributed, "process_index", lambda: 0)

        def fake_exchange(arr, tag=None):
            import numpy as np

            return [np.asarray(arr, dtype="<i8"),
                    np.asarray([peer_code], dtype="<i8")]

        monkeypatch.setattr(distributed, "exchange_i64", fake_exchange)

    def _rows(self):
        model = CasRegister()
        hists = [valid_hist(seed=111), invalid_hist(salt=111)]
        encs = [encode_history(history_from_dicts(h), model) for h in hists]
        full = check_histories([history_from_dicts(h) for h in hists],
                               model, device="cpu")
        return model, encs, full

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_remote_rows_upgrade_from_store(self, tmp_path, monkeypatch,
                                            writer):
        """We are process 0 and own row 0; the peer published row 1's
        full result (through either package's store) before the verdict
        exchange: row 1 comes back as that result, not a stub, and our
        own row is published for the peer."""
        monkeypatch.setenv("JGRAFT_RESULT_STORE", str(tmp_path))
        model, encs, full = self._rows()
        key = detail_fingerprint(model, "auto", encs[1])
        (ResultStore if writer == "port" else RefStore)(tmp_path) \
            .put_detail(key, full[1])
        self._fake_two_processes(monkeypatch, distributed._CODE_INVALID)
        calls = []
        results = distributed.run_sharded(
            encs, lambda sub: (calls.append(len(sub)) or [dict(full[0])]),
            model=model, algorithm="auto")
        assert calls == [1]  # we checked only our shard
        remote = results[1]
        assert remote["valid?"] is False
        assert remote["detail-source"] == "result-store"
        assert remote["process"] == 1
        assert {k: v for k, v in remote.items()
                if k not in ("detail-source", "process")} == \
            json.loads(json.dumps(full[1]))
        mine = ResultStore(tmp_path).get_detail(
            detail_fingerprint(model, "auto", encs[0]))
        assert mine == json.loads(json.dumps(full[0]))

    @pytest.mark.parametrize("record", ["missing", "mismatched", "degraded"])
    def test_stub_without_a_matching_record(self, tmp_path, monkeypatch,
                                            record):
        monkeypatch.setenv("JGRAFT_RESULT_STORE", str(tmp_path))
        model, encs, full = self._rows()
        key = detail_fingerprint(model, "auto", encs[1])
        if record == "mismatched":
            ResultStore(tmp_path).put_detail(key, dict(full[1],
                                                       **{"valid?": True}))
        elif record == "degraded":
            ResultStore(tmp_path).put_detail(
                key, dict(full[1], **{"platform-degraded": "host"}))
        self._fake_two_processes(monkeypatch, distributed._CODE_INVALID)
        results = distributed.run_sharded(encs, lambda sub: [dict(full[0])],
                                          model=model, algorithm="auto")
        assert results[1] == distributed._remote_result(
            distributed._CODE_INVALID, 1)

    def test_stub_without_store(self, monkeypatch):
        monkeypatch.delenv("JGRAFT_RESULT_STORE", raising=False)
        monkeypatch.delenv("JGRAFT_SERVICE_CLUSTER_DIR", raising=False)
        store, key = distributed._detail_exchange(CasRegister(), "auto")
        assert store is None and key is None

    def test_detail_exchange_inert_without_model(self, tmp_path,
                                                 monkeypatch):
        monkeypatch.setenv("JGRAFT_RESULT_STORE", str(tmp_path))
        store, key = distributed._detail_exchange(None, "auto")
        assert store is None and key is None

    def test_cluster_dir_is_the_fallback_store(self, tmp_path, monkeypatch):
        monkeypatch.delenv("JGRAFT_RESULT_STORE", raising=False)
        monkeypatch.setenv("JGRAFT_SERVICE_CLUSTER_DIR", str(tmp_path))
        store, key = distributed._detail_exchange(CasRegister(), "auto")
        assert store is not None and store.root == tmp_path


# ------------------------------------------------------------- inertness


class TestSingleReplicaInert:
    def test_no_cluster_without_configuration(self, tmp_path, monkeypatch):
        monkeypatch.delenv("JGRAFT_SERVICE_CLUSTER_DIR", raising=False)
        svc = CheckingService(store_root=str(tmp_path), batch_wait=0.0,
                              device="cpu")
        try:
            assert svc.cluster is None
            st = svc.stats()
            assert st["cluster_enabled"] is False
            assert st["store_hits"] == 0 and st["handoff_claims"] == 0
            assert svc._journal.path == \
                tmp_path / "graftd" / "journal" / "wal.jsonl"
        finally:
            svc.shutdown()

    def test_env_seam_engages_cluster(self, tmp_path, monkeypatch):
        monkeypatch.setenv("JGRAFT_SERVICE_CLUSTER_DIR", str(tmp_path))
        monkeypatch.setenv("JGRAFT_SERVICE_REPLICA_ID", "envd")
        svc = CheckingService(store_root=None, batch_wait=0.0, device="cpu")
        try:
            assert svc.cluster is not None
            assert svc.cluster.replica_id == "envd"
            assert svc._journal is not None
            assert svc._journal.path == \
                tmp_path / "journal" / "envd" / "wal.jsonl"
            assert svc.stats()["cluster_enabled"] is True
        finally:
            svc.shutdown()

    def test_stats_keys_equal_the_reference(self, tmp_path, monkeypatch):
        """`/stats` of a replica and of a single daemon carry the
        reference's keys, the cluster's among them."""
        monkeypatch.delenv("JGRAFT_SERVICE_CLUSTER_DIR", raising=False)
        keys = {}
        for pkg, make, single in (
                ("port", make_replica,
                 lambda: CheckingService(device="cpu", autostart=False)),
                ("reference", make_ref_replica,
                 lambda: RefService(autostart=False))):
            svc, one = make(tmp_path / pkg, "r0", autostart=False), single()
            try:
                keys[pkg] = (set(svc.stats()), set(one.stats()))
            finally:
                svc.shutdown()
                one.shutdown()
        assert keys["port"] == keys["reference"]
        cluster_keys = keys["port"][0] - keys["port"][1]
        assert {"replica_id", "live_replicas", "shed_depth",
                "store_get_hits", "store_put_writes"} <= cluster_keys
        assert {"store_hits", "store_puts", "handoff_claims",
                "handoff_requests", "handoff_streams",
                "cluster_enabled"} <= keys["port"][1]


def test_cli_replica_advertises_its_bound_url(tmp_path):
    """`serve-checker --cluster-dir D --replica-id R` (on the CPU, port
    0) publishes a lease whose url is the bound address, answers /stats
    there as that replica, and removes the lease on SIGINT."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_jgroups_raft_tpu_torch",
         "serve-checker", "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0", "--store", str(tmp_path / "store"),
         "--cluster-dir", str(tmp_path / "clu"), "--replica-id", "cli0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lease_path = tmp_path / "clu" / "leases" / "cli0.json"
    try:
        deadline = time.monotonic() + WAIT_S
        while True:
            lease = read_lease(lease_path)
            if lease is not None and lease.get("url"):
                break
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "no advertised url"
            time.sleep(0.05)
        assert lease["url"].startswith("http://127.0.0.1:")
        assert not lease["url"].endswith(":0")
        st = ServiceClient(lease["url"]).stats()
        assert st["cluster_enabled"] is True and st["replica_id"] == "cli0"
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
    assert proc.returncode == 0, out
    assert "cluster=cli0" in out
    assert not lease_path.exists()
    shutil.rmtree(tmp_path / "clu", ignore_errors=True)
