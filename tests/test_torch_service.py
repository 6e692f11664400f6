"""The port's checking service (`jepsen_jgroups_raft_tpu_torch.service`)
against the reference's (`jepsen_jgroups_raft_tpu.service`), on the CPU.

* Verdicts: the same submissions through the reference's
  `CheckingService` (JAX on the CPU) and the port's (``device="cpu"``,
  the kernels' plain versions) give equal ``valid?`` and
  ``decided-tier`` per unit, and equal fingerprints; a coalesced batch
  demultiplexes to the verdicts of isolated checks.
* Fingerprints: byte-identical to the reference's for register,
  counter, queue, set and list-append submissions, at the weaker rungs
  too, and over the binary lane.
* The host ladder (`check_encoded_host`) equals the reference's.
* Failure paths: an injected `check_fn` failure degrades with the
  ``platform-degraded`` stamp; a kernel build error (`KernelBuildError`)
  fails the request and is never degraded; on the card, any failure of
  the default check path (a failed launch, an illegal address, an
  out-of-memory error, a batch the watchdog gave up on twice) fails the
  request and is never degraded; a service on the card builds its
  kernels at start, so a missing nvcc fails the start.
* Shards: two shard executors on one device give the single worker's
  verdicts.
* The HTTP lanes (JSON and binary frames) give one fingerprint; the CLI's
  ``serve-checker`` exits 3 without a card.

Tolerance: exact equality (booleans, tier names, hex digests).
Small sizes: 20-60-op histories of 3 processes, a few requests a test;
every wait has its own timeout.
"""

import contextlib
import random
import threading

import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import linearizable as ref_lin
from jepsen_jgroups_raft_tpu.history.packing import \
    encode_history as ref_encode
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu.service import CheckingService as RefService
from jepsen_jgroups_raft_tpu.service import request as ref_request
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker import linearizable as lin
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.ops import _build
from jepsen_jgroups_raft_tpu_torch.service import (CheckingService,
                                                   ServiceClient,
                                                   serve_in_thread)
from jepsen_jgroups_raft_tpu_torch.service import daemon as port_daemon
from jepsen_jgroups_raft_tpu_torch.service import request as port_request

torch.set_num_threads(1)

#: the longest wait for one request (an upper bound, not a sleep)
WAIT_S = 120.0
KIND = {"register": "cas-register", "counter": "counter", "queue": "queue",
        "set": "set", "list-append": "list-append"}


def _rows(kind, seed, n_ops=30, corrupt=False):
    """Op dicts of a random valid history of `kind` (3 processes; a
    list-append history keyed); with `corrupt`, one ok read moved out of
    any reachable value."""
    kw = {"value_range": 32} if kind == "set" else {}
    ops = list(random_valid_history(random.Random(seed), kind, n_ops=n_ops,
                                    n_procs=3, crash_p=0.1, **kw))
    if kind == "list-append":
        # an independent workload: every value keyed, here by key 0
        ops = [op.replace(value=(0, op.value)) for op in ops]
    if corrupt:
        reads = [j for j, op in enumerate(ops) if op.type == "ok"
                 and op.f == "read" and op.value is not None]
        j = reads[len(reads) // 2]
        bump = 7 if kind == "register" else 10**6
        ops[j] = ops[j].replace(value=ops[j].value + bump)
    return [op.to_dict() for op in ops]


def _submissions(kind, n_requests=4, per_request=2, seed=0):
    """n_requests lists of op-dict histories; every third history
    corrupted."""
    out = []
    k = 0
    for _ in range(n_requests):
        req = []
        for _ in range(per_request):
            req.append(_rows(kind, seed + k, corrupt=k % 3 == 1))
            k += 1
        out.append(req)
    return out


def _run(service, subs, workload):
    """Submit every submission to a service built with autostart=False
    (so they coalesce), start it, wait; returns the requests."""
    reqs = [service.submit(s, workload=workload) for s in subs]
    service.start()
    try:
        for r in reqs:
            assert r.wait(WAIT_S), f"request {r.id} stuck in {r.status}"
    finally:
        service.shutdown()
    return reqs


def _units(reqs):
    return [(x["valid?"], x.get("decided-tier")) for r in reqs
            for x in r.results]


def _port(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("batch_wait", 0.0)
    kw.setdefault("autostart", False)
    return CheckingService(**kw)


def _ref(**kw):
    kw.setdefault("batch_wait", 0.0)
    kw.setdefault("autostart", False)
    return RefService(**kw)


# ------------------------------------------------------------- verdicts


@pytest.mark.parametrize("kind", ["register", "counter"])
def test_verdicts_equal_reference_service(kind):
    """The same coalesced submissions through both daemons: equal
    fingerprints, equal (valid?, decided-tier) per unit, both INVALID
    and VALID seen, and a batch carrying several requests on each."""
    subs = _submissions(kind)
    ours = _run(_port(), subs, kind)
    theirs = _run(_ref(), subs, kind)
    assert [r.fingerprint for r in ours] == [r.fingerprint for r in theirs]
    assert _units(ours) == _units(theirs)
    assert {True, False} <= {v for v, _ in _units(ours)}
    assert [r.verdict() for r in ours] == [r.verdict() for r in theirs]
    assert max(r.stats["batched_requests"] for r in ours) >= 2
    assert not any("platform-degraded" in x for r in ours
                   for x in r.results)


def test_demuxed_verdicts_equal_isolated_checks():
    """Six requests coalesce (one batch per shape bucket they fall in);
    each request's demultiplexed results equal `check_histories` of its
    own histories alone."""
    subs = _submissions("register", n_requests=6, per_request=1, seed=40)
    reqs = _run(_port(), subs, "register")
    assert len({r.stats["batch_seq"] for r in reqs}) < len(reqs)
    for s, r in zip(subs, reqs):
        hs = [port_request.history_from_dicts(h) for h in s]
        alone = lin.check_histories(hs, MODELS["cas-register"](),
                                    device="cpu")
        assert [(x["valid?"], x["decided-tier"]) for x in r.results] == \
            [(x["valid?"], x["decided-tier"]) for x in alone]


# --------------------------------------------------------- fingerprints


@pytest.mark.parametrize("kind", list(KIND))
def test_fingerprints_equal_reference(kind):
    """`admit` in both packages: the same units and a byte-identical
    fingerprint; the binary lane's `admit_encoded` (the port's own
    encodings, and the reference's carried over) reaches it too."""
    hs = [_rows(kind, 70 + i, n_ops=24) for i in range(3)]
    ours = port_request.admit(hs, kind)
    theirs = ref_request.admit(hs, kind)
    assert [lab for lab, _ in ours.units] == [lab for lab, _ in
                                              theirs.units]
    assert ours.fingerprint == theirs.fingerprint
    labels = [lab for lab, _ in ours.units]
    assert port_request.admit_encoded(kind, labels, ours.encs).fingerprint \
        == theirs.fingerprint
    carried = [interop.encoding_from_reference(e) for e in theirs.encs]
    assert port_request.admit_encoded(kind, labels, carried).fingerprint \
        == theirs.fingerprint


@pytest.mark.parametrize("rung", ["sequential", "session"])
def test_weak_rung_fingerprint_equals_reference(rung):
    """At a weaker rung the fingerprint hashes the rung and the process
    ids too: equal to the reference's, and unlike the linearizable
    one."""
    hs = [_rows("register", 90 + i) for i in range(2)]
    ours = port_request.admit(hs, "register", consistency=rung)
    theirs = ref_request.admit(hs, "register", consistency=rung)
    assert ours.fingerprint == theirs.fingerprint
    assert ours.fingerprint != port_request.admit(hs, "register").fingerprint


@pytest.mark.parametrize("algorithm", ["auto", "dense", "cpu", "dfs"])
def test_fingerprint_hashes_the_algorithm_name(algorithm):
    """The algorithm string is part of the digest: for every name both
    packages share, the digests agree."""
    hs = [_rows("counter", 5)]
    assert port_request.admit(hs, "counter", algorithm=algorithm) \
        .fingerprint == ref_request.admit(hs, "counter",
                                          algorithm=algorithm).fingerprint


# ----------------------------------------------------------- host ladder


@pytest.mark.parametrize("rung", ["linearizable", "sequential", "session"])
@pytest.mark.parametrize("kind", ["register", "counter"])
def test_check_encoded_host_equals_reference(kind, rung):
    """The degrade arm's host ladder on the same encodings (reference
    encodings carried over): equal verdict, tier and algorithm."""
    m, rm = MODELS[KIND[kind]](), REF_MODELS[KIND[kind]]()
    for seed in range(4):
        h = ref_request.history_from_dicts(
            _rows(kind, 110 + seed, n_ops=20, corrupt=seed % 2 == 1))
        renc = ref_encode(h, rm)
        want = ref_lin.check_encoded_host(renc, rm, consistency=rung)
        got = lin.check_encoded_host(interop.encoding_from_reference(renc),
                                     m, consistency=rung)
        keys = ("valid?", "decided-tier", "algorithm", "consistency",
                "sc-refuted")
        assert {k: got.get(k) for k in keys} == \
            {k: want.get(k) for k in keys}


# -------------------------------------------------------- failure paths


def test_injected_failure_degrades_with_the_stamp():
    """A `check_fn` that raises mid-check: the batch takes the host
    ladder, every result carries ``platform-degraded`` with the cause,
    the batch counts as degraded, the verdicts equal the healthy
    check's, and the degraded verdict is never cached."""
    subs = _submissions("register", n_requests=2, seed=130)

    def boom(encs, model, **kw):
        raise RuntimeError("injected device fault")

    reqs = _run(_port(check_fn=boom), subs, "register")
    healthy = _run(_port(), subs, "register")
    for r in reqs:
        assert r.status == "done"
        assert r.stats["degraded"] is True
        assert all("injected device fault" in x["platform-degraded"]
                   for x in r.results)
    assert [v for v, _ in _units(reqs)] == [v for v, _ in _units(healthy)]
    svc = _port(check_fn=boom)
    first = _run(svc, subs[:1], "register")
    assert svc.stats()["degraded_batches"] == 1
    assert len(svc.cache) == 0 and not first[0].cached


def test_kernel_build_error_fails_the_request_loudly():
    """A kernel that does not build or load is never degraded: the
    request fails with the build log's tail, no result is stamped, no
    batch counts as degraded."""
    tail = "dense_scan.cu(12): error: identifier undefined"

    def broken(encs, model, **kw):
        raise _build.KernelBuildError(
            "CUDA kernel build failed\ndense_scan: nvcc exited 2:\n" + tail)

    svc = _port(check_fn=broken)
    reqs = _run(svc, _submissions("register", n_requests=2), "register")
    for r in reqs:
        assert r.status == "failed"
        assert tail in r.error and "kernel build" in r.error
        assert r.results is None
    assert svc.stats()["degraded_batches"] == 0
    assert svc.stats()["failed"] == 2


def test_start_on_the_card_builds_its_kernels(monkeypatch, tmp_path):
    """A service on the card builds (or loads) SERVICE_LIBRARIES at
    start; with no nvcc the start raises `KernelBuildError` and no
    worker starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        CheckingService(device="cuda", name="graftd-nvcc")
    assert not any(t.name.startswith("graftd-nvcc")
                   for t in threading.enumerate()
                   if t.name not in before)
    built = []
    monkeypatch.setattr(_build, "build", lambda names: built.append(
        tuple(names)) or 0.0)
    monkeypatch.setattr(_build, "load", lambda name: built.append(name))
    svc = CheckingService(device="cuda", autostart=False)
    svc.prepare_kernels()
    svc.prepare_kernels()  # once per service
    assert built == [port_daemon.SERVICE_LIBRARIES,
                     *port_daemon.SERVICE_LIBRARIES]


def _card_service(monkeypatch, check, **kw):
    """A service on the card's default check path, on a host without
    one: the start-time build is stubbed, the path's `check_encoded` is
    `check`, the launch scope is the host's, and the fast lane is off so
    every row reaches `check`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build", lambda names: 0.0)
    monkeypatch.setattr(_build, "load", lambda name: None)
    monkeypatch.setattr(lin, "check_encoded", check)
    monkeypatch.setenv("JGRAFT_LIN_FASTPATH", "0")
    kw.setdefault("batch_wait", 0.0)
    svc = CheckingService(device="cuda", **kw)
    monkeypatch.setattr(svc.scheduler, "launch_scope",
                        contextlib.nullcontext)
    return svc


def _on_host(encs, model, device=None, **kw):
    return REAL_CHECK_ENCODED(encs, model, device="cpu", **kw)


REAL_CHECK_ENCODED = lin.check_encoded


@pytest.mark.parametrize("fault", [
    RuntimeError("dense_scan kernel launch failed: CUDA error: invalid "
                 "configuration argument"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                "2.00 GiB"),
    RuntimeError("injected device fault")],
    ids=["launch", "illegal-address", "out-of-memory", "other"])
def test_card_default_path_failure_fails_the_request(monkeypatch, fault):
    """On the card the default check path never degrades: a kernel's
    failure fails every request of its batch with the cause, no result
    carries ``platform-degraded`` and no batch counts as degraded."""
    def broken(encs, model, **kw):
        raise fault

    svc = _card_service(monkeypatch, broken, autostart=False)
    assert svc.scheduler.host_degrade is False
    reqs = _run(svc, _submissions("register", n_requests=2), "register")
    for r in reqs:
        assert r.status == "failed" and r.results is None
        assert str(fault) in r.error and "device path failed" in r.error
    assert svc.stats()["degraded_batches"] == 0
    assert svc.stats()["failed"] == 2


def test_card_default_path_serves_its_verdicts(monkeypatch):
    """The same card service, with a healthy check path, answers with
    the CPU service's verdicts and degrades nothing."""
    subs = _submissions("register", n_requests=2, seed=140)
    reqs = _run(_card_service(monkeypatch, _on_host, autostart=False),
                subs, "register")
    monkeypatch.setattr(lin, "check_encoded", REAL_CHECK_ENCODED)
    assert _units(reqs) == _units(_run(_port(), subs, "register"))
    assert not any(r.stats["degraded"] for r in reqs)


def test_card_watchdog_fails_a_twice_hung_batch(monkeypatch):
    """A batch wedged on the card's default path: strike two fails the
    request with the watchdog's cause instead of re-checking it on the
    host; the released zombie cannot overwrite that answer, and the
    replacement worker serves the next request from the device path."""
    release = threading.Event()
    calls = []

    def hanging(encs, model, **kw):
        calls.append(threading.get_ident())
        if len(calls) == 1:
            release.wait(30)   # a wedged launch
        return _on_host(encs, model, **kw)

    svc = _card_service(monkeypatch, hanging, watchdog_margin_s=0.25)
    try:
        req = svc.submit([_rows("register", 250)], workload="register",
                         deadline_ms=200)
        assert req.wait(WAIT_S), req.status
        assert req.status == "failed" and req.results is None
        assert "WatchdogDegrade" in req.error
        release.set()
        ok = svc.submit([_rows("register", 251)], workload="register")
        assert ok.wait(WAIT_S) and ok.verdict() is True
        assert not any("platform-degraded" in x for x in ok.results)
    finally:
        release.set()
        svc.shutdown()
    assert svc.stats()["degraded_batches"] == 0
    assert req.status == "failed"   # first-wins: unchanged


# --------------------------------------------------------------- shards


def test_two_shards_on_one_device_match_one_worker():
    """Two shard executors on one device against the single worker, on
    three shape buckets (short and long register rows, counter rows):
    equal verdicts and tiers, placement within the two shards."""
    subs = [("register", s) for s in _submissions("register", 2, seed=150)]
    subs += [("register", [_rows("register", 160 + i, n_ops=60)
                           for i in range(2)])]
    subs += [("counter", s) for s in _submissions("counter", 2, seed=170)]

    def run(workers):
        svc = _port(n_workers=workers)
        reqs = [svc.submit(s, workload=w) for w, s in subs]
        svc.start()
        try:
            for r in reqs:
                assert r.wait(WAIT_S)
            st = svc.stats()
        finally:
            svc.shutdown()
        return reqs, st

    two, st2 = run(2)
    one, st1 = run(1)
    assert _units(two) == _units(one)
    assert (st2["workers"], st1["workers"]) == (2, 1)
    assert {r.stats["placement"]["shard"] for r in two} <= {0, 1}
    assert all(r.stats["placement"]["n_shards"] == 2 for r in two)
    assert st2["degraded_batches"] == 0


# ----------------------------------------------------------------- HTTP


def test_json_and_binary_lanes_give_one_fingerprint(tmp_path):
    """Over HTTP: the same histories as JSON and as a binary frame give
    one fingerprint (the second answers from the cache) and the
    verdicts of `check_histories`."""
    hs = [_rows("register", 200 + i, corrupt=i == 1) for i in range(3)]
    svc = CheckingService(device="cpu", journal_dir=str(tmp_path / "j"),
                          batch_wait=0.0)
    httpd, port, _ = serve_in_thread(svc)
    cl = ServiceClient(f"http://127.0.0.1:{port}", timeout=30.0)
    try:
        a = cl.check(hs, workload="register", timeout_s=WAIT_S)
        b = cl.submit(hs, workload="register", binary=True)
        b = cl.result(b["id"], wait_s=20)
        st = cl.stats()
    finally:
        cl.close()
        httpd.shutdown()
        httpd.server_close()
        svc.shutdown()
    assert a["fingerprint"] == b["fingerprint"]
    assert b["cached"] is True
    alone = lin.check_histories(
        [port_request.history_from_dicts(h) for h in hs],
        MODELS["cas-register"](), device="cpu")
    assert [x["valid?"] for x in a["results"]] == \
        [x["valid?"] for x in b["results"]] == [x["valid?"] for x in alone]
    assert st["journal_enabled"] and not st["cluster_enabled"]


def test_cli_serve_checker_without_a_card_exits_3(monkeypatch, capsys):
    from jepsen_jgroups_raft_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["serve-checker", "--port", "0"]) == 3
    assert "no CUDA device" in capsys.readouterr().err


def test_service_without_a_card_raises(monkeypatch):
    """No CUDA device and no explicit CPU request: the service refuses
    to start (it never carries on on the host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckingService(autostart=False)


# ----------------------------------------------------------- resilience


class Boom(BaseException):
    """Escapes the degrade arm's `except Exception`: kills the executor
    thread, as a crashing worker would."""


def test_poison_batch_quarantined_like_reference():
    """A check that kills its executor every time: the request is
    quarantined at the crash cap, the worker respawned exactly that
    often, and the queue is not wedged afterwards — as in the
    reference's daemon."""
    def dying(encs, model, algorithm="auto", **kw):
        raise Boom("deterministic executor killer")

    out = {}
    for name, make in (("port", _port), ("ref", _ref)):
        svc = make(check_fn=dying, crash_cap=2)
        req = svc.submit([_rows("register", 240)], workload="register")
        svc.start()
        try:
            assert req.wait(WAIT_S), req.status
            st = svc.stats()
        finally:
            svc.shutdown()
        out[name] = (req.status, "quarantined" in req.error,
                     st["quarantined"], st["worker_restarts"])
    assert out["port"] == out["ref"] == ("failed", True, 1, 2)


def test_watchdog_rescues_a_hung_batch_on_the_host():
    """A batch wedged in its check: strike one requeues it, strike two
    re-runs it on the host ladder on a replacement worker (stamped, never
    cached); the wedged one, released later, cannot overwrite the
    answer, and the replacement serves the next request from the
    device path."""
    release = threading.Event()
    calls = []

    def hanging(encs, model, algorithm="auto", **kw):
        calls.append(threading.get_ident())
        if len(calls) == 1:
            release.wait(30)   # a wedged launch
        return lin.check_encoded(encs, model, algorithm=algorithm,
                                 device="cpu", distribute=False, **kw)

    svc = CheckingService(device="cpu", batch_wait=0.0, check_fn=hanging,
                          watchdog_margin_s=0.25)
    try:
        req = svc.submit([_rows("register", 250)], workload="register",
                         deadline_ms=200)
        assert req.wait(WAIT_S), req.status
        assert req.status == "done" and req.verdict() is True
        assert all("watchdog" in x["platform-degraded"]
                   for x in req.results)
        release.set()
        ok = svc.submit([_rows("register", 251)], workload="register")
        assert ok.wait(WAIT_S) and ok.verdict() is True
        assert not any("platform-degraded" in x for x in ok.results)
    finally:
        release.set()
        svc.shutdown()     # joins the workers: their accounting is done
    assert svc.stats()["watchdog_requeues"] == 2 and len(svc.cache) == 1
    assert req.verdict() is True   # first-wins: unchanged


@pytest.mark.parametrize("algorithm", ["jax", "pallas", "bogus"])
def test_reference_only_algorithm_names_are_refused(algorithm, tmp_path):
    """The port's algorithm names are auto / dense / cpu / dfs / race: a
    name it does not have (the reference's "jax" and "pallas" among
    them) is refused at admission, on both lanes and at a stream's open,
    and a journal record carrying one is skipped on replay — never a
    batch that raises and degrades."""
    hs = [_rows("register", 260)]
    with pytest.raises(ValueError, match="unknown algorithm"):
        port_request.admit(hs, "register", algorithm=algorithm)
    req = port_request.admit(hs, "register")
    with pytest.raises(ValueError, match="unknown algorithm"):
        port_request.admit_encoded("register", ["h0"], req.encs,
                                   algorithm=algorithm)
    svc = _port(journal_dir=str(tmp_path / "j"))
    try:
        with pytest.raises(ValueError, match="unknown algorithm"):
            svc.streams.open(workload="register", algorithm=algorithm)
    finally:
        svc.shutdown()
    ref = _ref(journal_dir=str(tmp_path / "ref"))
    ref.submit(hs, workload="register", algorithm=algorithm)
    ref._journal.close()
    out = CheckingService(device="cpu", journal_dir=str(tmp_path / "ref"),
                          autostart=False)
    try:
        assert out.stats()["recovered_requests"] == 0
        assert out.queue.depth == 0
    finally:
        out.shutdown()


def test_concurrent_tenants_stress_keeps_every_count():
    """More submitting threads than cores against two shard executors,
    with a shortened switch interval: every request completes with the
    verdicts of an isolated check, and the daemon's counters lose no
    update (submitted = completed = requests; batched requests summed
    over batches = requests)."""
    import sys

    n_threads, per_thread = 16, 2
    subs = [[_rows("register", 300 + i, n_ops=20, corrupt=i % 5 == 0)]
            for i in range(n_threads * per_thread)]
    svc = _port(n_workers=2, batch_wait=0.005, autostart=True)
    reqs = [None] * len(subs)
    errors = []

    def tenant(k):
        try:
            for i in range(k, len(subs), n_threads):
                reqs[i] = svc.submit(subs[i], workload="register")
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=tenant, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        assert not errors, errors
        for r in reqs:
            assert r.wait(WAIT_S), r.status
    finally:
        sys.setswitchinterval(old)
        svc.shutdown()     # joins the workers: their accounting is done
    st = svc.stats()
    assert st["submitted"] == st["completed"] == len(subs)
    assert st["batched_requests"] == len(subs)
    assert st["failed"] == st["degraded_batches"] == 0
    alone = lin.check_histories(
        [port_request.history_from_dicts(s[0]) for s in subs],
        MODELS["cas-register"](), device="cpu")
    assert [r.results[0]["valid?"] for r in reqs] == \
        [x["valid?"] for x in alone]
