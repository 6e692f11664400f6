"""The port's chunked wavefront against the reference's.

* Chained chunks of the plain chunk forms (`dense_chunk_plain`,
  `mask_chunk_plain`, `sort_chunk_plain`) give the one-shot plain
  versions' flags at every chunk size, both row formats.
* After every chunk, the port's flags and carry equal those of the
  reference's `make_dense_chunk_checker` / `make_sort_chunk_checker` (run
  on the CPU from the same event rows), field for field
  (`interop.carry_fields` against `interop.reference_carry_fields`).
* A scan stopped in the reference after k chunks and finished in the
  port (`interop.carry_from_reference`) reaches the reference's verdict.
* The port's `run_chunked` gives the reference's `run_chunked` outcome
  per launch (ok, overflow, chunks_run, evicted_rows, early_exit, tag)
  on the reference's own wavefront cases (tests/test_chunked_scan.py).
* `check_histories` result dicts ("chunked" and "kernel" included, less
  "time-s" and "algorithm") and the wavefront counters equal the
  reference's at the default chunk and at JGRAFT_SCAN_CHUNK=0.

Booleans and integers throughout: exact equality.
"""

import random

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.checker import schedule as ref_schedule
from jepsen_jgroups_raft_tpu.checker.linearizable import \
    check_histories as ref_check
from jepsen_jgroups_raft_tpu.models import MODELS as REF_MODELS
from jepsen_jgroups_raft_tpu.ops import dense_scan as ref_ds
from jepsen_jgroups_raft_tpu.ops import linear_scan as ref_ls
from jepsen_jgroups_raft_tpu_torch import interop
from jepsen_jgroups_raft_tpu_torch.checker import schedule
from jepsen_jgroups_raft_tpu_torch.checker.linearizable import \
    check_histories
from jepsen_jgroups_raft_tpu_torch.history.packing import (bucket_rows,
                                                           encode_history,
                                                           pack_batch,
                                                           pack_macro_batch)
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.ops import dense_scan as ds
from jepsen_jgroups_raft_tpu_torch.ops import linear_scan as ls

torch.set_num_threads(1)

KIND = {"register": "cas-register", "counter": "counter", "queue": "queue",
        "set": "set", "list-append": "list-append"}
FORMATS = (pack_batch, pack_macro_batch)


@pytest.fixture(autouse=True)
def _reset_stats():
    schedule.consume_stats()
    ref_schedule.consume_stats()
    yield
    schedule.consume_stats()
    ref_schedule.consume_stats()


def _corrupt(h, rng):
    """One completed observation changed, where the history has one: a
    register or counter read, an add-and-get's new value, an enqueue's
    or dequeue's ticket raised by one; a set or list read missing its
    last element."""
    ops = list(h)
    idx = [j for j, op in enumerate(ops) if op.type == "ok"
           and op.value is not None and op.f in ("read", "add-and-get",
                                                 "enqueue", "dequeue")]
    if not idx:
        return ops
    j = rng.choice(idx)
    v = ops[j].value
    if isinstance(v, tuple):
        v = (v[0], v[1] + 1)
    elif isinstance(v, (list, set, frozenset)):
        if not v:
            return ops
        v = list(v)[:-1] if isinstance(v, list) else sorted(v)[:-1]
    else:
        v = v + 1
    ops[j] = ops[j].replace(value=v)
    return ops


def _histories(kind, seed, n=8, n_ops=30, n_procs=4, crash_p=0.15,
               max_crashes=2, corrupt_every=3):
    rng = random.Random(seed)
    kw = {"value_range": 32} if kind == "set" else {}
    hs = []
    for i in range(n):
        h = random_valid_history(rng, kind, n_ops=n_ops + 3 * i,
                                 n_procs=n_procs, crash_p=crash_p,
                                 max_crashes=max_crashes, **kw)
        if corrupt_every and i % corrupt_every == 1:
            h = _corrupt(h, rng)
        hs.append(h)
    return hs


def _models(kind):
    return MODELS[KIND[kind]](), REF_MODELS[KIND[kind]]()


# ------------------------------------------------------------- cases
# name: (history kind, scan kind, window W, sort capacity C)

CASES = {f"domain-W{w}": ("register", "domain", w, None) for w in range(1, 7)}
CASES.update({
    "mask-counter": ("counter", "mask", None, None),
    "mask-queue": ("queue", "mask", None, None),
    "sort-register": ("register", "sort", None, 32),
    "sort-set": ("set", "sort", None, 64),
    "sort-listappend": ("list-append", "sort", None, 16),
})


def _setup(name, pack, seed=0):
    """Histories, encodings and packed batch of case `name`, and the
    port's chunk pair, one-shot plain function and the reference's
    chunk pair on the same rows."""
    kind, scan, W, C = CASES[name]
    m, rm = _models(kind)
    n_procs = min(W, 4) if W else 4
    hs = _histories(kind, seed + len(name), n_procs=n_procs,
                    max_crashes=(W - n_procs) if W else 2,
                    crash_p=0.5 if W and W > n_procs else 0.15)
    encs = [encode_history(h, m) for h in hs]
    batch = pack(encs)
    P = batch.get("macro_p")
    ev = torch.from_numpy(batch["events"])
    ne = torch.from_numpy(batch["n_events"])
    W = W or max(max(e.n_slots for e in encs), 1)
    if scan == "sort":
        W = ls.bucket_slots(W)
        init, step = ls.make_sort_chunk_checker(m, C, W, macro_p=P)
        ref = ref_ls.make_sort_chunk_checker(rm, C, W, macro_p=P)
        one = ls.sort_scan_plain(ev, W, C, P, ne, model=m)
        return dict(ev=ev, ne=ne, W=W, size=C, P=P, scan=scan, m=m,
                    carry=init(ne), step=step, ref=ref,
                    ref_args=(batch["n_events"],), one=one)
    if scan == "mask":
        vo = np.zeros((len(encs), 1), dtype=np.int32)
        S = 1
    else:
        plan = ds.dense_plan(m, encs)
        assert plan.kind == "domain" and plan.n_slots <= W
        vo, S = plan.val_of, plan.n_states
    init, step = ds.make_dense_chunk_checker(m, scan, W, S, macro_p=P)
    ref = ref_ds.make_dense_chunk_checker(rm, scan, W, S, macro_p=P)
    vt = torch.from_numpy(vo)
    one = (ds.mask_scan_plain(ev, W, P, ne, model=m) if scan == "mask"
           else ds.dense_scan_plain(ev, vt, W, P, ne, m))
    return dict(ev=ev, ne=ne, W=W, size=S, P=P, scan=scan, m=m,
                carry=init(vt, ne), step=step, ref=ref,
                ref_args=(vo, batch["n_events"]),
                one=(one, torch.zeros_like(one)))


def _chain(ev, carry, step, chunk, width=None):
    """Chained chunk steps over the whole batch; the last flags."""
    E = int(ev.shape[1])
    out = None
    for lo in range(0, max(E, 1), chunk):
        out = step(carry, ev[:, lo:lo + chunk], width)
        carry = out[0]
    return out


@pytest.mark.parametrize("pack", FORMATS, ids=["legacy", "macro"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_chained_chunks_equal_one_shot(name, pack):
    """At chunk 1, 7, 32, 128 and the whole schedule (and a slice cut
    short of its width), the chained chunk plain versions end with the
    one-shot plain version's ok and overflow, every row exhausted."""
    c = _setup(name, pack)
    E = int(c["ev"].shape[1])
    ok1, of1 = c["one"]
    assert (~ok1).any() and ok1.any(), "the case needs both polarities"
    for chunk in (1, 7, 32, 128, E):
        _, dec, exh, ok, of = _chain(c["ev"], c["carry"], c["step"], chunk)
        assert torch.equal(ok, ok1) and torch.equal(of, of1), chunk
        assert torch.equal(dec, ~ok1) and bool(exh.all()), chunk
    # one launch of width 2E over the E real rows: the missing rows are
    # EV_PAD, and left goes to E - 2E
    carry, dec, exh, ok, of = c["step"](c["carry"], c["ev"], 2 * E)
    assert torch.equal(ok, ok1) and torch.equal(of, of1)
    assert bool(exh.all())


def _ref_chain_check(c, chunk, compare=True):
    """Run the reference's chunk pair and the port's side by side over
    chunks of `chunk` rows; after every chunk the flags and (when
    `compare`) every carry field agree. Returns both carries after each
    chunk."""
    ref_init, ref_step = c["ref"]
    ev = c["ev"].numpy()
    B, E, R = ev.shape
    E_pad = -(-E // chunk) * chunk
    pad = np.zeros((B, E_pad, R), dtype=np.int32)
    pad[:, :E] = ev
    rc = ref_init(*c["ref_args"])
    pc = c["carry"]
    history = []
    for lo in range(0, E_pad, chunk):
        rc, *rflags = ref_step(rc, pad[:, lo:lo + chunk])
        pc, *pflags = c["step"](pc, c["ev"][:, lo:lo + chunk], chunk)
        for r, p in zip(rflags, pflags):
            np.testing.assert_array_equal(np.asarray(r), p.numpy())
        rcn = {"inner": [np.asarray(x) if not isinstance(x, tuple)
                         else tuple(np.asarray(y) for y in x)
                         for x in rc["inner"]],
               "left": np.asarray(rc["left"])}
        if compare:
            want = interop.reference_carry_fields(c["scan"], rcn, c["m"])
            got = interop.carry_fields(c["scan"], pc, c["W"], c["size"])
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            if c["scan"] == "mask":
                np.testing.assert_array_equal(
                    got["col"], want["sums"][:, [1 << j
                                                 for j in range(c["W"])]])
        history.append((rcn, pc))
    return history


REF_CASES = ("domain-W3", "domain-W6", "mask-counter", "mask-queue",
             "sort-register", "sort-set", "sort-listappend")


@pytest.mark.parametrize("pack", FORMATS, ids=["legacy", "macro"])
@pytest.mark.parametrize("name", REF_CASES)
def test_every_chunk_matches_reference(name, pack, monkeypatch):
    """After every chunk (7 rows), flags and carry equal the
    reference's chunk checker's: the frontier, slot state, ok, dirty,
    overflow and left (the domain's transition rows against the
    reference's hoisted carry, JGRAFT_HOIST=1)."""
    monkeypatch.setenv("JGRAFT_HOIST", "1")
    _ref_chain_check(_setup(name, pack), 7)


@pytest.mark.parametrize("name", ("domain-W4", "mask-counter", "sort-set",
                                  "sort-register"))
def test_resume_from_reference_carry(name):
    """Stop the reference after k chunks, carry its state across
    (`carry_from_reference`; the domain's from the reference's slot
    registers) and finish in the port: the reference's flags, for every
    k."""
    c = _setup(name, pack_macro_batch)
    hist = _ref_chain_check(c, 5, compare=False)
    final = hist[-1][0]
    want_ok, want_of = {
        "domain": lambda f: (f["inner"][3], np.zeros_like(f["inner"][3])),
        "mask": lambda f: (f["inner"][8], np.zeros_like(f["inner"][8])),
        "sort": lambda f: (f["inner"][6], f["inner"][7]),
    }[c["scan"]](final)
    resumed = 0
    for k in range(len(hist)):
        rest = c["ev"][:, (k + 1) * 5:]
        if rest.shape[1] == 0:
            continue
        carry = interop.carry_from_reference(c["scan"], hist[k][0], c["m"])
        _, _, exhausted, ok, of = c["step"](carry, rest)
        assert np.array_equal(ok.numpy(), want_ok), k
        assert np.array_equal(of.numpy(), want_of), k
        assert bool(exhausted.all())
        resumed += 1
    assert resumed >= 3


@pytest.mark.parametrize("name", ("domain-W5", "mask-queue",
                                  "sort-listappend"))
def test_carry_round_trip_is_exact(name, monkeypatch):
    """carry_from_reference of the reference's carry after each chunk is
    the port's carry at the same point, int for int (the domain's from
    the hoisted carry)."""
    monkeypatch.setenv("JGRAFT_HOIST", "1")
    c = _setup(name, pack_batch)
    for rcn, pc in _ref_chain_check(c, 9, compare=False):
        assert torch.equal(
            interop.carry_from_reference(c["scan"], rcn, c["m"]), pc)


# ----------------------------------------------------- the wavefront


def _dense_launches(hists, model, rmodel, e_sched=None, exact=False):
    """The same dense launches for both packages: the port's and the
    reference's ChunkLaunch lists over one set of packed groups."""
    encs = [encode_history(h, model) for h in hists]
    grouped, rest = ds.dense_plans_grouped(model, encs)
    assert not rest
    ours, theirs, subs = [], [], []
    for idxs, plan in grouped:
        batch = pack_batch([encs[i] for i in idxs])
        init, step = ds.make_dense_chunk_checker(model, plan.kind,
                                                 plan.n_slots, plan.n_states)
        ours.append(schedule.ChunkLaunch(
            events=batch["events"], n_events=batch["n_events"],
            init_fn=init, step_fn=step, val_of=plan.val_of,
            e_sched=e_sched, device="cpu", tag=plan.kernel_tag,
            exact_rows=exact))
        rinit, rstep = ref_ds.make_dense_chunk_checker(
            rmodel, plan.kind, plan.n_slots, plan.n_states)
        theirs.append(ref_schedule.ChunkLaunch(
            events=batch["events"], n_events=batch["n_events"],
            init_fn=rinit, step_fn=rstep, val_of=plan.val_of,
            e_sched=e_sched, tag=plan.kernel_tag, exact_rows=exact))
        subs.append((idxs, plan, batch))
    return ours, theirs, subs


def _same_outcomes(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.ok, b.ok)
        np.testing.assert_array_equal(a.overflow, b.overflow)
        assert (a.chunks_run, a.evicted_rows, a.early_exit, a.tag) == \
            (b.chunks_run, b.evicted_rows, b.early_exit, b.tag)


KEYS = ("chunks_run", "evicted_rows", "groups_run", "groups_early_exited")


@pytest.mark.parametrize("kind", ["register", "counter"])
def test_wavefront_eviction_matches_reference(kind):
    """Mixed lengths and corrupted rows at chunk 8: per launch the
    reference's verdicts, launches, evictions and early exits, and the
    same counters (evictions happen)."""
    m, rm = _models(kind)
    hs = _histories(kind, 17, n=24, n_ops=4, n_procs=3, corrupt_every=3)
    ours, theirs, _ = _dense_launches(hs, m, rm)
    _same_outcomes(schedule.run_chunked(ours, chunk=8),
                   ref_schedule.run_chunked(theirs, chunk=8))
    a, b = schedule.consume_stats(), ref_schedule.consume_stats()
    assert [a[k] for k in KEYS] == [b[k] for k in KEYS]
    assert a["evicted_rows"] > 0


def test_recompaction_roundtrip_matches_one_shot():
    """Chunk 4 over 30 rows (many evictions and recompactions): the
    reference's outcomes, and each group's verdicts equal one one-shot
    plain launch of the same batch."""
    m, rm = _models("register")
    hs = _histories("register", 23, n=30, n_ops=6, corrupt_every=3)
    ours, theirs, subs = _dense_launches(hs, m, rm)
    outs = schedule.run_chunked(ours, chunk=4)
    _same_outcomes(outs, ref_schedule.run_chunked(theirs, chunk=4))
    for out, (idxs, plan, batch) in zip(outs, subs):
        ok = ds.dense_scan_plain(torch.from_numpy(batch["events"]),
                                 torch.from_numpy(plan.val_of),
                                 plan.n_slots,
                                 n_events=torch.from_numpy(
                                     batch["n_events"]), model=m)
        np.testing.assert_array_equal(out.ok, ok.numpy())


def test_early_exit_on_padded_schedule():
    """A schedule covering 256 events over short histories early-exits
    in both packages, with the reference's launch count."""
    m, rm = _models("register")
    rng = random.Random(29)
    hs = [random_valid_history(rng, "register", n_ops=10) for _ in range(9)]
    ours, theirs, _ = _dense_launches(hs, m, rm, e_sched=256)
    [out] = schedule.run_chunked(ours, chunk=8)
    [ref] = ref_schedule.run_chunked(theirs, chunk=8)
    _same_outcomes([out], [ref])
    assert out.early_exit and out.chunks_run < 256 // 8
    assert schedule.snapshot_stats()["groups_early_exited"] == 1


def test_exact_rows_skip_recompaction():
    """exact_rows launches keep their rows in place; verdicts and
    outcomes are the reference's."""
    m, rm = _models("register")
    rng = random.Random(31)
    hs = [random_valid_history(rng, "register", n_ops=8 + 4 * i)
          for i in range(5)]
    ours, theirs, _ = _dense_launches(hs, m, rm, exact=True)
    _same_outcomes(schedule.run_chunked(ours, chunk=4),
                   ref_schedule.run_chunked(theirs, chunk=4))


def test_sort_launch_matches_reference():
    """One sort launch at a chunk that does not divide the event length,
    with overflowing rows (C = 4): the reference's outcome."""
    m, rm = _models("register")
    rng = random.Random(37)
    encs = [encode_history(random_valid_history(rng, "register", n_ops=n,
                                                crash_p=0.4), m)
            for n in (5, 9, 14, 20, 26)]
    batch = pack_batch(encs)
    E = batch["events"].shape[1]
    for C in (4, 64):
        init, step = ls.make_sort_chunk_checker(m, C, 8)
        rinit, rstep = ref_ls.make_sort_chunk_checker(rm, C, 8)
        kw = dict(events=batch["events"], n_events=batch["n_events"],
                  e_sched=bucket_rows(E, 32), tag="sort")
        _same_outcomes(
            schedule.run_chunked([schedule.ChunkLaunch(
                init_fn=init, step_fn=step, device="cpu", **kw)], chunk=6),
            ref_schedule.run_chunked([ref_schedule.ChunkLaunch(
                init_fn=rinit, step_fn=rstep, **kw)], chunk=6))


def test_run_chunked_rejects_nonpositive_chunk():
    with pytest.raises(ValueError):
        schedule.run_chunked([], chunk=0)
    with pytest.raises(ValueError):
        schedule.run_chunked([], chunk=-1)


def test_scan_chunk_env_gate(monkeypatch):
    """JGRAFT_SCAN_CHUNK: unset the reference's 128, 0 the one-shot path,
    garbage warns and keeps the default, a negative value clamps to 0 —
    the reference's parse in each case."""
    for raw in (None, "0", "64", "junk", "-3", " 32 "):
        if raw is None:
            monkeypatch.delenv("JGRAFT_SCAN_CHUNK", raising=False)
        else:
            monkeypatch.setenv("JGRAFT_SCAN_CHUNK", raw)
        assert schedule.scan_chunk() == ref_schedule.scan_chunk(), raw
    monkeypatch.delenv("JGRAFT_SCAN_CHUNK")
    assert schedule.scan_chunk() == schedule.DEFAULT_SCAN_CHUNK == 128


# -------------------------------------------------- check_histories


def _strip(r):
    return {k: v for k, v in r.items() if k not in ("time-s", "algorithm")}


@pytest.mark.parametrize("chunk", [None, "0", "16"])
@pytest.mark.parametrize("kind", ["register", "counter", "queue", "set",
                                  "list-append"])
def test_result_dicts_match_reference(kind, chunk, monkeypatch):
    """check_histories on the CPU against the reference's: every result
    dict field for field ("chunked" and "kernel" included; the device's
    "algorithm" is "torch" where the reference's is "jax"), and the
    wavefront counters, at the default chunk, 16 and 0 (the one-shot
    path: no "chunked" stamp, no groups counted)."""
    if chunk is None:
        monkeypatch.delenv("JGRAFT_SCAN_CHUNK", raising=False)
    else:
        monkeypatch.setenv("JGRAFT_SCAN_CHUNK", chunk)
    m, rm = _models(kind)
    hs = _histories(kind, 41, n=10, n_ops=24, corrupt_every=4)
    ours = check_histories(hs, m, device="cpu")
    theirs = ref_check(hs, rm)
    assert [_strip(r) for r in ours] == [_strip(r) for r in theirs]
    a, b = schedule.consume_stats(), ref_schedule.consume_stats()
    assert [a[k] for k in KEYS] == [b[k] for k in KEYS]
    if chunk == "0":
        assert a["groups_run"] == 0
        assert not any("chunked" in r for r in ours)
    else:
        assert a["groups_run"] > 0
