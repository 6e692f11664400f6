"""The port's election-safety models and check against the reference's.

`LeaderModel` and `MajorityLeaderModel` must give the reference's result
dicts field for field (error, term, observation-count, view-count) on the
cases of tests/test_leader_majority.py and on seeded election runs, safe
and with planted conflicts. `check_election_safety_plain` (the plain
version of the election-safety kernel) must give
`jax.vmap(check_election_safety_jax)`'s verdicts on seeded padded
batches, and the one place where both differ from
`check_election_safety_np` — two leaders at a negative term — is pinned.
Exact equality throughout (booleans and ints)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.history.ops import History as RefHistory
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu.models.leader import (
    LeaderModel as RefLeader, MajorityLeaderModel as RefMajority,
    check_election_safety_jax, check_election_safety_np as ref_np)
from jepsen_jgroups_raft_tpu_torch.history import synth
from jepsen_jgroups_raft_tpu_torch.history.ops import (INVOKE, OK, History,
                                                       Op)
from jepsen_jgroups_raft_tpu_torch.models import MODELS
from jepsen_jgroups_raft_tpu_torch.models.leader import (
    LeaderModel, MajorityLeaderModel, check_election_safety,
    check_election_safety_np, check_election_safety_plain)
from jepsen_jgroups_raft_tpu_torch.ops.election_safety import (
    SHARED_MAX_OBSERVATIONS, election_form, election_safety, table_log2)

torch.set_num_threads(1)


def _both(rows):
    h, rh = History(), RefHistory()
    for r in rows:
        h.append(Op(*r))
        rh.append(RefOp(*r))
    return h, rh


def _same(rows):
    """Both models of both packages on `rows`: equal dicts; returns the
    port's (parity, majority) results."""
    h, rh = _both(rows)
    ours = (LeaderModel().check(h), MajorityLeaderModel().check(h))
    theirs = (RefLeader().check(rh), RefMajority().check(rh))
    assert ours == theirs
    return ours


# the cases of tests/test_leader_majority.py
CASES = {
    "stale_minority": [
        (0, OK, "views", [("n1", "B", 5), ("n2", "B", 5), ("n3", "B", 5),
                          ("n4", "A", 3), ("n5", "A", 3)]),
        (1, OK, "inspect", ("B", 5)),
        (0, OK, "views", [("n1", "B", 5), ("n2", "B", 5), ("n3", "B", 5),
                          ("n4", "A", 3), ("n5", "A", 3)]),
    ],
    "dual_majority": [
        (0, OK, "views", [("n1", "A", 7), ("n2", "A", 7), ("n3", "A", 7)]),
        (0, OK, "views", [("n3", "B", 7), ("n4", "B", 7), ("n5", "B", 7)]),
    ],
    "overlapping_views": [
        (0, INVOKE, "views", None),
        (1, INVOKE, "views", None),
        (0, OK, "views", [("n1", "A", 6)]),
        (1, OK, "views", [("n1", "A", 5)]),
    ],
    "term_regression": [
        (0, OK, "views", [("n1", "A", 9)]),
        (0, OK, "views", [("n1", "A", 4)]),
    ],
    "inspect_safety": [
        (0, OK, "inspect", ("A", 2)),
        (1, OK, "inspect", ("B", 2)),
    ],
    "no_leader": [
        (0, OK, "inspect", (None, 3)),
        (1, OK, "views", [("n1", None, 3), ("n2", "A", 3)]),
    ],
    "empty": [],
}

WANT = {  # (parity valid?, majority valid?)
    "stale_minority": (True, True), "dual_majority": (True, False),
    "overlapping_views": (True, True), "term_regression": (True, False),
    "inspect_safety": (False, False), "no_leader": (True, True),
    "empty": (True, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_models_match_reference_on_majority_cases(name):
    parity, majority = _same(CASES[name])
    assert (parity["valid?"], majority["valid?"]) == WANT[name]


def test_case_details():
    _, maj = _same(CASES["stale_minority"])
    assert maj["view-count"] == 10
    _, maj = _same(CASES["dual_majority"])
    assert "term 7" in maj["error"] and maj["term"] == 7
    _, maj = _same(CASES["term_regression"])
    assert "backward" in maj["error"]
    parity, _ = _same(CASES["inspect_safety"])
    assert parity["term"] == 2 and parity["observation-count"] == 2


def _plant(rows, rng):
    """Report another leader for a term that already has one, in a
    views op (cross-node) or an inspect op, or move a node's term back."""
    oks = [j for j, r in enumerate(rows) if r[1] == OK and r[3]]
    j = rng.choice(oks)
    p, typ, f, v = rows[j]
    kind = rng.choice(["views", "inspect", "regress"])
    if f == "views" and kind != "inspect":
        v = [tuple(x) for x in v]
        k = rng.randrange(len(v))
        node, leader, term = v[k]
        if kind == "regress":
            v[k] = (node, leader, term - 3)
        else:
            v[k] = (node, "zz", term)
    else:
        leader, term = v
        v = ("zz", term)
    rows[j] = (p, typ, f, v)
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_models_match_reference_on_seeded_runs(seed):
    rng = random.Random(seed)
    h = synth.election_history(rng, n_ops=300, concurrency=3 + seed % 3,
                               p_new_term=0.05)
    rows = [(op.process, op.type, op.f, op.value) for op in h]
    parity, majority = _same(rows)
    assert parity["valid?"] is True and majority["valid?"] is True
    assert majority["view-count"] > 0
    planted = [_same(_plant(list(rows), rng)) for _ in range(3)]
    assert not all(m["valid?"] for _, m in planted)


# --------------------------------------------------- the batched check


def _jax_verdicts(obs):
    return np.asarray(jax.vmap(check_election_safety_jax)(
        jnp.asarray(obs))).tolist()


def _padded_batch(seed, B, N):
    """Seeded [B, N, 2] rows: safe rows, planted conflicts early, in the
    middle and last, one leader repeated, negative terms, padded tails."""
    rng = np.random.default_rng(seed)
    obs = synth.election_observation_rows(rng, B, N, n_terms=max(2, N // 3))
    for b in range(B):
        kind = b % 6
        if kind == 1:  # conflict: a later observation of row 0's term
            j = int(rng.integers(1, N)) if N > 1 else 0
            obs[b, j] = (obs[b, 0, 0], obs[b, 0, 1] + 1)
        elif kind == 2:  # one observation repeated everywhere
            obs[b] = obs[b, 0]
        elif kind == 3:  # padded tail
            obs[b, int(rng.integers(0, N + 1)):] = -1
        elif kind == 4:  # negative terms with two leaders
            obs[b, : N // 2, 0] = -1 - (np.arange(N // 2) % 2)
        elif kind == 5 and N > 1:  # conflict in the last position
            obs[b, N - 1] = (obs[b, 0, 0], obs[b, 0, 1] + 7)
    return obs


@pytest.mark.parametrize("N", [1, 2, 3, 31, 32, 33, 128])
def test_plain_matches_jax_on_seeded_batches(N):
    obs = _padded_batch(N, 24, N)
    ours = check_election_safety_plain(torch.from_numpy(obs)).tolist()
    assert ours == _jax_verdicts(obs)
    assert check_election_safety(torch.from_numpy(obs)).tolist() == ours
    if N > 1:
        assert not all(ours) and any(ours)


def test_valid_len_cuts_rows_like_padding():
    obs = _padded_batch(5, 18, 40)
    rng = np.random.default_rng(9)
    vl = rng.integers(0, 41, size=18).astype(np.int32)
    padded = obs.copy()
    for b in range(18):
        padded[b, vl[b]:] = -1
    ours = check_election_safety_plain(torch.from_numpy(obs),
                                       torch.from_numpy(vl)).tolist()
    assert ours == _jax_verdicts(padded)


def test_negative_terms_are_ignored_unlike_np():
    """The JAX function (and the port's batched check) ignores negative
    terms; `check_election_safety_np` flags two leaders at term -1. Raft
    terms are never negative, so the two agree on every real history."""
    obs = np.array([[-1, 0], [-1, 1], [4, 2]], dtype=np.int32)
    assert ref_np(obs) == (False, -1)
    assert check_election_safety_np(obs) == (False, -1)
    assert _jax_verdicts(obs[None]) == [True]
    assert check_election_safety_plain(
        torch.from_numpy(obs[None])).tolist() == [True]


def test_plain_matches_np_on_nonnegative_terms():
    obs = _padded_batch(11, 30, 50)
    obs[:, :, 0] = np.abs(obs[:, :, 0])  # no negative terms
    ours = check_election_safety_plain(torch.from_numpy(obs)).tolist()
    assert ours == [check_election_safety_np(o)[0] for o in obs]


def test_kernel_wrapper_refuses_cpu_tensors_and_sizes_its_table():
    """The kernel's table holds 2N slots at least; the form that keeps it
    in shared memory takes rows up to 8192 observations (2^14 slots, 128
    KB of the 227 KB a CTA may have), the global form the rest."""
    with pytest.raises(ValueError, match="CUDA"):
        election_safety(torch.zeros((1, 4, 2), dtype=torch.int32))
    assert [table_log2(n) for n in (1, 2, 3, 4096, 8192, 8193, 65536)] == \
        [1, 2, 3, 13, 14, 15, 17]
    assert [election_form(n) for n in (1, 2, 31, 4096, 8192)] == \
        ["shared"] * 5
    assert [election_form(n) for n in (8193, 65536, 1 << 26)] == \
        ["global"] * 3
    assert SHARED_MAX_OBSERVATIONS == 8192
    assert 8 << table_log2(SHARED_MAX_OBSERVATIONS) <= 227 * 1024
    assert MODELS["leader"] is LeaderModel


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 8191, 8192, 8193, 65536])
def test_election_form_is_a_function_of_n(n):
    """`election_form` reads N alone: the shared form exactly while the
    row's table (the power of two ≥ 2N slots) fits 2^14 slots."""
    want = "shared" if 2 * n <= 1 << 14 else "global"
    assert election_form(n) == want
    assert (1 << table_log2(n)) >= 2 * n > (1 << table_log2(n)) // 2 \
        or n == 1
