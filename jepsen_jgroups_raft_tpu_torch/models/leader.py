"""Election-safety model (a copy of the reference's `models/leader.py`,
with its device check ported).

Equivalent of the reference's LeaderModel (workload/leader.clj:63-75): each
``inspect`` op observes a ``(leader, term)`` tuple; the invariant is that no
term ever has two different leaders ("election safety"). Like the reference
(comment at leader.clj:58-62) it does NOT check majority agreement.

This invariant is order-independent — no linearization search is needed —
so it gets a direct check rather than the frontier kernel. The models'
verdicts come from the host check (`check_election_safety_np`, which
also names the first offending term); `check_election_safety` is the
batched device form of the reference's `check_election_safety_jax`
(`models/leader.py:163`), over many observation rows at once: a CPU
tensor takes `check_election_safety_plain`, a CUDA tensor launches the
hand-written kernel (ops/csrc/election_safety.cu) or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..history.ops import INVOKE, OK, History


class LeaderModel:
    """Checks election safety over inspect observations."""

    name = "leader"

    def observations(self, history: History) -> np.ndarray:
        """Extract [(term, leader_id)] int32 pairs from ok inspect ops.

        Leaders are interned to dense int ids (node names are strings).
        """
        self._leaders: dict = {}
        rows = []
        for op in history:
            if op.type == OK and op.f == "inspect":
                leader, term = op.value
                if leader is None:
                    continue  # no leader known at inspection time
                lid = self._leaders.setdefault(leader, len(self._leaders))
                rows.append((int(term), lid))
        return np.asarray(rows, dtype=np.int32).reshape(-1, 2)

    def check(self, history: History) -> dict:
        obs = self.observations(history)
        valid, bad_term = check_election_safety_np(obs)
        result = {"valid?": bool(valid), "observation-count": int(len(obs))}
        if not valid:
            by_id = {v: k for k, v in self._leaders.items()}
            leaders = sorted(
                {by_id[int(l)] for t, l in obs if int(t) == bad_term}
            )
            result["error"] = (
                f"two leaders observed for term {bad_term}: {leaders}"
            )
            result["term"] = int(bad_term)
        return result


class MajorityLeaderModel(LeaderModel):
    """Opt-in strengthening past the reference's parity point.

    The reference deliberately does NOT check cross-node agreement
    (leader.clj:58-62: a partitioned node can legitimately still think X
    is leader — stale views are not errors). But the harness's DB probes
    EVERY node's local view, so stronger — still sound — invariants are
    checkable from `views` observations (ops with f="views", value =
    [(node, leader, term), ...]):

      1. POOLED election safety: one leader per term across every
         node's view, not just the connected node's. Two same-term
         majorities with different leaders must share a node (majorities
         intersect), and that node's two reports collide here — so a
         genuine dual-majority view fails while a stale minority view
         (old leader at an OLD term) passes.
      2. Per-node term monotonicity: a node's reported term never goes
         backward. Lagging forever is fine; regressing is not (Raft
         terms are monotone per server: currentTerm only grows).
    """

    name = "leader-majority"

    def pooled(self, history: History, interned: dict):
        """(pooled [(term, leader_id)] int32 [N, 2], by_node) over the
        ok inspect and views ops, leaders interned into `interned`;
        by_node maps a node to its views snapshots [(invoke_idx, ok_idx,
        term)] — both endpoints kept because concurrent views ops have
        no order: monotonicity may only be asserted between snapshots
        where one op COMPLETED before the other was INVOKED."""
        pooled = []
        by_node: dict = {}
        pending: dict = {}  # process -> invoke idx of its open views op
        for idx, op in enumerate(history):
            if op.f == "views" and op.type == INVOKE:
                pending[op.process] = idx
            if op.type != OK:
                continue
            if op.f == "inspect":
                leader, term = op.value
                if leader is not None:
                    lid = interned.setdefault(leader, len(interned))
                    pooled.append((int(term), lid))
            elif op.f == "views":
                inv = pending.pop(op.process, idx)
                for node, leader, term in op.value or ():
                    if leader is None:
                        continue
                    lid = interned.setdefault(leader, len(interned))
                    pooled.append((int(term), lid))
                    by_node.setdefault(node, []).append(
                        (inv, idx, int(term)))
        return np.asarray(pooled, dtype=np.int32).reshape(-1, 2), by_node

    def check(self, history: History) -> dict:
        result = super().check(history)  # inspect-op safety (parity)
        interned = dict(self._leaders)
        obs, by_node = self.pooled(history, interned)
        ok, bad_term = check_election_safety_np(obs)
        if not ok:
            by_id = {v: k for k, v in interned.items()}
            leaders = sorted({by_id[int(l)] for t, l in obs
                              if int(t) == bad_term})
            result["valid?"] = False
            result["error"] = ("cross-node election safety: two leaders "
                              f"for term {bad_term}: {leaders}")
            result["term"] = int(bad_term)
        for node, snaps in sorted(by_node.items()):
            # Compare each snapshot only against the max term of
            # snapshots that happened-before it (completed before its
            # invocation): snapshots in invocation order, a
            # completion-ordered cursor carrying the running max,
            # O(n log n).
            done = sorted(snaps, key=lambda s: s[1])
            k = 0
            run_max = None
            for inv_j, _, term_j in sorted(snaps):
                while k < len(done) and done[k][1] < inv_j:
                    t = done[k][2]
                    run_max = t if run_max is None else max(run_max, t)
                    k += 1
                if run_max is not None and term_j < run_max:
                    result["valid?"] = False
                    result["error"] = (
                        f"node {node} term went backward: {run_max} "
                        f"-> {term_j} across non-overlapping snapshots")
                    return result
        result["view-count"] = int(sum(len(t) for t in by_node.values()))
        return result


def check_election_safety_np(obs: np.ndarray) -> Tuple[bool, Optional[int]]:
    """(valid?, first offending term). obs: [N,2] int32 (term, leader)."""
    if len(obs) == 0:
        return True, None
    order = np.lexsort((obs[:, 1], obs[:, 0]))
    s = obs[order]
    same_term = s[1:, 0] == s[:-1, 0]
    diff_leader = s[1:, 1] != s[:-1, 1]
    bad = same_term & diff_leader
    if bad.any():
        return False, int(s[1:][bad][0, 0])
    return True, None


def _masked(obs, valid_len):
    """obs [B, N, 2] int32 with the rows at or past valid_len[b] set to
    the padding (-1, -1)."""
    import torch

    if valid_len is None:
        return obs
    n = int(obs.shape[1])
    pad = torch.arange(n, device=obs.device)[None, :] >= \
        valid_len.to(obs.device)[:, None]
    return torch.where(pad[:, :, None], torch.full_like(obs, -1), obs)


def check_election_safety_plain(obs, valid_len=None):
    """The reference's `check_election_safety_jax` in plain PyTorch, over
    a batch: obs [B, N, 2] int32 (term, leader), padded rows (-1, -1) or
    cut by valid_len [B]. Sorts each row by (term, leader) and flags an
    adjacent pair of one term ≥ 0 with two leaders. Returns [B] bool,
    True where the row is safe (negative terms are ignored — where
    `check_election_safety_np` flags two leaders at one negative term,
    this does not; Raft terms are never negative)."""
    import torch

    obs = _masked(obs, valid_len)
    term = obs[:, :, 0].to(torch.int64)
    leader = obs[:, :, 1].to(torch.int64)
    # (term, leader) lexicographic as one int64 key: the leader offset
    # into [0, 2^32) below the term
    key, _ = torch.sort(term * (1 << 32) + (leader + (1 << 31)), dim=1)
    ts = torch.div(key, 1 << 32, rounding_mode="floor")
    bad = (ts[:, 1:] == ts[:, :-1]) & (key[:, 1:] != key[:, :-1]) & \
        (ts[:, 1:] >= 0)
    return ~bad.any(dim=1)


def check_election_safety(obs, valid_len=None):
    """Election safety of a batch of observation rows: obs [B, N, 2]
    int32 (term, leader), padded rows (-1, -1) or cut by valid_len [B]
    (int32). Returns [B] bool, True where no term ≥ 0 has two leaders
    (`check_election_safety_jax`'s verdict, row by row). A CPU tensor
    takes `check_election_safety_plain`; a CUDA tensor launches the
    hand-written kernel (ops/election_safety.py) or raises."""
    if obs.device.type == "cpu":
        return check_election_safety_plain(obs, valid_len)
    from ..ops.election_safety import election_safety

    return election_safety(obs, valid_len)
