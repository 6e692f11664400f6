"""The closure kernels' plain versions against the reference's programs.

`cycle_closure_plain` is held to the reference's `make_cycle_closure`
(B7) and `cycle_closure_tiled_plain` to `make_cycle_closure_tiled` (B8),
both run on CPU JAX as the reference's own tests run them, bitwise on
every entry of `closed` and on `has_cycle`: seeded random digraphs,
dense DAGs, a long chain, a planted Hamiltonian cycle and zero-padded
rows, at every node bucket from 4 to 512 and at 768 with T = 256 and
T = 128. The bit layout (`pack_bits`, `pack_adjacency`) and the
dispatcher's CPU routing are checked too. The CUDA kernels are held to
these plain versions on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py `cycle_kernel`).
"""

import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.ops import kernel_ir as ref_ir
from jepsen_jgroups_raft_tpu_torch.ops import cycle_closure as cc
from jepsen_jgroups_raft_tpu_torch.ops import kernel_ir

torch.set_num_threads(1)

#: the node buckets the cycle tier emits up to the monolithic cap
BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def graphs(N: int, seed: int, kinds=("random", "dag", "chain", "cycle",
                                     "padded")) -> np.ndarray:
    """[len(kinds), N, N] int32 0/1 graphs of bucket N (nodes shuffled)."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in kinds:
        n = max(2, N - N // 5) if kind == "padded" else N
        if kind in ("random", "padded"):
            g = (rng.random((n, n)) < 1.5 / n).astype(np.int32)
        elif kind == "dag":
            g = np.triu((rng.random((n, n)) < 0.3).astype(np.int32), 1)
        else:
            g = np.zeros((n, n), np.int32)
            g[np.arange(n - 1), np.arange(1, n)] = 1
            if kind == "cycle":
                g[n - 1, 0] = 1
        np.fill_diagonal(g, 0)
        p = rng.permutation(n)
        full = np.zeros((N, N), np.int32)
        full[:n, :n] = g[np.ix_(p, p)]
        out.append(full)
    return np.stack(out)


def _same(ours, theirs):
    has, closed = ours
    r_has, r_closed = (np.asarray(x) for x in theirs)
    assert has.dtype == torch.bool and closed.dtype == torch.int32
    assert has.numpy().tolist() == r_has.tolist()
    assert np.array_equal(closed.numpy(), r_closed)
    return has.numpy()


@pytest.mark.parametrize("N", BUCKETS)
def test_monolithic_closure_matches_reference(N):
    kinds = (("random", "chain", "cycle") if N >= 384 else
             ("random", "dag", "chain", "cycle", "padded"))
    adj = graphs(N, N, kinds)
    has = _same(cc.cycle_closure_plain(torch.from_numpy(adj)),
                ref_ir.make_cycle_closure(N)(adj))
    assert has[kinds.index("cycle")] and not has[kinds.index("chain")]


@pytest.mark.parametrize("N,T", [(768, 256), (768, 128), (96, 32),
                                 (64, 16)])
def test_tiled_closure_matches_reference(N, T):
    kinds = ("random", "chain", "cycle") if N == 768 else \
        ("random", "dag", "chain", "cycle", "padded")
    adj = graphs(N, 7 * N + T, kinds)
    ours = cc.cycle_closure_tiled_plain(torch.from_numpy(adj), T)
    has = _same(ours, ref_ir.make_cycle_closure_tiled(N, T)(adj))
    assert has[kinds.index("cycle")] and not has[kinds.index("chain")]
    if N < 768:  # the two schedules give one closure
        mono = cc.cycle_closure_plain(torch.from_numpy(adj))
        assert torch.equal(mono[1], ours[1])


@pytest.mark.parametrize("N,T", [(768, 512), (96, 0), (0, 4), (100, 64)])
def test_tile_that_does_not_divide_raises_as_reference(N, T):
    with pytest.raises(ValueError):
        ref_ir.make_cycle_closure_tiled(N, T)
    with pytest.raises(ValueError):
        cc.cycle_closure_tiled_plain(torch.zeros((1, N, N)), T)


def test_tile_helpers_and_caps_match_reference():
    for name in ("CYCLE_MAX_NODES", "CYCLE_MAX_NODES_TILED", "CYCLE_TILE"):
        assert getattr(kernel_ir, name) == getattr(ref_ir, name)
    for n in (4, 6, 96, 512, 768, 1024, 1536, 2048, 3072, 4096, 5000):
        for t in (0, 1, 3, 16, 100, 128, 256, 512, 1024, 9999):
            assert kernel_ir.cycle_closure_tile(n, t) == \
                ref_ir.cycle_closure_tile(n, t)
            assert kernel_ir.cycle_closure_tiles(n, max(t, 1)) == \
                ref_ir.cycle_closure_tiles(n, max(t, 1))
            assert kernel_ir.cycle_closure_tile_bytes(n, t) == \
                ref_ir.cycle_closure_tile_bytes(n, t)
        assert kernel_ir.cycle_adjacency_bytes(n) == \
            ref_ir.cycle_adjacency_bytes(n)


@pytest.mark.parametrize("N", [4, 6, 33, 48, 96, 100])
def test_bit_layout_round_trips(N):
    adj = graphs(N, N + 1)
    t = torch.from_numpy(adj)
    bits = cc.pack_bits(t)
    assert bits.shape == (adj.shape[0], N, (N + 31) // 32)
    assert torch.equal(cc.unpack_bits(bits, N), t)
    host = cc.pack_adjacency(list(adj.astype(np.uint8)), N)
    assert np.array_equal(host, bits.numpy())
    assert np.array_equal(cc.unpack_adjacency(host, N), adj)
    # graphs smaller than the bucket pack zero-padded
    small = cc.pack_adjacency([adj[0][:N // 2, :N // 2]], N)
    pad = np.zeros((N, N), np.int32)
    pad[:N // 2, :N // 2] = adj[0][:N // 2, :N // 2]
    assert np.array_equal(small, cc.pack_bits(torch.from_numpy(
        pad[None])).numpy())


@pytest.mark.parametrize("N", [6, 96, 768])
def test_dispatcher_takes_the_plain_versions_on_the_cpu(N):
    adj = graphs(N, 3 * N, ("random", "chain", "cycle"))
    t = torch.from_numpy(adj)
    has, closed = cc.cycle_closure(t)
    want = (cc.cycle_closure_plain(t) if N <= 512 else
            cc.cycle_closure_tiled_plain(t, 256))
    assert torch.equal(has, want[0]) and torch.equal(closed, want[1])
    b_has, b_closed = cc.cycle_closure_bits(cc.pack_bits(t), N)
    assert torch.equal(b_has, has)
    assert torch.equal(cc.unpack_bits(b_closed, N), closed)
    f_has, none = cc.cycle_closure_bits(cc.pack_bits(t), N,
                                        want_closed=False)
    assert none is None and torch.equal(f_has, has)
    assert cc.launch_counts() == {"cycle_closure": 0,
                                  "cycle_closure_tiled": 0}


def test_dispatcher_refuses_beyond_the_tiled_cap():
    with pytest.raises(ValueError):
        cc.cycle_closure(torch.zeros((1, 4097, 4097), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cc.cycle_closure_bits(torch.zeros((1, 4097, 129), dtype=torch.int32),
                              4097)
