"""The port's CAS register step (`torch_step`) against the reference's
`jax_step` and the scalar `step`, over a grid of values with NIL =
-2^31 and the int32 extremes in it. Tolerance: exact equality (states
are int32, legality is boolean)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_jgroups_raft_tpu.models.register import CasRegister as RefReg
from jepsen_jgroups_raft_tpu.history.packing import encode_history as ref_enc
from jepsen_jgroups_raft_tpu_torch.history.synth import random_valid_history
from jepsen_jgroups_raft_tpu_torch.history.packing import encode_history
from jepsen_jgroups_raft_tpu_torch.models.base import NIL
from jepsen_jgroups_raft_tpu_torch.models.register import (CAS, READ, WRITE,
                                                           CasRegister)

torch.set_num_threads(1)

VALUES = [NIL, NIL + 1, -1, 0, 1, 2, 3, 2**31 - 1]


def _grid(f):
    rows = list(itertools.product(VALUES, VALUES, VALUES))
    s, a, b = (np.asarray(c, dtype=np.int32) for c in zip(*rows))
    return s, np.full_like(s, f), a, b


@pytest.mark.parametrize("f", [READ, WRITE, CAS], ids=["read", "write",
                                                        "cas"])
def test_torch_step_matches_jax_step_and_step(f):
    s, fs, a, b = _grid(f)
    ns_t, lg_t = CasRegister().torch_step(*(torch.from_numpy(x)
                                            for x in (s, fs, a, b)))
    ns_j, lg_j = RefReg().jax_step(*(jnp.asarray(x) for x in (s, fs, a, b)))
    assert ns_t.dtype == torch.int32
    assert np.array_equal(ns_t.numpy(), np.asarray(ns_j))
    assert np.array_equal(lg_t.numpy(), np.asarray(lg_j))
    py = [RefReg().step(int(x), f, int(y), int(z))
          for x, y, z in zip(s, a, b)]
    assert np.array_equal(ns_t.numpy(), np.asarray([p[0] for p in py],
                                                   dtype=np.int32))
    assert np.array_equal(lg_t.numpy(), np.asarray([p[1] for p in py]))


def test_scalar_and_columnar_steps_match_reference():
    for f in (READ, WRITE, CAS):
        s, fs, a, b = _grid(f)
        ns_c, lg_c = CasRegister().step_columnar(s, fs, a, b)
        ns_r, lg_r = RefReg().step_columnar(s, fs, a, b)
        assert np.array_equal(ns_c, ns_r) and np.array_equal(lg_c, lg_r)
        for x, y, z in zip(s[:64], a[:64], b[:64]):
            assert CasRegister().step(int(x), f, int(y), int(z)) == \
                RefReg().step(int(x), f, int(y), int(z))


def test_dense_domain_matches_reference():
    import random

    rng = random.Random(3)
    for _ in range(20):
        h = random_valid_history(rng, "register", n_ops=60, n_procs=4,
                                 crash_p=0.2, value_range=9)
        ev = ref_enc(h, RefReg()).events
        assert CasRegister().dense_domain(ev) == RefReg().dense_domain(ev)
        assert np.array_equal(encode_history(h, CasRegister()).events, ev)
