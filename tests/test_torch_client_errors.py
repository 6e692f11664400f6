"""The port's error taxonomy (`client/errors.py`) against the reference's.

Every case of the reference's tests/test_client_errors.py (the
taxonomy and the isinstance ladder's order) goes through both packages'
`classify_error` and `with_errors`: the (definite?, kind, description)
triples and the completed ops (type, error) must be equal, and an error
that is not a client error must surface from both."""

import socket

import pytest
import torch

from jepsen_jgroups_raft_tpu.client import errors as ref_errors
from jepsen_jgroups_raft_tpu.history.ops import Op as RefOp
from jepsen_jgroups_raft_tpu_torch.client import errors
from jepsen_jgroups_raft_tpu_torch.history.ops import INVOKE, Op

torch.set_num_threads(1)


def _exc(pkg, name, *args):
    """An exception of the taxonomy's `name` in `pkg`, or a builtin."""
    cls = getattr(pkg, name, None) or {
        "TimeoutError": TimeoutError, "socket.timeout": socket.timeout,
        "ConnectionRefusedError": ConnectionRefusedError,
        "ConnectionResetError": ConnectionResetError, "OSError": OSError,
        "ZeroDivisionError": ZeroDivisionError,
        "ValueError": ValueError}[name]
    return cls(*args)


#: (exception, its args, op f, idempotent fs) — the reference's cases
CASES = [
    ("ClientTimeout", ("10s",), "write", ()),
    ("ClientTimeout", (), "read", ("read",)),
    ("ConnectFailed", (), "write", ()),
    ("NotLeader", ("I'm not the leader",), "write", ()),
    ("SocketBroken", (), "write", ()),
    ("SocketBroken", ("reset",), "write", ()),
    ("ClientTimeout", ("10s",), "write", ("read",)),
    ("TimeoutError", (), "write", ()),
    ("socket.timeout", (), "write", ()),
    ("ConnectionRefusedError", (), "write", ()),
    ("ConnectionResetError", (), "write", ()),
    ("OSError", ("EPIPE",), "write", ()),
    ("SocketBroken", (), "read", ("read",)),
    ("TimeoutError", (), "read", ("read",)),
    ("SocketBroken", (), "write", ("read",)),
    ("NotLeader", (), "read", ("read",)),
    ("ConnectFailed", ("refused",), "cas", ("read",)),
]


def _raising(exc):
    def invoke(test, op):
        raise exc
    return invoke


@pytest.mark.parametrize("name,args,f,idem", CASES,
                         ids=[f"{c[0]}-{c[2]}-{i}"
                              for i, c in enumerate(CASES)])
def test_classify_and_with_errors_equal_the_reference(name, args, f, idem):
    mine = errors.classify_error(_exc(errors, name, *args))
    ref = ref_errors.classify_error(_exc(ref_errors, name, *args))
    assert mine == ref
    value = None if f == "read" else 1
    out = errors.with_errors(_raising(_exc(errors, name, *args)), {},
                             Op(process=0, type=INVOKE, f=f, value=value),
                             idempotent=idem)
    ref_out = ref_errors.with_errors(
        _raising(_exc(ref_errors, name, *args)), {},
        RefOp(process=0, type=INVOKE, f=f, value=value), idempotent=idem)
    assert (out.type, out.error, out.f, out.value, out.process) == \
        (ref_out.type, ref_out.error, ref_out.f, ref_out.value,
         ref_out.process)


@pytest.mark.parametrize("name", ["ZeroDivisionError", "ValueError"])
def test_non_client_errors_surface_from_both(name):
    for pkg, op_cls in ((errors, Op), (ref_errors, RefOp)):
        with pytest.raises(_exc(pkg, name).__class__):
            pkg.with_errors(_raising(_exc(pkg, name)), {},
                            op_cls(process=0, type=INVOKE, f="write",
                                   value=1))
        with pytest.raises(_exc(pkg, name).__class__):
            pkg.classify_error(_exc(pkg, name))


def test_success_passes_through_both():
    for pkg, op_cls in ((errors, Op), (ref_errors, RefOp)):
        out = pkg.with_errors(lambda t, o: o.replace(type="ok"), {},
                              op_cls(process=0, type=INVOKE, f="write",
                                     value=1))
        assert out.type == "ok" and out.error is None


def test_the_ladder_types_nest_as_the_reference():
    for name in ("ClientTimeout", "ConnectFailed", "NotLeader",
                 "SocketBroken"):
        mine, ref = getattr(errors, name), getattr(ref_errors, name)
        assert [c.__name__ for c in mine.__mro__] == \
            [c.__name__ for c in ref.__mro__]
