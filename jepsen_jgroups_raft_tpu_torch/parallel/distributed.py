"""Multi-process checking over torch.distributed: the port of the
reference's `jepsen_jgroups_raft_tpu/parallel/distributed.py`.

One process per card (or several processes sharing one), each started
with torchrun's environment. Four layers, smallest dependency first:

* **Runtime** — `maybe_init_distributed` brings up the default process
  group from torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), parsed
  defensively: a malformed or inconsistent value warns, records a
  degrade note and runs single-process, as the reference does with its
  JAX cluster triple. The backend is chosen by a rule before init
  (`choose_backend`): ``nccl`` when every rank of the host has a card of
  its own, ``gloo`` otherwise (the CPU, and ranks sharing one card).

* **Exchange** — `barrier`, `exchange_bytes` and `exchange_i64` ride the
  process group's key-value store (the TCPStore made at init), the
  counterpart of the reference's coordination-service KV: no device
  collective is involved, so they work under every backend. Every
  process must make the same sequence of calls (a shared tag counter,
  two barriers an exchange).

* **Sharded wavefront** — `run_sharded` is the seam `checker.linearizable
  .check_encoded` routes through inside a cluster: each process checks
  its contiguous row shard (`history.packing.shard_bounds`) with the
  ordinary single-process pass, then the per-row verdict codes are
  exchanged, so every process returns the whole batch's verdicts.
  Remote rows carry `_remote_result` stubs, unless a result store every
  process shares is configured (``JGRAFT_RESULT_STORE``, or the service's
  cluster dir) and the caller names the model: then each process
  publishes its rows' full results before the exchange and reads the
  owners' after it (`_detail_exchange`, `service/store.py`), so
  witnesses and counterexamples follow the verdict across processes.

* **Global counts** — `check_batch_global`: per-process packing
  (`history.packing.pack_*_batch_shard`), the dense or mask kernel on
  the rank's own device, which counts B10's verdict counts in the same
  launch, and one ``all_reduce``
  of the two counts — the reference's global-mesh ``psum``.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import os
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..history.packing import shard_bounds  # noqa: F401  (re-exported)
from ..platform import env_int, note_degraded, resolve_device

_log = logging.getLogger(__name__)

#: Wire timeout of the store exchange (barriers and gets), and of the
#: process group: a barrier waits for the slowest shard's check.
DEFAULT_TIMEOUT_MS = 600_000


def distributed_enabled() -> bool:
    """Master gate of the distributed seam: ``JGRAFT_DISTRIBUTED=0`` pins
    single-process behaviour even inside a cluster."""
    return env_int("JGRAFT_DISTRIBUTED", 1, minimum=0) != 0


def exchange_timeout_ms() -> int:
    return env_int("JGRAFT_DISTRIBUTED_TIMEOUT_MS", DEFAULT_TIMEOUT_MS,
                   minimum=1_000)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(milliseconds=exchange_timeout_ms())


def _degrade(note: str) -> None:
    _log.warning("distributed: %s", note)
    note_degraded(note)


# ---------------------------------------------------------------- runtime


class ClusterEnv(NamedTuple):
    """torchrun's view of this process: the store's address and port, the
    world, this process's rank, and its rank and peers on its host."""

    addr: str
    port: int
    world_size: int
    rank: int
    local_rank: int
    local_world_size: int


def parse_cluster_env() -> Optional[ClusterEnv]:
    """This process's `ClusterEnv` from torchrun's variables, or None when
    they are absent (no ``MASTER_ADDR`` or no ``WORLD_SIZE``) or wrong.
    ``RANK`` defaults to 0, ``LOCAL_RANK`` to the rank and
    ``LOCAL_WORLD_SIZE`` to the world (one host). A malformed value (not
    an integer, no ``MASTER_PORT``) or an inconsistent one warns and
    records a degrade note instead of raising: the single-process
    fallback must be loud, not fatal."""
    addr = os.environ.get("MASTER_ADDR")
    world_raw = os.environ.get("WORLD_SIZE")
    if not addr or not world_raw:
        return None
    raw = {k: os.environ.get(k) for k in ("MASTER_PORT", "RANK",
                                          "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    try:
        world = int(world_raw.strip())
        port = int((raw["MASTER_PORT"] or "").strip())
        rank = int((raw["RANK"] or "0").strip() or "0")
        local_rank = int((raw["LOCAL_RANK"] or str(rank)).strip())
        local_world = int((raw["LOCAL_WORLD_SIZE"] or str(world)).strip())
    except ValueError:
        _degrade(f"cluster env malformed (WORLD_SIZE={world_raw!r}, "
                 + ", ".join(f"{k}={v!r}" for k, v in raw.items())
                 + ") — running single-process")
        return None
    if world < 1 or not 0 <= rank < world or not 0 < port < 65536 \
            or not 1 <= local_world <= world \
            or not 0 <= local_rank < local_world:
        _degrade(f"cluster env inconsistent (world_size={world}, "
                 f"rank={rank}, port={port}, local_rank={local_rank}, "
                 f"local_world_size={local_world}) — running "
                 "single-process")
        return None
    return ClusterEnv(addr, port, world, rank, local_rank, local_world)


def choose_backend(local_rank: int, local_world_size: int,
                   device=None) -> Tuple[str, torch.device]:
    """(backend, this rank's device), by rule and before init: on the
    card (`device` None or any CUDA device) ``nccl`` with ``cuda:
    LOCAL_RANK`` when every rank of the host has a card of its own
    (``LOCAL_WORLD_SIZE ≤ torch.cuda.device_count()``), else ``gloo``
    with every rank on ``cuda:0``; on a CPU `device`, ``gloo`` on the
    CPU. Every rank of a host reaches the same backend: the test reads
    only what they share. Without a card and without ``device="cpu"``
    it raises (`resolve_device`)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", torch.device("cpu")
    if local_world_size <= torch.cuda.device_count():
        return "nccl", torch.device("cuda", int(local_rank))
    return "gloo", torch.device("cuda", 0)


#: What `maybe_init_distributed` set up: the store, the rank's device and
#: the backend.
_STATE: dict = {}


def maybe_init_distributed(device=None) -> bool:
    """Bring up the default process group when torchrun's environment is
    present; True iff it is (now) up. Idempotent. `device` names the CPU
    for a CPU cluster (``"cpu"``); otherwise the ranks run on the card
    (`choose_backend`). A failed init warns, records a degrade note and
    returns False, as the reference's does; the backend is never chosen
    by catching a failure."""
    if is_initialized():
        return True
    env = parse_cluster_env()
    if env is None:
        return False
    backend, dev = choose_backend(env.local_rank, env.local_world_size,
                                  device)
    import torch.distributed as dist

    try:
        store = dist.TCPStore(env.addr, env.port, env.world_size,
                              is_master=env.rank == 0, timeout=_timeout())
        dist.init_process_group(backend, store=store,
                                world_size=env.world_size, rank=env.rank,
                                timeout=_timeout())
    except Exception as e:  # unreachable store, a peer that never came
        _degrade((f"torch.distributed init failed for {env.addr}:"
                  f"{env.port} ({type(e).__name__}: {e}) — running "
                  "single-process")[:300])
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _STATE.update(store=store, device=dev, backend=backend)
    return True


def shutdown_distributed() -> None:
    """Tear the default process group down, if it is up: a barrier, so
    that no rank leaves while another still exchanges through it, then
    `destroy_process_group`; the store and device chosen at init are
    forgotten. A process that returns with its group still up can abort
    at interpreter exit."""
    if is_initialized():
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    _STATE.clear()


def is_initialized() -> bool:
    """Whether the default process group is up."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the cluster; 1 outside one."""
    if not is_initialized():
        return 1
    import torch.distributed as dist

    return int(dist.get_world_size())


def process_index() -> int:
    """This process's rank; 0 outside a cluster."""
    if not is_initialized():
        return 0
    import torch.distributed as dist

    return int(dist.get_rank())


def rank_device() -> torch.device:
    """The device this process checks on: the one `maybe_init_distributed`
    chose, else the card (`resolve_device`), with its index."""
    dev = _STATE.get("device")
    if dev is None:
        dev = resolve_device(None)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def wavefront_active() -> bool:
    """Whether the checker runs the sharded wavefront: a multi-process
    group is up and the env gate allows it."""
    return distributed_enabled() and process_count() > 1


# --------------------------------------------------------------- exchange

#: Exchange sequence counter: every process makes the same sequence of
#: barrier and exchange calls, so a per-process counter yields
#: cluster-identical keys with no coordination of its own.
_SEQ = itertools.count()
#: Rank 0's keys of the last barrier, deleted once every process has
#: reached the next one (by then every process has left it).
_STALE: List[str] = []


def _store():
    """The process group's key-value store: the TCPStore made at init, or
    the default group's store when the group was made elsewhere."""
    store = _STATE.get("store")
    if store is not None:
        return store
    if not is_initialized():
        raise RuntimeError("torch.distributed is not initialized — no "
                           "store to exchange through")
    try:
        from torch.distributed.distributed_c10d import _get_default_store
        store = _get_default_store()
    except (ImportError, RuntimeError) as e:
        raise RuntimeError("the process group's store is unavailable "
                           f"({type(e).__name__}: {e}); cannot exchange "
                           "across processes") from e
    _STATE["store"] = store
    return store


def _delete(store, keys) -> None:
    for k in keys:
        try:
            store.delete_key(k)
        except Exception as e:  # noqa: BLE001 — cleanup only; every
            # process has already read or passed the key
            _log.debug("distributed: store cleanup of %s failed (%s: %s)",
                       k, type(e).__name__, e)


def _barrier(store, name: str) -> None:
    """Every process arrives (one `add` each), the last one opens the
    gate, all wait for it. Keys carry the shared counter, so each
    barrier's keys are its own."""
    key = f"jgraft/b/{name}/{next(_SEQ)}"
    if store.add(f"{key}/n", 1) == process_count():
        store.set(f"{key}/go", b"1")
    store.wait([f"{key}/go"], _timeout())
    if process_index() == 0:
        _delete(store, _STALE)
        _STALE[:] = [f"{key}/n", f"{key}/go"]


def barrier(name: str) -> None:
    """Cluster-wide barrier over the store (no device collective); `name`
    labels its keys."""
    _barrier(_store(), name)


def exchange_bytes(payload: bytes, tag: Optional[str] = None) -> List[bytes]:
    """All-gather one bytes payload per process through the store: set
    own key, barrier, read every key, barrier, then rank 0 deletes the
    keys (a long-lived process must not grow the store without bound).
    Returns the payloads in rank order. Each stored value starts with
    one framing byte, so an empty shard's payload round-trips. Every
    process makes the same calls in the same order."""
    store = _store()
    n, pid = process_count(), process_index()
    base = f"jgraft/kv/{tag or 'x'}/{next(_SEQ)}"
    store.set(f"{base}/{pid}", b"\x01" + bytes(payload))
    _barrier(store, "set")
    out = [bytes(store.get(f"{base}/{i}"))[1:] for i in range(n)]
    _barrier(store, "got")
    if pid == 0:
        _delete(store, [f"{base}/{i}" for i in range(n)])
    return out


def exchange_i64(arr: Sequence[int], tag: Optional[str] = None) \
        -> List[np.ndarray]:
    """All-gather one int64 vector per process (verdict codes, counts);
    shards may contribute different lengths."""
    payload = np.asarray(arr, dtype="<i8").tobytes()
    return [np.frombuffer(raw, dtype="<i8") for raw
            in exchange_bytes(payload, tag=tag)]


# ------------------------------------------------------ sharded wavefront

#: Verdict wire codes (checker.base VALID / INVALID / UNKNOWN).
_CODE_INVALID, _CODE_VALID, _CODE_UNKNOWN = 0, 1, 2


def _verdict_code(result: dict) -> int:
    from ..checker.base import INVALID, VALID

    v = result.get("valid?")
    if v is VALID:
        return _CODE_VALID
    if v is INVALID:
        return _CODE_INVALID
    return _CODE_UNKNOWN


def _remote_result(code: int, owner: int) -> dict:
    """Result of a row checked by another process: the verdict is exact
    (it rode the wire); without a shared result store its detail
    (witness, timing, kernel tag) stays with the owner."""
    from ..checker.base import INVALID, UNKNOWN, VALID

    valid = (VALID if code == _CODE_VALID
             else INVALID if code == _CODE_INVALID else UNKNOWN)
    return {"valid?": valid, "algorithm": "torch",
            "kernel": "remote-shard", "process": owner,
            "decided-tier": "remote-shard"}


def _detail_exchange(model, algorithm: str):
    """(store, key_fn) for the cross-process result-detail exchange, or
    (None, None) — inert unless JGRAFT_RESULT_STORE (or the cluster dir)
    names a directory every process shares, and only usable when the
    caller supplied the model the detail keys hash over."""
    if model is None:
        return None, None
    from ..service.store import detail_fingerprint, detail_store

    store = detail_store()
    if store is None:
        return None, None
    return store, lambda enc: detail_fingerprint(model, algorithm, enc)


def run_sharded(encs: Sequence, check_local: Callable[[list], List[dict]],
                model=None, algorithm: str = "auto") -> List[dict]:
    """The distributed wavefront driver: check only this process's row
    shard through `check_local` (the ordinary single-process pass), then
    exchange the per-row verdict codes so every process returns the
    whole batch's results in submission order: full dicts for its own
    rows, `_remote_result` stubs for the others'. Outside a cluster it is
    `check_local` of the whole batch, with no wire.

    With a shared result store configured (`model` given, and
    JGRAFT_RESULT_STORE or the cluster dir), each process publishes its
    rows' full results before the verdict exchange and reads the owners'
    after it: a remote row whose published result has its exchanged
    verdict becomes that result, with ``"process"`` (its owner) and
    ``"detail-source": "result-store"``. The exchange's barriers order
    every publish before every read, so a shared filesystem needs no
    other synchronisation; a missing, mismatched or degraded record (the
    store refuses degraded ones) leaves that row's stub, never an error.

    Every process must call with the same batch (same rows, same order).
    The cuts are the reference's at granularity 1: a process launches on
    one device, so no fan-out asks for aligned shards."""
    n, pid = process_count(), process_index()
    if n <= 1:
        return check_local(list(encs))
    lo, hi = shard_bounds(len(encs), n, pid)
    local = check_local(list(encs[lo:hi]))
    store, key_fn = _detail_exchange(model, algorithm)
    if store is not None:
        for enc, res in zip(encs[lo:hi], local):
            if isinstance(res, dict) and "valid?" in res:
                store.put_detail(key_fn(enc), res)
    codes = exchange_i64([_verdict_code(r) for r in local])
    results: List[dict] = []
    for p in range(n):
        plo, phi = shard_bounds(len(encs), n, p)
        if p == pid:
            results.extend(local)
            continue
        if len(codes[p]) != phi - plo:
            raise RuntimeError(
                f"shard {p} exchanged {len(codes[p])} verdicts for "
                f"{phi - plo} rows — processes disagree on the batch (the "
                "contract of run_sharded is broken)")
        for row, c in zip(range(plo, phi), codes[p]):
            stub = _remote_result(int(c), p)
            if store is not None:
                detail = store.get_detail(key_fn(encs[row]))
                if detail is not None \
                        and detail.get("valid?") == stub["valid?"]:
                    # the full result rode the store; keep the owner
                    # attribution on top of it
                    detail["process"] = p
                    detail["detail-source"] = "result-store"
                    stub = detail
            results.append(stub)
    return results


# ------------------------------------------------------- global counts

_COLLECTIVES: Optional[bool] = None


def _collective_device() -> torch.device:
    """Where the group's collectives take tensors: the rank's card under
    nccl, the host under gloo."""
    import torch.distributed as dist

    return rank_device() if dist.get_backend() == "nccl" \
        else torch.device("cpu")


def collectives_supported() -> bool:
    """Whether the process group runs collectives: probed once with one
    ``all_reduce`` of ones (itself a collective, so every process reaches
    the probe together). False outside a cluster."""
    global _COLLECTIVES
    if _COLLECTIVES is not None:
        return _COLLECTIVES
    if process_count() <= 1:
        return False
    import torch.distributed as dist

    try:
        ones = torch.ones((1,), dtype=torch.int64,
                          device=_collective_device())
        dist.all_reduce(ones)
        _COLLECTIVES = int(ones.item()) == process_count()  # lint: allow(host-sync) the one-time collectives probe
    except Exception as e:  # noqa: BLE001 — any refusal means "exchange
        # through the store instead"
        _log.info("distributed: collectives unavailable (%s: %s) — "
                  "exchanging through the store", type(e).__name__,
                  str(e)[:200])
        _COLLECTIVES = False
    return _COLLECTIVES


def check_batch_global(model, encs: Sequence) -> Tuple[int, int]:
    """One dense check of a batch spread over every process: each process
    packs and fills only its row shard (`pack_batch_shard` /
    `pack_macro_batch_shard` at batch-global shapes, the batch padded to
    a multiple of the world with EV_PAD rows that `real` masks out), runs
    the dense or mask kernel on its device, which counts B10's counts in
    the same launch (`mesh.sharded_dense_checker`), and one
    ``all_reduce(SUM)`` sums the two counts — on the device tensor under
    nccl, on the host under gloo. Returns the global (n_valid, n_unknown), equal on every
    process. Needs `collectives_supported()` and a dense-eligible batch.

    Unlike the reference, whose CPU backend refuses multiprocess
    computations, this runs on a CPU cluster too (gloo)."""
    import torch.distributed as dist

    from ..history.packing import (macro_events_on, pack_batch_shard,
                                   pack_macro_batch_shard)
    from ..ops.dense_scan import dense_plan
    from .mesh import make_mesh, sharded_dense_checker

    if not collectives_supported():
        raise RuntimeError("collectives unsupported (no process group, or "
                           "its all_reduce failed) — use run_sharded, "
                           "which exchanges through the store")
    encs = list(encs)
    plan = dense_plan(model, encs)
    if plan is None:
        raise ValueError("check_batch_global needs a dense-eligible batch "
                         "(run_sharded handles the general routing)")
    n, pid = process_count(), process_index()
    B = len(encs)
    B_pad = -(-B // n) * n
    lo, hi = shard_bounds(B_pad, n, pid)
    pack = pack_macro_batch_shard if macro_events_on() else pack_batch_shard
    batch = pack(encs, pid, n, n_rows=B_pad)
    val_of = np.zeros((hi - lo,) + plan.val_of.shape[1:],
                      dtype=plan.val_of.dtype)
    real = np.zeros((hi - lo,), dtype=bool)
    n_real = max(0, min(hi, B) - lo)
    val_of[:n_real] = plan.val_of[lo:lo + n_real]
    val_of[n_real:] = plan.val_of[:1]
    real[:n_real] = True
    mesh = make_mesh()
    dev = mesh.device
    fn = sharded_dense_checker(model, mesh, plan.kind, plan.n_slots,
                               plan.n_states, macro_p=batch.get("macro_p"))
    _, _, n_valid, n_unknown = fn(torch.from_numpy(batch["events"]).to(dev),  # lint: allow(host-sync) the shard's inputs go up once (pageable)
                                  torch.from_numpy(val_of).to(dev),  # lint: allow(host-sync) the shard's inputs go up once (pageable)
                                  torch.from_numpy(real).to(dev))  # lint: allow(host-sync) the shard's inputs go up once (pageable)
    counts = torch.stack([n_valid, n_unknown]).to(_collective_device())
    dist.all_reduce(counts)
    n_valid, n_unknown = counts.tolist()  # lint: allow(host-sync) the global counts are the answer
    return int(n_valid), int(n_unknown)
