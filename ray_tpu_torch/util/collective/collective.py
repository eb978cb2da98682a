"""Out-of-band collectives between actors/tasks (ref analog:
python/ray/util/collective/collective.py:120,258,423,472,531).

Two planes, per SURVEY.md §2.5:
  * **Device plane** — NCCL collectives between cards
    (``torch.distributed``); not ported yet (ROADMAP.md item 6), so
    ``backend="nccl"`` raises.
  * **Host plane** — this module (the port of ray_tpu/util/collective):
    rendezvous + CPU collectives between separate processes
    (actors/tasks), the analog of the reference's Gloo groups with GCS-KV
    rendezvous (collective_group/nccl_collective_group.py:29
    `Rendezvous`). Arrays travel as numpy; a ``torch.Tensor`` argument is
    copied to the host first, and results come back as numpy, as the
    JAX package returns numpy for a ``jax.Array``.

Rendezvous rides the GCS KV store exactly like the reference's
NCCLUniqueId exchange: rank 0 starts a store server and publishes its
address under `collective/<group>/store`; peers poll the key.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Sequence

import numpy as np

from ray_tpu_torch.util.collective.store import (PeerServer, REDUCE_UFUNCS,
                                                 StoreServer, peer_send,
                                                 store_call)

_NS = "collective"
_groups: dict[str, "CollectiveGroup"] = {}
_groups_lock = threading.Lock()


def _core_worker():
    from ray_tpu_torch.core.object_ref import get_core_worker
    from ray_tpu_torch.core.runtime import get_runtime_context

    cw = get_core_worker()
    if cw is not None:
        return cw
    return get_runtime_context().core_worker


def _kv_put(key: str, value, overwrite: bool = True):
    import cloudpickle

    cw = _core_worker()
    cw.io.run(cw.gcs.kv_put(key, cloudpickle.dumps(value), namespace=_NS,
                            overwrite=overwrite))


def _kv_get(key: str):
    import cloudpickle

    cw = _core_worker()
    raw = cw.io.run(cw.gcs.kv_get(key, namespace=_NS))
    return None if raw is None else cloudpickle.loads(raw)


def _kv_del(key: str):
    cw = _core_worker()
    cw.io.run(cw.gcs.kv_del(key, namespace=_NS))


def _kv_wait(key: str, timeout: float) -> Any:
    deadline = time.monotonic() + timeout
    while True:
        val = _kv_get(key)
        if val is not None:
            return val
        if time.monotonic() >= deadline:
            raise TimeoutError(f"rendezvous key {key!r} never appeared")
        time.sleep(0.02)


def _host(array):
    """``np.asarray`` that also takes a ``torch.Tensor`` (on any device):
    the tensor is copied to the host. torch is only consulted when the
    caller already imported it. bf16 has no numpy dtype here, so a bf16
    tensor is refused rather than silently widened."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(array, torch.Tensor):
        if array.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 tensor has no numpy dtype; cast it "
                            "(for example .float()) before a host "
                            "collective")
        return array.detach().cpu().numpy()
    return np.asarray(array)


def _host_ip() -> str:
    # the node manager address is the host's reachable IP on multi-host
    # clusters (workers export it at spawn; see core/worker_main.py)
    addr = os.environ.get("RAYT_NODE_ADDR")
    if addr:
        return addr.rsplit(":", 1)[0]
    return os.environ.get("RAYT_NODE_IP", "127.0.0.1")


class CollectiveGroup:
    """One logical communicator: world_size ranks over the TCP store."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 timeout: float = 60.0):
        if not (0 <= rank < world_size):
            raise ValueError(f"rank {rank} out of range [0, {world_size})")
        self.name = group_name
        self.world_size = world_size
        self.rank = rank
        self._seq: dict[str, int] = {}
        self._seq_lock = threading.Lock()
        self._store: StoreServer | None = None
        self.peer = PeerServer()
        _kv_put(f"{group_name}/peer/{rank}", (_host_ip(), self.peer.port))
        if rank == 0:
            self._store = StoreServer(world_size)
            _kv_put(f"{group_name}/store", (_host_ip(), self._store.port))
        self.store_addr = tuple(_kv_wait(f"{group_name}/store", timeout))
        self._peer_addrs: dict[int, tuple[str, int]] = {}
        self.barrier()  # everyone up before any op

    # ------------------------------------------------------------- plumbing
    def _next(self, kind: str) -> str:
        with self._seq_lock:
            n = self._seq.get(kind, 0)
            self._seq[kind] = n + 1
        return f"{kind}#{n}"

    def _call(self, kind: str, payload, timeout: float = 300.0):
        return store_call(self.store_addr, kind, self._next(kind), self.rank,
                          payload, timeout)

    def _peer_addr(self, rank: int) -> tuple[str, int]:
        addr = self._peer_addrs.get(rank)
        if addr is None:
            addr = tuple(_kv_wait(f"{self.name}/peer/{rank}", 60.0))
            self._peer_addrs[rank] = addr
        return addr

    # ----------------------------------------------------------- collectives
    def barrier(self, timeout: float = 300.0):
        self._call("barrier", None, timeout)

    # arrays at/above this ride the bandwidth-optimal peer ring instead of
    # the rank-0 star (the star serializes world_size full copies through
    # one host; the ring moves 2*(w-1)/w of the array per rank — the Gloo
    # ring the reference uses for big CPU tensors,
    # gloo_collective_group.py)
    RING_THRESHOLD_BYTES = 1 << 20

    def allreduce(self, array, op: str = "sum", timeout: float = 300.0):
        arr = _host(array)
        if (arr.nbytes >= self.RING_THRESHOLD_BYTES
                and self.world_size > 1 and op in REDUCE_UFUNCS):
            return self._ring_allreduce(arr, op, timeout)
        return self._call(f"allreduce:{op}", arr, timeout)

    def _ring_allreduce(self, arr: "np.ndarray", op: str,
                        timeout: float) -> "np.ndarray":
        """Classic two-phase ring: w-1 reduce-scatter steps then w-1
        allgather steps over the per-rank peer servers; each rank sends
        to rank+1 and receives from rank-1. Peer sends buffer in the
        receiver's inbox, so the ring cannot rendezvous-deadlock."""
        w, r = self.world_size, self.rank
        ufunc = REDUCE_UFUNCS[op]
        flat = arr.reshape(-1)
        # views, not copies: steps REBIND chunks[i] (never mutate), and
        # reduce results are fresh arrays anyway
        chunks = list(np.array_split(flat, w))
        # NEGATIVE tag namespace: user send()/recv() tags are >= 0, so
        # ring traffic can never collide with a buffered p2p payload from
        # the ring predecessor. The shared per-kind sequence numbers
        # (drawn in the same order on every rank) keep concurrent
        # allreduces separate.
        base = -1 - int(self._next("ring").split("#")[1]) * 4096
        nxt = self._peer_addr((r + 1) % w)
        prv = (r - 1) % w
        for step in range(w - 1):               # reduce-scatter
            send_idx = (r - step) % w
            recv_idx = (r - step - 1) % w
            peer_send(nxt, r, base - step, chunks[send_idx],
                      timeout=timeout)
            got = self.peer.recv(prv, base - step, timeout)
            chunks[recv_idx] = ufunc(chunks[recv_idx], got)
        for step in range(w - 1):               # allgather
            send_idx = (r + 1 - step) % w
            recv_idx = (r - step) % w
            peer_send(nxt, r, base - 2048 - step, chunks[send_idx],
                      timeout=timeout)
            chunks[recv_idx] = self.peer.recv(prv, base - 2048 - step,
                                              timeout)
        return np.concatenate(chunks).reshape(arr.shape).astype(
            arr.dtype, copy=False)

    def allgather(self, array, timeout: float = 300.0) -> list:
        return self._call("gather", _host(array), timeout)

    def reducescatter(self, array, op: str = "sum", timeout: float = 300.0):
        """Reduce across ranks, then scatter along axis 0 (rank i gets the
        i-th split of the reduced array)."""
        return self._call(f"reducescatter:{op}", _host(array), timeout)

    def broadcast(self, array=None, src_rank: int = 0, timeout: float = 300.0):
        payload = _host(array) if self.rank == src_rank else None
        return self._call("bcast", payload, timeout)

    def gather_obj(self, obj: Any, timeout: float = 300.0) -> list:
        """Allgather of arbitrary picklable objects (rendezvous payloads)."""
        return self._call("gather", obj, timeout)

    def send(self, array, dst_rank: int, tag: int = 0):
        if dst_rank == self.rank:
            raise ValueError("cannot send to self")
        if tag < 0:
            raise ValueError("negative tags are reserved for ring traffic")
        peer_send(self._peer_addr(dst_rank), self.rank, tag, _host(array))

    def recv(self, src_rank: int, tag: int = 0, timeout: float = 300.0):
        if src_rank == self.rank:
            raise ValueError("cannot recv from self")
        if tag < 0:
            raise ValueError("negative tags are reserved for ring traffic")
        return self.peer.recv(src_rank, tag, timeout)

    def destroy(self):
        # drop the registry entry too, so the same group name can be
        # re-initialized later (destroy_collective_group and direct
        # group.destroy() behave identically)
        with _groups_lock:
            if _groups.get(self.name) is self:
                _groups.pop(self.name)
        if self._store is not None:
            _kv_del(f"{self.name}/store")
            self._store.close()
            self._store = None
        _kv_del(f"{self.name}/peer/{self.rank}")
        cw = _core_worker()
        actor_id = getattr(cw, "actor_id", None)
        if actor_id is not None:
            # drop any declarative rank record so a later collective call
            # errors ("not initialized") instead of lazily re-joining a
            # destroyed group
            _kv_del(f"{self.name}/decl/{actor_id.hex()}")
        self.peer.close()


# ------------------------------------------------------------------ module API
def _check_backend(backend: str) -> None:
    if backend == "nccl":
        raise NotImplementedError(
            "backend='nccl' (collectives between cards) is not ported yet "
            "(ROADMAP.md item 6); the host tier takes 'tcp', 'gloo' or "
            "'auto'")
    if backend not in ("tcp", "gloo", "auto"):
        raise ValueError(f"unsupported backend {backend!r}; the host tier "
                         "takes 'tcp', 'gloo' or 'auto'")


def init_collective_group(world_size: int, rank: int, backend: str = "tcp",
                          group_name: str = "default") -> CollectiveGroup:
    """Imperative group setup — call in every participating actor/task
    (ref: util/collective/collective.py:120)."""
    _check_backend(backend)
    with _groups_lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
    group = CollectiveGroup(group_name, world_size, rank)
    with _groups_lock:
        _groups[group_name] = group
    return group


def create_collective_group(actors: Sequence, world_size: int,
                            ranks: Sequence[int], backend: str = "tcp",
                            group_name: str = "default") -> None:
    """Declarative setup from the driver (ref:
    util/collective/collective.py:151): records the rank assignment in GCS
    KV; each actor lazily joins on its first collective call."""
    _check_backend(backend)
    if len(actors) != len(ranks) or len(set(ranks)) != len(ranks):
        raise ValueError("actors/ranks must be same length and ranks unique")
    for actor, rank in zip(actors, ranks):
        _kv_put(f"{group_name}/decl/{actor._actor_id.hex()}",
                (rank, world_size, backend))


def _lazy_join(group_name: str) -> CollectiveGroup:
    cw = _core_worker()
    actor_id = getattr(cw, "actor_id", None)
    if actor_id is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            "process; call init_collective_group() first")
    decl = _kv_get(f"{group_name}/decl/{actor_id.hex()}")
    if decl is None:
        raise RuntimeError(
            f"collective group {group_name!r}: this actor has no declared "
            "rank (create_collective_group was not called for it)")
    rank, world_size, backend = decl
    return init_collective_group(world_size, rank, backend, group_name)


def get_group(group_name: str = "default") -> CollectiveGroup:
    with _groups_lock:
        group = _groups.get(group_name)
    if group is None:
        group = _lazy_join(group_name)
    return group


def is_group_initialized(group_name: str = "default") -> bool:
    with _groups_lock:
        return group_name in _groups


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()


def get_rank(group_name: str = "default") -> int:
    return get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return get_group(group_name).world_size


def allreduce(array, op: str = "sum", group_name: str = "default"):
    return get_group(group_name).allreduce(array, op)


def allgather(array, group_name: str = "default") -> list:
    return get_group(group_name).allgather(array)


def reducescatter(array, op: str = "sum", group_name: str = "default"):
    return get_group(group_name).reducescatter(array, op)


def broadcast(array=None, src_rank: int = 0, group_name: str = "default"):
    return get_group(group_name).broadcast(array, src_rank)


def barrier(group_name: str = "default"):
    get_group(group_name).barrier()


def send(array, dst_rank: int, group_name: str = "default", tag: int = 0):
    get_group(group_name).send(array, dst_rank, tag)


def recv(src_rank: int, group_name: str = "default", tag: int = 0):
    return get_group(group_name).recv(src_rank, tag)
