"""Device-resident objects: ObjectRefs whose payload lives in the holder
process (a CUDA tensor in the card's memory) instead of the host object
store.

Ref analog: the reference's GPU-tensor channels
(python/ray/experimental/channel/torch_tensor_nccl_channel.py,
core_worker/experimental_mutable_object_manager.cc) — tensors move
worker-to-worker without a host pickle bounce. Here that is (a) zero-copy
handoff within a process, and (b) a host-staged transfer between worker
processes (same host or across hosts) that never pickles the device
buffer — raw bytes + dtype/shape metadata; compiled-DAG device edges
(dag/device_channel.py) ride the same framing. Every cross-process value is
host-staged, as in the reference (ray_tpu/core/device_objects.py:12-19).

The holder of a device object is a WORKER PROCESS (not a node). `rt.get`
in the holder returns the same torch.Tensor object; `rt.get` elsewhere
fetches raw bytes from the holder over RPC and rebuilds the tensor on the
consumer's device (``rebuild_device``): the CUDA card in a process that
uses it (a worker leased a GPU, or any process that has already
initialised CUDA), else the CPU. Any tensor rides this plane, CPU tensors
included (as the TPU build takes any jax.Array, CPU arrays included), so
the plane runs on hosts without a card.

torch is imported inside the functions only: a worker that never touches a
tensor boots without it.
"""

from __future__ import annotations

import sys
import threading
from typing import Any

from ray_tpu_torch._internal.ids import ObjectID


def is_device_value(value: Any) -> bool:
    """True for torch.Tensor values, which ride the device plane."""
    torch = sys.modules.get("torch")
    # a process that never imported torch holds no tensor
    return torch is not None and isinstance(value, torch.Tensor)


def dtype_name(value) -> str:
    """The dtype a leaf is rebuilt with: a tensor's torch dtype name
    ("bfloat16", "float32", ...), a numpy array's numpy name (the same
    words for every dtype the two share)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return str(value.dtype).removeprefix("torch.")
    return str(value.dtype)


def _dtensor_type():
    """``torch.distributed.tensor.DTensor`` when the process already
    imported it (a process that never did holds none), else None."""
    mod = sys.modules.get("torch.distributed.tensor")
    return getattr(mod, "DTensor", None)


def is_sharded(value) -> bool:
    """True for a DTensor that some mesh dim shards (or keeps partial):
    its whole value exists only after a gather over the mesh."""
    dtensor = _dtensor_type()
    if dtensor is None or not isinstance(value, dtensor):
        return False
    return not all(p.is_replicate() for p in value.placements)


def host_shard_view(value):
    """torch.Tensor -> one host numpy view of its payload (counterpart of
    the reference's single-shard view). A plain tensor lives on one
    device, so it is one shard, and nothing is gathered: a CUDA tensor is
    copied to host memory once; a contiguous CPU tensor is viewed in
    place. A ``DTensor`` is gathered whole (``full_tensor()``, a
    collective over its mesh, so every rank stages it, as every rank runs
    the same program), except one replicated on every mesh dim, which
    ships its local tensor with no gather (the reference's one-shard
    shortcut, ray_tpu/core/device_objects.py:40-62). bf16, which numpy
    lacks, travels as its bits (a uint16 view); `dtype_name` names the
    dtype to rebuild. A numpy array passes through."""
    import numpy as np

    torch = sys.modules.get("torch")
    if torch is None or not isinstance(value, torch.Tensor):
        return np.asarray(value)
    dtensor = _dtensor_type()
    if dtensor is not None and isinstance(value, dtensor):
        value = (value.full_tensor() if is_sharded(value)
                 else value.to_local())
    host = value.detach().to("cpu").contiguous()
    if host.dtype == torch.bfloat16:
        host = host.view(torch.uint16)
    return host.numpy()


def serialize_array(tensor) -> tuple:
    """torch.Tensor -> (raw host bytes, dtype name, shape). The bytes are
    staged through host memory once; any dtype (bf16 included) travels as
    its raw bytes."""
    return (host_shard_view(tensor).tobytes(), dtype_name(tensor),
            tuple(tensor.shape))


def gpu_lease(resources: dict | None) -> float:
    """The GPUs in a lease's resource demand: its "GPU" entry, or the
    entries a placement-group bundle renames it to ("GPU_pg_<id>_<i>")."""
    return sum(float(v) for k, v in (resources or {}).items()
               if k == "GPU" or k.startswith("GPU_pg_"))


def rebuild_device() -> str:
    """Where this process rebuilds a tensor that arrives as host bytes:
    "cuda" in a process that uses the card, that is one that has already
    initialised CUDA (``torch.cuda.is_initialized()``, the rule
    ``dag.collective.client_fingerprint`` follows) or a worker whose lease
    holds a GPU (``CoreWorker.leased_gpus``, set from the actor's or the
    running task's resource demand); "cpu" anywhere else, without creating
    a CUDA context. A GPU lease pins its worker to the lease's cards, so
    "cuda" there is the lease's first card. A CPU-only lease pins nothing
    and keeps the view of every card of the node: a CPU-leased actor that
    reads a device edge must not build a context there."""
    import torch

    if torch.cuda.is_initialized():
        return "cuda"
    from ray_tpu_torch.core.object_ref import get_core_worker

    cw = get_core_worker()
    if getattr(cw, "leased_gpus", 0) > 0 and torch.cuda.is_available():
        return "cuda"
    return "cpu"


def rebuild_tensor(host_view, dtype: str, shape):
    """A numpy view of raw host bytes -> torch.Tensor of `dtype` (a torch
    dtype name) and `shape` on this process's device (``rebuild_device``).
    A read-only view is copied first (a tensor is writable); the copy to
    the card is synchronous, so the view's buffer may be reused once this
    returns."""
    import numpy as np
    import torch

    if not host_view.flags.writeable:
        host_view = host_view.copy()
    flat = torch.from_numpy(np.ascontiguousarray(host_view).reshape(-1))
    host = flat.view(torch.uint8).view(getattr(torch, dtype)).reshape(shape)
    return host.to("cuda") if rebuild_device() == "cuda" else host


def deserialize_array(payload: tuple):
    """(bytes, dtype name, shape) -> torch.Tensor on this process's device
    (``rebuild_device``)."""
    import numpy as np

    raw, dtype, shape = payload
    return rebuild_tensor(np.frombuffer(bytearray(raw), np.uint8), dtype,
                          shape)


class DeviceObjectStore:
    """Per-process table of device-resident objects (oid -> torch.Tensor).

    The table holds the tensors alive; dropping the table entry releases
    the card's memory. Thread-safe: puts come from executor threads,
    fetches from the IO loop.
    """

    def __init__(self):
        self._objects: dict[ObjectID, Any] = {}
        self._staged: dict[ObjectID, tuple] = {}
        self._lock = threading.Lock()

    def put(self, oid: ObjectID, value: Any):
        """Hold `value`; a sharded DTensor is staged to host bytes now,
        while every rank of its mesh runs the same put: a later fetch is
        served by this rank alone, and the gather is a collective."""
        staged = serialize_array(value) if is_sharded(value) else None
        with self._lock:
            self._objects[oid] = value
            if staged is not None:
                self._staged[oid] = staged

    def payload(self, oid: ObjectID):
        """(raw host bytes, dtype name, shape) of a held object, or None:
        the bytes staged at put for a sharded DTensor, else a fresh
        host copy."""
        with self._lock:
            value = self._objects.get(oid)
            staged = self._staged.get(oid)
        if value is None:
            return None
        return staged if staged is not None else serialize_array(value)

    def get(self, oid: ObjectID):
        with self._lock:
            return self._objects.get(oid)

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._objects

    def delete(self, oid: ObjectID):
        with self._lock:
            self._objects.pop(oid, None)
            self._staged.pop(oid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)

    def nbytes(self) -> int:
        with self._lock:
            return sum(getattr(v, "nbytes", 0)
                       for v in self._objects.values())
