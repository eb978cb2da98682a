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
(dag/device_channel.py) ride the same framing. A card-to-card path (NCCL)
is ROADMAP.md item 6.

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


def host_shard_view(value):
    """torch.Tensor -> one host numpy view of its payload (counterpart of
    the TPU build's single-shard view: a tensor lives on one device, so it
    is one shard, and nothing is gathered). A CUDA tensor is copied to
    host memory once; a contiguous CPU tensor is viewed in place. bf16,
    which numpy lacks, travels as its bits (a uint16 view); `dtype_name`
    names the dtype to rebuild. A numpy array passes through."""
    import numpy as np

    torch = sys.modules.get("torch")
    if torch is None or not isinstance(value, torch.Tensor):
        return np.asarray(value)
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
    a CUDA context. No card is pinned per lease, so on a host with a card
    every process sees it: a CPU-leased actor that reads a device edge
    must not build a context there."""
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
        self._lock = threading.Lock()

    def put(self, oid: ObjectID, value: Any):
        with self._lock:
            self._objects[oid] = value

    def get(self, oid: ObjectID):
        with self._lock:
            return self._objects.get(oid)

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._objects

    def delete(self, oid: ObjectID):
        with self._lock:
            self._objects.pop(oid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)

    def nbytes(self) -> int:
        with self._lock:
            return sum(getattr(v, "nbytes", 0)
                       for v in self._objects.values())
