"""Device-resident objects: ObjectRefs whose payload lives in the holder
process (a CUDA tensor in the card's memory) instead of the host object
store.

Ref analog: the reference's GPU-tensor channels
(python/ray/experimental/channel/torch_tensor_nccl_channel.py,
core_worker/experimental_mutable_object_manager.cc) — tensors move
worker-to-worker without a host pickle bounce. Here that is (a) zero-copy
handoff within a process, and (b) a host-staged transfer between worker
processes (same host or across hosts) that never pickles the device
buffer — raw bytes + dtype/shape metadata. A card-to-card path (NCCL)
comes with the device channels of ROADMAP.md item 3.

The holder of a device object is a WORKER PROCESS (not a node). `rt.get`
in the holder returns the same torch.Tensor object; `rt.get` elsewhere
fetches raw bytes from the holder over RPC and rebuilds the tensor on the
consumer's device: the CUDA card when the consumer's process has one,
else the CPU. Any tensor rides this plane, CPU tensors included (as the
TPU build takes any jax.Array, CPU arrays included), so the plane runs on
hosts without a card.

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


def serialize_array(tensor) -> tuple:
    """torch.Tensor -> (raw host bytes, dtype name, shape). The bytes are
    staged through host memory once; any dtype (bf16 included) travels as
    its raw bytes."""
    import torch

    host = tensor.detach().to("cpu").contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy().tobytes()
    return (raw, str(host.dtype).removeprefix("torch."), tuple(host.shape))


def deserialize_array(payload: tuple):
    """(bytes, dtype name, shape) -> torch.Tensor on this process's device:
    the CUDA card when there is one, else the CPU."""
    import torch

    raw, dtype, shape = payload
    dtype = getattr(torch, dtype)
    if raw:
        flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        host = flat.view(dtype).reshape(shape)
    else:
        host = torch.empty(shape, dtype=dtype)
    return host.to("cuda") if torch.cuda.is_available() else host


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
