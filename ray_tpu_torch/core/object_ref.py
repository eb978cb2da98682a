"""ObjectRef: a distributed future naming an immutable object.

Ref analog: python/ray/includes/object_ref + ownership model from
src/ray/core_worker/reference_count.h:66. Each ref embeds its owner's
address so any holder can resolve the object without a directory lookup.
Deserializing a ref in another process registers that process as a
borrower with the owner; dropping the last local Python reference sends a
release. The owner garbage-collects the object when local + borrower
counts hit zero.
"""

from __future__ import annotations

import weakref
from typing import TYPE_CHECKING, Optional

from ray_tpu_torch._internal.ids import ObjectID

if TYPE_CHECKING:
    from ray_tpu_torch.core.common import WorkerInfo

# The process-wide core worker, set by runtime bootstrap. ObjectRef talks to
# it for gets and ref-count events.
_core_worker = None


def set_core_worker(cw) -> None:
    global _core_worker
    _core_worker = cw


def get_core_worker():
    return _core_worker


class ObjectRef:
    __slots__ = ("id", "owner", "_released", "__weakref__")

    def __init__(self, object_id: ObjectID, owner: Optional["WorkerInfo"] = None,
                 *, _add_local_ref: bool = True):
        self.id = object_id
        self.owner = owner
        self._released = False
        cw = _core_worker
        if _add_local_ref and cw is not None:
            cw.reference_counter.add_local_ref(self)

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def get(self, timeout: float | None = None):
        cw = _core_worker
        if cw is None:
            raise RuntimeError("ray_tpu_torch not initialized")
        return cw.get([self], timeout=timeout)[0]

    def __reduce__(self):
        # Serializing a ref hands it to another process: record the pass so
        # the receiving side is registered as a borrower.
        cw = _core_worker
        if cw is not None:
            cw.reference_counter.on_ref_serialized(self)
        return (_deserialize_ref, (self.id, self.owner))

    def __del__(self):
        if not self._released and _core_worker is not None:
            try:
                _core_worker.reference_counter.remove_local_ref(self)
            except Exception:
                pass

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return f"ObjectRef({self.id.hex()[:16]})"

    # Allow `await ref` inside async actors.
    def __await__(self):
        import asyncio

        async def _get():
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(None, self.get)

        return _get().__await__()


def _deserialize_ref(object_id: ObjectID, owner) -> ObjectRef:
    ref = ObjectRef(object_id, owner, _add_local_ref=False)
    cw = _core_worker
    if cw is not None:
        cw.reference_counter.on_ref_deserialized(ref)
    return ref
