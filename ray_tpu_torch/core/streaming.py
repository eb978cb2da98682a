"""Streaming generator returns (ref analog: ObjectRefGenerator in
python/ray/_raylet.pyx:284 + core_worker/generator_waiter.cc).

A task or actor method declared with ``num_returns="streaming"`` executes
as a Python generator on the worker; every yielded item is pushed to the
owner as it is produced (``generator_item`` RPC) and surfaces to the
caller through :class:`ObjectRefGenerator` — an iterator of
``ObjectRef``s. Backpressure: the owner delays the ack of an item while
more than ``generator_backpressure_num_objects`` items sit unconsumed,
which blocks the producing worker (its report call is synchronous), the
same flow-control idea as the reference's generator_waiter.
"""

from __future__ import annotations

import asyncio
from typing import Any

from ray_tpu_torch._internal.ids import ObjectID, TaskID


class _StreamState:
    """Owner-side state of one streaming task (lives on the IO loop)."""

    def __init__(self, task_id: TaskID, backpressure: int):
        self.task_id = task_id
        self.backpressure = backpressure
        self.items: dict[int, ObjectID] = {}   # arrived, not yet consumed
        self.next_read = 0                     # caller's cursor
        self.total: int | None = None          # set by stream end
        self.error: Exception | None = None    # stream aborted
        self.dropped = False                   # consumer closed the stream
        self._arrived = asyncio.Event()
        self._consumed = asyncio.Event()

    # ---- producer side (rpc handlers) ----
    def buffered(self) -> int:
        return len(self.items)

    async def wait_capacity(self):
        while not self.dropped and self.buffered() >= self.backpressure:
            self._consumed.clear()
            await self._consumed.wait()

    def drop(self):
        """Consumer abandoned the stream: unblock any backpressured
        producer ack so the worker sees alive=False and stops."""
        self.dropped = True
        self._consumed.set()
        self._arrived.set()

    def push(self, index: int, oid: ObjectID):
        self.items[index] = oid
        self._arrived.set()

    def finish(self, total: int):
        self.total = total
        self._arrived.set()

    def abort(self, error: Exception):
        self.error = error
        self._arrived.set()

    # ---- consumer side ----
    async def next_object(self) -> ObjectID | None:
        """Returns the next ObjectID, or None when exhausted."""
        while True:
            if self.next_read in self.items:
                oid = self.items.pop(self.next_read)
                self.next_read += 1
                self._consumed.set()
                return oid
            if self.error is not None:
                raise self.error
            if self.total is not None and self.next_read >= self.total:
                return None
            self._arrived.clear()
            await self._arrived.wait()


class ObjectRefGenerator:
    """Iterator over a streaming task's return refs (ref:
    _raylet.pyx:284). Each __next__ yields an ObjectRef whose value is
    already local to the owner; rt.get() on it is cheap."""

    def __init__(self, core_worker, task_id: TaskID):
        self._cw = core_worker
        self._task_id = task_id

    @property
    def task_id(self) -> TaskID:
        return self._task_id

    def close(self):
        """Abandon the stream: the producer's next report is nacked and it
        stops; buffered (unconsumed) items are freed from the owner's
        stores — a disconnected consumer must not leak item values."""
        cw = self._cw
        stream = cw._streams.pop(self._task_id, None)
        if stream is not None:
            def _drop():
                stream.drop()
                for oid in stream.items.values():
                    cw.memory_store.delete(oid)
                    meta = cw.object_meta.pop(oid, None)
                    if meta is not None and meta.in_shm:
                        # shm items were pinned on the producer node by
                        # object_created; free them there too or they
                        # leak store/spill space until node restart
                        cw._free_shm_copies(meta)
                stream.items.clear()
            try:
                cw.io.loop.call_soon_threadsafe(_drop)
            except Exception:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        from ray_tpu_torch.core.object_ref import ObjectRef

        stream = self._cw._streams.get(self._task_id)
        if stream is None:
            raise StopIteration
        oid = self._cw.io.run(stream.next_object())
        if oid is None:
            self._cw._streams.pop(self._task_id, None)
            raise StopIteration
        return ObjectRef(oid, self._cw.worker_info)

    def __aiter__(self):
        return self

    async def __anext__(self):
        """Async variant for asyncio consumers (Serve streaming). Must be
        awaited from a foreign loop, not the core worker's IO loop."""
        from ray_tpu_torch.core.object_ref import ObjectRef

        stream = self._cw._streams.get(self._task_id)
        if stream is None:
            raise StopAsyncIteration
        fut = self._cw.io.spawn(stream.next_object())
        oid = await asyncio.wrap_future(fut)
        if oid is None:
            self._cw._streams.pop(self._task_id, None)
            raise StopAsyncIteration
        return ObjectRef(oid, self._cw.worker_info)
