"""Distributed Queue backed by an actor (ref analog:
python/ray/util/queue.py:20)."""

from __future__ import annotations

import asyncio
from typing import Any, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self._q: asyncio.Queue = asyncio.Queue(maxsize)

    async def put(self, item, timeout: Optional[float] = None):
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    def get_nowait_batch(self, n: int) -> list:
        out = []
        while len(out) < n:
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()


class Queue:
    """Multi-producer multi-consumer queue usable from any worker: a thin
    client over a dedicated (async) queue actor."""

    def __init__(self, maxsize: int = 0, actor_options: dict | None = None):
        import ray_tpu_torch as rt

        cls = rt.remote(**(actor_options or {}))(_QueueActor)
        self.actor = cls.remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None):
        import ray_tpu_torch as rt

        if not block:
            if not rt.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        if not rt.get(self.actor.put.remote(item, timeout)):
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch as rt

        if not block:
            ok, item = rt.get(self.actor.get_nowait.remote())
        else:
            ok, item = rt.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def get_nowait_batch(self, num_items: int) -> list:
        import ray_tpu_torch as rt

        return rt.get(self.actor.get_nowait_batch.remote(num_items))

    def put_async(self, item: Any):
        """Fire-and-forget put returning the ObjectRef."""
        return self.actor.put.remote(item, None)

    def qsize(self) -> int:
        import ray_tpu_torch as rt

        return rt.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        import ray_tpu_torch as rt

        return rt.get(self.actor.empty.remote())

    def full(self) -> bool:
        import ray_tpu_torch as rt

        return rt.get(self.actor.full.remote())

    def shutdown(self):
        import ray_tpu_torch as rt

        rt.kill(self.actor)
