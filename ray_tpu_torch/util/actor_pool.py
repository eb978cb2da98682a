"""ActorPool: schedule a stream of work over a fixed set of actors (ref
analog: python/ray/util/actor_pool.py:13).

Error-safety: the actor is returned to the pool (and pending work
redispatched) BEFORE the result is fetched, so a raising task neither
strands its actor nor blocks queued submissions.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable


class ActorPool:
    def __init__(self, actors: list):
        self._idle = list(actors)
        self._future_to_actor: dict = {}        # future -> (index, actor)
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list[tuple[Callable, Any]] = []

    def submit(self, fn: Callable, value: Any):
        """fn(actor, value) -> ObjectRef, e.g.
        pool.submit(lambda a, v: a.double.remote(v), 1)."""
        if self._idle:
            actor = self._idle.pop()
            self._dispatch(fn, value, actor)
        else:
            self._pending_submits.append((fn, value))

    def _dispatch(self, fn: Callable, value: Any, actor):
        future = fn(actor, value)
        self._future_to_actor[future] = (self._next_task_index, actor)
        self._index_to_future[self._next_task_index] = future
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def get_next(self, timeout: float | None = None) -> Any:
        """Next result in submission order. A timeout leaves the task in
        the pool (retryable); a task error returns its actor to the pool
        and re-raises."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.common import GetTimeoutError

        if not self.has_next():
            raise StopIteration("no more results")
        # skip indices already consumed by get_next_unordered
        while (self._next_return_index < self._next_task_index
               and self._next_return_index not in self._index_to_future):
            self._next_return_index += 1
        idx = self._next_return_index
        future = self._index_to_future.get(idx)
        assert future is not None, "pool bookkeeping out of sync"
        return self._consume(idx, future, timeout, GetTimeoutError, rt)

    def get_next_unordered(self, timeout: float | None = None) -> Any:
        """Next result in completion order."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.common import GetTimeoutError

        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = rt.wait(list(self._future_to_actor), num_returns=1,
                           timeout=timeout)
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        future = ready[0]
        idx, _ = self._future_to_actor[future]
        return self._consume(idx, future, None, GetTimeoutError, rt)

    def _consume(self, idx: int, future, timeout, GetTimeoutError, rt):
        try:
            value = rt.get(future, timeout=timeout)
        except GetTimeoutError:
            raise TimeoutError(f"result for task {idx} not ready "
                               f"within {timeout}s")  # task stays retryable
        except Exception:
            self._finish_task(idx, future)
            raise
        self._finish_task(idx, future)
        return value

    def _finish_task(self, idx: int, future):
        self._index_to_future.pop(idx, None)
        if idx == self._next_return_index:
            self._next_return_index += 1
        self._return_actor_for(future)

    def _return_actor_for(self, future):
        _, actor = self._future_to_actor.pop(future)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self._dispatch(fn, value, actor)
        else:
            self._idle.append(actor)

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor):
        self._idle.append(actor)
