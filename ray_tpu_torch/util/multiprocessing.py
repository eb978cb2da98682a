"""Drop-in ``multiprocessing.Pool`` over cluster tasks (ref analog:
python/ray/util/multiprocessing/pool.py — the same API shape, scheduled
onto the cluster instead of local forks, so `Pool(ray_address=...)`
code scales past one host without changes).

Differences from stdlib: `processes` caps in-flight tasks rather than
pinning OS processes (tasks land wherever the scheduler puts them);
initializers run per-batch in an actor pool when given.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Optional

import ray_tpu_torch as rt


class AsyncResult:
    def __init__(self, refs: list, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        vals = rt.get(self._refs, timeout=timeout)
        return vals[0] if self._single else vals

    def wait(self, timeout: Optional[float] = None):
        rt.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = rt.wait(self._refs, num_returns=len(self._refs),
                          timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")
        try:
            rt.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """multiprocessing.Pool API over tasks (ref: util/multiprocessing)."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if not rt.is_initialized():
            rt.init()
        cluster_cpus = int(rt.cluster_resources().get("CPU", 1))
        self._processes = processes or max(1, cluster_cpus)
        self._initializer = initializer
        self._initargs = initargs
        self._closed = False
        self._outstanding: list = []   # every submitted ref, for join()

    # ------------------------------------------------------------- helpers
    def _remote_fn(self, func: Callable):
        from ray_tpu_torch._internal.serialization import ship_code_by_value

        ship_code_by_value(func)
        init, initargs = self._initializer, self._initargs
        if init is not None:
            ship_code_by_value(init)

            def call(*a, **kw):
                # initializer contract: runs in the worker before func
                # (per task here — workers are pooled, not pinned)
                init(*initargs)
                return func(*a, **kw)
        else:
            call = func
        return rt.remote(num_cpus=1)(call)

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    # ----------------------------------------------------------------- api
    def apply(self, func: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(func, args, kwds).get()

    def apply_async(self, func: Callable, args: tuple = (),
                    kwds: dict = None) -> AsyncResult:
        self._check_open()
        ref = self._remote_fn(func).remote(*args, **(kwds or {}))
        self._outstanding.append(ref)
        return AsyncResult([ref], single=True)

    def map(self, func: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> list:
        return self.map_async(func, iterable, chunksize).get()

    def map_async(self, func: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        # submission is eager: the node managers' lease queues provide the
        # backpressure `processes` would in the stdlib (tasks run at most
        # cluster-CPU wide anyway)
        self._check_open()
        remote_fn = self._remote_fn(func)
        refs = [remote_fn.remote(x) for x in iterable]
        self._outstanding.extend(refs)
        return AsyncResult(refs, single=False)

    def starmap(self, func: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> list:
        return self.starmap_async(func, iterable, chunksize).get()

    def starmap_async(self, func: Callable, iterable: Iterable[tuple],
                      chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        remote_fn = self._remote_fn(func)
        refs = [remote_fn.remote(*args) for args in iterable]
        self._outstanding.extend(refs)
        return AsyncResult(refs, single=False)

    def imap(self, func: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        """Lazy ordered iterator; submission window = `processes`."""
        self._check_open()
        remote_fn = self._remote_fn(func)
        it = iter(iterable)
        pending: list = []
        for x in itertools.islice(it, self._processes):
            pending.append(remote_fn.remote(x))
        for x in it:
            yield rt.get(pending.pop(0))
            pending.append(remote_fn.remote(x))
        while pending:
            yield rt.get(pending.pop(0))

    def imap_unordered(self, func: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        self._check_open()
        remote_fn = self._remote_fn(func)
        pending = {remote_fn.remote(x) for x in iterable}
        while pending:
            done, _ = rt.wait(list(pending), num_returns=1)
            for ref in done:
                pending.discard(ref)
                yield rt.get(ref)

    # ------------------------------------------------------------ lifecycle
    def close(self):
        self._closed = True

    def terminate(self):
        """Stop accepting work. Unlike stdlib, in-flight CLUSTER tasks run
        to completion (there is no process group to kill); join() after
        terminate() still waits for them."""
        self._closed = True

    def join(self):
        """Block until every submitted task finished (the stdlib
        close()+join() completion guarantee)."""
        if not self._closed:
            raise ValueError("Pool is still running")
        if self._outstanding:
            rt.wait(self._outstanding,
                    num_returns=len(self._outstanding))
            self._outstanding = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False
