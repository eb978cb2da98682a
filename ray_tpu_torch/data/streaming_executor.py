"""Operator-topology streaming executor.

Ref analogs: python/ray/data/_internal/execution/streaming_executor.py:48,
streaming_executor_state.py (operator topology + select_operator_to_run),
backpressure_policy/ (ConcurrencyCapBackpressurePolicy,
StreamingOutputBacklogPolicy), autoscaler/ (data-internal actor-pool
autoscaling for map_batches(compute=ActorPoolStrategy)).

A pipeline segment (consecutive map-family stages) becomes a topology of
`_OpState`s, each with an input queue, an ordered outstanding-task window
and an output queue. One driver-side scheduling loop dispatches work
downstream-first so the pipeline DRAINS before it fills, subject to:

  * a per-op concurrency cap (max_in_flight tasks), and
  * a per-op memory budget: an op may not submit while the bytes queued
    at its consumer (its backlog) exceed its budget — so one slow
    downstream operator bounds every upstream operator's materialized
    blocks instead of letting them pile into the object store.

Block sizes come from the owner's object metadata when known, else a
conservative estimate. The executor is a generator: the consumer pulling
output refs drives scheduling, and abandoning it tears down actor pools.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Iterator, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.data.executor import (ActorPoolStrategy, MapSpec, _MapActor,
                                         _map_task, _ship_spec_code)

_DEFAULT_BLOCK_ESTIMATE = 1 << 20      # bytes, when the owner has no size
_DEFAULT_OP_BUDGET = 64 << 20          # per-op backlog budget (bytes)


@dataclasses.dataclass
class ExecutionOptions:
    max_in_flight: int = 8                 # per-op concurrency cap
    op_budget_bytes: int = _DEFAULT_OP_BUDGET
    block_size_estimate: int = _DEFAULT_BLOCK_ESTIMATE
    actor_scale_interval_s: float = 0.2    # min seconds between scale-ups
    # stop SUBMITTING (draining continues) when the node's shm arena is
    # this full — per-op budgets are guesses, the arena is ground truth
    store_highwater: float = 0.8
    # derive per-op budgets from the arena's real capacity when known
    auto_budget: bool = True


@dataclasses.dataclass
class OpStats:
    name: str = ""
    submitted: int = 0
    completed: int = 0
    backlog_peak_bytes: int = 0
    backlog_peak_blocks: int = 0
    pool_peak: int = 0
    paused_on_backpressure: int = 0
    paused_on_store_pressure: int = 0


# (id(shm), supports_usage) — keyed to the store OBJECT: flavor can
# change across rt.init() cycles (RAYT_SHM_MODE), and a cached bound
# method of a previous cluster's closed store points at unmapped C
# memory (observed SIGSEGV), so nothing but the decision is cached
_shm_probe: tuple[int, bool] | None = None


def _store_usage() -> tuple[int, int] | None:
    """(used, capacity) of this node's shm arena, when the store flavor
    tracks it (the native boundary-tag arena does; the per-object
    segments fallback doesn't). The occupancy integrates EVERY writer on
    the node — other jobs included — which per-op budgets can't see."""
    global _shm_probe
    try:
        shm = _cw().shm
        key = id(shm)
        if _shm_probe is None or _shm_probe[0] != key:
            _shm_probe = (key, hasattr(shm, "used")
                          and hasattr(shm, "capacity"))
        if not _shm_probe[1]:
            return None
        c = shm.capacity()
        if not c:
            return None
        return shm.used(), c
    except Exception:
        return None


_core_worker_fn = None


def _cw():
    """Lazy-cached core-worker accessor (shared by size + usage probes)."""
    global _core_worker_fn
    if _core_worker_fn is None:
        from ray_tpu_torch.api import _core_worker
        _core_worker_fn = _core_worker
    return _core_worker_fn()


def _ref_size(ref, estimate: int) -> int:
    try:
        meta = _cw().object_meta.get(ref.id)
        if meta is not None and meta.size > 0:
            return meta.size
    except Exception:
        pass
    return estimate


class _RefQueue:
    """Deque of block refs with a running byte total, so backpressure
    checks are O(1) instead of re-summing the queue per submission."""

    __slots__ = ("_q", "_sizes", "bytes", "_est")

    def __init__(self, estimate: int):
        self._q: collections.deque = collections.deque()
        self._sizes: collections.deque = collections.deque()
        self.bytes = 0
        self._est = estimate

    def append(self, ref):
        s = _ref_size(ref, self._est)
        self._q.append(ref)
        self._sizes.append(s)
        self.bytes += s

    def extend(self, refs):
        for r in refs:
            self.append(r)

    def popleft(self):
        self.bytes -= self._sizes.popleft()
        return self._q.popleft()

    def __len__(self):
        return len(self._q)

    def __bool__(self):
        return bool(self._q)


class _OpState:
    def __init__(self, spec: MapSpec, idx: int, opts: ExecutionOptions):
        self.spec = spec
        self.idx = idx
        self.opts = opts
        self.budget_bytes = opts.op_budget_bytes  # topology may refine
        self.inqueue = _RefQueue(opts.block_size_estimate)
        # ordered window: completions are delivered downstream in FIFO
        # order (the reference preserves block order by default)
        self.outstanding: collections.deque = collections.deque()
        self.input_done = False
        self.stats = OpStats(name=spec.kind)
        # actor pool (map_batches(compute=ActorPoolStrategy))
        self.pool: list = []
        self._rr = 0
        self._last_scale = 0.0
        if spec.compute is not None:
            _ship_spec_code(spec)
            self._actor_cls = rt.remote(num_cpus=1)(_MapActor)
            for _ in range(max(1, getattr(spec.compute, "min_size",
                                          spec.compute.size))):
                self._add_actor()
        else:
            _ship_spec_code(spec)
            self._remote_fn = rt.remote(num_cpus=1)(_map_task)

    # ------------------------------------------------------------- actors
    def _add_actor(self):
        self.pool.append(self._actor_cls.remote(self.spec))
        self.stats.pool_peak = max(self.stats.pool_peak, len(self.pool))

    def _maybe_autoscale(self):
        strat = self.spec.compute
        if strat is None:
            return
        now = time.monotonic()
        # scale on PENDING WORK PER ACTOR (queued + in-flight): queue
        # depth alone never fires when the concurrency window swallows
        # the queue instantly
        pending = len(self.inqueue) + len(self.outstanding)
        if (pending > 2 * len(self.pool)
                and len(self.pool) < strat.max_size
                and now - self._last_scale >= self.opts.actor_scale_interval_s):
            self._add_actor()
            self._last_scale = now

    # ----------------------------------------------------------- dispatch
    def can_submit(self, backlog_bytes: int) -> bool:
        if not self.inqueue:
            return False
        if len(self.outstanding) >= self.opts.max_in_flight:
            return False
        if backlog_bytes >= self.budget_bytes:
            self.stats.paused_on_backpressure += 1
            return False
        if self.spec.compute is not None and not self.pool:
            return False
        return True

    def submit_one(self):
        ref = self.inqueue.popleft()
        if self.spec.compute is not None:
            self._maybe_autoscale()
            actor = self.pool[self._rr % len(self.pool)]
            self._rr += 1
            fut = actor.apply.remote(ref)
        else:
            fut = self._remote_fn.remote(ref, self.spec)
        self.outstanding.append(fut)
        self.stats.submitted += 1

    def pop_ready(self) -> list:
        """FIFO completions: pop from the head while ready."""
        out = []
        while self.outstanding:
            head = self.outstanding[0]
            ready, _ = rt.wait([head], num_returns=1, timeout=0)
            if not ready:
                break
            out.append(self.outstanding.popleft())
            self.stats.completed += 1
        return out

    @property
    def finished(self) -> bool:
        return self.input_done and not self.inqueue and not self.outstanding

    def close(self):
        for a in self.pool:
            try:
                rt.kill(a)
            except Exception:
                pass
        self.pool = []


class StreamingTopology:
    """Executes consecutive map-family stages as one pipelined topology."""

    def __init__(self, specs: list[MapSpec], source: Iterator,
                 options: Optional[ExecutionOptions] = None):
        self.opts = options or ExecutionOptions()
        self.ops = [_OpState(s, i, self.opts) for i, s in enumerate(specs)]
        self._source = source
        self._source_done = False
        self._out = _RefQueue(self.opts.block_size_estimate)
        if self.opts.auto_budget and \
                self.opts.op_budget_bytes == _DEFAULT_OP_BUDGET:
            # only refine the DEFAULT budget: an explicitly configured
            # op_budget_bytes is the user's call, never silently clamped
            usage = _store_usage()
            if usage is not None:
                # leave headroom: the pipeline may keep at most a
                # quarter of the arena materialized across its ops
                _, cap = usage
                derived = max(4 * self.opts.block_size_estimate,
                              cap // (4 * max(1, len(self.ops))))
                for op in self.ops:
                    op.budget_bytes = min(op.budget_bytes, derived)

    # ------------------------------------------------------------- sizing
    def _backlog_bytes(self, op: _OpState) -> int:
        """Bytes materialized but not yet consumed DOWNSTREAM of `op`:
        its in-flight window plus everything queued at its consumer (or
        the final output queue). This is what submitting more work can
        grow, so it is what the budget bounds."""
        est = self.opts.block_size_estimate
        consumer_q = (self.ops[op.idx + 1].inqueue
                      if op.idx + 1 < len(self.ops) else self._out)
        total = consumer_q.bytes + len(op.outstanding) * est
        op.stats.backlog_peak_bytes = max(op.stats.backlog_peak_bytes,
                                          total)
        op.stats.backlog_peak_blocks = max(
            op.stats.backlog_peak_blocks,
            len(consumer_q) + len(op.outstanding))
        return total

    # ------------------------------------------------------------ stepping
    def _pull_source(self, limit: int | None = None):
        """Admit source blocks only when the first op has room — the
        source iterator may itself be a lazy upstream segment (so
        pulling can MATERIALIZE blocks; pressure rounds pass limit=1)."""
        op0 = self.ops[0]
        room = self.opts.max_in_flight if limit is None else limit
        while (not self._source_done
               and len(op0.inqueue) < room):
            try:
                op0.inqueue.append(next(self._source))
            except StopIteration:
                self._source_done = True
                op0.input_done = True

    def _step(self) -> bool:
        """One scheduling round; returns True if anything progressed."""
        progressed = False
        pressured = self._store_pressured()
        if not pressured:
            # pulling may itself materialize blocks (lazy upstream
            # segment), so it obeys the same pressure gate as submission
            self._pull_source()
        # drain completions downstream-first so memory frees before it
        # accumulates (ref: select_operator_to_run prefers ops closer to
        # the sink)
        for i in reversed(range(len(self.ops))):
            op = self.ops[i]
            ready = op.pop_ready()
            if ready:
                progressed = True
                target = (self.ops[i + 1].inqueue
                          if i + 1 < len(self.ops) else self._out)
                target.extend(ready)
            if op.finished and i + 1 < len(self.ops):
                self.ops[i + 1].input_done = True
        if pressured:
            # arena near-full: drain-only round — submitting would
            # allocate more blocks into a store about to spill. BUT if
            # this pipeline has nothing in flight at all, the pressure
            # is another writer's and waiting can never free anything
            # for us: keep ONE task moving so the job can't hang on
            # someone else's memory forever.
            if any(op.outstanding for op in self.ops):
                for op in self.ops:
                    if op.inqueue:
                        op.stats.paused_on_store_pressure += 1
                return progressed
            self._pull_source(limit=1)  # ONE block: just enough to move
            for i in reversed(range(len(self.ops))):
                op = self.ops[i]
                if op.can_submit(self._backlog_bytes(op)):
                    op.submit_one()
                    op.stats.paused_on_store_pressure += 1
                    return True
            return progressed
        for i in reversed(range(len(self.ops))):
            op = self.ops[i]
            while op.can_submit(self._backlog_bytes(op)):
                op.submit_one()
                progressed = True
        return progressed

    def _store_pressured(self) -> bool:
        usage = _store_usage()
        if usage is None:
            return False
        used, cap = usage
        return used >= self.opts.store_highwater * cap

    def run(self) -> Iterator:
        """Yield output block refs in order; pulling drives the loop."""
        try:
            while True:
                while self._out:
                    yield self._out.popleft()
                if all(o.finished for o in self.ops) and self._source_done:
                    break
                if not self._step() and not self._out:
                    time.sleep(0.005)  # all windows full or waiting
        finally:
            for op in self.ops:
                op.close()

    def stats(self) -> list[OpStats]:
        return [op.stats for op in self.ops]
