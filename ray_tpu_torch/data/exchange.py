"""Distributed exchange subsystem: the pipelined map/reduce shuffle
plane behind repartition / random_shuffle / sort / groupby / dedup
(ref analog: python/ray/data/_internal/planner/exchange/ —
ShuffleTaskSpec + SortTaskSpec executed task-based, the Ray-paper shape
from PAPERS.md arXiv:1712.05889 §4.2).

An exchange is described by an :class:`ExchangeSpec`:

* ``map_fn(block, num_partitions, map_index) -> list[Block]`` — the
  partition kernel, one shard per output partition (the columnar
  kernels live in data/block.py: hash/range/random partition via index
  arrays, local split for repartition);
* ``combine_fn(list[Block]) -> Block`` — ASSOCIATIVE shard fold
  (default concat_blocks, which keeps NumpyBlock shards columnar);
* ``finalize_fn(block, partition_index) -> Block`` — the per-partition
  reduce epilogue (local shuffle, final sort, dedup set, ...).

The :class:`ExchangeController` schedules it PIPELINED instead of as a
global barrier:

* map tasks run with a bounded in-flight window and submission obeys
  the shm arena's real occupancy (the same ``_store_usage`` ground
  truth the streaming topology executor gates on) — a near-full store
  pauses admission, it never piles shards into a store about to spill;
* every map task returns its shards as ``num_returns=n`` objects, so a
  shard is ONE shm object riding the PR-4 zero-copy plane: the reduce
  task's get deserializes over scatter-gather frames straight out of
  the source mapping, no driver hop, no copy;
* the controller tracks per-output-partition shard READINESS: the
  moment a partition has ``fold_min`` ready shards of consecutive map
  indices it launches a streaming combine task for them — reduce work
  starts while the map side is still unfinished (``ExchangeStats.folds``
  / ``maps_done_at_first_fold`` instrument exactly that). A run may
  start past a map still running: the fold takes that run's place in
  map-index order, so a straggling map blocks no fold and the concat
  order (hence shuffle and build_corpus output) is the same as when
  every map finishes in order. (The JAX package delivers shards in
  map-index order and folds only the delivered prefix, so a straggling
  first map holds every fold back until the map side is done.)
* when the map side drains, each partition's surviving refs (folded
  accumulators + tail shards) feed one finalize task. ``run`` returns
  the finalize refs without blocking on them, so a downstream stage
  pipelines on top.

Telemetry: ``rayt_data_exchange_{bytes_total,partitions_total,
reduce_wait_s}`` counters (tagged by op) ride the batched metrics
publisher; ``reduce_wait_s`` is the cumulative age of the oldest ready
shard at each reduce-side launch — near zero when map and reduce
overlap well.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.data.block import Block, concat_blocks
# backpressure accounting shared with the streaming topology executor:
# the arena-occupancy probe and owner-metadata block sizing
from ray_tpu_torch.data.streaming_executor import (ExecutionOptions, _ref_size,
                                                   _store_usage)


@dataclasses.dataclass
class ExchangeSpec:
    """One all-to-all, as data: partition kernel + shard fold + reduce
    epilogue. Everything is a plain callable so specs compose (dedup is
    hash_partition + a set epilogue; sort is range_partition + a sort
    epilogue)."""
    num_partitions: int
    map_fn: Callable                 # (block, n, map_index) -> list[Block]
    # associative shard fold; must be identity on singletons
    # (combine_fn([x]) == x) — single-shard partitions skip it
    combine_fn: Callable = concat_blocks
    finalize_fn: Optional[Callable] = None  # (block, partition_idx) -> Block
    name: str = "exchange"
    # ready shards per partition before a streaming fold launches; folds
    # only fire while maps are still outstanding (afterwards the
    # finalize task combines whatever is left in one hop)
    fold_min: int = 4


@dataclasses.dataclass
class ExchangeStats:
    map_tasks: int = 0
    maps_done: int = 0
    # streaming folds launch ONLY while the map side is unfinished
    # (run() gates them on maps_remaining), so folds > 0 is itself the
    # pipelining evidence — a barrier executor would always show 0
    folds: int = 0
    maps_done_at_first_fold: int = -1
    finalizes: int = 0
    bytes_total: int = 0
    reduce_wait_s: float = 0.0
    paused_on_store_pressure: int = 0


def _runs(pending: dict, fold_min: int) -> list[list]:
    """The maximal runs of consecutive map indices among a partition's
    fresh shards that hold at least `fold_min` of them."""
    runs, run = [], []
    for i in sorted(pending):
        if run and i != run[-1] + 1:
            if len(run) >= fold_min:
                runs.append(run)
            run = []
        run.append(i)
    if len(run) >= fold_min:
        runs.append(run)
    return runs


def _run_map(block: Block, map_fn, n: int, idx: int):
    shards = map_fn(block, n, idx)
    if len(shards) != n:
        raise ValueError(
            f"exchange map_fn returned {len(shards)} shards, "
            f"expected {n}")
    return list(shards) if n > 1 else shards[0]


def _run_fold(combine_fn, *shards: Block) -> Block:
    return combine_fn(list(shards))


def _run_finalize(combine_fn, finalize_fn, j: int,
                  *shards: Block) -> Block:
    block = shards[0] if len(shards) == 1 else combine_fn(list(shards))
    if finalize_fn is not None:
        block = finalize_fn(block, j)
    return block


class ExchangeController:
    """Schedules one ExchangeSpec over a stream of input block refs.

    ``run`` drives a small polling loop on the caller's thread (the
    same shape as StreamingTopology): admit map tasks into the window,
    collect completions FIFO, launch streaming folds for partitions
    whose ready-shard backlog crossed ``fold_min``, and finally launch
    one finalize task per partition. The returned refs are NOT waited
    on — downstream consumption drives them."""

    def __init__(self, spec: ExchangeSpec,
                 options: Optional[ExecutionOptions] = None):
        if spec.num_partitions < 1:
            raise ValueError(
                f"num_partitions must be >= 1, got {spec.num_partitions}")
        self.spec = spec
        self.opts = options or ExecutionOptions()
        self.stats = ExchangeStats()
        # user-module spec callables ship by value like MapSpec fns
        # (ship_code_by_value itself skips site-packages modules and
        # those found in the checkout under their own name, the port's
        # among them: its registry is process-wide; closures/lambdas are
        # by-value already)
        from ray_tpu_torch._internal.serialization import ship_code_by_value

        for fn in (spec.map_fn, spec.combine_fn, spec.finalize_fn):
            if fn is not None:
                ship_code_by_value(fn)
        n = spec.num_partitions
        self._map_task = rt.remote(num_cpus=1, num_returns=n)(_run_map)
        self._fold_task = rt.remote(num_cpus=1)(_run_fold)
        self._finalize_task = rt.remote(num_cpus=1)(_run_finalize)

    # ------------------------------------------------------------ pressure
    def _store_pressured(self) -> bool:
        usage = _store_usage()
        if usage is None:
            return False
        used, cap = usage
        return used >= self.opts.store_highwater * cap

    # ----------------------------------------------------------------- run
    def run(self, source: Iterable) -> list:
        spec = self.spec
        n = spec.num_partitions
        src = iter(source)
        src_done = False
        idx = 0
        # per output partition, keyed by map index: FRESH shards not yet
        # folded, and fold outputs (keyed by their run's first index). A
        # fold consumes only fresh shards — fold outputs are never
        # re-folded, so every byte moves through the reduce side at most
        # twice (one fold + the finalize concat) instead of
        # quadratically re-concatenating the accumulator.
        pending: list[dict] = [{} for _ in range(n)]   # idx -> (ts, ref)
        accs: list[dict] = [{} for _ in range(n)]      # idx -> (ts, ref)
        outstanding: collections.deque = collections.deque()  # (idx, shards)
        in_pressure_pause = False

        while True:
            # admit map tasks up to the in-flight window; the shm arena's
            # real occupancy gates admission (drain-only when near-full,
            # but always keep one task moving so the exchange can't hang
            # on another writer's memory)
            while (not src_done
                   and len(outstanding) < self.opts.max_in_flight):
                if outstanding and self._store_pressured():
                    if not in_pressure_pause:  # count episodes, not spins
                        in_pressure_pause = True
                        self.stats.paused_on_store_pressure += 1
                    break
                in_pressure_pause = False
                try:
                    ref = next(src)
                except StopIteration:
                    src_done = True
                    break
                shards = self._map_task.remote(ref, spec.map_fn, n, idx)
                outstanding.append(
                    (idx, shards if isinstance(shards, list) else [shards]))
                idx += 1
                self.stats.map_tasks += 1

            # collect completed maps in ANY order — a straggler must not
            # hold the window hostage (all num_returns objects of a task
            # materialize together, so polling shard 0 suffices per
            # task); each shard keeps its map index, so reduce-side
            # concat order (and thus shuffle / build_corpus output) is
            # deterministic, never timing-bound
            progressed = False
            if outstanding:
                ready, _ = rt.wait([s[0] for _, s in outstanding],
                                   num_returns=len(outstanding),
                                   timeout=0)
                ready_ids = {r.id for r in ready}
                if ready_ids:
                    still: collections.deque = collections.deque()
                    now = time.monotonic()
                    for i, shards in outstanding:
                        if shards[0].id in ready_ids:
                            for j, sref in enumerate(shards):
                                pending[j][i] = (now, sref)
                                self.stats.bytes_total += _ref_size(sref, 0)
                            self.stats.maps_done += 1
                            progressed = True
                        else:
                            still.append((i, shards))
                    outstanding = still

            maps_remaining = (not src_done) or bool(outstanding)
            # streaming reduce folds: a run of fold_min fresh shards of
            # consecutive map indices reduces NOW, while maps are still
            # running — this is what removes the map/reduce barrier
            if maps_remaining:
                for j in range(n):
                    for run in _runs(pending[j], spec.fold_min):
                        self._launch_fold(run, pending[j], accs[j])
            if not maps_remaining:
                break
            if not progressed:
                time.sleep(0.002)  # window full / maps still executing

        out = []
        now = time.monotonic()
        for j in range(n):
            # fold outputs and tail shards in map-index order
            merged = {**accs[j], **pending[j]}
            batch = [merged[i] for i in sorted(merged)]
            if not batch:  # empty exchange (no input blocks at all)
                out.append(rt.put([]))
                continue
            self.stats.reduce_wait_s += now - min(ts for ts, _ in batch)
            self.stats.finalizes += 1
            out.append(self._finalize_task.remote(
                spec.combine_fn, spec.finalize_fn, j,
                *[r for _, r in batch]))
        self._emit_metrics()
        return out

    def _launch_fold(self, run: list, pending: dict, accs: dict) -> None:
        """Fold the fresh shards of map indices `run` (consecutive) into
        one, which takes the run's place at its first index."""
        batch = [pending.pop(i) for i in run]
        now = time.monotonic()
        self.stats.reduce_wait_s += now - min(ts for ts, _ in batch)
        if self.stats.maps_done_at_first_fold < 0:
            self.stats.maps_done_at_first_fold = self.stats.maps_done
        self.stats.folds += 1
        ref = self._fold_task.remote(self.spec.combine_fn,
                                     *[r for _, r in batch])
        accs[run[0]] = (now, ref)

    # ------------------------------------------------------------- metrics
    def _emit_metrics(self) -> None:
        try:
            from ray_tpu_torch.util import builtin_metrics as bm

            tags = {"op": self.spec.name}
            if self.stats.bytes_total > 0:
                bm.data_exchange_bytes.inc(float(self.stats.bytes_total),
                                           tags=tags)
            bm.data_exchange_partitions.inc(float(self.spec.num_partitions),
                                            tags=tags)
            if self.stats.reduce_wait_s > 0:
                bm.data_exchange_reduce_wait.inc(self.stats.reduce_wait_s,
                                                 tags=tags)
        except Exception:
            pass  # telemetry must never fail the exchange
