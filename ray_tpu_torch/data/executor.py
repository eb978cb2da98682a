"""Streaming executor: pull-based operator pipeline over block refs (ref
analogs: data/_internal/execution/streaming_executor.py:48,
streaming_executor_state.py, operators/{map_operator,
task_pool_map_operator,actor_pool_map_operator}.py).

Map stages stream: at most `max_in_flight` block tasks are outstanding per
stage, so a long pipeline holds O(window) blocks in memory instead of the
whole dataset — the reference's backpressure idea without its resource
budgets. All-to-all stages (repartition / random_shuffle / sort / hash
shuffle / dedup) run through the exchange subsystem (data/exchange.py):
columnar partition kernels on the map side, per-partition shard
readiness + streaming reduce folds on the reduce side — pipelined
map/reduce rather than a global barrier.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Iterator, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.data.block import (Block, concat_blocks, dedup_block,
                                      from_batch, iter_rows, random_partition,
                                      range_partition, sample_keys,
                                      shuffle_block, sort_block,
                                      split_partition, to_batch)


@dataclasses.dataclass
class ActorPoolStrategy:
    """Actor-pool compute for map_batches. `size` is the fixed size when
    min/max are not given; with min_size/max_size the topology executor
    autoscales the pool with input-queue depth (ref:
    data/_internal/execution/autoscaler/)."""
    size: int = 2
    min_size: int | None = None
    max_size: int | None = None

    def __post_init__(self):
        if self.min_size is None:
            self.min_size = self.size
        if self.max_size is None:
            self.max_size = max(self.size, self.min_size)
        if self.min_size > self.max_size:
            raise ValueError(
                f"ActorPoolStrategy min_size={self.min_size} > "
                f"max_size={self.max_size}")


@dataclasses.dataclass
class MapSpec:
    kind: str                     # map | map_batches | filter | flat_map
    fn: Any                       # callable or class (for actor compute)
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    compute: Optional[ActorPoolStrategy] = None
    fn_constructor_args: tuple = ()
    fn_kwargs: dict = dataclasses.field(default_factory=dict)


def apply_map_spec(spec: MapSpec, fn, block: Block) -> Block:
    """Run one map stage over one block (inside a task/actor)."""
    from ray_tpu_torch.data.block import batch_iter

    if spec.kind == "fused":
        # planner-fused chain: run every sub-stage in this one task
        for sub in spec.fn:
            block = apply_map_spec(sub, sub.fn, block)
        return block

    if spec.kind == "map":
        return [fn(row, **spec.fn_kwargs) for row in iter_rows(block)]
    if spec.kind == "filter":
        return [row for row in iter_rows(block) if fn(row, **spec.fn_kwargs)]
    if spec.kind == "flat_map":
        out: list = []
        for row in iter_rows(block):
            out.extend(fn(row, **spec.fn_kwargs))
        return out
    if spec.kind == "map_batches":
        outs = []
        for sub in batch_iter(block, spec.batch_size):
            batch = to_batch(sub, spec.batch_format)
            outs.append(from_batch(fn(batch, **spec.fn_kwargs)))
        if len(outs) == 1:
            return outs[0]
        return concat_blocks(outs)  # arrow-aware concat
    raise ValueError(f"unknown map kind {spec.kind!r}")


def _map_task(block: Block, spec: MapSpec) -> Block:
    return apply_map_spec(spec, spec.fn, block)


class _MapActor:
    """Actor-pool compute: constructs the callable once, reuses it per
    block (ref: actor_pool_map_operator.py)."""

    def __init__(self, spec: MapSpec):
        self.spec = spec
        fn = spec.fn
        if isinstance(fn, type):
            fn = fn(*spec.fn_constructor_args)
        self.fn = fn

    def apply(self, block: Block) -> Block:
        return apply_map_spec(self.spec, self.fn, block)


def _ship_spec_code(spec: MapSpec) -> None:
    """Register the spec's user code for by-value pickling. Fused specs hold
    a list of sub-specs in `fn`, so recurse rather than handing the list to
    ship_code_by_value (a list has no __module__ and would silently no-op)."""
    from ray_tpu_torch._internal.serialization import ship_code_by_value

    if spec.kind == "fused":
        for sub in spec.fn:
            _ship_spec_code(sub)
    else:
        ship_code_by_value(spec.fn)


class StreamingExecutor:
    def __init__(self, max_in_flight: int = 8, execution_options=None):
        self.max_in_flight = max_in_flight
        self.execution_options = execution_options
        self.last_topology = None   # stats hook for tests/observability
        self.last_exchange = None   # ExchangeStats of the last all-to-all

    # --------------------------------------------------------- map pipeline
    def stream_pipeline(self, refs: Iterator, specs: list) -> Iterator:
        """Run consecutive map-family stages as one operator topology with
        per-op queues, backpressure budgets, and actor-pool autoscaling
        (data/streaming_executor.py)."""
        from ray_tpu_torch.data.streaming_executor import (ExecutionOptions,
                                                           StreamingTopology)

        opts = self.execution_options or ExecutionOptions(
            max_in_flight=self.max_in_flight)
        topo = StreamingTopology(list(specs), iter(refs), opts)
        self.last_topology = topo
        return topo.run()

    # ------------------------------------------------------------- map stage
    def stream_map(self, refs: Iterator, spec: MapSpec) -> Iterator:
        """Single-stage convenience wrapper over the topology executor
        (kept as API; Dataset batches consecutive stages itself)."""
        return self.stream_pipeline(refs, [spec])

    # --------------------------------------------------------- all-to-all
    #
    # Every all-to-all is one ExchangeSpec run by the pipelined
    # ExchangeController (data/exchange.py): map-side partition kernels
    # keep columnar blocks columnar (index-array take, no row dicts),
    # shards ride the zero-copy shm plane as task returns, and reduce
    # tasks start folding a partition the moment its shards exist —
    # no global map barrier, and the driver never gathers block data.

    def _exchange(self, spec, refs):
        from ray_tpu_torch.data.exchange import ExchangeController
        from ray_tpu_torch.data.streaming_executor import ExecutionOptions

        opts = self.execution_options or ExecutionOptions(
            max_in_flight=self.max_in_flight)
        controller = ExchangeController(spec, options=opts)
        out = controller.run(refs)
        self.last_exchange = controller.stats
        return out

    def repartition(self, refs: list, n: int) -> list:
        """Distributed repartition via local split: each map task splits
        its block into n near-equal slices (remainders rotated by block
        index, so outputs balance within ±1 row per input block) and the
        reduce side concatenates slice j of every block. No counting
        pre-pass: the driver never blocks on a per-block rt.get(counts)
        barrier the way the old split+merge pattern did.

        Contract note: output partition j holds slice j OF EVERY input
        block, so the global row order is not the input order (the old
        count-then-slice path kept partitions globally contiguous —
        that exactness is what the count barrier bought). Repartition
        before order-sensitive stages, or sort afterwards."""
        refs = list(refs)
        if not refs:
            return [rt.put([]) for _ in range(n)]
        from ray_tpu_torch.data.exchange import ExchangeSpec

        return self._exchange(
            ExchangeSpec(n, map_fn=_repartition_map, name="repartition"),
            refs)

    def random_shuffle(self, refs: list, seed: Optional[int] = None) -> list:
        """Distributed shuffle: map tasks scatter rows uniformly across N
        shards, reduce tasks concat + locally permute their partition.

        Retry safety: the per-task seed is ALWAYS derived from a base
        seed fixed at submission time plus the block index — with
        seed=None the base is drawn once HERE and baked into the task
        args, so a driver-level map-task retry reproduces the exact
        shard assignment of the first attempt. (Fresh in-task randomness
        would route rows differently on retry, duplicating them into
        one reduce partition and losing them from another.)"""
        refs = list(refs)
        n = max(1, len(refs))
        base = seed if seed is not None \
            else random.SystemRandom().randrange(1 << 31)

        def shuffle_map(block: Block, n: int, idx: int) -> list[Block]:
            return random_partition(block, n, seed=base + idx)

        def shuffle_reduce(block: Block, j: int) -> Block:
            return shuffle_block(block, seed=base + 10_000 + j)

        from ray_tpu_torch.data.exchange import ExchangeSpec

        return self._exchange(
            ExchangeSpec(n, map_fn=shuffle_map,
                         finalize_fn=shuffle_reduce, name="shuffle"),
            refs)

    def sort(self, refs: list, key, descending: bool) -> list:
        """Distributed sample sort (ref: planner/exchange/sort_task_spec.py
        TaskBasedShuffle): a sampling pre-pass ships ~16 key values per
        block to the driver (the only driver-side sync, and it is tiny),
        quantiles of the pooled sample become the n-1 range bounds, map
        tasks range-partition on them, and each reduce partition sorts
        once. String keys on columnar blocks run fully vectorized
        (argsort/searchsorted over the key column); callable keys fall
        back to row kernels."""
        refs = list(refs)
        if not refs:
            return []
        n = len(refs)
        if callable(key):
            # a user key fn from a driver-local module pickles by
            # reference inside our closures — register its module for
            # by-value shipping (same contract as MapSpec user fns)
            from ray_tpu_torch._internal.serialization import (
                ship_code_by_value)

            ship_code_by_value(key)

        def sample(block: Block) -> list:
            return sample_keys(block, key, 16)

        sample_task = rt.remote(num_cpus=1)(sample)
        samples = sorted(
            (x for sub in rt.get([sample_task.remote(r) for r in refs])
             for x in sub),
            reverse=descending)
        if not samples:  # every block empty
            return refs
        bounds = [samples[(len(samples) * j) // n] for j in range(1, n)]

        def sort_map(block: Block, n: int, idx: int) -> list[Block]:
            return range_partition(block, key, bounds, descending)

        def sort_reduce(block: Block, j: int) -> Block:
            return sort_block(block, key, descending)

        from ray_tpu_torch.data.exchange import ExchangeSpec

        return self._exchange(
            ExchangeSpec(n, map_fn=sort_map, finalize_fn=sort_reduce,
                         name="sort"),
            refs)

    def hash_partitioned(self, refs: list, key, n: Optional[int] = None,
                         finalize_fn=None, name: str = "groupby") -> list:
        """Hash exchange: all rows with equal `key` land in the same
        output partition (the groupby/dedup substrate). `finalize_fn`
        runs once per partition after its shards folded."""
        refs = list(refs)
        n = n or max(1, len(refs))
        from ray_tpu_torch.data.block import hash_partition
        from ray_tpu_torch.data.exchange import ExchangeSpec

        if callable(key):  # user key fns ship like MapSpec fns
            from ray_tpu_torch._internal.serialization import (
                ship_code_by_value)

            ship_code_by_value(key)

        def hash_map(block: Block, n: int, idx: int) -> list[Block]:
            return hash_partition(block, key, n)

        return self._exchange(
            ExchangeSpec(n, map_fn=hash_map, finalize_fn=finalize_fn,
                         name=name),
            refs)

    def dedup(self, refs: list, key) -> list:
        """Distributed drop-duplicates: hash exchange on `key` (or
        whole-row identity when key=None) + a per-partition
        first-occurrence set in the reduce epilogue."""

        def dedup_reduce(block: Block, j: int) -> Block:
            return dedup_block(block, key)

        return self.hash_partitioned(refs, key, finalize_fn=dedup_reduce,
                                     name="dedup")

    def unique_values(self, refs: list, key: str) -> list:
        """Distinct values of column `key`: the map side projects each
        block to the key column BEFORE hash partitioning, so only key
        values — never full rows — cross the wire or reach the driver."""
        refs = list(refs)
        n = max(1, len(refs))
        from ray_tpu_torch.data.block import hash_partition, project_column
        from ray_tpu_torch.data.exchange import ExchangeSpec

        def unique_map(block: Block, n: int, idx: int) -> list[Block]:
            return hash_partition(project_column(block, key), key, n)

        def unique_reduce(block: Block, j: int) -> Block:
            return dedup_block(block, key)

        return self._exchange(
            ExchangeSpec(n, map_fn=unique_map,
                         finalize_fn=unique_reduce, name="unique"),
            refs)


def _repartition_map(block: Block, n: int, idx: int) -> list[Block]:
    return split_partition(block, n, offset=idx % n)
