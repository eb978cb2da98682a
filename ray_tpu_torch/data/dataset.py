"""Dataset — lazy, streaming-executed distributed data (ref analogs:
python/ray/data/dataset.py API, _internal/plan.py logical plan,
_internal/iterator/ for iter_batches, output_splitter for
streaming_split)."""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Iterator, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.data.block import (Block, concat_blocks,
                                      iter_batches_from_blocks, num_rows_of,
                                      slice_rows, split_block, to_batch)
from ray_tpu_torch.data.executor import (ActorPoolStrategy, MapSpec,
                                         StreamingExecutor)


@dataclasses.dataclass
class _AllToAll:
    kind: str      # repartition | shuffle | sort | dedup
    args: dict


@dataclasses.dataclass
class _Limit:
    n: int


class Dataset:
    """Lazy plan over source block refs. Transforms append stages; the
    streaming executor runs map stages with bounded in-flight blocks and
    barriers only at all-to-all stages."""

    def __init__(self, source_refs: list, stages: Optional[list] = None,
                 executor: Optional[StreamingExecutor] = None):
        self._source_refs = source_refs
        self._stages = stages or []
        self._executor = executor or StreamingExecutor()

    # ----------------------------------------------------------- transforms
    def _with(self, stage) -> "Dataset":
        return Dataset(self._source_refs, self._stages + [stage],
                       self._executor)

    def map(self, fn: Callable, **fn_kwargs) -> "Dataset":
        return self._with(MapSpec("map", fn, fn_kwargs=fn_kwargs))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with(MapSpec("filter", fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with(MapSpec("flat_map", fn))

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    compute: Optional[ActorPoolStrategy] = None,
                    fn_constructor_args: tuple = (),
                    **fn_kwargs) -> "Dataset":
        return self._with(MapSpec(
            "map_batches", fn, batch_size=batch_size,
            batch_format=batch_format, compute=compute,
            fn_constructor_args=tuple(fn_constructor_args),
            fn_kwargs=fn_kwargs))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._with(_AllToAll("repartition", {"n": num_blocks}))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return self._with(_AllToAll("shuffle", {"seed": seed}))

    def sort(self, key: str | Callable, descending: bool = False) -> "Dataset":
        # the RAW key travels to the executor: a string key lets the
        # exchange run vectorized columnar kernels (argsort/searchsorted
        # over the key column); callable keys force row kernels
        return self._with(_AllToAll(
            "sort", {"key": key, "descending": descending}))

    def drop_duplicates(self, key: Optional[str] = None) -> "Dataset":
        """Keep one row per distinct `key` (whole-row identity when
        key=None — that path materializes rows even for columnar
        blocks). Runs as a hash exchange + per-partition
        first-occurrence set; row ORDER across the dataset is not
        preserved (rows land in hash-partition order)."""
        return self._with(_AllToAll("dedup", {"key": key}))

    def unique(self, key: str) -> list:
        """Distinct values of column `key`, sorted when the values are
        mutually orderable (mixed/nullable columns come back in
        partition order instead). The exchange's map side projects to
        the key column before hash partitioning, so only key values —
        never full rows — cross the wire or reach the driver."""
        from ray_tpu_torch.data.block import key_values

        refs = self._executor.unique_values(
            list(self._iter_block_refs()), key)
        vals: list = []
        for block in rt.get(refs):  # one batched gather, not n RTTs
            if num_rows_of(block):
                kv = key_values(block, key)
                vals.extend(kv.tolist() if hasattr(kv, "tolist") else kv)
        try:
            return sorted(vals)
        except TypeError:  # unorderable mix (e.g. None next to str)
            return vals

    def limit(self, n: int) -> "Dataset":
        return self._with(_Limit(n))

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._iter_block_refs())
        for o in others:
            refs.extend(o._iter_block_refs())
        return Dataset(refs)

    def zip(self, other: "Dataset") -> "Dataset":
        left = self.take_all()
        right = other.take_all()
        if len(left) != len(right):
            raise ValueError("zip requires equal row counts "
                             f"({len(left)} vs {len(right)})")
        rows = []
        for a, b in zip(left, right):
            row = dict(a)
            for k, v in b.items():
                row[k if k not in row else f"{k}_1"] = v
            rows.append(row)
        return from_items_rows(rows, num_blocks=max(1, len(
            self._source_refs)))

    def groupby(self, key: str) -> "GroupedData":
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    # ------------------------------------------------------------ execution
    def explain(self) -> list[str]:
        """The optimized plan as stage descriptions (ref analog:
        logical-plan printout in data/_internal/plan.py)."""
        from ray_tpu_torch.data.plan import describe, optimize

        return describe(optimize(list(self._stages)))

    def _iter_block_refs(self) -> Iterator:
        from ray_tpu_torch.data.plan import optimize

        stages = optimize(list(self._stages))
        refs: Iterator = iter(self._source_refs)
        i = 0
        while i < len(stages):
            stage = stages[i]
            if isinstance(stage, MapSpec):
                # consecutive map-family stages run as ONE pipelined
                # operator topology with per-op queues + backpressure
                # (data/streaming_executor.py)
                segment = [stage]
                while i + 1 < len(stages) and isinstance(stages[i + 1],
                                                         MapSpec):
                    i += 1
                    segment.append(stages[i])
                refs = self._executor.stream_pipeline(refs, segment)
            elif isinstance(stage, _AllToAll):
                refs = self._run_all_to_all(refs, stage)
            elif isinstance(stage, _Limit):
                refs = self._limit_refs(refs, stage.n)
            i += 1
        return refs

    def _run_all_to_all(self, refs: Iterator, stage) -> Iterator:
        """All-to-all stages run through the pipelined exchange
        (data/exchange.py). Input refs are materialized only to fix the
        output partition count; the exchange itself overlaps map and
        reduce tasks instead of barriering between them."""
        materialized = list(refs)
        if stage.kind == "repartition":
            return iter(self._executor.repartition(
                materialized, stage.args["n"]))
        if stage.kind == "shuffle":
            return iter(self._executor.random_shuffle(
                materialized, stage.args["seed"]))
        if stage.kind == "dedup":
            return iter(self._executor.dedup(
                materialized, stage.args["key"]))
        return iter(self._executor.sort(
            materialized, stage.args["key"], stage.args["descending"]))

    def _limit_refs(self, refs: Iterator, n: int) -> Iterator:
        remaining = n
        for ref in refs:
            if remaining <= 0:
                return
            block = rt.get(ref)
            n_rows = num_rows_of(block)
            if n_rows > remaining:
                yield rt.put(slice_rows(block, 0, remaining))
                return
            remaining -= n_rows
            yield ref

    def materialize(self) -> "Dataset":
        return Dataset(list(self._iter_block_refs()))

    # ------------------------------------------------------------- consumers
    def iter_rows(self) -> Iterator[dict]:
        from ray_tpu_torch.data.block import iter_rows as _block_iter_rows

        for ref in self._iter_block_refs():
            yield from _block_iter_rows(rt.get(ref))

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        # columnar end-to-end: blocks are sliced/concatenated, never
        # shattered into per-row dicts (ref: _internal/block_batching)
        yield from iter_batches_from_blocks(
            (rt.get(ref) for ref in self._iter_block_refs()),
            batch_size, batch_format, drop_last)

    def take(self, n: int = 20) -> list:
        from ray_tpu_torch.data.block import block_rows

        out: list = []
        for ref in self._iter_block_refs():
            out.extend(block_rows(rt.get(ref)))
            if len(out) >= n:
                return out[:n]
        return out

    def take_all(self) -> list:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(num_rows_of(rt.get(ref))
                   for ref in self._iter_block_refs())

    def num_blocks(self) -> int:
        return len(self._source_refs)

    def schema(self) -> Optional[list[str]]:
        first = self.take(1)
        if not first:
            return None
        row = first[0]
        return sorted(row.keys()) if isinstance(row, dict) else ["item"]

    def aggregate(self, *agg_fns) -> dict:
        """Global aggregation via AggregateFn plugins (ref:
        dataset.py aggregate + aggregate.py): one accumulate task per
        block, tiny accumulators merge on the driver — rows never leave
        their blocks."""
        from ray_tpu_torch.data.block import iter_rows as _block_iter_rows

        def accumulate(block: Block) -> list:
            accs = []
            for fn in agg_fns:
                acc = fn.init()
                for row in _block_iter_rows(block):
                    acc = fn.accumulate_row(acc, row)
                accs.append(acc)
            return accs

        acc_task = rt.remote(num_cpus=1)(accumulate)
        partials = rt.get([acc_task.remote(ref)
                           for ref in self._iter_block_refs()])
        out = {}
        for i, fn in enumerate(agg_fns):
            acc = fn.init()
            for p in partials:
                acc = fn.merge(acc, p[i])
            out[fn.name] = fn.finalize(acc)
        return out

    def sum(self, on: str) -> float:
        return sum(row[on] for row in self.iter_rows())

    def min(self, on: str):
        return min(row[on] for row in self.iter_rows())

    def max(self, on: str):
        return max(row[on] for row in self.iter_rows())

    def mean(self, on: str) -> float:
        total, n = 0.0, 0
        for row in self.iter_rows():
            total += row[on]
            n += 1
        return total / n if n else float("nan")

    def write_datasink(self, sink, **kwargs) -> list:
        """Fan blocks out to a Datasink (one retryable write task per
        block, atomic per-file commit — data/datasink.py)."""
        from ray_tpu_torch.data.datasink import write_datasink

        return write_datasink(self, sink, **kwargs)

    def write_parquet(self, path: str, *,
                      partition_cols: Optional[list] = None) -> list:
        from ray_tpu_torch.data.datasink import ParquetDatasink

        return self.write_datasink(
            ParquetDatasink(path, partition_cols=partition_cols))

    def write_jsonl(self, path: str, *,
                    partition_cols: Optional[list] = None) -> list:
        from ray_tpu_torch.data.datasink import JSONLDatasink

        return self.write_datasink(
            JSONLDatasink(path, partition_cols=partition_cols))

    def write_npz(self, path: str, *,
                  partition_cols: Optional[list] = None) -> list:
        from ray_tpu_torch.data.datasink import NpzDatasink

        return self.write_datasink(
            NpzDatasink(path, partition_cols=partition_cols))

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.take_all())

    # ------------------------------------------------- train-ingest surface
    def streaming_split(self, n: int, *, equal: bool = True,
                        seed: Optional[int] = None) -> list["DataIterator"]:
        """Split into n iterators, one per train worker (ref:
        output_splitter.py streaming_split + train DataConfig)."""
        refs = list(self._iter_block_refs())
        shards: list[list] = [[] for _ in range(n)]
        if equal:
            rows = concat_blocks([rt.get(r) for r in refs])
            per = num_rows_of(rows) // n
            for i, part in enumerate(
                    split_block(slice_rows(rows, 0, per * n), n)):
                shards[i].append(rt.put(part))
        else:
            for i, ref in enumerate(refs):
                shards[i % n].append(ref)
        return [DataIterator(shard) for shard in shards]

    def split(self, n: int) -> list["Dataset"]:
        refs = list(self._iter_block_refs())
        out: list[list] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            out[i % n].append(ref)
        return [Dataset(refs_i) for refs_i in out]

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._source_refs)}, "
                f"stages={len(self._stages)})")


class DataIterator:
    """Picklable per-worker shard iterator (resolves block refs lazily in
    the consuming worker)."""

    def __init__(self, refs: list):
        self._refs = refs

    def iter_rows(self) -> Iterator[dict]:
        from ray_tpu_torch.data.block import iter_rows as _block_iter_rows

        for ref in self._refs:
            yield from _block_iter_rows(rt.get(ref))

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        yield from iter_batches_from_blocks(
            (rt.get(ref) for ref in self._refs),
            batch_size, batch_format, drop_last)

    def count(self) -> int:
        return sum(num_rows_of(rt.get(ref)) for ref in self._refs)

    def __reduce__(self):
        return (DataIterator, (self._refs,))


def from_items_rows(rows: list, num_blocks: int = 8) -> Dataset:
    num_blocks = max(1, min(num_blocks, max(1, len(rows))))
    return Dataset([rt.put(b) for b in split_block(rows, num_blocks)])
