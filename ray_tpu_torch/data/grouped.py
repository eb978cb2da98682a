"""GroupedData: hash-shuffle by key then per-partition aggregate (ref
analog: python/ray/data/grouped_data.py + planner/exchange hash shuffle).

The shuffle itself is the exchange subsystem's hash exchange
(data/exchange.py via StreamingExecutor.hash_partitioned): columnar
blocks are routed by a vectorized key-column hash and never shatter
into row dicts; the reduce side streams partial concats while map
tasks are still running."""

from __future__ import annotations

from typing import Any, Callable

import ray_tpu_torch as rt
from ray_tpu_torch.data.block import Block, iter_rows, stable_hash

_stable_hash = stable_hash  # back-compat alias (kernel moved to block.py)


def _group_rows(part: Block, key: str) -> dict[Any, Block]:
    groups: dict[Any, Block] = {}
    for row in iter_rows(part):
        groups.setdefault(row[key], []).append(row)
    return groups


def _fold_partition(part: Block, key: str, agg_fns: tuple,
                    named_aggs: dict) -> Block:
    """One streaming pass over a partition: each row folds into its
    group's accumulators the moment it is produced and is then dropped —
    for columnar blocks the per-row dicts iter_rows materializes die
    immediately instead of piling into per-group lists (ADVICE fix; the
    keyword ``(col, reducer-over-list)`` surface still needs the VALUES
    of its input column, but only that column, never whole rows)."""
    accs: dict[Any, list] = {}          # group -> AggregateFn accumulators
    vals: dict[Any, list] = {}          # group -> per-named-agg value lists
    order: list = []                    # first-seen group order
    named = list(named_aggs.items())
    for row in iter_rows(part):
        gkey = row[key]
        if gkey not in accs:
            order.append(gkey)
            accs[gkey] = [fn.init() for fn in agg_fns]
            vals[gkey] = [[] for _ in named]
        acc = accs[gkey]
        for i, fn in enumerate(agg_fns):
            acc[i] = fn.accumulate_row(acc[i], row)
        v = vals[gkey]
        for i, (_, (in_col, _)) in enumerate(named):
            v[i].append(row[in_col])
    out: Block = []
    for gkey in order:
        row = {key: gkey}
        for i, fn in enumerate(agg_fns):
            row[fn.name] = fn.finalize(accs[gkey][i])
        for i, (out_col, (_, reducer)) in enumerate(named):
            row[out_col] = reducer(vals[gkey][i])
        out.append(row)
    return out


class GroupedData:
    def __init__(self, dataset, key: str):
        self._dataset = dataset
        self._key = key

    def _partitions(self) -> list:
        """Hash-partition rows by key, one output partition per input
        block (the pipelined hash exchange: distributed shuffle, not a
        driver gather — columnar blocks stay columnar)."""
        refs = list(self._dataset._iter_block_refs())
        return self._dataset._executor.hash_partitioned(refs, self._key)

    def aggregate(self, *agg_fns, **named_aggs: tuple[str, Callable]):
        """Two surfaces (ref: grouped_data.py aggregate):

        * positional :class:`~ray_tpu_torch.data.aggregate.AggregateFn` plugin
          objects — rows fold into small accumulators AS the partition
          streams (init/accumulate_row/finalize), so a group's rows are
          never gathered into a list;
        * keyword ``out_col=(in_col, reducer over list of values)`` for
          quick ad-hoc reductions (collects that one column's values per
          group — the reducer's contract — but never whole rows).

        Returns a Dataset of one row per group. Aggregation runs as one
        task per partition — partitions never land on the driver, so the
        group stage scales past one node's store (ref: planner/exchange
        reduce-side aggregation)."""
        from ray_tpu_torch.data.dataset import Dataset

        key = self._key

        def agg_partition(part: Block) -> Block:
            return _fold_partition(part, key, agg_fns, named_aggs)

        agg_task = rt.remote(num_cpus=1)(agg_partition)
        return Dataset([agg_task.remote(ref) for ref in self._partitions()])

    def count(self):
        return self.aggregate(count=(self._key, len))

    def sum(self, on: str):
        return self.aggregate(**{f"sum({on})": (on, sum)})

    def mean(self, on: str):
        return self.aggregate(**{
            f"mean({on})": (on, lambda vs: sum(vs) / len(vs))})

    def min(self, on: str):
        return self.aggregate(**{f"min({on})": (on, min)})

    def max(self, on: str):
        return self.aggregate(**{f"max({on})": (on, max)})

    def map_groups(self, fn: Callable):
        from ray_tpu_torch.data.dataset import Dataset

        key = self._key

        def apply(part: Block) -> Block:
            groups = _group_rows(part, key)
            out: Block = []
            for _, rows in groups.items():
                result = fn(rows)
                out.extend(result if isinstance(result, list) else [result])
            return out

        apply_task = rt.remote(num_cpus=1)(apply)
        return Dataset([apply_task.remote(ref)
                        for ref in self._partitions()])
