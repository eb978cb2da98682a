"""ray_tpu_torch.data: streaming datasets over tasks/actors (ref analog:
python/ray/data; SURVEY.md §2.3 Data). The port of ray_tpu/data: blocks,
datasources and sinks, the streaming executor, the exchange and the LLM
corpus pipeline. It imports no torch; pyarrow and pandas are imported only
by the Arrow, parquet, csv and pandas paths."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.data.aggregate import (  # noqa: F401
    AggregateFn, Count, Max, Mean, Min, Std, Sum)
from ray_tpu_torch.data.dataset import (  # noqa: F401
    DataIterator, Dataset, from_items_rows)
from ray_tpu_torch.data.datasink import (  # noqa: F401
    Datasink, FileDatasink, JSONLDatasink, NpzDatasink, ParquetDatasink,
    WriteResult)
from ray_tpu_torch.data.datasource import (  # noqa: F401
    read_csv, read_json, read_npz, read_parquet, read_text, write_parquet)
from ray_tpu_torch.data.exchange import (  # noqa: F401
    ExchangeController, ExchangeSpec)
from ray_tpu_torch.data.executor import ActorPoolStrategy  # noqa: F401
from ray_tpu_torch.data.llm_corpus import (  # noqa: F401
    CorpusCursor, TokenCorpus, build_corpus, read_token_corpus)
from ray_tpu_torch.data.partitioning import Partitioning  # noqa: F401


def from_items(items: list, num_blocks: int = 8) -> Dataset:
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    return from_items_rows(rows, num_blocks)


def range(n: int, num_blocks: int = 8) -> Dataset:  # noqa: A001
    import builtins

    return from_items_rows([{"id": i} for i in builtins.range(n)], num_blocks)


def from_numpy(array, num_blocks: int = 8) -> Dataset:
    return from_items_rows([{"data": row} for row in array], num_blocks)


def from_pandas(df, num_blocks: int = 8) -> Dataset:
    return from_items_rows(df.to_dict("records"), num_blocks)
