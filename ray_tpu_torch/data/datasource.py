"""Datasources: file reads fan out as tasks, one block per file/shard (ref
analog: python/ray/data/datasource/ + read_api.py)."""

from __future__ import annotations

import glob as globlib
import os
from typing import Optional

import ray_tpu_torch as rt


def _expand(paths) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(
                f for f in globlib.glob(os.path.join(p, "**"), recursive=True)
                if os.path.isfile(f)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(globlib.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths!r}")
    return out


def read_text(paths, *, drop_empty_lines: bool = True):
    from ray_tpu_torch.data.dataset import Dataset

    def read_file(path: str):
        with open(path) as f:
            lines = f.read().splitlines()
        if drop_empty_lines:
            lines = [ln for ln in lines if ln]
        return [{"text": ln} for ln in lines]

    task = rt.remote(num_cpus=1)(read_file)
    return Dataset([task.remote(p) for p in _expand(paths)])


def read_csv(paths):
    from ray_tpu_torch.data.dataset import Dataset

    def read_file(path: str):
        from pyarrow import csv as pa_csv

        return pa_csv.read_csv(path)  # arrow block (columnar)

    task = rt.remote(num_cpus=1)(read_file)
    return Dataset([task.remote(p) for p in _expand(paths)])


def read_parquet(paths, *, columns: Optional[list[str]] = None,
                 partitioning=None):
    """`partitioning` (data/partitioning.Partitioning) re-injects
    partition-column values encoded in hive-style paths — the read half
    of Dataset.write_parquet(partition_cols=...)."""
    from ray_tpu_torch.data.dataset import Dataset

    base = paths if isinstance(paths, str) and os.path.isdir(paths) \
        else None

    def read_file(path: str, columns, partitioning, base):
        import pyarrow as pa
        import pyarrow.parquet as pq

        # arrow table IS the block: stays columnar through the pipeline,
        # zero-copy into numpy batches for train ingest
        table = pq.read_table(path, columns=columns)
        if partitioning is not None:
            for k, v in partitioning.parse(path, base).items():
                if k not in table.column_names:
                    table = table.append_column(
                        k, pa.array([v] * table.num_rows))
        return table

    task = rt.remote(num_cpus=1)(read_file)
    return Dataset([task.remote(p, columns, partitioning, base)
                    for p in _expand(paths)])


def read_json(paths, *, partitioning=None):
    from ray_tpu_torch.data.dataset import Dataset

    base = paths if isinstance(paths, str) and os.path.isdir(paths) \
        else None

    def read_file(path: str, partitioning, base):
        import json

        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                rows = json.load(f)
            else:
                rows = [json.loads(ln) for ln in f if ln.strip()]
        if partitioning is not None:
            values = partitioning.parse(path, base)
            for row in rows:
                for k, v in values.items():
                    row.setdefault(k, v)
        return rows

    task = rt.remote(num_cpus=1)(read_file)
    return Dataset([task.remote(p, partitioning, base)
                    for p in _expand(paths)])


def write_parquet(dataset, path: str) -> None:
    """Legacy free-function surface; now routes through the Datasink
    write path (data/datasink.py: remote write tasks, atomic commit,
    retry-safe deterministic names)."""
    dataset.write_parquet(path)


def read_npz(paths, *, partitioning=None):
    """One columnar NumpyBlock per .npz file: the multi-dim-column
    format (token matrices, image stacks) Arrow files can't carry.
    Producer side: Dataset.write_npz, ray_tpu_torch.rl.offline.
    write_offline_dataset, or plain np.savez of equal-length arrays.
    `partitioning` re-injects hive-path-encoded columns, pairing with
    write_npz(partition_cols=...)."""
    from ray_tpu_torch.data.block import NumpyBlock
    from ray_tpu_torch.data.dataset import Dataset

    base = paths if isinstance(paths, str) and os.path.isdir(paths) \
        else None

    def read_file(path: str, partitioning, base):
        import numpy as np

        with np.load(path) as z:
            cols = {k: z[k] for k in z.files}
        if partitioning is not None and cols:
            n = len(next(iter(cols.values())))
            for k, v in partitioning.parse(path, base).items():
                cols.setdefault(k, np.full(n, v))
        return NumpyBlock(cols)

    task = rt.remote(num_cpus=1)(read_file)
    return Dataset([task.remote(p, partitioning, base)
                    for p in _expand(paths)])
