"""Datasink — the pluggable write path (ref analogs:
python/ray/data/datasource/datasink.py `Datasink`,
file_datasink.py `_FileDatasink/BlockBasedFileDatasink`).

One write task per block fans out over the cluster; each task writes its
files ATOMICALLY (write to ``<final>.tmp-<pid>-<rand>``, fsync-free
``os.replace`` to a final name that is DETERMINISTIC in the task index),
so a crash leaves no partial file visible and a retried write task
replaces its own output instead of duplicating it. The driver runs
``on_write_start`` before fan-out and ``on_write_complete`` after every
task reports, which also sweeps any orphaned temp files left by killed
attempts.

Partitioned writes route through :class:`~ray_tpu_torch.data.partitioning.
Partitioning`: rows land under hive-style ``col=value/`` directories
with the partition columns stripped from the file payload (the path IS
the value; the paired readers re-inject them).
"""

from __future__ import annotations

import abc
import dataclasses
import glob as globlib
import os
from typing import Optional

from ray_tpu_torch.data.block import (Block, NumpyBlock, block_rows,
                                      is_arrow_block, is_numpy_block,
                                      num_rows_of)
from ray_tpu_torch.data.partitioning import Partitioning, split_by_partition


@dataclasses.dataclass
class WriteResult:
    """What one write task produced (ref: datasink.py WriteResult)."""
    num_rows: int = 0
    num_bytes: int = 0
    paths: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class WriteTaskContext:
    """Identity of one write task: the task index keys deterministic
    output names; the attempt counts driver-level retries."""
    task_index: int
    attempt: int = 0


class Datasink(abc.ABC):
    """Where Dataset.write_* sends blocks. Subclasses must be picklable:
    ``write`` runs inside a remote task."""

    def on_write_start(self) -> None:
        """Driver-side, before any write task is submitted."""

    @abc.abstractmethod
    def write(self, block: Block, ctx: WriteTaskContext) -> WriteResult:
        """Write one block (inside a write task); idempotent per
        ``ctx.task_index`` — a retry must not duplicate output."""

    def on_write_complete(self, results: list) -> None:
        """Driver-side, after every write task succeeded."""

    def on_write_failed(self, error: Exception) -> None:
        """Driver-side, when a write task exhausted its retries."""


class FileDatasink(Datasink):
    """Directory-of-files sink with atomic per-file commit and optional
    hive partitioning. Subclasses implement ``write_file``."""

    file_suffix = "bin"

    def __init__(self, path: str,
                 partitioning: Optional[Partitioning] = None, *,
                 partition_cols: Optional[list] = None):
        if partitioning is None and partition_cols:
            partitioning = Partitioning(tuple(partition_cols))
        self.path = os.path.abspath(path)
        self.partitioning = partitioning

    # ------------------------------------------------------------ driver
    def on_write_start(self) -> None:
        os.makedirs(self.path, exist_ok=True)

    def on_write_complete(self, results: list) -> None:
        # sweep temp files orphaned by killed/retried attempts; every
        # surviving attempt has already os.replace()d its own temps away
        for stale in globlib.glob(os.path.join(self.path, "**", "*.tmp-*"),
                                  recursive=True):
            try:
                os.remove(stale)
            except OSError:
                pass

    # ------------------------------------------------------- write task
    def write(self, block: Block, ctx: WriteTaskContext) -> WriteResult:
        result = WriteResult()
        n = num_rows_of(block)
        if n == 0:
            return result
        if self.partitioning is None:
            self._commit_one(block, self.path, ctx, 0, result)
            return result
        for gi, (rel, rows) in enumerate(
                sorted(split_by_partition(block, self.partitioning).items())):
            part_dir = os.path.join(self.path, rel)
            os.makedirs(part_dir, exist_ok=True)
            self._commit_one(rows, part_dir, ctx, gi, result)
        return result

    def _commit_one(self, block: Block, dir_path: str,
                    ctx: WriteTaskContext, group_index: int,
                    result: WriteResult) -> None:
        final = os.path.join(
            dir_path,
            f"part-{ctx.task_index:05d}-{group_index:04d}"
            f".{self.file_suffix}")
        tmp = f"{final}.tmp-{os.getpid()}-{ctx.attempt}"
        try:
            self.write_file(block, tmp)
            os.replace(tmp, final)  # atomic commit
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)  # failed attempt: no partial file visible
        result.num_rows += num_rows_of(block)
        result.num_bytes += os.path.getsize(final)
        result.paths.append(final)

    def write_file(self, block: Block, path: str) -> None:
        raise NotImplementedError


class ParquetDatasink(FileDatasink):
    file_suffix = "parquet"

    def write_file(self, block: Block, path: str) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        if is_arrow_block(block):
            table = block
        elif is_numpy_block(block):
            table = pa.table({k: pa.array(v)
                              for k, v in block.cols.items()})
        else:
            table = pa.Table.from_pylist(block_rows(block))
        pq.write_table(table, path)


class JSONLDatasink(FileDatasink):
    file_suffix = "jsonl"

    def write_file(self, block: Block, path: str) -> None:
        import json

        import numpy as np

        def default(o):
            if isinstance(o, np.generic):
                return o.item()
            if isinstance(o, np.ndarray):
                return o.tolist()
            raise TypeError(f"not JSON serializable: {type(o)}")

        with open(path, "w") as f:
            for row in block_rows(block):
                f.write(json.dumps(row, default=default))
                f.write("\n")


class NpzDatasink(FileDatasink):
    """Columnar npz shards — the multi-dim-column format read_npz pairs
    with (token matrices and friends)."""

    file_suffix = "npz"

    def write_file(self, block: Block, path: str) -> None:
        import numpy as np

        if is_numpy_block(block):
            cols = block.cols
        else:
            rows = block_rows(block)
            cols = NumpyBlock({k: np.asarray([r[k] for r in rows])
                               for k in rows[0].keys()}).cols
        # np.savez appends .npz when missing — write to an explicit
        # file object so the temp path is exactly what we rename
        with open(path, "wb") as f:
            np.savez(f, **cols)


def write_datasink(dataset, sink: Datasink, *,
                   write_retries: int = 2,
                   concurrency: int = 8) -> list:
    """Fan a dataset's blocks out to ``sink`` as write tasks (one per
    block, bounded in-flight window) with per-task retry. Retries are
    safe because FileDatasink commit names are deterministic in the task
    index — attempt N+1 replaces attempt N's files, never duplicates
    them. Returns the per-task WriteResults."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._internal.serialization import ship_code_by_value

    try:
        ship_code_by_value(type(sink))
    except Exception:
        pass  # stdlib-importable sinks need no shipping

    def run_write(block: Block, sink: Datasink,
                  ctx: WriteTaskContext) -> WriteResult:
        return sink.write(block, ctx)

    write_task = rt.remote(num_cpus=1)(run_write)
    sink.on_write_start()
    results: dict[int, WriteResult] = {}
    attempts: dict = {}   # ref -> (task_index, attempt, block_ref)
    pending: list = []

    def submit(task_index: int, block_ref, attempt: int):
        ref = write_task.remote(
            block_ref, sink, WriteTaskContext(task_index, attempt))
        attempts[ref] = (task_index, attempt, block_ref)
        pending.append(ref)

    try:
        block_refs = enumerate(dataset._iter_block_refs())
        exhausted = False
        while True:
            while not exhausted and len(pending) < concurrency:
                try:
                    i, block_ref = next(block_refs)
                except StopIteration:
                    exhausted = True
                    break
                submit(i, block_ref, 0)
            if not pending:
                break
            done, pending[:] = rt.wait(pending, num_returns=1)
            for ref in done:
                task_index, attempt, block_ref = attempts.pop(ref)
                try:
                    results[task_index] = rt.get(ref)
                except Exception:
                    if attempt >= write_retries:
                        raise
                    # retried task rewrites the SAME final names
                    submit(task_index, block_ref, attempt + 1)
    except Exception as e:
        sink.on_write_failed(e)
        raise
    ordered = [results[i] for i in sorted(results)]
    sink.on_write_complete(ordered)
    return ordered
