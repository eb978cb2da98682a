"""Block primitives. A Block is ONE of:

* a columnar ``pyarrow.Table`` (ref analog:
  python/ray/data/_internal/arrow_block.py — the reference is
  Arrow-first): what file readers produce; zero-copy slices; flows
  into numpy batches without touching Python rows;
* a :class:`NumpyBlock` — struct-of-arrays (dict of same-length numpy
  arrays). The accelerator-native columnar format: unlike Arrow it
  carries multi-dim columns (token matrices, images) natively, becomes
  tensors through ``torch.from_numpy`` without a copy, and pickles its
  arrays out-of-band (protocol 5) straight into the shm arena;
* a row-major Python list (of dicts, or bare items) for ad-hoc data.

``map_batches`` output batches become columnar blocks (NumpyBlock for
dict-of-arrays, Table stays Table), so a
``read_parquet -> map_batches -> iter_batches`` pipeline never
materializes per-row dicts. Every primitive here handles all three
flavors.
"""

from __future__ import annotations

import pickle
import zlib
from typing import Any, Iterable, Iterator

import numpy as np

Block = Any  # pyarrow.Table | NumpyBlock | list[dict] | list[Any]


class NumpyBlock:
    """Columnar struct-of-arrays block: dict of equal-length ndarrays.

    Slicing returns zero-copy views; pickling rides protocol-5
    out-of-band buffers (numpy supports PickleBuffer), so put/get of a
    large block moves bytes through the shm arena without row-wise
    pickle churn.
    """

    __slots__ = ("cols",)

    def __init__(self, cols: dict):
        self.cols = {k: np.asarray(v) for k, v in cols.items()}
        lengths = {len(v) for v in self.cols.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"NumpyBlock columns have unequal lengths: "
                f"{ {k: len(v) for k, v in self.cols.items()} }")

    @property
    def num_rows(self) -> int:
        if not self.cols:
            return 0
        return len(next(iter(self.cols.values())))

    def slice(self, start: int, length: int) -> "NumpyBlock":
        return NumpyBlock({k: v[start:start + length]
                           for k, v in self.cols.items()})

    def to_rows(self) -> list[dict]:
        keys = list(self.cols)
        return [{k: _item(self.cols[k][i]) for k in keys}
                for i in range(self.num_rows)]

    def __len__(self) -> int:
        return self.num_rows

    def __repr__(self):
        return (f"NumpyBlock(rows={self.num_rows}, "
                f"cols={list(self.cols)})")


def is_arrow_block(block: Block) -> bool:
    try:
        import pyarrow as pa
    except Exception:
        return False
    return isinstance(block, pa.Table)


def is_numpy_block(block: Block) -> bool:
    return isinstance(block, NumpyBlock)

def is_columnar_block(block: Block) -> bool:
    return is_numpy_block(block) or is_arrow_block(block)


def num_rows_of(block: Block) -> int:
    if is_columnar_block(block):
        return block.num_rows
    return len(block)


def slice_rows(block: Block, start: int, length: int) -> Block:
    """Zero-copy for columnar blocks, list slice otherwise."""
    if is_columnar_block(block):
        return block.slice(start, length)
    return block[start:start + length]


def iter_rows(block: Block) -> Iterator:
    """Row iterator over any block flavor. Genuinely streaming for
    columnar blocks: row dicts materialize one at a time (arrow:
    batch-at-a-time) so a fold over a large block never holds every
    row dict simultaneously (use block_rows when you WANT the list)."""
    if is_arrow_block(block):
        for batch in block.to_batches(max_chunksize=4096):
            yield from batch.to_pylist()
    elif is_numpy_block(block):
        keys = list(block.cols)
        for i in range(block.num_rows):
            yield {k: _item(block.cols[k][i]) for k in keys}
    else:
        yield from block


def block_rows(block: Block) -> list:
    """Materialize rows (list-of-dicts) from any block flavor."""
    if is_arrow_block(block):
        return block.to_pylist()
    if is_numpy_block(block):
        return block.to_rows()
    return block


def is_record_block(block: Block) -> bool:
    if is_columnar_block(block):
        return True
    return bool(block) and isinstance(block[0], dict)


def to_batch(block: Block, batch_format: str = "numpy") -> Any:
    if is_numpy_block(block):
        if batch_format == "numpy":
            # zero-copy views, READ-ONLY: these may alias the shared
            # object store, and an in-place `batch['x'] *= 2` would
            # silently corrupt the stored block for every other reader
            # (Arrow's zero-copy to_numpy has the same contract)
            return {k: _readonly_view(v) for k, v in block.cols.items()}
        if batch_format == "rows":
            return block.to_rows()
        if batch_format == "pyarrow":
            import pyarrow as pa

            return pa.table({k: pa.array(v)
                             for k, v in block.cols.items()})
        import pandas as pd

        return pd.DataFrame(block.cols)
    if is_arrow_block(block):
        if batch_format == "pyarrow":
            return block
        if batch_format == "rows":
            return block.to_pylist()
        if batch_format == "numpy":
            # columnar, zero-copy where dtypes allow
            return {name: block.column(name).to_numpy(zero_copy_only=False)
                    for name in block.column_names}
        return block.to_pandas()
    if batch_format == "pyarrow":
        import pyarrow as pa

        return pa.Table.from_pylist(block if is_record_block(block)
                                    else [{"item": v} for v in block])
    if batch_format == "rows":
        return block
    if not block:
        return {} if batch_format == "numpy" else None
    if not is_record_block(block):
        arr = np.asarray(block)
        if batch_format == "numpy":
            return {"item": arr}
        import pandas as pd

        return pd.DataFrame({"item": arr})
    keys = block[0].keys()
    cols = {k: np.asarray([row[k] for row in block]) for k in keys}
    if batch_format == "numpy":
        return cols
    import pandas as pd

    return pd.DataFrame(cols)


def from_batch(batch: Any) -> Block:
    """A user batch becomes a block. Columnar inputs STAY columnar —
    a dict of arrays from map_batches must not shatter into per-row
    dicts (the reference builds Arrow blocks here, arrow_block.py:130)."""
    if batch is None:
        return []
    if is_arrow_block(batch) or is_numpy_block(batch):
        return batch  # columnar formats ARE blocks
    if isinstance(batch, list):
        return batch
    if isinstance(batch, dict):
        if not batch:
            return []
        try:
            return NumpyBlock(batch)
        except ValueError:
            # ragged columns (per-row variable-length lists, e.g.
            # un-padded token lists): numpy can't hold them columnar —
            # degrade this block to rows rather than fail the pipeline
            keys = list(batch)
            n = len(batch[keys[0]])
            return [{k: _item(batch[k][i]) for k in keys}
                    for i in range(n)]
    # pandas
    return NumpyBlock({c: batch[c].to_numpy() for c in batch.columns})


def _item(x):
    if isinstance(x, np.generic):
        return x.item()
    return x


def _readonly_view(a: np.ndarray) -> np.ndarray:
    v = a.view()
    v.flags.writeable = False
    return v


def batch_iter(block: Block, batch_size: int | None) -> Iterator[Block]:
    if batch_size is None or batch_size <= 0:
        yield block
        return
    n = num_rows_of(block)
    for i in range(0, n, batch_size):
        yield slice_rows(block, i, batch_size)  # zero-copy for columnar


def split_block(block: Block, n: int) -> list[Block]:
    return split_partition(block, n, offset=0)


def concat_blocks(blocks: Iterable[Block]) -> Block:
    blocks = [b for b in list(blocks) if num_rows_of(b)]
    if not blocks:
        return []
    if all(is_numpy_block(b) for b in blocks):
        keys = list(blocks[0].cols)
        if all(list(b.cols) == keys for b in blocks):
            try:
                return NumpyBlock({k: np.concatenate([b.cols[k]
                                                      for b in blocks])
                                   for k in keys})
            except ValueError:
                # multi-dim columns with mismatched trailing dims
                # (e.g. per-batch-padded token matrices): degrade to
                # rows like the pre-columnar path instead of failing
                # the reduce task
                pass
    if any(is_arrow_block(b) for b in blocks):
        import pyarrow as pa

        tables = [b if is_arrow_block(b)
                  else pa.Table.from_pylist(block_rows(b))
                  for b in blocks]
        return pa.concat_tables(tables, promote_options="default")
    out: list = []
    for b in blocks:
        out.extend(block_rows(b))
    return out


# ------------------------------------------------------ partition kernels
#
# The exchange subsystem's map-side kernels (data/exchange.py). The rule:
# columnar blocks (NumpyBlock / arrow Table) are partitioned through
# INDEX ARRAYS — vectorized hash/argsort/searchsorted over the key
# column, then a columnar `take` — so no row dict ever materializes for
# columnar data. Row blocks take the per-row path. Shards produced from
# a columnar block are columnar, so reduce-side `concat_blocks` stays
# columnar end-to-end (np.concatenate over shm views).


_U64 = (1 << 64) - 1
_MIX1 = 0xFF51AFD7ED558CCD   # murmur3 fmix64 constants: a key & n with
_MIX2 = 0xC4CEB9FE1A85EC53   # a common stride must not alias mod n


def _mix_int(v: int) -> int:
    """Avalanche an integer key (identity % n would send stride-n keys
    — all-even ids, ids*10 — to ONE partition, serializing the whole
    reduce side). Must match the vectorized uint64 path bit-for-bit."""
    h = v & _U64  # two's-complement wrap, like astype(uint64)
    h = ((h ^ (h >> 33)) * _MIX1) & _U64
    h = ((h ^ (h >> 33)) * _MIX2) & _U64
    return (h ^ (h >> 33)) & 0x7FFFFFFF


def stable_hash(value: Any) -> int:
    """Process-stable key hash: builtin hash() of str/bytes is randomized
    per process (PYTHONHASHSEED), so two workers would route the same key
    to different partitions. crc32 over a canonical pickle is stable."""
    if isinstance(value, np.generic):
        # np.int64(5) is NOT a Python int (and would take the pickle
        # path), but the vectorized columnar hash treats it as 5 — user
        # map fns emit numpy scalars into row blocks, so normalize or
        # equal keys would route to different partitions by block flavor
        value = value.item()
    if isinstance(value, bytes):
        data = value
    elif isinstance(value, str):
        data = value.encode()
    elif isinstance(value, int):
        return _mix_int(value)
    elif isinstance(value, float) and value.is_integer():
        # 5 and 5.0 are EQUAL keys (dedup's membership check agrees),
        # so they must route to the same partition — JSON int/float
        # flavor mixing would otherwise split a key across partitions
        return _mix_int(int(value))
    else:
        data = pickle.dumps(value, protocol=4)
    return zlib.crc32(data)


def hash_values(values) -> np.ndarray:
    """Vectorized stable_hash over a key column. Integer dtypes mix in
    a few vector ops; everything else falls back to per-VALUE hashing
    (still only the key column — never whole rows). Must agree with
    stable_hash so columnar and row blocks in one exchange route keys
    identically."""
    arr = np.asarray(values)
    if arr.dtype.kind in "iub":
        h = arr.astype(np.int64, copy=False).astype(np.uint64)
        h = (h ^ (h >> np.uint64(33))) * np.uint64(_MIX1)
        h = (h ^ (h >> np.uint64(33))) * np.uint64(_MIX2)
        h ^= h >> np.uint64(33)
        return (h & np.uint64(0x7FFFFFFF)).astype(np.int64)
    vals = arr.tolist() if isinstance(values, np.ndarray) else list(values)
    return np.fromiter((stable_hash(v) for v in vals), dtype=np.int64,
                       count=len(vals))


def key_values(block: Block, key: str):
    """The key column of a block: ndarray for columnar blocks (zero-copy
    where the backing format allows), list for row blocks."""
    if is_numpy_block(block):
        return block.cols[key]
    if is_arrow_block(block):
        return block.column(key).to_numpy(zero_copy_only=False)
    return [row[key] for row in block]


def _key_array(block: Block, key) -> "np.ndarray | None":
    """The key column as a 1-D array for the vectorized kernels, or
    None when the kernel must take the row path: callable key, row
    block, or a multi-dim key column (argsort/searchsorted/unique all
    assume 1-D keys — a 2-D key would be silently wrong, not slow)."""
    if not (isinstance(key, str) and is_columnar_block(block)):
        return None
    arr = np.asarray(key_values(block, key))
    return arr if arr.ndim == 1 else None


def take(block: Block, indices) -> Block:
    """Rows at `indices`, preserving the block flavor (the exchange's
    gather primitive: one fancy-index per column, no row dicts)."""
    if is_numpy_block(block):
        idx = np.asarray(indices, dtype=np.int64)
        return NumpyBlock({k: v[idx] for k, v in block.cols.items()})
    if is_arrow_block(block):
        return block.take(np.asarray(indices, dtype=np.int64))
    return [block[i] for i in indices]


def _split_by_partition_ids(block: Block, pids: np.ndarray,
                            n: int) -> list[Block]:
    """One `take` per output partition from a per-row partition-id
    vector: stable argsort groups rows by pid, searchsorted finds the
    cut points."""
    order = np.argsort(pids, kind="stable")
    cuts = np.searchsorted(pids[order], np.arange(1, n))
    return [take(block, idx) for idx in np.split(order, cuts)]


def hash_partition(block: Block, key, n: int) -> list[Block]:
    """Split by stable key hash into n shards. 1-D string-named key
    columns on columnar blocks vectorize; callable/multi-dim keys force
    the row path; `key=None` means whole-row identity (dedup without a
    key column) — row path even for columnar blocks."""
    keys = _key_array(block, key) if key is not None else None
    if keys is not None:
        pids = hash_values(keys) % n
        return _split_by_partition_ids(block, pids, n)
    key_fn = _row_key_fn(key)
    shards: list[list] = [[] for _ in range(n)]
    for row in block_rows(block):
        shards[stable_hash(key_fn(row)) % n].append(row)
    return shards


def _row_key_fn(key):
    """Row-path key extractor: callable as-is, column lookup for a
    string, whole-row identity token for None."""
    if callable(key):
        return key
    if key is None:
        return _row_token
    return lambda r, _k=key: r[_k]


def _row_token(row: dict) -> bytes:
    """Canonical bytes of a whole row for keyless dedup/hashing (values
    may be unhashable, e.g. token lists)."""
    return pickle.dumps(sorted(row.items()), protocol=4)


def random_partition(block: Block, n: int, seed) -> list[Block]:
    """Uniform-random shard assignment, deterministic per seed (the
    shuffle map kernel — retried map tasks MUST reproduce the same
    assignment, see executor.random_shuffle)."""
    rows = num_rows_of(block)
    pids = np.random.default_rng(seed).integers(0, n, size=rows)
    if is_columnar_block(block):
        return _split_by_partition_ids(block, pids, n)
    shards: list[list] = [[] for _ in range(n)]
    for i, row in enumerate(block):
        shards[int(pids[i])].append(row)
    return shards


def range_partition(block: Block, key, bounds: list,
                    descending: bool = False) -> list[Block]:
    """Split at the n-1 `bounds` (given in output order: ascending, or
    descending when descending=True). Partition j holds keys between
    bounds[j-1] and bounds[j]; a key equal to a bound lands in the
    earlier partition. Columnar + string key → searchsorted over the key
    column; callable keys force the row path."""
    n = len(bounds) + 1
    keys = _key_array(block, key)
    if keys is not None:
        if descending:
            asc = np.asarray(list(bounds)[::-1])
            pids = len(bounds) - np.searchsorted(asc, keys, side="right")
        else:
            pids = np.searchsorted(np.asarray(bounds), keys, side="left")
        return _split_by_partition_ids(block, pids, n)
    import bisect

    key_fn = _row_key_fn(key)
    cmp_bounds = [_Neg(b) for b in bounds] if descending else list(bounds)
    shards: list[list] = [[] for _ in range(n)]
    for row in block_rows(block):
        k = key_fn(row)
        if descending:
            k = _Neg(k)
        shards[bisect.bisect_left(cmp_bounds, k)].append(row)
    return shards


def split_partition(block: Block, n: int, offset: int = 0) -> list[Block]:
    """split_block with the remainder rows rotated to partitions starting
    at `offset` (the repartition map kernel): repartitioning m blocks
    spreads the ±1 remainders round-robin across output partitions
    instead of piling them all onto partition 0 — so outputs balance
    within m rows WITHOUT the driver ever gathering per-block counts."""
    length = num_rows_of(block)
    size, rem = divmod(length, n)
    out, start = [], 0
    for j in range(n):
        end = start + size + (1 if (j - offset) % n < rem else 0)
        out.append(slice_rows(block, start, end - start))
        start = end
    return out


def sort_block(block: Block, key, descending: bool = False) -> Block:
    """Sort one block by key. Columnar + 1-D string key → one argsort
    over the key column + a columnar take; otherwise a row sort."""
    keys = _key_array(block, key)
    if keys is not None:
        order = np.argsort(keys, kind="stable")
        if descending:
            order = order[::-1]
        return take(block, order)
    return sorted(block_rows(block), key=_row_key_fn(key),
                  reverse=descending)


def shuffle_block(block: Block, seed) -> Block:
    """Deterministic local permutation (the shuffle reduce kernel)."""
    rows = num_rows_of(block)
    if rows == 0:
        return block
    return take(block, np.random.default_rng(seed).permutation(rows))


def sample_keys(block: Block, key, s: int) -> list:
    """~s evenly-strided key values (tiny — the only thing the driver
    sees during sample sort)."""
    rows = num_rows_of(block)
    if rows == 0:
        return []
    step = max(1, rows // s)
    keys = _key_array(block, key)
    if keys is not None:
        return keys[::step].tolist()
    key_fn = _row_key_fn(key)
    return [key_fn(r) for r in block_rows(block)[::step]]


def project_column(block: Block, key: str) -> Block:
    """A key-column-only block (columnar stays columnar): the map-side
    projection for exchanges that only need the key (Dataset.unique), so
    full rows never cross the wire."""
    vals = key_values(block, key)
    if isinstance(vals, np.ndarray):
        return NumpyBlock({key: vals})
    return [{key: v} for v in vals]


def dedup_block(block: Block, key) -> Block:
    """First occurrence per distinct key within one block (the dedup
    reduce kernel — the hash exchange guarantees all copies of a key
    land in the same partition). Callable keys, multi-dim key columns,
    and `key=None` (whole-row identity) take the row path."""
    arr = _key_array(block, key) if key is not None else None
    if arr is not None:
        if arr.dtype.kind == "O":
            # object columns (nullable/mixed JSON values) may not be
            # orderable — np.unique sorts, so first-occurrence via dict
            # like the row path (same unhashable-value normalization)
            first_idx: dict = {}
            for i, v in enumerate(arr.tolist()):
                v = _hashable_key(v)
                if v not in first_idx:
                    first_idx[v] = i
            return take(block, sorted(first_idx.values()))
        _, first = np.unique(arr, return_index=True)
        return take(block, np.sort(first))
    key_fn = _row_key_fn(key)
    seen: set = set()
    out: list = []
    for row in block_rows(block):
        k = _hashable_key(key_fn(row))
        if k not in seen:
            seen.add(k)
            out.append(row)
    return out


_NAN_KEY = object()  # all NaN keys dedup as one (SQL-DISTINCT/pandas
# semantics, and what np.unique does on the numeric columnar path —
# without this the row path would keep every NaN since NaN != NaN)


def _hashable_key(v):
    """Hashable identity token for a dedup key value: ndarrays compare
    by bytes, other unhashable containers by their pickle, NaNs as one
    key."""
    if isinstance(v, np.ndarray):
        return v.tobytes()
    if isinstance(v, (list, dict, set)):
        return pickle.dumps(v, protocol=4)
    if isinstance(v, float) and v != v:
        return _NAN_KEY
    return v


class _Neg:
    """Order-reversing key wrapper for descending range partitioning."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return self.v == other.v


def iter_batches_from_blocks(block_iter: Iterable[Block], batch_size: int,
                             batch_format: str,
                             drop_last: bool) -> Iterator[Any]:
    """Re-batch a stream of blocks to `batch_size` WITHOUT materializing
    rows: columnar blocks are sliced (zero-copy views) and concatenated
    at batch granularity (ref analog: _internal/block_batching).
    Mixed-flavor boundaries degrade that one batch to rows."""
    pending: list[Block] = []
    pending_rows = 0

    def emit(blocks: list[Block]):
        block = blocks[0] if len(blocks) == 1 else concat_blocks(blocks)
        return to_batch(block, batch_format)

    for block in block_iter:
        n = num_rows_of(block)
        if n == 0:
            continue
        pending.append(block)
        pending_rows += n
        while pending_rows >= batch_size:
            take: list[Block] = []
            need = batch_size
            while need > 0:
                head = pending[0]
                hn = num_rows_of(head)
                if hn <= need:
                    take.append(pending.pop(0))
                    need -= hn
                else:
                    take.append(slice_rows(head, 0, need))
                    pending[0] = slice_rows(head, need, hn - need)
                    need = 0
            pending_rows -= batch_size
            yield emit(take)
    if pending_rows and not drop_last:
        yield emit(pending)
