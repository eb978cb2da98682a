"""Streaming tokenized-LLM-corpus datasource (ref analogs:
python/ray/data file datasources + TorchTitan's checkpointable dataloader
— PAPERS.md arxiv 2410.06511 §3.1: "a sharded, resumable data loader
whose cursor travels with the model checkpoint").

A corpus is a directory (or glob) of token shards; each shard holds a
sequence of DOCUMENTS (token id arrays):

* ``.jsonl`` — one JSON object per line, token ids under ``column``;
* ``.parquet`` — a list-typed ``column`` of token ids, one row per doc;
* ``.npz`` — either ``tokens``(1-D) + ``doc_lens``, a 2-D ``tokens``
  (one row per doc), or a bare 1-D array (one doc).

**Shard assignment** is deterministic per ``(dp_rank, world_size)``:
shards sort lexicographically and rank r owns ``shards[r::world_size]``
— no coordination, no overlap, stable across restarts.

**Packing**: documents concatenate (optionally separated by ``eos_id``)
into fixed ``seq_len`` token blocks. Each block carries ``segment_ids``
(1-based document index within the block, so attention can mask
cross-document positions) — the standard pre-training pack format.

**Resumable cursor**: iteration state is (epoch, shard position, next
doc index, the partially-packed buffer). ``state_dict()`` snapshots it
after the last *emitted* block; restoring into a fresh TokenCorpus makes
the continuation BIT-IDENTICAL to an uninterrupted run — the contract
train checkpoints rely on (the cursor rides inside the model
checkpoint; see train/ingest.py).

Shard loads can optionally fan out through the streaming executor
(``shard_tasks=True``): shard files parse in remote tasks with the
topology's bounded in-flight window while delivery order stays FIFO, so
resume determinism is preserved.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Iterator, Optional

import numpy as np

from ray_tpu_torch.data.datasource import _expand

_TOKEN_DTYPE = np.int32


# --------------------------------------------------------------- loading
def load_shard_docs(path: str, column: str = "tokens",
                    dtype=_TOKEN_DTYPE) -> list:
    """Parse one shard file into its ordered list of document arrays."""
    lower = path.lower()
    if lower.endswith(".npz"):
        with np.load(path) as z:
            if "doc_lens" in z.files:
                flat = np.asarray(z[column], dtype=dtype)
                lens = np.asarray(z["doc_lens"], dtype=np.int64)
                bounds = np.cumsum(lens)[:-1]
                return [d for d in np.split(flat, bounds)]
            arr = np.asarray(z[column] if column in z.files
                             else z[z.files[0]])
            if arr.ndim == 2:
                return [row.astype(dtype) for row in arr]
            return [arr.astype(dtype)]
    if lower.endswith(".parquet"):
        import pyarrow.parquet as pq

        col = pq.read_table(path, columns=[column]).column(column)
        return [np.asarray(doc, dtype=dtype) for doc in col.to_pylist()]
    # jsonl (default)
    import json

    docs = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            docs.append(np.asarray(json.loads(line)[column], dtype=dtype))
    return docs


def assign_shards(paths: list, dp_rank: int, world_size: int) -> list:
    """Rank r's shard list: sorted paths strided by world size. Every
    token belongs to exactly one rank; assignment is a pure function of
    (paths, r, W), so restarts and re-created iterators agree."""
    if not 0 <= dp_rank < world_size:
        raise ValueError(f"dp_rank {dp_rank} not in [0, {world_size})")
    return sorted(paths)[dp_rank::world_size]


# ---------------------------------------------------------------- cursor
@dataclasses.dataclass
class CorpusCursor:
    """Everything needed to resume the packed-block stream exactly:
    position at document granularity plus the partial pack buffer (a
    document can straddle block boundaries)."""
    epoch: int = 0
    shard_pos: int = 0        # index into THIS rank's assigned shards
    doc_idx: int = 0          # next unconsumed document in that shard
    blocks_emitted: int = 0
    buf_tokens: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, _TOKEN_DTYPE))
    buf_segments: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, _TOKEN_DTYPE))
    buf_doc: int = 0          # segment id of the last buffered document

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "shard_pos": self.shard_pos,
                "doc_idx": self.doc_idx,
                "blocks_emitted": self.blocks_emitted,
                "buf_tokens": np.asarray(self.buf_tokens, _TOKEN_DTYPE),
                "buf_segments": np.asarray(self.buf_segments,
                                           _TOKEN_DTYPE),
                "buf_doc": self.buf_doc}

    @classmethod
    def from_state_dict(cls, state: dict) -> "CorpusCursor":
        return cls(
            epoch=int(state["epoch"]), shard_pos=int(state["shard_pos"]),
            doc_idx=int(state["doc_idx"]),
            blocks_emitted=int(state["blocks_emitted"]),
            buf_tokens=np.asarray(state["buf_tokens"], _TOKEN_DTYPE),
            buf_segments=np.asarray(state["buf_segments"], _TOKEN_DTYPE),
            buf_doc=int(state["buf_doc"]))


# ---------------------------------------------------------------- corpus
class TokenCorpus:
    """The streaming packed-block iterator over one rank's shards.

    Iterating yields ``{"tokens": (seq_len,) int32,
    "segment_ids": (seq_len,) int32}`` dicts. The iterator mutates the
    corpus's cursor as blocks are emitted; ``state_dict()`` between
    ``next()`` calls snapshots a resume point whose continuation is
    bit-identical to carrying on.
    """

    def __init__(self, paths, *, seq_len: int, dp_rank: int = 0,
                 world_size: int = 1, column: str = "tokens",
                 eos_id: Optional[int] = None, epochs: int = 1,
                 shard_tasks: bool = False, max_in_flight: int = 4):
        if seq_len <= 0:
            raise ValueError(f"seq_len must be positive, got {seq_len}")
        self.seq_len = seq_len
        self.column = column
        self.eos_id = eos_id
        self.epochs = epochs
        self.dp_rank = dp_rank
        self.world_size = world_size
        self.shard_tasks = shard_tasks
        self.max_in_flight = max_in_flight
        self.shards = assign_shards(_expand(paths), dp_rank, world_size)
        if not self.shards:
            raise ValueError(
                f"rank {dp_rank}/{world_size} was assigned no shards "
                f"(corpus has too few files)")
        self._cursor = CorpusCursor()

    # ---------------------------------------------------------- cursor io
    def state_dict(self) -> dict:
        return copy.deepcopy(self._cursor.state_dict())

    def load_state_dict(self, state: dict) -> None:
        self._cursor = CorpusCursor.from_state_dict(state)

    @property
    def cursor(self) -> CorpusCursor:
        return self._cursor

    # ------------------------------------------------------------ loading
    def _iter_shards_inline(self, start: int) -> Iterator[list]:
        for pos in range(start, len(self.shards)):
            yield load_shard_docs(self.shards[pos], self.column)

    def _iter_shards_tasks(self, start: int) -> Iterator[list]:
        """Shard parsing fanned out as tasks through the streaming
        topology: bounded in-flight prefetch, FIFO delivery (order is
        what makes the cursor deterministic)."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.data.executor import MapSpec, StreamingExecutor
        from ray_tpu_torch.data.streaming_executor import ExecutionOptions

        column = self.column

        def parse(row: dict) -> dict:
            return {"docs": load_shard_docs(row["path"], column)}

        refs = (rt.put([{"path": p}]) for p in self.shards[start:])
        executor = StreamingExecutor(execution_options=ExecutionOptions(
            max_in_flight=self.max_in_flight))
        out = executor.stream_pipeline(refs, [MapSpec("map", parse)])
        for ref in out:
            yield rt.get(ref)[0]["docs"]

    def _iter_shards(self, start: int) -> Iterator[list]:
        if self.shard_tasks:
            return self._iter_shards_tasks(start)
        return self._iter_shards_inline(start)

    # ---------------------------------------------------------- iteration
    def _drain(self) -> Iterator[dict]:
        """Emit full blocks while the pack buffer holds >= seq_len
        tokens. A cursor snapshotted between two blocks drained from the
        same buffer still holds the second one, so resume ALSO drains
        before touching any document."""
        cur = self._cursor
        seq = self.seq_len
        while len(cur.buf_tokens) >= seq:
            tokens = cur.buf_tokens[:seq].copy()
            segments = cur.buf_segments[:seq].copy()
            cur.buf_tokens = cur.buf_tokens[seq:]
            cur.buf_segments = cur.buf_segments[seq:]
            if len(cur.buf_segments):
                # renumber so segment ids stay small and a resumed
                # buffer packs identically
                base = int(cur.buf_segments[0]) - 1
                cur.buf_segments = cur.buf_segments - base
                cur.buf_doc -= base
            else:
                cur.buf_doc = 0
            # normalize emitted ids to start at 1
            segments = segments - (int(segments[0]) - 1)
            cur.blocks_emitted += 1
            yield {"tokens": tokens, "segment_ids": segments}

    def __iter__(self) -> Iterator[dict]:
        cur = self._cursor
        yield from self._drain()  # restored cursor may hold full blocks
        while cur.epoch < self.epochs:
            shard_iter = self._iter_shards(cur.shard_pos)
            for docs in shard_iter:
                while cur.doc_idx < len(docs):
                    doc = docs[cur.doc_idx]
                    cur.doc_idx += 1
                    cur.buf_doc += 1
                    if self.eos_id is not None:
                        doc = np.append(doc, _TOKEN_DTYPE(self.eos_id))
                    cur.buf_tokens = np.concatenate(
                        [cur.buf_tokens, np.asarray(doc, _TOKEN_DTYPE)])
                    cur.buf_segments = np.concatenate(
                        [cur.buf_segments,
                         np.full(len(doc), cur.buf_doc, _TOKEN_DTYPE)])
                    yield from self._drain()
                cur.shard_pos += 1
                cur.doc_idx = 0
            # epoch rollover: the tail buffer (< seq_len tokens) is
            # DROPPED, matching fixed-shape pre-training ingest
            cur.epoch += 1
            cur.shard_pos = 0
            cur.doc_idx = 0
            cur.buf_tokens = np.empty(0, _TOKEN_DTYPE)
            cur.buf_segments = np.empty(0, _TOKEN_DTYPE)
            cur.buf_doc = 0


def read_token_corpus(paths, *, seq_len: int, dp_rank: int = 0,
                      world_size: int = 1, **kwargs) -> TokenCorpus:
    """The datasource entry point (mirrors read_parquet & friends, but
    returns the streaming TokenCorpus rather than a Dataset: packing is
    stateful-sequential by design — the cursor is the feature)."""
    return TokenCorpus(paths, seq_len=seq_len, dp_rank=dp_rank,
                       world_size=world_size, **kwargs)


# ------------------------------------------------------- corpus building
def _write_token_shard(block, path: str) -> dict:
    """Pack one block of tokenized documents into one .npz token shard
    (``tokens`` flat + ``doc_lens`` — the TokenCorpus format). Retry
    safe the datasink way: the final name is deterministic per shard
    index, the temp name is per-pid, and os.replace commits atomically —
    a driver-level write-task retry replaces, never duplicates."""
    import os

    from ray_tpu_torch.data.block import block_rows

    docs = [np.asarray(r["tokens"], _TOKEN_DTYPE)
            for r in block_rows(block)]
    flat = (np.concatenate(docs) if docs
            else np.empty(0, _TOKEN_DTYPE))
    lens = np.asarray([len(d) for d in docs], np.int64)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:  # file handle: savez can't append .npz
        np.savez(f, tokens=flat, doc_lens=lens)
    os.replace(tmp, path)
    return {"path": path, "docs": len(docs), "tokens": int(flat.size)}


def build_corpus(inputs, out_dir: str, *, tokenize,
                 text_column: str = "text", num_shards: int = 8,
                 seed: int = 0, dedup: bool = True,
                 tokenize_batch_size: int = 64,
                 executor=None) -> list[str]:
    """The flagship corpus-prep pipeline, end to end on the exchange
    subsystem: multi-shard jsonl documents → content-hash dedup (hash
    exchange + per-partition set) → ``tokenize`` via map_batches →
    ``random_shuffle`` (pipelined shuffle exchange) → ``num_shards``
    packed ``.npz`` token shards that :class:`TokenCorpus` / the train
    ingest path (train/ingest.py) consume with the resumable-cursor
    contract intact.

    ``tokenize`` maps one document string to a list/array of token ids.
    Returns the ordered list of written shard paths (deterministic
    names, so ``TokenCorpus(out_dir, ...)`` re-expands identically)."""
    import hashlib
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch._internal.serialization import ship_code_by_value
    from ray_tpu_torch.data.datasource import read_json

    # `tokenize` rides inside _tok (a module-level closure here), so it
    # would pickle by REFERENCE — register its driver-local module for
    # by-value shipping like any MapSpec user fn
    ship_code_by_value(tokenize)
    ds = read_json(inputs)
    if executor is not None:
        ds._executor = executor
    if dedup:
        col = text_column

        def _content_hash(row: dict) -> dict:
            return {**row, "_ch": hashlib.sha1(
                row[col].encode()).hexdigest()}

        ds = ds.map(_content_hash).drop_duplicates("_ch")

    def _tok(rows: list) -> dict:
        return {"tokens": [tokenize(r[text_column]) for r in rows]}

    ds = ds.map_batches(_tok, batch_size=tokenize_batch_size,
                        batch_format="rows")
    ds = ds.random_shuffle(seed=seed).repartition(num_shards)

    os.makedirs(out_dir, exist_ok=True)
    write_task = rt.remote(num_cpus=1)(_write_token_shard)
    paths = [os.path.join(out_dir, f"shard-{i:05d}.npz")
             for i in range(num_shards)]
    # the write barrier is the pipeline's commit point: every shard file
    # is durably in place when build_corpus returns
    rt.get([write_task.remote(ref, p)
            for ref, p in zip(ds._iter_block_refs(), paths)])
    return paths
