"""Data->Train ingest bridge (ref analogs: train DataConfig +
data/_internal/iterator streaming_split ingest; TorchTitan's
checkpointable dataloader, PAPERS.md arxiv 2410.06511).

Each train worker owns one :class:`CorpusIngestIterator`: a background
producer thread pulls packed token blocks off a
:class:`~ray_tpu_torch.data.llm_corpus.TokenCorpus` (this host's deterministic
``(dp_rank, world_size)`` shard slice), stacks them into
``(batch_blocks, seq_len)`` batches, and parks them in a bounded queue;
the train loop's ``next()`` pops a ready batch and, given a ``device``,
moves it there as tensors (a pinned host copy, then
``.to(device, non_blocking=True)``); without one it yields numpy.
Prefetch depth bounds host memory; the queue hides shard-load latency
behind the train step. The port of ray_tpu/train/ingest.py, with
``device`` in place of the reference's ``mesh``.

**Cursor contract**: every delivered batch carries the corpus cursor
snapshotted AFTER that batch was packed. ``state_dict()`` returns the
cursor of the last batch the *consumer* actually received, so saving it
inside the model checkpoint (see recipes.corpus_pretrain_loop) and
restoring via ``ScalingConfig.ingest`` + ``session.get_ingest(state=…)``
resumes the token stream bit-identically — tokens consumed after the
checkpoint but before a crash are replayed, never skipped.

Telemetry rides the cluster metrics pipeline (util/builtin_metrics):
``rayt_ingest_tokens_per_s``, ``rayt_ingest_stall_s_total`` (consumer
time blocked on the queue), ``rayt_ingest_batches_total``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class IngestSpec:
    """Declarative corpus-ingest config, carried on ScalingConfig so the
    controller ships ONE description and every worker derives its own
    shard slice from (rank, world_size)."""
    paths: Any                       # file/dir/glob, as datasource._expand
    seq_len: int = 512
    batch_blocks: int = 8            # rows per delivered (B, seq_len) batch
    column: str = "tokens"
    eos_id: Optional[int] = None
    epochs: int = 1
    prefetch_batches: int = 4        # bounded producer queue depth
    shard_tasks: bool = False        # parse shards via streaming executor
    drop_last: bool = True           # tail batch smaller than batch_blocks


@dataclasses.dataclass
class IngestStats:
    batches: int = 0
    blocks: int = 0
    tokens: int = 0
    stall_s: float = 0.0      # consumer time blocked waiting on producer
    last_stall_s: float = 0.0  # the most recent next()'s queue wait
    load_s: float = 0.0       # producer time packing/loading batches
    wall_s: float = 0.0       # first next() to last next()


class _Stop:
    """Queue sentinel: end-of-corpus or producer error."""

    __slots__ = ("error",)

    def __init__(self, error: Optional[BaseException] = None):
        self.error = error


class CorpusIngestIterator:
    """Per-host iterator of device-ready ``{"tokens", "segment_ids"}``
    batches with a checkpointable cursor."""

    def __init__(self, spec: IngestSpec, *, dp_rank: int = 0,
                 world_size: int = 1, device=None,
                 state: Optional[dict] = None, experiment: str = "",
                 recorder=None):
        from ray_tpu_torch.data.llm_corpus import TokenCorpus

        self.spec = spec
        self.device = device
        self.dp_rank = dp_rank
        self.experiment = experiment
        # optional train/telemetry.StepRecorder: the queue wait becomes
        # the step's data_wait_s waterfall stage, and the blocked get()
        # is a watchdog-visible phase (ingest-starved attribution)
        self.recorder = recorder
        self.stats = IngestStats()
        self._corpus = TokenCorpus(
            spec.paths, seq_len=spec.seq_len, dp_rank=dp_rank,
            world_size=world_size, column=spec.column, eos_id=spec.eos_id,
            epochs=spec.epochs, shard_tasks=spec.shard_tasks)
        if state is not None:
            self._corpus.load_state_dict(state)
        self._delivered_state = self._corpus.state_dict()
        self._q: queue.Queue = queue.Queue(
            maxsize=max(1, spec.prefetch_batches))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._done = False
        self._t_first: Optional[float] = None
        self._t_last_batch: Optional[float] = None

    # ------------------------------------------------------------ cursor
    def state_dict(self) -> dict:
        """Cursor as of the last DELIVERED batch (not the producer's
        read-ahead position — prefetched-but-unconsumed batches must be
        replayed after a restore)."""
        return self._delivered_state

    # ---------------------------------------------------------- producer
    def _produce(self) -> None:
        spec = self.spec
        try:
            blocks: list = []
            t0 = time.perf_counter()
            for block in self._corpus:
                if self._stop.is_set():
                    return
                blocks.append(block)
                if len(blocks) == spec.batch_blocks:
                    batch = _stack(blocks)
                    state = self._corpus.state_dict()
                    self.stats.load_s += time.perf_counter() - t0
                    self._put((batch, state, len(blocks)))
                    blocks = []
                    t0 = time.perf_counter()
            if blocks and not spec.drop_last:
                batch = _stack(blocks)
                state = self._corpus.state_dict()
                self.stats.load_s += time.perf_counter() - t0
                self._put((batch, state, len(blocks)))
            self._put(_Stop())
        except BaseException as e:  # surface on the consumer side
            self._put(_Stop(e))

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # ---------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._done:
            raise StopIteration
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._produce, name="rayt-ingest-prefetch",
                daemon=True)
            self._thread.start()
            self._t_first = time.perf_counter()
        rec = self.recorder
        if rec is not None:
            rec.begin_phase("data_wait")
        t0 = time.perf_counter()
        try:
            item = self._q.get()
        finally:
            if rec is not None:
                rec.end_phase()
        stall = time.perf_counter() - t0
        self.stats.stall_s += stall
        self.stats.last_stall_s = stall
        if isinstance(item, _Stop):
            self._done = True
            if item.error is not None:
                raise item.error
            raise StopIteration
        batch, state, n_blocks = item
        self._delivered_state = state
        self.stats.batches += 1
        self.stats.blocks += n_blocks
        self.stats.tokens += int(batch["tokens"].size)
        self.stats.wall_s = time.perf_counter() - self._t_first
        self._emit_metrics(batch, stall)
        if rec is not None:
            with rec.phase("h2d"):
                return self._to_device(batch)
        return self._to_device(batch)

    def close(self) -> None:
        self._stop.set()
        self._done = True
        try:  # unblock a producer parked on a full queue
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    # ----------------------------------------------------------- helpers
    def _to_device(self, batch: dict) -> dict:
        if self.device is None:
            return batch
        import torch

        device = torch.device(self.device)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out

    def _emit_metrics(self, batch: dict, stall: float) -> None:
        try:
            from ray_tpu_torch.util import builtin_metrics as bm

            tags = {"experiment": self.experiment,
                    "rank": str(self.dp_rank)}
            now = time.perf_counter()
            if self._t_last_batch is not None:
                dt = now - self._t_last_batch
                if dt > 0:
                    bm.ingest_tokens_per_s.set(
                        batch["tokens"].size / dt, tags=tags)
            self._t_last_batch = now
            bm.ingest_stall_s.inc(stall, tags=tags)
            bm.ingest_batches.inc(1.0, tags=tags)
        except Exception:
            pass  # telemetry must never fail ingest


def _stack(blocks: list) -> dict:
    return {"tokens": np.stack([b["tokens"] for b in blocks]),
            "segment_ids": np.stack([b["segment_ids"] for b in blocks])}
