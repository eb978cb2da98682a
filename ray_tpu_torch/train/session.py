"""Per-worker training session (ref analog: train/_internal/session.py —
`ray.train.report`, `get_checkpoint`, `get_context`).

Runs inside each TrainWorker actor. `report()` persists the worker's
checkpoint shard into run storage and queues the metrics row; the
controller drains rows via a concurrent actor method (threaded actor).

The port of ray_tpu/train/session.py. ``get_device()`` (Ray's
``ray.train.torch.get_device``) is the card when the worker was set up
with ``use_gpu``, and never a quiet fall back to the CPU. ``get_mesh()``
builds ``ScalingConfig.mesh`` over the workers: in the reference a
worker's mesh spans its host's local devices; in the port one process
owns one device, so the mesh spans the workers, and its first call starts
the process group across them (gloo with ``use_gpu=False``, NCCL
otherwise).
"""

from __future__ import annotations

import collections
import os
import shutil
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_context: "TrainContext | None" = None
_context_lock = threading.Lock()


class TrainContext:
    def __init__(self, rank: int, world_size: int, experiment_path: str,
                 experiment_name: str, latest_checkpoint: Optional[str],
                 mesh_axes: Optional[dict] = None,
                 ingest_spec=None, run_id: Optional[str] = None,
                 node_id: str = "", use_gpu: bool = False,
                 collective_group: Optional[str] = None):
        self.rank = rank
        self.collective_group = collective_group
        self._mesh = None
        self.use_gpu = use_gpu
        self.world_size = world_size
        self.experiment_path = experiment_path
        self.experiment_name = experiment_name
        self.mesh_axes = mesh_axes
        self.ingest_spec = ingest_spec
        self.run_id = run_id
        # per-step waterfall recorder (train/telemetry.py), live when
        # the controller minted a run id and capture is enabled
        self.recorder = None
        if run_id:
            try:
                from ray_tpu_torch.train.telemetry import (StepRecorder,
                                                           recording_enabled)

                if recording_enabled():
                    self.recorder = StepRecorder(
                        run_id, experiment_name, rank=rank,
                        node_id=node_id)
            except Exception:
                self.recorder = None
        self._latest_checkpoint_dir = latest_checkpoint
        self._results: collections.deque = collections.deque()
        self._results_cond = threading.Condition()
        # resume past existing step dirs so a restarted worker group never
        # reuses checkpoint_* names the controller has already seen
        self._report_index = self._next_free_index(experiment_path)
        self._last_report_t: float | None = None

    @staticmethod
    def _next_free_index(experiment_path: str) -> int:
        import glob

        top = 0
        for d in glob.glob(os.path.join(experiment_path, "checkpoint_*")):
            tail = os.path.basename(d).rsplit("_", 1)[-1]
            if tail.isdigit():
                top = max(top, int(tail) + 1)
        return top

    # -------------------------------------------------------------- API
    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.rank  # single-host-per-worker model

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_checkpoint(self) -> Optional[Checkpoint]:
        if self._latest_checkpoint_dir is None:
            return None
        return Checkpoint(self._latest_checkpoint_dir)

    def get_mesh(self):
        """The ``DeviceMesh`` of ScalingConfig.mesh (``{"data": -1}`` when
        None) across the workers, one rank each, built once. The first call
        starts the default process group (every worker must call it): gloo
        for ``use_gpu=False``, NCCL for the card. GPU workers beyond one
        need each lease pinned to its own card, which the port does not do
        yet (ROADMAP.md item 6): every worker would open cuda:0, and NCCL
        refuses two ranks on one card."""
        if self._mesh is not None:
            return self._mesh
        import torch.distributed as dist

        from ray_tpu_torch.parallel.mesh import build_mesh, init_process_group

        if self.use_gpu and self.world_size > 1:
            raise NotImplementedError(
                "a mesh across GPU workers needs each lease pinned to its own "
                "card (ROADMAP.md item 6); use num_workers=1 on one card, or "
                "use_gpu=False for gloo CPU ranks")
        device = self.get_device()
        if not dist.is_initialized():
            init_process_group(self.world_size, self.rank,
                               self._rendezvous_address(), device=device)
        self._mesh = build_mesh(dict(self.mesh_axes or {"data": -1}),
                                device)
        return self._mesh

    def _rendezvous_address(self) -> str:
        """Rank 0's ``tcp://ip:port`` for the process group, handed to the
        others over the workers' host collective group."""
        from ray_tpu_torch.parallel.mesh import free_address

        if self.world_size == 1:
            return free_address()
        from ray_tpu_torch.util import collective
        from ray_tpu_torch.util.collective.collective import _host_ip

        mine = free_address(_host_ip()) if self.rank == 0 else None
        group = collective.get_group(self.collective_group)
        return group.gather_obj(mine)[0]

    def close_process_group(self):
        """Destroy this process's default process group, if one was
        started (the loop ended, or the worker is torn down)."""
        import sys

        dist = sys.modules.get("torch.distributed")
        self._mesh = None
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()

    def get_device(self):
        """The ``torch.device`` this worker trains on: ``cuda`` when the
        trainer asked for GPUs (``ScalingConfig(use_gpu=True)``, the
        default), raising when torch then sees no CUDA device; ``cpu``
        only when the caller set ``use_gpu=False``. No card is pinned per
        lease yet (ROADMAP.md item 6): on one card every GPU worker uses
        the card."""
        import torch

        if not self.use_gpu:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "this train worker was leased a GPU (ScalingConfig("
                "use_gpu=True)) but torch sees no CUDA device; pass "
                "use_gpu=False to train on the CPU")
        return torch.device("cuda")

    def get_ingest(self, *, device=None, state: Optional[dict] = None):
        """This worker's corpus-ingest iterator (train/ingest.py), built
        from ScalingConfig.ingest with the shard slice derived from
        (rank, world_size); with a ``device`` its batches arrive there as
        tensors, without one as numpy. `state` restores a cursor saved in
        a checkpoint so the resumed token stream is bit-identical."""
        from ray_tpu_torch.train.ingest import CorpusIngestIterator

        if self.ingest_spec is None:
            raise RuntimeError(
                "no ingest configured: pass ScalingConfig(ingest="
                "IngestSpec(...)) to the trainer")
        return CorpusIngestIterator(
            self.ingest_spec, dp_rank=self.rank,
            world_size=self.world_size, device=device, state=state,
            experiment=self.experiment_name, recorder=self.recorder)

    def _emit_metrics(self, metrics: dict):
        """Per-report training telemetry onto the cluster metrics
        pipeline (TorchTitan-style per-step throughput — PAPERS.md):
        tokens/sec (passthrough or tokens/dt), MFU, and a generic gauge
        per scalar key so any reported metric charts on the dashboard."""
        from ray_tpu_torch.util import builtin_metrics as bm

        t = time.monotonic()
        dt = (t - self._last_report_t
              if self._last_report_t is not None else None)
        self._last_report_t = t
        tags = {"experiment": self.experiment_name, "rank": str(self.rank)}

        def scalar(key):
            v = metrics.get(key)
            return float(v) if isinstance(v, (int, float)) \
                and not isinstance(v, bool) else None

        tps = scalar("tokens_per_s")
        if tps is None and dt and dt > 0 and scalar("tokens") is not None:
            tps = scalar("tokens") / dt
        if tps is not None:
            bm.train_tokens_per_s.set(tps, tags=tags)
        mfu = scalar("mfu")
        if mfu is not None:
            bm.train_mfu.set(mfu, tags=tags)
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                bm.train_metric.set(float(v), tags={**tags, "key": str(k)})

    def report(self, metrics: dict, checkpoint: Optional[Checkpoint] = None):
        try:
            self._emit_metrics(metrics)
        except Exception:
            pass  # telemetry must never fail a train step
        entry = {"metrics": dict(metrics), "rank": self.rank,
                 "index": self._report_index, "checkpoint_dir": None}
        if checkpoint is not None:
            # the synchronous slice of the save (staging the shard into
            # run storage) is the step's ckpt_block_s waterfall stage;
            # an async-committed checkpoint's background portion is NOT
            # in here (see checkpoint.save_pytree_async)
            if self.recorder is not None:
                self.recorder.begin_phase("ckpt_block")
            try:
                step_dir = os.path.join(
                    self.experiment_path,
                    f"checkpoint_{self._report_index:06d}")
                rank_dir = os.path.join(step_dir, f"rank_{self.rank}")
                if os.path.abspath(checkpoint.path) != \
                        os.path.abspath(rank_dir):
                    os.makedirs(step_dir, exist_ok=True)
                    shutil.copytree(checkpoint.path, rank_dir,
                                    dirs_exist_ok=True)
                # durable completion marker: lets the controller recover
                # this checkpoint even if the worker dies before results
                # are drained
                with open(os.path.join(
                        step_dir, f".complete-rank_{self.rank}"), "w"):
                    pass
                entry["checkpoint_dir"] = step_dir
                self._latest_checkpoint_dir = step_dir
            finally:
                if self.recorder is not None:
                    self.recorder.end_phase()
        self._report_index += 1
        with self._results_cond:
            self._results.append(entry)
            self._results_cond.notify_all()

    def close_telemetry(self):
        """Worker teardown: drain the recorder's buffered step records
        synchronously so the run's tail survives the actor exit."""
        if self.recorder is not None:
            try:
                self.recorder.close()
            except Exception:
                pass

    # ------------------------------------------------------ controller side
    def drain_results(self) -> list[dict]:
        with self._results_cond:
            out = list(self._results)
            self._results.clear()
        return out


def get_context() -> TrainContext:
    if _context is None:
        raise RuntimeError("ray_tpu_torch.train.get_context() called "
                           "outside a training worker")
    return _context


def set_context(ctx: Optional[TrainContext]):
    global _context
    with _context_lock:
        _context = ctx


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None):
    get_context().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context().get_checkpoint()


def get_ingest(*, device=None, state: Optional[dict] = None):
    return get_context().get_ingest(device=device, state=state)


def get_device():
    return get_context().get_device()
