"""TrainController — the v2-style run state machine (ref analog:
train/v2/_internal/execution/controller.py:74 `TrainController` +
failure_handling/failure_policy.py:14).

Loop: start worker group → poll run futures + drain reported results →
on worker death consult the FailurePolicy → either restart the whole
group from the latest checkpoint (a group restarts gang-wise; there is
no single-worker recovery inside an SPMD program) or surface the error.
A copy of ray_tpu/train/controller.py.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainingFailedError(RuntimeError):
    pass


class FailurePolicy:
    """Decide RETRY vs RAISE after a worker-group failure."""

    RETRY = "retry"
    RAISE = "raise"

    def __init__(self, max_failures: int):
        self.max_failures = max_failures
        self.failures = 0

    def decide(self, error: BaseException) -> str:
        self.failures += 1
        if self.max_failures < 0 or self.failures <= self.max_failures:
            return self.RETRY
        return self.RAISE


class ScalingPolicy:
    """Elasticity hook (ref: scaling_policy.py:26): called before each
    (re)start with the requested config; may return a resized one. Slice
    granularity is the caller's responsibility — you can't drop one host
    of a slice."""

    def on_start(self, scaling: ScalingConfig) -> ScalingConfig:
        return scaling


class ElasticScalingPolicy(ScalingPolicy):
    """Resize at worker granularity on restart: size the group to what
    the ALIVE cluster can hold right now, clamped to
    [min_workers, max_workers]. On a node death the failure path
    checkpoints, this policy shrinks the group, the surviving hosts
    rebuild the collective group at the new world size, and the
    user loop resumes from the latest checkpoint; when capacity returns a
    later (re)start grows the group back (ref:
    train/v2/_internal/execution/scaling_policy/scaling_policy.py:26).

    One worker == one bundle (ScalingConfig.worker_resources), so
    shrinking by whole workers never leaves a worker with a fraction of
    its lease.
    """

    def __init__(self, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 settle_timeout_s: float = 15.0):
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.settle_timeout_s = settle_timeout_s

    def _capacity(self, per_worker: dict) -> int:
        cluster = rt.cluster_resources()  # alive nodes only
        cap = None
        for r, amt in per_worker.items():
            if amt <= 0:
                continue
            fit = int(cluster.get(r, 0.0) // amt)
            cap = fit if cap is None else min(cap, fit)
        return cap if cap is not None else 0

    def on_start(self, scaling: ScalingConfig) -> ScalingConfig:
        import dataclasses as _dc

        want = self.max_workers or scaling.num_workers
        per = scaling.worker_resources()
        deadline = time.monotonic() + self.settle_timeout_s
        cap = self._capacity(per)
        # brief settle: right after a crash the dead node may not be
        # reaped from the view yet (or a replacement may be mid-register)
        while cap < self.min_workers and time.monotonic() < deadline:
            time.sleep(0.5)
            cap = self._capacity(per)
        n = max(self.min_workers, min(want, cap))
        if n == scaling.num_workers:
            return scaling
        return _dc.replace(scaling, num_workers=n)


class TrainController:
    def __init__(self, train_fn: Callable, config: Optional[dict],
                 scaling: ScalingConfig, run_config: RunConfig,
                 scaling_policy: Optional[ScalingPolicy] = None):
        self.train_fn = train_fn
        self.config = config
        self.scaling = scaling
        self.run_config = run_config
        name = run_config.name or f"train_{int(time.time())}"
        self.experiment_name = name
        self.experiment_path = os.path.join(
            run_config.resolved_storage_path(), name)
        os.makedirs(self.experiment_path, exist_ok=True)
        cc = run_config.checkpoint_config
        self.checkpoint_manager = CheckpointManager(
            cc.num_to_keep, cc.checkpoint_score_attribute,
            cc.checkpoint_score_order)
        self.failure_policy = FailurePolicy(
            run_config.failure_config.max_failures)
        self.scaling_policy = scaling_policy or ScalingPolicy()
        self.latest_metrics: Optional[dict] = None
        self._group_seq = 0
        self._last_world_size = scaling.num_workers
        self._seen_checkpoints: set[str] = set()
        # train-plane observability: the run id keys every step record /
        # compile event / memory snapshot this run's workers publish
        # (core/gcs_train_manager); minted here, threaded through
        # WorkerGroup.setup into each worker's session
        from ray_tpu_torch.train.telemetry import mint_run_id

        self.run_id = mint_run_id()

    def _publish_run_state(self, state: str, world_size: int):
        """Best-effort run lifecycle record onto the train_state
        channel (RUNNING at group start, FINISHED/FAILED at the end) —
        carries the job id so the GCS purges the run on job finish."""
        import time as _time

        from ray_tpu_torch.train.telemetry import publish_record

        job_hex = ""
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            if cw is not None and cw.job_id is not None:
                job_hex = cw.job_id.hex()
        except Exception:
            pass
        publish_record({"kind": "run", "run_id": self.run_id,
                        "experiment": self.experiment_name,
                        "job_id": job_hex, "world_size": world_size,
                        "state": state, "ts": _time.time()})

    # ------------------------------------------------------------------ run
    def run(self) -> Result:
        error: Optional[BaseException] = None
        while True:
            sized = self.scaling_policy.on_start(self.scaling)
            self._last_world_size = sized.num_workers
            group = WorkerGroup(
                sized, self.run_config,
                self.experiment_path, self.experiment_name, self._group_seq,
                run_id=self.run_id)
            self._group_seq += 1
            latest = (self.checkpoint_manager.latest.path
                      if self.checkpoint_manager.latest else None)
            try:
                group.start(latest)
                self._publish_run_state("RUNNING", sized.num_workers)
                run_refs = group.run_async(self.train_fn, self.config)
                self._poll(group, run_refs)
                self._ingest(group.drain_results())
                group.shutdown()
                self._publish_run_state("FINISHED", sized.num_workers)
                return self._result(None)
            except (rt.ActorDiedError, rt.WorkerCrashedError, rt.TaskError,
                    rt.RayTpuError, TimeoutError) as e:
                self._ingest_safe(group)
                self._recover_checkpoints_from_storage()
                group.shutdown()
                if self.failure_policy.decide(e) == FailurePolicy.RETRY:
                    continue
                error = e
                self._publish_run_state("FAILED", sized.num_workers)
                return self._result(error)

    def _poll(self, group: WorkerGroup, run_refs: list):
        pending = list(run_refs)
        while pending:
            done, pending = rt.wait(pending, num_returns=len(pending),
                                    timeout=0.25)
            self._ingest(group.drain_results())
            for ref in done:
                rt.get(ref)  # raises worker/user errors

    def _recover_checkpoints_from_storage(self):
        """After a crash, reported-but-undrained checkpoints exist only as
        directories with per-rank `.complete-rank_*` markers — pick up any
        complete ones (all ranks reported) the manager hasn't seen."""
        import glob

        n = self._last_world_size
        for step_dir in sorted(glob.glob(
                os.path.join(self.experiment_path, "checkpoint_*"))):
            if step_dir in self._seen_checkpoints:
                continue
            markers = glob.glob(os.path.join(step_dir, ".complete-rank_*"))
            if len(markers) >= n:
                self._seen_checkpoints.add(step_dir)
                self.checkpoint_manager.register(Checkpoint(step_dir), {})

    def _ingest_safe(self, group: WorkerGroup):
        try:
            self._ingest(group.drain_results())
        except Exception:
            pass

    def _ingest(self, entries: list[dict]):
        # metrics: rank-0 rows are canonical (ref: v1 session semantics);
        # checkpoints: first sighting of a step dir registers it.
        for e in sorted(entries, key=lambda e: (e["index"], e["rank"])):
            if e["rank"] == 0:
                self.latest_metrics = e["metrics"]
            ckpt_dir = e.get("checkpoint_dir")
            if ckpt_dir and ckpt_dir not in self._seen_checkpoints:
                self._seen_checkpoints.add(ckpt_dir)
                self.checkpoint_manager.register(
                    Checkpoint(ckpt_dir), e["metrics"])

    def _result(self, error: Optional[BaseException]) -> Result:
        result = Result(
            metrics=self.latest_metrics,
            checkpoint=self.checkpoint_manager.latest,
            error=error,
            path=self.experiment_path)
        result._best_checkpoints = self.checkpoint_manager.best_with_metrics
        if error is not None:
            raise TrainingFailedError(
                f"training failed after {self.failure_policy.failures - 1} "
                f"restarts") from error
        return result
