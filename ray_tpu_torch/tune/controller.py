"""TuneController — event-driven trial lifecycle management (ref analog:
python/ray/tune/execution/tune_controller.py:68 + the PG-backed trial
resources of tune/execution/placement_groups.py).

Each trial owns a WorkerGroup (the same actors ray_tpu_torch.train uses): the
default is one world_size=1 worker, but a ScalingConfig turns every
trial into a multi-worker (placement-grouped) training run. A trial's
workers lease what its ScalingConfig asks for: one GPU each by the port's
default, or a fraction (``resources_per_worker={"GPU": 0.5}``) so that
trials share a card; without a ScalingConfig, ``resources_per_trial`` as
given; with neither, the port's default ``ScalingConfig()``: one GPU a
trial. A trial that leases a GPU on a cluster without one raises before
any trial starts, as the port's other entry points do without CUDA.
Rank 0's reported rows drive scheduler decisions (ASHA stops, PBT
exploit/explore restarts from a donor checkpoint).

The trials admitted together start together: every group's workers are
created and set up before the controller waits on any of them. The
reference starts them one at a time, each start blocking until its
workers are set up; its workers spend seconds importing jax, so its trials
still overlap, but the port's boot in a fraction of a second and a short
trial would finish before the next one started, leaving PBT and ASHA no
peers to compare at a boundary.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Callable, Optional

import cloudpickle

import ray_tpu_torch as rt
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, FIFOScheduler
from ray_tpu_torch.tune.trial import Trial, TrialStatus


def trial_scaling(scaling_config=None, resources_per_trial=None):
    """What each trial's workers lease: the ScalingConfig as given; else one
    worker leasing ``resources_per_trial`` (on the card when they name a
    GPU or a fraction of one, else on the CPU); else ``ScalingConfig()``."""
    from ray_tpu_torch.train.config import ScalingConfig

    if scaling_config is not None:
        return scaling_config
    if resources_per_trial:
        return ScalingConfig(num_workers=1,
                             use_gpu=bool(resources_per_trial.get("GPU")),
                             resources_per_worker=dict(resources_per_trial))
    return ScalingConfig()


class TuneController:
    def __init__(self, trainable: Callable, trials: list[Trial],
                 *, metric: Optional[str], mode: str,
                 scheduler: Optional[FIFOScheduler],
                 experiment_path: str, experiment_name: str,
                 max_concurrent: int, max_failures_per_trial: int = 0,
                 resources_per_trial: Optional[dict] = None,
                 scaling_config=None, search_alg=None):
        self.trainable = trainable
        self.trials = trials
        self.metric = metric
        self.mode = mode
        self.scheduler = scheduler or FIFOScheduler()
        self.experiment_path = experiment_path
        self.experiment_name = experiment_name
        self.max_concurrent = max_concurrent
        self.max_failures = max_failures_per_trial
        self.scaling = trial_scaling(scaling_config, resources_per_trial)
        self.search_alg = search_alg
        self._group_seq = 0
        if hasattr(self.scheduler, "set_population"):
            self.scheduler.set_population(self.trials)
        self._dirty = False

    # ------------------------------------------------------------------ run
    def run(self) -> list[Trial]:
        pending = [t for t in self.trials if t.status == TrialStatus.PENDING]
        if pending:
            self._check_gpu()
        running: list[Trial] = []
        while pending or running:
            starting = []
            while pending and len(running) + len(starting) < \
                    self.max_concurrent:
                # reap finished trials BEFORE launching: a launch waits
                # for its workers' setup, and one waiting on resources
                # held by finished-but-unreaped trials would stall the
                # loop for the whole 120s setup timeout (then count as a
                # spurious trial failure)
                self._reap_finished(running, pending, timeout=0.0)
                trial = pending.pop(0)
                try:
                    starting.append((trial, self._start(trial)))
                except Exception as e:
                    self._launch_failed(trial, pending, e)
            for trial, setup_refs in starting:
                try:
                    self._run(trial, setup_refs)
                except Exception as e:
                    self._launch_failed(trial, pending, e)
                    continue
                running.append(trial)
            if not running:
                # every start of this round failed: start what is still
                # pending (the loop ends once nothing is)
                continue
            self._reap_finished(running, pending, timeout=0.2)
            if self._dirty:
                self._save_state()
        self._save_state()
        return self.trials

    def _reap_finished(self, running: list[Trial], pending: list[Trial],
                       *, timeout: float):
        """Drain reports and finish (stop + release resources of) every
        trial whose run ref completed."""
        if not running:
            return
        done_refs, _ = rt.wait([t.run_ref for t in running],
                               num_returns=len(running), timeout=timeout)
        self._drain(running, pending)
        for trial in list(running):
            if trial.run_ref in done_refs and trial.status == \
                    TrialStatus.RUNNING:
                self._finish(trial, pending)
            if trial.status != TrialStatus.RUNNING:
                running.remove(trial)

    # ------------------------------------------------------------ internals
    def _check_gpu(self):
        """A trial leasing a GPU on a cluster that has none would wait out
        its workers' setup timeout and count as failed: raise instead."""
        if self.scaling.worker_resources().get("GPU") and \
                not rt.cluster_resources().get("GPU"):
            raise RuntimeError(
                "each trial leases a GPU (the default is ScalingConfig(): "
                "one a trial) but no node of the cluster found a CUDA "
                "device; run trials on the CPU with resources_per_trial="
                "{'CPU': 1} or ScalingConfig(use_gpu=False)")

    def _trial_dir(self, trial: Trial) -> str:
        return os.path.join(self.experiment_path, trial.trial_id)

    def _start(self, trial: Trial) -> list:
        """Create the trial's worker group and submit its setup; -> the
        setup refs."""
        from ray_tpu_torch.train.worker_group import WorkerGroup

        if self.search_alg is not None and trial.config is None:
            trial.config = self.search_alg.suggest(trial.trial_id)
        self._group_seq += 1
        group = WorkerGroup(
            self.scaling, None, self._trial_dir(trial),
            f"{self.experiment_name}-{trial.trial_id}", self._group_seq)
        trial.actor = group  # set early: _stop_trial_actor reaps on failure
        return group.start_async(trial.checkpoint_dir)

    def _run(self, trial: Trial, setup_refs: list) -> None:
        """Wait for the trial's workers' setup, then start its trainable."""
        rt.get(setup_refs, timeout=120)
        trial.run_refs = trial.actor.run_async(self.trainable, trial.config)
        trial.run_ref = trial.run_refs[0]
        trial.status = TrialStatus.RUNNING
        self._dirty = True

    def _launch_failed(self, trial: Trial, pending: list[Trial],
                       error: Exception) -> None:
        self._stop_trial_actor(trial)
        trial.num_failures += 1
        if trial.num_failures <= self.max_failures:
            trial.status = TrialStatus.PENDING
            pending.append(trial)
        else:
            trial.status = TrialStatus.ERROR
            trial.error = repr(error)
        self._dirty = True

    def _stop_trial_actor(self, trial: Trial):
        if trial.actor is not None:
            try:
                trial.actor.shutdown()
            except Exception:
                pass
        trial.actor = None
        trial.run_ref = None
        trial.run_refs = None

    def _drain(self, running: list[Trial], pending: list[Trial]):
        # rank 0's reports drive scheduling (ref: tune reads the rank-0
        # session; other ranks report for checkpoint sync only)
        refs = {t.trial_id: t.actor.workers[0].drain_results.remote()
                for t in running
                if t.actor is not None and t.actor.workers}
        for trial in running:
            ref = refs.get(trial.trial_id)
            if ref is None:
                continue
            try:
                entries = rt.get(ref, timeout=30)
            except Exception:
                continue  # dying actor: the run_ref surface handles it
            for entry in entries:
                self._on_result(trial, entry, pending)
                if trial.status != TrialStatus.RUNNING:
                    break

    def _on_result(self, trial: Trial, entry: dict, pending: list[Trial]):
        self._dirty = True
        metrics = dict(entry["metrics"])
        trial.iteration += 1
        metrics.setdefault("training_iteration", trial.iteration)
        trial.last_result = metrics
        trial.results.append(metrics)
        if entry.get("checkpoint_dir"):
            trial.checkpoint_dir = entry["checkpoint_dir"]
        if self.search_alg is not None:
            # multi-fidelity searchers (BOHB) model per-budget results
            on_res = getattr(self.search_alg, "on_trial_result", None)
            if on_res is not None:
                on_res(trial.trial_id, metrics)
        decision = self.scheduler.on_result(trial, metrics)
        if decision == STOP:
            self._stop_trial_actor(trial)
            trial.status = TrialStatus.TERMINATED
            if self.search_alg is not None:
                self.search_alg.on_trial_complete(trial.trial_id,
                                                  trial.last_result)
            return
        instruction = self.scheduler.exploit_instruction(trial)
        if instruction is not None:
            donor, new_config = instruction
            self._stop_trial_actor(trial)
            trial.config = new_config
            trial.checkpoint_dir = donor.checkpoint_dir
            trial.status = TrialStatus.PENDING
            trial.iteration = donor.iteration
            pending.append(trial)

    def _finish(self, trial: Trial, pending: list[Trial]):
        self._dirty = True
        try:
            rt.get(list(trial.run_refs or [trial.run_ref]))
            trial.status = TrialStatus.TERMINATED
            if self.search_alg is not None:
                self.search_alg.on_trial_complete(trial.trial_id,
                                                  trial.last_result)
        except Exception as e:
            trial.num_failures += 1
            if trial.num_failures <= self.max_failures:
                self._stop_trial_actor(trial)
                trial.status = TrialStatus.PENDING
                pending.append(trial)
                return
            trial.status = TrialStatus.ERROR
            trial.error = repr(e)
        self._stop_trial_actor(trial)

    def _save_state(self):
        state = {
            "experiment_name": self.experiment_name,
            "metric": self.metric, "mode": self.mode,
            "timestamp": time.time(),
            "trials": [t.snapshot() for t in self.trials],
        }
        os.makedirs(self.experiment_path, exist_ok=True)
        tmp = os.path.join(self.experiment_path, ".tuner_state.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(self.experiment_path,
                                     "tuner_state.json"))
        if self.search_alg is not None:
            # searcher fidelity across restores: the model's observations
            # and RNG resume exactly (ref: tune/execution/experiment_state
            # searcher checkpointing)
            try:
                blob = cloudpickle.dumps(self.search_alg)
                stmp = os.path.join(self.experiment_path, ".searcher.tmp")
                with open(stmp, "wb") as f:
                    f.write(blob)
                os.replace(stmp, os.path.join(self.experiment_path,
                                              "searcher_state.pkl"))
            except Exception:
                pass  # an unpicklable custom searcher degrades to fresh
        self._dirty = False


def new_trial_id() -> str:
    return uuid.uuid4().hex[:8]
