"""Tuner — the hyperparameter-search entrypoint (ref analogs:
python/ray/tune/tuner.py:44/`fit:344`, tune/tune.py `run`)."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune.controller import (TuneController, new_trial_id,
                                           trial_scaling)
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import FIFOScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.trial import Trial, TrialStatus


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[FIFOScheduler] = None
    # sequential searcher (e.g. tune.TPESearcher); when set, trial
    # configs are suggested at launch time instead of pre-expanded
    search_alg: Optional[object] = None
    seed: Optional[int] = None


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: dict | None = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resources_per_trial: Optional[dict] = None,
                 scaling_config=None,
                 _restored_trials: Optional[list[Trial]] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources_per_trial = resources_per_trial
        # a ScalingConfig makes every trial a multi-worker (PG-backed,
        # mesh-rendezvous'd) training run (ref:
        # tune/execution/placement_groups.py trial resources)
        self.scaling_config = scaling_config
        self._restored_trials = _restored_trials

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        name = self.run_config.name or f"tune_{int(time.time())}"
        experiment_path = os.path.join(
            self.run_config.resolved_storage_path(), name)
        os.makedirs(experiment_path, exist_ok=True)
        if self._restored_trials is not None:
            trials = self._restored_trials
        elif tc.search_alg is not None:
            trials = [Trial(trial_id=f"{i:05d}_{new_trial_id()}",
                            config=None)
                      for i in range(tc.num_samples)]
        else:
            variants = BasicVariantGenerator(
                self.param_space, tc.num_samples, tc.seed).variants()
            trials = [Trial(trial_id=f"{i:05d}_{new_trial_id()}", config=v)
                      for i, v in enumerate(variants)]
        max_concurrent = tc.max_concurrent_trials or min(
            len(trials), 8, self._capacity_trials()) or 1
        controller = TuneController(
            self.trainable, trials,
            metric=tc.metric, mode=tc.mode, scheduler=tc.scheduler,
            experiment_path=experiment_path, experiment_name=name,
            max_concurrent=max_concurrent,
            max_failures_per_trial=self.run_config.failure_config.max_failures,
            resources_per_trial=self.resources_per_trial,
            scaling_config=self.scaling_config,
            search_alg=tc.search_alg)
        controller.run()
        return ResultGrid(trials, metric=tc.metric, mode=tc.mode,
                          experiment_path=experiment_path)

    def _capacity_trials(self) -> int:
        """How many trials the cluster can PLACE at once. The default
        concurrency must not exceed this: TuneController waits for each
        started trial's workers to be set up, so a trial waiting on
        resources that only finished-but-unreaped trials hold would stall
        the whole loop for the 120s setup timeout and then count as a trial
        FAILURE (observed: a 4-CPU cluster with 6 one-CPU trials). What
        a trial leases is read through ``worker_resources()``: the port's
        default adds one GPU a worker, which is what each worker leases."""
        import ray_tpu_torch as rt

        try:
            total = rt.cluster_resources()
        except Exception:
            return 8  # clusterless/unknown: keep the old default cap
        scaling = trial_scaling(self.scaling_config, self.resources_per_trial)
        per = scaling.worker_resources()
        workers = scaling.num_workers
        fits = []
        for res, amt in per.items():
            if amt and amt > 0:
                fits.append(int(total.get(res, 0.0) // (amt * workers)))
        return max(1, min(fits)) if fits else 8

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                tune_config: Optional[TuneConfig] = None,
                resources_per_trial: Optional[dict] = None) -> "Tuner":
        """Resume an interrupted run: terminated trials keep their results;
        pending/running/errored ones run (again) from their last
        checkpoint (ref analog: tune/tuner.py Tuner.restore +
        execution/experiment_state.py)."""
        state_file = os.path.join(path, "tuner_state.json")
        with open(state_file) as f:
            state = json.load(f)
        trials = [Trial.from_snapshot(s) for s in state["trials"]]
        searcher_file = os.path.join(path, "searcher_state.pkl")
        restored_searcher = None
        if os.path.exists(searcher_file):
            import cloudpickle

            with open(searcher_file, "rb") as f:
                restored_searcher = cloudpickle.loads(f.read())
        for t in trials:
            if t.status in (TrialStatus.RUNNING, TrialStatus.ERROR):
                t.status = TrialStatus.PENDING
        run_config = RunConfig(
            name=os.path.basename(path.rstrip("/")),
            storage_path=os.path.dirname(path.rstrip("/")))
        tc = tune_config or TuneConfig(metric=state.get("metric"),
                                       mode=state.get("mode") or "min")
        if restored_searcher is not None and tc.search_alg is None:
            tc.search_alg = restored_searcher
        return cls(trainable, tune_config=tc, run_config=run_config,
                   resources_per_trial=resources_per_trial,
                   _restored_trials=trials)
