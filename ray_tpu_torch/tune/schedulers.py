"""Trial schedulers: FIFO, ASHA, PBT (ref analogs:
python/ray/tune/schedulers/{fifo,async_hyperband,pbt}.py).

The controller calls `on_result(trial, result)` per reported row and acts
on the decision; PBT additionally returns exploit instructions (clone a
better trial's checkpoint + mutate hyperparams).
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

from ray_tpu_torch.tune.trial import Trial

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial: Trial, result: dict) -> str:
        return CONTINUE

    def exploit_instruction(self, trial: Trial):
        return None


class ASHAScheduler(FIFOScheduler):
    """Asynchronous Successive Halving: at each rung (grace*eta^k
    iterations) a trial continues only if its metric is in the top 1/eta
    of results recorded at that rung."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.eta = reduction_factor
        self.max_t = max_t
        # rung -> {trial_id: metric at first crossing} (one score per peer)
        self._rungs: dict[int, dict[str, float]] = {}
        rung = grace_period
        while rung < max_t:
            self._rungs[rung] = {}
            rung *= reduction_factor

    def on_result(self, trial: Trial, result: dict) -> str:
        t = int(result.get(self.time_attr, trial.iteration))
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        value = float(value)
        if t >= self.max_t:
            return STOP
        rung = self._rung_for(t)
        if rung is None or trial.trial_id in self._rungs[rung]:
            return CONTINUE
        self._rungs[rung][trial.trial_id] = value
        recorded = list(self._rungs[rung].values())
        if len(recorded) < self.eta:
            return CONTINUE  # not enough peers to judge yet
        cutoff = self._cutoff(recorded)
        good = value <= cutoff if self.mode == "min" else value >= cutoff
        return CONTINUE if good else STOP

    def _rung_for(self, t: int) -> Optional[int]:
        best = None
        for rung in self._rungs:
            if t >= rung and (best is None or rung > best):
                best = rung
        return best

    def _cutoff(self, recorded: list[float]) -> float:
        s = sorted(recorded, reverse=(self.mode == "max"))
        k = max(1, int(math.ceil(len(s) / self.eta)))
        return s[k - 1]


class PopulationBasedTraining(FIFOScheduler):
    """PBT: every perturbation_interval iterations, trials in the bottom
    quantile clone the checkpoint of a top-quantile trial and continue
    with mutated hyperparameters."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self._population: list[Trial] = []

    def set_population(self, trials: list[Trial]):
        self._population = trials

    def on_result(self, trial: Trial, result: dict) -> str:
        return CONTINUE

    def exploit_instruction(self, trial: Trial):
        """Called by the controller at perturbation boundaries. Returns
        (donor_trial, mutated_config) when `trial` should exploit, else
        None."""
        t = trial.iteration
        if self.interval <= 0 or t == 0 or t % self.interval != 0:
            return None
        scored = [p for p in self._population
                  if p.metric(self.metric) is not None]
        if len(scored) < 2:
            return None
        scored.sort(key=lambda p: p.metric(self.metric),
                    reverse=(self.mode == "max"))
        n = len(scored)
        k = max(1, int(n * self.quantile))
        bottom = scored[n - k:]
        top = scored[:k]
        if trial not in bottom or trial in top:
            return None
        donor = self.rng.choice(top)
        if donor is trial or donor.checkpoint_dir is None:
            return None
        return donor, self._mutate(dict(donor.config))

    def _mutate(self, config: dict) -> dict:
        for key, spec in self.mutations.items():
            if key not in config:
                continue
            if isinstance(spec, list):
                config[key] = self.rng.choice(spec)
            elif callable(spec):
                config[key] = spec()
            else:  # Domain
                sample = getattr(spec, "sample", None)
                if sample is not None:
                    config[key] = sample(self.rng)
                    continue
                factor = self.rng.choice([0.8, 1.2])
                config[key] = config[key] * factor
        return config
