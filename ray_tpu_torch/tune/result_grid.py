"""ResultGrid — terminal view over a tuning run (ref analog:
python/ray/tune/result_grid.py)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result
from ray_tpu_torch.tune.trial import Trial, TrialStatus


class ResultGrid:
    def __init__(self, trials: list[Trial], *, metric: Optional[str] = None,
                 mode: str = "min", experiment_path: Optional[str] = None):
        self._trials = trials
        self._metric = metric
        self._mode = mode
        self.experiment_path = experiment_path

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, i: int) -> Result:
        return self._to_result(self._trials[i])

    def _to_result(self, trial: Trial) -> Result:
        result = Result(
            metrics=trial.last_result,
            checkpoint=(Checkpoint(trial.checkpoint_dir)
                        if trial.checkpoint_dir else None),
            error=(RuntimeError(trial.error) if trial.error else None),
            path=self.experiment_path)
        result.config = trial.config
        return result

    @property
    def num_errors(self) -> int:
        return sum(1 for t in self._trials if t.status == TrialStatus.ERROR)

    @property
    def num_terminated(self) -> int:
        return sum(1 for t in self._trials
                   if t.status == TrialStatus.TERMINATED)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric is required (none set in TuneConfig)")
        scored = [t for t in self._trials if t.metric(metric) is not None]
        if not scored:
            raise RuntimeError("no trial reported the metric "
                               f"{metric!r}")
        best = (max if mode == "max" else min)(
            scored, key=lambda t: t.metric(metric))
        return self._to_result(best)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for t in self._trials:
            row = dict(t.last_result or {})
            row["trial_id"] = t.trial_id
            for k, v in t.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)
