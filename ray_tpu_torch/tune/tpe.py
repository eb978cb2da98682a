"""TPE searcher — sequential model-based search (ref analogs:
python/ray/tune/search/hyperopt/ + optuna's TPESampler; the algorithm is
an independent implementation of Bergstra et al. 2011's tree-structured
Parzen estimator: model P(x|good) and P(x|bad) with Parzen windows and
suggest the candidate maximizing their ratio).
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

from ray_tpu_torch.tune.search import (Categorical, Domain, Float, GridSearch,
                                       Integer, _set_path, _walk,
                                       _deep_copy_plain)


class Searcher:
    """Sequential suggestion interface (ref: tune/search/searcher.py)."""

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict):
        """Optional: observe an INTERMEDIATE result (multi-fidelity
        searchers model per-budget performance from these)."""

    def on_trial_complete(self, trial_id: str, result: Optional[dict]):
        pass


class TPESearcher(Searcher):
    def __init__(self, param_space: dict, *, metric: str, mode: str = "max",
                 n_startup_trials: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.space = param_space
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._leaves = list(_walk(param_space, ()))
        for path, leaf in self._leaves:
            if isinstance(leaf, GridSearch):
                raise ValueError(
                    "TPESearcher does not support grid_search leaves "
                    f"(at {'/'.join(map(str, path))}); use tune.choice")
        self._pending: dict[str, dict] = {}
        self._obs: list[tuple[dict, float]] = []  # (flat config, score)

    # ------------------------------------------------------------ interface
    def _has_model(self) -> bool:
        return len(self._obs) >= self.n_startup

    def suggest(self, trial_id: str) -> dict:
        if not self._has_model():
            flat = {p: leaf.sample(self.rng) for p, leaf in self._leaves}
        else:
            flat = self._suggest_tpe()
        self._pending[trial_id] = flat
        cfg = _deep_copy_plain(self.space)
        for p, v in flat.items():
            _set_path(cfg, p, v)
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[dict]):
        flat = self._pending.pop(trial_id, None)
        if flat is None or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._obs.append((flat, score))

    # ------------------------------------------------------------ internals
    def _split(self):
        ranked = sorted(self._model_obs(), key=lambda o: o[1],
                        reverse=True)
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        return ranked[:n_good], ranked[n_good:] or ranked[:1]

    def _suggest_tpe(self) -> dict:
        good, bad = self._split()
        out: dict = {}
        for path, leaf in self._leaves:
            g_vals = [o[0][path] for o in good]
            b_vals = [o[0][path] for o in bad]
            if isinstance(leaf, Categorical):
                out[path] = self._pick_categorical(leaf, g_vals, b_vals)
            elif isinstance(leaf, (Float, Integer)):
                out[path] = self._pick_numeric(leaf, g_vals, b_vals)
            else:  # Function etc.: no model, just sample
                out[path] = leaf.sample(self.rng)
        return out

    def _pick_categorical(self, leaf: Categorical, g_vals, b_vals):
        cats = leaf.categories
        # Laplace-smoothed counts under the good distribution, scored
        # against the bad distribution
        def probs(vals):
            return {c: (1 + sum(1 for v in vals if v == c))
                    / (len(cats) + len(vals)) for c in cats}
        pg, pb = probs(g_vals), probs(b_vals)
        scored = [(pg[c] / pb[c], c) for c in cats]
        total = sum(s for s, _ in scored)
        r = self.rng.uniform(0, total)
        acc = 0.0
        for s, c in scored:
            acc += s
            if r <= acc:
                return c
        return scored[-1][1]

    def _model_obs(self) -> list:
        """Observations backing the TPE model (subclass hook)."""
        return self._obs

    def _pick_numeric(self, leaf, g_vals, b_vals):
        log = isinstance(leaf, Float) and leaf.log
        lo, hi = float(leaf.lower), float(leaf.upper)

        def to_internal(v):
            return math.log(v) if log else float(v)

        def from_internal(v):
            v = math.exp(v) if log else v
            v = min(max(v, lo), hi if isinstance(leaf, Float) else hi - 1)
            return int(round(v)) if isinstance(leaf, Integer) else v

        ilo, ihi = to_internal(lo), to_internal(max(hi, lo + 1e-12))
        g = [to_internal(v) for v in g_vals]
        b = [to_internal(v) for v in b_vals]
        span = max(ihi - ilo, 1e-12)
        # Parzen windows centered on good observations; bandwidth shrinks
        # as observations accumulate
        bw_g = max(span / (1 + len(g)), 1e-12)
        bw_b = max(span / (1 + len(b)), 1e-12)

        def density(x, centers, bw):
            if not centers:
                return 1.0 / span
            s = sum(math.exp(-0.5 * ((x - c) / bw) ** 2) for c in centers)
            return s / (len(centers) * bw * math.sqrt(2 * math.pi)) + 1e-12

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            center = self.rng.choice(g) if g else self.rng.uniform(ilo, ihi)
            x = min(max(self.rng.gauss(center, bw_g), ilo), ihi)
            ratio = density(x, g, bw_g) / density(x, b, bw_b)
            if ratio > best_ratio:
                best_ratio, best_x = ratio, x
        return from_internal(best_x)


class BOHBSearcher(TPESearcher):
    """BOHB-class searcher: TPE over the HIGHEST fidelity that has
    enough observations (ref analogs: tune/search/bohb/ TuneBOHB;
    Falkner et al. 2018). Pair with ASHAScheduler — early rungs feed the
    per-budget models via on_trial_result, so the model warms up from
    cheap partial evaluations long before any trial completes."""

    def __init__(self, param_space: dict, *, metric: str,
                 mode: str = "max", budget_key: str = "training_iteration",
                 min_points_per_budget: int = 6, **kw):
        super().__init__(param_space, metric=metric, mode=mode, **kw)
        self.budget_key = budget_key
        self.min_points = min_points_per_budget
        # budget value -> [(flat config, score), ...]
        self._budget_obs: dict[float, list] = {}

    def on_trial_result(self, trial_id: str, result: dict):
        flat = self._pending.get(trial_id)
        if flat is None or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        budget = float(result.get(self.budget_key, 0.0))
        self._budget_obs.setdefault(budget, []).append((flat, score))

    def _has_model(self) -> bool:
        return super()._has_model() or any(
            len(v) >= self.min_points for v in self._budget_obs.values())

    def _model_obs(self) -> list:
        # highest budget whose sample count supports a Parzen split —
        # high-fidelity evidence beats plentiful low-fidelity evidence
        for b in sorted(self._budget_obs, reverse=True):
            if len(self._budget_obs[b]) >= self.min_points:
                return self._budget_obs[b]
        return self._obs or next(
            iter(self._budget_obs.values()), [])

# Searcher persistence is whole-object cloudpickle: the controller
# checkpoints self.search_alg verbatim and Tuner.restore unpickles it
# (controller._save_state / tuner.restore) — no separate state schema
# to drift out of sync.
