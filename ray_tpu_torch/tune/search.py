"""Search-space primitives + the basic variant generator (ref analogs:
python/ray/tune/search/sample.py domains, search/basic_variant.py).

grid_search entries expand cartesian-product style; Domain leaves sample
per trial; num_samples repeats the whole expansion.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        import math

        if self.log:
            return math.exp(rng.uniform(math.log(self.lower),
                                        math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        try:
            return self.fn({})
        except TypeError:
            return self.fn()


class GridSearch:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


# ---------------------------------------------------------------- public API
def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


# ------------------------------------------------------------ variant expansion
def _walk(space: Any, path: tuple):
    """Yield (path, leaf) for grid/domain leaves inside nested dicts."""
    if isinstance(space, dict):
        if "grid_search" in space and len(space) == 1:
            yield path, GridSearch(space["grid_search"])
            return
        for k, v in space.items():
            yield from _walk(v, path + (k,))
    elif isinstance(space, (GridSearch, Domain)):
        yield path, space


def _set_path(cfg: dict, path: tuple, value: Any):
    node = cfg
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


def _deep_copy_plain(space: Any) -> Any:
    if isinstance(space, dict):
        return {k: _deep_copy_plain(v) for k, v in space.items()}
    return space


class BasicVariantGenerator:
    """Expand grid_search leaves cartesian-product-wise, sample Domain
    leaves, repeat num_samples times."""

    def __init__(self, param_space: dict, num_samples: int = 1,
                 seed: int | None = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> list[dict]:
        leaves = list(_walk(self.param_space, ()))
        grid_leaves = [(p, l) for p, l in leaves if isinstance(l, GridSearch)]
        domain_leaves = [(p, l) for p, l in leaves if isinstance(l, Domain)]
        grid_axes = [[(p, v) for v in l.values] for p, l in grid_leaves]
        out = []
        for _ in range(self.num_samples):
            for combo in itertools.product(*grid_axes) if grid_axes else [()]:
                cfg = _deep_copy_plain(self.param_space)
                for p, v in combo:
                    _set_path(cfg, p, v)
                for p, l in domain_leaves:
                    _set_path(cfg, p, l.sample(self.rng))
                out.append(cfg)
        return out
