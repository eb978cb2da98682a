"""Aggregate plugin API (ref analog: python/ray/data/aggregate.py
AggregateFn + the built-ins Count/Sum/Min/Max/Mean/Std).

An AggregateFn is a distributive reducer: per-block tasks fold rows into
a small accumulator (`init` + `accumulate_row`), accumulators `merge`
pairwise, and `finalize` produces the result — so a global aggregation
moves only O(blocks) accumulators to the driver, never rows, and a
grouped aggregation folds each key's rows inside its hash partition.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional


class AggregateFn:
    def __init__(self, init: Callable[[], Any],
                 accumulate_row: Callable[[Any, dict], Any],
                 merge: Callable[[Any, Any], Any],
                 finalize: Optional[Callable[[Any], Any]] = None,
                 name: str = "agg"):
        self.init = init
        self.accumulate_row = accumulate_row
        self.merge = merge
        self.finalize = finalize or (lambda a: a)
        self.name = name


def _col(row: dict, on: Optional[str]):
    return row if on is None else row[on]


class Count(AggregateFn):
    def __init__(self, name: str = "count()"):
        super().__init__(lambda: 0, lambda a, r: a + 1,
                         lambda a, b: a + b, name=name)


class Sum(AggregateFn):
    def __init__(self, on: str, name: Optional[str] = None):
        super().__init__(lambda: 0,
                         lambda a, r: a + _col(r, on),
                         lambda a, b: a + b,
                         name=name or f"sum({on})")


class Min(AggregateFn):
    def __init__(self, on: str, name: Optional[str] = None):
        super().__init__(lambda: None,
                         lambda a, r: _col(r, on) if a is None
                         else min(a, _col(r, on)),
                         lambda a, b: b if a is None
                         else (a if b is None else min(a, b)),
                         name=name or f"min({on})")


class Max(AggregateFn):
    def __init__(self, on: str, name: Optional[str] = None):
        super().__init__(lambda: None,
                         lambda a, r: _col(r, on) if a is None
                         else max(a, _col(r, on)),
                         lambda a, b: b if a is None
                         else (a if b is None else max(a, b)),
                         name=name or f"max({on})")


class Mean(AggregateFn):
    def __init__(self, on: str, name: Optional[str] = None):
        super().__init__(lambda: (0.0, 0),
                         lambda a, r: (a[0] + _col(r, on), a[1] + 1),
                         lambda a, b: (a[0] + b[0], a[1] + b[1]),
                         lambda a: a[0] / a[1] if a[1] else float("nan"),
                         name=name or f"mean({on})")


class Std(AggregateFn):
    """Sample standard deviation via parallel Welford/Chan merge (the
    numerically stable pairwise form the reference uses)."""

    def __init__(self, on: str, ddof: int = 1, name: Optional[str] = None):
        def acc(a, r):
            n, mean, m2 = a
            x = _col(r, on)
            n += 1
            d = x - mean
            mean += d / n
            m2 += d * (x - mean)
            return (n, mean, m2)

        def merge(a, b):
            na, ma, m2a = a
            nb, mb, m2b = b
            if na == 0:
                return b
            if nb == 0:
                return a
            n = na + nb
            d = mb - ma
            return (n, ma + d * nb / n,
                    m2a + m2b + d * d * na * nb / n)

        def fin(a):
            n, _, m2 = a
            if n - ddof <= 0:
                return float("nan")
            return math.sqrt(m2 / (n - ddof))

        super().__init__(lambda: (0, 0.0, 0.0), acc, merge, fin,
                         name=name or f"std({on})")
