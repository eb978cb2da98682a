"""Distributed progress bars (ref analog:
python/ray/experimental/tqdm_ray.py): tasks/actors update a bar; driver
renders. State rides the GCS metrics channel as gauges, so the driver
(or `rayt status` tooling) aggregates worker progress without stdout
interleaving."""

from __future__ import annotations

import os
import sys
import time


class tqdm:
    """tqdm-shaped progress reporting from inside tasks/actors."""

    def __init__(self, iterable=None, desc: str = "", total: int | None = None,
                 position: int = 0, report_interval_s: float = 0.5):
        self._iterable = iterable
        self.desc = desc or "progress"
        self.total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        self.n = 0
        self._last_report = 0.0
        self._interval = report_interval_s
        from ray_tpu_torch.util.metrics import Gauge

        name = self.desc.replace(" ", "_")
        self._gauge = Gauge(f"tqdm_{name}", tag_keys=("pid",))
        self._tags = {"pid": str(os.getpid())}

    def __iter__(self):
        for item in self._iterable:
            yield item
            self.update(1)
        self.close()

    def update(self, n: int = 1):
        self.n += n
        now = time.monotonic()
        if now - self._last_report >= self._interval:
            self._last_report = now
            self._report()

    def _report(self):
        try:
            self._gauge.set(float(self.n), tags=self._tags)
        except Exception:
            pass
        if sys.stderr.isatty():
            frac = (f"{self.n}/{self.total}" if self.total
                    else str(self.n))
            print(f"\r{self.desc}: {frac}", end="", file=sys.stderr)

    def close(self):
        self._report()
        if sys.stderr.isatty():
            print(file=sys.stderr)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
