"""User-facing metrics API: Counter / Gauge / Histogram (ref analog:
python/ray/util/metrics.py:137,187,262).

Metrics register in a per-process registry; each record also publishes to
the GCS metrics channel (best-effort, dropped when no cluster is up) so
the GCS time-series store / dashboard can aggregate cluster-wide.

Publishing is BATCHED (ref analog: the reference's per-node metrics
agent shipping aggregated OpenCensus views, not raw records): records
merge into a process-local buffer — counters sum their deltas, gauges
last-write-win, histogram observations pre-bucket into their metric's
boundaries — and a flusher on the core worker's IO loop ships one
publish per ``metrics_flush_interval_s``. Hot paths (per-task latency
histograms) therefore cost a lock + dict update, never an RPC.
"""

from __future__ import annotations

import asyncio
import bisect
import threading
import time
import weakref
from typing import Dict, Optional, Sequence, Tuple

_registry: dict[str, "Metric"] = {}
_registry_lock = threading.Lock()

CH_METRICS = "metrics"


class _Batcher:
    """Process-local record aggregation + periodic flush to the GCS.

    Thread-safe: metric calls land from any thread; the flush coroutine
    runs on the core worker's IO loop. When no cluster is connected,
    records are dropped at the door (matching the old per-record
    behavior) so the buffer can't grow unbounded in clusterless runs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        # (name, tags) -> {"bounds": tuple, "counts": list, "sum", "count"}
        self._hists: dict[tuple, dict] = {}
        self._scheduled = False
        self._scheduled_at = 0.0
        # weakref to the core worker the pending flush was spawned on
        # (weakref, not id(): a freed worker's address can be recycled
        # by the allocator, which would defeat the identity check)
        self._scheduled_cw: Optional[weakref.ref] = None
        self._interval: float | None = None  # cached from config

    def _stale_after(self) -> float:
        """A flush scheduled longer ago than this is presumed dropped
        (the core worker it was spawned on shut down mid-flight — e.g.
        an rt.shutdown()/rt.init() cycle); the next record reschedules
        on the CURRENT core worker instead of waiting forever. Scales
        with the configured interval so a >2s flush cadence isn't
        mistaken for a dead flush."""
        return max(2.0, 2.0 * (self._interval or 0.0) + 0.5)

    def add(self, kind: str, name: str, value: float, tags: dict,
            bounds: Optional[tuple] = None, key: Optional[tuple] = None):
        cw = self._core_worker()
        if cw is None:
            return
        if key is None:
            key = (name, tuple(sorted(tags.items())))
        with self._lock:
            if kind == "counter":
                self._counters[key] = self._counters.get(key, 0.0) + value
            elif kind == "gauge":
                self._gauges[key] = value
            else:
                h = self._hists.get(key)
                if h is None or h["bounds"] != bounds:
                    h = self._hists[key] = {
                        "bounds": bounds,
                        "counts": [0] * (len(bounds) + 1),
                        "sum": 0.0, "count": 0}
                h["counts"][bisect.bisect_left(bounds, value)] += 1
                h["sum"] += value
                h["count"] += 1
            now = time.monotonic()
            # reschedule when the pending flush is presumed dead: aged
            # past the staleness bound, OR spawned on a PREVIOUS core
            # worker (an rt.shutdown()/rt.init() cycle killed it with
            # its loop — without this check the new cluster's first
            # records sit buffered until the age-based self-heal fires)
            schedule = (not self._scheduled
                        or now - self._scheduled_at > self._stale_after()
                        or self._scheduled_cw is None
                        or self._scheduled_cw() is not cw)
            if schedule:
                self._scheduled = True
                self._scheduled_at = now
                self._scheduled_cw = weakref.ref(cw)
        if schedule:
            self._spawn_flush(cw)

    @staticmethod
    def _core_worker():
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            if cw is None or cw.gcs is None:
                return None
            return cw
        except Exception:
            return None

    def _spawn_flush(self, cw):
        try:
            # shutdown-tracked spawn: the sweep cancels it instead of
            # leaving a destroyed-pending task at loop teardown
            cw._spawn_from_thread(self._flush_later(cw))
        except Exception:
            with self._lock:
                self._scheduled = False

    def _drain(self) -> list[dict]:
        ts = time.time()
        with self._lock:
            counters, self._counters = self._counters, {}
            gauges, self._gauges = self._gauges, {}
            hists, self._hists = self._hists, {}
        out: list[dict] = []
        for (name, tags), v in counters.items():
            out.append({"name": name, "kind": "counter", "value": v,
                        "tags": dict(tags), "ts": ts})
        for (name, tags), v in gauges.items():
            out.append({"name": name, "kind": "gauge", "value": v,
                        "tags": dict(tags), "ts": ts})
        for (name, tags), h in hists.items():
            out.append({"name": name, "kind": "histogram",
                        "tags": dict(tags), "ts": ts,
                        "bounds": list(h["bounds"]),
                        "counts": h["counts"], "sum": h["sum"],
                        "count": h["count"]})
        return out

    async def _flush_later(self, cw):
        from ray_tpu_torch._internal.config import get_config

        try:
            self._interval = get_config().metrics_flush_interval_s
            await asyncio.sleep(self._interval)
        except Exception:
            pass
        records = self._drain()
        try:
            if records and cw.gcs is not None:
                await cw.gcs.publish(CH_METRICS, records)
        except Exception:
            pass  # best-effort: dropped on GCS hiccup / shutdown
        resume = False
        with self._lock:
            if self._counters or self._gauges or self._hists:
                resume = True  # records raced in during the publish
                self._scheduled_at = time.monotonic()
            else:
                self._scheduled = False
        if resume:
            try:
                cw._spawn(self._flush_later(cw))  # already on the IO loop
            except Exception:
                with self._lock:
                    self._scheduled = False


_batcher = _Batcher()


def _publish(name: str, kind: str, value: float, tags: dict,
             bounds: Optional[tuple] = None):
    try:
        _batcher.add(kind, name, value, tags, bounds)
    except Exception:
        pass


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name is required")
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._bound: Dict[tuple, "_BoundMetric"] = {}
        with _registry_lock:
            _registry[name] = self

    def with_tags(self, tags: Optional[Dict[str, str]] = None):
        """Pre-resolved handle for a fixed tag set: merging, validation,
        and key sorting happen ONCE here instead of per observation —
        hot-path emitters (per-task latency/queue-depth instrumentation)
        hold the bound handle."""
        merged = self._merged_tags(tags)
        cache_key = tuple(sorted(merged.items()))
        bound = self._bound.get(cache_key)
        if bound is None:
            bound = self._bound[cache_key] = _BoundMetric(self, merged)
        return bound

    @property
    def info(self) -> dict:
        return {"name": self._name, "description": self._description,
                "tag_keys": self._tag_keys}

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _merged_tags(self, tags: Optional[Dict[str, str]]) -> dict:
        out = dict(self._default_tags)
        if tags:
            out.update(tags)
        unknown = set(out) - set(self._tag_keys)
        if unknown:
            raise ValueError(f"unknown tag keys {unknown} for metric "
                             f"{self._name!r} (declared {self._tag_keys})")
        return out


class Counter(Metric):
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._counts: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value <= 0:
            raise ValueError("Counter.inc() requires value > 0")
        merged = self._merged_tags(tags)
        key = tuple(sorted(merged.items()))
        with self._lock:
            self._counts[key] = self._counts.get(key, 0.0) + value
        _publish(self._name, "counter", value, merged)

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        key = tuple(sorted(self._merged_tags(tags).items()))
        with self._lock:
            return self._counts.get(key, 0.0)


class Gauge(Metric):
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        merged = self._merged_tags(tags)
        key = tuple(sorted(merged.items()))
        with self._lock:
            self._values[key] = float(value)
        _publish(self._name, "gauge", float(value), merged)

    def get(self, tags: Optional[Dict[str, str]] = None) -> float:
        key = tuple(sorted(self._merged_tags(tags).items()))
        with self._lock:
            return self._values.get(key, 0.0)


class Histogram(Metric):
    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        if not boundaries:
            raise ValueError("Histogram requires bucket boundaries")
        self._boundaries = sorted(float(b) for b in boundaries)
        self._buckets: Dict[Tuple, list] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        merged = self._merged_tags(tags)
        key = tuple(sorted(merged.items()))
        with self._lock:
            counts = self._buckets.setdefault(
                key, [0] * (len(self._boundaries) + 1))
            counts[bisect.bisect_left(self._boundaries, value)] += 1
        _publish(self._name, "histogram", float(value), merged,
                 bounds=tuple(self._boundaries))

    def buckets(self, tags: Optional[Dict[str, str]] = None) -> list:
        key = tuple(sorted(self._merged_tags(tags).items()))
        with self._lock:
            return list(self._buckets.get(
                key, [0] * (len(self._boundaries) + 1)))


class _BoundMetric:
    """A (metric, fixed-tags) handle from Metric.with_tags: the per-call
    cost drops to one lock + one aggregate update + the batcher append,
    with every key prebuilt."""

    __slots__ = ("_m", "_tags", "_key", "_pub_key", "_bounds")

    def __init__(self, m: Metric, merged: Dict[str, str]):
        self._m = m
        self._tags = merged
        self._key = tuple(sorted(merged.items()))
        self._pub_key = (m._name, self._key)
        self._bounds = (tuple(m._boundaries)
                        if isinstance(m, Histogram) else None)

    def inc(self, value: float = 1.0):
        m = self._m
        with m._lock:
            m._counts[self._key] = m._counts.get(self._key, 0.0) + value
        try:
            _batcher.add("counter", m._name, value, self._tags,
                         key=self._pub_key)
        except Exception:
            pass

    def set(self, value: float):
        m = self._m
        with m._lock:
            m._values[self._key] = float(value)
        try:
            _batcher.add("gauge", m._name, float(value), self._tags,
                         key=self._pub_key)
        except Exception:
            pass

    def observe(self, value: float):
        m = self._m
        with m._lock:
            counts = m._buckets.get(self._key)
            if counts is None:
                counts = m._buckets[self._key] = \
                    [0] * (len(self._bounds) + 1)
            counts[bisect.bisect_left(self._bounds, value)] += 1
        try:
            _batcher.add("histogram", m._name, float(value), self._tags,
                         bounds=self._bounds, key=self._pub_key)
        except Exception:
            pass


def registered_metrics() -> dict[str, Metric]:
    with _registry_lock:
        return dict(_registry)
