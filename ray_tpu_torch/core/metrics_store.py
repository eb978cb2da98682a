"""GCS-side metrics time-series store (ref analogs:
_private/metrics_agent.py:483 cluster aggregation for Prometheus, and
the reference dashboard's metrics head backed by Prometheus queries —
here a self-contained in-memory TSDB so the dashboard needs no external
Prometheus).

Every record published on the ``metrics`` pubsub channel lands here (see
``GcsServer.publish``). Records are aggregated into per-series ring
buffers of fixed-``resolution_s`` time bins bounded by ``retention_s``:

* **counter** records carry increment deltas; a bin holds the sum of
  deltas that landed in it, so query-time rate conversion is just
  ``sum(deltas in step) / step``.
* **gauge** records last-write-win within a bin.
* **histogram** records carry either a single raw observation (legacy
  single-record publish) or a batched bucket-delta
  (``counts``/``sum``/``count`` + ``bounds``, the batcher in
  util/metrics.py); bins hold bucket-count deltas so percentiles are
  computed by bucket interpolation at query time — and because series
  are keyed by (name, kind, tags), records for the same series from
  DIFFERENT nodes merge at ingest, giving cross-node percentiles for
  free. Series that differ only by a node-ish tag merge at query time
  with ``merge=True``.

Single-threaded by design: ingest and query both run on the GCS event
loop (the dashboard head is colocated), so no locking is needed.
"""

from __future__ import annotations

import bisect
import collections
import math
import time
from typing import Any, Optional, Sequence

# fallback bucket layout for raw histogram observations whose metric
# never declared boundaries (latencies in seconds fit this comfortably)
DEFAULT_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                  0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_HIST_AGGS = ("p50", "p90", "p95", "p99", "mean", "count", "sum")


class _Series:
    __slots__ = ("name", "kind", "tags", "bounds", "bins", "total",
                 "last", "cum_counts", "cum_sum", "cum_count", "updated")

    def __init__(self, name: str, kind: str, tags: tuple, maxbins: int):
        self.name = name
        self.kind = kind
        self.tags = tags
        self.bounds: tuple | None = None
        # ring of [bin_start_ts, payload]; maxlen implements retention
        self.bins: collections.deque = collections.deque(maxlen=maxbins)
        self.total = 0.0          # counter: cumulative sum of deltas
        self.last = 0.0           # gauge: last value seen
        self.cum_counts: list[int] | None = None  # histogram cumulative
        self.cum_sum = 0.0
        self.cum_count = 0
        self.updated = 0.0


class MetricsStore:
    def __init__(self, retention_s: float = 900.0,
                 resolution_s: float = 5.0, max_series: int = 4096):
        if resolution_s <= 0 or retention_s < resolution_s:
            raise ValueError("need resolution_s > 0 and "
                             "retention_s >= resolution_s")
        self.retention_s = float(retention_s)
        self.resolution_s = float(resolution_s)
        self.max_series = int(max_series)
        self._maxbins = int(math.ceil(retention_s / resolution_s)) + 1
        # LRU by last update so a tag-cardinality explosion evicts the
        # stalest series instead of growing without bound
        self._series: collections.OrderedDict[tuple, _Series] = \
            collections.OrderedDict()
        self.dropped_records = 0

    # -------------------------------------------------------------- ingest
    def ingest_many(self, records: Sequence[dict], now: float | None = None):
        for rec in records:
            self.ingest(rec, now=now)

    def ingest(self, rec: dict, now: float | None = None):
        """Accept one published metric record; malformed records are
        counted and dropped (observability must never take down the GCS
        event loop)."""
        try:
            self._ingest(rec, now)
        except Exception:
            self.dropped_records += 1

    def _ingest(self, rec: dict, now: float | None):
        name, kind = rec["name"], rec["kind"]
        ts = float(rec.get("ts") or now or time.time())
        tags = tuple(sorted((rec.get("tags") or {}).items()))
        # validate BEFORE creating the series so a malformed record
        # can't leave a phantom entry in the name directory
        if kind in ("counter", "gauge"):
            value = float(rec["value"])
        elif kind != "histogram":
            raise ValueError(f"unknown metric kind {kind!r}")
        key = (name, kind, tags)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series(name, kind, tags, self._maxbins)
            while len(self._series) > self.max_series:
                self._series.popitem(last=False)
        else:
            self._series.move_to_end(key)
        s.updated = ts
        if kind == "counter":
            s.total += value
            self._bin_add(s, ts, value)
        elif kind == "gauge":
            s.last = value
            self._bin_set(s, ts, value)
        else:
            self._ingest_histogram(s, rec, ts)

    def _ingest_histogram(self, s: _Series, rec: dict, ts: float):
        bounds = tuple(float(b) for b in (rec.get("bounds")
                                          or s.bounds or DEFAULT_BOUNDS))
        if s.bounds is None or (s.bounds != bounds and s.cum_count == 0):
            # first record (or a redefinition before any data) fixes the
            # bucket layout for the series' lifetime
            s.bounds = bounds
            s.cum_counts = [0] * (len(bounds) + 1)
        elif s.bounds != bounds:
            raise ValueError("histogram bounds changed mid-series")
        if "counts" in rec:  # batched bucket-delta record
            counts = list(rec["counts"])
            if len(counts) != len(s.bounds) + 1:
                raise ValueError("bucket count length mismatch")
            dsum = float(rec.get("sum", 0.0))
            dcount = int(rec.get("count", sum(counts)))
        else:  # legacy raw observation
            counts = [0] * (len(s.bounds) + 1)
            v = float(rec["value"])
            counts[bisect.bisect_left(s.bounds, v)] = 1
            dsum, dcount = v, 1
        for i, c in enumerate(counts):
            s.cum_counts[i] += c
        s.cum_sum += dsum
        s.cum_count += dcount
        payload = self._bin_payload(s, ts)
        for i, c in enumerate(counts):
            payload["counts"][i] += c
        payload["sum"] += dsum
        payload["count"] += dcount

    # bins -----------------------------------------------------------------
    def _bin_start(self, ts: float) -> float:
        return math.floor(ts / self.resolution_s) * self.resolution_s

    def _locate_bin(self, s: _Series, ts: float):
        """Find-or-create the bin for ts. Bins append in time order; a
        slightly-late record (cross-node clock skew) merges into a recent
        bin by a short right-to-left scan, and anything older than the
        ring folds into the oldest bin rather than corrupting order."""
        b = self._bin_start(ts)
        if not s.bins or b > s.bins[-1][0]:
            s.bins.append([b, self._zero_payload(s)])
            return s.bins[-1]
        for i in range(len(s.bins) - 1, max(-1, len(s.bins) - 9), -1):
            if s.bins[i][0] == b:
                return s.bins[i]
            if s.bins[i][0] < b:
                return s.bins[i + 1] if i + 1 < len(s.bins) else s.bins[-1]
        return s.bins[0]

    def _zero_payload(self, s: _Series):
        if s.kind == "counter":
            return [0.0]
        if s.kind == "gauge":
            return [0.0, False]  # value, seen
        return {"counts": [0] * (len(s.bounds or DEFAULT_BOUNDS) + 1),
                "sum": 0.0, "count": 0}

    def _bin_add(self, s: _Series, ts: float, v: float):
        self._locate_bin(s, ts)[1][0] += v

    def _bin_set(self, s: _Series, ts: float, v: float):
        payload = self._locate_bin(s, ts)[1]
        payload[0] = v
        payload[1] = True

    def _bin_payload(self, s: _Series, ts: float) -> dict:
        return self._locate_bin(s, ts)[1]

    # -------------------------------------------------------------- queries
    def names(self) -> list[dict]:
        """Metric name directory: kind, tag-key union, series count."""
        by_name: dict[tuple, dict] = {}
        for (name, kind, tags), s in self._series.items():
            entry = by_name.setdefault((name, kind), {
                "name": name, "kind": kind, "tag_keys": set(),
                "num_series": 0})
            entry["num_series"] += 1
            entry["tag_keys"].update(k for k, _ in tags)
        out = [{**e, "tag_keys": sorted(e["tag_keys"])}
               for e in by_name.values()]
        out.sort(key=lambda e: e["name"])
        return out

    def query(self, name: str, window_s: float = 300.0,
              step_s: float | None = None, agg: str | None = None,
              tags: Optional[dict] = None, merge: bool = False,
              now: float | None = None) -> dict:
        """Aligned time series for one metric name.

        Returns ``{"name", "kind", "agg", "step_s", "start", "end",
        "series": [{"tags": {...}, "points": [[t, v|None], ...]}]}``
        with one point per ``step_s`` covering ``window_s`` back from
        ``now``. Steps snap to multiples of the store resolution.

        * counters: ``agg`` "rate" (default, per-second) or "increase"
        * gauges: last value in the step (None where no data)
        * histograms: ``agg`` p50/p90/p95/p99 (bucket-interpolated),
          "mean", "count" (observations/s), or "sum"
        * ``tags``: subset filter ({"k": "v"} keeps matching series)
        * ``merge``: collapse all matching series into one (counters sum
          rates, gauges sum values, histogram buckets merge — the
          cross-node percentile path)
        """
        now = float(now if now is not None else time.time())
        window_s = max(float(window_s), self.resolution_s)
        window_s = min(window_s, self.retention_s)
        if step_s is None:
            step_s = max(self.resolution_s, window_s / 60.0)
        step_s = max(self.resolution_s,
                     math.ceil(float(step_s) / self.resolution_s)
                     * self.resolution_s)
        end = math.floor(now / step_s) * step_s + step_s
        nsteps = max(1, int(math.ceil(window_s / step_s)))
        start = end - nsteps * step_s

        matched = [s for (n, _k, _t), s in self._series.items()
                   if n == name and self._tags_match(s, tags)]
        kind = matched[0].kind if matched else None
        agg = self._check_agg(kind, agg)
        if merge and len(matched) > 1:
            groups = [matched]
        else:
            groups = [[s] for s in matched]
        series_out = []
        for group in groups:
            series_out.append({
                "tags": self._common_tags(group),
                "points": self._render_points(group, start, step_s,
                                              nsteps, agg),
            })
        return {"name": name, "kind": kind, "agg": agg,
                "step_s": step_s, "start": start, "end": end,
                "series": series_out}

    @staticmethod
    def _tags_match(s: _Series, flt: Optional[dict]) -> bool:
        if not flt:
            return True
        have = dict(s.tags)
        return all(have.get(k) == v for k, v in flt.items())

    @staticmethod
    def _common_tags(group: list[_Series]) -> dict:
        common = set(group[0].tags)
        for s in group[1:]:
            common &= set(s.tags)
        return dict(sorted(common))

    @staticmethod
    def _check_agg(kind: str | None, agg: str | None) -> str | None:
        if kind == "counter":
            agg = agg or "rate"
            if agg not in ("rate", "increase"):
                raise ValueError(f"bad counter agg {agg!r}")
        elif kind == "gauge":
            agg = agg or "last"
            if agg != "last":
                raise ValueError(f"bad gauge agg {agg!r}")
        elif kind == "histogram":
            agg = agg or "p50"
            if agg not in _HIST_AGGS:
                raise ValueError(f"bad histogram agg {agg!r}")
        return agg

    def _render_points(self, group: list[_Series], start: float,
                       step_s: float, nsteps: int, agg: str | None):
        kind = group[0].kind
        if kind == "histogram":
            return self._render_histogram(group, start, step_s, nsteps,
                                          agg)
        # two-level accumulation: within one series a step holds the
        # delta-sum (counter) or the LAST bin's value (gauge —
        # downsampling must not sum repeated sets); across merged series
        # steps sum (cluster totals across nodes)
        acc: list[float | None] = [None] * nsteps
        for s in group:
            per: list[float | None] = [None] * nsteps
            for b, payload in s.bins:  # bins are in time order
                idx = int((b - start) // step_s)
                if idx < 0 or idx >= nsteps:
                    continue
                if kind == "counter":
                    per[idx] = (per[idx] or 0.0) + payload[0]
                elif payload[1]:
                    per[idx] = payload[0]
            for i, v in enumerate(per):
                if v is not None:
                    acc[i] = (acc[i] or 0.0) + v
        points = []
        for i in range(nsteps):
            t = start + i * step_s
            v = acc[i]
            if v is not None and kind == "counter" and agg == "rate":
                v = v / step_s
            points.append([t, v])
        return points

    def _render_histogram(self, group: list[_Series], start: float,
                          step_s: float, nsteps: int, agg: str):
        bounds = group[0].bounds or DEFAULT_BOUNDS
        nb = len(bounds) + 1
        counts = [[0] * nb for _ in range(nsteps)]
        sums = [0.0] * nsteps
        totals = [0] * nsteps
        seen = [False] * nsteps
        for s in group:
            if (s.bounds or DEFAULT_BOUNDS) != bounds:
                continue  # merge needs one bucket layout; skip strangers
            for b, payload in s.bins:
                idx = int((b - start) // step_s)
                if idx < 0 or idx >= nsteps:
                    continue
                seen[idx] = True
                for i, c in enumerate(payload["counts"]):
                    counts[idx][i] += c
                sums[idx] += payload["sum"]
                totals[idx] += payload["count"]
        points = []
        for i in range(nsteps):
            t = start + i * step_s
            if not seen[i] or totals[i] == 0:
                points.append([t, None])
                continue
            if agg == "count":
                v: float = totals[i] / step_s
            elif agg == "sum":
                v = sums[i]
            elif agg == "mean":
                v = sums[i] / totals[i]
            else:
                q = {"p50": 0.5, "p90": 0.9, "p95": 0.95,
                     "p99": 0.99}[agg]
                v = _bucket_percentile(bounds, counts[i], totals[i], q)
            points.append([t, v])
        return points

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> list[dict]:
        """Cumulative view for the Prometheus scrape: counters/gauges as
        ``value``; histograms as count/sum plus cumulative ``buckets``
        ([upper_bound, cumulative_count], +Inf last) ready for
        ``_bucket`` rendering."""
        out = []
        for (name, kind, tags), s in self._series.items():
            entry: dict[str, Any] = {"name": name, "kind": kind,
                                     "tags": dict(tags)}
            if kind == "counter":
                entry["value"] = s.total
            elif kind == "gauge":
                entry["value"] = s.last
            else:
                entry["count"] = s.cum_count
                entry["sum"] = s.cum_sum
                cum = 0
                buckets = []
                for bound, c in zip(s.bounds or (), s.cum_counts or ()):
                    cum += c
                    buckets.append([bound, cum])
                buckets.append(["+Inf", s.cum_count])
                entry["buckets"] = buckets
            out.append(entry)
        return out

    def prune(self, now: float | None = None) -> int:
        """Drop series idle past twice the retention window (keeps the
        name directory honest for long-lived clusters)."""
        now = float(now if now is not None else time.time())
        horizon = now - 2.0 * self.retention_s
        stale = [k for k, s in self._series.items() if s.updated < horizon]
        for k in stale:
            del self._series[k]
        return len(stale)


def _bucket_percentile(bounds: Sequence[float], counts: Sequence[int],
                       total: int, q: float) -> float:
    """Percentile estimate by linear interpolation inside the target
    bucket (Prometheus histogram_quantile semantics). The overflow
    bucket clamps to its lower bound — an honest floor, since the true
    upper edge is unknown."""
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            if i >= len(bounds):  # overflow bucket
                return float(bounds[-1])
            hi = bounds[i]
            frac = (target - cum) / c
            return float(lo + (hi - lo) * frac)
        cum += c
    return float(bounds[-1])
