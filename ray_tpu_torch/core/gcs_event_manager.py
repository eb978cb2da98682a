"""GCS event manager — the cluster-wide EVENT LOG and scheduling-plane
DECISION-TRACE store (the scheduling sibling of gcs_task_manager.py /
gcs_object_manager.py / gcs_dag_manager.py; ref analogs: Ray's cluster
events / `ray status` node+demand rendering, and the raylet's
resource_demands feeding autoscaler state, arXiv:1712.05889).

Two stores, one module, because they answer the same question — *why is
work where it is* — from two directions:

* **Event log**: structured, timestamped, severity-tagged events from
  every plane (node register / heartbeat-lost / dead, worker start /
  crash / OOM-reap, actor create / restart / death with cause, job
  start/finish, GCS restart, lease spillback + infeasible verdicts,
  cluster- and serve-autoscaler decisions, DAG stall flag/clear, serve
  shed episodes), ingested from the ``cluster_events`` pubsub channel
  and from in-process GCS flows. Memory-bounded
  (``RAYT_CLUSTER_EVENTS_MAX``) with per-job oldest-first eviction +
  dropped accounting — the same contract as the task/object/DAG
  managers — and purged on job finish.

* **Scheduling decision traces**: every node manager coalesces its
  ``request_lease`` verdicts per DEMAND SHAPE (grant / spillback /
  queue / infeasible / cancelled, with reason, queue-wait time,
  spillback hop, and the candidate node views it considered) and ships
  the deltas on its heartbeat cadence together with its pending-lease
  queue depth and per-shape aggregate pending demand. This module
  merges them into cluster-wide per-shape records that feed
  ``rayt status``, ``rayt why-pending``, ``summarize_scheduling`` and
  the ``rayt_sched_*`` Prometheus family.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import Any, Optional

# pubsub channel events + sched reports ride (defined here, next to the
# consumer; gcs.py re-exports it beside its siblings)
CH_EVENTS = "cluster_events"

# severity taxonomy, rank-ordered: a severity FILTER is a minimum —
# querying WARNING returns WARNING and ERROR
SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# recent per-shape decision samples kept cluster-side (queue-wait /
# spill-hop percentiles for the envelope bench + why-pending context)
_RECENT_DECISIONS = 256
# free-text payload bound: events are telemetry, not log shipping
_MSG_CAP = 500


def severity_rank(sev: str) -> int:
    return _SEV_RANK.get(sev, _SEV_RANK["INFO"])


def shape_key(demand: dict) -> str:
    """Canonical demand-shape key: sorted ``res:amount`` pairs, so
    ``{"CPU": 1.0}`` coalesces as ``CPU:1`` everywhere (node traces,
    GCS rollups, why-pending joins)."""
    if not demand:
        return "(none)"
    return ",".join(f"{k}:{demand[k]:g}" for k in sorted(demand))


def make_event(*, source: str, kind: str, message: str,
               severity: str = "INFO", job_id: str = "",
               node_id: str = "", ts: float | None = None,
               data: dict | None = None) -> dict:
    """The one wire schema for a cluster event — every emitter (GCS
    flows, node managers, autoscalers, serve, workers) builds events
    here so the log never sees divergent shapes."""
    return {
        "type": "event",
        "source": source,
        "kind": kind,
        "severity": severity if severity in _SEV_RANK else "INFO",
        "message": (message or "")[:_MSG_CAP],
        "job_id": job_id or "",
        "node_id": node_id or "",
        "ts": time.time() if ts is None else float(ts),
        "data": dict(data or {}),
    }


def emit_cluster_event(*, source: str, kind: str, message: str,
                       severity: str = "INFO", job_id: str = "",
                       node_id: str = "", **data) -> None:
    """Fire-and-forget event publish from any process with a live core
    worker (serve controller/proxies, drivers). Never raises — events
    are telemetry and must not break the emitting plane."""
    try:
        from ray_tpu_torch._internal.config import get_config

        if not get_config().cluster_events_enabled:
            return
        from ray_tpu_torch.core.object_ref import get_core_worker

        cw = get_core_worker()
        if cw is None or cw.gcs is None:
            return
        if not node_id:
            nid = getattr(cw, "node_id", None)
            node_id = nid.hex() if nid is not None else ""
        ev = make_event(source=source, kind=kind, message=message,
                        severity=severity, job_id=job_id,
                        node_id=node_id, data=data)
        cw._spawn_from_thread(cw.gcs.publish(CH_EVENTS, [ev]))
    except Exception:
        pass


def _new_shape_record(demand: dict) -> dict:
    return {
        "demand": dict(demand or {}),
        "granted": 0, "queued": 0, "spillback": 0,
        "infeasible": 0, "cancelled": 0,
        "queue_wait_s_total": 0.0, "queue_wait_max_s": 0.0,
        "max_spill_hops": 0,
        "last_reason": "",
        "last_candidates": None,
        "last_ts": 0.0,
        # recent decision samples: dicts with ts/node/verdict/hop/
        # queue_wait_s/reason (candidates ride only last_candidates)
        "recent": collections.deque(maxlen=_RECENT_DECISIONS),
    }


class GcsEventManager:
    def __init__(self, max_events: int = 10_000):
        self.max_events = max_events
        # event id -> record; insertion-ordered so per-job eviction
        # finds a job's oldest record cheaply via the index
        self._events: dict[int, dict] = {}
        self._seq = itertools.count(1)
        # job_hex -> insertion-ordered set of its event ids ("" bucket
        # holds cluster-scoped events with no job attribution)
        self._by_job: dict[str, dict[int, None]] = {}
        self._dropped_per_job: collections.Counter = collections.Counter()
        # ---- scheduling decision traces ----
        self._shapes: dict[str, dict] = {}
        # node hex -> {"pending": n, "pending_shapes": {...}, "ts": s}
        self._node_sched: dict[str, dict] = {}
        # node hex -> {job_hex: {res: amt}} — each node's ABSOLUTE leased
        # usage by job, shipped with its sched report; the cluster-wide
        # aggregate feeds the placement plane's quota accounting
        self._node_job_usage: dict[str, dict] = {}
        # cumulative per-job quota-throttle verdicts (deltas ingested
        # from sched reports, like the shape counters)
        self._quota_throttled: collections.Counter = collections.Counter()
        self._reports_ingested = 0
        # metric records derived from sched-report deltas, drained by
        # the GCS publish handler into the metrics store (this process
        # has no core worker — same raw-record pattern as the node
        # manager / dag manager)
        self._metric_records: list[dict] = []

    # ------------------------------------------------------------ ingest
    def ingest(self, msg: Any):
        """One pubsub payload: a single event, a batch of events, or a
        node manager's coalesced scheduling report."""
        if isinstance(msg, list):
            for m in msg:
                self.ingest(m)
            return
        if not isinstance(msg, dict):
            return
        t = msg.get("type")
        if t == "event":
            self._ingest_event(msg)
        elif t == "sched_report":
            self.ingest_sched_report(msg)

    def record(self, *, source: str, kind: str, message: str,
               severity: str = "INFO", job_id: str = "",
               node_id: str = "", data: dict | None = None):
        """In-process emission shortcut for flows the GCS itself drives
        (node/actor/job lifecycle, autoscaler) — no pubsub hop."""
        self._ingest_event(make_event(
            source=source, kind=kind, message=message, severity=severity,
            job_id=job_id, node_id=node_id, data=data))

    def _ingest_event(self, ev: dict):
        eid = next(self._seq)
        rec = {
            "id": eid,
            "ts": float(ev.get("ts", 0.0)) or time.time(),
            "severity": (ev.get("severity")
                         if ev.get("severity") in _SEV_RANK else "INFO"),
            "source": str(ev.get("source", ""))[:40],
            "kind": str(ev.get("kind", ""))[:60],
            "message": str(ev.get("message", ""))[:_MSG_CAP],
            "job_id": str(ev.get("job_id", "")),
            "node_id": str(ev.get("node_id", "")),
            "data": ev.get("data") if isinstance(ev.get("data"), dict)
            else {},
        }
        self._events[eid] = rec
        self._by_job.setdefault(rec["job_id"], {})[eid] = None
        self._maybe_evict()

    def _maybe_evict(self):
        """Per-job eviction under the global cap: the job holding the
        most events gives up its OLDEST one, with per-job dropped
        accounting (same fairness contract as GcsTaskManager — one
        event-flood job can't evict every other job's history)."""
        while len(self._events) > self.max_events:
            victim_job = max(self._by_job,
                             key=lambda j: len(self._by_job[j]))
            job_events = self._by_job[victim_job]
            eid = next(iter(job_events))
            del job_events[eid]
            if not job_events:
                del self._by_job[victim_job]
            self._events.pop(eid, None)
            self._dropped_per_job[victim_job] += 1

    def on_job_finished(self, job_hex: str):
        """The finished job's events are purged (regular freeing, not
        eviction — no dropped accounting), matching the task/object/DAG
        manager purge contract."""
        for eid in self._by_job.pop(job_hex, ()):
            self._events.pop(eid, None)
        self._quota_throttled.pop(job_hex, None)
        for usage in self._node_job_usage.values():
            usage.pop(job_hex, None)

    # ------------------------------------------------------------ queries
    def _iter_filtered(self, job_id=None, node_id=None, severity=None,
                       source=None, kind=None, start_s=None, end_s=None):
        min_rank = _SEV_RANK.get(severity) if severity else None
        if job_id is not None:
            ids: Any = self._by_job.get(job_id, ())
            rows = (self._events[e] for e in ids if e in self._events)
        else:
            rows = iter(self._events.values())
        for rec in rows:
            if node_id is not None and not rec["node_id"].startswith(
                    node_id):
                continue
            if min_rank is not None and \
                    _SEV_RANK[rec["severity"]] < min_rank:
                continue
            if source is not None and rec["source"] != source:
                continue
            if kind is not None and rec["kind"] != kind:
                continue
            if start_s is not None and rec["ts"] < start_s:
                continue
            if end_s is not None and rec["ts"] > end_s:
                continue
            yield rec

    def list(self, *, job_id: Optional[str] = None,
             node_id: Optional[str] = None,
             severity: Optional[str] = None,
             source: Optional[str] = None, kind: Optional[str] = None,
             start_s: Optional[float] = None,
             end_s: Optional[float] = None, limit: int = 100) -> dict:
        """Filtered events, newest-first, with truncation + per-job
        dropped accounting. ``severity`` is a MINIMUM (``WARNING``
        matches WARNING and ERROR); ``node_id`` matches by prefix."""
        matched = list(self._iter_filtered(job_id, node_id, severity,
                                           source, kind, start_s, end_s))
        matched.reverse()  # insertion order -> newest first
        limit = max(0, limit or 0)  # <= 0 means unlimited
        truncated = max(0, len(matched) - limit) if limit else 0
        return {
            "events": [dict(r, data=dict(r["data"]))
                       for r in (matched[:limit] if limit else matched)],
            "total": len(matched),
            "truncated": truncated,
            "dropped": self.dropped_counts(job_id),
        }

    def dropped_counts(self, job_id: Optional[str] = None) -> dict:
        if job_id is not None:
            return {job_id: self._dropped_per_job.get(job_id, 0)}
        return dict(self._dropped_per_job)

    def num_events(self) -> int:
        return len(self._events)

    # --------------------------------------------- scheduling decisions
    def ingest_sched_report(self, report: dict):
        """One node manager's heartbeat-cadence report: per-shape
        decision DELTAS since its last successful publish, plus its live
        pending-lease queue state. Derives the ``rayt_sched_*`` metric
        records as a side effect (drained by the GCS publish handler)."""
        node = str(report.get("node", ""))
        ts = float(report.get("ts", 0.0)) or time.time()
        self._reports_ingested += 1
        self._node_sched[node] = {
            "pending": int(report.get("pending", 0)),
            "pending_shapes": {
                k: {"count": int(v.get("count", 0)),
                    "demand": dict(v.get("demand", {}))}
                for k, v in (report.get("pending_shapes") or {}).items()},
            "ts": ts,
        }
        if report.get("job_usage") is not None:
            usage = {str(j): {r: float(a) for r, a in (u or {}).items()}
                     for j, u in report["job_usage"].items()}
            if usage:
                self._node_job_usage[node] = usage
            else:
                self._node_job_usage.pop(node, None)
        throttled = {str(j): max(0, int(n)) for j, n in
                     (report.get("quota_throttled") or {}).items()
                     if int(n) > 0}
        for j, n in throttled.items():
            self._quota_throttled[j] += n
        d_spill = d_infeas = 0
        d_qwait = 0.0
        for sk, d in (report.get("decisions") or {}).items():
            rec = self._shapes.get(sk)
            if rec is None:
                if len(self._shapes) >= 1024:  # shape-cardinality bound
                    continue
                rec = self._shapes[sk] = _new_shape_record(
                    d.get("demand") or {})
            for c in ("granted", "queued", "spillback", "infeasible",
                      "cancelled"):
                rec[c] += max(0, int(d.get(c, 0)))
            rec["queue_wait_s_total"] += max(
                0.0, float(d.get("queue_wait_s", 0.0)))
            rec["queue_wait_max_s"] = max(
                rec["queue_wait_max_s"],
                float(d.get("queue_wait_max_s", 0.0)))
            rec["max_spill_hops"] = max(
                rec["max_spill_hops"], int(d.get("max_spill_hops", 0)))
            if d.get("last_reason"):
                rec["last_reason"] = str(d["last_reason"])[:_MSG_CAP]
            if d.get("last_candidates") is not None:
                rec["last_candidates"] = d["last_candidates"]
            rec["last_ts"] = max(rec["last_ts"], ts)
            for sample in d.get("recent") or ():
                rec["recent"].append(sample)
            d_spill += max(0, int(d.get("spillback", 0)))
            d_infeas += max(0, int(d.get("infeasible", 0)))
            d_qwait += max(0.0, float(d.get("queue_wait_s", 0.0)))
        from ray_tpu_torch.util.builtin_metrics import (quota_throttled_records,
                                                        sched_metric_records)

        self._metric_records.extend(sched_metric_records(
            node, spillbacks=d_spill, infeasible=d_infeas,
            queue_wait_s=d_qwait,
            pending=self._node_sched[node]["pending"], ts=ts))
        if throttled:
            self._metric_records.extend(
                quota_throttled_records(node, throttled, ts=ts))

    def drain_metric_records(self) -> list[dict]:
        out, self._metric_records = self._metric_records, []
        return out

    def node_sched(self, node_hex: str) -> dict:
        return self._node_sched.get(node_hex) or {
            "pending": 0, "pending_shapes": {}, "ts": 0.0}

    def drop_node(self, node_hex: str):
        """A dead node's pending-lease report will never be withdrawn
        by the node itself: purge it so `rayt status` / the autoscaler
        don't read phantom demand forever."""
        self._node_sched.pop(node_hex, None)
        self._node_job_usage.pop(node_hex, None)

    def job_usage(self) -> dict:
        """Cluster-wide leased usage by job: {job_hex: {res: amt}},
        summed over the nodes' absolute per-report ledgers. This is the
        quota plane's 'used' input (core/placement.py)."""
        out: dict[str, dict[str, float]] = {}
        for usage in self._node_job_usage.values():
            for j, res in usage.items():
                agg = out.setdefault(j, {})
                for r, amt in res.items():
                    agg[r] = agg.get(r, 0.0) + amt
        return out

    def quota_throttled_totals(self) -> dict:
        """Cumulative quota-throttle verdicts per job hex."""
        return dict(self._quota_throttled)

    def pending_demand(self) -> dict:
        """Cluster-wide aggregate pending lease demand by shape:
        shape_key -> {"count", "demand", "nodes": [hex, ...]}."""
        out: dict[str, dict] = {}
        for node, st in self._node_sched.items():
            for sk, entry in st.get("pending_shapes", {}).items():
                agg = out.setdefault(sk, {"count": 0,
                                          "demand": entry["demand"],
                                          "nodes": []})
                agg["count"] += entry["count"]
                agg["nodes"].append(node)
        return out

    def shape_stats(self, sk: str) -> Optional[dict]:
        rec = self._shapes.get(sk)
        if rec is None:
            return None
        return self._shape_view(rec)

    @staticmethod
    def _shape_view(rec: dict) -> dict:
        out = {k: v for k, v in rec.items() if k != "recent"}
        out["recent"] = [dict(s) if isinstance(s, dict) else s
                         for s in rec["recent"]]
        n_q = rec["queued"]
        out["queue_wait_mean_s"] = (
            rec["queue_wait_s_total"] / n_q if n_q else None)
        out["decisions"] = (rec["granted"] + rec["spillback"]
                            + rec["infeasible"] + rec["cancelled"])
        return out

    def summarize_scheduling(self) -> dict:
        """`rayt status` / state-API rollup: per-shape decision totals,
        per-node pending queue state, and cluster totals."""
        shapes = {sk: self._shape_view(r)
                  for sk, r in self._shapes.items()}
        totals = {"granted": 0, "queued": 0, "spillback": 0,
                  "infeasible": 0, "cancelled": 0,
                  "queue_wait_s_total": 0.0, "max_spill_hops": 0}
        for r in self._shapes.values():
            for c in ("granted", "queued", "spillback", "infeasible",
                      "cancelled"):
                totals[c] += r[c]
            totals["queue_wait_s_total"] += r["queue_wait_s_total"]
            totals["max_spill_hops"] = max(totals["max_spill_hops"],
                                           r["max_spill_hops"])
        totals["queue_wait_s_total"] = round(
            totals["queue_wait_s_total"], 4)
        return {
            "shapes": shapes,
            "nodes": {n: dict(st) for n, st in self._node_sched.items()},
            "pending_total": sum(st.get("pending", 0)
                                 for st in self._node_sched.values()),
            "totals": totals,
            "quota_throttled": dict(self._quota_throttled),
            "job_usage": self.job_usage(),
            "reports_ingested": self._reports_ingested,
        }
