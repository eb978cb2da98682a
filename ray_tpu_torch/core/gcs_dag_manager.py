"""GCS dag manager — the cluster-wide compiled-DAG state store (the
execution-plane sibling of gcs_task_manager.py / gcs_object_manager.py).

The compiled-DAG driver registers each DAG at compile time (edge
topology: producer/consumer endpoints, channel kind, ring geometry) and
every participating process — the driver and each actor loop — publishes
per-channel stat snapshots (ticks, bytes, ring occupancy, write/read
block time, slot-pin holds, gc-nudges, DCN credit window) on the
``dag_state`` pubsub channel at the report cadence. This module
coalesces them into one record per DAG with per-edge rollups, runs the
STALL WATCHDOG attribution (an edge whose consumer is parked on an
empty ring — or producer on a full one — past the grace window is
flagged; the blocked side's peer is cross-referenced against the GCS
actor table, so "runner died → ring stalled" names the dead peer), and
answers server-side filtered queries for `rayt list dags` / `rayt dag
<id>`, the dashboard DAGs tab, and state_api.list_dags — with the same
memory bound + per-job oldest-first eviction + dropped accounting
contract as its siblings.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional

# pubsub channel the driver/actor-loop dag reports ride (defined here,
# next to its consumer; gcs.py re-exports it beside its siblings)
CH_DAGS = "dag_state"

# per-edge throughput history kept for the dashboard sparklines:
# (ts, ticks, bytes, occupancy) points at the report cadence
_HISTORY_POINTS = 60


def _endpoint(raw) -> dict:
    raw = raw or {}
    return {"actor": raw.get("actor", ""),
            "label": raw.get("label", "driver")}


class GcsDagManager:
    def __init__(self, max_dags: int = 500, stall_grace_s: float = 5.0,
                 actor_state: Optional[Callable[[str], Optional[str]]] = None,
                 event_cb: Optional[Callable] = None):
        self.max_dags = max_dags
        self.stall_grace_s = stall_grace_s
        # actor hex -> lifecycle state string ("ALIVE"/"DEAD"/...), or
        # None when unknown; the GCS server wires its actor table in
        self._actor_state = actor_state or (lambda _hex: None)
        # cluster-event emitter for stall flag/clear TRANSITIONS (the
        # GCS server wires its event manager in): cb(kind, message,
        # severity, job_id, data) — called only when the flag CHANGES,
        # never per report
        self._event_cb = event_cb
        # dag_id -> record; insertion-ordered so per-job eviction finds
        # a job's oldest record cheaply via the index
        self._dags: dict[str, dict] = {}
        # job_hex -> insertion-ordered set of its dag ids
        self._by_job: dict[str, dict[str, None]] = {}
        self._dropped_per_job: collections.Counter = collections.Counter()
        # (dag_id, channel key) -> edge id, for report routing
        self._chan_edge: dict[tuple[str, str], str] = {}
        self._reports_ingested = 0
        # incrementally-maintained stall count: every stall set/clear
        # routes through _set_stall, so the per-report hot path never
        # rescans the whole store
        self._num_stalled = 0
        self._last_stalled_emitted = -1
        # metric records derived from report deltas, drained by the GCS
        # publish handler into the metrics store (this process has no
        # core worker — same raw-record pattern as the node manager)
        self._metric_records: list[dict] = []

    # ------------------------------------------------------------ ingest
    def ingest(self, report: dict):
        if not isinstance(report, dict):
            return
        self._reports_ingested += 1
        kind = report.get("kind")
        if kind == "register":
            self._ingest_register(report)
        elif kind == "report":
            self._ingest_report(report)
        elif kind == "teardown":
            self._ingest_teardown(report)

    def _ingest_register(self, report: dict):
        dag_id = report.get("dag_id") or ""
        if not dag_id:
            return
        job = report.get("job_id") or ""
        ts = float(report.get("ts", 0.0))
        edges: dict[str, dict] = {}
        for e in report.get("edges") or ():
            edge_id = e.get("edge") or f"e{len(edges)}"
            edges[edge_id] = {
                "edge": edge_id,
                "producer": _endpoint(e.get("producer")),
                "consumer": _endpoint(e.get("consumer")),
                "kind": e.get("kind", "shm"),
                # shm|dcn beneath a device edge (same as kind otherwise)
                "transport": e.get("transport", e.get("kind", "shm")),
                # the kind this edge WANTS (co-located device/shm; see
                # core/placement.py preferred_kind_summary)
                "preferred": e.get("preferred", ""),
                "channel": e.get("channel", ""),
                "n_slots": int(e.get("n_slots", 0)),
                "slot_size": int(e.get("slot_size", 0)),
                "role": e.get("role", "edge"),   # input | edge | output
                # producer-side cumulatives (device_arrays counts the
                # jax.Array leaves shipped as raw shard bytes on a
                # kind=device edge; stays 0 on host edges)
                "device_arrays": 0,
                "ticks": 0, "bytes": 0, "write_block_s": 0.0,
                # consumer-side cumulatives
                "reads": 0, "read_block_s": 0.0, "occupancy": 0,
                "pinned_slots": 0, "gc_nudges": 0, "credits": None,
                # live in-progress block durations (stall inputs)
                "write_blocked_s": 0.0, "read_blocked_s": 0.0,
                "stall": None,
                "last_report_ts": 0.0,
                "history": collections.deque(maxlen=_HISTORY_POINTS),
            }
            self._chan_edge[(dag_id, e.get("channel", ""))] = edge_id
        self._dags[dag_id] = {
            "dag_id": dag_id,
            "job_id": job,
            "driver": report.get("driver", ""),
            "state": "RUNNING",
            "created_at": ts,
            "updated_at": ts,
            "torn_down_at": 0.0,
            "channel_kinds": dict(report.get("channel_kinds") or {}),
            # recovery lineage: epoch > 0 marks a recompile-and-resume
            # ring and recovered_from names the dag_id it replaced
            "epoch": int(report.get("epoch", 0)),
            "recovered_from": report.get("recovered_from", ""),
            # placement quality at compile time: fraction of edges on
            # their preferred (co-located) channel kind
            "preferred_kind_ratio": report.get("preferred_kind_ratio"),
            "edges": edges,
        }
        self._by_job.setdefault(job, {})[dag_id] = None
        ratio = report.get("preferred_kind_ratio")
        if ratio is not None:
            from ray_tpu_torch.util.builtin_metrics import \
                dag_preferred_kind_record

            self._metric_records.append(dag_preferred_kind_record(
                dag_id, float(ratio), ts=ts))
        self._maybe_evict()

    def _ingest_report(self, report: dict):
        dag_id = report.get("dag_id") or ""
        rec = self._dags.get(dag_id)
        if rec is None:
            return  # evicted / pre-registration race: drop silently
        ts = float(report.get("ts", 0.0))
        rec["updated_at"] = max(rec["updated_at"], ts)
        for chan, entry in (report.get("channels") or {}).items():
            edge_id = self._chan_edge.get((dag_id, chan))
            edge = rec["edges"].get(edge_id) if edge_id else None
            if edge is None:
                continue
            role = entry.get("role", "")
            if role == "producer":
                d_ticks = max(0, int(entry.get("writes", 0))
                              - edge["ticks"])
                d_bytes = max(0, int(entry.get("bytes_written", 0))
                              - edge["bytes"])
                d_wblock = max(0.0, float(entry.get("write_block_s", 0.0))
                               - edge["write_block_s"])
                edge["ticks"] += d_ticks
                edge["bytes"] += d_bytes
                edge["write_block_s"] += d_wblock
                edge["write_blocked_s"] = float(
                    entry.get("write_blocked_s_now", 0.0))
                if entry.get("credits") is not None:
                    edge["credits"] = int(entry["credits"])
                if entry.get("device_arrays") is not None:
                    edge["device_arrays"] = max(
                        edge["device_arrays"],
                        int(entry["device_arrays"]))
                self._emit_edge_metrics(dag_id, edge_id, ts,
                                        ticks=d_ticks, nbytes=d_bytes,
                                        write_block_s=d_wblock)
                # one history point per producer report (the consumer's
                # report carries the SAME cumulative ticks — appending
                # on both roles would zigzag the dashboard rate series
                # between 0 and 2x and halve the window)
                edge["history"].append((ts, edge["ticks"],
                                        edge["bytes"],
                                        edge["occupancy"]))
            else:  # consumer
                d_reads = max(0, int(entry.get("reads", 0))
                              - edge["reads"])
                d_rblock = max(0.0, float(entry.get("read_block_s", 0.0))
                               - edge["read_block_s"])
                edge["reads"] += d_reads
                edge["read_block_s"] += d_rblock
                edge["read_blocked_s"] = float(
                    entry.get("read_blocked_s_now", 0.0))
                edge["occupancy"] = int(entry.get("occupancy", 0))
                edge["pinned_slots"] = int(entry.get("pinned_slots", 0))
                edge["gc_nudges"] = int(entry.get("gc_nudges", 0))
                self._emit_edge_metrics(dag_id, edge_id, ts,
                                        read_block_s=d_rblock,
                                        occupancy=edge["occupancy"])
            edge["last_report_ts"] = ts
            self._check_stall(rec, edge, ts)
        self._emit_stalled_gauge(ts)

    def _ingest_teardown(self, report: dict):
        rec = self._dags.get(report.get("dag_id") or "")
        if rec is None:
            return
        ts = float(report.get("ts", 0.0))
        rec["state"] = "TORN_DOWN"
        rec["torn_down_at"] = ts
        rec["updated_at"] = max(rec["updated_at"], ts)
        # a torn-down DAG's parked loops are expected, not stalled
        for edge in rec["edges"].values():
            self._set_stall(rec, edge, None)
            edge["write_blocked_s"] = 0.0
            edge["read_blocked_s"] = 0.0
        self._emit_stalled_gauge(ts)

    # ----------------------------------------------------- stall watchdog
    def _set_stall(self, rec: dict, edge: dict, stall):
        """Every stall set/clear routes here so _num_stalled stays an
        O(1) incrementally-maintained count — and so flag TRANSITIONS
        (not per-report re-flags) land in the cluster event log with
        the watchdog's attribution."""
        had = edge["stall"] is not None
        edge["stall"] = stall
        if stall is not None and not had:
            self._num_stalled += 1
            self._emit_event(
                "dag_stall", "WARNING", rec, edge,
                f"dag {rec['dag_id'][:12]} edge {edge['edge']} "
                f"{stall['blocked']}-blocked {stall['blocked_s']:.1f}s; "
                f"culprit {stall['culprit']}"
                + (" (peer DEAD)" if stall.get("dead_peer") else ""),
                stall)
        elif stall is None and had:
            self._num_stalled -= 1
            self._emit_event(
                "dag_stall_cleared", "INFO", rec, edge,
                f"dag {rec['dag_id'][:12]} edge {edge['edge']} "
                f"stall cleared", None)

    def _emit_event(self, kind, severity, rec, edge, message, stall):
        if self._event_cb is None:
            return
        try:
            self._event_cb(kind, message, severity, rec["job_id"],
                           {"dag_id": rec["dag_id"],
                            "edge": edge["edge"],
                            **(dict(stall) if stall else {})})
        except Exception:
            pass

    def _check_stall(self, rec: dict, edge: dict, ts: float):
        """Attribution: a consumer parked on an EMPTY ring points at the
        producer (nothing arriving); a producer parked on a FULL ring
        points at the consumer (nothing draining). The culprit peer's
        liveness comes from the GCS actor table — a DEAD peer turns an
        opaque stall into a one-line diagnosis."""
        if rec["state"] != "RUNNING":
            self._set_stall(rec, edge, None)  # straggler after teardown
            return
        blocked_kind = None
        blocked_s = 0.0
        if edge["read_blocked_s"] >= self.stall_grace_s:
            blocked_kind, blocked_s = "read", edge["read_blocked_s"]
            culprit = edge["producer"]
        elif edge["write_blocked_s"] >= self.stall_grace_s:
            blocked_kind, blocked_s = "write", edge["write_blocked_s"]
            culprit = edge["consumer"]
        else:
            self._set_stall(rec, edge, None)
            return
        peer_state = (self._actor_state(culprit["actor"])
                      if culprit["actor"] else None)
        self._set_stall(rec, edge, {
            "blocked": blocked_kind,
            "blocked_s": round(blocked_s, 3),
            "culprit": culprit["label"],
            "culprit_actor": culprit["actor"],
            "culprit_state": peer_state or "",
            "dead_peer": (culprit["actor"]
                          if peer_state == "DEAD" else ""),
            "detected_at": ts,
        })

    def num_stalled_edges(self) -> int:
        return self._num_stalled

    # ---------------------------------------------------- derived metrics
    def _emit_edge_metrics(self, dag_id: str, edge_id: str, ts: float, *,
                           ticks: int = 0, nbytes: int = 0,
                           write_block_s: float = 0.0,
                           read_block_s: float = 0.0,
                           occupancy: Optional[int] = None):
        from ray_tpu_torch.util.builtin_metrics import dag_edge_metric_records

        self._metric_records.extend(dag_edge_metric_records(
            dag_id, edge_id, ticks=ticks, nbytes=nbytes,
            write_block_s=write_block_s, read_block_s=read_block_s,
            occupancy=occupancy, ts=ts))

    def _emit_stalled_gauge(self, ts: float):
        """Gauge record on CHANGE only: reports arrive at ~1/s per
        participating process cluster-wide, and an unchanged count per
        report would flood the metrics store for nothing."""
        if self._num_stalled == self._last_stalled_emitted:
            return
        from ray_tpu_torch.util.builtin_metrics import dag_stalled_gauge_record

        self._last_stalled_emitted = self._num_stalled
        self._metric_records.append(
            dag_stalled_gauge_record(self._num_stalled, ts=ts))

    def drain_metric_records(self) -> list[dict]:
        out, self._metric_records = self._metric_records, []
        return out

    # ----------------------------------------------------- memory bound
    def _maybe_evict(self):
        """Per-job eviction under the global cap: the job holding the
        most DAG records gives up its OLDEST one (same fairness contract
        as GcsTaskManager / GcsObjectManager)."""
        evicted = False
        while len(self._dags) > self.max_dags:
            victim_job = max(self._by_job,
                             key=lambda j: len(self._by_job[j]))
            job_dags = self._by_job[victim_job]
            dag_id = next(iter(job_dags))
            del job_dags[dag_id]
            if not job_dags:
                del self._by_job[victim_job]
            self._drop(dag_id)
            self._dropped_per_job[victim_job] += 1
            evicted = True
        if evicted:
            # an evicted record may have carried stall flags; the
            # register that triggered eviction drains this record
            self._emit_stalled_gauge(time.time())

    def _drop(self, dag_id: str):
        rec = self._dags.pop(dag_id, None)
        if rec is None:
            return
        for edge in rec["edges"].values():
            self._set_stall(rec, edge, None)  # keep _num_stalled exact
            self._chan_edge.pop((dag_id, edge["channel"]), None)

    def on_job_finished(self, job_hex: str):
        """The exiting driver owned the job's DAGs: drop their records
        (regular freeing, not eviction — no dropped accounting)."""
        dropped = list(self._by_job.pop(job_hex, ()))
        for dag_id in dropped:
            self._drop(dag_id)
        if dropped:
            # a crashed driver's stall-flagged records just vanished:
            # without this the gauge would stay frozen at its last
            # nonzero value forever (the caller drains the record)
            self._emit_stalled_gauge(time.time())

    # ------------------------------------------------------------ queries
    @staticmethod
    def _edge_view(edge: dict) -> dict:
        out = {k: v for k, v in edge.items() if k != "history"}
        out["stall"] = dict(edge["stall"]) if edge["stall"] else None
        out["history"] = [list(p) for p in edge["history"]]
        return out

    def _record_view(self, rec: dict) -> dict:
        stalled = [e["edge"] for e in rec["edges"].values() if e["stall"]]
        ticks = max((e["ticks"] for e in rec["edges"].values()),
                    default=0)
        return {
            "dag_id": rec["dag_id"], "job_id": rec["job_id"],
            "driver": rec["driver"], "state": rec["state"],
            "created_at": rec["created_at"],
            "updated_at": rec["updated_at"],
            "torn_down_at": rec["torn_down_at"],
            "channel_kinds": dict(rec["channel_kinds"]),
            "epoch": rec.get("epoch", 0),
            "recovered_from": rec.get("recovered_from", ""),
            "preferred_kind_ratio": rec.get("preferred_kind_ratio"),
            "num_edges": len(rec["edges"]),
            "ticks": ticks,
            "bytes": sum(e["bytes"] for e in rec["edges"].values()),
            "stalled_edges": stalled,
            "edges": [self._edge_view(e) for e in rec["edges"].values()],
        }

    def _iter_filtered(self, job_id=None, dag_id=None, stalled_only=False):
        if dag_id is not None:
            rec = self._dags.get(dag_id)
            source = (rec,) if rec is not None else ()
        elif job_id is not None:
            ids = self._by_job.get(job_id, ())
            source = (self._dags[d] for d in ids if d in self._dags)
        else:
            source = iter(self._dags.values())
        for rec in source:
            if stalled_only and not any(e["stall"]
                                        for e in rec["edges"].values()):
                continue
            yield rec

    def list(self, *, job_id: Optional[str] = None,
             dag_id: Optional[str] = None, stalled_only: bool = False,
             limit: int = 100) -> dict:
        """Filtered DAG records, newest-first, with truncation + per-job
        dropped accounting (mirrors GcsTaskManager.list)."""
        matched = list(self._iter_filtered(job_id, dag_id, stalled_only))
        matched.reverse()  # insertion order -> newest first
        limit = max(0, limit or 0)  # <= 0 means unlimited
        truncated = max(0, len(matched) - limit) if limit else 0
        return {
            "dags": [self._record_view(r)
                     for r in (matched[:limit] if limit else matched)],
            "total": len(matched),
            "truncated": truncated,
            "dropped": self.dropped_counts(job_id),
        }

    def summarize(self, *, job_id: Optional[str] = None) -> dict:
        """Rollup for `rayt summary`-style surfaces: DAG counts by
        state, edge/tick/byte totals, blocked-time totals, and every
        currently-stalled edge with its attribution."""
        by_state: collections.Counter = collections.Counter()
        totals = {"dags": 0, "edges": 0, "ticks": 0, "bytes": 0,
                  "write_block_s": 0.0, "read_block_s": 0.0,
                  "gc_nudges": 0, "stalled_edges": 0}
        stalls: list[dict] = []
        for rec in self._iter_filtered(job_id):
            totals["dags"] += 1
            by_state[rec["state"]] += 1
            # same definition as _record_view: a DAG's tick count is
            # the max over its edges (summing would count one logical
            # tick once per pipeline stage)
            totals["ticks"] += max(
                (e["ticks"] for e in rec["edges"].values()), default=0)
            for e in rec["edges"].values():
                totals["edges"] += 1
                totals["bytes"] += e["bytes"]
                totals["write_block_s"] += e["write_block_s"]
                totals["read_block_s"] += e["read_block_s"]
                totals["gc_nudges"] += e["gc_nudges"]
                if e["stall"]:
                    totals["stalled_edges"] += 1
                    stalls.append({
                        "dag_id": rec["dag_id"], "edge": e["edge"],
                        "producer": e["producer"]["label"],
                        "consumer": e["consumer"]["label"],
                        **e["stall"]})
        totals["write_block_s"] = round(totals["write_block_s"], 3)
        totals["read_block_s"] = round(totals["read_block_s"], 3)
        return {
            "by_state": dict(by_state),
            "totals": totals,
            "stalls": stalls,
            "dropped": self.dropped_counts(job_id),
        }

    def dropped_counts(self, job_id: Optional[str] = None) -> dict:
        if job_id is not None:
            return {job_id: self._dropped_per_job.get(job_id, 0)}
        return dict(self._dropped_per_job)

    def num_dags(self) -> int:
        return len(self._dags)

    def raw(self, dag_id: str) -> Optional[dict]:
        """Internal record by exact dag id — the placement plane's
        measured-edge-bytes input (core/placement.py advise_dag); stays
        a reference, callers must not mutate."""
        return self._dags.get(dag_id)
