"""GCS object manager — the cluster-wide object-plane state store (ref
analog: src/ray/gcs/gcs_server/gcs_object_manager.h + the `ray memory`
aggregation in _private/internal_api.py).

Node managers publish object-directory deltas (size / owner / spill /
pin / creation callsite per object, plus store-level segment stats) and
workers publish reference-breakdown deltas (the owner's local refs /
borrowers / task pins / escaped counts, this process's zero-copy
get-pins, and leak-watchdog flags) over the ``object_state`` pubsub
channel; this module coalesces both streams into one record per object,
maintains per-job and per-node indexes, enforces a global memory bound
with per-job oldest-first eviction and dropped accounting (the same
contract as gcs_task_manager.py), and answers server-side filtered
queries so `rayt memory`, `rayt list objects`, the dashboard Objects tab
and `state_api.list_objects/summarize_objects` never materialize the
full store in a client.
"""

from __future__ import annotations

import collections
from typing import Optional

# pubsub channel the node-manager / worker object reports ride (defined
# here, next to its consumer; gcs.py re-exports it beside its siblings)
CH_OBJECTS = "object_state"


class GcsObjectManager:
    def __init__(self, max_objects: int = 20_000):
        self.max_objects = max_objects
        # oid_hex -> coalesced record; insertion-ordered so per-job
        # eviction finds a job's oldest record cheaply via the index
        self._objects: dict[str, dict] = {}
        # job_hex -> insertion-ordered set of its oid hexes
        self._by_job: dict[str, dict[str, None]] = {}
        # per-job evicted-record accounting (store-side memory cap)
        self._dropped_per_job: collections.Counter = collections.Counter()
        # node_hex -> latest store-level stats dict (segments, zombies,
        # fallback bytes, arena counters) — kept outside the records so
        # store health survives object churn/eviction
        self._node_stores: dict[str, dict] = {}
        # worker_hex -> node_hex (from worker reports): node death must
        # purge the dead node's workers' refs/pins/leaks too — nothing
        # will ever send their removal deltas
        self._worker_nodes: dict[str, str] = {}
        self._reports_ingested = 0

    # ------------------------------------------------------------ ingest
    def ingest(self, report: dict):
        """One published delta from a node manager (kind="node") or a
        worker (kind="worker")."""
        if not isinstance(report, dict):
            return
        self._reports_ingested += 1
        kind = report.get("kind")
        if kind == "node":
            self._ingest_node(report)
        elif kind == "worker":
            self._ingest_worker(report)
        elif kind == "worker_dead":
            # node manager reaped a worker process on a live node: its
            # refs/pins/leaks will never see removal deltas
            self.on_worker_dead(report.get("worker") or "")

    def _record(self, oid_hex: str, job_hex: str) -> dict:
        rec = self._objects.get(oid_hex)
        if rec is None:
            rec = self._objects[oid_hex] = {
                "object_id": oid_hex,
                "job_id": job_hex,
                "size": -1,
                "callsite": "",
                "created_at": 0.0,
                "owner_worker": "",
                # node_hex -> {"spilled": bool, "pinned": bool}
                "nodes": {},
                # the owner's ReferenceCounter breakdown (None until the
                # owner's first report lands — inline objects may only
                # ever have this half)
                "refs": None,
                # worker_hex -> outstanding zero-copy get-pins there
                "get_pins": {},
                # worker_hex -> seconds held past the leak grace window
                "leaked": {},
                "updated_at": 0.0,
            }
            self._by_job.setdefault(job_hex, {})[oid_hex] = None
            self._maybe_evict()
        elif job_hex and not rec["job_id"]:
            # a skeleton created by a pin/leak report (no job known yet)
            # learns its job from the first attributed report: reindex so
            # job-filtered queries and per-job eviction see it
            job_index = self._by_job.get("")
            if job_index is not None:
                job_index.pop(oid_hex, None)
                if not job_index:
                    del self._by_job[""]
            rec["job_id"] = job_hex
            self._by_job.setdefault(job_hex, {})[oid_hex] = None
        return rec

    def _ingest_node(self, report: dict):
        node = report.get("node") or ""
        ts = float(report.get("ts", 0.0))
        for oid_hex, entry in (report.get("objects") or {}).items():
            rec = self._record(oid_hex, entry.get("job", ""))
            rec["size"] = int(entry.get("size", rec["size"]))
            if entry.get("callsite") and not rec["callsite"]:
                rec["callsite"] = entry["callsite"]
            if entry.get("owner"):
                rec["owner_worker"] = entry["owner"]
            if entry.get("created_at") and not rec["created_at"]:
                rec["created_at"] = float(entry["created_at"])
            rec["nodes"][node] = {
                "spilled": bool(entry.get("spilled")),
                "pinned": bool(entry.get("pinned")),
            }
            rec["updated_at"] = ts
        for oid_hex in report.get("removed") or ():
            rec = self._objects.get(oid_hex)
            if rec is None:
                continue
            rec["nodes"].pop(node, None)
            self._maybe_drop(oid_hex, rec)
        store = report.get("store")
        if store is not None:
            store = dict(store)
            store["ts"] = ts
            self._node_stores[node] = store

    def _ingest_worker(self, report: dict):
        worker = report.get("worker") or ""
        ts = float(report.get("ts", 0.0))
        self._worker_nodes[worker] = report.get("node") or ""
        for oid_hex, entry in (report.get("refs") or {}).items():
            rec = self._record(oid_hex, entry.get("job", ""))
            rec["refs"] = {
                "local": int(entry.get("local", 0)),
                "borrowers": int(entry.get("borrowers", 0)),
                "task_pins": int(entry.get("task_pins", 0)),
                "escaped": int(entry.get("escaped", 0)),
            }
            if entry.get("size", -1) >= 0 and rec["size"] < 0:
                rec["size"] = int(entry["size"])
            if entry.get("callsite"):
                # the owner's capture wins over the node's coarser
                # "task:<name>" attribution
                rec["callsite"] = entry["callsite"]
            if entry.get("created_at") and not rec["created_at"]:
                rec["created_at"] = float(entry["created_at"])
            if not rec["owner_worker"]:
                rec["owner_worker"] = worker
            if entry.get("inline"):
                rec["inline"] = True
            rec["updated_at"] = ts
        for oid_hex in report.get("refs_removed") or ():
            rec = self._objects.get(oid_hex)
            if rec is None:
                continue
            rec["refs"] = None
            self._maybe_drop(oid_hex, rec)
        for oid_hex, n in (report.get("pins") or {}).items():
            rec = self._objects.get(oid_hex)
            if rec is None:
                # a pin on an object this store never saw (e.g. evicted):
                # make a skeleton so the pin is still visible
                rec = self._record(oid_hex, "")
            rec["get_pins"][worker] = int(n)
            rec["updated_at"] = ts
        for oid_hex in report.get("pins_removed") or ():
            rec = self._objects.get(oid_hex)
            if rec is None:
                continue
            rec["get_pins"].pop(worker, None)
            self._maybe_drop(oid_hex, rec)
        for oid_hex, held_s in (report.get("leaks") or {}).items():
            rec = self._objects.get(oid_hex) or self._record(oid_hex, "")
            rec["leaked"][worker] = float(held_s)
            rec["updated_at"] = ts
        for oid_hex in report.get("leaks_cleared") or ():
            rec = self._objects.get(oid_hex)
            if rec is None:
                continue
            rec["leaked"].pop(worker, None)
            self._maybe_drop(oid_hex, rec)

    def _maybe_drop(self, oid_hex: str, rec: dict):
        """Drop a record once nothing references it anywhere: no node
        holds a copy, the owner's refs are gone, and no pin or leak flag
        survives. This is the FREE path — distinct from eviction, so it
        does not count toward dropped accounting."""
        if rec["nodes"] or rec["refs"] is not None or rec["get_pins"] \
                or rec["leaked"]:
            return
        self._objects.pop(oid_hex, None)
        job = rec["job_id"]
        job_index = self._by_job.get(job)
        if job_index is not None:
            job_index.pop(oid_hex, None)
            if not job_index:
                del self._by_job[job]

    # ----------------------------------------------------- death cleanup
    def on_node_dead(self, node_hex: str):
        """A node died: its directory entries, store stats, and every
        report from workers that lived on it are gone for good — purge
        their attributed state so records can reach the free path
        (nothing will ever send their removal deltas; without this,
        dead nodes' objects sit in `rayt memory` until cap eviction
        charges live jobs for them)."""
        dead_workers = {w for w, n in self._worker_nodes.items()
                        if n == node_hex}
        self._purge(node_hex, dead_workers)

    def on_worker_dead(self, worker_hex: str):
        """One worker died on a still-live node (reaped by its node
        manager — e.g. the memory monitor's OOM kill, exactly the case
        the leak watchdog targets): drop its attributed state so a
        dead worker's get-pins can't hold records (and leak flags)
        forever."""
        if worker_hex:
            self._purge(None, {worker_hex})

    def _purge(self, node_hex: Optional[str], dead_workers: set):
        if node_hex is not None:
            self._node_stores.pop(node_hex, None)
        for w in dead_workers:
            self._worker_nodes.pop(w, None)
        for oid_hex, rec in list(self._objects.items()):
            if node_hex is not None:
                rec["nodes"].pop(node_hex, None)
            if rec["refs"] is not None \
                    and rec["owner_worker"] in dead_workers:
                rec["refs"] = None
            for w in dead_workers:
                rec["get_pins"].pop(w, None)
                rec["leaked"].pop(w, None)
            self._maybe_drop(oid_hex, rec)

    def on_job_finished(self, job_hex: str):
        """A job finished: its driver (the owner of its objects) is
        exiting — drop the job's records outright (regular freeing, not
        eviction, so no dropped accounting). A crashed driver on a live
        node is NOT covered here; those records age out via the cap."""
        for oid_hex in list(self._by_job.pop(job_hex, ())):
            self._objects.pop(oid_hex, None)
        self._sweep_worker_nodes()

    def _sweep_worker_nodes(self):
        """Drop _worker_nodes entries no surviving record references:
        drivers (one per job, never reaped by a node manager) and
        workers whose worker_dead publish was dropped would otherwise
        accumulate forever in a store that promises a memory bound.
        O(records); runs on job finish, when churn happens anyway."""
        live: set = set()
        for rec in self._objects.values():
            live.add(rec["owner_worker"])
            live.update(rec["get_pins"])
            live.update(rec["leaked"])
        for w in [w for w in self._worker_nodes if w not in live]:
            del self._worker_nodes[w]

    def _maybe_evict(self):
        """Per-job eviction under the global cap: the job holding the
        most records gives up its OLDEST one (same fairness contract as
        GcsTaskManager — one flood job can't evict everyone's state)."""
        while len(self._objects) > self.max_objects:
            victim_job = max(self._by_job, key=lambda j: len(self._by_job[j]))
            job_objects = self._by_job[victim_job]
            oid_hex = next(iter(job_objects))
            del job_objects[oid_hex]
            if not job_objects:
                del self._by_job[victim_job]
            self._objects.pop(oid_hex, None)
            self._dropped_per_job[victim_job] += 1

    # ------------------------------------------------------------ queries
    def _iter_filtered(self, job_id=None, node_id=None, callsite=None,
                       leaked_only=False):
        if job_id is not None:
            ids = self._by_job.get(job_id, ())
            source = (self._objects[o] for o in ids if o in self._objects)
        else:
            source = iter(self._objects.values())
        for rec in source:
            if node_id is not None and node_id not in rec["nodes"]:
                continue
            if callsite is not None and rec["callsite"] != callsite:
                continue
            if leaked_only and not rec["leaked"]:
                continue
            yield rec

    def list(self, *, job_id: Optional[str] = None,
             node_id: Optional[str] = None,
             callsite: Optional[str] = None,
             leaked_only: bool = False, limit: int = 100) -> dict:
        """Filtered object records, newest-first, with truncation +
        per-job dropped accounting (mirrors GcsTaskManager.list)."""
        matched = list(self._iter_filtered(job_id, node_id, callsite,
                                           leaked_only))
        matched.reverse()  # insertion order -> newest first
        limit = max(0, limit or 0)  # <= 0 means unlimited
        truncated = max(0, len(matched) - limit) if limit else 0
        return {
            # snapshot mutable sub-maps: consumers serialize off the GCS
            # loop while live records keep coalescing reports on it
            "objects": [dict(r, nodes={n: dict(v)
                                       for n, v in r["nodes"].items()},
                             refs=dict(r["refs"]) if r["refs"] else None,
                             get_pins=dict(r["get_pins"]),
                             leaked=dict(r["leaked"]))
                        for r in (matched[:limit] if limit else matched)],
            "total": len(matched),
            "truncated": truncated,
            "dropped": self.dropped_counts(job_id),
        }

    def summarize(self, *, job_id: Optional[str] = None) -> dict:
        """`ray memory --group-by` analog: per-callsite and per-node
        memory rollups with pinned/spilled/leaked breakdowns, plus the
        latest store-level stats per node."""
        by_callsite: dict[str, dict] = {}
        by_node: dict[str, dict] = {}
        totals = {"objects": 0, "bytes": 0, "pinned_bytes": 0,
                  "spilled_bytes": 0, "inline_bytes": 0,
                  "leaked_objects": 0, "leaked_bytes": 0,
                  "get_pinned_objects": 0}
        for rec in self._iter_filtered(job_id):
            size = max(0, rec["size"])
            pinned = any(v.get("pinned") for v in rec["nodes"].values())
            spilled = bool(rec["nodes"]) and all(
                v.get("spilled") for v in rec["nodes"].values())
            leaked = bool(rec["leaked"])
            inline = bool(rec.get("inline")) and not rec["nodes"]
            totals["objects"] += 1
            totals["bytes"] += size
            if pinned:
                totals["pinned_bytes"] += size
            if spilled:
                totals["spilled_bytes"] += size
            if inline:
                totals["inline_bytes"] += size
            if leaked:
                totals["leaked_objects"] += 1
                totals["leaked_bytes"] += size
            if rec["get_pins"]:
                totals["get_pinned_objects"] += 1
            site = rec["callsite"] or "(unknown)"
            e = by_callsite.get(site)
            if e is None:
                e = by_callsite[site] = {
                    "count": 0, "total_bytes": 0, "pinned_bytes": 0,
                    "spilled_bytes": 0, "leaked_count": 0,
                    "leaked_bytes": 0}
            e["count"] += 1
            e["total_bytes"] += size
            if pinned:
                e["pinned_bytes"] += size
            if spilled:
                e["spilled_bytes"] += size
            if leaked:
                e["leaked_count"] += 1
                e["leaked_bytes"] += size
            for node_hex, v in rec["nodes"].items():
                n = by_node.get(node_hex)
                if n is None:
                    n = by_node[node_hex] = {
                        "objects": 0, "total_bytes": 0, "pinned_bytes": 0,
                        "spilled_bytes": 0, "leaked_count": 0}
                n["objects"] += 1
                n["total_bytes"] += size
                if v.get("pinned"):
                    n["pinned_bytes"] += size
                if v.get("spilled"):
                    n["spilled_bytes"] += size
                if leaked:
                    n["leaked_count"] += 1
        for node_hex, store in self._node_stores.items():
            by_node.setdefault(node_hex, {
                "objects": 0, "total_bytes": 0, "pinned_bytes": 0,
                "spilled_bytes": 0, "leaked_count": 0,
            })["store"] = dict(store)
        return {
            "by_callsite": dict(sorted(
                by_callsite.items(),
                key=lambda kv: -kv[1]["total_bytes"])),
            "by_node": by_node,
            "totals": totals,
            "dropped": self.dropped_counts(job_id),
        }

    def dropped_counts(self, job_id: Optional[str] = None) -> dict:
        if job_id is not None:
            return {job_id: self._dropped_per_job.get(job_id, 0)}
        return dict(self._dropped_per_job)

    def num_objects(self) -> int:
        return len(self._objects)
