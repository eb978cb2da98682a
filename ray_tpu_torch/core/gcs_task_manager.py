"""GCS task manager — the cluster-wide task lifecycle event store (ref
analog: src/ray/gcs/gcs_server/gcs_task_manager.h).

Workers and node managers flush per-task state-transition events
(_internal/tracing.py TaskEventBuffer) to the GCS; this module coalesces
the transitions of one task into a single record, maintains a per-job
index, enforces a global memory bound with per-job eviction (the job
hoarding the most records loses its oldest first, and every eviction is
accounted per job — ref: GcsTaskManager::GcsTaskManagerStorage job-level
circular buffers + dropped-task counters), and answers server-side
filtered queries (job / state / name / actor / time window / limit) so
`rayt list tasks`, `rayt summary tasks`, the dashboard Tasks tab and the
timeline exporter never materialize the full store in a client.
"""

from __future__ import annotations

import collections
from typing import Any, Optional

from ray_tpu_torch._internal.tracing import TASK_STATES, TERMINAL_STATES

# rank for "current state" resolution: the highest-ranked state seen wins
# (FAILED outranks FINISHED — a task whose last attempt failed is FAILED)
_STATE_RANK = {s: i for i, s in enumerate(TASK_STATES)}


class GcsTaskManager:
    def __init__(self, max_tasks: int = 10_000):
        self.max_tasks = max_tasks
        # task_id -> coalesced record; insertion-ordered (dict) so the
        # oldest record of a job is cheap to find via the job index
        self._tasks: dict[str, dict] = {}
        # job_hex -> insertion-ordered set of its task_ids
        self._by_job: dict[str, dict[str, None]] = {}
        # per-job evicted-record accounting (store-side memory cap)
        self._dropped_per_job: collections.Counter = collections.Counter()
        # transitions dropped at the SOURCE (worker ring overflow meta
        # events) — distinct from store eviction: these never arrived
        self._worker_dropped = 0
        self._num_transitions = 0

    # ------------------------------------------------------------ ingest
    def ingest(self, events: list[dict]):
        for ev in events:
            if ev.get("kind") == "meta":
                self._worker_dropped += int(ev.get("dropped", 0))
                continue
            if ev.get("type") == "transition":
                self._apply_transition(ev)

    def _apply_transition(self, ev: dict):
        task_id = ev.get("task_id") or ""
        if not task_id:
            return
        rec = self._tasks.get(task_id)
        if rec is None:
            rec = self._new_record(ev)
            self._tasks[task_id] = rec
            self._by_job.setdefault(rec["job_id"], {})[task_id] = None
            self._maybe_evict()
        state = ev.get("state")
        if state not in _STATE_RANK:
            return
        attempt = int(ev.get("attempt", 0))
        if attempt > rec["attempt"]:
            # a retry supersedes the previous attempt's VERDICT: drop its
            # terminal state + error so a task whose retry succeeds reads
            # FINISHED, not the stale attempt-0 FAILED (phase timestamps
            # merge across attempts — earliest wins — for the timeline)
            rec["attempt"] = attempt
            for s in TERMINAL_STATES:
                if rec["states"].pop(s, None) is not None:
                    self._num_transitions -= 1
            rec["error"] = None
            rec["state"] = max(rec["states"], key=_STATE_RANK.get,
                               default="")
        elif attempt < rec["attempt"] and state in TERMINAL_STATES:
            return  # late flush of a superseded attempt's verdict
        # earliest timestamp per state (flushes from different processes
        # arrive out of order; a duplicate report must not move a phase
        # boundary forward). _num_transitions counts unique stored
        # states only, so eviction's per-record subtraction stays exact.
        ts = int(ev.get("ts_us", 0))
        prev = rec["states"].get(state)
        if prev is None:
            self._num_transitions += 1
            rec["states"][state] = ts
        elif ts < prev:
            rec["states"][state] = ts
        if _STATE_RANK[state] > _STATE_RANK.get(rec["state"], -1):
            rec["state"] = state
        # execution location: ONLY the current attempt's RUNNING report
        # pins node/worker (driver-side transitions — including the
        # FAILED verdict — carry the submitter's ids, and a late flush
        # of a superseded attempt's RUNNING must not win either)
        if state == "RUNNING" and ev.get("node") \
                and attempt >= rec["attempt"]:
            rec["node"] = ev["node"]
            rec["worker"] = ev["worker"]
        if ev.get("actor_id"):
            rec["actor_id"] = ev["actor_id"]
        if ev.get("resources"):
            # demand shape (submit-side PENDING_ARGS carries it): the
            # join key `rayt why-pending` uses against decision traces
            rec["resources"] = ev["resources"]
        if ev.get("error") and not rec.get("error"):
            rec["error"] = ev["error"]

    @staticmethod
    def _new_record(ev: dict) -> dict:
        return {
            "task_id": ev.get("task_id", ""),
            "name": ev.get("name", "task"),
            "kind": ev.get("kind", "task"),
            "job_id": ev.get("job_id", ""),
            "actor_id": ev.get("actor_id", ""),
            "node": ev.get("node", ""),
            "worker": ev.get("worker", ""),
            "attempt": int(ev.get("attempt", 0)),
            "resources": ev.get("resources") or {},
            "state": "",
            "states": {},
            "error": None,
        }

    def _maybe_evict(self):
        """Per-job eviction under the global cap: the job holding the
        most records gives up its OLDEST one (per-job fairness — one
        100k-task flood job can't evict every other job's history)."""
        while len(self._tasks) > self.max_tasks:
            victim_job = max(self._by_job, key=lambda j: len(self._by_job[j]))
            job_tasks = self._by_job[victim_job]
            task_id = next(iter(job_tasks))
            del job_tasks[task_id]
            if not job_tasks:
                del self._by_job[victim_job]
            rec = self._tasks.pop(task_id, None)
            if rec is not None:
                self._num_transitions -= len(rec["states"])
            self._dropped_per_job[victim_job] += 1

    # ------------------------------------------------------------ queries
    def get(self, task_id: str) -> Optional[dict]:
        """One record by task id (hex prefix accepted, like the other
        id-taking CLI surfaces) — the `rayt why-pending` lookup."""
        rec = self._tasks.get(task_id)
        if rec is None and task_id:
            rec = next((r for tid, r in self._tasks.items()
                        if tid.startswith(task_id)), None)
        if rec is None:
            return None
        return dict(rec, states=dict(rec["states"]))

    def _iter_filtered(self, job_id=None, state=None, name=None,
                       actor_id=None, start_us=None, end_us=None):
        if job_id is not None:
            ids: Any = self._by_job.get(job_id, ())
            source = (self._tasks[t] for t in ids)
        else:
            source = iter(self._tasks.values())
        for rec in source:
            if state is not None and rec["state"] != state:
                continue
            if name is not None and rec["name"] != name:
                continue
            if actor_id is not None and rec["actor_id"] != actor_id:
                continue
            if start_us is not None or end_us is not None:
                ts = rec["states"].values()
                if not ts:
                    continue
                if start_us is not None and max(ts) < start_us:
                    continue
                if end_us is not None and min(ts) > end_us:
                    continue
            yield rec

    def list(self, *, job_id: Optional[str] = None,
             state: Optional[str] = None, name: Optional[str] = None,
             actor_id: Optional[str] = None, start_us: Optional[int] = None,
             end_us: Optional[int] = None, limit: int = 100) -> dict:
        """Filtered task records, newest-first, with truncation
        accounting (ref: GcsTaskManager::HandleGetTaskEvents limit +
        num_filtered counters)."""
        matched = list(self._iter_filtered(job_id, state, name, actor_id,
                                           start_us, end_us))
        matched.reverse()  # insertion order -> newest first
        limit = max(0, limit or 0)  # <= 0 means unlimited
        truncated = max(0, len(matched) - limit) if limit else 0
        return {
            # snapshot the mutable "states" map too: consumers serialize
            # off the GCS loop (dashboard timeline) while live records
            # keep coalescing new transitions on it
            "tasks": [dict(r, states=dict(r["states"]))
                      for r in (matched[:limit] if limit else matched)],
            "total": len(matched),
            "truncated": truncated,
            "dropped": self.dropped_counts(job_id),
        }

    def summarize(self, *, job_id: Optional[str] = None) -> dict:
        """`ray summary tasks` analog: per-task-name state counts plus
        the scheduling-delay vs execution-time latency split."""
        by_name: dict[str, dict] = {}
        total = 0
        for rec in self._iter_filtered(job_id):
            total += 1
            entry = by_name.get(rec["name"])
            if entry is None:
                entry = by_name[rec["name"]] = {
                    "kind": rec["kind"], "count": 0,
                    "states": collections.Counter(),
                    "sched_total_s": 0.0, "sched_n": 0,
                    "exec_total_s": 0.0, "exec_n": 0,
                }
            entry["count"] += 1
            entry["states"][rec["state"] or "UNKNOWN"] += 1
            st = rec["states"]
            run = st.get("RUNNING")
            submit = st.get("PENDING_ARGS")
            term = min((st[s] for s in TERMINAL_STATES if s in st),
                       default=None)
            if submit is not None and run is not None and run >= submit:
                entry["sched_total_s"] += (run - submit) / 1e6
                entry["sched_n"] += 1
            if run is not None and term is not None and term >= run:
                entry["exec_total_s"] += (term - run) / 1e6
                entry["exec_n"] += 1
        out = {}
        for nm, e in sorted(by_name.items()):
            out[nm] = {
                "kind": e["kind"], "count": e["count"],
                "states": dict(e["states"]),
                "failed": e["states"].get("FAILED", 0),
                "sched_delay_mean_s": (e["sched_total_s"] / e["sched_n"]
                                       if e["sched_n"] else None),
                "exec_time_mean_s": (e["exec_total_s"] / e["exec_n"]
                                     if e["exec_n"] else None),
                "sched_delay_total_s": e["sched_total_s"],
                "exec_time_total_s": e["exec_total_s"],
            }
        return {
            "by_name": out,
            "total_tasks": total,
            "dropped": self.dropped_counts(job_id),
            # CLUSTER-global: source-side ring overflows carry no job
            # attribution (a worker buffer is shared by every job whose
            # tasks it ran), so this count is the same under any filter
            "worker_buffer_dropped": self._worker_dropped,
        }

    def dropped_counts(self, job_id: Optional[str] = None) -> dict:
        if job_id is not None:
            return {job_id: self._dropped_per_job.get(job_id, 0)}
        return dict(self._dropped_per_job)

    def num_tasks(self) -> int:
        return len(self._tasks)

    def num_transitions(self) -> int:
        return self._num_transitions

    def records(self, **filters) -> list[dict]:
        """Filtered records for the timeline exporter (no copy per
        record beyond the top-level dict — values are shared). Unlike
        list(), the default is UNLIMITED: a timeline wants everything
        that matches the filter."""
        filters.setdefault("limit", 0)
        return self.list(**filters)["tasks"]
