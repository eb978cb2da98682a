"""Task-event tracing: per-worker event buffer -> GCS task manager ->
Chrome trace export (ref analogs: src/ray/core_worker/task_event_buffer.cc,
gcs/gcs_server/gcs_task_manager.h task-event store, and the
`ray timeline` Chrome-trace exporter at scripts/scripts.py `timeline`).

Processes record per-task STATE TRANSITIONS (PENDING_ARGS -> SCHEDULED ->
DISPATCHED -> RUNNING -> FINISHED/FAILED, each timestamped, with attempt
number and a truncated error payload on failure) into a bounded local
ring; a periodic flush ships them to the GCS, whose task manager
coalesces the transitions of one task into a single record
(core/gcs_task_manager.py). `rayt timeline` renders the records as
nested Chrome trace-viewer slices — one outer slice per task lifetime,
inner slices per lifecycle phase — grouped by node (pid) and worker
(tid).
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any

# local buffer bound: ring semantics — when full the OLDEST events are
# evicted (the flush loop drains every second, so hitting it means a
# flood; the timeline must show the flood's tail, not freeze at its
# start) and the drop is accounted in a meta event
_LOCAL_CAP = 4096

# Task lifecycle states, in transition order (ref: rpc::TaskStatus).
# FAILED outranks FINISHED (a task whose retry failed is FAILED), and
# CANCELLED outranks both: rt.cancel() wins even when it races the body
# to completion (core_worker cancel semantics), and a deliberate cancel
# must not count as a failure in summaries.
TASK_STATES = ("PENDING_ARGS", "SCHEDULED", "DISPATCHED", "RUNNING",
               "FINISHED", "FAILED", "CANCELLED")
TERMINAL_STATES = ("FINISHED", "FAILED", "CANCELLED")

# error payload truncation (a 100MB traceback must not transit the
# control plane; ref: RAY_task_events_max_error_message_length)
_ERR_MSG_CAP = 500
_ERR_TB_CAP = 2000


def truncate_error(exc_type: str, message: str, tb: str = "") -> dict:
    """Bounded error payload carried on a FAILED transition."""
    return {"type": exc_type[:200], "message": (message or "")[:_ERR_MSG_CAP],
            "traceback": (tb or "")[-_ERR_TB_CAP:]}


def make_transition(*, task_id: str, name: str, kind: str, state: str,
                    job_id: str = "", actor_id: str = "", attempt: int = 0,
                    worker: str = "", node: str = "",
                    error: dict | None = None,
                    resources: dict | None = None,
                    ts: float | None = None) -> dict:
    """The one wire schema for a lifecycle transition event — every
    emitter (worker buffer, node manager, GCS-side actor-creation flow)
    builds events here so the coalescer never sees divergent shapes.
    ``resources`` (the demand shape, carried on the submit-side
    PENDING_ARGS) is the join key `rayt why-pending` uses against the
    scheduling decision traces."""
    ev = {
        "type": "transition", "task_id": task_id, "name": name,
        "kind": kind, "state": state, "job_id": job_id,
        "actor_id": actor_id, "attempt": attempt,
        "worker": worker, "node": node,
        "ts_us": int((time.time() if ts is None else ts) * 1e6),
    }
    if error is not None:
        ev["error"] = error
    if resources is not None:
        ev["resources"] = resources
    return ev


class TaskEventBuffer:
    def __init__(self, worker_hex: str, node_hex: str,
                 enabled: bool | None = None):
        self.worker = worker_hex
        self.node = node_hex
        if enabled is None:
            from ray_tpu_torch._internal.config import get_config

            enabled = get_config().task_events_enabled
        self.enabled = enabled
        self._events: collections.deque = collections.deque()
        self._dropped = 0
        self._lock = threading.Lock()

    def _append(self, ev: dict):
        with self._lock:
            self._events.append(ev)
            if len(self._events) > _LOCAL_CAP:
                # ring semantics: evict OLDEST so a flood's tail survives
                self._events.popleft()
                self._dropped += 1

    def record_transition(self, *, task_id: str, name: str, kind: str,
                          state: str, job_id: str = "", actor_id: str = "",
                          attempt: int = 0, error: dict | None = None,
                          resources: dict | None = None,
                          ts: float | None = None):
        """One lifecycle state transition (ref: TaskEventBuffer::
        RecordTaskStatusEvent). Near-free when task events are disabled —
        the hot submit path pays one attribute check. Enabled, it
        appends a COMPACT tuple; the wire dict materializes at drain
        time (the 1s flush), keeping the per-submit cost to a deque
        append (``resources`` rides as a dict REFERENCE, not a copy)."""
        if not self.enabled:
            return
        self._append(("t", task_id, name, kind, state, job_id, actor_id,
                      attempt, error, time.time() if ts is None else ts,
                      resources))

    def drain(self) -> list[dict]:
        with self._lock:
            raw = list(self._events)
            self._events.clear()
            out = [make_transition(
                task_id=e[1], name=e[2], kind=e[3], state=e[4],
                job_id=e[5], actor_id=e[6], attempt=e[7],
                worker=self.worker, node=self.node, error=e[8],
                ts=e[9], resources=e[10] if len(e) > 10 else None)
                if isinstance(e, tuple) else e
                for e in raw]
            if self._dropped:
                out.append({
                    "name": f"<dropped {self._dropped} events>",
                    "task_id": "", "kind": "meta", "worker": self.worker,
                    "node": self.node, "actor_id": "", "ok": True,
                    "dropped": self._dropped,
                    "ts_us": int(time.time() * 1e6), "dur_us": 0})
                self._dropped = 0
            return out


# ------------------------------------------------------ Chrome trace
# inner-slice labels: the phase a task is in AFTER entering state K
_PHASE_LABELS = {
    "PENDING_ARGS": "scheduling",   # waiting for a lease / placement
    "SCHEDULED": "dispatch",        # lease granted, pushing to worker
    "DISPATCHED": "startup",        # on the worker, not yet executing
    "RUNNING": "execution",
}


def _record_slices(rec: dict) -> list[dict]:
    """Render one coalesced task record as nested Chrome slices: an
    outer "X" spanning the whole lifecycle plus one inner slice per
    phase (Perfetto nests same-tid containment automatically)."""
    states: dict = rec.get("states") or {}
    order = [s for s in TASK_STATES if s in states]
    if not order:
        return []
    t0 = states[order[0]]
    t1 = max(states.values())
    pid = f"node:{(rec.get('node') or '?')[:8]}"
    tid = f"worker:{(rec.get('worker') or '?')[:8]}"
    err = rec.get("error") or {}
    args = {"task_id": rec.get("task_id", ""),
            "actor_id": rec.get("actor_id", ""),
            "job_id": rec.get("job_id", ""),
            "attempt": rec.get("attempt", 0),
            "state": rec.get("state", ""),
            "ok": rec.get("state") != "FAILED"}
    if err:
        args["error"] = f"{err.get('type', '')}: {err.get('message', '')}"
    out = [{
        "name": rec.get("name", "task"), "cat": rec.get("kind", "task"),
        "ph": "X", "ts": t0, "dur": max(1, t1 - t0),
        "pid": pid, "tid": tid, "args": args,
    }]
    if len(order) >= 3:  # enough structure for per-phase breakdown
        for a, b in zip(order, order[1:]):
            label = _PHASE_LABELS.get(a)
            if label is None:
                continue
            out.append({
                "name": f"{rec.get('name', 'task')} [{label}]",
                "cat": "phase", "ph": "X", "ts": states[a],
                "dur": max(1, states[b] - states[a]),
                "pid": pid, "tid": tid,
                "args": {"task_id": rec.get("task_id", "")},
            })
    return out


def to_chrome_trace(events: list[dict]) -> dict:
    """Chrome trace-viewer JSON (load via chrome://tracing / Perfetto).

    Accepts coalesced task records (GCS task manager, carry a "states"
    map -> nested lifecycle slices), otel spans (otel.py read_spans
    dicts, carry "start_ns" — per-tick DAG spans land here, grouped by
    pid and stitched by trace id; hot-path phases by pid and thread), and
    legacy flat duration events
    (single "X" each); meta events are skipped.
    """
    trace_events: list[dict] = []
    for ev in events:
        if "states" in ev:
            trace_events.extend(_record_slices(ev))
            continue
        if "start_ns" in ev:
            trace_events.append({
                "name": ev.get("name", "span"),
                "cat": ev.get("kind", "span"),
                "ph": "X",
                "ts": ev["start_ns"] // 1000,
                "dur": max(1, (ev.get("end_ns", ev["start_ns"])
                               - ev["start_ns"]) // 1000),
                "pid": f"pid:{ev.get('pid', '?')}",
                # phases (otel.phase) carry their thread: one row each
                "tid": (f"thread:{ev['thread']}" if "thread" in ev else
                        f"trace:{(ev.get('trace_id') or '?')[:8]}"),
                "args": {"trace_id": ev.get("trace_id", ""),
                         "span_id": ev.get("span_id", ""),
                         "parent_id": ev.get("parent_id"),
                         "ok": ev.get("status_ok", True),
                         **(ev.get("attributes") or {})},
            })
            continue
        if ev.get("kind") == "meta":
            continue
        trace_events.append({
            "name": ev["name"],
            "cat": ev.get("kind", "task"),
            "ph": "X",
            "ts": ev["ts_us"],
            "dur": max(1, ev.get("dur_us", 0)),
            "pid": f"node:{ev['node'][:8]}",
            "tid": f"worker:{ev['worker'][:8]}",
            "args": {"task_id": ev.get("task_id", ""),
                     "actor_id": ev.get("actor_id", ""),
                     "ok": ev.get("ok", True)},
        })
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def export_chrome_trace(events: list[dict], path: str) -> int:
    data = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(data, f)
    return len(data["traceEvents"])
