"""GCS train manager — the per-step train-plane observability store
(ref analog: the Train dashboard's run/worker telemetry; same store
contract as gcs_task_manager.h: memory bound with per-key eviction +
dropped accounting, purge on job finish, server-side filtered queries).

Train workers publish batched records on the ``train_state`` channel,
keyed by the run id the TrainController minted: per-step WATERFALL
records whose stages — ``data_wait_s`` (ingest dequeue), ``h2d_s``
(device_put), ``step_s`` (block-until-ready compute), ``ckpt_block_s``
(synchronous slice of checkpoint save) — TILE the step wall time by
construction; XLA compile events (first-trace compile time per jitted
fn, retraces surfaced as WARNING cluster events with the shape delta
that caused them); and per-device memory snapshots from jax
``memory_stats()`` on the 1s flush cadence.

A stall watchdog rides the same channel: a worker blocked inside one
phase past the grace window publishes a ``phase`` heartbeat, and the
manager flags the worker stalled with an ATTRIBUTION — ``data_wait`` →
ingest-starved, ``ckpt_block`` → checkpoint-blocked, compute/h2d →
collective-barrier (in SPMD a step that won't finish is almost always
a peer stuck in a collective). Flag TRANSITIONS emit cluster events
via the injected callback, exactly like the DAG watchdog (PR 9).

Prometheus derivation happens at ingest, BEFORE any eviction, so the
``rayt_train_{step_s,data_wait_s,h2d_s,ckpt_block_s}`` histograms,
``rayt_train_compiles_total`` and ``rayt_device_memory_*`` gauges are
unskewed by retention (the GCS process has no core worker, so — like
the dag/serve managers — it builds raw records and feeds its own
metrics store via drain_metric_records()).
"""

from __future__ import annotations

import collections
import time
from typing import Optional

from ray_tpu_torch.util.builtin_metrics import (device_memory_gauge_records,
                                                train_compile_metric_records,
                                                train_step_metric_records)

# channel convention: the owning manager defines its channel name and
# gcs.py re-exports it next to its siblings (CH_DAGS, CH_SERVE, ...)
CH_TRAIN = "train_state"

# the waterfall stages that tile step wall time, in execution order —
# summarize() rolls p50/p99 for each and the CLI/dashboard render them
# as a stacked bar in this order
TRAIN_STAGES = ("data_wait_s", "h2d_s", "step_s", "ckpt_block_s")

# blocked-phase -> stall attribution (the DAG watchdog's attribution
# idea applied to the train step's phases)
STALL_ATTRIBUTION = {
    "data_wait": "ingest_starved",
    "h2d": "collective_barrier",
    "step": "collective_barrier",
    "compute": "collective_barrier",
    "ckpt_block": "checkpoint_blocked",
}

# per-worker sparkline depth (points, one per retained step report)
_HISTORY = 60
# per-run compile-event retention (compiles are rare; retraces bounded)
_COMPILES = 100


def _pct(values: list, q: float) -> Optional[float]:
    if not values:
        return None
    vs = sorted(values)
    i = min(len(vs) - 1, max(0, int(q * (len(vs) - 1) + 0.5)))
    return vs[i]


class GcsTrainManager:
    def __init__(self, max_steps: int = 5000, stall_grace_s: float = 5.0,
                 event_cb=None):
        self.max_steps = max_steps
        self.stall_grace_s = stall_grace_s
        # (kind, message, severity, job_id, data) -> cluster event; the
        # GCS wires record_event in, tests inject a list-appender
        self._event_cb = event_cb
        # run_id -> run record (workers nested by rank)
        self._runs: dict[str, dict] = {}
        # step_id ("run:rank:step") -> step record; insertion-ordered so
        # the oldest record of a run is cheap to find via the run index
        self._steps: dict[str, dict] = {}
        # run_id -> insertion-ordered set of its step ids
        self._by_run: dict[str, dict[str, None]] = {}
        # store-side eviction accounting (memory cap), per run
        self._dropped_per_run: collections.Counter = collections.Counter()
        self._metric_buf: list[dict] = []
        self._steps_total = 0
        self._stalled = 0

    # ------------------------------------------------------------ ingest
    def ingest(self, message):
        """One pubsub payload: a record dict or a batched list of them
        (worker recorders flush lists on the 1s cadence)."""
        if isinstance(message, dict):
            message = [message]
        for m in message or ():
            try:
                kind = m.get("kind")
                if kind == "step":
                    self._apply_step(m)
                elif kind == "run":
                    self._apply_run(m)
                elif kind == "compile":
                    self._apply_compile(m)
                elif kind == "memory":
                    self._apply_memory(m)
                elif kind == "phase":
                    self._apply_phase(m)
            except Exception:
                continue  # observability must not take down the GCS

    def _run(self, run_id: str, m: dict) -> dict:
        run = self._runs.get(run_id)
        if run is None:
            run = self._runs[run_id] = {
                "run_id": run_id, "experiment": "", "job_id": "",
                "world_size": 0, "state": "RUNNING",
                "started_ts": float(m.get("ts") or time.time()),
                "finished_ts": None, "workers": {},
                "compiles": [], "compile_count": 0, "retrace_count": 0,
            }
        return run

    def _worker(self, run: dict, rank: int) -> dict:
        w = run["workers"].get(rank)
        if w is None:
            w = run["workers"][rank] = {
                "rank": rank, "last_step": -1, "steps_total": 0,
                "last_ts": 0.0, "tokens_total": 0,
                "wall_total_s": 0.0, "stage_totals":
                    {k: 0.0 for k in TRAIN_STAGES},
                "history": collections.deque(maxlen=_HISTORY),
                "stall": None, "memory": None,
            }
        return w

    def _apply_run(self, m: dict):
        run = self._run(m.get("run_id") or "", m)
        for k in ("experiment", "job_id"):
            if m.get(k):
                run[k] = m[k]
        if m.get("world_size"):
            run["world_size"] = int(m["world_size"])
        state = m.get("state")
        if state:
            run["state"] = state
            if state != "RUNNING":
                run["finished_ts"] = float(m.get("ts") or time.time())
                # a finished run can't be stalled; clear without events
                for w in run["workers"].values():
                    if w["stall"] is not None:
                        w["stall"] = None
                        self._stalled -= 1

    def _apply_step(self, m: dict):
        run_id = m.get("run_id") or ""
        if not run_id:
            return
        run = self._run(run_id, m)
        rank = int(m.get("rank") or 0)
        step = int(m.get("step") or 0)
        ts = float(m.get("ts") or time.time())
        stages = {k: float((m.get("stages") or {}).get(k) or 0.0)
                  for k in TRAIN_STAGES}
        wall = float(m.get("wall_s") or 0.0)
        # Prometheus derivation from EVERY step record, before the
        # retention decision — eviction shapes the store, not the series
        self._metric_buf.extend(train_step_metric_records(
            run["experiment"] or m.get("experiment") or "",
            step_s=stages["step_s"], data_wait_s=stages["data_wait_s"],
            h2d_s=stages["h2d_s"], ckpt_block_s=stages["ckpt_block_s"],
            ts=ts))
        w = self._worker(run, rank)
        w["last_step"] = max(w["last_step"], step)
        w["steps_total"] += 1
        self._steps_total += 1
        w["last_ts"] = ts
        w["tokens_total"] += int(m.get("tokens") or 0)
        w["wall_total_s"] += wall
        for k in TRAIN_STAGES:
            w["stage_totals"][k] += stages[k]
        w["history"].append({"step": step, "ts": ts, "wall_s": wall,
                             **stages})
        # fresh progress clears any stall flag (transition -> INFO event)
        self._set_stall(run, w, None)
        rec = {"step_id": f"{run_id}:{rank}:{step}", "run_id": run_id,
               "experiment": run["experiment"], "rank": rank,
               "step": step, "ts": ts, "wall_s": wall, "stages": stages}
        for k in ("ckpt_commit_s", "tokens", "loss"):
            if m.get(k) is not None:
                rec[k] = m[k]
        self._steps[rec["step_id"]] = rec
        self._by_run.setdefault(run_id, {})[rec["step_id"]] = None
        self._maybe_evict()

    def _maybe_evict(self):
        """Per-run eviction under the global cap: the run holding the
        most step records gives up its OLDEST one (one chatty run can't
        evict every other run's history)."""
        while len(self._steps) > self.max_steps:
            victim = max(self._by_run, key=lambda r: len(self._by_run[r]))
            ids = self._by_run[victim]
            sid = next(iter(ids))
            del ids[sid]
            if not ids:
                del self._by_run[victim]
            self._steps.pop(sid, None)
            self._dropped_per_run[victim] += 1

    # -------------------------------------------- compile / memory / stall
    def _apply_compile(self, m: dict):
        run = self._run(m.get("run_id") or "", m)
        ev = {"fn": m.get("fn") or "", "event": m.get("event") or
              "compile", "rank": int(m.get("rank") or 0),
              "compile_s": float(m.get("compile_s") or 0.0),
              "shape": m.get("shape") or "",
              "prev_shape": m.get("prev_shape") or "",
              "ts": float(m.get("ts") or time.time())}
        run["compiles"].append(ev)
        del run["compiles"][:-_COMPILES]
        self._metric_buf.extend(train_compile_metric_records(
            run["experiment"] or m.get("experiment") or "",
            event=ev["event"], ts=ev["ts"]))
        if ev["event"] == "retrace":
            run["retrace_count"] += 1
            # a retrace mid-training is a perf bug (a new shape hit the
            # jit cache) — surface it loudly, with the shape delta
            self._emit(
                "train_retrace",
                f"run {run['run_id'][:8]} rank {ev['rank']}: XLA retrace"
                f" of {ev['fn']} ({ev['prev_shape']} -> {ev['shape']}, "
                f"{ev['compile_s'] * 1e3:.0f}ms)",
                "WARNING", run,
                {"run_id": run["run_id"], "fn": ev["fn"],
                 "shape": ev["shape"], "prev_shape": ev["prev_shape"]})
        else:
            run["compile_count"] += 1

    def _apply_memory(self, m: dict):
        run = self._run(m.get("run_id") or "", m)
        w = self._worker(run, int(m.get("rank") or 0))
        devices = [d for d in (m.get("devices") or ()) if isinstance(
            d, dict)]
        w["memory"] = {"node_id": m.get("node_id") or "",
                       "ts": float(m.get("ts") or time.time()),
                       "devices": devices}
        self._metric_buf.extend(device_memory_gauge_records(
            m.get("node_id") or "", devices, ts=w["memory"]["ts"]))

    def _apply_phase(self, m: dict):
        """A blocked-phase heartbeat from a worker recorder: the worker
        has been inside one phase longer than the grace window. Flag the
        worker stalled, attributed by WHICH phase is blocked."""
        run = self._run(m.get("run_id") or "", m)
        w = self._worker(run, int(m.get("rank") or 0))
        blocked = float(m.get("blocked_s") or 0.0)
        if blocked < self.stall_grace_s:
            return
        phase = m.get("phase") or ""
        self._set_stall(run, w, {
            "phase": phase,
            "attribution": STALL_ATTRIBUTION.get(phase,
                                                 "collective_barrier"),
            "blocked_s": blocked, "step": int(m.get("step") or 0),
            "since_ts": float(m.get("ts") or time.time()) - blocked,
        })

    def _set_stall(self, run: dict, w: dict, stall: Optional[dict]):
        """All stall transitions route here so the stalled count stays
        O(1) and cluster events fire only on TRANSITIONS (set, clear,
        or attribution change), never per heartbeat."""
        prev = w["stall"]
        if stall is None:
            if prev is None:
                return
            w["stall"] = None
            self._stalled -= 1
            self._emit(
                "train_stall_cleared",
                f"run {run['run_id'][:8]} rank {w['rank']}: step resumed"
                f" after {prev['blocked_s']:.1f}s "
                f"({prev['attribution']})",
                "INFO", run, {"run_id": run["run_id"],
                              "rank": w["rank"],
                              "attribution": prev["attribution"]})
            return
        if prev is not None and prev["attribution"] == \
                stall["attribution"]:
            prev.update(stall)  # same stall, longer: refresh quietly
            return
        if prev is None:
            self._stalled += 1
        w["stall"] = stall
        self._emit(
            "train_stall",
            f"run {run['run_id'][:8]} rank {w['rank']}: step "
            f"{stall['step']} blocked {stall['blocked_s']:.1f}s in "
            f"{stall['phase']} ({stall['attribution']})",
            "WARNING", run,
            {"run_id": run["run_id"], "rank": w["rank"],
             "phase": stall["phase"],
             "attribution": stall["attribution"],
             "blocked_s": stall["blocked_s"]})

    def _emit(self, kind, message, severity, run, data):
        if self._event_cb is None:
            return
        try:
            self._event_cb(kind, message, severity,
                           run.get("job_id") or "", data)
        except Exception:
            pass

    def drain_metric_records(self) -> list[dict]:
        out, self._metric_buf = self._metric_buf, []
        return out

    # -------------------------------------------------------- job purge
    def on_job_finished(self, job_hex: str):
        """Job teardown purge: the job's runs, their step records and
        dropped accounting all go — a resubmitted job starts with a
        clean ledger."""
        for run_id in [r for r, run in self._runs.items()
                       if (run.get("job_id") or "") == job_hex]:
            run = self._runs.pop(run_id)
            for w in run["workers"].values():
                if w["stall"] is not None:
                    self._stalled -= 1
            for sid in list(self._by_run.pop(run_id, ())):
                self._steps.pop(sid, None)
            self._dropped_per_run.pop(run_id, None)

    # ------------------------------------------------------------ queries
    def get(self, run_id: str) -> Optional[dict]:
        """One run by id (hex prefix accepted, like the other id-taking
        CLI surfaces)."""
        run = self._runs.get(run_id)
        if run is None and run_id:
            run = next((r for rid, r in self._runs.items()
                        if rid.startswith(run_id)), None)
        if run is None:
            return None
        return self._snap_run(run)

    def _snap_run(self, run: dict) -> dict:
        # snapshot the mutable sub-structures: consumers serialize off
        # the GCS loop while live records keep updating
        out = dict(run)
        out["compiles"] = [dict(c) for c in run["compiles"]]
        out["workers"] = {
            rank: {**{k: v for k, v in w.items()
                      if k not in ("history", "stall", "memory",
                                   "stage_totals")},
                   "stage_totals": dict(w["stage_totals"]),
                   "history": [dict(h) for h in w["history"]],
                   "stall": dict(w["stall"]) if w["stall"] else None,
                   "memory": (dict(w["memory"], devices=[
                       dict(d) for d in w["memory"]["devices"]])
                       if w["memory"] else None)}
            for rank, w in run["workers"].items()}
        out["dropped_steps"] = self._dropped_per_run.get(
            run["run_id"], 0)
        return out

    def list_runs(self, *, experiment: Optional[str] = None,
                  state: Optional[str] = None, limit: int = 100) -> dict:
        """Filtered run records, newest first, with per-worker rollups
        + sparkline history inline (the dashboard Train tab's and
        `rayt train status`'s data source)."""
        matched = [r for r in self._runs.values()
                   if (experiment is None
                       or r.get("experiment") == experiment)
                   and (state is None or r.get("state") == state)]
        matched.reverse()
        limit = max(0, limit or 0)  # <= 0 means unlimited
        truncated = max(0, len(matched) - limit) if limit else 0
        return {
            "runs": [self._snap_run(r)
                     for r in (matched[:limit] if limit else matched)],
            "total": len(matched),
            "truncated": truncated,
            "dropped": self.dropped_counts(),
            "stalled": self._stalled,
        }

    def list_steps(self, *, run_id: Optional[str] = None,
                   rank: Optional[int] = None, slow: bool = False,
                   min_wall_s: Optional[float] = None,
                   limit: int = 100) -> dict:
        """Retained step records with truncation + per-run dropped
        accounting. Newest first; ``slow=True`` orders by wall time
        descending instead (the `rayt list steps --slow` view)."""
        if run_id is not None and run_id not in self._by_run:
            run_id = next((r for r in self._by_run
                           if r.startswith(run_id)), run_id)
        if run_id is not None:
            source = (self._steps[s]
                      for s in self._by_run.get(run_id, ()))
        else:
            source = iter(self._steps.values())
        matched = [s for s in source
                   if (rank is None or s.get("rank") == rank)
                   and (min_wall_s is None
                        or float(s.get("wall_s") or 0.0) >= min_wall_s)]
        if slow:
            matched.sort(key=lambda s: float(s.get("wall_s") or 0.0),
                         reverse=True)
        else:
            matched.reverse()  # insertion order -> newest first
        limit = max(0, limit or 0)
        truncated = max(0, len(matched) - limit) if limit else 0
        return {
            "steps": [dict(s, stages=dict(s["stages"]))
                      for s in (matched[:limit] if limit else matched)],
            "total": len(matched),
            "truncated": truncated,
            "dropped": self.dropped_counts(run_id),
        }

    def summarize(self, *, run_id: Optional[str] = None) -> dict:
        """Per-run rollup: step counts, p50/p99/mean per waterfall
        stage, compile/retrace counts, stalled + starved workers, and
        device-memory totals — the `rayt train status` table."""
        runs: dict[str, dict] = {}
        for rid, ids in self._by_run.items():
            if run_id is not None and not rid.startswith(run_id):
                continue
            stages = collections.defaultdict(list)
            walls = []
            for sid in ids:
                rec = self._steps[sid]
                walls.append(float(rec.get("wall_s") or 0.0))
                for k in TRAIN_STAGES:
                    stages[k].append(rec["stages"].get(k) or 0.0)
            runs[rid] = {"stages": stages, "walls": walls}
        out = {}
        for rid, acc in sorted(runs.items()):
            run = self._runs.get(rid) or {}

            def roll(vals):
                return {"p50": _pct(vals, 0.5), "p99": _pct(vals, 0.99),
                        "mean": (sum(vals) / len(vals)) if vals
                        else None, "n": len(vals)}
            workers = run.get("workers") or {}
            starved = self.starved_workers(run)
            mem_used = mem_peak = 0
            for w in workers.values():
                for d in ((w.get("memory") or {}).get("devices") or ()):
                    mem_used += int(d.get("bytes_in_use") or 0)
                    mem_peak += int(d.get("peak_bytes") or 0)
            out[rid] = {
                "experiment": run.get("experiment") or "",
                "state": run.get("state") or "",
                "world_size": run.get("world_size") or 0,
                "steps": len(acc["walls"]),
                "last_step": max((w["last_step"]
                                  for w in workers.values()),
                                 default=-1),
                "wall": roll(acc["walls"]),
                "stages": {k: roll(acc["stages"][k])
                           for k in TRAIN_STAGES},
                "compile_count": run.get("compile_count") or 0,
                "retrace_count": run.get("retrace_count") or 0,
                "stalled_workers": {
                    rank: dict(w["stall"])
                    for rank, w in workers.items() if w.get("stall")},
                "starved_workers": starved,
                "memory_used_bytes": mem_used,
                "memory_peak_bytes": mem_peak,
                "dropped_steps": self._dropped_per_run.get(rid, 0),
            }
        return {
            "runs": out,
            "total_steps": sum(e["steps"] for e in out.values())
            if out else 0,
            "steps_total": self._steps_total,
            "stalled": self._stalled,
            "dropped": self.dropped_counts(run_id),
        }

    @staticmethod
    def starved_workers(run: dict) -> dict:
        """Ranks whose cumulative ingest wait dominates their wall time
        (> 25% of it) — the slow-shard view `rayt train status` prints
        so a starved dp rank is attributable, not a cluster-wide
        counter."""
        out = {}
        for rank, w in (run.get("workers") or {}).items():
            wall = float(w.get("wall_total_s") or 0.0)
            wait = float((w.get("stage_totals") or {})
                         .get("data_wait_s") or 0.0)
            if wall > 0 and wait / wall > 0.25:
                out[rank] = {"data_wait_s": wait, "wall_s": wall,
                             "share": wait / wall}
        return out

    def dropped_counts(self, run_id: Optional[str] = None) -> dict:
        if run_id is not None:
            return {run_id: self._dropped_per_run.get(run_id, 0)}
        return dict(self._dropped_per_run)

    def num_steps(self) -> int:
        return len(self._steps)

    def num_runs(self) -> int:
        return len(self._runs)

    def stalled_count(self) -> int:
        return self._stalled
