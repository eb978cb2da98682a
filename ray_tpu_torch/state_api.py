"""State API — programmatic cluster introspection (ref analogs:
python/ray/util/state/api.py:110 `StateApiClient`, `ray list` CLI
state_cli.py; backed directly by GCS tables)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


def _cw():
    from ray_tpu_torch.core.object_ref import get_core_worker
    from ray_tpu_torch.core.runtime import get_runtime_context

    cw = get_core_worker()
    if cw is not None:
        return cw
    return get_runtime_context().core_worker


def list_nodes() -> list[dict]:
    cw = _cw()
    nodes = cw.io.run(cw.gcs.get_all_nodes())
    view = cw.io.run(cw.gcs.get_cluster_resources())
    out = []
    for n in nodes:
        entry = {
            "node_id": n.node_id.hex(),
            "address": f"{n.address.host}:{n.address.port}",
            "alive": n.alive, "resources": dict(n.resources_total),
            "labels": dict(n.labels or {}),
        }
        v = view.get(n.node_id.hex())
        if v is not None:
            entry["alive"] = bool(v.get("alive"))
            entry["available"] = v.get("available", {})
        out.append(entry)
    return out


def list_actors(*, state: Optional[str] = None) -> list[dict]:
    cw = _cw()
    actors = cw.io.run(cw.gcs.conn.call("get_all_actors"))
    out = []
    for a in actors:
        if state is not None and a.state != state:
            continue
        out.append({
            "actor_id": a.actor_id.hex(),
            "class_name": a.class_name,
            "state": a.state,
            "name": a.name,
            "node_id": a.node_id.hex() if a.node_id else None,
            "num_restarts": a.num_restarts,
            "death_cause": a.death_cause,
            # what the actor holds while it lives (ref analog: `ray list
            # actors --detail`'s required_resources)
            "required_resources": dict(a.required_resources),
        })
    return out


def list_jobs() -> list[dict]:
    cw = _cw()
    jobs = cw.io.run(cw.gcs.conn.call("get_all_jobs"))
    return [{"job_id": job_hex, **(meta if isinstance(meta, dict) else
                                   {"meta": meta})}
            for job_hex, meta in jobs.items()]


def list_placement_groups() -> list[dict]:
    cw = _cw()
    status = cw.io.run(cw.gcs.conn.call("cluster_status"))
    return status.get("placement_groups", [])


def list_workers() -> list[dict]:
    """Per-node worker processes (pool + actor workers), collected by
    dialing each node manager."""
    from ray_tpu_torch._internal.rpc import connect

    cw = _cw()
    out: list[dict] = []
    for n in cw.io.run(cw.gcs.get_all_nodes()):
        async def fetch(n=n):
            conn = await connect(n.address.host, n.address.port)
            try:
                return await conn.call("list_workers", timeout=10)
            finally:
                await conn.close()
        try:
            workers = cw.io.run(fetch())
        except Exception:
            continue
        for w in workers:
            w["node_id"] = n.node_id.hex()
            out.append(w)
    return out


def cluster_status() -> dict:
    cw = _cw()
    return cw.io.run(cw.gcs.conn.call("cluster_status"))


def drain_node(node_id: str, deadline_s: Optional[float] = None,
               reason: str = "") -> bool:
    """Start a graceful drain of a node (hex id or unique prefix):
    stop new placement, migrate its workloads, then mark it DRAINED."""
    from ray_tpu_torch._internal.ids import NodeID

    cw = _cw()
    matches = [n.node_id for n in cw.io.run(cw.gcs.get_all_nodes())
               if n.node_id.hex().startswith(node_id)]
    if len(matches) != 1:
        raise ValueError(
            f"node id {node_id!r} matches {len(matches)} nodes")
    nid: NodeID = matches[0]
    return bool(cw.io.run(cw.gcs.conn.call(
        "drain_node", (nid, deadline_s, reason))))


def drain_status() -> dict:
    """Drain records keyed by node-id hex (state / reason / deadline /
    migrated counts), covering DRAINING, DRAINED, and drain-interrupted
    (DEAD) nodes."""
    cw = _cw()
    return cw.io.run(cw.gcs.conn.call("get_drain_status")) or {}


def placement_state() -> dict:
    """Placement-plane surface: topology map (ici-slice / dcn-locality
    -> node hexes), per-job quota ledger with live usage, gang-admission
    counters, and cumulative quota-throttle verdicts per job."""
    cw = _cw()
    return cw.io.run(cw.gcs.conn.call("placement_state")) or {}


def place_gang(demands: list[dict],
               strategy: str = "SLICE_PACK") -> Optional[list]:
    """Advisory (non-reserving) gang placement: node hex per demand, or
    None when the gang does not fit whole right now."""
    cw = _cw()
    return cw.io.run(cw.gcs.conn.call(
        "place_gang", (list(demands), strategy)))


def set_job_quota(job_id: str, weight: float, floor: float = 0.0) -> None:
    """Set (or with weight<=0, floor<=0 remove) a job's fair-share
    quota of the governed resource."""
    cw = _cw()
    cw.io.run(cw.gcs.conn.call(
        "set_job_quota", (str(job_id), float(weight), float(floor))))


def summary() -> dict:
    """`ray summary`-style rollup."""
    nodes = list_nodes()
    actors = list_actors()
    by_state: dict[str, int] = {}
    for a in actors:
        by_state[a["state"]] = by_state.get(a["state"], 0) + 1
    total: dict[str, float] = {}
    avail: dict[str, float] = {}
    for n in nodes:
        if not n["alive"]:
            continue
        for k, v in n["resources"].items():
            total[k] = total.get(k, 0.0) + v
        for k, v in n.get("available", {}).items():
            avail[k] = avail.get(k, 0.0) + v
    return {
        "nodes_alive": sum(1 for n in nodes if n["alive"]),
        "nodes_total": len(nodes),
        "actors_by_state": by_state,
        "resources_total": total,
        "resources_available": avail,
    }


def _event_filters(job_id=None, start_s=None, end_s=None, limit=None):
    filters: dict = {}
    if job_id is not None:
        filters["job_id"] = job_id
    if start_s is not None:
        filters["start_us"] = int(start_s * 1e6)
    if end_s is not None:
        filters["end_us"] = int(end_s * 1e6)
    if limit is not None:
        filters["limit"] = limit
    return filters


def task_events(*, job_id: Optional[str] = None,
                start_s: Optional[float] = None,
                end_s: Optional[float] = None,
                limit: Optional[int] = None) -> list[dict]:
    """Coalesced task lifecycle records from the GCS task manager (ref:
    gcs_task_manager.h). Filters (job / time window / limit) run
    SERVER-side — the driver never materializes the full store."""
    cw = _cw()
    return cw.io.run(cw.gcs.call(
        "get_task_events", _event_filters(job_id, start_s, end_s, limit)))


def export_timeline(path: str, *, job_id: Optional[str] = None,
                    start_s: Optional[float] = None,
                    end_s: Optional[float] = None,
                    limit: Optional[int] = None) -> int:
    """Write a Chrome trace of task lifecycles (ref: `ray timeline`):
    each task renders as an outer slice with nested per-phase slices
    (scheduling / dispatch / startup / execution)."""
    from ray_tpu_torch._internal.tracing import export_chrome_trace

    return export_chrome_trace(
        task_events(job_id=job_id, start_s=start_s, end_s=end_s,
                    limit=limit), path)


def list_tasks(*, job_id: Optional[str] = None, state: Optional[str] = None,
               name: Optional[str] = None, actor_id: Optional[str] = None,
               limit: int = 100, detail: bool = False) -> list[dict]:
    """`ray list tasks` analog: filtered task lifecycle records, newest
    first, queried server-side against the GCS task manager. Each record
    carries the per-state timestamp map, attempt number, and (for FAILED
    tasks) the truncated error payload."""
    cw = _cw()
    filters = {"limit": limit}
    if job_id is not None:
        filters["job_id"] = job_id
    if state is not None:
        filters["state"] = state
    if name is not None:
        filters["name"] = name
    if actor_id is not None:
        filters["actor_id"] = actor_id
    out = cw.io.run(cw.gcs.call("list_tasks", filters))
    return out if detail else out["tasks"]


def summarize_tasks(*, job_id: Optional[str] = None) -> dict:
    """`ray summary tasks` analog: per-task-name state counts plus the
    scheduling-delay vs execution-time latency split, with dropped-event
    accounting (store eviction per job + worker ring overflow)."""
    cw = _cw()
    filters = {"job_id": job_id} if job_id is not None else {}
    return cw.io.run(cw.gcs.call("summarize_tasks", filters))


def list_objects(*, job_id: Optional[str] = None,
                 node_id: Optional[str] = None,
                 callsite: Optional[str] = None,
                 leaked_only: bool = False, limit: int = 0,
                 detail: bool = False) -> Any:
    """`ray list objects` analog: coalesced cluster-wide object records
    from the GCS object manager (ref: gcs_object_manager.h / `ray
    memory`), filtered SERVER-side (job / node / callsite / leaked,
    limit). Each record carries size, creation callsite + timestamp,
    owner, per-node spill/pin state, the owner's ref breakdown (local /
    borrowers / task pins / escaped), per-worker zero-copy get-pins,
    and leak-watchdog flags. Reports flow on the ~1s flush cadence, so
    a just-created object can lag by a beat."""
    cw = _cw()
    filters: dict = {"limit": limit, "leaked_only": leaked_only}
    if job_id is not None:
        filters["job_id"] = job_id
    if node_id is not None:
        filters["node_id"] = node_id
    if callsite is not None:
        filters["callsite"] = callsite
    out = cw.io.run(cw.gcs.call("list_objects_state", filters))
    return out if detail else out["objects"]


def summarize_objects(*, job_id: Optional[str] = None) -> dict:
    """`ray memory` summary analog: per-callsite and per-node memory
    rollups with pinned/spilled/leaked breakdowns, per-node store stats
    (segments, zombies, fallback/arena bytes), and dropped-record
    accounting from the GCS object manager."""
    cw = _cw()
    filters = {"job_id": job_id} if job_id is not None else {}
    return cw.io.run(cw.gcs.call("summarize_objects", filters))


def list_dags(*, job_id: Optional[str] = None,
              dag_id: Optional[str] = None, stalled_only: bool = False,
              limit: int = 100, detail: bool = False) -> Any:
    """Compiled-DAG execution-plane records from the GCS dag manager,
    filtered SERVER-side (job / dag id / stalled-only, limit). Each
    record carries the edge topology (producer/consumer endpoints,
    channel kind, ring geometry), per-edge tick/byte/occupancy/
    block-time rollups, sparkline history, and the stall watchdog's
    attribution (culprit endpoint + dead peer when the blocked side's
    actor is DEAD). Reports flow on the ~1s cadence, so a just-compiled
    DAG can lag by a beat."""
    cw = _cw()
    filters: dict = {"limit": limit, "stalled_only": stalled_only}
    if job_id is not None:
        filters["job_id"] = job_id
    if dag_id is not None:
        filters["dag_id"] = dag_id
    out = cw.io.run(cw.gcs.call("list_dags", filters))
    return out if detail else out["dags"]


def summarize_dags(*, job_id: Optional[str] = None) -> dict:
    """DAG-plane rollup: counts by state, tick/byte/blocked-time
    totals, and every currently-stalled edge with its attribution."""
    cw = _cw()
    filters = {"job_id": job_id} if job_id is not None else {}
    return cw.io.run(cw.gcs.call("summarize_dags", filters))


def list_serve_requests(*, app: Optional[str] = None,
                        outcome: Optional[str] = None,
                        model_id: Optional[str] = None,
                        errors_only: bool = False,
                        min_e2e_s: Optional[float] = None,
                        slow: bool = False, limit: int = 100,
                        detail: bool = False) -> Any:
    """Per-request serve latency waterfalls from the GCS serve manager,
    filtered SERVER-side. Each record is the coalesced proxy+replica
    view of one request: the proxy's stage tiling (admission/router/
    dispatch/stream summing to e2e), the replica's queue/service split,
    and — for LLM apps — the engine phase breakdown (prefill incl.
    chunk count, TTFT, TPOT, decode-batch occupancy). Retention is
    tail-biased: errors/sheds/aborts and the slowest decile are always
    kept, the happy path samples at RAYT_SERVE_REQUEST_SAMPLE.
    ``slow=True`` orders by e2e descending. Records flow on the metrics
    cadence, so the freshest requests can lag by a beat."""
    cw = _cw()
    filters: dict = {"limit": limit, "errors_only": errors_only,
                     "slow": slow}
    if app is not None:
        filters["app"] = app
    if outcome is not None:
        filters["outcome"] = outcome
    if model_id is not None:
        filters["model_id"] = model_id
    if min_e2e_s is not None:
        filters["min_e2e_s"] = min_e2e_s
    out = cw.io.run(cw.gcs.call("list_serve_requests", filters))
    return out if detail else out["requests"]


def summarize_serve_requests(*, app: Optional[str] = None) -> dict:
    """Serve request-path rollup: per-app request/outcome counts and
    p50/p99/mean per waterfall stage plus e2e/TTFT/TPOT — the data
    behind `rayt serve status` and the dashboard Serve tab."""
    cw = _cw()
    filters = {"app": app} if app is not None else {}
    return cw.io.run(cw.gcs.call("summarize_serve_requests", filters))


def get_serve_request(request_id: str) -> Optional[dict]:
    """One retained request record by id (hex prefix accepted)."""
    cw = _cw()
    return cw.io.run(cw.gcs.call("get_serve_request", request_id))


def list_train_runs(*, experiment: Optional[str] = None,
                    state: Optional[str] = None, limit: int = 100,
                    detail: bool = False) -> Any:
    """Train-run records from the GCS train manager, filtered
    SERVER-side (experiment / state, limit). Each record carries the
    per-worker step rollups (stage totals, sparkline history of the
    last 60 step waterfalls), the stall watchdog's attributed flag,
    the latest device-memory snapshot, and the run's compile/retrace
    events. Records flow on the ~1s flush cadence, so the freshest
    steps can lag by a beat."""
    cw = _cw()
    filters: dict = {"limit": limit}
    if experiment is not None:
        filters["experiment"] = experiment
    if state is not None:
        filters["state"] = state
    out = cw.io.run(cw.gcs.call("list_train_runs", filters))
    return out if detail else out["runs"]


def summarize_train_runs(*, run_id: Optional[str] = None) -> dict:
    """Train-plane rollup: per-run step counts and p50/p99/mean for
    each waterfall stage (data_wait/h2d/step/ckpt_block tiling step
    wall), compile/retrace counts, stalled workers with attribution
    (ingest-starved / checkpoint-blocked / collective-barrier), starved
    dp ranks, and device-memory totals — the data behind
    `rayt train status` and the dashboard Train tab."""
    cw = _cw()
    filters = {"run_id": run_id} if run_id is not None else {}
    return cw.io.run(cw.gcs.call("summarize_train_runs", filters))


def get_train_run(run_id: str) -> Optional[dict]:
    """One train-run record by id (hex prefix accepted)."""
    cw = _cw()
    return cw.io.run(cw.gcs.call("get_train_run", run_id))


def list_train_steps(*, run_id: Optional[str] = None,
                     rank: Optional[int] = None, slow: bool = False,
                     min_wall_s: Optional[float] = None,
                     limit: int = 100, detail: bool = False) -> Any:
    """Retained per-step waterfall records (run / rank / min-wall
    filters run SERVER-side; ``slow=True`` orders by step wall time
    descending — the `rayt list steps --slow` view). Stages
    data_wait_s + h2d_s + step_s + ckpt_block_s tile wall_s by
    construction."""
    cw = _cw()
    filters: dict = {"limit": limit, "slow": slow}
    if run_id is not None:
        filters["run_id"] = run_id
    if rank is not None:
        filters["rank"] = rank
    if min_wall_s is not None:
        filters["min_wall_s"] = min_wall_s
    out = cw.io.run(cw.gcs.call("list_train_steps", filters))
    return out if detail else out["steps"]


def list_cluster_events(*, job_id: Optional[str] = None,
                        node_id: Optional[str] = None,
                        severity: Optional[str] = None,
                        source: Optional[str] = None,
                        kind: Optional[str] = None,
                        start_s: Optional[float] = None,
                        end_s: Optional[float] = None,
                        limit: int = 100, detail: bool = False) -> Any:
    """Cluster event log (GCS event manager; the `ray status` events /
    cluster-events analog): structured, timestamped, severity-tagged
    events from every plane — node register/heartbeat-lost/dead, worker
    start/crash/OOM-reap, actor lifecycle with cause, job start/finish,
    GCS restart, autoscaler decisions, DAG stall flag/clear, serve shed
    episodes. Filters run SERVER-side; ``severity`` is a minimum
    (``"WARNING"`` returns WARNING and ERROR), ``node_id`` matches by
    hex prefix. Newest first."""
    cw = _cw()
    filters: dict = {"limit": limit}
    for key, val in (("job_id", job_id), ("node_id", node_id),
                     ("severity", severity), ("source", source),
                     ("kind", kind), ("start_s", start_s),
                     ("end_s", end_s)):
        if val is not None:
            filters[key] = val
    out = cw.io.run(cw.gcs.call("list_cluster_events", filters))
    return out if detail else out["events"]


def summarize_scheduling() -> dict:
    """Scheduling decision-trace rollup (GCS event manager): per-demand-
    shape lease verdict counts (granted / queued / spillback /
    infeasible / cancelled) with queue-wait totals and max spillback
    hops, plus per-node pending-lease queue depth and the per-shape
    aggregate pending demand reported on each heartbeat."""
    cw = _cw()
    return cw.io.run(cw.gcs.call("summarize_scheduling"))


def why_pending(task_id: str) -> dict:
    """`rayt why-pending` backend: join the task-events record (PR 2)
    with the scheduling decision traces and the live resource view to
    say WHAT a pending task is waiting for — ``feasible_but_busy``
    (names the nodes that fit by capacity and the queue depth in front
    of the task) vs ``infeasible`` (names the short resource and the
    largest node's capacity). ``task_id`` may be a hex prefix."""
    cw = _cw()
    return cw.io.run(cw.gcs.call("why_pending", task_id))


def list_node_objects() -> list[dict]:
    """LIVE per-node object-directory dump (dials every node manager —
    the pre-aggregation surface; use list_objects for the cluster-wide
    coalesced records with ref breakdowns)."""
    from ray_tpu_torch._internal.rpc import connect

    cw = _cw()
    out = []
    for n in cw.io.run(cw.gcs.get_all_nodes()):
        if not n.alive:
            continue

        async def fetch(n=n):
            conn = await connect(n.address.host, n.address.port)
            try:
                return await conn.call("list_objects", timeout=30)
            finally:
                await conn.close()

        try:
            for entry in cw.io.run(fetch()):
                entry["node_id"] = n.node_id.hex()
                out.append(entry)
        except Exception:
            pass
    return out


def memory_summary() -> dict:
    """`rayt memory` data: live per-node directory totals (exact at call
    time) + the GCS object manager's callsite/leak rollups."""
    objs = list_node_objects()
    try:
        summary = summarize_objects()
    except Exception:
        summary = None
    return {
        "num_objects": len(objs),
        "total_bytes": sum(o["size"] for o in objs),
        "spilled_objects": sum(1 for o in objs if o["spilled"]),
        "pinned_objects": sum(1 for o in objs if o["pinned"]),
        "objects": objs,
        "summary": summary,
    }


def profile_worker(worker_id: str, *, mode: str = "cpu",
                   duration_s: float = 5.0,
                   interval_s: float = 0.01) -> dict:
    """Profile one live worker on demand (ref analog: the dashboard's
    py-spy/memray attach, profile_manager.py:373). `worker_id` is a hex
    prefix; matches actor ids too."""
    from ray_tpu_torch._internal.rpc import connect

    cw = _cw()

    async def fetch():
        for n in await cw.gcs.get_all_nodes():
            if not n.alive:
                continue
            conn = await connect(n.address.host, n.address.port)
            try:
                workers = await conn.call("list_workers", timeout=10)
            finally:
                await conn.close()
            for w in workers:
                wid = w.get("worker_id", "")
                aid = w.get("actor_id") or ""
                if not (wid.startswith(worker_id)
                        or (aid and aid.startswith(worker_id))):
                    continue
                addr = w.get("address")
                if not addr:
                    continue
                host, _, port = addr.partition(":")
                wc = await connect(host, int(port))
                try:
                    out = await wc.call(
                        "profile_worker",
                        {"mode": mode, "duration_s": duration_s,
                         "interval_s": interval_s},
                        timeout=duration_s + 30)
                finally:
                    await wc.close()
                out["worker_id"] = wid
                out["node_id"] = n.node_id.hex()
                return out
        raise ValueError(f"no live worker matches {worker_id!r}")

    return cw.io.run(fetch())


def dump_stacks() -> list[dict]:
    """Stack traces of every registered worker on every node (ref
    analog: `ray stack`, scripts.py:1934 py-spy dump — cooperative
    sys._current_frames here, no ptrace)."""
    import asyncio

    from ray_tpu_torch._internal.rpc import connect

    cw = _cw()
    out = []
    for n in cw.io.run(cw.gcs.get_all_nodes()):
        if not n.alive:
            continue

        async def fetch(n=n):
            conn = await connect(n.address.host, n.address.port)
            try:
                workers = await conn.call("list_workers", timeout=10)
            finally:
                await conn.close()
            dumps = []
            for w in workers:
                addr = w.get("address")
                if not addr:
                    continue
                host, _, port = addr.partition(":")
                try:
                    wc = await connect(host, int(port))
                    try:
                        dumps.append(await wc.call("dump_stacks",
                                                   timeout=10))
                    finally:
                        await wc.close()
                except Exception:
                    pass
            return dumps

        try:
            for d in cw.io.run(fetch()):
                d["node_id"] = n.node_id.hex()
                out.append(d)
        except Exception:
            pass
    return out
