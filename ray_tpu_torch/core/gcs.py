"""GCS — the global control store (cluster head service).

TPU-native analog of ref src/ray/gcs/gcs_server/ (gcs_server.h:89): one
asyncio process hosting node membership, the actor directory + lifecycle
manager, job table, internal KV (also the collective-rendezvous store, like
NCCLUniqueId exchange in ref nccl_collective_group.py:29), placement
groups, and pubsub. Storage is in-memory (a Redis-backed store can be
slotted behind ``_Tables`` later, ref: gcs/store_client/).

Health checking: node managers hold a persistent RPC connection; disconnect
or missed heartbeats mark the node dead and broadcast the death (ref:
gcs_health_check_manager.h:45).
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Any

from ray_tpu_torch._internal.ids import (ActorID, JobID, NodeID, PlacementGroupID,
                                         WorkerID)
from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch._internal.rpc import Connection, RpcServer, connect
from ray_tpu_torch.core.common import (ActorInfo, ActorState, Address, NodeInfo,
                                       TaskSpec, now)
from ray_tpu_torch.util.metrics import CH_METRICS

logger = setup_logger("gcs")

# Pubsub channel names (CH_METRICS is canonical in util/metrics.py,
# CH_OBJECTS in core/gcs_object_manager.py, CH_DAGS in
# core/gcs_dag_manager.py, CH_EVENTS in core/gcs_event_manager.py —
# the owning side defines them; re-exported here next to their siblings)
from ray_tpu_torch.core.gcs_dag_manager import CH_DAGS, GcsDagManager  # noqa: E402
from ray_tpu_torch.core.gcs_event_manager import (CH_EVENTS,  # noqa: E402
                                                  GcsEventManager, shape_key)
from ray_tpu_torch.core.gcs_object_manager import (CH_OBJECTS,  # noqa: E402
                                                   GcsObjectManager)
from ray_tpu_torch.core.gcs_serve_manager import (CH_SERVE,  # noqa: E402
                                                  GcsServeManager)
from ray_tpu_torch.core.gcs_train_manager import (CH_TRAIN,  # noqa: E402
                                                  GcsTrainManager)

CH_NODE = "node_events"          # {"event": "added"|"removed", "node": NodeInfo}
CH_ACTOR = "actor_events"        # ActorInfo
CH_ERROR = "error_events"
CH_LOG = "log_events"

# crash-race dead-worker records older than this can't match any in-flight
# start_actor reply (scheduling deadline is 300s) — prune them
_DEAD_WORKER_TTL_S = 600.0


def _replay_error(payload: str) -> Exception:
    """Rebuild a dedup-cached handler error as an exception whose type NAME
    matches the original, so a replayed failure crosses the RPC boundary
    with the same "ClassName: message" rendering as the first execution."""
    name, sep, msg = payload.partition(": ")
    if sep and name.isidentifier():
        return type(name, (RuntimeError,), {})(msg)
    return RuntimeError(payload)


class GcsServer:
    def __init__(self, persist_path: str | None = None):
        from ray_tpu_torch._internal.config import get_config

        self.server = RpcServer()
        self.kv: dict[str, dict[str, bytes]] = {}
        self.nodes: dict[NodeID, NodeInfo] = {}
        self.node_conns: dict[NodeID, Connection] = {}
        self.node_resources_available: dict[NodeID, dict[str, float]] = {}
        self.node_last_heartbeat: dict[NodeID, float] = {}
        # streaming resource sync (ref analog: ray_syncer.h:83 delta
        # broadcast): every change to a node's view entry bumps the
        # version and logs the node id; consumers pull only the entries
        # changed since their last-seen version
        self.resource_version = 0
        self._resource_log: collections.deque = collections.deque(
            maxlen=4096)
        self.actors: dict[ActorID, ActorInfo] = {}
        self.actor_specs: dict[ActorID, TaskSpec] = {}
        # worker ids whose death was reported before their start_actor
        # reply landed (new-incarnation crash race); value = report time,
        # pruned after _DEAD_WORKER_TTL_S so unmatched entries can't
        # accumulate forever
        self._dead_actor_workers: dict[WorkerID, float] = {}
        self.named_actors: dict[tuple[str, str], ActorID] = {}
        # PENDING actors whose creation is already in flight on a node —
        # they are NOT autoscaler demand (placed, just booting)
        self._actors_placing: set[ActorID] = set()
        self.jobs: dict[JobID, dict] = {}
        self.placement_groups: dict[PlacementGroupID, dict] = {}
        # node drain state machine (ALIVE -> DRAINING(deadline, reason)
        # -> DRAINED | DEAD): record per draining node, snapshotted so a
        # head restart mid-drain resumes the migration (ref analog:
        # DrainNodeRequest / autoscaler v2 drain, extended with a
        # deadline-bound proactive-migration coordinator)
        self.draining: dict[NodeID, dict] = {}
        # PGs currently inside _reschedule_pg (re-entrancy guard for the
        # retry loop vs. drain/death triggered reschedules)
        self._pgs_rescheduling: set[PlacementGroupID] = set()
        # at-most-once envelope for client-retried mutations, keyed
        # per-client so one chatty client can't evict another client's
        # record before its retry lands: client_id -> (seq -> (ok,
        # payload)); each client's table is a bounded LRU, snapshotted so
        # a replay across a GCS restart still dedupes
        from collections import OrderedDict
        self._dedup_results: OrderedDict[str, OrderedDict] = OrderedDict()
        self._dedup_total = 0
        self._spread_counter = 0
        self._dedup_inflight: dict[tuple, asyncio.Future] = {}
        # task lifecycle event store: per-job indexed, memory-bounded,
        # server-side filtered queries (ref: gcs_task_manager.h)
        from ray_tpu_torch.core.gcs_task_manager import GcsTaskManager

        cfg0 = get_config()
        self.task_manager = GcsTaskManager(
            max_tasks=cfg0.task_events_max_tasks)
        self._task_events_enabled = cfg0.task_events_enabled
        # object-plane state store fed by the `object_state` pubsub
        # channel (ref: gcs_object_manager.h / `ray memory` aggregation)
        self.object_manager = GcsObjectManager(
            max_objects=cfg0.object_state_max_objects)
        # cluster event log + scheduling decision-trace store fed by
        # the `cluster_events` channel (and by in-process GCS flows:
        # node/actor/job lifecycle, autoscaler). Built BEFORE the dag
        # manager (whose stall watchdog emits events through it) and
        # before any snapshot load (which records gcs_restarted).
        self.event_manager = GcsEventManager(
            max_events=cfg0.cluster_events_max)
        self._cluster_events_enabled = cfg0.cluster_events_enabled
        # compiled-DAG execution-plane state store fed by the
        # `dag_state` channel; the stall watchdog cross-references the
        # actor table for dead-peer attribution and names stall
        # flag/clear transitions in the cluster event log
        self.dag_manager = GcsDagManager(
            max_dags=cfg0.dag_state_max_dags,
            stall_grace_s=cfg0.dag_stall_grace_s,
            actor_state=self._actor_state_by_hex,
            event_cb=self._dag_stall_event)
        # serve request-path state store fed by the `serve_state`
        # channel: coalesced per-request latency waterfalls from the
        # ingress proxies + replicas, with tail-biased retention and
        # engine-report delta metrics (core/gcs_serve_manager.py)
        self.serve_manager = GcsServeManager(
            max_requests=cfg0.serve_requests_max,
            sample=cfg0.serve_request_sample)
        # train-plane state store fed by the `train_state` channel:
        # per-run step waterfalls, compile events, device-memory
        # snapshots, and the stall watchdog whose attributed flag
        # transitions land in the cluster event log
        # (core/gcs_train_manager.py)
        self.train_manager = GcsTrainManager(
            max_steps=cfg0.train_state_max,
            stall_grace_s=cfg0.train_stall_grace_s,
            event_cb=self._train_stall_event)
        # metrics time-series store fed by the `metrics` pubsub channel
        # (ref analog: metrics_agent aggregation; serves /api/metrics/*)
        from ray_tpu_torch.core.metrics_store import MetricsStore

        cfg = get_config()
        self.metrics_store = MetricsStore(
            retention_s=cfg.metrics_retention_s,
            resolution_s=cfg.metrics_resolution_s)
        # placement plane: topology-aware global placer + ordered gang
        # admission + per-job fair-share quotas (core/placement.py),
        # wired into the live stores it scores from — the resource view,
        # the event manager's queue/usage traces (PR 11), and the dag
        # manager's measured per-edge bytes (PR 9)
        from ray_tpu_torch.core.placement import PlacementPlane

        self.placement_plane = PlacementPlane(
            views_fn=lambda: {nid.hex(): self._node_view_entry(nid)
                              for nid in self.nodes},
            pending_fn=lambda h:
                self.event_manager.node_sched(h)["pending"],
            shape_stats_fn=self.event_manager.shape_stats,
            job_usage_fn=self.event_manager.job_usage,
            active_jobs_fn=lambda: [
                j.hex() for j, m in self.jobs.items()
                if m.get("status") == "RUNNING"],
            dag_stats_fn=self.dag_manager.raw)
        # channel -> set of subscribed connections
        self.subscribers: dict[str, set[Connection]] = {}
        self.server.add_service(self)
        self._started = now()
        # --- persistence (ref analog: gcs/store_client/ — pluggable:
        # local snapshot file, or an external store server the head can
        # restart against from ANY machine: core/persistence.py) ---
        from ray_tpu_torch.core.persistence import make_backend

        self.persist_path = (persist_path if persist_path is not None
                             else get_config().gcs_persist_path) or None
        self._backend = make_backend(self.persist_path)
        self._dirty = False
        self._bg: list[asyncio.Task] = []
        if self._backend is not None:
            if hasattr(self._backend, "failure_listener"):
                # remote store unreachable past the retry budget: the
                # head keeps running but persistence is DEGRADED — put
                # that on the cluster event log, not just a logger line
                self._backend.failure_listener = (
                    lambda exc, method: self.record_event(
                        source="gcs", kind="snapshot_store_unavailable",
                        severity="WARNING",
                        message=(f"snapshot store {method} failed after "
                                 f"retries: {exc!r}; head state is NOT "
                                 "being persisted"),
                        persist_path=self.persist_path or ""))
            self._load_snapshot()

    # ------------------------------------------------------- persistence
    def mark_dirty(self):
        self._dirty = True

    # KV values above this size snapshot as content-addressed side files
    # (runtime_env packages reach 100MB; re-pickling them on every dirty
    # tick would stall the event loop)
    _BLOB_THRESHOLD = 256 * 1024

    def _externalize_blob(self, value: bytes, pending: dict) -> tuple:
        import hashlib

        digest = hashlib.sha256(value).hexdigest()
        pending[digest] = value  # written OFF-loop with the snapshot
        return ("__rayt_blob__", digest)

    def _snapshot_state(self) -> tuple[dict, dict]:
        """-> (state, pending_blobs). No backend IO happens here: with a
        REMOTE backend a blocking put from the event loop would stall
        every GCS handler (heartbeats included) for the store's RTT."""
        pending_blobs: dict[str, bytes] = {}
        kv_out: dict = {}
        for ns, table in self.kv.items():
            out_table = {}
            for key, value in table.items():
                if isinstance(value, (bytes, bytearray)) and \
                        len(value) > self._BLOB_THRESHOLD:
                    out_table[key] = self._externalize_blob(
                        bytes(value), pending_blobs)
                else:
                    out_table[key] = value
            kv_out[ns] = out_table
        return ({
            "kv": kv_out,
            "nodes": self.nodes,
            "node_last_heartbeat": self.node_last_heartbeat,
            "actors": self.actors,
            "actor_specs": self.actor_specs,
            "named_actors": self.named_actors,
            "jobs": self.jobs,
            "placement_groups": self.placement_groups,
            "draining": self.draining,
            "quotas": self.placement_plane.quotas.snapshot(),
            "dedup_results": {c: dict(t)
                              for c, t in self._dedup_results.items()},
        }, pending_blobs)

    def _write_snapshot(self):
        """Synchronous snapshot (tests / non-loop callers). Runtime
        paths (_flush_loop, stop) pickle on the loop and write via
        run_in_executor instead — a blocking put from the event loop
        would stall every handler for a remote store's RTT."""
        import pickle

        state, blobs = self._snapshot_state()
        self._write_snapshot_bytes(pickle.dumps(state, protocol=4), blobs)

    def _write_snapshot_bytes(self, data: bytes, blobs: dict):
        for digest, value in blobs.items():
            self._backend.put_if_absent("blobs/" + digest, value)
        self._backend.put("snapshot", data)

    def _load_snapshot(self):
        import pickle

        try:
            data = self._backend.get("snapshot")
            if data is None:
                return
            state = pickle.loads(data)
        except Exception:
            logger.exception("GCS snapshot load failed; starting empty")
            return
        kv: dict = {}
        for ns, table in state.get("kv", {}).items():
            out = {}
            for key, value in table.items():
                if isinstance(value, tuple) and len(value) == 2 and \
                        value[0] == "__rayt_blob__":
                    blob = self._backend.get("blobs/" + value[1])
                    if blob is None:
                        logger.warning("missing snapshot blob for %s/%s",
                                       ns, key)
                    else:
                        out[key] = blob
                else:
                    out[key] = value
            kv[ns] = out
        self.kv = kv
        self.nodes = state.get("nodes", {})
        self.actors = state.get("actors", {})
        self.actor_specs = state.get("actor_specs", {})
        self.named_actors = state.get("named_actors", {})
        self.jobs = state.get("jobs", {})
        self.placement_groups = state.get("placement_groups", {})
        self.draining = state.get("draining", {})
        self.placement_plane.quotas.restore(state.get("quotas", {}))
        from collections import OrderedDict
        saved = state.get("dedup_results", {})
        self._dedup_results = OrderedDict()
        for c, t in saved.items():
            if isinstance(t, dict):
                self._dedup_results[c] = OrderedDict(t)
            else:  # pre-r4 flat snapshot: req_id -> outcome
                self._dedup_results.setdefault(
                    "_legacy", OrderedDict())[c] = t
        self._dedup_total = sum(
            len(t) for t in self._dedup_results.values())
        # nodes must re-register (their conns died with the old process);
        # give them a heartbeat grace window before declaring them dead
        for nid in self.nodes:
            self.node_last_heartbeat[nid] = now()
            # seed the delta log so a since=0 consumer's pull covers the
            # restored nodes — otherwise the delta path would silently
            # omit every node that hasn't re-registered yet
            self._mark_resource_change(nid)
        logger.info("GCS snapshot loaded: %d nodes, %d actors, %d jobs",
                    len(self.nodes), len(self.actors), len(self.jobs))
        self.record_event(
            source="gcs", kind="gcs_restarted", severity="WARNING",
            message=(f"GCS restarted from snapshot: {len(self.nodes)} "
                     f"nodes, {len(self.actors)} actors, "
                     f"{len(self.jobs)} jobs await re-registration"),
            nodes=len(self.nodes), actors=len(self.actors),
            jobs=len(self.jobs))

    async def _flush_off_loop(self):
        """Pickle on the loop thread (consistent table view — handlers
        mutate these dicts on this loop), write off-loop (a blocking put
        from the loop would stall every handler for a remote store's
        RTT). Shared by the periodic flush and the shutdown flush."""
        import pickle

        state, blobs = self._snapshot_state()
        data = pickle.dumps(state, protocol=4)
        await asyncio.get_running_loop().run_in_executor(
            None, self._write_snapshot_bytes, data, blobs)

    async def _flush_loop(self):
        while True:
            await asyncio.sleep(0.1)
            if self._dirty:
                self._dirty = False
                try:
                    await self._flush_off_loop()
                except Exception:
                    self._dirty = True  # don't lose the mutation
                    logger.exception("GCS snapshot write failed")

    async def _node_timeout_loop(self):
        """Death detection by heartbeat staleness — needed after a head
        restart, when the connection-close signal no longer exists (ref:
        gcs_health_check_manager.h:45)."""
        from ray_tpu_torch._internal.config import get_config

        timeout = get_config().node_death_timeout_s
        while True:
            await asyncio.sleep(1.0)
            t = now()
            for nid, info in list(self.nodes.items()):
                if info.alive and nid not in self.node_conns and \
                        t - self.node_last_heartbeat.get(nid, t) > timeout:
                    await self._on_node_lost(
                        nid, cause=f"heartbeat lost for >{timeout:g}s")

    async def _metrics_prune_loop(self):
        """Drop metric series idle past 2x retention so the name
        directory (and per-query scans) stay bounded on long-lived
        clusters with churning tag sets (finished train experiments)."""
        while True:
            await asyncio.sleep(60.0)
            try:
                self.metrics_store.prune()
            except Exception:
                pass

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        port = await self.server.start(host, port)
        self._bg.append(asyncio.ensure_future(self._metrics_prune_loop()))
        self._bg.append(asyncio.ensure_future(self._heartbeat_gap_loop()))
        self._bg.append(asyncio.ensure_future(self._pg_reschedule_loop()))
        if self._backend is not None:
            self._bg.append(asyncio.ensure_future(self._flush_loop()))
            self._bg.append(asyncio.ensure_future(self._node_timeout_loop()))
            # actors restored mid-placement must resume scheduling — their
            # pre-crash _schedule_actor coroutine died with the old process
            for aid, info in self.actors.items():
                if info.state in (ActorState.PENDING, ActorState.RESTARTING) \
                        and aid in self.actor_specs:
                    asyncio.ensure_future(self._schedule_actor(aid))
            # drains restored mid-flight resume their migration the same
            # way — the pre-crash coordinator died with the old process
            for nid, rec in self.draining.items():
                if rec.get("state") == "DRAINING":
                    asyncio.ensure_future(self._drain_coordinator(nid))
        logger.info("GCS listening on %s:%s", host, port)
        return port

    async def stop(self):
        for t in self._bg:
            t.cancel()
        if self._backend is not None and self._dirty:
            try:
                await self._flush_off_loop()
            except Exception:
                pass
        if self._backend is not None:
            self._backend.close()
        await self.server.stop()

    # ------------------------------------------------------ cluster events
    def record_event(self, *, source: str, kind: str, message: str,
                     severity: str = "INFO", job_id: str = "",
                     node_id: str = "", **data):
        """In-process cluster-event emission for flows the GCS itself
        drives (node/actor/job lifecycle, autoscaler decisions, DAG
        stalls). Never raises — events are telemetry."""
        if not self._cluster_events_enabled:
            return
        try:
            self.event_manager.record(
                source=source, kind=kind, message=message,
                severity=severity, job_id=job_id, node_id=node_id,
                data=data)
        except Exception:
            pass

    def _dag_stall_event(self, kind: str, message: str, severity: str,
                         job_id: str, data: dict):
        self.record_event(source="dag", kind=kind, message=message,
                          severity=severity, job_id=job_id, **data)

    def _train_stall_event(self, kind: str, message: str, severity: str,
                           job_id: str, data: dict):
        self.record_event(source="train", kind=kind, message=message,
                          severity=severity, job_id=job_id, **data)

    async def _heartbeat_gap_loop(self):
        """Per-node heartbeat-gap gauges (rayt_node_heartbeat_gap_s):
        the staleness signal `rayt status` + the Cluster tab sparklines
        render. Covers DEAD nodes too — a lost node's gap keeps growing
        instead of freezing at its last report."""
        from ray_tpu_torch.util.builtin_metrics import heartbeat_gap_records

        while True:
            await asyncio.sleep(2.0)
            try:
                t = now()
                gaps = {nid.hex(): round(
                    t - self.node_last_heartbeat.get(nid, t), 3)
                    for nid in self.nodes}
                recs = heartbeat_gap_records(gaps, ts=time.time())
                if recs:
                    self.metrics_store.ingest_many(recs)
            except Exception:
                pass

    # ------------------------------------------------------------- pubsub
    async def publish(self, channel: str, message: Any):
        if channel == CH_ACTOR:
            self.mark_dirty()  # every actor event is a table mutation
        if channel == CH_METRICS:
            # batched publishes (util/metrics.py flusher) arrive as lists
            if isinstance(message, list):
                self.metrics_store.ingest_many(message)
            else:
                self.metrics_store.ingest(message)
        elif channel == CH_OBJECTS:
            self.object_manager.ingest(message)
        elif channel == CH_EVENTS:
            self.event_manager.ingest(message)
            # sched-report deltas derive the rayt_sched_* family
            recs = self.event_manager.drain_metric_records()
            if recs:
                self.metrics_store.ingest_many(recs)
        elif channel == CH_DAGS:
            self.dag_manager.ingest(message)
            # report deltas derive the rayt_dag_* Prometheus family
            recs = self.dag_manager.drain_metric_records()
            if recs:
                self.metrics_store.ingest_many(recs)
        elif channel == CH_SERVE:
            self.serve_manager.ingest(message)
            # finalized records + engine-report deltas derive the
            # rayt_serve_{ttft,tpot,queue_wait,prefill,engine_*} family
            recs = self.serve_manager.drain_metric_records()
            if recs:
                self.metrics_store.ingest_many(recs)
        elif channel == CH_TRAIN:
            self.train_manager.ingest(message)
            # every step record derives the rayt_train_* histograms +
            # compile counter + device-memory gauges, before eviction
            recs = self.train_manager.drain_metric_records()
            if recs:
                self.metrics_store.ingest_many(recs)
        dead = []
        # snapshot: the notify below awaits, and a concurrent subscribe /
        # connection-close discard mutating the live set mid-iteration
        # raises "Set changed size during iteration"
        for conn in list(self.subscribers.get(channel, ())):
            if conn.closed:
                dead.append(conn)
                continue
            try:
                await conn.notify("pubsub:" + channel, message)
            except Exception:
                dead.append(conn)
        for conn in dead:
            self.subscribers.get(channel, set()).discard(conn)

    def rpc_subscribe(self, conn: Connection, channel: str):
        self.subscribers.setdefault(channel, set()).add(conn)
        conn.on_close.append(
            lambda c: self.subscribers.get(channel, set()).discard(c))
        return True

    async def rpc_publish(self, conn: Connection, arg):
        channel, message = arg
        await self.publish(channel, message)
        return True

    # --------------------------------------------------------- dedup envelope
    _DEDUP_CAP_PER_CLIENT = 512   # records per client (retry window is short)
    _DEDUP_CAP_LEGACY = 4096      # shared bucket for bare-uuid req_ids
    _DEDUP_CLIENT_CAP = 4096      # distinct clients tracked (LRU)
    _DEDUP_TOTAL_CAP = 16384      # global record budget: bounds what every
    # snapshot flush deep-copies + re-pickles on the event-loop thread

    @staticmethod
    def _dedup_key(req_id):
        # new clients send (client_id, seq); legacy sends a bare uuid str
        if isinstance(req_id, (tuple, list)) and len(req_id) == 2:
            return req_id[0], req_id[1]
        return "_legacy", req_id

    async def rpc_dedup_call(self, conn: Connection, arg):
        """At-most-once execution for client-retried mutations.

        GcsClient retries once after ConnectionLost, but the drop can
        happen *after* the handler executed (and the 100ms snapshot flush
        preserves that execution across a GCS restart). The client sends
        non-idempotent mutations through this envelope with a stable
        (client_id, seq) req_id; a replay returns the first execution's
        cached outcome instead of running the handler twice (ref analog:
        gRPC server-side idempotency for GCS mutations, ADVICE r2 #2).
        Records are kept per client so sustained mutation traffic from
        other clients cannot evict a record before its owner's retry lands
        (ADVICE r3 #3).
        """
        req_id, method, inner = arg
        client_id, seq = self._dedup_key(req_id)
        table = self._dedup_results.get(client_id)
        cached = table.get(seq) if table is not None else None
        if cached is not None:
            table.move_to_end(seq)
            self._dedup_results.move_to_end(client_id)
            ok, payload = cached
            if ok:
                return payload
            raise _replay_error(payload)
        inflight = self._dedup_inflight.get((client_id, seq))
        if inflight is not None:
            # replay raced the still-running first execution
            return await asyncio.shield(inflight)
        handler = self.server.handlers.get(method)
        if handler is None:
            raise RuntimeError(f"dedup_call: no handler {method!r}")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._dedup_inflight[(client_id, seq)] = fut
        try:
            result = handler(conn, inner)
            if asyncio.iscoroutine(result):
                result = await result
        except Exception as e:
            self._record_dedup(client_id, seq,
                               (False, f"{type(e).__name__}: {e}"))
            if not fut.done():
                fut.set_exception(e)
            fut.exception()  # mark retrieved: no un-awaited error warnings
            raise
        else:
            self._record_dedup(client_id, seq, (True, result))
            if not fut.done():
                fut.set_result(result)
            return result
        finally:
            self._dedup_inflight.pop((client_id, seq), None)

    def _record_dedup(self, client_id: str, seq, outcome: tuple):
        # No mark_dirty here: a mutation that changed the tables already
        # set the dirty flag, so its dedup record rides the same snapshot
        # flush; records for no-op handlers aren't worth a full re-pickle.
        from collections import OrderedDict
        table = self._dedup_results.get(client_id)
        if table is None:
            table = self._dedup_results[client_id] = OrderedDict()
        self._dedup_results.move_to_end(client_id)
        if seq not in table:
            self._dedup_total += 1
        table[seq] = outcome
        # the shared legacy bucket (bare-uuid req_ids / pre-r4 snapshot
        # replays) keeps the old server-wide cap so mixed-version traffic
        # doesn't shrink its dedup window 8x
        cap = self._DEDUP_CAP_LEGACY if client_id == "_legacy" \
            else self._DEDUP_CAP_PER_CLIENT
        while len(table) > cap:
            table.popitem(last=False)
            self._dedup_total -= 1
        while len(self._dedup_results) > self._DEDUP_CLIENT_CAP:
            _, dropped = self._dedup_results.popitem(last=False)
            self._dedup_total -= len(dropped)
        # global budget: evict whole idle clients (oldest first) so the
        # 100ms snapshot flush never re-pickles an unbounded record pile
        while self._dedup_total > self._DEDUP_TOTAL_CAP and \
                len(self._dedup_results) > 1:
            _, dropped = self._dedup_results.popitem(last=False)
            self._dedup_total -= len(dropped)

    # ----------------------------------------------------------------- KV
    def rpc_kv_put(self, conn, arg):
        ns, key, value, overwrite = arg
        table = self.kv.setdefault(ns, {})
        if not overwrite and key in table:
            return False
        table[key] = value
        self.mark_dirty()
        return True

    def rpc_kv_get(self, conn, arg):
        ns, key = arg
        return self.kv.get(ns, {}).get(key)

    def rpc_kv_multi_get(self, conn, arg):
        ns, keys = arg
        table = self.kv.get(ns, {})
        return {k: table[k] for k in keys if k in table}

    def rpc_kv_del(self, conn, arg):
        ns, key = arg
        existed = self.kv.get(ns, {}).pop(key, None) is not None
        if existed:
            self.mark_dirty()
        return existed

    def rpc_kv_keys(self, conn, arg):
        ns, prefix = arg
        return [k for k in self.kv.get(ns, {}) if k.startswith(prefix)]

    def rpc_kv_exists(self, conn, arg):
        ns, key = arg
        return key in self.kv.get(ns, {})

    # -------------------------------------------------------------- nodes
    async def rpc_register_node(self, conn: Connection, info: NodeInfo):
        # A node registering after a COMPLETED drain starts a FRESH
        # lifecycle: it must not inherit a `draining` label or a stale
        # drain record from restored snapshot state (drain -> die ->
        # restart would otherwise come back permanently unschedulable).
        # But a node RE-registering while its drain is still DRAINING —
        # the head bounced mid-drain — keeps both: the resumed
        # coordinator finishes the migration.
        rec = self.draining.get(info.node_id)
        if rec is not None and rec.get("state") == "DRAINING":
            info.labels["draining"] = "1"
        else:
            info.labels.pop("draining", None)
            self.draining.pop(info.node_id, None)
        self.nodes[info.node_id] = info
        self.node_conns[info.node_id] = conn
        self.node_resources_available[info.node_id] = dict(info.resources_total)
        self.node_last_heartbeat[info.node_id] = now()
        self._mark_resource_change(info.node_id)
        conn.on_close.append(lambda c: asyncio.ensure_future(
            self._on_node_lost(info.node_id)))
        self.mark_dirty()
        self.record_event(
            source="gcs", kind="node_registered",
            message=(f"node {info.node_id.hex()[:12]} registered "
                     f"({info.resources_total})"),
            node_id=info.node_id.hex(),
            resources=dict(info.resources_total),
            labels=dict(info.labels or {}))
        await self.publish(CH_NODE, {"event": "added", "node": info})
        logger.info("node %s registered (%s)", info.node_id, info.resources_total)
        return True

    async def _on_node_lost(self, node_id: NodeID,
                            cause: str | None = None):
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        conn = self.node_conns.pop(node_id, None)
        self.node_resources_available.pop(node_id, None)
        self._mark_resource_change(node_id)
        # the dead node's object directory + its workers' ref reports
        # will never send removal deltas: purge them now
        self.object_manager.on_node_dead(node_id.hex())
        # ...and its pending-lease report (phantom demand otherwise)
        self.event_manager.drop_node(node_id.hex())
        self.mark_dirty()
        cause = cause or (
            f"connection lost "
            f"({getattr(conn, 'close_reason', '') or 'untracked'})")
        gap = now() - self.node_last_heartbeat.get(node_id, now())
        logger.warning("node %s lost (%s)", node_id, cause)
        self.record_event(
            source="gcs", kind="node_dead", severity="ERROR",
            message=f"node {node_id.hex()[:12]} dead: {cause} "
                    f"(last heartbeat {gap:.1f}s ago)",
            node_id=node_id.hex(), cause=cause,
            heartbeat_gap_s=round(gap, 3))
        await self.publish(CH_NODE, {"event": "removed", "node": info})
        # a drain interrupted by the node dying ends DEAD, not DRAINED
        drain = self.draining.get(node_id)
        if drain is not None and drain.get("state") == "DRAINING":
            drain["state"] = "DEAD"
            self.mark_dirty()
        # Re-place placement groups with a bundle on the dead node BEFORE
        # failing over its actors: the replacement bundles' `{r}_pg_*`
        # resource keys must exist on live nodes for the restarted actors
        # to land (stale placements served forever was the old behavior).
        for pg_id, pg in list(self.placement_groups.items()):
            if pg.get("state") == "CREATED" and \
                    node_id in (pg.get("placement") or []):
                asyncio.ensure_future(self._reschedule_pg(pg_id))
        # Fail over actors on this node (restart if budget remains).
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in (
                    ActorState.ALIVE, ActorState.PENDING):
                await self._handle_actor_failure(actor, "node died")

    def _mark_resource_change(self, node_id: NodeID):
        self.resource_version += 1
        self._resource_log.append((self.resource_version, node_id))

    def rpc_heartbeat(self, conn, arg):
        """Resource-view sync (ref analog: RaySyncer resource broadcast).

        Delta form: (node_id, delta, full) where delta maps changed
        resource keys to amounts (None = key removed) and full=True
        replaces the whole view (first send / after reconnect). Legacy
        (node_id, available) is treated as full. Only REAL changes bump
        the version — an all-idle cluster syncs O(0) bytes downstream."""
        if len(arg) == 3:
            node_id, delta, full = arg
        else:
            node_id, delta, full = arg[0], arg[1], True
        self.node_last_heartbeat[node_id] = now()
        if node_id in self.nodes and self.nodes[node_id].alive:
            cur = self.node_resources_available.get(node_id)
            if full or cur is None:
                new = {k: v for k, v in delta.items() if v is not None}
                if cur != new:
                    self.node_resources_available[node_id] = new
                    self._mark_resource_change(node_id)
            elif delta:
                changed = False
                for k, v in delta.items():
                    if v is None:
                        changed |= cur.pop(k, None) is not None
                    elif cur.get(k) != v:
                        cur[k] = v
                        changed = True
                if changed:
                    self._mark_resource_change(node_id)
        return True

    def _node_view_entry(self, nid: NodeID) -> dict:
        info = self.nodes[nid]
        return {
            "total": info.resources_total,
            "available": self.node_resources_available.get(nid, {}),
            "alive": info.alive,
            "address": info.address,
            "labels": info.labels,
        }

    def rpc_get_cluster_resources_delta(self, conn, since: int):
        """Entries changed in (since, current]; falls back to a full
        view when `since` predates the change log's horizon (fresh
        consumer, log overflow, or GCS restart). Every reply also
        carries the quota view (shares + live usage) so node managers
        enforce fair shares on the same sync cadence — empty dict when
        no job has a quota, so the common case costs nothing."""
        v = self.resource_version
        quota = self.placement_plane.quota_view() \
            if self.placement_plane.quotas.quotas else {}
        if since == v:
            return {"version": v, "full": None, "changed": {},
                    "removed": [], "quota": quota}
        oldest = self._resource_log[0][0] if self._resource_log else v + 1
        if since > v or since < oldest - 1:
            # version from a previous GCS incarnation, or horizon lost
            return {"version": v,
                    "full": self.rpc_get_cluster_resources(conn),
                    "changed": {}, "removed": [], "quota": quota}
        changed_ids = {nid for ver, nid in self._resource_log
                       if ver > since}
        changed, removed = {}, []
        for nid in changed_ids:
            if nid in self.nodes:
                changed[nid.hex()] = self._node_view_entry(nid)
            else:
                removed.append(nid.hex())
        return {"version": v, "full": None, "changed": changed,
                "removed": removed, "quota": quota}

    def rpc_get_all_nodes(self, conn, arg=None):
        return list(self.nodes.values())

    def rpc_get_cluster_resources(self, conn, arg=None):
        return {nid.hex(): self._node_view_entry(nid)
                for nid in self.nodes}

    def rpc_drain_node(self, conn, arg):
        """Start a deadline-bound drain (ref analog: DrainNodeRequest +
        autoscaler v2 drain, extended with proactive migration).

        arg: (node_id, deadline_s, reason) — or a bare NodeID for the
        legacy label-only form (deadline/reason default). Idempotent: a
        second drain of a DRAINING node just returns True. The label
        stops new placement immediately (scheduling_policy filters it);
        the coordinator then migrates workloads off the node and flips
        the record to DRAINED (or DEAD if the node dies first)."""
        from ray_tpu_torch._internal.config import get_config

        if isinstance(arg, (tuple, list)):
            node_id = arg[0]
            deadline_s = arg[1] if len(arg) > 1 else None
            reason = (arg[2] if len(arg) > 2 else "") or ""
        else:
            node_id, deadline_s, reason = arg, None, ""
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return False
        if deadline_s is None:
            deadline_s = get_config().drain_deadline_s
        info.labels["draining"] = "1"
        self._mark_resource_change(node_id)  # view entry carries labels
        rec = self.draining.get(node_id)
        if rec is not None and rec.get("state") == "DRAINING":
            return True  # coordinator already running
        rec = {
            "state": "DRAINING",
            "reason": reason or "requested",
            "deadline": now() + float(deadline_s),
            "deadline_s": float(deadline_s),
            "started": now(),
            "migrated": {"actors": 0, "placement_groups": 0,
                         "objects": 0},
        }
        self.draining[node_id] = rec
        self.mark_dirty()
        self.record_event(
            source="gcs", kind="node_draining", severity="WARNING",
            message=(f"node {node_id.hex()[:12]} draining: "
                     f"{rec['reason']} (deadline {deadline_s:g}s)"),
            node_id=node_id.hex(), reason=rec["reason"],
            deadline_s=float(deadline_s))
        asyncio.ensure_future(self._drain_coordinator(node_id))
        return True

    def rpc_get_drain_status(self, conn, arg=None):
        """Drain records by node-id hex (read-only; serve controller
        polls this to find replicas it must migrate, CLI/state API
        render it)."""
        return {nid.hex(): dict(rec)
                for nid, rec in self.draining.items()}

    def _drain_rec(self, node_id: NodeID) -> dict | None:
        """The node's drain record IF the drain is still live (the node
        may have died or re-registered mid-coordination)."""
        rec = self.draining.get(node_id)
        if rec is None or rec.get("state") != "DRAINING":
            return None
        return rec

    async def _drain_coordinator(self, node_id: NodeID):
        """Migrate a draining node's workloads before teardown, bounded
        by the drain deadline:

          1. placement groups with a bundle on the node re-place their
             gang elsewhere (their `{r}_pg_*` keys must exist on live
             nodes before the member actors move);
          2. restartable actors fail over via _handle_actor_failure —
             the NEW incarnation schedules onto another node (the
             draining label filters this one) while the OLD instance
             keeps running; once the replacement is ALIVE the old worker
             is killed (its late death report is absorbed by the stale-
             worker guard). Non-restartable actors are left alone: serve
             replicas (max_restarts=0) are migrated by their controller,
             which watches get_drain_status;
          3. sole-copy objects on the node are pushed to live peers
             (node_manager evacuate_objects) so readers never need
             lineage re-execution after teardown;
          4. wait (deadline-bound) for the node to empty of ALIVE
             actors, then flip the record to DRAINED and emit the
             node_drained event with per-workload migration counts.

        Re-entrant: a head restart mid-drain resumes here from the
        restored record, and every phase only acts on workloads still
        on the node."""
        from ray_tpu_torch._internal.config import get_config

        rec = self._drain_rec(node_id)
        if rec is None:
            return
        poll = max(0.05, get_config().drain_poll_interval_s)
        try:
            # -- phase 1: placement groups off the node (gang re-place)
            for pg_id, pg in list(self.placement_groups.items()):
                if self._drain_rec(node_id) is None:
                    return
                if pg.get("state") == "CREATED" and \
                        node_id in (pg.get("placement") or []):
                    if await self._reschedule_pg(pg_id,
                                                 exclude=node_id):
                        rec["migrated"]["placement_groups"] += 1
                        self.mark_dirty()
            # -- phase 2: restartable actors fail over (make-before-
            # break: old instance keeps serving until the new one lands)
            migrating: list[ActorInfo] = []
            for actor in list(self.actors.values()):
                if self._drain_rec(node_id) is None:
                    return
                if actor.node_id != node_id:
                    continue
                if actor.state == ActorState.RESTARTING:
                    # restored mid-failover (head restart): the
                    # _schedule_actor resumed in start() owns the
                    # replacement — adopt the wait, don't re-fail it
                    migrating.append(actor)
                    continue
                if actor.state != ActorState.ALIVE:
                    continue
                if actor.max_restarts == 0:
                    continue  # controller-managed (serve) or pinned
                await self._handle_actor_failure(
                    actor, f"node draining: {rec['reason']}")
                migrating.append(actor)
            for actor in migrating:
                while now() < rec["deadline"] and \
                        actor.state == ActorState.RESTARTING and \
                        self._drain_rec(node_id) is not None:
                    await asyncio.sleep(poll)
                if self._drain_rec(node_id) is None:
                    return
                if actor.state == ActorState.ALIVE and \
                        actor.node_id != node_id:
                    rec["migrated"]["actors"] += 1
                    self.mark_dirty()
                # the old incarnation still runs on the draining node —
                # stop it now that (or whether) the replacement landed
                conn = self.node_conns.get(node_id)
                if conn is not None:
                    try:
                        await conn.call("kill_actor_worker",
                                        actor.actor_id, timeout=10)
                    except Exception:
                        pass
            # -- phase 3: evacuate object copies whose only home is the
            # draining node (push to live peers; owners learn the new
            # location so post-teardown reads never hit lineage)
            conn = self.node_conns.get(node_id)
            targets = [
                (nid, info.address)
                for nid, info in self.nodes.items()
                if info.alive and nid != node_id
                and nid in self.node_conns
                and not (info.labels or {}).get("draining")]
            if conn is not None and targets:
                budget = max(5.0, rec["deadline"] - now())
                try:
                    moved = await conn.call("evacuate_objects", targets,
                                            timeout=budget)
                    rec["migrated"]["objects"] += int(moved or 0)
                    self.mark_dirty()
                except Exception as e:
                    logger.warning("drain %s: object evacuation "
                                   "failed: %s", node_id, e)
            # -- phase 4: deadline-bound wait for the node to empty
            # RESTARTING counts as still-on-the-node: its replacement is
            # in flight and node_id only moves once that lands — flipping
            # DRAINED early would let a re-register shed the record
            # while the migration is unfinished
            while now() < rec["deadline"]:
                if self._drain_rec(node_id) is None:
                    return
                if not any(a.node_id == node_id
                           and a.state in (ActorState.ALIVE,
                                           ActorState.RESTARTING)
                           for a in self.actors.values()):
                    break
                await asyncio.sleep(poll)
            if self._drain_rec(node_id) is None:
                return
            remaining = sum(
                1 for a in self.actors.values()
                if a.node_id == node_id
                and a.state in (ActorState.ALIVE, ActorState.RESTARTING))
            rec["state"] = "DRAINED"
            rec["completed"] = now()
            self.mark_dirty()
            took = rec["completed"] - rec["started"]
            mig = rec["migrated"]
            self.record_event(
                source="gcs", kind="node_drained", severity="WARNING",
                message=(f"node {node_id.hex()[:12]} drained in "
                         f"{took:.1f}s: {mig['actors']} actor(s), "
                         f"{mig['placement_groups']} placement "
                         f"group(s), {mig['objects']} object(s) "
                         f"migrated; {remaining} actor(s) left behind "
                         f"({rec['reason']})"),
                node_id=node_id.hex(), reason=rec["reason"],
                drain_s=round(took, 3), migrated=dict(mig),
                remaining_actors=remaining)
        except Exception:
            logger.exception("drain coordinator for %s failed", node_id)

    # --------------------------------------------------------------- jobs
    def rpc_register_job(self, conn, arg):
        job_id, metadata = arg
        self.jobs[job_id] = {"metadata": metadata, "start_time": now(),
                             "status": "RUNNING"}
        self.mark_dirty()
        job_hex = job_id.hex() if job_id is not None else ""
        self.record_event(source="gcs", kind="job_started",
                          message=f"job {job_hex[:12]} started",
                          job_id=job_hex)
        return True

    async def rpc_finish_job(self, conn, job_id: JobID):
        if job_id in self.jobs:
            self.jobs[job_id]["status"] = "FINISHED"
            self.jobs[job_id]["end_time"] = now()
            self.mark_dirty()
        # the finished job's fair-share quota dies with it (its hex is
        # never reused; a stale entry would dilute live jobs' shares)
        self.placement_plane.quotas.set_quota(job_id.hex(), 0.0, 0.0)
        # the exiting driver owns the job's objects: drop their records
        self.object_manager.on_job_finished(job_id.hex())
        # ...and its event-log entries (purge FIRST so the finish event
        # itself survives as the job's one remaining record)
        self.event_manager.on_job_finished(job_id.hex())
        self.record_event(source="gcs", kind="job_finished",
                          message=f"job {job_id.hex()[:12]} finished",
                          job_id=job_id.hex())
        # ...and its compiled DAGs (their loops die with the driver);
        # drain the gauge update this may emit (no report will follow
        # to carry it — a dead job's stall must not read as live)
        self.dag_manager.on_job_finished(job_id.hex())
        recs = self.dag_manager.drain_metric_records()
        if recs:
            self.metrics_store.ingest_many(recs)
        # ...and its train runs (step records, stall flags, memory
        # snapshots — a resubmitted job starts with a clean ledger)
        self.train_manager.on_job_finished(job_id.hex())
        # node managers relay this to their pooled workers, which drop
        # the finished job's function-table entries (pooled workers
        # outlive jobs; see core/function_table.py evict_job)
        await self.publish("job_finished", job_id.hex())
        # and sweep the job's code blobs out of the fn_table KV
        # namespace — function ids are job-hex-prefixed, so a finished
        # job's blobs would otherwise accumulate in GCS memory (and its
        # snapshots) forever
        table = self.kv.get("fn_table")
        if table:
            prefix = job_id.hex() + ":"
            for k in [k for k in table if k.startswith(prefix)]:
                del table[k]
            self.mark_dirty()
        return True

    def rpc_get_all_jobs(self, conn, arg=None):
        return {j.hex(): meta for j, meta in self.jobs.items()}

    # -------------------------------------------------------------- actors
    async def rpc_register_actor(self, conn: Connection, spec: TaskSpec):
        """Register + schedule an actor (ref: gcs_actor_manager.cc)."""
        opts = spec.actor_options
        assert spec.actor_id is not None and opts is not None
        if opts.name:
            key = (opts.namespace, opts.name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing is not None and existing.state != ActorState.DEAD:
                    raise ValueError(
                        f"actor name {opts.name!r} already taken in "
                        f"namespace {opts.namespace!r}")
            self.named_actors[key] = spec.actor_id
        info = ActorInfo(
            actor_id=spec.actor_id, name=opts.name, namespace=opts.namespace,
            state=ActorState.PENDING, address=None, worker_id=None,
            node_id=None, max_restarts=opts.max_restarts,
            class_name=spec.name, required_resources=dict(spec.resources))
        self.actors[spec.actor_id] = info
        self.actor_specs[spec.actor_id] = spec
        self._record_task_transition(spec, "PENDING_ARGS")
        self.record_event(
            source="gcs", kind="actor_created",
            message=(f"actor {spec.actor_id.hex()[:12]} "
                     f"({spec.name or 'Actor'}) registered, scheduling"),
            job_id=spec.job_id.hex(), actor_id=spec.actor_id.hex(),
            class_name=spec.name or "")
        self.mark_dirty()
        await self.publish(CH_ACTOR, info)
        asyncio.ensure_future(self._schedule_actor(spec.actor_id))
        return True

    def _pick_node_for(self, demand: dict[str, float],
                       strategy=None) -> NodeID | None:
        """Actor/PG placement via the shared policy module (ref:
        gcs_actor_scheduler.h:111 + scheduling/policy/ — hybrid top-k
        scoring, SPREAD round-robin, node-affinity, label affinity)."""
        from ray_tpu_torch.core.scheduling_policy import pick_node

        views, by_hex = {}, {}
        for nid, info in self.nodes.items():
            h = nid.hex()
            by_hex[h] = nid
            views[h] = {
                "total": info.resources_total,
                "available": self.node_resources_available.get(nid, {}),
                "alive": info.alive, "labels": info.labels,
            }
        self._spread_counter += 1
        nid_hex = pick_node(views, demand, strategy,
                            spread_counter=self._spread_counter)
        return by_hex.get(nid_hex)

    async def _schedule_actor(self, actor_id: ActorID):
        info = self.actors[actor_id]
        spec = self.actor_specs[actor_id]
        # placement check only: zero-resource actors still target a node
        # with a CPU free (they hold nothing once placed)
        demand = dict(spec.resources) or {"CPU": 1.0}
        from ray_tpu_torch._internal.config import get_config

        deadline = time.monotonic() + \
            get_config().actor_scheduling_deadline_s
        tries = 0
        while time.monotonic() < deadline:
            if info.state == ActorState.DEAD:
                return  # killed while pending placement
            node_id = self._pick_node_for(demand, spec.scheduling_strategy)
            if node_id is None or node_id not in self.node_conns:
                tries += 1
                if tries % 150 == 0:  # ~every 30s of spinning
                    logger.warning(
                        "actor %s unplaceable after %d tries: demand=%s "
                        "picked=%s conns=%s view=%s", actor_id, tries,
                        demand, node_id,
                        [n.hex()[:8] for n in self.node_conns],
                        {n.hex()[:8]: self.node_resources_available.get(n)
                         for n in self.nodes})
                await asyncio.sleep(0.2)
                continue
            conn = self.node_conns[node_id]
            self._record_task_transition(spec, "SCHEDULED")
            self._actors_placing.add(actor_id)
            try:
                # Must exceed the node-side create_actor push timeout (300s,
                # node_manager rpc_start_actor): timing out first would make
                # this retry loop create a duplicate actor while the first
                # create is still running, leaking its worker + lease.
                result = await conn.call(
                    "start_actor", spec,
                    timeout=get_config().actor_creation_push_timeout_s)
            except Exception as e:
                logger.warning("start_actor on %s failed: %s", node_id, e)
                await asyncio.sleep(0.2)
                continue
            finally:
                self._actors_placing.discard(actor_id)
            if result is None:
                await asyncio.sleep(0.1)
                continue
            worker_info, err = result
            if err is not None:
                # creation task raised: actor is DEAD with cause
                info.state = ActorState.DEAD
                info.death_cause = err
                self.record_event(
                    source="gcs", kind="actor_dead", severity="ERROR",
                    message=(f"actor {actor_id.hex()[:12]} "
                             f"({info.class_name or 'Actor'}) creation "
                             f"failed: {err}"),
                    job_id=spec.job_id.hex(),
                    node_id=node_id.hex(),
                    actor_id=actor_id.hex(), cause=err)
                await self.publish(CH_ACTOR, info)
                return
            if worker_info.worker_id in self._dead_actor_workers:
                # the fresh worker died before this reply arrived
                self._dead_actor_workers.pop(worker_info.worker_id, None)
                await asyncio.sleep(0.1)
                continue
            if info.state == ActorState.DEAD:
                # killed while creation was in flight: stop the worker we
                # just made instead of resurrecting the actor
                try:
                    await conn.call("kill_actor_worker", actor_id)
                except Exception:
                    pass
                return
            info.state = ActorState.ALIVE
            info.address = worker_info.address
            info.worker_id = worker_info.worker_id
            info.node_id = worker_info.node_id
            await self.publish(CH_ACTOR, info)
            logger.info("actor %s alive on %s", actor_id, info.address)
            return
        info.state = ActorState.DEAD
        info.death_cause = "scheduling timed out (unsatisfiable resources?)"
        self.record_event(
            source="gcs", kind="actor_dead", severity="ERROR",
            message=(f"actor {actor_id.hex()[:12]} "
                     f"({info.class_name or 'Actor'}) scheduling timed "
                     f"out: demand {demand} unplaceable"),
            job_id=spec.job_id.hex(), actor_id=actor_id.hex(),
            cause=info.death_cause, demand=demand)
        await self.publish(CH_ACTOR, info)

    def _actor_job_hex(self, actor_id: ActorID) -> str:
        spec = self.actor_specs.get(actor_id)
        return spec.job_id.hex() if spec is not None else ""

    async def _handle_actor_failure(self, info: ActorInfo, cause: str):
        if info.max_restarts != 0 and (
                info.max_restarts < 0 or info.num_restarts < info.max_restarts):
            info.num_restarts += 1
            info.state = ActorState.RESTARTING
            info.address = None
            self.record_event(
                source="gcs", kind="actor_restarting", severity="WARNING",
                message=(f"actor {info.actor_id.hex()[:12]} "
                         f"({info.class_name or 'Actor'}) restarting "
                         f"(attempt {info.num_restarts}): {cause}"),
                job_id=self._actor_job_hex(info.actor_id),
                node_id=info.node_id.hex() if info.node_id else "",
                actor_id=info.actor_id.hex(), cause=cause,
                num_restarts=info.num_restarts)
            await self.publish(CH_ACTOR, info)
            asyncio.ensure_future(self._schedule_actor(info.actor_id))
        else:
            info.state = ActorState.DEAD
            info.death_cause = cause
            info.address = None
            self.record_event(
                source="gcs", kind="actor_dead", severity="ERROR",
                message=(f"actor {info.actor_id.hex()[:12]} "
                         f"({info.class_name or 'Actor'}) dead: {cause}"),
                job_id=self._actor_job_hex(info.actor_id),
                node_id=info.node_id.hex() if info.node_id else "",
                actor_id=info.actor_id.hex(), cause=cause)
            await self.publish(CH_ACTOR, info)

    async def rpc_report_actor_failure(self, conn, arg):
        """Called by node managers when an actor's worker process dies."""
        actor_id, cause, *rest = arg
        worker_id = rest[0] if rest else None
        info = self.actors.get(actor_id)
        if info is None or info.state == ActorState.DEAD:
            return False
        if info.state != ActorState.ALIVE:
            # PENDING/RESTARTING: a _schedule_actor is in flight and owns
            # recovery. A report for an unknown worker is the in-flight
            # incarnation dying before its start_actor result landed —
            # remember it so _schedule_actor treats the creation as failed
            # instead of marking a dead worker ALIVE.
            if worker_id is not None and worker_id != info.worker_id:
                ts = now()
                self._dead_actor_workers[worker_id] = ts
                for wid, t in list(self._dead_actor_workers.items()):
                    if ts - t > _DEAD_WORKER_TTL_S:
                        del self._dead_actor_workers[wid]
            return False
        if (worker_id is not None and info.worker_id is not None
                and worker_id != info.worker_id):
            return False  # stale report for a previous incarnation's worker
        await self._handle_actor_failure(info, cause)
        return True

    async def rpc_kill_actor(self, conn, arg):
        actor_id, no_restart = arg
        info = self.actors.get(actor_id)
        if info is None:
            return False
        # kill(no_restart=False) on a PENDING/RESTARTING actor is a no-op
        # by design: there is no live incarnation to kill, and the
        # in-flight _schedule_actor already delivers the same outcome a
        # kill+restart would (a fresh instance).
        if no_restart:
            info.max_restarts = 0
        if info.node_id in self.node_conns:
            try:
                await self.node_conns[info.node_id].call(
                    "kill_actor_worker", actor_id)
            except Exception:
                pass
        # Record the death now (don't wait for the node's reap loop) so
        # calls submitted after kill() returns fail fast instead of racing
        # the SIGTERM to the still-live worker. Only an ALIVE actor takes
        # the failure path — a PENDING/RESTARTING one already has a
        # _schedule_actor in flight and a second one would double-restart;
        # those flows notice info.state == DEAD and stand down themselves.
        if info.state == ActorState.ALIVE:
            await self._handle_actor_failure(info, "killed via ray_tpu_torch.kill()")
        elif no_restart and info.state != ActorState.DEAD:
            info.state = ActorState.DEAD
            info.death_cause = "killed via ray_tpu_torch.kill()"
            info.address = None
            await self.publish(CH_ACTOR, info)
        return True

    def rpc_get_actor_info(self, conn, actor_id: ActorID):
        return self.actors.get(actor_id)

    def rpc_get_named_actor(self, conn, arg):
        namespace, name = arg
        actor_id = self.named_actors.get((namespace, name))
        if actor_id is None:
            return None
        return self.actors.get(actor_id), self.actor_specs.get(actor_id)

    def rpc_get_all_actors(self, conn, arg=None):
        return list(self.actors.values())

    def rpc_actor_handle_state(self, conn, actor_id: ActorID):
        """Lightweight poll used by callers resolving an actor address."""
        info = self.actors.get(actor_id)
        if info is None:
            return None
        return (info.state, info.address, info.death_cause,
                info.num_restarts, info.node_id)

    # ---------------------------------------------------- placement groups
    async def rpc_create_placement_group(self, conn, arg):
        """Gang reservation: all-or-nothing bundle reservation across
        nodes (ref: gcs_placement_group_manager + 2-phase commit on
        raylets; here prepare/commit RPCs against node managers)."""
        pg_id, bundles, strategy = arg
        existing = self.placement_groups.get(pg_id)
        if existing is not None and existing.get("state") == "PENDING":
            existing["last_poll"] = now()
        placement = await self._schedule_pg(pg_id, bundles, strategy)
        self.mark_dirty()
        if placement is None:
            # record the unplaced PG: the autoscaler reads PENDING PGs as
            # resource demand (ref: gcs_autoscaler_state_manager feeding
            # autoscaler v2's Reconciler); the client keeps polling and a
            # later attempt succeeds once capacity arrives
            self.placement_groups[pg_id] = {
                "bundles": bundles, "strategy": strategy,
                "placement": None, "state": "PENDING",
                "last_poll": now(),
            }
            return None
        self.placement_groups[pg_id] = {
            "bundles": bundles, "strategy": strategy,
            "placement": placement, "state": "CREATED",
        }
        return placement

    async def _schedule_pg(self, pg_id, bundles, strategy, exclude=None):
        """Gang placement through the placement plane: the measured-cost
        placer decides (SLICE_PACK keeps the gang inside one ICI slice;
        scheduling_policy.node_schedulable filters dead/draining/label
        mismatches), then the two-phase prepare/commit reserves — the
        WHOLE sequence inside one ordered-admission window, so two
        concurrent gangs at partial capacity never interleave partial
        prepares: one completes, the other backs off whole.

        exclude: a node to avoid even if schedulable (the node being
        drained — its label may not have propagated to every view yet)."""
        views, by_hex = {}, {}
        for nid, info in self.nodes.items():
            if nid == exclude:
                continue
            h = nid.hex()
            by_hex[h] = nid
            views[h] = self._node_view_entry(nid)
        gang = pg_id.hex()
        async with self.placement_plane.admission.admit(gang):
            hexes = self.placement_plane.place_bundles(
                bundles, strategy, views)
            if hexes is None:
                self.placement_plane.admission.note_backoff(gang)
                return None
            placement = [by_hex[h] for h in hexes]
            # 2-phase: prepare on each node, commit if all succeed.
            prepared: list[tuple[NodeID, int]] = []
            ok = True
            for i, nid in enumerate(placement):
                conn2 = self.node_conns.get(nid)
                if conn2 is None:
                    ok = False
                    break
                try:
                    good = await conn2.call(
                        "pg_prepare", (pg_id, i, bundles[i]), timeout=10)
                except Exception:
                    good = False
                if not good:
                    ok = False
                    break
                prepared.append((nid, i))
            if not ok:
                # back off WHOLE: every prepared bundle is returned
                # before the admission window closes, so the next gang
                # in line sees no partial reservation
                for nid, i in prepared:
                    conn2 = self.node_conns.get(nid)
                    if conn2 is not None:
                        try:
                            await conn2.call("pg_return", (pg_id, i),
                                             timeout=10)
                        except Exception:
                            pass
                self.placement_plane.admission.note_backoff(gang)
                return None
            for nid, i in prepared:
                await self.node_conns[nid].call("pg_commit", (pg_id, i),
                                                timeout=10)
            self.placement_plane.admission.note_placed(gang)
            return placement

    async def _reschedule_pg(self, pg_id,
                             exclude: NodeID | None = None) -> bool:
        """Gang re-placement of a PG displaced by a dead or draining
        node (ref analog: gcs_placement_group_manager rescheduling on
        node death — the piece the old `_on_node_lost` never did).

        A CREATED PG with a bundle on a bad node releases its surviving
        reservations (all-or-nothing: bundles can't half-move), flips to
        RESCHEDULING, and re-places the whole gang on live non-draining
        nodes. On failure it STAYS RESCHEDULING: its bundles read as
        pending demand (autoscaler launches capacity) and
        _pg_reschedule_loop retries until placement succeeds."""
        pg = self.placement_groups.get(pg_id)
        if pg is None or pg_id in self._pgs_rescheduling:
            return False
        self._pgs_rescheduling.add(pg_id)
        try:
            state = pg.get("state")
            if state == "CREATED":
                placement = pg.get("placement") or []

                def bad(nid):
                    info = self.nodes.get(nid)
                    return (nid == exclude or info is None
                            or not info.alive
                            or bool((info.labels or {}).get("draining")))

                if not any(bad(nid) for nid in placement):
                    return False  # nothing displaced
                for i, nid in enumerate(placement):
                    c = self.node_conns.get(nid)
                    if c is not None:
                        try:
                            await c.call("pg_return", (pg_id, i),
                                         timeout=10)
                        except Exception:
                            pass
                pg["state"] = "RESCHEDULING"
                pg["placement"] = None
                pg["last_poll"] = now()
                self.mark_dirty()
            elif state != "RESCHEDULING":
                return False
            placement = await self._schedule_pg(
                pg_id, pg["bundles"], pg["strategy"], exclude=exclude)
            if placement is None:
                return False
            pg["placement"] = placement
            pg["state"] = "CREATED"
            self.mark_dirty()
            self.record_event(
                source="gcs", kind="placement_group_rescheduled",
                severity="WARNING",
                message=(f"placement group {pg_id.hex()[:12]} "
                         f"re-placed on "
                         f"{sorted({n.hex()[:12] for n in placement})}"),
                placement_group_id=pg_id.hex(),
                nodes=[n.hex() for n in placement])
            return True
        finally:
            self._pgs_rescheduling.discard(pg_id)

    async def _pg_reschedule_loop(self):
        """Retry RESCHEDULING placement groups once capacity appears
        (a reschedule that found no room parks the PG here; autoscaled
        or newly registered nodes make the next attempt succeed)."""
        while True:
            await asyncio.sleep(1.0)
            for pg_id, pg in list(self.placement_groups.items()):
                if pg.get("state") == "RESCHEDULING":
                    try:
                        await self._reschedule_pg(pg_id)
                    except Exception:
                        logger.exception("pg %s reschedule retry failed",
                                         pg_id)

    async def rpc_remove_placement_group(self, conn, pg_id):
        pg = self.placement_groups.pop(pg_id, None)
        if pg is None:
            return False
        self.mark_dirty()
        for i, nid in enumerate(pg.get("placement") or []):
            c = self.node_conns.get(nid)
            if c is not None:
                try:
                    await c.call("pg_return", (pg_id, i), timeout=10)
                except Exception:
                    pass
        return True

    def rpc_get_placement_group(self, conn, pg_id):
        return self.placement_groups.get(pg_id)

    # ------------------------------------------------------ placement plane
    def rpc_place_gang(self, conn, arg):
        """Advisory gang placement: (demands, strategy) -> a node hex
        per demand, or None when the gang doesn't fit whole RIGHT NOW.
        Pure decision — nothing is reserved; callers that need a real
        reservation go through create_placement_group (which routes the
        same placer inside the ordered admission window). RL/train use
        this for soft co-location of worker fleets."""
        demands, strategy = arg
        return self.placement_plane.place_bundles(
            [dict(d) for d in demands], strategy or "SLICE_PACK")

    def rpc_placement_advise_dag(self, conn, arg):
        """Compile-time consult from ChannelCompiledDAG: given the DAG's
        per-actor demands and its edges' current endpoint nodes, report
        where the plane would put the gang (SLICE_PACK) and how many
        edges the CURRENT placement co-locates — weighted by measured
        per-edge bytes when dag_id names a known ring (recovery
        recompile)."""
        a = dict(arg or {})
        return self.placement_plane.advise_dag(
            demands=[dict(d) for d in a.get("demands") or ()],
            edge_nodes=[tuple(e) for e in a.get("edge_nodes") or ()],
            dag_id=str(a.get("dag_id") or ""))

    def rpc_set_job_quota(self, conn, arg):
        """(job_hex, weight, floor) — opt a job into fair-share
        enforcement (weight<=0 and floor<=0 removes the quota). The
        updated view ships to every node manager on its next heartbeat
        sync; enforcement is node-side in the lease path."""
        job_hex, weight, floor = arg
        self.placement_plane.quotas.set_quota(
            str(job_hex), float(weight), float(floor))
        self.mark_dirty()
        self.record_event(
            source="gcs", kind="job_quota_set",
            message=(f"job {str(job_hex)[:12]} quota set: "
                     f"weight={float(weight):g} floor={float(floor):g} "
                     f"{self.placement_plane.quotas.resource}"),
            job_id=str(job_hex), weight=float(weight),
            floor=float(floor))
        return True

    def rpc_placement_state(self, conn, arg=None):
        """`rayt status` / dashboard surface for the placement plane:
        topology map (slice/locality -> nodes), quota ledger with live
        usage, gang-admission counters, cumulative per-job throttle
        verdicts."""
        st = self.placement_plane.state()
        st["quota_throttled"] = \
            self.event_manager.quota_throttled_totals()
        return st

    # -------------------------------------------------------- task events
    def _record_task_transition(self, spec: TaskSpec, state: str,
                                kind: str = "actor_creation"):
        """GCS-side lifecycle emission for flows the GCS itself drives
        (actor creation: registered -> placed); ingested directly, no
        buffer/flush hop needed in-process."""
        if not self._task_events_enabled:
            return
        from ray_tpu_torch._internal.tracing import make_transition

        self.task_manager.ingest([make_transition(
            task_id=spec.task_id.hex(), name=spec.name or "Actor",
            kind=kind, state=state, job_id=spec.job_id.hex(),
            actor_id=spec.actor_id.hex() if spec.actor_id else "",
            resources=(dict(spec.resources)
                       if state == "PENDING_ARGS" else None))])

    def rpc_add_task_events(self, conn, events: list):
        """Ingest flushed worker/node-manager event batches into the
        task manager (ref: gcs_task_manager.h AddTaskEventData)."""
        self.task_manager.ingest(events)
        return True

    def rpc_get_task_events(self, conn, arg=None):
        """Filtered coalesced task records (timeline / state API feed).
        arg: optional {"job_id", "state", "name", "actor_id",
        "start_us", "end_us", "limit"} — no more full-ring dumps; the
        filter runs server-side."""
        filters = dict(arg or {})
        filters.setdefault("limit", 0)  # timeline export wants everything
        return self.task_manager.records(**filters)

    def rpc_list_tasks(self, conn, arg=None):
        """State API `list_tasks` backend: filtered, limited, newest
        first, with truncation + per-job dropped accounting."""
        return self.task_manager.list(**dict(arg or {}))

    def rpc_summarize_tasks(self, conn, arg=None):
        """State API `summarize_tasks` backend: per-task-name state
        counts + scheduling-vs-execution latency split."""
        return self.task_manager.summarize(**dict(arg or {}))

    def rpc_list_objects_state(self, conn, arg=None):
        """State API `list_objects` backend: filtered coalesced object
        records (job / node / callsite / leaked, limit) from the object
        manager — server-side, no full-store dump to the client."""
        return self.object_manager.list(**dict(arg or {}))

    def rpc_summarize_objects(self, conn, arg=None):
        """State API `summarize_objects` backend: per-callsite and
        per-node memory rollups + store stats + leak flags (`rayt
        memory`'s data source)."""
        return self.object_manager.summarize(**dict(arg or {}))

    def _actor_state_by_hex(self, actor_hex: str):
        """Liveness lookup for the dag manager's stall attribution.
        O(actors) — only paid when an edge is blocked past the grace
        window, never on the report hot path."""
        for aid, info in self.actors.items():
            if aid.hex() == actor_hex:
                return info.state
        return None

    def rpc_list_dags(self, conn, arg=None):
        """State API `list_dags` backend: filtered compiled-DAG records
        (job / dag id / stalled-only, limit) with per-edge stats, stall
        attribution, and sparkline history — server-side, no full-store
        dump to the client."""
        return self.dag_manager.list(**dict(arg or {}))

    def rpc_summarize_dags(self, conn, arg=None):
        """State API `summarize_dags` backend: DAG counts by state,
        tick/byte/blocked-time totals, and current stalls."""
        return self.dag_manager.summarize(**dict(arg or {}))

    def rpc_list_serve_requests(self, conn, arg=None):
        """State API `list_serve_requests` backend: filtered coalesced
        per-request latency-waterfall records (app / outcome / model id
        / errors-only / min-e2e / slowest-first, limit) with per-app
        eviction + sampling accounting — server-side, no full-store
        dump to the client."""
        return self.serve_manager.list(**dict(arg or {}))

    def rpc_summarize_serve_requests(self, conn, arg=None):
        """State API `summarize_serve_requests` backend: per-app
        request/outcome counts + waterfall-stage and TTFT/TPOT/e2e
        p50/p99 rollups (`rayt serve status`'s table)."""
        return self.serve_manager.summarize(**dict(arg or {}))

    def rpc_get_serve_request(self, conn, request_id: str):
        """One request record by id (hex prefix accepted)."""
        return self.serve_manager.get(request_id or "")

    def rpc_list_train_runs(self, conn, arg=None):
        """State API `list_train_runs` backend: filtered run records
        (experiment / state, limit) with per-worker rollups, sparkline
        history, stall flags, and device-memory snapshots — server-side,
        no full-store dump to the client."""
        return self.train_manager.list_runs(**dict(arg or {}))

    def rpc_summarize_train_runs(self, conn, arg=None):
        """State API `summarize_train_runs` backend: per-run step
        counts + waterfall-stage p50/p99 rollups, compile/retrace
        counts, stalled + starved workers, and memory totals
        (`rayt train status`'s table)."""
        return self.train_manager.summarize(**dict(arg or {}))

    def rpc_get_train_run(self, conn, run_id: str):
        """One train-run record by id (hex prefix accepted)."""
        return self.train_manager.get(run_id or "")

    def rpc_list_train_steps(self, conn, arg=None):
        """State API `list_train_steps` backend: retained per-step
        waterfall records (run / rank / min-wall / slowest-first,
        limit) with per-run dropped accounting."""
        return self.train_manager.list_steps(**dict(arg or {}))

    def rpc_list_cluster_events(self, conn, arg=None):
        """State API `list_cluster_events` backend: filtered event-log
        query (job / node prefix / min-severity / source / kind / time
        window / limit) — server-side, no full-log dump to the client."""
        return self.event_manager.list(**dict(arg or {}))

    def rpc_summarize_scheduling(self, conn, arg=None):
        """State API `summarize_scheduling` backend: per-demand-shape
        lease decision rollups (grant/spill/queue/infeasible/cancelled
        counts, queue-wait totals, spillback hops) + per-node pending
        queue state from the heartbeat-cadence reports."""
        return self.event_manager.summarize_scheduling()

    def rpc_why_pending(self, conn, task_id: str):
        """`rayt why-pending <task_id>` backend: join the task-events
        record with the live resource view + decision traces to say
        what a pending task is waiting for — feasible-but-busy (and on
        which nodes, behind how deep a queue) vs infeasible
        cluster-wide (and which resource is short)."""
        from ray_tpu_torch._internal.tracing import TERMINAL_STATES

        rec = self.task_manager.get(task_id or "")
        if rec is None:
            return {"found": False,
                    "explanation": f"no task record matches "
                                   f"{task_id!r} (events flush on a "
                                   f"~1s cadence; evicted records are "
                                   f"gone)"}
        out = {
            "found": True, "task_id": rec["task_id"],
            "name": rec["name"], "state": rec["state"],
            "attempt": rec["attempt"], "job_id": rec["job_id"],
        }
        if rec["state"] == "RUNNING" or rec["state"] in TERMINAL_STATES:
            out["pending"] = False
            out["verdict"] = "not_pending"
            out["explanation"] = (
                f"task is {rec['state']}"
                + (f" on node {rec['node'][:12]}" if rec.get("node")
                   else "") + " — not waiting on the scheduler")
            return out
        out["pending"] = True
        demand = dict(rec.get("resources") or {}) or {"CPU": 1.0}
        sk = shape_key(demand)
        out["demand"] = demand
        out["shape"] = sk
        # live feasibility over the GCS resource view
        fit_now, fit_ever, node_views = [], [], {}
        short = {r: 0.0 for r in demand}
        for nid, info in self.nodes.items():
            if not info.alive:
                continue
            h = nid.hex()
            avail = self.node_resources_available.get(nid, {})
            total = info.resources_total
            fits_now = all(avail.get(r, 0.0) >= amt - 1e-9
                           for r, amt in demand.items())
            fits_ever = all(total.get(r, 0.0) >= amt - 1e-9
                            for r, amt in demand.items())
            if fits_now:
                fit_now.append(h)
            if fits_ever:
                fit_ever.append(h)
            for r in demand:
                short[r] = max(short[r], total.get(r, 0.0))
            node_views[h] = {
                "available": {r: avail.get(r, 0.0) for r in demand},
                "total": {r: total.get(r, 0.0) for r in demand},
                "fits_now": fits_now, "fits_ever": fits_ever,
                "pending_leases":
                    self.event_manager.node_sched(h)["pending"],
            }
        out["nodes"] = node_views
        out["trace"] = self.event_manager.shape_stats(sk)
        # fair-share check: a quota'd job past its share parks in the
        # node-side lease queue even when nodes have room — a DISTINCT
        # verdict from feasible_but_busy (waiting on its own share to
        # free, not on other work to finish)
        jq = self.placement_plane.quota_view().get(rec["job_id"])
        over_share = (
            jq is not None and
            jq["used"] + demand.get(jq["resource"], 0.0)
            > jq["share"] + 1e-9)
        if jq is not None:
            out["quota"] = jq
        if not fit_ever:
            missing = {r: {"need": demand[r],
                           "cluster_max": short[r]}
                       for r, amt in demand.items()
                       if short[r] < amt - 1e-9}
            out["verdict"] = "infeasible"
            out["short_resources"] = missing
            out["explanation"] = (
                f"INFEASIBLE cluster-wide: no alive node can ever "
                f"satisfy {sk}; short on "
                + ", ".join(f"{r} (need {v['need']:g}, largest node "
                            f"has {v['cluster_max']:g})"
                            for r, v in missing.items()))
        elif over_share:
            out["verdict"] = "quota_throttled"
            out["explanation"] = (
                f"QUOTA THROTTLED: job {rec['job_id'][:12]} holds "
                f"{jq['used']:g} {jq['resource']} of a "
                f"{jq['share']:g} fair share "
                f"(weight {jq['weight']:g}, floor {jq['floor']:g}); "
                f"{sk} waits behind under-share tenants until the "
                f"job's own leases return — not a capacity problem")
        elif not fit_now:
            depth = sum(v["pending_leases"]
                        for h, v in node_views.items() if h in fit_ever)
            out["verdict"] = "feasible_but_busy"
            out["explanation"] = (
                f"FEASIBLE BUT BUSY: {len(fit_ever)} node(s) "
                f"({', '.join(h[:12] for h in fit_ever[:4])}"
                + ("…" if len(fit_ever) > 4 else "")
                + f") fit {sk} by capacity but none has room now; "
                  f"{depth} lease(s) queued on those nodes — the task "
                  f"waits for running work to release resources")
        else:
            out["verdict"] = "schedulable"
            out["explanation"] = (
                f"{len(fit_now)} node(s) have room for {sk} right now; "
                f"the task is likely mid-dispatch (lease RPC / worker "
                f"startup) or its record lags the ~1s event flush")
        return out

    def rpc_metrics_snapshot(self, conn, arg=None):
        return self.metrics_store.snapshot()

    def rpc_metrics_names(self, conn, arg=None):
        return self.metrics_store.names()

    def rpc_metrics_query(self, conn, arg):
        """arg: {"name", "window_s"?, "step_s"?, "agg"?, "tags"?,
        "merge"?} — the dashboard's /api/metrics/query backend, also
        reachable by any GCS client (state API)."""
        return self.metrics_store.query(**dict(arg or {}))

    def rpc_report_task_demand(self, conn, demand: dict):
        """A driver's task found no feasible node: remember the demand
        briefly (TTL) so the autoscaler sees it (ref: raylet
        resource_demands in autoscaler state)."""
        if not hasattr(self, "task_demands"):
            self.task_demands = []
        t = now()
        self.task_demands = [(d, ts) for d, ts in self.task_demands
                             if t - ts < 10.0]
        self.task_demands.append((dict(demand), t))
        return getattr(self, "autoscaler_active", False)

    def rpc_get_pending_demand(self, conn, arg=None):
        """Aggregate unmet resource demand for the autoscaler (ref:
        gcs_autoscaler_state_manager): PENDING placement groups (bundle
        lists + strategy), PENDING actors, and recently-reported
        infeasible task demands."""
        # prune PENDING PGs whose client stopped polling (gave up/died) —
        # otherwise they'd read as unmet demand forever and the autoscaler
        # would thrash launch/idle-terminate cycles. The window is a
        # config knob (a paused/debugged driver outlives 15s easily) and
        # the prune is a WARNING event, so a vanished PG is diagnosable.
        from ray_tpu_torch._internal.config import get_config

        t = now()
        prune_after = get_config().pg_pending_poll_timeout_s
        for pg_id, pg in list(self.placement_groups.items()):
            if pg.get("state") == "PENDING" and \
                    t - pg.get("last_poll", t) > prune_after:
                idle = t - pg.get("last_poll", t)
                del self.placement_groups[pg_id]
                self.mark_dirty()
                self.record_event(
                    source="gcs", kind="placement_group_pruned",
                    severity="WARNING",
                    message=(f"placement group {pg_id.hex()[:12]} "
                             f"pruned: PENDING with no client poll for "
                             f"{idle:.1f}s (> {prune_after:g}s — driver "
                             f"gone?)"),
                    placement_group_id=pg_id.hex(),
                    idle_s=round(idle, 3))
        # RESCHEDULING PGs (displaced by a dead/draining node) are demand
        # too: their gang needs room on live nodes before the retry loop
        # can re-place it
        pgs = [
            {"pg_id": pg_id, "bundles": pg["bundles"],
             "strategy": pg["strategy"]}
            for pg_id, pg in self.placement_groups.items()
            if pg.get("state") in ("PENDING", "RESCHEDULING")
        ]
        actors = []
        for aid, info in self.actors.items():
            if info.state in (ActorState.PENDING, ActorState.RESTARTING) \
                    and aid not in self._actors_placing:
                spec = self.actor_specs.get(aid)
                demand = dict(spec.resources) if spec is not None else {}
                actors.append(demand or {"CPU": 1.0})
        t = now()
        tasks = [d for d, ts in getattr(self, "task_demands", [])
                 if t - ts < 10.0]
        # a DRAINING node's in-use load is demand-in-waiting: its
        # workloads are about to migrate, so the autoscaler must launch
        # replacement capacity NOW, not after the migration stalls.
        # PG-scoped keys (`CPU_pg_<hex>_<i>`) fold back to their base
        # resource — a fresh node satisfies CPU, never the scoped key.
        draining = []
        for nid, rec in self.draining.items():
            if rec.get("state") != "DRAINING":
                continue
            info = self.nodes.get(nid)
            if info is None or not info.alive:
                continue
            avail = self.node_resources_available.get(nid, {})
            used: dict[str, float] = {}
            for r, tot in info.resources_total.items():
                amt = tot - avail.get(r, 0.0)
                if amt > 1e-9:
                    base = r.split("_pg_", 1)[0]
                    used[base] = used.get(base, 0.0) + amt
            if used:
                draining.append(used)
        return {"placement_groups": pgs, "actors": actors,
                "tasks": tasks, "draining": draining}

    # ---------------------------------------------------------- debugging
    def rpc_cluster_status(self, conn, arg=None):
        """`rayt status` / dashboard `/api/cluster` backend: the summary
        counters plus a per-node table (resources, pending leases,
        heartbeat age), aggregate pending lease demand by shape, the
        scheduling decision rollup, and recent WARNING+ events (the
        `ray status` analog, enriched with the decision-trace feed)."""
        t = now()
        node_rows = []
        for nid, info in self.nodes.items():
            h = nid.hex()
            hb = self.node_last_heartbeat.get(nid)
            drain = self.draining.get(nid)
            if not info.alive:
                state = "DEAD"
            elif drain is not None and drain.get("state") in (
                    "DRAINING", "DRAINED"):
                state = drain["state"]
            else:
                state = "ALIVE"
            node_rows.append({
                "node_id": h,
                "alive": info.alive,
                "state": state,
                "address": (f"{info.address.host}:{info.address.port}"
                            if info.address else ""),
                "labels": dict(info.labels or {}),
                "resources_total": dict(info.resources_total),
                "resources_available": dict(
                    self.node_resources_available.get(nid, {})),
                "heartbeat_age_s": (round(t - hb, 3)
                                    if hb is not None else None),
                "pending_leases":
                    self.event_manager.node_sched(h)["pending"],
            })
        out = {
            "uptime_s": t - self._started,
            "num_nodes": sum(1 for n in self.nodes.values() if n.alive),
            "num_actors": len(self.actors),
            "num_jobs": len(self.jobs),
            "num_placement_groups": len(self.placement_groups),
            "nodes": node_rows,
            "pending_demand": self.event_manager.pending_demand(),
            "scheduling":
                self.event_manager.summarize_scheduling()["totals"],
            "recent_events": self.event_manager.list(
                severity="WARNING", limit=20)["events"],
            "placement_groups": [
                {"placement_group_id": pg_id.hex(),
                 "bundles": pg.get("bundles"),
                 "strategy": pg.get("strategy"),
                 "state": pg.get("state"),
                 "nodes": [n.hex() for n in pg.get("placement") or []]}
                for pg_id, pg in self.placement_groups.items()],
            "drains": {nid.hex(): dict(rec)
                       for nid, rec in self.draining.items()},
            # fair-share ledger (empty when no job opted into quotas)
            "quotas": self.placement_plane.quota_view(),
            "quota_throttled":
                self.event_manager.quota_throttled_totals(),
        }
        # monitor-in-head: head_main attaches the autoscaler so `rayt
        # status` can show the instance lifecycle (ref: `ray status`
        # rendering autoscaler v2 instance states)
        scaler = getattr(self, "autoscaler", None)
        if scaler is not None:
            try:
                out["autoscaler"] = scaler.stats()
            except Exception:
                pass
        return out


class GcsClient:
    """Typed async client for the GCS (ref analog: gcs_client/ accessors).

    Auto-reconnects when the GCS restarts (persistence-backed head): the
    connection's close event schedules a redial loop that also replays
    channel subscriptions, so pubsub-driven flows (actor resolution)
    survive a head restart."""

    def __init__(self, conn: Connection, address: Address | None = None):
        import itertools
        import uuid

        self.conn = conn
        self.address = address
        self._subs: dict[str, list] = {}
        # called (no args, on the reconnect loop) after a successful
        # redial + subscription replay: lets delta publishers reset
        # their baselines — the restarted GCS's stores are empty, so
        # unchanged state must be re-sent in full
        self.on_reconnect: list = []
        self._closing = False
        # stable identity for the server's per-client dedup tables
        self._client_id = uuid.uuid4().hex
        self._dedup_seq = itertools.count()
        if address is not None:
            conn.on_close.append(self._schedule_reconnect)

    @classmethod
    async def connect(cls, address: Address) -> "GcsClient":
        conn = await connect(address.host, address.port)
        return cls(conn, address=address)

    # ------------------------------------------------------- reconnection
    def _schedule_reconnect(self, _conn):
        if self._closing:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return
        asyncio.ensure_future(self._reconnect())

    async def _reconnect(self):
        for _ in range(120):
            if self._closing:
                return
            try:
                conn = await connect(self.address.host, self.address.port,
                                     retries=1)
            except Exception:
                await asyncio.sleep(0.5)
                continue
            conn.on_close.append(self._schedule_reconnect)
            self.conn = conn
            for ch in list(self._subs):
                def dispatch(msg, _ch=ch):
                    for cb in self._subs.get(_ch, []):
                        cb(msg)
                conn.on_notify("pubsub:" + ch, dispatch)
                try:
                    await conn.call("subscribe", ch)
                except Exception:
                    pass
            for cb in list(self.on_reconnect):
                try:
                    cb()
                except Exception:
                    pass
            logger.info("GCS client reconnected")
            return

    # Methods safe to replay verbatim: reads, and conn-bound registrations
    # that the reconnect path must re-execute on the NEW connection.
    _REPLAY_SAFE = frozenset({
        "kv_get", "kv_multi_get", "kv_keys", "kv_exists",
        "get_all_nodes", "get_cluster_resources", "get_all_jobs",
        "get_actor_info", "get_named_actor", "get_all_actors",
        "actor_handle_state", "get_placement_group", "metrics_snapshot",
        "metrics_names", "metrics_query",
        "get_task_events", "list_tasks", "summarize_tasks",
        "list_objects_state", "summarize_objects",
        "list_dags", "summarize_dags",
        "list_cluster_events", "summarize_scheduling", "why_pending",
        "get_pending_demand", "cluster_status", "heartbeat", "subscribe",
        "get_drain_status",
        # placement plane reads: advisory placement decisions reserve
        # nothing, so replaying across a GCS restart is harmless
        "place_gang", "placement_advise_dag", "placement_state",
        "get_cluster_resources_delta",
        # periodic overwrite-style reports: replaying is harmless, and
        # routing them through the dedup envelope would churn the LRU
        "report_task_demand", "add_task_events",
        # pubsub events are best-effort/at-least-once by nature; the
        # 200ms metric batches especially must not churn the dedup LRU
        "publish",
        # conn-bound: GCS stores the calling connection for death
        # detection, so the retry MUST re-execute on the new connection
        # (re-registration is idempotent on the tables)
        "register_node",
    })

    async def call(self, method: str, arg: Any = None,
                   timeout: float | None = None) -> Any:
        """Call with one transparent retry across a GCS restart.

        ONLY ConnectionLost retries — but a connection can drop *after*
        the server executed the handler (and the snapshot flush keeps that
        execution across a restart), so non-idempotent mutations
        (kv_put overwrite=False, register_actor, ...) are wrapped in the
        server's at-most-once ``dedup_call`` envelope: the retry carries
        the same req_id and gets the first execution's cached outcome."""
        from ray_tpu_torch._internal.rpc import ConnectionLost

        if method not in self._REPLAY_SAFE:
            arg = ((self._client_id, next(self._dedup_seq)), method, arg)
            method = "dedup_call"
        try:
            return await self.conn.call(method, arg, timeout=timeout)
        except ConnectionLost:
            if self._closing or self.address is None:
                raise
            # wait for the background reconnect to land, then retry once
            for _ in range(100):
                if not self.conn.closed:
                    break
                await asyncio.sleep(0.1)
            return await self.conn.call(method, arg, timeout=timeout)

    # KV
    async def kv_put(self, key: str, value: bytes, *, namespace: str = "default",
                     overwrite: bool = True) -> bool:
        return await self.call("kv_put", (namespace, key, value, overwrite))

    async def kv_get(self, key: str, *, namespace: str = "default"):
        return await self.call("kv_get", (namespace, key))

    async def kv_del(self, key: str, *, namespace: str = "default") -> bool:
        return await self.call("kv_del", (namespace, key))

    async def kv_keys(self, prefix: str = "", *, namespace: str = "default"):
        return await self.call("kv_keys", (namespace, prefix))

    async def kv_exists(self, key: str, *, namespace: str = "default") -> bool:
        return await self.call("kv_exists", (namespace, key))

    # pubsub
    async def subscribe(self, channel: str, callback):
        self._subs.setdefault(channel, []).append(callback)
        if len(self._subs[channel]) == 1:
            def dispatch(msg, _ch=channel):
                for cb in self._subs.get(_ch, []):
                    cb(msg)
            self.conn.on_notify("pubsub:" + channel, dispatch)
            await self.call("subscribe", channel)

    async def publish(self, channel: str, message: Any):
        await self.call("publish", (channel, message))

    # nodes / cluster
    async def get_all_nodes(self) -> list[NodeInfo]:
        return await self.call("get_all_nodes")

    async def get_cluster_resources(self):
        return await self.call("get_cluster_resources")

    # actors
    async def register_actor(self, spec: TaskSpec):
        return await self.call("register_actor", spec)

    async def actor_handle_state(self, actor_id: ActorID):
        return await self.call("actor_handle_state", actor_id)

    async def get_named_actor(self, name: str, namespace: str = ""):
        return await self.call("get_named_actor", (namespace, name))

    async def kill_actor(self, actor_id: ActorID, no_restart: bool):
        return await self.call("kill_actor", (actor_id, no_restart))

    async def get_all_actors(self):
        return await self.call("get_all_actors")

    async def close(self):
        self._closing = True  # suppress the reconnect loop
        await self.conn.close()
