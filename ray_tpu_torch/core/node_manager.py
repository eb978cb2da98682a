"""NodeManager — the per-node daemon (raylet analog).

Ref analogs: src/ray/raylet/node_manager.h:117 (daemon),
cluster_task_manager.h:42 + local_task_manager.h:58 (lease-based
scheduling with spillback), worker_pool.h:212 (pre-forked pool),
plasma store_runner (the shm object directory lives here).

Scheduling model: callers request a worker *lease* for a resource demand;
the node either grants a local leased worker, replies with a spillback
node (its view of the cluster comes from GCS heartbeats), or queues the
request until resources free up. The "GPU" resource counts the cards on
this host (autodetected at init, _internal/accelerators.py); any other
resource is custom.

Card pinning: every card of the node has a fractional load. A lease of k
whole GPUs takes k free cards, a fractional one packs onto one card, and a
placement-group bundle takes its cards when it is reserved (the bundle's
leases take theirs from those). The worker learns its cards with the grant
(the lease token for a task, the spec for an actor) and sets
CUDA_VISIBLE_DEVICES before it touches CUDA. CUDA reads that variable once
a process, so a worker is reused for a GPU lease only when it already
sees the lease's cards or has never imported torch (any torch.cuda call,
``is_available()`` too, may have read the variable); a CPU-only lease
takes a worker that sees every card of the node, as it did before pinning.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time
from typing import Any

from ray_tpu_torch._internal.config import get_config
from ray_tpu_torch._internal.ids import ActorID, NodeID, ObjectID, WorkerID
from ray_tpu_torch._internal.logging_utils import setup_logger
from ray_tpu_torch._internal.rpc import Connection, RawView, RpcServer, connect
from ray_tpu_torch.core.common import (Address, NodeInfo, TaskSpec,
                                      WorkerInfo, lease_token,
                                      parse_lease_token)
from ray_tpu_torch.core.gcs_event_manager import (CH_EVENTS, make_event,
                                                  shape_key)
from ray_tpu_torch.core.gcs_object_manager import CH_OBJECTS
from ray_tpu_torch.core.object_store import make_shm_store

logger = setup_logger("node_manager")


class _Cards:
    """Cards of one resource key (the node's "GPU", or a reserved bundle's
    "GPU_pg_<id>_<i>") by the names CUDA_VISIBLE_DEVICES gives them, each
    with the share still free (1.0 for a whole card; a bundle holding half
    a card frees 0.5 of it)."""

    def __init__(self, ids, free=None):
        self.ids = list(ids)
        self.free = list(free) if free is not None else [1.0] * len(self.ids)

    def take(self, amount: float) -> list[tuple[int, float]] | None:
        """[(card, share), ...] for `amount` GPUs: its whole part as that
        many wholly free cards, the rest packed onto the fitting card with
        the least room (fractions share a card before they open another);
        None when the cards cannot hold it."""
        whole = int(amount + 1e-9)
        frac = amount - whole
        got = []
        for i, f in enumerate(self.free):
            if len(got) == whole:
                break
            if f >= 1.0 - 1e-9:
                got.append((i, 1.0))
        if len(got) < whole:
            return None
        if frac > 1e-9:
            taken = {i for i, _ in got}
            fits = [i for i, f in enumerate(self.free)
                    if i not in taken and f >= frac - 1e-9]
            if not fits:
                return None
            got.append((min(fits, key=lambda i: self.free[i]), frac))
        for i, share in got:
            self.free[i] -= share
        return got

    def give(self, got) -> None:
        for i, share in got:
            self.free[i] += share

    def available(self) -> float:
        """The GPU these cards still hold, as the node advertises it."""
        return sum(self.free)

    def names(self, got) -> tuple[str, ...]:
        return tuple(self.ids[i] for i, _ in got)


def _node_card_ids(count: float) -> list[str]:
    """The CUDA_VISIBLE_DEVICES names of this node's `count` cards: the
    entries of the node's own CUDA_VISIBLE_DEVICES when it has one (the
    cards autodetect counted), else 0..count-1 (also for a count set by
    hand)."""
    n = int(count + 1e-9)
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is not None:
        ids = [e.strip() for e in visible.split(",") if e.strip()]
        if len(ids) >= n:
            return ids[:n]
    return [str(i) for i in range(n)]


class _Worker:
    def __init__(self, proc: subprocess.Popen, view: tuple = ()):
        self.proc = proc
        # the cards this process sees (CUDA_VISIBLE_DEVICES), as the node
        # names them: every card of the node until a GPU lease pins it
        self.view = view
        # the cards of the current lease ({resource key: [(card, share)]})
        self.lease_cards: dict = {}
        # set once the process may have initialised CUDA under its view
        # (it imported torch): it can then never be pinned to other cards
        self.cuda_fixed = False
        self.info: WorkerInfo | None = None
        self.conn: Connection | None = None
        self.registered = asyncio.Event()
        self.busy = False
        self.actor_id: ActorID | None = None
        self.lease_resources: dict[str, float] | None = None
        # job hex the current lease is charged to (fair-share ledger)
        self.lease_job: str = ""
        self.last_idle = time.monotonic()
        # set by the memory monitor before it terminates the worker:
        # (mem_fraction, rss_bytes) — the reap path turns it into a
        # caused worker_oom_reaped cluster event
        self.oom_reap: tuple | None = None


class _PullManager:
    """Admission-controlled, deduplicated object pulls (ref analog:
    pull_manager.h:52). Bounds the total bytes of objects streaming into
    this node at once (quota); same-object pulls coalesce onto one
    in-flight transfer; chunks of one object are fetched with a bounded
    pipeline depth (ref: object_buffer_pool chunking)."""

    def __init__(self, nm: "NodeManager"):
        self.nm = nm
        self._inflight: dict[ObjectID, asyncio.Future] = {}
        self._used_bytes = 0
        # FIFO admission queue: (size, future). Strict ordering so an
        # oversize pull can't be starved by later small pulls barging in.
        self._admit_queue: list = []
        self.pulled_objects = 0
        self.pulled_bytes = 0

    async def pull(self, oid: ObjectID, size: int, owner,
                   remote_addr: Address) -> bool:
        while True:
            if self.nm.shm.contains_locally(oid):
                return True
            fut = self._inflight.get(oid)
            if fut is None:
                break
            try:
                return await asyncio.shield(fut)
            except asyncio.CancelledError:
                if fut.cancelled():
                    continue  # the LEADER was cancelled: take over
                raise  # this waiter itself was cancelled
        fut = asyncio.get_running_loop().create_future()
        self._inflight[oid] = fut
        try:
            ok = await self._admitted_pull(oid, size, owner, remote_addr)
        except asyncio.CancelledError:
            # wake coalesced waiters so one of them becomes the new leader
            self._inflight.pop(oid, None)
            if not fut.done():
                fut.cancel()
            raise
        except Exception as e:
            logger.warning("pull of %s from %s failed: %s",
                           oid, remote_addr, e)
            ok = False
        finally:
            self._inflight.pop(oid, None)
        if not fut.done():
            fut.set_result(ok)
        return ok

    def _fits(self, size: int) -> bool:
        # oversize objects are admitted alone (a strict quota check would
        # deadlock them)
        quota = get_config().pull_max_inflight_bytes
        return self._used_bytes == 0 \
            or self._used_bytes + size <= quota

    def _drain_admit_queue(self):
        while self._admit_queue:
            size, fut = self._admit_queue[0]
            if fut.done():  # cancelled waiter
                self._admit_queue.pop(0)
                continue
            if not self._fits(size):
                break  # strict FIFO: later pulls wait behind the head
            self._admit_queue.pop(0)
            self._used_bytes += size
            fut.set_result(True)

    async def _admitted_pull(self, oid, size, owner, remote_addr) -> bool:
        if not self._admit_queue and self._fits(size):
            self._used_bytes += size
        else:
            fut = asyncio.get_running_loop().create_future()
            self._admit_queue.append((size, fut))
            try:
                await fut
            except asyncio.CancelledError:
                if fut.done() and not fut.cancelled():
                    # admission was granted (quota charged by
                    # _drain_admit_queue) before the cancel landed:
                    # release it or the quota leaks permanently
                    self._used_bytes -= size
                    self._drain_admit_queue()
                else:
                    self._admit_queue[:] = [
                        (sz, f) for sz, f in self._admit_queue
                        if f is not fut]
                raise
        try:
            return await self._transfer(oid, size, owner, remote_addr)
        finally:
            self._used_bytes -= size
            self._drain_admit_queue()

    async def _transfer(self, oid, size, owner, remote_addr) -> bool:
        cfg = get_config()
        chunk = max(1, cfg.object_transfer_chunk_bytes)
        loop = asyncio.get_running_loop()
        c = await connect(remote_addr.host, remote_addr.port)
        created = False
        try:
            if size <= chunk:
                data = await c.call("fetch_object", oid, timeout=120)
                if data is None:
                    return False
                await loop.run_in_executor(
                    None, self.nm._store_pulled, oid, [data], size, owner)
            else:
                # Allocate the destination first, then stream each chunk
                # straight into it as it arrives — resident heap stays
                # ~chunk * max_inflight, not the whole object (the 100 GiB
                # get envelope; ref object_buffer_pool.h).
                created = await loop.run_in_executor(
                    None, self.nm._prepare_pull_segment, oid, size)
                if not created:
                    # another transfer/restore of the same object is (or
                    # finished) writing it — treat as satisfied
                    return True
                sem = asyncio.Semaphore(
                    max(1, cfg.object_transfer_max_inflight_chunks))
                write_futs: list = []

                async def fetch(i: int, off: int):
                    async with sem:
                        d = await c.call(
                            "fetch_chunk",
                            (oid, off, min(chunk, size - off)),
                            timeout=120)
                        if d is None:
                            raise LookupError(f"chunk {i} of {oid} missing")
                        f = loop.run_in_executor(
                            None, self.nm.shm.write_at, oid, off, d)
                        write_futs.append(f)
                        await f

                tasks = [asyncio.ensure_future(fetch(i, off))
                         for i, off in enumerate(range(0, size, chunk))]
                try:
                    await asyncio.gather(*tasks)
                except BaseException:
                    # sibling fetches may still be writing into the
                    # segment; every started executor write MUST finish
                    # before the abort path frees it (a write into a
                    # freed+reallocated arena block would corrupt another
                    # object). Cancelling a task abandons its await, not
                    # the thread job — drain write_futs explicitly.
                    for t in tasks:
                        t.cancel()
                    await asyncio.gather(*tasks, return_exceptions=True)
                    await asyncio.gather(*write_futs,
                                         return_exceptions=True)
                    raise
                await loop.run_in_executor(
                    None, self.nm._finish_pull_segment, oid, size, owner)
                created = False  # sealed: no abort on close path
        except LookupError:
            return False  # remote no longer has (part of) the object
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.warning("chunked fetch of %s failed (%s)", oid, e)
            return False
        finally:
            if created:  # failed/cancelled mid-stream: drop the partial
                try:
                    self.nm.shm.abort_unsealed(oid)
                except Exception:
                    pass
            await c.close()
        self.pulled_objects += 1
        self.pulled_bytes += size
        return True


class NodeManager:
    def __init__(self, node_id: NodeID, resources: dict[str, float],
                 gcs_address: Address, labels: dict[str, str] | None = None):
        self.node_id = node_id
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.gcs_address = gcs_address
        # explicit labels win; topology labels (ici-slice from the
        # slice-head custom resource or RAYT_ICI_SLICE, dcn-locality
        # from RAYT_DCN_LOCALITY) fill the gaps so every node advertises
        # its position to the placement plane (core/placement.py)
        from ray_tpu_torch.core.placement import topology_labels

        self.labels = dict(labels or {})
        for k, v in topology_labels(self.resources_total).items():
            self.labels.setdefault(k, v)
        self.server = RpcServer()
        self.server.add_service(self)
        self.address: Address | None = None
        self.gcs_conn: Connection | None = None
        self.workers: dict[WorkerID, _Worker] = {}
        self._unregistered: list[_Worker] = []
        self._doomed: list[_Worker] = []  # terminated, awaiting reap
        self.shm = make_shm_store(node_id)
        # object directory: id -> {"size": int, "owner": WorkerInfo,
        #                          "spilled": path|None}
        self.object_dir: dict[ObjectID, dict] = {}
        # insertion order doubles as spill order (oldest first)
        self._spilled_bytes = 0
        self._spill_count = 0
        self._restore_count = 0
        self._oom_kills = 0
        # (demand, future, job_hex) — job_hex "" when the caller
        # predates the quota-aware lease wire format
        self._pending_leases: list[
            tuple[dict, asyncio.Future, str]] = []
        # fair-share quota view synced from the GCS with the resource
        # view: {job_hex: {"resource","share","used","weight","floor"}}
        self._quota_view: dict[str, dict] = {}
        # per-job quota-throttle verdict deltas since the last
        # successful sched-report publish
        self._quota_throttled_deltas: dict[str, int] = {}
        self._pg_reserved: dict[tuple, dict[str, float]] = {}
        self._pg_prepared: dict[tuple, dict[str, float]] = {}
        # card pinning: the node's cards, and each reserved bundle's
        self._cards: dict[str, _Cards] = {}
        if self.resources_total.get("GPU", 0.0) >= 1.0 - 1e-9:
            self._cards["GPU"] = _Cards(
                _node_card_ids(self.resources_total["GPU"]))
        self._all_cards = tuple(self._cards["GPU"].ids
                                if "GPU" in self._cards else ())
        self._pg_cards: dict[tuple, dict] = {}
        self._cluster_view: dict = {}
        self._view_version = 0         # last-seen GCS resource version
        self._hb_last_sent: dict | None = None  # delta-heartbeat baseline
        # serializes delta sends: two concurrent pushes reading the same
        # baseline would leave the GCS view diverged until the next real
        # change (the full-view protocol was self-healing; deltas aren't)
        self._hb_lock = asyncio.Lock()
        self._spread_counter = 0
        self._last_metrics_pub = 0.0
        self._stopping = False
        self._tasks: list[asyncio.Task] = []
        # short-lived fire-and-forget relays (job-finished code
        # eviction); self-cleaning via done-callbacks
        self._relays: set[asyncio.Task] = set()
        self._pull_manager = _PullManager(self)
        self._restore_futs: dict[ObjectID, asyncio.Future] = {}
        self._push_sem: asyncio.Semaphore | None = None
        # task lifecycle events this daemon emits (actor-creation
        # dispatch; ref: raylet-side task events feeding
        # gcs_task_manager) — flushed on the heartbeat cadence
        from ray_tpu_torch._internal.tracing import TaskEventBuffer

        self.task_events = TaskEventBuffer(node_id.hex(), node_id.hex())
        import threading

        self._spill_lock = threading.Lock()
        # object-plane observability: last-published directory snapshot
        # + store stats for delta publishes on the heartbeat cadence
        self._object_state_enabled = get_config().object_state_enabled
        self._objects_published: dict[str, dict] = {}
        self._store_stats_published: dict | None = None
        self._store_stats_cache: tuple[float, dict | None] = (0.0, None)
        # set by every object_dir mutation: the publisher only rebuilds
        # + diffs the directory view when something actually changed
        # (an idle tick stays O(1) instead of O(objects))
        self._objects_dirty = True
        # scheduling-plane observability: per-demand-shape lease
        # decision deltas (coalesced locally, shipped to the GCS event
        # manager on the heartbeat cadence) + the structured cluster
        # event buffer (worker crash/OOM-reap etc.)
        self._cluster_events_enabled = get_config().cluster_events_enabled
        self._sched_decisions: dict[str, dict] = {}
        self._sched_dirty = False
        self._sched_pending_published: dict | None = None
        self._event_buf: list[dict] = []

    # ------------------------------------------------------------ lifecycle
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Address:
        port = await self.server.start(host, port)
        self.address = Address(host, port)
        # Bidirectional: the GCS pushes start_actor / pg_* requests back
        # over this persistent connection, so install our handler table.
        self.gcs_conn = await connect(self.gcs_address.host,
                                      self.gcs_address.port,
                                      handlers=self.server.handlers)
        info = NodeInfo(
            node_id=self.node_id, address=self.address,
            resources_total=dict(self.resources_total), labels=dict(self.labels))
        await self.gcs_conn.call("register_node", info)
        # job teardown: evict the finished job's loaded code from every
        # pooled worker on this node (their fn-cache LRUs outlive jobs)
        self.gcs_conn.on_notify("pubsub:job_finished", self._on_job_finished)
        await self.gcs_conn.call("subscribe", "job_finished")
        self._tasks.append(asyncio.ensure_future(self._heartbeat_loop()))
        self._tasks.append(asyncio.ensure_future(self._reap_loop()))
        if get_config().object_spilling_threshold > 0:
            self._tasks.append(asyncio.ensure_future(self._spill_loop()))
        self._tasks.append(asyncio.ensure_future(self._memory_monitor_loop()))
        cfg = get_config()
        if cfg.preemption_notice_file:
            self._tasks.append(
                asyncio.ensure_future(self._preemption_watch_loop()))
        for _ in range(cfg.idle_worker_pool_size):
            self._spawn_worker()
        logger.info("node manager %s up at %s", self.node_id, self.address)
        return self.address

    async def stop(self):
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for w in list(self.workers.values()) + self._unregistered + self._doomed:
            try:
                w.proc.terminate()
            except Exception:
                pass
        for w in list(self.workers.values()) + self._unregistered + self._doomed:
            try:
                w.proc.wait(timeout=3)
            except Exception:
                try:
                    w.proc.kill()
                except Exception:
                    pass
        for oid in list(self.object_dir):
            self.shm.unlink(oid)
        if hasattr(self.shm, "destroy_self"):
            self.shm.destroy_self()  # drop the node's arena segment
        if self.gcs_conn is not None:
            await self.gcs_conn.close()
        await self.server.stop()

    async def _heartbeat_loop(self):
        """Streaming resource sync (ref: ray_syncer.h delta broadcast):
        upstream sends only resource keys that changed since the last
        ack'd send; downstream pulls only view entries changed since the
        last-seen version. An idle cluster's sync traffic is a liveness
        ping + an empty delta, independent of node count."""
        while not self._stopping:
            try:
                await self._push_heartbeat()
                await self._refresh_view()
                await self._publish_node_metrics()
                await self._publish_object_state()
                await self._publish_sched_state()
                await self._flush_events()
                await self._flush_task_events()
            except Exception:
                if self.gcs_conn is not None and self.gcs_conn.closed \
                        and not self._stopping:
                    await self._reconnect_gcs()
            await asyncio.sleep(get_config().gcs_health_check_period_s)

    async def _publish_node_metrics(self):
        """Resource-utilization gauges onto the GCS metrics channel (ref
        analog: the per-node metrics agent's node gauges). This process
        has no core worker, so it publishes raw records directly on the
        persistent GCS connection, throttled to node_metrics_period_s."""
        t = time.time()
        if t - self._last_metrics_pub < get_config().node_metrics_period_s:
            return
        self._last_metrics_pub = t
        from ray_tpu_torch.util.builtin_metrics import node_gauge_records
        from ray_tpu_torch.util.metrics import CH_METRICS

        try:
            store_bytes = self._unspilled_bytes()
            store_cap = self._store_capacity()
        except Exception:
            store_bytes, store_cap = 0, 0
        recs = node_gauge_records(
            self.node_id.hex(),
            resources_total=self.resources_total,
            resources_available=self.resources_available,
            num_workers=len(self.workers),
            object_store_bytes=store_bytes,
            object_store_capacity=store_cap, ts=t)
        if self._object_state_enabled:
            from ray_tpu_torch.util.builtin_metrics import \
                object_store_gauge_records

            try:
                recs.extend(object_store_gauge_records(
                    self.node_id.hex(), self._store_stats(), ts=t))
            except Exception:
                pass
        try:
            await self.gcs_conn.call("publish", (CH_METRICS, recs))
        except Exception:
            pass  # metrics are best-effort; heartbeats carry liveness

    # --------------------------------------------- object-state reporting
    def _store_stats(self) -> dict:
        """Store-level snapshot for the object report + Prometheus
        gauges: directory-derived byte totals plus the store's own
        segment/zombie/fallback counters (ShmObjectStore.stats /
        NativeArenaStore.stats). Cached briefly — the metrics publisher
        and the object-state publisher both read it each heartbeat
        tick, and the arena's fallback-dir scan stats every file."""
        t = time.monotonic()
        cached_at, cached = self._store_stats_cache
        if cached is not None and t - cached_at < 0.5:
            return cached
        stats = {
            "capacity_bytes": self._store_capacity(),
            "used_bytes": self._unspilled_bytes(),
            "pinned_bytes": sum(
                m.get("size", 0) for m in list(self.object_dir.values())
                if m.get("pinned") and not m.get("spilled")),
            "spilled_bytes": self._spilled_bytes,
            "num_objects": len(self.object_dir),
            "num_spilled": self._spill_count,
            "num_restored": self._restore_count,
        }
        snap = getattr(self.shm, "stats", None)
        if snap is not None:
            try:
                stats.update(snap())
            except Exception:
                pass
        self._store_stats_cache = (t, stats)
        return stats

    def _object_report(self) -> dict[str, dict]:
        """Current object-directory view keyed by oid hex (the unit the
        delta publisher diffs)."""
        out: dict[str, dict] = {}
        for oid, meta in list(self.object_dir.items()):
            owner = meta.get("owner")
            out[oid.hex()] = {
                "size": meta.get("size", 0),
                "job": oid.job_id().hex(),
                "owner": owner.worker_id.hex() if owner is not None else "",
                "spilled": bool(meta.get("spilled")),
                "pinned": bool(meta.get("pinned")),
                "callsite": meta.get("callsite", ""),
                "created_at": meta.get("created_at", 0.0),
            }
        return out

    async def _publish_object_state(self):
        """Ship object-directory deltas + store stats to the GCS object
        manager over the shared pubsub channel (ref analog: the raylet
        reporting local object info to gcs_object_manager.h). Rides the
        heartbeat cadence; an idle directory publishes nothing."""
        if not self._object_state_enabled:
            return
        stats = self._store_stats()
        if not self._objects_dirty \
                and stats == self._store_stats_published:
            return
        # clear BEFORE building: a directory mutation that lands during
        # the publish await re-sets the flag and republishes next tick
        # (clearing after the await would eat that mutation whenever the
        # store stats happen to be byte-identical)
        self._objects_dirty = False
        cur = self._object_report()
        changed = {k: v for k, v in cur.items()
                   if self._objects_published.get(k) != v}
        removed = [k for k in self._objects_published if k not in cur]
        if not changed and not removed \
                and stats == self._store_stats_published:
            return
        msg = {"kind": "node", "node": self.node_id.hex(),
               "ts": time.time(), "objects": changed, "removed": removed,
               "store": stats}
        try:
            await self.gcs_conn.call("publish", (CH_OBJECTS, msg))
        except Exception:
            self._objects_dirty = True  # delta not delivered: retry
            raise
        self._objects_published = cur
        self._store_stats_published = stats

    async def _flush_task_events(self):
        events = self.task_events.drain()
        if not events:
            return
        try:
            await self.gcs_conn.call("add_task_events", events)
        except Exception:
            pass  # best-effort: lifecycle events are telemetry

    # ------------------------------------- cluster events + sched traces
    def _emit_event(self, kind: str, message: str,
                    severity: str = "INFO", job_id: str = "", **data):
        """Buffer a structured cluster event for the GCS event manager.
        INFO rides the next heartbeat tick; WARNING+ schedules an
        immediate flush so chaos (worker crash, OOM reap) shows up as a
        caused, named event without waiting out the cadence."""
        if not self._cluster_events_enabled:
            return
        self._event_buf.append(make_event(
            source="node_manager", kind=kind, message=message,
            severity=severity, job_id=job_id,
            node_id=self.node_id.hex(), data=data))
        if len(self._event_buf) > 1000:  # bound a disconnected burst
            del self._event_buf[:len(self._event_buf) - 1000]
        if severity in ("WARNING", "ERROR"):
            try:
                asyncio.get_running_loop()
            except RuntimeError:
                return
            asyncio.ensure_future(self._flush_events())

    async def _flush_events(self):
        if not self._event_buf:
            return
        buf, self._event_buf = self._event_buf, []
        try:
            await self.gcs_conn.call("publish", (CH_EVENTS, buf))
        except Exception:
            # not delivered: put the batch back in front for the next
            # tick (order preserved; the 1000-event bound still holds)
            self._event_buf = buf + self._event_buf

    def _record_decision(self, demand: dict, strategy, verdict: str, *,
                         reason: str = "", hop: int = 0,
                         queue_wait_s: float = 0.0, candidates=None):
        """Coalesce one request_lease verdict into the per-demand-shape
        delta record the heartbeat report ships. Hot-path cost is a
        dict update; the wire dict materializes at publish time."""
        if not self._cluster_events_enabled:
            return
        sk = shape_key(demand)
        d = self._sched_decisions.get(sk)
        if d is None:
            if len(self._sched_decisions) >= 256:
                return  # shape-cardinality bound (pathological demands)
            d = self._sched_decisions[sk] = {
                "demand": dict(demand),
                "granted": 0, "queued": 0, "spillback": 0,
                "infeasible": 0, "cancelled": 0,
                "queue_wait_s": 0.0, "queue_wait_max_s": 0.0,
                "max_spill_hops": 0, "last_reason": "",
                "last_candidates": None, "recent": [],
            }
        d[verdict] = d.get(verdict, 0) + 1
        if queue_wait_s > 0.0:
            d["queued"] += 1
            d["queue_wait_s"] += queue_wait_s
            d["queue_wait_max_s"] = max(d["queue_wait_max_s"],
                                        queue_wait_s)
        if verdict == "spillback":
            d["max_spill_hops"] = max(d["max_spill_hops"], hop + 1)
        if reason:
            d["last_reason"] = reason
        if candidates is not None:
            d["last_candidates"] = candidates
        if len(d["recent"]) < 32:
            d["recent"].append({
                "ts": time.time(), "node": self.node_id.hex(),
                "verdict": verdict, "strategy": str(strategy or ""),
                "hop": hop, "queue_wait_s": round(queue_wait_s, 4),
                "reason": reason})
        self._sched_dirty = True

    def _candidate_views(self, demand: dict, max_nodes: int = 8) -> dict:
        """Per-node feasibility snapshot recorded on non-grant verdicts
        (what this node SAW when it decided): demanded-resource
        availability, fits-now, fits-ever. Bounded — a trace entry, not
        a cluster dump."""
        def fits(avail):
            return all(avail.get(r, 0.0) >= amt - 1e-9
                       for r, amt in demand.items())

        out = {self.node_id.hex(): {
            "local": True,
            "available": {r: round(self.resources_available.get(r, 0.0),
                          3) for r in demand},
            "fits_now": fits(self.resources_available),
            "fits_ever": self._can_ever_satisfy(demand),
        }}
        for nid_hex, view in self._cluster_view.items():
            if len(out) >= max_nodes:
                break
            if nid_hex == self.node_id.hex() or not view.get("alive"):
                continue
            avail = view.get("available") or {}
            total = view.get("total") or {}
            out[nid_hex] = {
                "available": {r: round(avail.get(r, 0.0), 3)
                              for r in demand},
                "fits_now": fits(avail),
                "fits_ever": fits(total),
            }
        return out

    async def _publish_sched_state(self):
        """Ship the coalesced decision deltas + live pending-lease
        queue state to the GCS event manager on the heartbeat cadence.
        An idle scheduler with an unchanged queue publishes nothing."""
        if not self._cluster_events_enabled:
            return
        pending_shapes: dict[str, dict] = {}
        n_pending = 0
        for demand, fut, _job in self._pending_leases:
            if fut.done():
                continue
            n_pending += 1
            sk = shape_key(demand)
            entry = pending_shapes.setdefault(
                sk, {"count": 0, "demand": dict(demand)})
            entry["count"] += 1
        # absolute per-job leased usage on this node (base resource
        # keys — PG-scoped keys fold back so quota math sees CPU, not
        # CPU_pg_<hex>_<i>); the GCS event manager aggregates these
        # node ledgers into the quota plane's cluster-wide "used"
        pend = {"pending": n_pending, "pending_shapes": pending_shapes,
                "job_usage": self._job_usage_ledger()}
        if not self._sched_dirty \
                and pend == self._sched_pending_published:
            return
        decisions, self._sched_decisions = self._sched_decisions, {}
        throttled = self._quota_throttled_deltas
        self._quota_throttled_deltas = {}
        self._sched_dirty = False
        msg = {"type": "sched_report", "node": self.node_id.hex(),
               "ts": time.time(), "decisions": decisions,
               "quota_throttled": throttled, **pend}
        try:
            await self.gcs_conn.call("publish", (CH_EVENTS, msg))
        except Exception:
            for j, n in throttled.items():
                self._quota_throttled_deltas[j] = \
                    self._quota_throttled_deltas.get(j, 0) + n
            # deltas not delivered: merge back and retry next tick
            for sk, d in decisions.items():
                cur = self._sched_decisions.get(sk)
                if cur is None:
                    self._sched_decisions[sk] = d
                    continue
                for c in ("granted", "queued", "spillback",
                          "infeasible", "cancelled"):
                    cur[c] += d[c]
                cur["queue_wait_s"] += d["queue_wait_s"]
                cur["queue_wait_max_s"] = max(cur["queue_wait_max_s"],
                                              d["queue_wait_max_s"])
                cur["max_spill_hops"] = max(cur["max_spill_hops"],
                                            d["max_spill_hops"])
                cur["recent"] = (d["recent"]
                                 + cur["recent"])[:32]
            self._sched_dirty = True
            raise
        self._sched_pending_published = pend

    async def _refresh_view(self):
        resp = await self.gcs_conn.call("get_cluster_resources_delta",
                                        self._view_version)
        # quota view rides every delta reply (empty when no job has a
        # quota) — fair-share enforcement tracks the same sync cadence
        self._quota_view = resp.get("quota") or {}
        if resp["full"] is not None:
            self._cluster_view = resp["full"]
        else:
            self._cluster_view.update(resp["changed"])
            for nid_hex in resp["removed"]:
                self._cluster_view.pop(nid_hex, None)
        self._view_version = resp["version"]

    async def _reconnect_gcs(self):
        """The GCS died (head restart). Reconnect and re-register this
        node so a persistence-backed head rebuilds its live view (ref:
        python/ray/tests/test_gcs_fault_tolerance.py semantics)."""
        try:
            old = self.gcs_conn
            self.gcs_conn = await connect(self.gcs_address.host,
                                          self.gcs_address.port,
                                          handlers=self.server.handlers,
                                          retries=2)
            if old is not None and not old.closed:
                await old.close()
            info = NodeInfo(
                node_id=self.node_id, address=self.address,
                resources_total=dict(self.resources_total),
                labels=dict(self.labels))
            await self.gcs_conn.call("register_node", info)
            # the restarted GCS has a fresh version counter and no view
            # of us: resync from scratch (full heartbeat, full view
            # pull). The old view is dropped NOW — a node the new GCS
            # never heard of would otherwise survive as an alive ghost
            # entry that spillback keeps routing to.
            self._view_version = 0
            self._hb_last_sent = None
            self._cluster_view = {}
            # the restarted GCS's object manager is empty: resend the
            # full directory on the next heartbeat, not just deltas
            self._objects_published = {}
            self._store_stats_published = None
            # ...and its event manager lost this node's pending-lease
            # report: republish even if the queue state is unchanged
            self._sched_pending_published = None
            logger.info("re-registered with restarted GCS")
        except Exception:
            pass

    async def _reap_loop(self):
        """Detect worker process deaths (ref: raylet worker death watch)."""
        while not self._stopping:
            for w in list(self.workers.values()):
                if w.proc.poll() is not None:
                    await self._on_worker_death(w)
            self._unregistered = [w for w in self._unregistered
                                  if w.proc.poll() is None]
            self._doomed = [w for w in self._doomed
                            if w.proc.poll() is None]
            await asyncio.sleep(0.1)

    def _on_job_finished(self, job_hex: str):
        """pubsub relay: tell every live pooled worker to drop the
        finished job's function-cache entries (best effort — a worker
        that misses the evict just pays LRU pressure later). The relay
        futures are short-lived and self-cleaning (self._tasks holds
        only the long-lived loops stop() must cancel)."""
        for w in list(self.workers.values()):
            if w.conn is not None and not w.conn.closed:
                t = asyncio.ensure_future(
                    self._evict_job_code(w.conn, job_hex))
                self._relays.add(t)
                t.add_done_callback(self._relays.discard)

    async def _evict_job_code(self, conn, job_hex: str):
        try:
            await conn.call("evict_job_code", job_hex, timeout=10)
        except Exception:
            pass  # worker mid-death: nothing to evict

    async def _on_worker_death(self, w: _Worker):
        if w.info is not None:
            self.workers.pop(w.info.worker_id, None)
        if w.lease_resources:
            self._release_resources(w.lease_resources, w.lease_cards)
            w.lease_resources = None
            w.lease_cards = {}
            # queued lease requests may now fit (e.g. tasks submitted
            # right after a fleet of pool actors was killed)
            self._maybe_grant_pending()
        if w.actor_id is not None:
            try:
                await self.gcs_conn.call(
                    "report_actor_failure",
                    (w.actor_id,
                     f"worker process exited with code {w.proc.returncode}",
                     w.info.worker_id if w.info else None))
            except Exception:
                pass
        if self._object_state_enabled and w.info is not None:
            # the dead worker's published get-pins/leak flags will never
            # see removal deltas: tell the GCS object manager directly
            try:
                await self.gcs_conn.call(
                    "publish", (CH_OBJECTS, {
                        "kind": "worker_dead",
                        "worker": w.info.worker_id.hex()}))
            except Exception:
                pass
        wid = w.info.worker_id.hex() if w.info else ""
        if w.oom_reap is not None:
            # the same reap path PR 6 instruments for object cleanup —
            # chaos runs need the CAUSE, with the RSS measured at reap
            # time, not just the cleanup
            frac, rss = w.oom_reap
            self._emit_event(
                "worker_oom_reaped",
                f"worker {wid[:12]} (pid {w.proc.pid}) OOM-reaped at "
                f"{frac * 100:.0f}% node memory, rss "
                f"{rss / 1e6:.1f} MB (task will retry)",
                severity="WARNING", worker_id=wid, pid=w.proc.pid,
                rss_bytes=rss, memory_fraction=round(frac, 4),
                exit_code=w.proc.returncode,
                actor_id=w.actor_id.hex() if w.actor_id else "")
        else:
            self._emit_event(
                "worker_died",
                f"worker {wid[:12]} (pid {w.proc.pid}) died with exit "
                f"code {w.proc.returncode}"
                + (f" while running actor {w.actor_id.hex()[:12]}"
                   if w.actor_id else (" while leased" if w.busy
                                       else "")),
                severity="WARNING", worker_id=wid, pid=w.proc.pid,
                exit_code=w.proc.returncode,
                actor_id=w.actor_id.hex() if w.actor_id else "")
        logger.warning("worker %s died (code %s)",
                       w.info.worker_id if w.info else "?", w.proc.returncode)

    # ---------------------------------------------------------- worker pool
    def _spawn_worker(self) -> _Worker:
        from ray_tpu_torch._internal.spawn import child_env, fast_python_argv

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = child_env(pkg_root)
        env["RAYT_CONFIG_JSON"] = get_config().to_json()
        env["RAYT_NODE_ID"] = self.node_id.hex()
        # workers must use the same store flavor as this node manager
        env["RAYT_SHM_MODE"] = (
            "native" if type(self.shm).__name__ == "NativeArenaStore"
            else "segments")
        env["RAYT_NODE_ADDR"] = f"{self.address.host}:{self.address.port}"
        env["RAYT_GCS_ADDR"] = f"{self.gcs_address.host}:{self.gcs_address.port}"
        # a new worker sees every card of the node; its first GPU lease
        # pins it (CUDA_VISIBLE_DEVICES, set by the worker from the grant)
        proc = subprocess.Popen(
            fast_python_argv("ray_tpu_torch.core.worker_main"),
            env=env, stdin=subprocess.DEVNULL)
        w = _Worker(proc, self._all_cards)
        self._unregistered.append(w)
        return w

    async def rpc_register_worker(self, conn: Connection, arg):
        info, pid = arg
        w = next((c for c in self._unregistered if c.proc.pid == pid), None)
        if w is None:
            w = next((c for c in self._unregistered if c.info is None), None)
        if w is None:
            w = _Worker(proc=_FakeProc(), view=self._all_cards)
            self._unregistered.append(w)
        # Claim (set info) before the await so a concurrent registration
        # can't grab this entry via the info-is-None fallback; stay in
        # _unregistered so _replenish_pool keeps counting it as "starting".
        # conn must be live before the worker enters self.workers
        # (claimable), else a concurrent lease grant sees conn=None.
        w.info = info
        try:
            w.conn = await connect(info.address.host, info.address.port)
        except Exception as e:
            logger.warning("node manager pid %d could not reach registering "
                           "worker pid %s at %s: %r", os.getpid(), pid,
                           info.address, e)
            if w in self._unregistered:
                self._unregistered.remove(w)
            try:
                w.proc.terminate()  # unreachable worker: don't leak it
            except Exception:
                pass
            self._doomed.append(w)
            raise
        if w in self._unregistered:
            self._unregistered.remove(w)
        self.workers[info.worker_id] = w
        w.registered.set()
        self._emit_event(
            "worker_started",
            f"worker {info.worker_id.hex()[:12]} (pid {w.proc.pid}) "
            f"registered", worker_id=info.worker_id.hex(),
            pid=w.proc.pid)
        self._maybe_grant_pending()
        return True

    def _try_claim_idle(self, view: tuple | None = None,
                        repin: bool = False) -> _Worker | None:
        """Atomically (no awaits) claim an idle worker. Callers across await
        points must use this so two concurrent lease grants can't both pick
        the same worker (which would co-locate a task with an actor and
        deadlock its executor). It must see the cards `view` (every card
        of the node when None); with `repin`, one that sees other cards
        and may still be pinned anew (it never imported torch, as far as
        the node knows) is claimed instead."""
        want = self._all_cards if view is None else view
        for w in self.workers.values():
            if not w.busy and w.actor_id is None and w.conn is not None \
                    and (w.view == want if not repin
                         else w.view != want and not w.cuda_fixed):
                w.busy = True
                self._replenish_pool()
                return w
        return None

    async def _claim_for_cards(self, view: tuple) -> _Worker | None:
        """An idle worker that can serve a lease of the cards `view`: one
        that sees them already, else one whose process has not imported
        torch (asked over its connection), which the grant pins anew. A
        worker found with torch imported keeps its view for good."""
        w = self._try_claim_idle(view)
        if w is not None:
            return w
        while True:
            w = self._try_claim_idle(view, repin=True)
            if w is None:
                return None
            try:
                touched = await w.conn.call("cuda_initialized", None,
                                            timeout=10)
            except Exception:
                touched = True
            if not touched:
                return w
            w.cuda_fixed = True
            w.busy = False

    def _replenish_pool(self):
        """Keep idle_worker_pool_size workers warm (ref: worker_pool.h:212
        prestart) so actor/task starts don't pay interpreter cold-boot.
        Workers a GPU lease pinned to some of the node's cards do not
        count: a CPU-only lease takes none of them."""
        if self._stopping:
            return
        target = get_config().idle_worker_pool_size
        idle = sum(1 for w in self.workers.values()
                   if not w.busy and w.actor_id is None
                   and w.view == self._all_cards)
        starting = len(self._unregistered)
        for _ in range(target - idle - starting):
            self._spawn_worker()

    async def _claim(self, view: tuple | None) -> _Worker | None:
        """An idle worker for a lease of the cards `view` (None: a
        CPU-only lease, which takes one that sees every card)."""
        if view is None:
            return self._try_claim_idle()
        return await self._claim_for_cards(view)

    async def _get_idle_worker(self, timeout_s: float | None = None,
                               view: tuple | None = None) -> _Worker:
        """An idle worker for a lease of the cards `view` (None: a
        CPU-only lease), started if none is free."""
        w = await self._claim(view)
        if w is not None:
            return w
        cfg = get_config()
        deadline = time.monotonic() + (
            cfg.worker_startup_timeout_s if timeout_s is None
            else min(timeout_s, cfg.worker_startup_timeout_s))
        # Boot-storm throttle (ref analog: raylet worker-pool prestart
        # throttling): bound CONCURRENTLY-BOOTING workers so a fleet of
        # actor creations doesn't fork N jax-importing processes at once
        # and thrash small hosts; queued creations claim workers as they
        # register.
        while len(self._unregistered) >= cfg.max_concurrent_worker_boots:
            if time.monotonic() >= deadline:
                raise TimeoutError("worker startup queue timed out")
            await asyncio.sleep(0.05)
            cand = await self._claim(view)
            if cand is not None:
                return cand
        spawned = self._spawn_worker()
        while time.monotonic() < deadline:
            if spawned.info is not None and spawned.conn is not None \
                    and not spawned.busy:
                spawned.busy = True
                return spawned
            # registration may have been matched to another _Worker entry
            # (or another lease took this one): claim any idle one that can
            # serve the lease
            cand = await self._claim(view)
            if cand is not None:
                return cand
            if spawned.proc.poll() is not None:
                raise RuntimeError("worker died during startup")
            await asyncio.sleep(0.02)
        raise TimeoutError("worker startup timed out")

    # ------------------------------------------------------------ resources
    def _try_acquire(self, demand: dict[str, float]) -> dict | None:
        """Take `demand` from the free resources, with the cards of its
        GPU keys: -> {resource key: [(card, share), ...]} (empty without
        a GPU), or None when it does not fit now. A key with cards has
        its free amount from them alone (``_Cards.available``)."""
        for r, amt in demand.items():
            if r not in self._cards and \
                    self.resources_available.get(r, 0.0) < amt - 1e-9:
                return None
        cards: dict = {}
        for r, amt in demand.items():
            pool = self._cards.get(r)
            if pool is None or amt <= 0:
                continue
            got = pool.take(amt)
            if got is None:
                for key, taken in cards.items():
                    self._cards[key].give(taken)
                return None
            cards[r] = got
        for r, amt in demand.items():
            pool = self._cards.get(r)
            self.resources_available[r] = (
                pool.available() if pool is not None
                else self.resources_available.get(r, 0.0) - amt)
        return cards

    def _release_resources(self, demand: dict[str, float],
                           cards: dict | None = None):
        for r, amt in demand.items():
            if r not in self._cards:
                self.resources_available[r] = (
                    self.resources_available.get(r, 0.0) + amt)
        for r, got in (cards or {}).items():
            pool = self._cards.get(r)
            if pool is not None:
                pool.give(got)
                self.resources_available[r] = pool.available()

    def _lease_view(self, cards: dict) -> tuple | None:
        """The CUDA_VISIBLE_DEVICES names of a lease's cards, in the
        node's order; None for a lease without a GPU."""
        names = [n for r, got in cards.items()
                 for n in self._cards[r].names(got)]
        if not names:
            return None
        order = {n: i for i, n in enumerate(self._all_cards)}
        return tuple(sorted(set(names), key=lambda n: order.get(n, 0)))

    def _pin(self, w: _Worker, cards: dict) -> tuple | None:
        """Bind a lease's cards to the worker that serves it; -> the view
        the worker must set (None for a CPU-only lease)."""
        w.lease_cards = cards
        view = self._lease_view(cards)
        if view is not None:
            w.view = view
        return view

    def _can_ever_satisfy(self, demand: dict[str, float]) -> bool:
        return all(self.resources_total.get(r, 0.0) >= amt - 1e-9
                   for r, amt in demand.items())

    def _job_usage_ledger(self) -> dict[str, dict[str, float]]:
        """Absolute per-job leased usage on this node, derived from the
        live worker table (no incremental bookkeeping to drift): every
        busy worker's lease is charged to its job, PG-scoped resource
        keys folded back to their base resource."""
        usage: dict[str, dict[str, float]] = {}
        for w in self.workers.values():
            if not (w.busy and w.lease_resources and w.lease_job):
                continue
            agg = usage.setdefault(w.lease_job, {})
            for r, amt in w.lease_resources.items():
                base = r.split("_pg_", 1)[0]
                agg[base] = round(agg.get(base, 0.0) + amt, 4)
        return usage

    def _quota_over_share(self, job_hex: str,
                          demand: dict[str, float]) -> bool:
        """Would granting `demand` put this job past its fair share?
        Only jobs with an entry in the synced quota view are governed.
        Cluster-wide usage comes from the view (sync-cadence fresh);
        this node's LIVE ledger wins when larger — local grants since
        the last report must count against the share immediately, or a
        tight grant loop overshoots by a full sync period."""
        if not job_hex or not self._quota_view:
            return False
        q = self._quota_view.get(job_hex)
        if q is None:
            return False
        res = q.get("resource", "CPU")
        need = demand.get(res, 0.0)
        if need <= 0:
            return False
        local = self._job_usage_ledger().get(job_hex, {}).get(res, 0.0)
        used = max(float(q.get("used", 0.0)), local)
        return used + need > float(q.get("share", 0.0)) + 1e-9

    def _quota_throttled(self, job_hex: str,
                         demand: dict[str, float]) -> bool:
        """Park this request behind the job's share? Work-conserving:
        an over-share job still gets idle capacity — it throttles only
        while some OTHER job's lease is waiting here (the contended
        case where bursting past the share means starving a tenant
        that's under its floor)."""
        if not self._quota_over_share(job_hex, demand):
            return False
        return any(j != job_hex for _d, f, j in self._pending_leases
                   if not f.done())

    def _draining_self(self) -> bool:
        """Whether the GCS has marked THIS node draining, read from the
        synced cluster view (the label is GCS-applied; the sync cadence
        bounds how long a fresh drain can race a local grant)."""
        me = self._cluster_view.get(self.node_id.hex())
        return bool(me and (me.get("labels") or {}).get("draining"))

    def _pick_spillback(self, demand: dict[str, float],
                        strategy=None) -> Address | None:
        """Spillback target via the shared hybrid top-k policy (ref:
        hybrid_scheduling_policy.h:85): score by post-placement
        critical-resource utilization, random choice among the best k."""
        from ray_tpu_torch.core.scheduling_policy import pick_node

        self._spread_counter += 1
        nid_hex = pick_node(self._cluster_view, demand, strategy,
                            exclude={self.node_id.hex()},
                            spread_counter=self._spread_counter)
        if nid_hex is None or nid_hex == self.node_id.hex():
            return None
        return self._cluster_view[nid_hex].get("address")

    async def _pick_spillback_fresh(self, demand,
                                    strategy=None) -> Address | None:
        """Spillback against the heartbeat view; on a miss, refresh the view
        once from the GCS — a just-registered node may not have reached the
        periodic sync yet."""
        target = self._pick_spillback(demand, strategy)
        if target is not None:
            return target
        try:
            await self._refresh_view()
        except Exception:
            return None
        return self._pick_spillback(demand, strategy)

    # --------------------------------------------------------------- leases
    async def rpc_request_lease(self, conn, arg):
        """Grant leased worker(s) for `demand`, spill, or queue.

        Batched form (4/5-tuple arg) returns
        ("granted", [(WorkerInfo, lease_token), ...]) with 1..count
        grants: the first lease takes the full queue-wait path, the rest
        are granted only as long as resources are immediately acquirable
        — a partial batch is a backpressure signal the client answers
        with its next (queued) request. Legacy 2/3-tuple args keep the
        ("granted", WorkerInfo, lease_token) shape.
        Other replies: ("spillback", Address, next_hop) |
        ("infeasible", reason, detail) | ("cancelled", reason).

        The 5-tuple form carries the spillback HOP COUNT the caller
        accumulated; it rides the spillback reply back out so chains
        reassemble in the GCS decision traces. Every outcome is
        recorded as a per-demand-shape DECISION TRACE (verdict, reason,
        queue-wait, hop, candidate views) shipped on the heartbeat
        cadence — see _record_decision / gcs_event_manager.py.
        """
        count, batched, hop, job_hex = 1, False, 0, ""
        if len(arg) == 6:
            # quota-aware form: the caller's job id rides along so the
            # grant is charged to the right fair-share ledger
            demand, allow_spill, strategy, count, hop, job_hex = arg
            batched = True
            count = max(1, int(count))
            hop = max(0, int(hop))
            job_hex = str(job_hex or "")
        elif len(arg) == 5:
            demand, allow_spill, strategy, count, hop = arg
            batched = True
            count = max(1, int(count))
            hop = max(0, int(hop))
        elif len(arg) == 4:
            demand, allow_spill, strategy, count = arg
            batched = True
            count = max(1, int(count))
        elif len(arg) == 3:
            demand, allow_spill, strategy = arg
        else:
            (demand, allow_spill), strategy = arg, None
        trace = {"reason": "", "queue_wait_s": 0.0, "candidates": None}
        try:
            res = await self._request_lease(
                conn, demand, allow_spill, strategy, count, batched,
                hop, trace, job_hex)
        except asyncio.CancelledError:
            self._record_decision(demand, strategy, "cancelled",
                                  reason="lease handler cancelled",
                                  hop=hop)
            raise
        self._record_decision(
            demand, strategy, res[0], reason=trace["reason"], hop=hop,
            queue_wait_s=trace["queue_wait_s"],
            candidates=trace["candidates"])
        return res

    async def _request_lease(self, conn, demand, allow_spill, strategy,
                             count, batched, hop, trace, job_hex=""):
        from ray_tpu_torch.core.common import (NodeAffinitySchedulingStrategy,
                                               NodeLabelSchedulingStrategy)

        def spill(target):
            trace["reason"] = (
                f"spilled to {target.host}:{target.port}"
                if target is not None else "")
            return ("spillback", target, hop + 1)

        def infeasible(reason):
            trace["reason"] = reason
            trace["candidates"] = self._candidate_views(demand)
            return ("infeasible", reason,
                    {"shape": shape_key(demand),
                     "node": self.node_id.hex(),
                     "candidates": trace["candidates"]})

        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            # affinity to ANOTHER node: redirect the caller there
            if strategy.node_id != self.node_id:
                view = self._cluster_view.get(strategy.node_id.hex())
                if view is None or not view.get("alive"):
                    # a just-registered node may not be in the heartbeat
                    # view yet: refresh once before declaring it gone
                    try:
                        await self._refresh_view()
                    except Exception:
                        pass
                    view = self._cluster_view.get(strategy.node_id.hex())
                if view is not None and view.get("alive"):
                    return spill(view.get("address"))
                if not strategy.soft:
                    return infeasible(
                        f"affinity node {strategy.node_id} not alive")
            strategy = None  # landed on (or soft-fell-back to) this node
        elif isinstance(strategy, NodeLabelSchedulingStrategy) and \
                strategy.hard and not all(
                    self.labels.get(k) == v
                    for k, v in strategy.hard.items()):
            # this node fails the hard label constraint: redirect to a
            # matching node — one with room now, else one that could EVER
            # fit it (the target queues the lease until resources free)
            target = await self._pick_spillback_fresh(demand, strategy)
            if target is None:
                from ray_tpu_torch.core.scheduling_policy import pick_node

                nid_hex = pick_node(self._cluster_view, demand, strategy,
                                    exclude={self.node_id.hex()},
                                    by_capacity=True)
                if nid_hex is not None:
                    target = self._cluster_view[nid_hex].get("address")
            if target is not None:
                return spill(target)
            return infeasible(
                f"no alive node matches hard labels {strategy.hard}")
        elif strategy == "SPREAD" and allow_spill:
            # round-robin over ALL feasible nodes incl. this one; only
            # execute locally when it's this node's turn
            from ray_tpu_torch.core.scheduling_policy import spread_pick

            self._spread_counter += 1
            nid_hex = spread_pick(self._cluster_view, demand,
                                  self._spread_counter)
            if nid_hex is None:
                # everyone is saturated: round-robin by CAPACITY so the
                # overflow wave queues evenly instead of herding onto
                # this node's pending-lease queue
                nid_hex = spread_pick(self._cluster_view, demand,
                                      self._spread_counter,
                                      by_capacity=True)
            if nid_hex is not None and nid_hex != self.node_id.hex():
                return spill(self._cluster_view[nid_hex].get("address"))
        # A draining node admits NO new leases — not even from a driver
        # attached to this node manager, which never consults the
        # cluster-wide placement filter. Redirect to a live peer even on
        # an already-spilled hop (a peer with a view predating the drain
        # label may have sent it here; the redirect can't ping-pong back
        # because the spill pick itself filters draining nodes). With no
        # peer fitting, report infeasible so the caller's retry loop
        # lands the task once replacement capacity arrives.
        if self._draining_self():
            target = await self._pick_spillback_fresh(demand, strategy)
            if target is not None:
                return spill(target)
            return infeasible("node is draining")
        # PG-bundle demands translate to reserved-resource keys upstream.
        if not self._can_ever_satisfy(demand):
            if allow_spill:
                target = await self._pick_spillback_fresh(demand, strategy)
                if target is not None:
                    return spill(target)
            return infeasible(
                f"node cannot ever satisfy {demand} (total={self.resources_total})")
        # fair-share gate BEFORE the acquire: an over-share job with a
        # contending tenant parks even when resources are free right
        # now. It does NOT spill — the quota view is cluster-global, so
        # a peer node would reach the same verdict and the request
        # would just ping-pong.
        throttled = self._quota_throttled(job_hex, demand)
        if throttled:
            self._quota_throttled_deltas[job_hex] = \
                self._quota_throttled_deltas.get(job_hex, 0) + 1
            self._sched_dirty = True
            q = self._quota_view.get(job_hex, {})
            trace["reason"] = (
                f"quota_throttled: job {job_hex[:12]} at "
                f"{q.get('used', 0):g}/{q.get('share', 0):g} "
                f"{q.get('resource', 'CPU')} fair share")
        cards = None if throttled else self._try_acquire(demand)
        if cards is None:
            if allow_spill and not throttled:
                target = await self._pick_spillback_fresh(demand, strategy)
                if target is not None:
                    return spill(target)
            # park in the pending-lease queue. A caller that goes away
            # (connection closed, e.g. its driver died or cancelled)
            # must release its queue slot and record a `cancelled`
            # verdict instead of eventually granting to nobody — a
            # grant whose reply can't be delivered would leak the
            # worker + resources forever.
            fut = asyncio.get_running_loop().create_future()
            self._pending_leases.append((demand, fut, job_hex))
            trace["candidates"] = self._candidate_views(demand)
            t_park = time.monotonic()

            def _caller_gone(_c, fut=fut):
                if not fut.done():
                    fut.set_result("cancelled")

            conn.on_close.append(_caller_gone)
            try:
                outcome = await fut
            finally:
                try:
                    conn.on_close.remove(_caller_gone)
                except ValueError:
                    pass
            trace["queue_wait_s"] = time.monotonic() - t_park
            if outcome == "cancelled":
                # still parked: _maybe_grant_pending drops done futures,
                # but sweep explicitly so the slot releases NOW
                self._pending_leases = [
                    e for e in self._pending_leases
                    if e[1] is not fut]
                trace["reason"] = "caller gone while queued"
                return ("cancelled", trace["reason"])
            cards = outcome
            if conn.closed:
                # granted (resources acquired by _maybe_grant_pending)
                # but the caller died before we resumed: hand the
                # acquisition back instead of leasing to nobody
                self._release_resources(demand, cards)
                self._maybe_grant_pending()
                trace["reason"] = "caller gone as queued lease granted"
                return ("cancelled", trace["reason"])
        granted: list = []
        while True:
            try:
                w = await self._get_idle_worker(
                    view=self._lease_view(cards))
            except Exception as e:
                self._release_resources(demand, cards)
                self._maybe_grant_pending()
                if granted:
                    break  # partial batch beats failing granted leases
                return infeasible(f"worker startup failed: {e}")
            w.busy = True
            w.lease_resources = dict(demand)
            w.lease_job = job_hex
            view = self._pin(w, cards)
            # the token names the worker, and the cards it must see: the
            # caller puts them on every spec it pushes on this lease
            granted.append((w.info, lease_token(w.info.worker_id.hex(),
                                                view)))
            # grant further batch members only while resources are
            # immediately acquirable — never queue mid-batch (the first
            # lease owns the queue-wait slot; a partial grant tells the
            # client to come back, keeping the FIFO fair across clients)
            if len(granted) >= count:
                break
            cards = self._try_acquire(demand)
            if cards is None:
                break
        if not batched:
            return ("granted", granted[0][0], granted[0][1])
        return ("granted", granted)

    def rpc_return_lease(self, conn, token: str):
        wid = WorkerID.from_hex(parse_lease_token(token)[0])
        w = self.workers.get(wid)
        if w is None:
            return False
        if w.lease_resources:
            self._release_resources(w.lease_resources, w.lease_cards)
            w.lease_resources = None
            w.lease_cards = {}
        w.lease_job = ""
        w.busy = False
        w.last_idle = time.monotonic()
        self._maybe_grant_pending()
        return True

    def _maybe_grant_pending(self):
        """Two-pass FIFO grant: under-share (and unquota'd) waiters
        first; over-share waiters take what's left ONLY when no one
        else is still waiting — the fair-share ordering that lets a
        serve tenant reclaim its floor from a bursting shuffle job as
        leases churn. Over-share leftovers requeue behind the rest."""
        still, deferred = [], []
        for entry in self._pending_leases:
            demand, fut, job = entry
            if fut.done():
                continue
            if self._quota_over_share(job, demand):
                deferred.append(entry)
                continue
            cards = self._try_acquire(demand)
            if cards is not None:
                fut.set_result(cards)
            else:
                still.append(entry)
        for entry in deferred:
            demand, fut, job = entry
            cards = None if still else self._try_acquire(demand)
            if cards is not None:
                fut.set_result(cards)
            else:
                still.append(entry)
        self._pending_leases = still

    # --------------------------------------------------------------- actors
    async def rpc_start_actor(self, conn, spec: TaskSpec):
        """Lease a dedicated worker and run the actor-creation task on it.
        Returns (WorkerInfo, error_str|None) or None if resources are busy."""
        demand = dict(spec.resources)
        # Zero-resource actors still need a 1-CPU *placement* check (ref
        # semantics: actors need 1 CPU to schedule but hold 0) so they don't
        # land on CPU-starved nodes; nothing is deducted for them.
        placement_demand = demand or {"CPU": 1.0}
        if not self._can_ever_satisfy(placement_demand):
            return None
        cards: dict = {}
        if demand:
            cards = self._try_acquire(demand)
            if cards is None:
                return None
        elif any(self.resources_available.get(r, 0.0) < amt
                 for r, amt in placement_demand.items()):
            return None
        # The WHOLE creation (worker startup + create call) must finish
        # inside the GCS's push timeout, or the GCS reschedules while this
        # instance still materializes — a ghost holding leased resources.
        budget = time.monotonic() + \
            get_config().actor_creation_push_timeout_s - 15.0
        try:
            self.task_events.record_transition(
                task_id=spec.task_id.hex(), name=spec.name or "Actor",
                kind="actor_creation", state="DISPATCHED",
                job_id=spec.job_id.hex(),
                actor_id=spec.actor_id.hex() if spec.actor_id else "")
        except Exception:
            pass
        logger.info("start_actor %s (%s): acquiring worker",
                    spec.actor_id, spec.name or "")
        try:
            w = await self._get_idle_worker(
                timeout_s=budget - time.monotonic(),
                view=self._lease_view(cards))
        except Exception as e:
            self._release_resources(demand, cards)
            self._maybe_grant_pending()
            return (None, f"worker startup failed: {e}")
        w.busy = True
        w.actor_id = spec.actor_id
        w.lease_resources = dict(demand)
        w.lease_job = spec.job_id.hex() if spec.job_id else ""
        # the actor's process sees its lease's cards from its constructor on
        spec.gpu_ids = self._pin(w, cards)
        logger.info("start_actor %s: pushing create to worker pid=%s",
                    spec.actor_id, w.proc.pid)
        try:
            err = await w.conn.call(
                "create_actor", spec,
                timeout=max(5.0, budget - time.monotonic()))
        except Exception as e:
            # Creation not committed: the GCS _schedule_actor loop owns the
            # retry (returning None). Keep this the ONLY recovery path:
            # clear actor_id first so worker-death reaping doesn't also
            # report an actor failure, and recycle the process rather than
            # returning it to the idle pool (its state is unknown — the
            # create may still be executing on it).
            w.actor_id = None
            if w.lease_resources:
                self._release_resources(w.lease_resources, w.lease_cards)
                w.lease_resources = None
                w.lease_cards = {}
            if w.info is not None:
                self.workers.pop(w.info.worker_id, None)
            try:
                w.proc.terminate()
            except Exception:
                pass
            self._doomed.append(w)  # keep poll()ing it so it gets reaped
            self._maybe_grant_pending()
            logger.warning("actor creation push failed, will reschedule: %s", e)
            return None
        if err is not None:
            w.busy = False
            w.actor_id = None
            self._release_resources(demand, w.lease_cards)
            w.lease_resources = None
            w.lease_cards = {}
            self._maybe_grant_pending()
            return (w.info, err)
        return (w.info, None)

    async def rpc_kill_actor_worker(self, conn, actor_id: ActorID):
        for w in list(self.workers.values()):
            if w.actor_id == actor_id:
                try:
                    w.proc.terminate()
                except Exception:
                    pass
                return True
        return False

    # ----------------------------------------------------- placement groups
    def rpc_list_workers(self, conn, arg=None):
        """State-API surface: worker processes on this node."""
        out = []
        for w in self.workers.values():
            out.append({
                "worker_id": w.info.worker_id.hex() if w.info else None,
                "pid": w.proc.pid,
                "busy": w.busy,
                "actor_id": w.actor_id.hex() if w.actor_id else None,
                "address": (f"{w.info.address.host}:{w.info.address.port}"
                            if w.info else None),
            })
        out.extend({"worker_id": None, "pid": w.proc.pid,
                    "busy": False, "actor_id": None, "starting": True}
                   for w in self._unregistered)
        return out

    def rpc_pg_prepare(self, conn, arg):
        pg_id, bundle_index, demand = arg
        cards = self._try_acquire(demand)
        if cards is None:
            return False
        self._pg_prepared[(pg_id, bundle_index)] = dict(demand)
        self._pg_cards[(pg_id, bundle_index)] = cards
        return True

    async def rpc_pg_commit(self, conn, arg):
        pg_id, bundle_index = arg
        demand = self._pg_prepared.pop((pg_id, bundle_index), None)
        if demand is None:
            return False
        self._pg_reserved[(pg_id, bundle_index)] = demand
        # Advertise bundle resources as custom keys so leases inside the PG
        # target the reservation (ref: bundle resource naming "CPU_group_...").
        for r, amt in demand.items():
            key = f"{r}_pg_{pg_id.hex()}_{bundle_index}"
            self.resources_total[key] = self.resources_total.get(key, 0.0) + amt
            self.resources_available[key] = (
                self.resources_available.get(key, 0.0) + amt)
        # the bundle's leases take their cards from the bundle's own
        for r, got in self._pg_cards.get((pg_id, bundle_index), {}).items():
            key = f"{r}_pg_{pg_id.hex()}_{bundle_index}"
            self._cards[key] = _Cards(self._cards[r].names(got),
                                      [share for _, share in got])
            self.resources_available[key] = self._cards[key].available()
        await self._push_heartbeat()
        return True

    async def _push_heartbeat(self):
        """Sync the GCS resource view (delta form): only resource keys
        that changed since the last ack'd send travel; a removed key is
        sent as None. Also called out-of-band so just-committed bundle
        resources are visible to spillback/scheduling immediately."""
        async with self._hb_lock:
            cur = dict(self.resources_available)
            if self._hb_last_sent is None:
                delta, full = cur, True
            else:
                delta = {k: v for k, v in cur.items()
                         if self._hb_last_sent.get(k) != v}
                for k in self._hb_last_sent:
                    if k not in cur:
                        delta[k] = None
                full = False
            try:
                await self.gcs_conn.call("heartbeat",
                                         (self.node_id, delta, full))
                self._hb_last_sent = cur
            except Exception:
                # the server may or may not have applied the delta:
                # the baseline is unknowable — next send must be full
                self._hb_last_sent = None

    async def rpc_pg_return(self, conn, arg):
        pg_id, bundle_index = arg
        demand = self._pg_prepared.pop((pg_id, bundle_index), None)
        if demand is not None:
            self._release_resources(
                demand, self._pg_cards.pop((pg_id, bundle_index), None))
            self._maybe_grant_pending()
            return True
        demand = self._pg_reserved.pop((pg_id, bundle_index), None)
        if demand is None:
            return False
        for r, amt in demand.items():
            key = f"{r}_pg_{pg_id.hex()}_{bundle_index}"
            self.resources_total.pop(key, None)
            self.resources_available.pop(key, None)
            self._cards.pop(key, None)
        self._release_resources(
            demand, self._pg_cards.pop((pg_id, bundle_index), None))
        self._maybe_grant_pending()
        await self._push_heartbeat()
        return True

    # ----------------------------------------------------- spilling / OOM
    def _store_capacity(self) -> int:
        cfg = get_config()
        if cfg.object_store_memory:
            return cfg.object_store_memory
        cap = getattr(self.shm, "capacity", None)
        if callable(cap):
            try:
                return int(cap())
            except Exception:
                pass
        return 2 << 30

    def _unspilled_bytes(self) -> int:
        # snapshot: restore/spill IO on executor threads can mutate the
        # dict concurrently with this loop-side iteration
        return sum(m["size"] for m in list(self.object_dir.values())
                   if not m.get("spilled"))

    def _spill_path(self, oid: ObjectID) -> str:
        d = os.path.join(get_config().object_spill_dir, self.node_id.hex())
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, oid.hex())

    def _claim_spill_victim(self):
        """Pick AND mark a spill victim under the spill lock — sync spills
        on executor threads and the async spill loop must not race onto
        the same object."""
        with self._spill_lock:
            victim = next(
                (oid for oid, m in list(self.object_dir.items())
                 if not m.get("spilled") and not m.get("spilling")
                 and self.shm.contains_locally(oid)),
                None)
            if victim is not None:
                self.object_dir[victim]["spilling"] = True
            return victim

    def _spill_write(self, victim: ObjectID, size: int) -> str:
        """The IO half of a spill (shm map + file write) — safe to run
        on an executor thread; state mutation stays on the loop. Writes
        the mapping view directly: no host-side copy of the payload."""
        path = self._spill_path(victim)
        view, release = self.shm.read_range_view(victim, size, 0, size)
        try:
            with open(path + ".tmp", "wb") as f:
                f.write(view)
        finally:
            view = None
            if release is not None:
                try:
                    release()
                except Exception:
                    pass
        os.replace(path + ".tmp", path)
        return path

    def _finish_spill(self, victim: ObjectID, meta: dict, path: str):
        with self._spill_lock:
            if meta.get("spilled"):
                return  # another path already completed this spill
            self.shm.unlink(victim)      # tombstone while pinned
            if meta.pop("pinned", False):
                self.shm.unpin(victim)   # refcount 0 -> space reclaimed
            meta["spilled"] = path
            self._spilled_bytes += meta["size"]
            self._spill_count += 1
            self._objects_dirty = True
        logger.info("spilled %s (%d bytes) to %s",
                    victim, meta["size"], path)

    def _spill_one(self) -> bool:
        """Synchronous spill (OOM fallback paths, possibly on executor
        threads); the background spill loop uses _spill_one_async to keep
        file IO off the RPC loop. Both claim victims via the spill lock."""
        victim = self._claim_spill_victim()
        if victim is None:
            return False
        meta = self.object_dir[victim]
        try:
            path = self._spill_write(victim, meta["size"])
            self._finish_spill(victim, meta, path)
        finally:
            meta.pop("spilling", None)
        return True

    async def _spill_one_async(self) -> bool:
        """Spill with the file IO on an executor thread (ref:
        local_object_manager spills via IO workers, not the main loop).
        The victim is marked `spilling` so concurrent picks skip it; if
        it is freed while the write is in flight, the file is removed."""
        victim = self._claim_spill_victim()
        if victim is None:
            return False
        meta = self.object_dir[victim]
        loop = asyncio.get_running_loop()
        try:
            path = await loop.run_in_executor(
                None, self._spill_write, victim, meta["size"])
            if self.object_dir.get(victim) is not meta:
                # freed mid-spill: drop the orphan file
                try:
                    os.remove(path)
                except OSError:
                    pass
                return True
            self._finish_spill(victim, meta, path)
        finally:
            meta.pop("spilling", None)
        return True

    def _spill_until(self, target_unspilled: float) -> int:
        n = 0
        while self._unspilled_bytes() > target_unspilled:
            if not self._spill_one():
                break
            n += 1
        return n

    async def rpc_spill_now(self, conn, need_bytes: int):
        """A creator hit shm OOM: free at least need_bytes by spilling
        primaries (ref: plasma create-request queue + spill). The caller
        blocks, but this loop keeps serving other RPCs — spill IO runs
        on executor threads."""
        cap = self._store_capacity()
        target = min(max(0.0, cap - float(need_bytes) * 2),
                     get_config().object_spilling_threshold * cap)
        n = 0
        while self._unspilled_bytes() > target:
            if not await self._spill_one_async():
                break
            n += 1
        return n

    async def _spill_loop(self):
        """Move sealed shm objects to disk past the high-water mark (ref:
        local_object_manager.h:41 spill-to-disk). Oldest-sealed first; the
        directory keeps serving them (fetch reads the file, local access
        restores into shm on demand). File IO runs on executor threads so
        multi-GiB spills don't stall lease/RPC traffic on this loop."""
        cfg = get_config()
        high = cfg.object_spilling_threshold * self._store_capacity()
        while not self._stopping:
            try:
                while self._unspilled_bytes() > high:
                    if not await self._spill_one_async():
                        break
            except Exception:
                logger.exception("spill loop error")
            await asyncio.sleep(0.2)

    def _restore_spilled(self, oid: ObjectID) -> bool:
        meta = self.object_dir.get(oid)
        if meta is None:
            return False
        if not meta.get("spilled"):
            return self.shm.contains_locally(oid)
        try:
            with open(meta["spilled"], "rb") as f:
                data = f.read()
        except OSError:
            return False
        if not self.shm.contains_locally(oid):
            try:
                self.shm.create_from_bytes(oid, data)
            except MemoryError:
                # make room by spilling other primaries, then retry
                self._spill_until(max(
                    0.0, self._store_capacity() - 2.0 * len(data)))
                self.shm.create_from_bytes(oid, data)
        try:
            meta["pinned"] = self.shm.pin(oid)
        except Exception:
            meta["pinned"] = False
        try:
            os.remove(meta["spilled"])
        except OSError:
            pass
        meta["spilled"] = None
        self._restore_count += 1
        self._objects_dirty = True
        return True

    async def rpc_restore_object(self, conn, oid: ObjectID):
        """Local un-spill: a worker on this node wants shm access. The
        disk read + shm write run off-loop. Concurrent restores of the
        same object coalesce onto one executor task — two threads racing
        create would let the loser return while the winner is mid-write
        (and double-pin the segment)."""
        loop = asyncio.get_running_loop()
        fut = self._restore_futs.get(oid)
        if fut is not None:
            return await asyncio.shield(fut)
        fut = loop.create_future()
        self._restore_futs[oid] = fut
        try:
            ok = await loop.run_in_executor(None, self._restore_spilled, oid)
        except Exception:
            logger.exception("restore of %s failed", oid)
            ok = False
        finally:
            self._restore_futs.pop(oid, None)
        if not fut.done():
            fut.set_result(ok)
        return ok

    async def _preemption_watch_loop(self):
        """Preemption-notice watcher (simulates the TPU maintenance-
        event endpoint a preemptible slice would poll): watch the
        configured notice file; when it appears, self-initiate a
        deadline-bound drain through the GCS. The file may carry a JSON
        body {"deadline_s": .., "reason": ..}; an empty or unparsable
        file drains with the config-default deadline."""
        cfg = get_config()
        path = cfg.preemption_notice_file.format(
            node_id=self.node_id.hex())
        poll = max(0.05, cfg.preemption_poll_interval_s)
        while not self._stopping:
            await asyncio.sleep(poll)
            try:
                if not os.path.exists(path):
                    continue
            except OSError:
                continue
            deadline_s, reason = None, "preemption notice"
            try:
                import json

                with open(path) as f:
                    body = json.load(f)
                deadline_s = body.get("deadline_s")
                reason = body.get("reason") or reason
            except Exception:
                pass  # empty/garbled notice: defaults
            self._emit_event(
                "preemption_notice",
                f"preemption notice at {path}: self-draining ({reason})",
                severity="WARNING", notice_file=path, reason=reason)
            try:
                ok = await self.gcs_conn.call(
                    "drain_node", (self.node_id, deadline_s, reason))
            except Exception:
                logger.exception("self-drain after preemption notice "
                                 "failed; retrying")
                continue
            if ok:
                logger.warning("preemption notice %s: node %s draining "
                               "(%s)", path, self.node_id, reason)
                return  # drain initiated — the watcher's job is done
            await asyncio.sleep(poll)

    async def _memory_monitor_loop(self):
        """Node OOM guard (ref: memory_monitor.h + retriable-FIFO worker
        killing policy): past the RAM watermark, kill the most recently
        leased non-actor worker — its task retries elsewhere/later."""
        cfg = get_config()
        while not self._stopping:
            await asyncio.sleep(cfg.memory_monitor_interval_s)
            try:
                import psutil

                frac = psutil.virtual_memory().percent / 100.0
            except Exception:
                continue
            if frac < cfg.memory_usage_threshold:
                continue
            victim = self._pick_worker_to_kill()
            if victim is None:
                continue
            self._oom_kills += 1
            # RSS measured BEFORE the kill: the reap path turns this
            # into a caused worker_oom_reaped cluster event
            try:
                rss = psutil.Process(victim.proc.pid).memory_info().rss
            except Exception:
                rss = 0
            victim.oom_reap = (frac, rss)
            logger.warning(
                "memory pressure %.0f%% >= %.0f%%: killing worker %s "
                "(task will retry)", frac * 100,
                cfg.memory_usage_threshold * 100,
                victim.info.worker_id if victim.info else "?")
            try:
                victim.proc.terminate()
            except Exception:
                pass

    def _pick_worker_to_kill(self):
        """Retriable-FIFO: newest busy non-actor worker first (ref:
        worker_killing_policy_retriable_fifo.cc); actors only as a last
        resort (they may not be restartable)."""
        tasks = [w for w in self.workers.values()
                 if w.busy and w.actor_id is None]
        if tasks:
            return max(tasks, key=lambda w: w.last_idle)
        actors = [w for w in self.workers.values() if w.actor_id is not None]
        if actors:
            return max(actors, key=lambda w: w.last_idle)
        return None

    # ------------------------------------------------------ object directory
    def rpc_object_created(self, conn, arg):
        # 4-tuple carries the creation callsite (env-gated capture at
        # rt.put / task returns); legacy 3-tuple stays accepted
        if len(arg) == 4:
            object_id, size, owner, callsite = arg
        else:
            (object_id, size, owner), callsite = arg, ""
        # pin the primary copy: LRU eviction must not race the spill loop
        # (ref: plasma pins primaries; spilling is the only reclaim path)
        pinned = False
        try:
            pinned = self.shm.pin(object_id)
        except Exception:
            pass
        self.object_dir[object_id] = {"size": size, "owner": owner,
                                      "pinned": pinned,
                                      "callsite": callsite or "",
                                      "created_at": time.time()}
        self._objects_dirty = True
        return True

    def rpc_object_lookup(self, conn, object_id: ObjectID):
        return self.object_dir.get(object_id)

    def rpc_free_object(self, conn, object_id: ObjectID):
        self._objects_dirty = True
        meta = self.object_dir.pop(object_id, None)
        if meta is not None and meta.get("spilled"):
            try:
                os.remove(meta["spilled"])
            except OSError:
                pass
        self.shm.unlink(object_id)
        if meta is not None and meta.get("pinned"):
            try:
                self.shm.unpin(object_id)
            except Exception:
                pass
        return True

    @staticmethod
    async def _read_spill_range(path: str, offset: int, length: int | None):
        """Read [offset, offset+length) of a spill file (length None =
        to EOF) on an executor thread. None = the file vanished (a
        concurrent local restore deleted it)."""

        def read_file():
            try:
                with open(path, "rb") as f:
                    if offset:
                        f.seek(offset)
                    return f.read() if length is None else f.read(length)
            except OSError:
                return None

        return await asyncio.get_running_loop().run_in_executor(
            None, read_file)

    async def _serve_shm_range(self, object_id: ObjectID, size: int,
                               offset: int, length: int):
        """Serve bytes [offset, offset+length) of a sealed in-shm object
        as a RawView over the source mapping — no ``bytes()`` copy; the
        rpc layer writes it verbatim and the get-ref pinning the mapping
        drops once the write is handed to the transport. The store read
        runs on an executor thread: usually just a mapping slice, but
        the native store's fallback-file branch (arena-OOM objects) does
        a real disk read that must not stall this loop. None = gone, or
        a concurrent free/unlink closed the mapping under the executor
        read — "not here", the puller tries elsewhere."""
        try:
            view, release = await asyncio.get_running_loop().run_in_executor(
                None, self.shm.read_range_view, object_id,
                size, offset, length)
        except (KeyError, FileNotFoundError, TypeError, ValueError):
            return None
        return RawView(view, release)

    async def rpc_fetch_object(self, conn, object_id: ObjectID):
        """Single-frame pull entrypoint for node-to-node transfer (ref:
        push_manager.h:30 / pull_manager.h:52). Spilled objects serve
        straight from disk; in-shm objects serve zero-copy via
        _serve_shm_range."""
        meta = self.object_dir.get(object_id)
        if meta is None:
            return None
        if meta.get("spilled"):
            return await self._read_spill_range(meta["spilled"], 0, None)
        return await self._serve_shm_range(object_id, meta["size"],
                                           0, meta["size"])

    async def rpc_fetch_chunk(self, conn, arg):
        """Serve bytes [offset, offset+length) of a sealed object — the
        push side of chunked transfer, throttled so bulk pulls can't
        monopolize this node (ref: push_manager.h:30)."""
        object_id, offset, length = arg
        if self._push_sem is None:
            self._push_sem = asyncio.Semaphore(
                max(1, get_config().push_max_concurrent_chunks))
        async with self._push_sem:
            meta = self.object_dir.get(object_id)
            if meta is None:
                return None
            if meta.get("spilled"):
                data = await self._read_spill_range(
                    meta["spilled"], offset, length)
                if data is not None:
                    return data
                # a concurrent local restore deleted the spill file
                # mid-pull; it re-created the shm copy first, so fall
                # through and serve the chunk from shm
            return await self._serve_shm_range(object_id, meta["size"],
                                               offset, length)

    def _store_pulled(self, object_id: ObjectID, chunks: list, size: int,
                      owner):
        """Seal a pulled object into local shm, spilling to make room."""
        try:
            self.shm.create_from_chunks(object_id, chunks, size)
        except MemoryError:
            self._spill_until(max(
                0.0, self._store_capacity() - 2.0 * size))
            self.shm.create_from_chunks(object_id, chunks, size)
        # pulled SECONDARY copy: not pinned (evictable; the primary or its
        # spill file elsewhere remains the durable copy)
        self.object_dir[object_id] = {"size": size, "owner": owner}
        self._objects_dirty = True

    def _prepare_pull_segment(self, object_id: ObjectID, size: int) -> bool:
        """Allocate the (unsealed) destination for a streamed pull,
        spilling to make room. False if the object already exists."""
        try:
            return self.shm.create_unsealed(object_id, size)
        except MemoryError:
            self._spill_until(max(
                0.0, self._store_capacity() - 2.0 * size))
            return self.shm.create_unsealed(object_id, size)

    def _finish_pull_segment(self, object_id: ObjectID, size: int, owner):
        self.shm.seal(object_id)
        self.object_dir[object_id] = {"size": size, "owner": owner}
        self._objects_dirty = True

    async def rpc_store_remote_object(self, conn, arg):
        """Pull `object_id` from another node's manager into local shm —
        chunked, admission-controlled, deduplicated (_PullManager).
        Optional 5th element pin=True promotes the copy to a durable
        primary (drain evacuation: the source node is going away, so
        this copy must not be LRU-evictable)."""
        object_id, size, owner, remote_addr = arg[:4]
        pin = bool(arg[4]) if len(arg) > 4 else False
        ok = await self._pull_manager.pull(object_id, size, owner,
                                           remote_addr)
        if ok and pin:
            meta = self.object_dir.get(object_id)
            if meta is not None and not meta.get("pinned"):
                try:
                    meta["pinned"] = self.shm.pin(object_id)
                except Exception:
                    pass
                self._objects_dirty = True
        return ok

    async def rpc_evacuate_objects(self, conn, targets):
        """Drain-time object migration (called by the GCS drain
        coordinator): push every primary copy living here (pinned in
        shm or spilled to this node's disk) to a live peer, pinned
        there, and record the new location with the object's owner — so
        reads after this node's teardown resolve from the copy instead
        of lineage re-execution.

        targets: [(NodeID, Address)] of live non-draining peers.
        Returns the number of objects successfully evacuated."""
        if not targets:
            return 0
        moved = 0
        peer_conns: dict = {}
        owner_conns: dict = {}

        async def conn_to(cache, addr):
            key = (addr.host, addr.port)
            c = cache.get(key)
            if c is None or c.closed:
                c = cache[key] = await connect(addr.host, addr.port)
            return c

        try:
            i = 0
            for oid, meta in list(self.object_dir.items()):
                if not (meta.get("pinned") or meta.get("spilled")):
                    continue  # secondary copy: durable home elsewhere
                size = meta.get("size", 0)
                owner = meta.get("owner")
                target_nid, target_addr = targets[i % len(targets)]
                i += 1
                try:
                    c = await conn_to(peer_conns, target_addr)
                    ok = await c.call(
                        "store_remote_object",
                        (oid, size, owner, self.address, True),
                        timeout=120)
                except Exception as e:
                    logger.warning("evacuation of %s to %s failed: %s",
                                   oid, target_nid, e)
                    continue
                if not ok:
                    continue
                moved += 1
                # the owner appends the new location; the draining
                # node's own entry is pruned by its CH_NODE removal
                if owner is not None and owner.address is not None:
                    try:
                        oc = await conn_to(owner_conns, owner.address)
                        await oc.call("add_object_location",
                                      (oid, target_nid), timeout=10)
                    except Exception:
                        pass  # owner gone: its refs died with it
        finally:
            for c in list(peer_conns.values()) + list(owner_conns.values()):
                try:
                    await c.close()
                except Exception:
                    pass
        if moved:
            self._emit_event(
                "objects_evacuated",
                f"{moved} primary object cop(ies) evacuated to "
                f"{len(targets)} peer(s) ahead of drain",
                severity="WARNING", moved=moved)
        return moved

    # ------------------------------------------------------------ debugging
    def rpc_list_objects(self, conn, arg=None):
        """Object-directory dump for `rayt memory` (ref analog:
        `ray memory` / _private/internal_api.py memory summary)."""
        out = []
        for oid, meta in list(self.object_dir.items()):
            owner = meta.get("owner")
            out.append({
                "object_id": oid.hex(),
                "size": meta.get("size", 0),
                "spilled": bool(meta.get("spilled")),
                "pinned": bool(meta.get("pinned")),
                "callsite": meta.get("callsite", ""),
                "owner_worker": (owner.worker_id.hex()
                                 if owner is not None else None),
            })
        return out

    def rpc_node_stats(self, conn, arg=None):
        return {
            "node_id": self.node_id.hex(),
            "resources_total": dict(self.resources_total),
            "resources_available": dict(self.resources_available),
            "num_workers": len(self.workers),
            "num_objects": len(self.object_dir),
            "pending_leases": len(self._pending_leases),
            "pulled_objects": self._pull_manager.pulled_objects,
            "pulled_bytes": self._pull_manager.pulled_bytes,
            "num_spilled": self._spill_count,
            "num_restored": self._restore_count,
            "spilled_bytes": self._spilled_bytes,
            "oom_kills": self._oom_kills,
        }


class _FakeProc:
    pid = -1

    def poll(self):
        return None

    def terminate(self):
        pass

    def wait(self, timeout=None):
        pass

    def kill(self):
        pass
