"""ServeController — reconciles target app state onto replica actors (ref
analogs: python/ray/serve/_private/controller.py:84,
application_state.py, deployment_state.py, autoscaling_state.py).

A detached named actor. The reconcile loop diffs target replica counts
(static or autoscaled from ongoing-request stats) against live replicas
and starts/stops ReplicaActors; handles poll `get_routing_table` (the
long-poll analog) with a version counter so unchanged tables are cheap.
"""

from __future__ import annotations

import asyncio
import math
import time
import traceback
from typing import Any, Optional

import cloudpickle

CONTROLLER_NAME = "serve_controller"

# a wedged reconcile loop must be diagnosable: errors log at WARNING
# with traceback, rate-limited so a persistent failure can't flood
RECONCILE_ERR_LOG_INTERVAL_S = 30.0

# controller-state checkpoint location in the GCS KV (survives a
# controller bounce; with a persisted GCS it survives a head bounce too)
CKPT_NAMESPACE = "serve"
CKPT_KEY = "controller:checkpoint"

# ingress-proxy liveness: a proxy heartbeats ~1/s; one missing for this
# long is declared dead and its admission-window share redistributes to
# the survivors on their next routing-table refresh (~1s capacity TTL)
PROXY_TTL_S = 3.0


class ServeController:
    def __init__(self):
        self.apps: dict[str, dict] = {}      # app -> {dep_name: spec}
        self.replicas: dict[tuple, list] = {}  # (app, dep) -> [handle]
        self.version = 0
        self._scale_marks: dict[tuple, float] = {}
        # replicas removed from the routing table but still finishing
        # in-flight requests: [(handle, drain_deadline)] (graceful rolling
        # replace, ref deployment_state.py replica draining)
        self._draining: list[tuple] = []
        # cross-handle router signal: (app, dep) -> {replica_idx: ongoing}
        # refreshed each reconcile tick (ref: replica_scheduler/common.py
        # queue-length cache — here controller-mediated so every handle
        # in every process sees the same load view)
        self._replica_load: dict[tuple, dict[int, float]] = {}
        # in-progress version replacements: (app, dep) -> {"old": [handles
        # still routed], "warming": [new-version handles not yet routed]}
        # (ref: deployment_state.py rolling update — old replicas keep
        # serving until a new-version replica is READY, so the routing
        # table never goes empty mid-update)
        self._updating: dict[tuple, dict] = {}
        # proactive drain migration: (app, dep) -> {"victims": [routed
        # handles on DRAINING nodes], "warming": [replacements not yet
        # routed], "drain_timeout_s"} — same make-before-break shape as
        # _updating, driven by the GCS drain state instead of a deploy
        self._migrating: dict[tuple, dict] = {}
        # cached DRAINING-node view: (set of node hexes, monotonic ts)
        self._drain_cache: tuple[set, float] = (set(), 0.0)
        # active health probing: actor_hex -> consecutive failures
        # (ref: deployment_state.py replica health checks)
        self._health_fails: dict[str, int] = {}
        self._last_probe: dict[tuple, float] = {}
        self._loop_task = None  # started via ensure_loop (needs the
        # actor's asyncio loop, which doesn't exist during __init__)
        self._reconcile_lock: asyncio.Lock | None = None  # lazy: needs loop
        self._last_err_log = 0.0
        # metrics-store signal cache: key -> (signals dict, monotonic ts)
        # (throttles GCS metrics_query RPCs to ~1/s per deployment)
        self._signal_cache: dict[tuple, tuple[dict, float]] = {}
        # last autoscale decision per key (introspection: tests, bench,
        # dashboard): {"desired", "target", "live", "signals", "ts"}
        self._autoscale_status: dict[str, dict] = {}
        # ingress-proxy fleet membership: proxy_id -> {"proto", "port",
        # "last_seen" (controller-local monotonic)}. The live count rides
        # get_route_info so every proxy sizes its admission-window share
        # from the same view the routing table comes from.
        self._proxies: dict[str, dict] = {}

    # ------------------------------------------------- proxy fleet
    def register_proxy(self, proxy_id: str, proto: str = "http",
                       port: int = 0) -> bool:
        fresh = proxy_id not in self._proxies
        self._proxies[proxy_id] = {"proto": proto, "port": int(port),
                                   "last_seen": time.monotonic()}
        if fresh:
            try:
                from ray_tpu_torch.core.gcs_event_manager import \
                    emit_cluster_event

                emit_cluster_event(
                    source="serve", kind="serve_proxy_joined",
                    message=(f"ingress proxy {proxy_id} ({proto}, port "
                             f"{port}) joined the fleet "
                             f"({self._live_proxy_count()} live)"),
                    proxy=proxy_id, proto=proto, port=int(port))
            except Exception:
                pass
        return True

    def proxy_heartbeat(self, proxy_id: str, proto: str = "http",
                        port: int = 0) -> bool:
        rec = self._proxies.get(proxy_id)
        if rec is None:  # controller bounced: heartbeat re-registers
            return self.register_proxy(proxy_id, proto, port)
        rec["last_seen"] = time.monotonic()
        return True

    def deregister_proxy(self, proxy_id: str) -> bool:
        return self._proxies.pop(proxy_id, None) is not None

    def _live_proxy_ids(self) -> list[str]:
        now = time.monotonic()
        return [pid for pid, rec in self._proxies.items()
                if now - rec["last_seen"] <= PROXY_TTL_S]

    def _live_proxy_count(self) -> int:
        return max(1, len(self._live_proxy_ids()))

    def list_proxies(self) -> dict:
        """Fleet view for introspection (dashboard / bench): per-proxy
        proto, port, liveness, and seconds since the last heartbeat."""
        now = time.monotonic()
        return {pid: {"proto": rec["proto"], "port": rec["port"],
                      "age_s": round(now - rec["last_seen"], 3),
                      "live": now - rec["last_seen"] <= PROXY_TTL_S}
                for pid, rec in self._proxies.items()}

    def _proxy_tick(self):
        """Prune proxies past the liveness TTL (one WARNING event per
        death; the share redistribution itself needs no action here —
        live_proxies is recomputed on every get_route_info)."""
        now = time.monotonic()
        for pid, rec in list(self._proxies.items()):
            if now - rec["last_seen"] > PROXY_TTL_S:
                del self._proxies[pid]
                try:
                    from ray_tpu_torch.core.gcs_event_manager import \
                        emit_cluster_event

                    emit_cluster_event(
                        source="serve", kind="serve_proxy_dead",
                        severity="WARNING",
                        message=(f"ingress proxy {pid} missed heartbeats "
                                 f"for {PROXY_TTL_S}s — removed from the "
                                 "fleet; its admission share "
                                 "redistributes on the next refresh"),
                        proxy=pid)
                except Exception:
                    pass

    async def ensure_loop(self) -> bool:
        if self._loop_task is None:
            # HA: a freshly (re)created controller restores the last
            # checkpoint BEFORE its first reconcile, so live replicas
            # from the previous incarnation are ADOPTED into the routing
            # table instead of being cold-started next to orphans
            if not self.apps:
                await asyncio.get_running_loop().run_in_executor(
                    None, self._restore_checkpoint)
            self._loop_task = asyncio.ensure_future(self._reconcile_loop())
        return True

    # ------------------------------------------------- HA checkpointing
    def _checkpoint_state(self) -> dict:
        """Serializable controller state. Monotonic marks/deadlines are
        stored as AGES/REMAINING seconds (a restarted process has a new
        monotonic clock)."""
        now = time.monotonic()
        return {
            "apps": self.apps,
            "version": self.version,
            "replicas": {k: list(v) for k, v in self.replicas.items()},
            "draining": [(h, max(0.0, dl - now))
                         for h, dl in self._draining],
            "updating": {k: {"old": list(st["old"]),
                             "warming": list(st["warming"]),
                             "drain_timeout_s": st["drain_timeout_s"]}
                         for k, st in self._updating.items()},
            "migrating": {k: {"victims": list(st["victims"]),
                              "warming": list(st["warming"]),
                              "drain_timeout_s": st["drain_timeout_s"]}
                          for k, st in self._migrating.items()},
            "scale_marks": {k: now - first
                            for k, first in self._scale_marks.items()},
            "autoscale_status": dict(self._autoscale_status),
            "proxies": {pid: {"proto": rec["proto"], "port": rec["port"],
                              "age_s": now - rec["last_seen"]}
                        for pid, rec in self._proxies.items()},
        }

    def _save_checkpoint(self):
        """Write controller state to the GCS KV (sync; callers run it in
        an executor). Best-effort: serving must not depend on it."""
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            blob = cloudpickle.dumps(self._checkpoint_state())
            cw.io.run(cw.gcs.kv_put(CKPT_KEY, blob,
                                    namespace=CKPT_NAMESPACE),
                      timeout=10.0)
        except Exception:
            self._log_reconcile_error("checkpoint")

    def _restore_checkpoint(self):
        """Rebuild state from the last checkpoint (sync, executor-run).
        Replica handles are restored as-is: the next reconcile pass
        filters dead ones via _alive() and tops live sets up to target —
        adoption, not cold start."""
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            blob = cw.io.run(cw.gcs.kv_get(CKPT_KEY,
                                           namespace=CKPT_NAMESPACE),
                             timeout=10.0)
        except Exception:
            return
        if not blob:
            return
        try:
            state = cloudpickle.loads(blob)
            now = time.monotonic()
            self.apps = state.get("apps", {})
            # version bump past the checkpoint: every handle/proxy gets
            # a full table push on its next refresh (their cached
            # versions came from the dead incarnation)
            self.version = int(state.get("version", 0)) + 1
            self.replicas = {k: list(v)
                             for k, v in state.get("replicas",
                                                   {}).items()}
            self._draining = [(h, now + rem)
                              for h, rem in state.get("draining", [])]
            self._updating = state.get("updating", {})
            self._migrating = state.get("migrating", {})
            self._scale_marks = {k: now - age for k, age in
                                 state.get("scale_marks", {}).items()}
            self._autoscale_status = state.get("autoscale_status", {})
            # adopt the proxy fleet too: ages carry over so a proxy that
            # died while the controller was down still expires on time;
            # live ones refresh within one heartbeat anyway
            self._proxies = {
                pid: {"proto": rec.get("proto", "http"),
                      "port": int(rec.get("port", 0)),
                      "last_seen": now - float(rec.get("age_s", 0.0))}
                for pid, rec in state.get("proxies", {}).items()}
            adopted = sum(len(v) for v in self.replicas.values())
            from ray_tpu_torch.core.gcs_event_manager import emit_cluster_event

            emit_cluster_event(
                source="serve", kind="serve_controller_restored",
                severity="WARNING",
                message=(f"serve controller restored from checkpoint: "
                         f"{len(self.apps)} app(s), {adopted} replica "
                         "handle(s) adopted for reconciliation"),
                apps=list(self.apps), replicas=adopted)
        except Exception:
            self._log_reconcile_error("restore")

    # ---------------------------------------------------------- app deploy
    @staticmethod
    def _spec_version(spec: dict) -> str:
        """Content hash of the parts of a spec that require a replica
        restart to take effect (code + construction args)."""
        import hashlib

        h = hashlib.sha256()
        h.update(spec.get("callable_blob") or b"")
        h.update(repr((spec.get("init_args"), spec.get("init_kwargs"),
                       spec.get("user_config"))).encode())
        return h.hexdigest()

    async def deploy_application(self, app_name: str,
                                 dep_specs: list[dict]) -> bool:
        import ray_tpu_torch as rt

        new = {spec["name"]: spec for spec in dep_specs}
        old = self.apps.get(app_name, {})
        removed = set(old) - set(new)
        # deployments whose code/args changed: VERSION REPLACE. Old
        # replicas STAY in the routing table and keep serving; the
        # reconcile loop warms new-version replicas and retires one old
        # replica per ready new one — zero requests dropped (ref:
        # deployment_state.py rolling update).
        replaced = {d for d in set(old) & set(new)
                    if self._spec_version(old[d]) != self._spec_version(new[d])}
        for dep_name in removed:
            drain_s = float(old.get(dep_name, {}).get(
                "drain_timeout_s", 30.0) or 0)
            deadline = time.monotonic() + drain_s
            for handle in self.replicas.pop((app_name, dep_name), []):
                self._draining.append((handle, deadline))
            self._abandon_update((app_name, dep_name))
            self._signal_cache.pop((app_name, dep_name), None)
            self._autoscale_status.pop(f"{app_name}/{dep_name}", None)
        for dep_name in replaced:
            key = (app_name, dep_name)
            # update-of-an-update: abandoned warming replicas die
            self._abandon_update(key)
            self._updating[key] = {
                "old": list(self.replicas.get(key, [])),
                "warming": [],
                "drain_timeout_s": float(new[dep_name].get(
                    "drain_timeout_s", 30.0) or 0),
            }
        if removed:
            self.version += 1
        self.apps[app_name] = new
        await self._reconcile()
        await asyncio.get_running_loop().run_in_executor(
            None, self._save_checkpoint)
        return True

    @staticmethod
    def _kill_quietly(handle):
        import ray_tpu_torch as rt

        try:
            rt.kill(handle)
        except Exception:
            pass

    def _abandon_update(self, key: tuple):
        """Kill warming (unrouted) replicas of a cancelled update so a
        removed/deleted deployment can't leak actors."""
        st = self._updating.pop(key, None)
        if st is not None:
            for h in st["warming"]:
                self._kill_quietly(h)
        mig = self._migrating.pop(key, None)
        if mig is not None:
            for h in mig["warming"]:
                self._kill_quietly(h)

    async def delete_application(self, app_name: str) -> bool:
        import ray_tpu_torch as rt

        specs = self.apps.pop(app_name, None)
        if specs is None:
            return False
        for dep_name in specs:
            for handle in self.replicas.pop((app_name, dep_name), []):
                self._kill_quietly(handle)
            self._abandon_update((app_name, dep_name))
            self._signal_cache.pop((app_name, dep_name), None)
            self._autoscale_status.pop(f"{app_name}/{dep_name}", None)
        self.version += 1
        # purge the app's request-observability ledger (retained
        # records, pending partials, engine baselines) — a redeploy
        # starts clean
        try:
            from ray_tpu_torch.serve.request_context import publish_record

            publish_record({"kind": "app_deleted", "app": app_name})
        except Exception:
            pass
        await asyncio.get_running_loop().run_in_executor(
            None, self._save_checkpoint)
        return True

    def list_applications(self) -> list[str]:
        return list(self.apps)

    def get_deployments(self, app_name: str) -> list[dict]:
        return [
            {"name": spec["name"],
             "num_replicas": len(self.replicas.get((app_name, spec["name"]),
                                                   []))}
            for spec in self.apps.get(app_name, {}).values()]

    # ------------------------------------------------------------- routing
    def get_routing_table(self, known_version: int = -1) -> Optional[dict]:
        """Replica handles per (app, deployment); None = unchanged."""
        if known_version == self.version:
            return None
        table = {}
        for (app, dep), handles in self.replicas.items():
            table[f"{app}/{dep}"] = list(handles)
        return {"version": self.version, "table": table}

    def get_route_info(self, known_version: int, key: str) -> dict:
        """One-RPC handle refresh: routing-table delta (None when the
        version is current) + this deployment's replica load snapshot
        (cross-handle pow-2 signal; ref: replica queue-length cache) +
        the deployment's max_ongoing_requests so routers/proxies can
        size saturation thresholds and admission windows."""
        app, _, dep = key.partition("/")
        spec = self.apps.get(app, {}).get(dep, {})
        return {"update": self.get_routing_table(known_version),
                "load": self._replica_load.get((app, dep), {}),
                "max_ongoing": int(spec.get("max_ongoing_requests", 16)),
                "live_proxies": self._live_proxy_count()}

    def get_autoscale_status(self) -> dict:
        """Last autoscale decision per 'app/dep' (desired demand, the
        post-hysteresis target actually applied, live count, and the
        metric signals that fed the decision)."""
        return dict(self._autoscale_status)

    async def wait_ready(self, app_name: str, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            specs = self.apps.get(app_name, {})
            if specs and all(
                    len(self.replicas.get((app_name, d), [])) >= 1
                    for d in specs):
                return True
            await asyncio.sleep(0.1)
        return False

    # ----------------------------------------------------------- reconcile
    async def _reconcile_loop(self):
        while True:
            try:
                await self._reconcile()
            except Exception:
                self._log_reconcile_error("reconcile")
            try:
                await self._migrate_tick()
            except Exception:
                self._log_reconcile_error("migrate")
            try:
                await self._drain_tick()
            except Exception:
                self._log_reconcile_error("drain")
            try:
                await self._self_evacuate_tick()
            except Exception:
                self._log_reconcile_error("self-evacuate")
            try:
                self._proxy_tick()
            except Exception:
                self._log_reconcile_error("proxy-fleet")
            await asyncio.sleep(0.5)

    def _log_reconcile_error(self, phase: str):
        now = time.monotonic()
        if now - self._last_err_log < RECONCILE_ERR_LOG_INTERVAL_S:
            return
        self._last_err_log = now
        try:
            from ray_tpu_torch._internal.logging_utils import setup_logger

            setup_logger("serve_controller").warning(
                "serve controller %s tick failed (loop keeps running; "
                "further errors suppressed for %.0fs):\n%s",
                phase, RECONCILE_ERR_LOG_INTERVAL_S,
                traceback.format_exc())
        except Exception:
            pass  # logging must never take the loop down with it

    async def _self_evacuate_tick(self):
        """The controller itself may sit on a DRAINING node — nothing
        else can move it (max_restarts=0, and only IT can hand off its
        fleet safely). Once every replica hand-off has settled, save a
        final checkpoint and exit: the next handle request self-heals a
        fresh controller, which the draining label places on a live node
        and which ADOPTS the running replicas from the checkpoint."""
        if self._migrating or self._updating or self._draining:
            return  # hand-offs still in flight; finish them first
        import os

        me = os.environ.get("RAYT_NODE_ID", "")
        if not me or me not in self._draining_nodes():
            return
        try:
            from ray_tpu_torch.core.gcs_event_manager import emit_cluster_event

            emit_cluster_event(
                source="serve", kind="serve_controller_evacuating",
                severity="WARNING",
                message=("serve controller exiting draining node "
                         f"{me[:12]}; a handle will self-heal it onto "
                         "a live node from its checkpoint"))
        except Exception:
            pass
        self._save_checkpoint()
        os._exit(0)

    def _draining_nodes(self) -> set:
        """Node hexes currently DRAINING per the GCS drain state
        machine (core/gcs.py rpc_drain_node), cached ~1s so the 0.5s
        reconcile cadence doesn't double-query."""
        now = time.monotonic()
        cached, ts = self._drain_cache
        if now - ts < 1.0:
            return cached
        nodes = cached  # keep the last view across a control-plane hiccup
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()
            status = cw.io.run(cw.gcs.conn.call("get_drain_status"),
                               timeout=5.0)
            nodes = {h for h, rec in (status or {}).items()
                     if rec.get("state") == "DRAINING"}
        except Exception:
            pass
        self._drain_cache = (nodes, now)
        return nodes

    def _replica_node(self, handle) -> str:
        from ray_tpu_torch.core.object_ref import get_core_worker

        try:
            cw = get_core_worker()
            info = cw.io.run(cw.gcs.conn.call("get_actor_info",
                                              handle._actor_id))
            return (info.node_id.hex()
                    if info is not None and info.node_id else "")
        except Exception:
            return ""

    async def _migrate_tick(self):
        """Proactive replica migration off DRAINING nodes (the serve leg
        of the node drain protocol). Make-before-break, mirroring
        _step_update: replacements warm FIRST (the draining label keeps
        them off the doomed node); a victim leaves the routing table only
        when its replacement is READY, then finishes in-flight requests
        on the _draining list — zero admitted-request failures."""
        if not self.apps:
            return
        draining_nodes = self._draining_nodes()
        if not draining_nodes and not self._migrating:
            return
        changed = False
        for app_name, specs in list(self.apps.items()):
            for dep_name, spec in specs.items():
                key = (app_name, dep_name)
                if key in self._updating:
                    continue  # the rolling update already replaces these
                live = self.replicas.get(key, [])
                mig = self._migrating.get(key)
                if mig is None:
                    if not draining_nodes:
                        continue
                    victims = [h for h in live
                               if self._replica_node(h) in draining_nodes]
                    if not victims:
                        continue
                    mig = self._migrating[key] = {
                        "victims": victims, "warming": [],
                        "drain_timeout_s": float(spec.get(
                            "drain_timeout_s", 30.0) or 0),
                    }
                    try:
                        from ray_tpu_torch.core.gcs_event_manager import \
                            emit_cluster_event

                        emit_cluster_event(
                            source="serve", kind="serve_replicas_migrating",
                            severity="WARNING",
                            message=(f"{app_name}/{dep_name}: "
                                     f"{len(victims)} replica(s) on "
                                     "draining node(s); warming "
                                     "replacements before de-routing"),
                            app=app_name, deployment=dep_name,
                            victims=len(victims))
                    except Exception:
                        pass
                # victims that died on their own leave the queue (the
                # reconcile target loop replaces them the ordinary way)
                mig["victims"] = [h for h in mig["victims"] if h in live]
                while len(mig["warming"]) < len(mig["victims"]):
                    mig["warming"].append(
                        self._start_replica(app_name, spec))
                ready, still = [], []
                for h in mig["warming"]:
                    if await self._is_ready(h):
                        ready.append(h)
                    else:
                        still.append(h)
                mig["warming"] = still
                for h in ready:
                    live.append(h)      # route the replacement in ...
                    changed = True
                    if mig["victims"]:  # ... and de-route one victim
                        victim = mig["victims"].pop()
                        if victim in live:
                            live.remove(victim)
                        self._draining.append(
                            (victim,
                             time.monotonic() + mig["drain_timeout_s"]))
                if not mig["victims"] and not mig["warming"]:
                    del self._migrating[key]
        if changed:
            self.version += 1
            await asyncio.get_running_loop().run_in_executor(
                None, self._save_checkpoint)

    async def _drain_tick(self):
        """Kill draining (de-routed) replicas once their in-flight requests
        finish, or at the drain deadline."""
        import ray_tpu_torch as rt

        if not self._draining:
            return
        keep = []
        for handle, deadline in self._draining:
            done = time.monotonic() >= deadline
            if not done:
                try:
                    stats = await asyncio.get_running_loop().run_in_executor(
                        None, lambda h=handle: rt.get(h.get_stats.remote(),
                                                      timeout=5))
                    done = stats["ongoing"] <= 0
                except Exception:
                    # a transient stats timeout under load must NOT kill a
                    # replica mid-request; only a dead actor stops draining
                    done = not self._alive(handle)
            if done:
                try:
                    rt.kill(handle)
                except Exception:
                    pass
            else:
                keep.append((handle, deadline))
        self._draining = keep

    async def _reconcile(self):
        # non-reentrant: deploy_application's eager reconcile and the
        # background loop interleave at await points; double-stepping a
        # rolling update would double-start/retire replicas
        if self._reconcile_lock is None:
            self._reconcile_lock = asyncio.Lock()
        async with self._reconcile_lock:
            await self._reconcile_locked()

    async def _reconcile_locked(self):
        import ray_tpu_torch as rt

        changed = False
        for app_name, specs in list(self.apps.items()):
            for dep_name, spec in specs.items():
                key = (app_name, dep_name)
                live = [h for h in self.replicas.get(key, [])
                        if self._alive(h)]
                live = await self._probe_health(key, spec, live)
                if len(live) != len(self.replicas.get(key, [])):
                    changed = True
                self.replicas[key] = live
                stats = await self._collect_stats(key)
                self._replica_load[key] = {
                    i: v for i, v in enumerate(stats or [])
                    if v is not None}
                if key in self._updating:
                    changed |= await self._step_update(key, spec, live)
                    continue
                target = await self._target_replicas(key, spec, len(live),
                                                     stats)
                while len(live) < target:
                    handle = self._start_replica(app_name, spec)
                    live.append(handle)
                    changed = True
                while len(live) > target:
                    victim = live.pop()
                    self._kill_quietly(victim)
                    changed = True
        if changed:
            self.version += 1
            # replica-set changes checkpoint so a bounced controller
            # adopts the CURRENT fleet, not the one deploy() created
            await asyncio.get_running_loop().run_in_executor(
                None, self._save_checkpoint)

    async def _step_update(self, key: tuple, spec: dict,
                           live: list) -> bool:
        """One tick of a rolling version replace: warm new-version
        replicas toward the target, and for each one that becomes READY
        route it in and move one old replica to draining. Old replicas
        keep serving the whole time, so no request window ever has an
        empty routing table."""
        st = self._updating[key]
        app_name, dep_name = key
        # re-read the CURRENT spec: this reconcile pass may have captured
        # its spec dict before the deploy that created this update (the
        # lock serializes passes, not the iteration snapshot) — warming
        # from the stale spec would "update" to the old version
        spec = self.apps.get(app_name, {}).get(dep_name, spec)
        target = spec.get("num_replicas", 1)
        changed = False
        # old replicas that died on their own shrink the retire queue
        st["old"] = [h for h in st["old"] if h in live]
        while len(st["warming"]) + self._new_count(key, live) < target:
            st["warming"].append(self._start_replica(app_name, spec))
        ready, still = [], []
        for h in st["warming"]:
            if await self._is_ready(h):
                ready.append(h)
            else:
                still.append(h)
        st["warming"] = still
        for h in ready:
            live.append(h)      # route the new-version replica in ...
            changed = True
            if st["old"]:       # ... and retire one old-version replica
                self._retire_old(st, live)
        if self._new_count(key, live) >= target:
            # downscaling update: once the new version covers the target,
            # retire EVERY remaining old replica (one-for-one swaps alone
            # would strand the excess serving the old version forever)
            while st["old"]:
                self._retire_old(st, live)
                changed = True
        if not st["old"] and not st["warming"]:
            del self._updating[key]   # update complete
        return changed

    def _retire_old(self, st: dict, live: list):
        victim = st["old"].pop()
        if victim in live:
            live.remove(victim)
        self._draining.append(
            (victim, time.monotonic() + st["drain_timeout_s"]))

    def _new_count(self, key: tuple, live: list) -> int:
        st = self._updating.get(key)
        if st is None:
            return len(live)
        return len([h for h in live if h not in st["old"]])

    async def _is_ready(self, handle) -> bool:
        import ray_tpu_torch as rt

        try:
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: rt.get(handle.check_health.remote(),
                                     timeout=5))
            return True
        except Exception:
            return False

    async def _probe_health(self, key: tuple, spec: dict,
                            live: list) -> list:
        """Active replica health checks (ref: deployment_state.py health
        probes): every health_check_period_s call check_health() on each
        routed replica; consecutive failures past the threshold kill the
        replica — the target loop then replaces it."""
        import ray_tpu_torch as rt

        period = float(spec.get("health_check_period_s", 10.0) or 0)
        if period <= 0:
            return live
        now = time.monotonic()
        if now - self._last_probe.get(key, 0.0) < period:
            return live
        self._last_probe[key] = now
        threshold = int(spec.get("health_check_failure_threshold", 2))
        healthy = []
        for h in live:
            hexid = h._actor_id.hex()
            if self._constructing(h):
                # still in its constructor (a replica building an engine on
                # the card can take longer than two failed probes): a probe
                # would wait behind it, time out and count as a failure
                healthy.append(h)
                continue
            try:
                ok = await asyncio.get_running_loop().run_in_executor(
                    None, lambda h=h: rt.get(
                        h.check_health.remote(),
                        timeout=float(spec.get("health_check_timeout_s",
                                               5.0))))
                ok = bool(ok)
            except Exception:
                ok = False
            if ok:
                self._health_fails.pop(hexid, None)
                healthy.append(h)
                continue
            fails = self._health_fails.get(hexid, 0) + 1
            self._health_fails[hexid] = fails
            if fails >= threshold:
                self._health_fails.pop(hexid, None)
                self._kill_quietly(h)   # replaced by the target loop
            else:
                healthy.append(h)       # not yet past the threshold
        return healthy

    def _actor_state(self, handle) -> Optional[str]:
        """The replica actor's GCS state (None on a transient error)."""
        from ray_tpu_torch.core.common import ActorState
        from ray_tpu_torch.core.object_ref import get_core_worker

        try:
            cw = get_core_worker()
            info = cw.io.run(cw.gcs.conn.call(
                "get_actor_info", handle._actor_id))
        except Exception:
            return None
        return ActorState.DEAD if info is None else info.state

    def _alive(self, handle) -> bool:
        from ray_tpu_torch.core.common import ActorState

        # assume alive on transient errors
        return self._actor_state(handle) != ActorState.DEAD

    def _constructing(self, handle) -> bool:
        """True while the replica's constructor runs: the GCS marks an
        actor ALIVE only once its creation task has returned."""
        from ray_tpu_torch.core.common import ActorState

        return self._actor_state(handle) == ActorState.PENDING

    def _start_replica(self, app_name: str, spec: dict):
        import ray_tpu_torch as rt
        from ray_tpu_torch.serve.replica import ReplicaActor

        opts = dict(spec.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 0)
        opts["max_concurrency"] = max(
            spec.get("max_ongoing_requests", 16), 16) + 4  # +stats/health
        cls = rt.remote(**opts)(ReplicaActor)
        return cls.remote(spec["name"], app_name, spec["callable_blob"],
                          spec.get("init_args", ()),
                          spec.get("init_kwargs", {}),
                          spec.get("user_config"),
                          spec.get("max_ongoing_requests", 16))

    # --------------------------------------------------------- autoscaling
    def _metrics_signals(self, key: tuple, window_s: float) -> dict:
        """Per-deployment QPS / p99 latency / router queue depth from the
        GCS metrics store (PR-1 pipeline): the demand signals replicas
        can't see themselves. QPS is the served-request rate
        (rayt_serve_requests_total), latency the cross-node p99
        (rayt_serve_request_latency_s), queue depth the merged sum of
        every handle's capacity-gate gauge (rayt_serve_handle_queued).
        Best-effort: an empty store or a query hiccup yields Nones and
        the ongoing-requests signal alone drives the decision. Cached
        ~1s so a 0.5s reconcile cadence doesn't double-query."""
        cached = self._signal_cache.get(key)
        now = time.monotonic()
        if cached is not None and now - cached[1] < 1.0:
            return cached[0]
        app, dep = key
        tags = {"app": app, "deployment": dep}
        window_s = max(float(window_s or 30.0), 10.0)
        out = {"qps": None, "p99_latency_s": None, "queued": None}
        try:
            from ray_tpu_torch.core.object_ref import get_core_worker

            cw = get_core_worker()

            def q(name, agg, win=window_s):
                res = cw.io.run(cw.gcs.conn.call("metrics_query", {
                    "name": name, "window_s": win, "agg": agg,
                    "tags": tags, "merge": True}))
                pts = [v for s in (res or {}).get("series", [])
                       for _, v in s.get("points", []) if v is not None]
                return pts

            qps = q("rayt_serve_requests_total", "rate")
            if qps:
                # mean of the trailing points smooths bin-edge jitter
                tail = qps[-3:]
                out["qps"] = sum(tail) / len(tail)
            lat = q("rayt_serve_request_latency_s", "p99")
            if lat:
                out["p99_latency_s"] = lat[-1]
            # deliberately SHORT window: a client killed while parked
            # never emits its trailing 0, so its phantom gauge must age
            # out fast (hysteresis covers the remaining seconds)
            queued = q("rayt_serve_handle_queued", "last", win=15.0)
            if queued:
                out["queued"] = queued[-1]
        except Exception:
            pass
        self._signal_cache[key] = (out, now)
        return out

    def _emit_decision(self, key: tuple, target: int, desired: int,
                       live: int, signals: dict):
        app, dep = key
        self._autoscale_status[f"{app}/{dep}"] = {
            "target": int(target), "desired": int(desired),
            "live": int(live), "signals": dict(signals),
            "ts": time.time()}
        try:
            from ray_tpu_torch.util import builtin_metrics as bm

            bm.serve_autoscale_decision.set(
                float(target), tags={"app": app, "deployment": dep})
        except Exception:
            pass
        if target != live:
            # a replica-count CHANGE is a scheduling-plane event (the
            # same inputs as rayt_serve_autoscale_decision, made
            # queryable next to node/worker lifecycle in the log);
            # unchanged decisions stay metric-only — no per-tick spam
            from ray_tpu_torch.core.gcs_event_manager import emit_cluster_event

            emit_cluster_event(
                source="serve", kind="serve_autoscale",
                message=(f"{app}/{dep}: replicas {live} -> {target} "
                         f"(desired {desired}; qps="
                         f"{signals.get('qps')}, queued="
                         f"{signals.get('queued')}, p99="
                         f"{signals.get('p99_latency_s')})"),
                app=app, deployment=dep, live=int(live),
                target=int(target), desired=int(desired),
                **{f"signal_{k}": v for k, v in signals.items()})

    async def _target_replicas(self, key: tuple, spec: dict,
                               live: int, stats=None) -> int:
        auto = spec.get("autoscaling_config")
        if auto is None:
            return spec.get("num_replicas", 1)
        auto = cloudpickle.loads(auto) if isinstance(auto, bytes) else auto
        if stats is None:
            stats = await self._collect_stats(key)
        if stats is None:
            return max(live, auto.min_replicas)
        signals = self._metrics_signals(
            key, getattr(auto, "metrics_window_s", 30.0))
        ongoing = sum(v for v in stats if v is not None)
        # demand = max over the signals that are live; router queue depth
        # folds into the ongoing signal (queued requests are demand the
        # saturated replicas can't report themselves)
        queued = signals.get("queued") or 0.0
        load = ongoing + max(0.0, queued)
        desired = (int(math.ceil(
            load / max(1e-6, float(auto.target_ongoing_requests))))
            if load > 0 else auto.min_replicas)
        target_qps = getattr(auto, "target_qps_per_replica", None)
        if target_qps and signals.get("qps"):
            desired = max(desired, int(math.ceil(
                signals["qps"] / float(target_qps))))
        lat_target = getattr(auto, "latency_target_s", None)
        if lat_target and (signals.get("p99_latency_s") or 0) > lat_target:
            desired = max(desired, live + 1)  # one step per decision
        desired = max(auto.min_replicas,
                      min(auto.max_replicas, desired))
        target = self._apply_hysteresis(key, auto, live, desired)
        self._emit_decision(key, target, desired, live, signals)
        return target

    def _apply_hysteresis(self, key: tuple, auto, live: int,
                          desired: int) -> int:
        """The desired direction must hold continuously for the up/down
        delay before replicas move (no flapping inside the window)."""
        now = time.monotonic()
        if desired > live:
            first = self._scale_marks.setdefault((key, "up"), now)
            self._scale_marks.pop((key, "down"), None)
            if now - first >= auto.upscale_delay_s:
                self._scale_marks.pop((key, "up"), None)
                return desired
            return live
        if desired < live:
            first = self._scale_marks.setdefault((key, "down"), now)
            self._scale_marks.pop((key, "up"), None)
            if now - first >= auto.downscale_delay_s:
                self._scale_marks.pop((key, "down"), None)
                return desired
            return live
        self._scale_marks.pop((key, "up"), None)
        self._scale_marks.pop((key, "down"), None)
        return live

    async def _collect_stats(self, key: tuple) -> Optional[list]:
        """Per-replica ongoing counts, POSITION-ALIGNED with
        self.replicas[key]; an unreachable replica yields None at its slot
        (dropping it would shift later replicas' loads onto earlier ones
        in the router's index-keyed view)."""
        import ray_tpu_torch as rt

        handles = self.replicas.get(key, [])
        if not handles:
            return None
        out: list = []
        for h in handles:
            try:
                stats = await asyncio.get_running_loop().run_in_executor(
                    None, lambda h=h: rt.get(h.get_stats.remote(),
                                             timeout=5))
                out.append(float(stats["ongoing"]))
            except Exception:
                out.append(None)
        return out if any(v is not None for v in out) else None
