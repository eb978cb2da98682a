"""DeploymentHandle + router (ref analogs:
python/ray/serve/handle.py, _private/router.py:321,
_private/replica_scheduler/pow_2_scheduler.py:52).

Routing is power-of-two-choices over per-replica load — the max of the
controller-reported ongoing count (cross-handle signal, refreshed each
reconcile tick) and this handle family's own in-flight count (exact and
instantaneous for its traffic). Routing tables refresh from the
controller on a short TTL (the long-poll analog), keyed by a version
counter so unchanged tables cost one RPC.

Capacity gate: a request never dispatches to a replica whose load is at
``max_ongoing_requests``. When EVERY replica is saturated the request
parks in the handle (bounded by ``RAYT_SERVE_QUEUE_TIMEOUT_S``) instead
of piling into replica actor queues; the park count is exported as the
``rayt_serve_handle_queued`` gauge — the autoscaler's queue-depth
signal. Past the deadline, ReplicaOverloadedError surfaces (the ingress
maps it to 503).

Model multiplexing routes by AFFINITY: each model id remembers the
replicas that served it (their multiplex LRUs hold the adapter). Repeat
traffic prefers the least-loaded unsaturated affinity replica and only
spills to power-of-two-choices when every affinity target is saturated
— the spill target then joins the affinity set, so a hot adapter's
working set grows with its load instead of thrashing replica caches.
Affinity entries are LRU at both levels (model ids, replicas per model)
and keyed by actor id, so a benign table refresh keeps them and a
replica removal drops exactly the dead entries.

A handle and all its ``options()`` clones share one router state
(table, in-flight counts, affinity), so a proxy that builds a per-model
clone per request still routes on complete local knowledge.

HA: the controller is a cached dependency, not a hard one. When the
route-info RPC fails (controller crashed, head bouncing) the router
keeps serving from its LAST table — requests go directly to replica
actors, which outlive the controller — while it re-resolves the named
controller in the background of each refresh (throttled). Re-resolution
uses ``serve._controller(create=True)``: if nothing else has restarted
the controller, the first surviving handle recreates it and the new
controller restores its GCS checkpoint, so the control plane self-heals
from the data plane. A GCS reconnect (head restart) registers a hook
that forces a full-table resync (version -1) since the restarted
control plane's version counter is not comparable to ours.
"""

from __future__ import annotations

import hashlib
import os
import random
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Optional

PREFIX_BLOCK_ENV = "RAYT_SERVE_PREFIX_BLOCK"


def _get_controller():
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    return rt.get_actor(CONTROLLER_NAME)


def prefix_block_tokens(default: int = 16) -> int:
    """Prefix-routing block size in tokens (0 disables prefix keys)."""
    try:
        return int(os.environ.get(PREFIX_BLOCK_ENV, default))
    except (TypeError, ValueError):
        return default


def derive_prefix_key(payload, block: int | None = None) -> str:
    """Hash a prompt's LEADING token block into a routing key.

    Requests whose prompts share the first ``block`` tokens (a system
    prompt, a shared document header) map to the same key and route to
    replicas whose engine already holds that prefix's KV rows. The key
    is first-block granularity on purpose: the ENGINE extends the match
    to the longest block-aligned prefix it has cached (llm.py), the
    router only needs a stable bucket. Prompts shorter than one block
    get no key ("") — nothing worth reusing."""
    if block is None:
        block = prefix_block_tokens()
    if block <= 0 or not isinstance(payload, dict):
        return ""
    tokens = payload.get("tokens")
    if isinstance(tokens, str):
        tokens = list(tokens.encode())
    if not isinstance(tokens, (list, tuple)) or len(tokens) < block:
        return ""
    try:
        head = ",".join(str(int(t)) for t in tokens[:block])
    except (TypeError, ValueError):
        return ""
    return hashlib.sha1(head.encode()).hexdigest()[:16]


class _RouterState:
    """Routing state shared by a handle family (a DeploymentHandle and
    every options() clone): routing table + version, controller load
    snapshot, local in-flight counts (actor-id-keyed so they survive
    table refreshes), and the model-affinity LRU."""

    MAX_MODELS = 1024             # affinity LRU: model-id entries
    MAX_REPLICAS_PER_MODEL = 4    # affinity LRU: replicas per model id
    MAX_PREFIXES = 4096           # prefix LRU: (model, prefix) entries
    MAX_REPLICAS_PER_PREFIX = 2   # prefix LRU: keep the warm set tight
    # (a prefix's KV lives in at most a couple of engines — spreading
    # wider than the engine prefix caches can hold just evicts them)

    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self.key = f"{app_name}/{deployment_name}"
        self.lock = threading.Lock()
        # parked pickers wait here; done()/table updates notify so a
        # freed slot wakes a waiter immediately instead of being found
        # by a poll (the 50ms wait cap only re-checks deadlines/TTL)
        self.capacity_freed = threading.Condition(self.lock)
        self.controller = None
        self.table_version = -1
        self.replicas: list = []
        self.hexes: list[str] = []       # actor-id hex, aligned w/ replicas
        self.table_ts = 0.0
        self.load: dict[int, float] = {}  # controller-reported, index-keyed
        self.max_ongoing = 16
        self.inflight: dict[str, int] = {}   # actor hex -> local in-flight
        # model id -> OrderedDict[replica hex] (most-recent last)
        self.model_affinity: OrderedDict[str, OrderedDict[str, None]] = \
            OrderedDict()
        # (model id, prefix key) -> OrderedDict[replica hex]: the
        # prefix-cache extension of the multiplex LRU — same double-LRU
        # mechanics, same churn semantics (benign refresh keeps entries,
        # replica removal drops exactly the dead hexes)
        self.prefix_affinity: OrderedDict[tuple, OrderedDict[str, None]] \
            = OrderedDict()
        self.live_proxies = 1     # fleet size from the last table refresh
        self.handle_hex = uuid.uuid4().hex[:8]
        self.waiting = 0                  # requests parked in the gate
        self._last_heal = 0.0             # controller re-resolve throttle
        self._reconnect_hooked = False

    # ------------------------------------------------------------- refresh
    def refresh(self, force: bool = False):
        now = time.monotonic()
        with self.lock:
            fresh = now - self.table_ts < 1.0 and self.replicas
            if fresh and not force:
                return
        self._ensure_reconnect_hook()
        import ray_tpu_torch as rt

        try:
            if self.controller is None:
                self.controller = _get_controller()
                force = True   # new controller handle: full table
            known = -1 if force else self.table_version
            info = rt.get(
                self.controller.get_route_info.remote(known, self.key),
                timeout=30)
        except Exception:
            # controller unreachable (crashed / head bouncing): drop the
            # cached handle and try to re-resolve — recreating restores
            # the controller's GCS checkpoint, so a surviving handle
            # self-heals the control plane
            self.controller = None
            info = None
            healed = self._heal_controller()
            if healed is not None:
                try:
                    info = rt.get(
                        healed.get_route_info.remote(-1, self.key),
                        timeout=30)
                    self.controller = healed
                except Exception:
                    info = None
            if info is None:
                with self.lock:
                    if self.replicas:
                        # stale-while-error: keep routing on the last
                        # table (replicas outlive the controller);
                        # bumping table_ts rate-limits the retries
                        self.table_ts = time.monotonic()
                        return
                raise
        self.apply_route_info(info, now)

    def _heal_controller(self):
        """Re-resolve (and, if gone, recreate) the named controller.
        Throttled so every parked request in a proxy does not stampede
        ``ensure_loop`` during a head bounce."""
        now = time.monotonic()
        with self.lock:
            if now - self._last_heal < 2.0:
                return None
            self._last_heal = now
        try:
            from ray_tpu_torch import serve as _serve

            return _serve._controller(create=True)
        except Exception:
            return None

    def _ensure_reconnect_hook(self):
        """After a GCS reconnect (head restart) the control plane's
        version counter restarts too — force a full-table resync and a
        controller re-resolution on the next refresh."""
        if self._reconnect_hooked:
            return
        import weakref

        try:
            from ray_tpu_torch.api import _core_worker

            cw = _core_worker()
            ref = weakref.ref(self)

            def _on_gcs_reconnect():
                state = ref()
                if state is None:
                    return
                with state.lock:
                    state.table_version = -1
                    state.table_ts = 0.0
                state.controller = None

            cw.gcs.on_reconnect.append(_on_gcs_reconnect)
            self._reconnect_hooked = True
        except Exception:
            pass

    def apply_route_info(self, info: dict, now: float | None = None):
        update = info.get("update")
        with self.lock:
            self.table_ts = time.monotonic() if now is None else now
            self.load = dict(info.get("load") or {})
            self.max_ongoing = int(info.get("max_ongoing") or 16)
            self.live_proxies = max(1, int(info.get("live_proxies") or 1))
            if update is None:
                return
            self.table_version = update["version"]
            self.replicas = update["table"].get(self.key, [])
            self.hexes = [r._actor_id.hex() for r in self.replicas]
            live = set(self.hexes)
            # table version changed: drop state for replicas no longer
            # routed; entries for still-routed replicas survive (a benign
            # refresh keeps affinity, a removal clears exactly its entries)
            self.inflight = {h: c for h, c in self.inflight.items()
                             if h in live}
            for mid in list(self.model_affinity):
                reps = self.model_affinity[mid]
                for h in [h for h in reps if h not in live]:
                    del reps[h]
                if not reps:
                    del self.model_affinity[mid]
            for pk in list(self.prefix_affinity):
                reps = self.prefix_affinity[pk]
                for h in [h for h in reps if h not in live]:
                    del reps[h]
                if not reps:
                    del self.prefix_affinity[pk]
            self.capacity_freed.notify_all()  # new table may have slots

    # ------------------------------------------------------------- scoring
    def _score(self, idx: int, hex_: str) -> float:
        """Replica load = max(controller snapshot, local in-flight). The
        snapshot already CONTAINS this family's dispatched requests, so
        summing would double-count; max() is exact when this family is
        the replica's only client (the ingress-proxy case) and stays a
        lower bound otherwise."""
        return max(float(self.load.get(idx, 0.0)),
                   float(self.inflight.get(hex_, 0)))

    def _record_affinity(self, model_id: str, hex_: str):
        reps = self.model_affinity.get(model_id)
        if reps is None:
            reps = self.model_affinity[model_id] = OrderedDict()
        reps[hex_] = None
        reps.move_to_end(hex_)
        while len(reps) > self.MAX_REPLICAS_PER_MODEL:
            reps.popitem(last=False)
        self.model_affinity.move_to_end(model_id)
        while len(self.model_affinity) > self.MAX_MODELS:
            self.model_affinity.popitem(last=False)

    def _record_prefix_affinity(self, pkey: tuple, hex_: str):
        reps = self.prefix_affinity.get(pkey)
        if reps is None:
            reps = self.prefix_affinity[pkey] = OrderedDict()
        reps[hex_] = None
        reps.move_to_end(hex_)
        while len(reps) > self.MAX_REPLICAS_PER_PREFIX:
            reps.popitem(last=False)
        self.prefix_affinity.move_to_end(pkey)
        while len(self.prefix_affinity) > self.MAX_PREFIXES:
            self.prefix_affinity.popitem(last=False)

    def _best_affine(self, reps, hex2idx):
        """Least-loaded UNSATURATED replica of an affinity set, or
        None when every member is saturated (callers hold the lock)."""
        best = None
        for h in reps:
            i = hex2idx.get(h)
            if i is None:
                continue
            s = self._score(i, h)
            if s < self.max_ongoing and (best is None or s < best[0]):
                best = (s, i, h)
        return best

    def _try_pick_locked(self, model_id: str, prefix_key: str = ""):
        """One routing attempt (callers hold the lock): returns
        (replica, hex, affinity, prefix) or None when every candidate is
        saturated. ``affinity`` is the multiplex routing outcome —
        "hit" (an affinity replica had a slot), "spill" (every affinity
        target saturated, pow-2 pick joins the set), "cold" (first
        request for the model id), "" (no model id). ``prefix`` is the
        same classification for the (model_id, prefix_key) warm set —
        a prefix "hit" lands on a replica whose engine holds the
        prompt's leading KV rows; prefix routing takes precedence over
        model affinity (a prefix entry implies the model is resident
        there too: the same replica served that exact workload)."""
        n = len(self.replicas)
        if n == 0:
            return None
        hex2idx = {h: i for i, h in enumerate(self.hexes)}
        affinity = ""
        prefix = ""
        if prefix_key:
            prefix = "cold"
            pkey = (model_id, prefix_key)
            preps = self.prefix_affinity.get(pkey)
            if preps:
                best = self._best_affine(preps, hex2idx)
                if best is not None:
                    self.prefix_affinity.move_to_end(pkey)
                    preps.move_to_end(best[2])
                    if model_id:
                        self._record_affinity(model_id, best[2])
                    return (self.replicas[best[1]], best[2],
                            "hit" if model_id else "", "hit")
                # warm replicas saturated: SPILL — the pow-2 pick below
                # joins the prefix set and warms up on this request
                prefix = "spill"
        if model_id:
            affinity = "cold"
            reps = self.model_affinity.get(model_id)
            if reps:
                best = self._best_affine(reps, hex2idx)
                if best is not None:
                    self.model_affinity.move_to_end(model_id)
                    reps.move_to_end(best[2])
                    if prefix_key:
                        self._record_prefix_affinity(
                            (model_id, prefix_key), best[2])
                    return self.replicas[best[1]], best[2], "hit", prefix
                # every affinity target saturated: SPILL to pow-2 below
                # (the spill target joins the affinity set)
                affinity = "spill"
        if n == 1:
            i = j = 0
        else:
            i, j = random.sample(range(n), 2)
        si = self._score(i, self.hexes[i])
        sj = self._score(j, self.hexes[j])
        pick, s = (i, si) if si <= sj else (j, sj)
        if s >= self.max_ongoing:
            # sampled pair saturated: fall back to a full argmin scan so
            # we only park when the WHOLE fleet is at capacity
            pick, s = min(
                ((k, self._score(k, self.hexes[k])) for k in range(n)),
                key=lambda t: t[1])
            if s >= self.max_ongoing:
                return None
        hex_ = self.hexes[pick]
        if model_id:
            self._record_affinity(model_id, hex_)
        if prefix_key:
            self._record_prefix_affinity((model_id, prefix_key), hex_)
        return self.replicas[pick], hex_, affinity, prefix

    # ---------------------------------------------------------------- pick
    def _emit_queued(self):
        try:
            from ray_tpu_torch.util import builtin_metrics as bm

            bm.serve_handle_queued.set(
                float(self.waiting),
                tags={"app": self.app_name,
                      "deployment": self.deployment_name,
                      "handle": self.handle_hex})
        except Exception:
            pass

    def pick(self, model_id: str, queue_timeout: float,
             ctx: Optional[dict] = None, prefix_key: str = ""):
        """Pick a replica and charge the local in-flight count; returns
        (replica, done). Parks while every replica is saturated, up to
        ``queue_timeout`` seconds. When a request-context dict rides
        along, the capacity-gate park time accumulates into its
        ``router_s`` stage and the routed replica / multiplex affinity
        outcome are stamped for the GCS request record."""
        from ray_tpu_torch.serve.admission import ReplicaOverloadedError

        t_pick = time.perf_counter()
        empty_deadline = time.monotonic() + 30.0
        queue_deadline = time.monotonic() + max(0.0, queue_timeout)
        parked = False
        last_emit = 0.0
        try:
            while True:
                self.refresh()
                with self.capacity_freed:
                    n = len(self.replicas)
                    got = (self._try_pick_locked(model_id, prefix_key)
                           if n else None)
                    if got is not None:
                        replica, hex_, affinity, prefix = got
                        self.inflight[hex_] = self.inflight.get(hex_, 0) + 1
                        if ctx is not None:
                            ctx["router_s"] = (
                                ctx.get("router_s", 0.0)
                                + (time.perf_counter() - t_pick))
                            ctx["replica"] = hex_
                            if affinity:
                                ctx["affinity"] = affinity
                            if prefix:
                                ctx["prefix"] = prefix
                        if affinity:
                            self._emit_affinity(affinity)
                        return replica, self._make_done(hex_)
                    now = time.monotonic()
                    if n and not parked:
                        parked = True
                        self.waiting += 1
                    if n and now <= queue_deadline:
                        # all replicas saturated: park until a slot
                        # frees (done()/table update notifies) — the
                        # wait cap only re-checks deadlines/TTL
                        self.capacity_freed.wait(timeout=0.05)
                if n == 0:
                    if now > empty_deadline:
                        raise RuntimeError(
                            f"no replicas for {self.key}")
                    time.sleep(0.1)
                    self.refresh(force=True)
                    continue
                if now > queue_deadline:
                    raise ReplicaOverloadedError(
                        f"all {n} replicas of {self.key} at "
                        f"max_ongoing_requests={self.max_ongoing} for "
                        f"{queue_timeout:.1f}s")
                # export the queue depth so the autoscaler sees the
                # unmet demand
                if now - last_emit > 0.25:
                    last_emit = now
                    self._emit_queued()
        except BaseException:
            # a failed pick (queue timeout / no replicas) still spent
            # wall time in the gate: attribute it, or the proxy's
            # waterfall would show the park as unattributed dispatch
            if ctx is not None:
                ctx["router_s"] = (ctx.get("router_s", 0.0)
                                   + (time.perf_counter() - t_pick))
            raise
        finally:
            if parked:
                with self.lock:
                    self.waiting -= 1
                self._emit_queued()

    def _emit_affinity(self, result: str):
        """Best-effort rayt_serve_affinity_total increment — the
        multiplex hit/spill ratio."""
        try:
            from ray_tpu_torch.util import builtin_metrics as bm

            bm.serve_affinity.inc(tags={"app": self.app_name,
                                        "result": result})
        except Exception:
            pass

    def _make_done(self, hex_: str):
        def done():
            with self.capacity_freed:
                n = self.inflight.get(hex_, 1)
                self.inflight[hex_] = max(0, n - 1)
                self.capacity_freed.notify_all()

        return done


class DeploymentResponse:
    """Future-like response (ref: serve handle DeploymentResponse).

    A request that raced a replica teardown (rolling update retiring it,
    health probe killing it) resolves to ActorDiedError — the router
    retries it on a live replica from a force-refreshed table, so
    clients never see the transient (ref: router retry of requests to
    draining/dead replicas). A replica-side queue-full
    (ReplicaOverloadedError) likewise resubmits through the router's
    capacity gate — which waits for a free slot — before surfacing as
    backpressure."""

    _MAX_DEAD_RETRIES = 3
    _MAX_OVERLOAD_RETRIES = 3

    def __init__(self, ref, on_done, resubmit=None):
        self._ref = ref
        self._on_done = on_done
        self._resubmit = resubmit
        self._done = False

    def _finish(self):
        if not self._done:
            self._done = True
            self._on_done()

    def result(self, timeout: Optional[float] = None) -> Any:
        import ray_tpu_torch as rt
        from ray_tpu_torch.core.common import ActorDiedError, GetTimeoutError
        from ray_tpu_torch.serve.admission import is_overload_error

        # ONE deadline across every retry: resubmits must not reset the
        # clock, or a caller's 60s timeout could hold an admission slot
        # for several multiples of that while attempts chain
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        dead = over = 0
        try:
            while True:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise GetTimeoutError(
                            f"request did not complete within "
                            f"{timeout:.1f}s (including retries)")
                else:
                    remaining = None
                try:
                    return rt.get(self._ref, timeout=remaining)
                except ActorDiedError:
                    if self._resubmit is None or \
                            dead >= self._MAX_DEAD_RETRIES:
                        raise
                    dead += 1
                except Exception as e:
                    if (not is_overload_error(e)
                            or self._resubmit is None
                            or over >= self._MAX_OVERLOAD_RETRIES):
                        raise
                    over += 1
                self._finish()  # release the failed attempt's slot
                self._ref, self._on_done = self._resubmit()
                self._done = False
        finally:
            self._finish()

    @property
    def ref(self):
        return self._ref


class DeploymentResponseGenerator:
    """Streaming response: iterate to receive items as the replica yields
    them (ref: serve DeploymentResponseGenerator over ObjectRefGenerator)."""

    def __init__(self, ref_gen, on_done):
        self._gen = ref_gen
        self._on_done = on_done
        self._done = False

    def _finish(self):
        if not self._done:
            self._done = True
            self._on_done()

    def close(self):
        """Cancel an abandoned stream (client disconnect): stops the
        producing replica and releases the in-flight routing count."""
        try:
            self._gen.close()
        except Exception:
            pass
        self._finish()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        import ray_tpu_torch as rt

        try:
            ref = next(self._gen)
        except StopIteration:
            self._finish()
            raise
        except Exception:
            self._finish()
            raise
        return rt.get(ref)

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        import ray_tpu_torch as rt

        loop = asyncio.get_running_loop()
        try:
            ref = await self._gen.__anext__()
        except StopAsyncIteration:
            self._finish()
            raise
        except Exception:
            self._finish()
            raise
        return await loop.run_in_executor(None, rt.get, ref)


class DeploymentHandle:
    def __init__(self, deployment_name: str, app_name: str = "default",
                 method_name: str = "__call__", stream: bool = False,
                 multiplexed_model_id: str = "",
                 retry_on_replica_death: bool = True,
                 queue_timeout_s: Optional[float] = None,
                 request_context: Optional[dict] = None,
                 prefix_key: str = "",
                 _router: Optional[_RouterState] = None):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self.method_name = method_name
        self.stream = stream
        self.multiplexed_model_id = multiplexed_model_id
        self.retry_on_replica_death = retry_on_replica_death
        self.queue_timeout_s = queue_timeout_s
        # prompt-prefix routing key (derive_prefix_key): requests
        # sharing it prefer replicas whose engine holds the warm KV
        self.prefix_key = prefix_key
        # per-request observability context (serve/request_context.py):
        # the ingress stamps request id / trace carrier here, the router
        # adds park time + affinity, and _submit_once forwards the wire
        # subset in the call envelope. Proxies build a per-request
        # options() clone, so one context never outlives its request.
        self.request_context = request_context
        self._router = _router or _RouterState(deployment_name, app_name)

    # picklable: runtime state rebuilds lazily in the new process
    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.app_name, self.method_name,
                 self.stream, self.multiplexed_model_id,
                 self.retry_on_replica_death, self.queue_timeout_s))

    def options(self, method_name: Optional[str] = None,
                stream: Optional[bool] = None,
                multiplexed_model_id: Optional[str] = None,
                retry_on_replica_death: Optional[bool] = None,
                queue_timeout_s: Optional[float] = None,
                request_context: Optional[dict] = None,
                prefix_key: Optional[str] = None
                ) -> "DeploymentHandle":
        return DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name or self.method_name,
            self.stream if stream is None else stream,
            self.multiplexed_model_id if multiplexed_model_id is None
            else multiplexed_model_id,
            self.retry_on_replica_death if retry_on_replica_death is None
            else retry_on_replica_death,
            self.queue_timeout_s if queue_timeout_s is None
            else queue_timeout_s,
            self.request_context if request_context is None
            else request_context,
            self.prefix_key if prefix_key is None else prefix_key,
            _router=self._router)  # clones share the router state

    # ------------------------------------------------- internals/back-compat
    @property
    def _model_affinity(self):
        return self._router.model_affinity

    @property
    def _load(self):
        return self._router.load

    @property
    def _replicas(self):
        return self._router.replicas

    @property
    def _inflight(self):
        return self._router.inflight

    def _refresh(self, force: bool = False):
        self._router.refresh(force=force)

    def _queue_timeout(self) -> float:
        if self.queue_timeout_s is not None:
            return float(self.queue_timeout_s)
        from ray_tpu_torch.serve.admission import queue_timeout_s

        return queue_timeout_s()

    def capacity(self) -> tuple[int, int]:
        """(num_replicas, max_ongoing_requests) from the current routing
        table — what the ingress proxies size admission windows from."""
        self._router.refresh()
        with self._router.lock:
            return (max(1, len(self._router.replicas)),
                    self._router.max_ongoing)

    def capacity_info(self) -> tuple[int, int, int]:
        """(num_replicas, max_ongoing_requests, live_proxies): the
        sharded-ingress capacity read — a proxy's admission window is
        the cluster window over live_proxies, recomputed per request
        from this (a dead proxy's share redistributes within one table
        refresh because the survivors read a smaller divisor here)."""
        self._router.refresh()
        with self._router.lock:
            return (max(1, len(self._router.replicas)),
                    self._router.max_ongoing,
                    self._router.live_proxies)

    # ---------------------------------------------------------------- call
    def _route(self):
        """Pick a replica and charge the family's in-flight count;
        returns (replica, done) where done releases the charge."""
        return self._router.pick(self.multiplexed_model_id,
                                 self._queue_timeout(),
                                 ctx=self.request_context,
                                 prefix_key=self.prefix_key)

    def _wire_context(self) -> Optional[dict]:
        """The envelope subset of the request context that crosses the
        process boundary: the request id keys the replica's partial GCS
        record, the W3C carrier stitches its span into the proxy's
        trace. Stamp times stay proxy-local (clocks don't line up)."""
        rc = self.request_context
        if not rc or not rc.get("request_id"):
            return None
        return {"request_id": rc["request_id"], "trace": rc.get("trace")}

    def _submit_once(self, args, kwargs):
        replica, done = self._route()
        ref = replica.handle_request.remote(
            self.method_name, args, kwargs, self.multiplexed_model_id,
            self._wire_context())
        return ref, done

    def remote(self, *args, **kwargs):
        """Submit a request; returns a DeploymentResponse (or generator
        for stream handles).

        Delivery semantics (unary, non-stream handles): by default a
        request whose replica dies is transparently resubmitted to a live
        replica, i.e. AT-LEAST-ONCE — a replica can die after partially
        or fully executing, so non-idempotent handlers may observe
        duplicate execution. Opt out with
        ``handle.options(retry_on_replica_death=False)`` to get
        at-most-once (the ActorDiedError surfaces to the caller).
        Stream handles are always at-most-once: a mid-stream replica
        death surfaces as ActorDiedError (replaying a partially consumed
        stream would re-deliver items)."""
        if self.stream:
            replica, done = self._route()
            ref_gen = replica.handle_request_streaming.options(
                num_returns="streaming").remote(
                self.method_name, args, kwargs, self.multiplexed_model_id,
                self._wire_context())
            return DeploymentResponseGenerator(ref_gen, done)
        ref, done = self._submit_once(args, kwargs)

        def resubmit():
            self._refresh(force=True)
            return self._submit_once(args, kwargs)

        return DeploymentResponse(
            ref, done,
            resubmit if self.retry_on_replica_death else None)
