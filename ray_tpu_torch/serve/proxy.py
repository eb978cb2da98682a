"""HTTP ingress proxy (ref analog: python/ray/serve/_private/proxy.py:1135
— uvicorn in the reference; aiohttp here).

Routes: POST/GET /<app_name> (body JSON becomes the request payload) →
app ingress handle → JSON response. Runs as an async actor; blocking
ObjectRef gets ride a DEDICATED thread executor (sized by
``RAYT_SERVE_PROXY_THREADS``) so the event loop keeps accepting — and
shedding — connections even when every worker thread is parked on a
result.

Admission control (see serve/admission.py): each request first passes
the per-app admission window sized from the routing table (replicas x
max_ongoing_requests x headroom). The capacity read is CACHED (~1s) and
refreshed off the request path on a small auxiliary executor, so the
accept/shed decision itself never needs a thread from the (possibly
saturated) request executor: shed requests answer 503 + ``Retry-After``
straight from the event loop — no executor thread, no replica traffic —
keeping a flat, fast rejection path under exactly the overload the
window exists for. Status mapping: 503 for overload/backpressure/
timeout (reasons ``shed`` / ``queue_full`` / ``timeout`` /
``no_replicas`` in the JSON body and the X-Rayt-Reason header), 500
ONLY for an exception raised by the replica's user code. Streaming
requests route BEFORE the SSE response is prepared, so an overloaded
stream sheds with a real 503 too (mid-stream failures degrade to an
``event: error`` frame — the 200 is already on the wire).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Any

from ray_tpu_torch.serve.admission import (AdmissionWindow, count_admitted,
                                           count_shed, is_overload_error,
                                           request_timeout_s, retry_after_s)

PROXY_THREADS_ENV = "RAYT_SERVE_PROXY_THREADS"

# routing-table capacity cache TTL: admission windows follow replica
# scaling within this bound without an RPC per request
CAPACITY_TTL_S = 1.0

# controller heartbeat cadence: liveness TTL is 3x this (see
# controller.PROXY_TTL_S), so a dead proxy's window share redistributes
# to the survivors within one capacity refresh after the TTL lapses
HEARTBEAT_PERIOD_S = 1.0


class ProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000,
                 request_timeout_s: float | None = None,
                 admission_headroom: float | None = None,
                 proxy_id: str = "http-0"):
        self.host = host
        self.port = port
        self.proxy_id = proxy_id
        self._handles: dict[str, Any] = {}
        self._ingress: dict[str, str] = {}
        self._runner = None
        self._executor = None       # admitted-request result waits
        self._aux_executor = None   # capacity refreshes (never starved
        # by admitted requests parking on results)
        self._timeout_override = request_timeout_s
        self._admission = AdmissionWindow(admission_headroom, proxy_id)
        self._capacity: dict[str, tuple[int, int, int, float]] = {}
        self._cap_refreshing: set[str] = set()
        self._hb_task = None

    async def start(self) -> int:
        from concurrent.futures import ThreadPoolExecutor

        from aiohttp import web

        self._executor = ThreadPoolExecutor(
            max_workers=int(os.environ.get(PROXY_THREADS_ENV, "128")),
            thread_name_prefix="serve-proxy")
        self._aux_executor = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="serve-proxy-cap")
        app = web.Application()
        app.router.add_route("*", "/-/routes", self._routes_endpoint)
        app.router.add_route("*", "/-/healthz", self._healthz)
        app.router.add_route("*", "/-/admission", self._admission_endpoint)
        app.router.add_route("*", "/{app_name}", self._dispatch)
        app.router.add_route("*", "/{app_name}/{tail:.*}", self._dispatch)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        for s in site._server.sockets:
            self.port = s.getsockname()[1]
            break
        self._hb_task = asyncio.create_task(self._heartbeat_loop())
        return self.port

    async def _heartbeat_loop(self):
        """Announce liveness to the controller ~1/s. ``live_proxies``
        rides the routing table back to every proxy's window math, so
        this beat is all the fleet coordination there is: a member that
        stops beating ages out after controller.PROXY_TTL_S and its
        admission share redistributes on the next capacity refresh."""
        import ray_tpu_torch as rt
        from ray_tpu_torch.serve.controller import CONTROLLER_NAME

        loop = asyncio.get_running_loop()

        def _beat():
            try:
                controller = rt.get_actor(CONTROLLER_NAME)
                rt.get(controller.proxy_heartbeat.remote(
                    self.proxy_id, "http", self.port), timeout=5)
            except Exception:
                pass  # controller bouncing: keep serving, beat again

        while True:
            await loop.run_in_executor(self._aux_executor, _beat)
            await asyncio.sleep(HEARTBEAT_PERIOD_S)

    def register_app(self, app_name: str, ingress_deployment: str) -> bool:
        self._ingress[app_name] = ingress_deployment
        self._handles.pop(app_name, None)
        self._capacity.pop(app_name, None)
        return True

    def unregister_app(self, app_name: str) -> bool:
        self._ingress.pop(app_name, None)
        self._handles.pop(app_name, None)
        self._capacity.pop(app_name, None)
        return True

    async def _healthz(self, request):
        from aiohttp import web

        return web.Response(text="ok")

    async def _routes_endpoint(self, request):
        from aiohttp import web

        return web.json_response(dict(self._ingress))

    async def _admission_endpoint(self, request):
        from aiohttp import web

        return web.json_response({**self._admission.snapshot(),
                                  **self._admission.fleet_snapshot()})

    def _request_timeout(self) -> float:
        if self._timeout_override is not None:
            return float(self._timeout_override)
        return request_timeout_s()

    def _unavailable(self, app_name: str, reason: str, detail: str):
        """503 + Retry-After: overload/backpressure/timeout semantics —
        the client should back off and retry, nothing is broken."""
        from aiohttp import web

        retry = retry_after_s()
        count_shed(app_name, self.proxy_id, reason)
        return web.json_response(
            {"error": detail, "reason": reason, "retry_after_s": retry},
            status=503,
            headers={"Retry-After": str(retry),
                     "X-Rayt-Reason": reason,
                     "X-Rayt-Proxy-Id": self.proxy_id})

    async def _app_capacity(self, app_name: str, handle,
                            loop) -> tuple[int, int, int]:
        """(replicas, max_ongoing, live_proxies) from the ~1s cache.
        Only the COLD read (first request for an app) waits on an RPC —
        and on the aux executor, not the request executor, so a
        saturated proxy still sheds instantly. Stale entries refresh in
        the background while the current value keeps serving decisions.
        live_proxies riding this same refresh is what redistributes a
        dead proxy's admission share within one table refresh."""
        cap = self._capacity.get(app_name)
        now = time.monotonic()
        if cap is None:
            try:
                replicas, max_ongoing, live = await loop.run_in_executor(
                    self._aux_executor, handle.capacity_info)
            except Exception:
                replicas, max_ongoing, live = 1, 16, 1  # table warming up
            self._capacity[app_name] = (replicas, max_ongoing, live,
                                        time.monotonic())
            return replicas, max_ongoing, live
        replicas, max_ongoing, live, ts = cap
        if now - ts > CAPACITY_TTL_S and \
                app_name not in self._cap_refreshing:
            self._cap_refreshing.add(app_name)

            def _refresh():
                try:
                    r, m, lp = handle.capacity_info()
                    self._capacity[app_name] = (r, m, lp,
                                                time.monotonic())
                except Exception:
                    self._capacity[app_name] = (replicas, max_ongoing,
                                                live, time.monotonic())
                finally:
                    self._cap_refreshing.discard(app_name)

            self._aux_executor.submit(_refresh)
        return replicas, max_ongoing, live

    async def _dispatch(self, request):
        from aiohttp import web

        t0 = time.perf_counter()
        app_name = request.match_info["app_name"]
        ingress = self._ingress.get(app_name)
        if ingress is None:
            return web.json_response(
                {"error": f"no app {app_name!r}"}, status=404)
        handle = self._handles.get(app_name)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(ingress, app_name)
            self._handles[app_name] = handle
        # request id: minted once per (resolved) request, echoed on
        # every response — 503s included — and rides the handle context
        # into the replica so both sides' partial GCS records coalesce
        from ray_tpu_torch._internal.otel import (current_context_carrier,
                                                  submit_span)
        from ray_tpu_torch.serve.request_context import mint_request_id

        rid = mint_request_id()
        ctx = {"request_id": rid, "start_ts": time.time(),
               "proxy": self.proxy_id}
        if request.can_read_body:
            try:
                payload = await request.json()
            except json.JSONDecodeError:
                payload = (await request.read()).decode()
        else:
            payload = dict(request.query)
        # streaming: ?stream=1 or Accept: text/event-stream gets an SSE
        # response fed by the replica's generator (ref: serve response
        # streaming through the proxy)
        wants_stream = (request.query.get("stream") == "1"
                        or "text/event-stream" in
                        request.headers.get("Accept", ""))
        loop = asyncio.get_running_loop()
        with submit_span("serve.proxy.request", app=app_name,
                         request_id=rid, proto="http",
                         path=request.path):
            try:
                # W3C carrier captured INSIDE the proxy span: the
                # replica's execute_span parents off it, stitching one
                # trace across the two processes
                ctx["trace"] = current_context_carrier()
            except Exception:
                pass
            # ---- admission: window sized from the (cached) routing-
            # table capacity; accept/shed is sync + fast on the event
            # loop. This proxy admits its SHARE of the cluster window
            # (cluster / live_proxies) — see serve/admission.py.
            replicas, max_ongoing, live = await self._app_capacity(
                app_name, handle, loop)
            if not self._admission.try_acquire(app_name, replicas,
                                               max_ongoing, live):
                resp = self._unavailable(
                    app_name, "shed",
                    f"admission window full for app {app_name!r} (window="
                    f"{self._admission.window_for(replicas, max_ongoing, live)}"
                    f", live_proxies={live})")
                resp.headers["X-Rayt-Request-Id"] = rid
                self._finish_record(ctx, app_name, "shed", t0=t0)
                return resp
            t1 = time.perf_counter()
            count_admitted(app_name, self.proxy_id)
            # model multiplexing (ref: serve proxy forwards the model-id
            # header); the router's capacity-gate park is bounded by the
            # request timeout — a request that can't find a replica slot
            # in time is SHED (503 queue_full), never left queueing to
            # timeout
            from ray_tpu_torch.serve.admission import queue_timeout_s

            model_id = request.headers.get("serve_multiplexed_model_id",
                                           "")
            # prefix-cache-aware routing: hash the prompt's leading
            # token block into a key the router's prefix-affinity LRU
            # steers toward replicas holding the warm KV state
            from ray_tpu_torch.serve.handle import derive_prefix_key

            prefix_key = derive_prefix_key(payload)
            handle = handle.options(
                multiplexed_model_id=model_id or None,
                queue_timeout_s=min(queue_timeout_s(),
                                    self._request_timeout()),
                request_context=ctx,
                prefix_key=prefix_key or None)
            try:
                if wants_stream:
                    return await self._dispatch_stream(
                        request, handle, app_name, payload, ctx, t0, t1,
                        model_id)
                return await self._dispatch_unary(
                    handle, app_name, payload, loop, ctx, t0, t1,
                    model_id)
            finally:
                self._admission.release(app_name)

    def _error_response(self, app_name: str, e: Exception):
        """Map a routing/replica failure onto the 503/500 split."""
        from aiohttp import web
        from ray_tpu_torch.core.common import GetTimeoutError

        if isinstance(e, GetTimeoutError):
            return self._unavailable(
                app_name, "timeout",
                f"request exceeded {self._request_timeout():.0f}s "
                "(RAYT_SERVE_REQUEST_TIMEOUT_S)")
        if is_overload_error(e):
            return self._unavailable(app_name, "queue_full", repr(e))
        if isinstance(e, RuntimeError) and "no replicas" in str(e):
            return self._unavailable(app_name, "no_replicas", repr(e))
        # a replica-raised user exception: a real 500
        return web.json_response({"error": repr(e)}, status=500)

    @staticmethod
    def _outcome_for(e: Exception) -> str:
        """Record outcome for a failed dispatch — mirrors the
        _error_response status mapping."""
        from ray_tpu_torch.core.common import GetTimeoutError

        if isinstance(e, GetTimeoutError):
            return "timeout"
        if is_overload_error(e):
            return "queue_full"
        if isinstance(e, RuntimeError) and "no replicas" in str(e):
            return "no_replicas"
        return "error"

    @staticmethod
    def _finish_record(ctx: dict, app_name: str, outcome: str, *,
                       t0: float, t1: float | None = None,
                       t_first: float | None = None,
                       t_end: float | None = None, proto: str = "http",
                       model_id: str = "", ttft_s: float | None = None,
                       tpot_s: float | None = None, chunks: int = 0):
        """Assemble and publish this request's FINAL record (one publish
        per request, batched off the hot path). The proxy stages TILE
        the end-to-end wall time by construction: admission (t1-t0) +
        router (accumulated by pick()) + dispatch (remainder up to first
        output or completion) + stream (first output -> end)."""
        try:
            from ray_tpu_torch.serve.request_context import publish_record

            if t_end is None:
                t_end = time.perf_counter()
            e2e = t_end - t0
            router_s = float(ctx.get("router_s") or 0.0)
            if t1 is None:
                # shed at the admission gate: the whole request was
                # admission time, by definition
                stages = {"admission_s": e2e}
            else:
                boundary = t_first if t_first is not None else t_end
                stages = {"admission_s": t1 - t0,
                          "router_s": router_s,
                          "dispatch_s": max(0.0,
                                            (boundary - t1) - router_s)}
                if t_first is not None:
                    stages["stream_s"] = t_end - t_first
            rec = {"kind": "request", "side": "proxy", "final": True,
                   "request_id": ctx["request_id"], "app": app_name,
                   "proto": proto, "outcome": outcome, "e2e_s": e2e,
                   "stages": stages, "pid_proxy": os.getpid(),
                   "start_ts": ctx.get("start_ts"), "ts": time.time()}
            if model_id:
                rec["model_id"] = model_id
            if ctx.get("replica"):
                rec["replica"] = ctx["replica"]
            if ctx.get("affinity"):
                rec["affinity"] = ctx["affinity"]
            if ctx.get("proxy"):
                rec["proxy"] = ctx["proxy"]
            if ctx.get("prefix"):
                rec["prefix_cache"] = ctx["prefix"]
            if ttft_s is not None:
                rec["ttft_s"] = ttft_s
            if tpot_s is not None:
                rec["tpot_s"] = tpot_s
            if chunks:
                rec["chunks"] = chunks
            publish_record(rec)
        except Exception:
            pass  # observability must never fail the request

    async def _dispatch_unary(self, handle, app_name, payload, loop,
                              ctx, t0, t1, model_id):
        from aiohttp import web

        timeout = self._request_timeout()
        try:
            response = await loop.run_in_executor(
                self._executor,
                lambda: handle.remote(payload).result(timeout=timeout))
        except Exception as e:
            resp = self._error_response(app_name, e)
            resp.headers["X-Rayt-Request-Id"] = ctx["request_id"]
            resp.headers["X-Rayt-Proxy-Id"] = self.proxy_id
            self._finish_record(ctx, app_name, self._outcome_for(e),
                                t0=t0, t1=t1, model_id=model_id)
            return resp
        self._finish_record(ctx, app_name, "ok", t0=t0, t1=t1,
                            model_id=model_id)
        if isinstance(response, (dict, list, str, int, float, bool,
                                 type(None))):
            resp = web.json_response({"result": response})
        else:
            resp = web.Response(body=str(response).encode())
        resp.headers["X-Rayt-Request-Id"] = ctx["request_id"]
        resp.headers["X-Rayt-Proxy-Id"] = self.proxy_id
        return resp

    def _observe_stream_latency(self, app_name: str, seconds: float):
        """Streaming requests record into the serve latency histogram
        too (they previously bypassed it entirely — the only serve
        latency series came from replica-side handler timing); the
        `_proxy_stream` pseudo-deployment keeps this client-visible
        series distinct from the replica's."""
        try:
            from ray_tpu_torch.util import builtin_metrics as bm

            bm.serve_request_latency.observe(
                seconds, tags={"app": app_name,
                               "deployment": "_proxy_stream"})
        except Exception:
            pass

    async def _dispatch_stream(self, request, handle, app_name, payload,
                               ctx, t0, t1, model_id):
        from aiohttp import web

        loop = asyncio.get_running_loop()
        if isinstance(payload, dict):
            payload.pop("stream", None)
        # route BEFORE preparing the SSE response: an overloaded /
        # replica-less stream must shed with a real 503, not a 200
        # carrying an error frame
        try:
            gen = await loop.run_in_executor(
                self._executor,
                lambda: handle.options(stream=True).remote(payload))
        except Exception as e:
            resp = self._error_response(app_name, e)
            resp.headers["X-Rayt-Request-Id"] = ctx["request_id"]
            resp.headers["X-Rayt-Proxy-Id"] = self.proxy_id
            self._finish_record(ctx, app_name, self._outcome_for(e),
                                t0=t0, t1=t1, model_id=model_id)
            return resp
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache",
                     "X-Rayt-Request-Id": ctx["request_id"],
                     "X-Rayt-Proxy-Id": self.proxy_id})
        await resp.prepare(request)
        # TTFT stamps at the FIRST SSE chunk, the total at stream END —
        # a streaming request's latency is its last byte, not the
        # instant the 200 went on the wire. A mid-stream failure or a
        # client hang-up finalizes as `stream_aborted`, never silence.
        t_first = None
        chunks = 0
        outcome = "ok"
        try:
            async for item in gen:
                if t_first is None:
                    t_first = time.perf_counter()
                chunks += 1
                await resp.write(
                    f"data: {json.dumps(item, default=str)}\n\n".encode())
        except (ConnectionResetError, ConnectionError):
            outcome = "stream_aborted"  # client went away;
            # gen.close() stops the replica
        except Exception as e:
            # mid-stream failure: the 200 is already on the wire — an
            # error frame is the only channel left
            outcome = "stream_aborted"
            try:
                await resp.write(
                    f"event: error\ndata: "
                    f"{json.dumps(repr(e))}\n\n".encode())
            except Exception:
                pass
        finally:
            gen.close()
        t_end = time.perf_counter()
        ttft = (t_first - t0) if t_first is not None else None
        tpot = ((t_end - t_first) / (chunks - 1)
                if t_first is not None and chunks > 1 else None)
        self._finish_record(ctx, app_name, outcome, t0=t0, t1=t1,
                            t_first=t_first, t_end=t_end,
                            model_id=model_id, ttft_s=ttft, tpot_s=tpot,
                            chunks=chunks)
        self._observe_stream_latency(app_name, t_end - t0)
        try:
            await resp.write_eof()
        except Exception:
            pass
        return resp
