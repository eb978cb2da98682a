"""gRPC ingress proxy (ref analog: python/ray/serve/_private/proxy.py
gRPC data plane + grpc_util/: the reference serves user-defined proto
services; this ingress exposes a generic byte-level service so callers
don't need generated stubs).

Service (full method names):
  /rayt.serve.Serve/Predict        unary-unary
  /rayt.serve.Serve/PredictStream  unary-stream

Request bytes: JSON {"app": <name>, "payload": <json value>,
"model_id": <optional>}; response bytes: JSON value per result (one per
stream message for PredictStream). Runs inside an async actor next to
the HTTP proxy, sharing the same DeploymentHandle routing path.

Mirrors the HTTP proxy's admission control and status split (see
serve/admission.py): shed / replica queue-full / timeout abort with
RESOURCE_EXHAUSTED or UNAVAILABLE (retry semantics), replica user-code
exceptions with INTERNAL.
"""

from __future__ import annotations

import json
import time
from typing import Any

from ray_tpu_torch.serve.admission import (AdmissionWindow, count_admitted,
                                           count_shed, is_overload_error,
                                           request_timeout_s, retry_after_s)

_SERVICE = "rayt.serve.Serve"


class GrpcProxyActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float | None = None,
                 admission_headroom: float | None = None,
                 proxy_id: str = "grpc-0"):
        self.host = host
        self.port = port
        self.proxy_id = proxy_id
        self._handles: dict[str, Any] = {}
        self._ingress: dict[str, str] = {}
        self._server = None
        self._timeout_override = request_timeout_s
        self._admission = AdmissionWindow(admission_headroom, proxy_id)
        self._hb_thread = None

    # ------------------------------------------------------------- control
    def register_app(self, app_name: str, ingress_deployment: str) -> bool:
        self._ingress[app_name] = ingress_deployment
        self._handles.pop(app_name, None)
        return True

    def unregister_app(self, app_name: str) -> bool:
        self._ingress.pop(app_name, None)
        self._handles.pop(app_name, None)
        return True

    def admission_snapshot(self) -> dict:
        return {**self._admission.snapshot(),
                **self._admission.fleet_snapshot()}

    async def start(self) -> int:
        import grpc

        proxy = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == f"/{_SERVICE}/Predict":
                    return grpc.unary_unary_rpc_method_handler(
                        proxy._predict)
                if details.method == f"/{_SERVICE}/PredictStream":
                    return grpc.unary_stream_rpc_method_handler(
                        proxy._predict_stream)
                return None

        self._server = grpc.server(
            __import__("concurrent.futures", fromlist=["f"])
            .ThreadPoolExecutor(max_workers=8),
            options=[("grpc.so_reuseport", 0)])
        self._server.add_generic_rpc_handlers((_Generic(),))
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        self._server.start()
        self._start_heartbeat()
        return self.port

    def _start_heartbeat(self):
        """Daemon-thread controller heartbeat (the gRPC server runs on
        plain threads, no event loop): same fleet-membership beat as the
        HTTP proxy, so the gRPC ingress counts toward live_proxies and
        admits its share of the shared cluster window."""
        import threading

        from ray_tpu_torch.serve.proxy import HEARTBEAT_PERIOD_S

        def _loop():
            import ray_tpu_torch as rt
            from ray_tpu_torch.serve.controller import CONTROLLER_NAME

            while True:
                try:
                    controller = rt.get_actor(CONTROLLER_NAME)
                    rt.get(controller.proxy_heartbeat.remote(
                        self.proxy_id, "grpc", self.port), timeout=5)
                except Exception:
                    pass  # controller bouncing: keep serving
                time.sleep(HEARTBEAT_PERIOD_S)

        self._hb_thread = threading.Thread(
            target=_loop, name="grpc-proxy-heartbeat", daemon=True)
        self._hb_thread.start()

    async def stop(self):
        if self._server is not None:
            self._server.stop(grace=1.0)

    # --------------------------------------------------------------- data
    def _resolve(self, request_bytes: bytes):
        import grpc

        req = json.loads(request_bytes)
        app_name = req.get("app")
        ingress = self._ingress.get(app_name)
        if ingress is None:
            raise _Abort(grpc.StatusCode.NOT_FOUND,
                         f"no app {app_name!r}")
        handle = self._handles.get(app_name)
        if handle is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            handle = DeploymentHandle(ingress, app_name)
            self._handles[app_name] = handle
        model_id = req.get("model_id") or ""
        from ray_tpu_torch.serve.admission import queue_timeout_s
        from ray_tpu_torch.serve.handle import derive_prefix_key

        payload = req.get("payload")
        # bound the capacity-gate park by the request timeout (shed as
        # backpressure instead of queueing into a deadline); prefix key
        # mirrors the HTTP proxy's prefix-cache-aware routing
        handle = handle.options(
            multiplexed_model_id=model_id or None,
            queue_timeout_s=min(queue_timeout_s(),
                                self._request_timeout()),
            prefix_key=derive_prefix_key(payload) or None)
        return app_name, handle, payload, model_id

    # --------------------------------------- request-path observability
    def _new_context(self, context) -> dict:
        """Mint the request id (parity with the HTTP proxy's
        X-Rayt-Request-Id: echoed to the caller as initial metadata,
        alongside x-rayt-proxy-id naming the fleet member that served
        it) and start the request context that rides the handle
        envelope."""
        from ray_tpu_torch.serve.request_context import mint_request_id

        rid = mint_request_id()
        try:
            context.send_initial_metadata(
                (("x-rayt-request-id", rid),
                 ("x-rayt-proxy-id", self.proxy_id)))
        except Exception:
            pass
        return {"request_id": rid, "start_ts": time.time(),
                "proxy": self.proxy_id}

    @staticmethod
    def _record(ctx: dict, app_name: str, outcome: str, **kw):
        """Same record shape as the HTTP side — one assembly path, so
        `rayt list requests` / summaries treat both protos uniformly."""
        from ray_tpu_torch.serve.proxy import ProxyActor

        ProxyActor._finish_record(ctx, app_name, outcome, proto="grpc",
                                  **kw)

    def _request_timeout(self) -> float:
        if self._timeout_override is not None:
            return float(self._timeout_override)
        return request_timeout_s()

    def _admit(self, app_name: str, handle):
        """Admission gate; raises _Abort(RESOURCE_EXHAUSTED) on shed.
        Returns once this request holds a window slot."""
        import grpc

        try:
            replicas, max_ongoing, live = handle.capacity_info()
        except Exception:
            replicas, max_ongoing, live = 1, 16, 1
        if not self._admission.try_acquire(app_name, replicas,
                                           max_ongoing, live):
            count_shed(app_name, self.proxy_id, "shed")
            raise _Abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"admission window full for app {app_name!r}; "
                f"retry after {retry_after_s()}s")
        count_admitted(app_name, self.proxy_id)

    def _abort_for(self, app_name: str, e: Exception) -> "_Abort":
        """Mirror the HTTP 503/500 split onto gRPC codes."""
        import grpc

        from ray_tpu_torch.core.common import GetTimeoutError

        if isinstance(e, GetTimeoutError):
            count_shed(app_name, self.proxy_id, "timeout")
            return _Abort(
                grpc.StatusCode.UNAVAILABLE,
                f"request exceeded {self._request_timeout():.0f}s "
                f"(RAYT_SERVE_REQUEST_TIMEOUT_S); retry after "
                f"{retry_after_s()}s")
        if is_overload_error(e):
            count_shed(app_name, self.proxy_id, "queue_full")
            return _Abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED,
                f"replicas at capacity: {e!r}; retry after "
                f"{retry_after_s()}s")
        if isinstance(e, RuntimeError) and "no replicas" in str(e):
            count_shed(app_name, self.proxy_id, "no_replicas")
            return _Abort(grpc.StatusCode.UNAVAILABLE, repr(e))
        return _Abort(grpc.StatusCode.INTERNAL, repr(e))

    def _predict(self, request_bytes: bytes, context) -> bytes:
        from ray_tpu_torch._internal.otel import (current_context_carrier,
                                                  submit_span)

        t0 = time.perf_counter()
        try:
            app_name, handle, payload, model_id = \
                self._resolve(request_bytes)
        except _Abort as e:
            context.abort(e.code, e.detail)
            return
        ctx = self._new_context(context)
        handle = handle.options(request_context=ctx)
        with submit_span("serve.proxy.request", app=app_name,
                         request_id=ctx["request_id"], proto="grpc"):
            try:
                ctx["trace"] = current_context_carrier()
            except Exception:
                pass
            try:
                self._admit(app_name, handle)
            except _Abort as e:
                self._record(ctx, app_name, "shed", t0=t0)
                context.abort(e.code, e.detail)
                return
            t1 = time.perf_counter()
            try:
                result = handle.remote(payload).result(
                    timeout=self._request_timeout())
                self._record(ctx, app_name, "ok", t0=t0, t1=t1,
                             model_id=model_id)
                return json.dumps(result, default=str).encode()
            except Exception as e:
                from ray_tpu_torch.serve.proxy import ProxyActor

                self._record(ctx, app_name, ProxyActor._outcome_for(e),
                             t0=t0, t1=t1, model_id=model_id)
                a = self._abort_for(app_name, e)
                context.abort(a.code, a.detail)
            finally:
                self._admission.release(app_name)

    def _predict_stream(self, request_bytes: bytes, context):
        from ray_tpu_torch._internal.otel import (current_context_carrier,
                                                  submit_span)

        t0 = time.perf_counter()
        try:
            app_name, handle, payload, model_id = \
                self._resolve(request_bytes)
        except _Abort as e:
            context.abort(e.code, e.detail)
            return
        ctx = self._new_context(context)
        handle = handle.options(request_context=ctx)
        with submit_span("serve.proxy.request", app=app_name,
                         request_id=ctx["request_id"], proto="grpc"):
            try:
                ctx["trace"] = current_context_carrier()
            except Exception:
                pass
            try:
                self._admit(app_name, handle)
            except _Abort as e:
                self._record(ctx, app_name, "shed", t0=t0)
                context.abort(e.code, e.detail)
                return
            t1 = time.perf_counter()
            t_first = None
            chunks = 0
            try:
                for item in handle.options(stream=True).remote(payload):
                    if t_first is None:
                        t_first = time.perf_counter()
                    chunks += 1
                    yield json.dumps(item, default=str).encode()
                t_end = time.perf_counter()
                self._record(
                    ctx, app_name, "ok", t0=t0, t1=t1, t_first=t_first,
                    t_end=t_end, model_id=model_id,
                    ttft_s=(t_first - t0) if t_first is not None
                    else None,
                    tpot_s=((t_end - t_first) / (chunks - 1)
                            if t_first is not None and chunks > 1
                            else None),
                    chunks=chunks)
            except Exception as e:
                from ray_tpu_torch.serve.proxy import ProxyActor

                # before the first message the caller still gets a real
                # status code; after it, this is a mid-stream abort —
                # same outcome split as the HTTP SSE path
                outcome = ("stream_aborted" if chunks
                           else ProxyActor._outcome_for(e))
                self._record(ctx, app_name, outcome, t0=t0, t1=t1,
                             t_first=t_first, model_id=model_id,
                             chunks=chunks)
                a = self._abort_for(app_name, e)
                context.abort(a.code, a.detail)
            finally:
                self._admission.release(app_name)


class _Abort(Exception):
    def __init__(self, code, detail):
        self.code = code
        self.detail = detail
