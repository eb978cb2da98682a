"""ReplicaActor — hosts the user callable (ref analog:
python/ray/serve/_private/replica.py:750,807).

Async actor with high max_concurrency: sync user callables are pushed to
a thread executor so one slow request doesn't block the replica's event
loop; ongoing-request count backs both the router's power-of-two choices
and controller autoscaling.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import inspect
import os
import time
from typing import Any, Optional

import cloudpickle

# cumulative engine reports piggyback on the request-recording path at
# most this often (differenced into rates GCS-side)
_ENGINE_REPORT_INTERVAL_S = 2.0


class _HandleMarker:
    """Placeholder in init args for a composed deployment's handle."""

    def __init__(self, deployment_name: str, app_name: str):
        self.deployment_name = deployment_name
        self.app_name = app_name


class ReplicaActor:
    def __init__(self, deployment_name: str, app_name: str,
                 callable_blob: bytes, init_args: tuple, init_kwargs: dict,
                 user_config: Any = None, max_ongoing_requests: int = 16):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._ongoing = 0
        self._total = 0
        self._overloaded_rejects = 0
        self._max_ongoing = max(1, int(max_ongoing_requests))
        target = cloudpickle.loads(callable_blob)
        args = tuple(self._resolve(a) for a in init_args)
        kwargs = {k: self._resolve(v) for k, v in init_kwargs.items()}
        if isinstance(target, type):
            self._callable = target(*args, **kwargs)
        else:
            self._callable = target
        self._user_config = user_config
        self._last_engine_report = 0.0
        if user_config is not None:
            reconfigure = getattr(self._callable, "reconfigure", None)
            if reconfigure is not None:
                reconfigure(user_config)

    def _resolve(self, arg: Any) -> Any:
        if isinstance(arg, _HandleMarker):
            from ray_tpu_torch.serve.handle import DeploymentHandle

            return DeploymentHandle(arg.deployment_name, arg.app_name)
        return arg

    def _check_capacity(self):
        """Queue-full backpressure (ref analog: replica max_ongoing_requests
        enforcement): a replica at capacity REFUSES instead of queueing
        invisibly in the actor scheduler — the router retries another
        replica or waits for a slot, and the ingress maps an
        all-saturated timeout to 503, never a 500."""
        if self._ongoing >= self._max_ongoing:
            from ray_tpu_torch.serve.admission import ReplicaOverloadedError

            self._overloaded_rejects += 1
            raise ReplicaOverloadedError(
                f"replica {self.app_name}/{self.deployment_name} at "
                f"capacity ({self._ongoing}/{self._max_ongoing} ongoing)")

    def _record_request(self, t0: float):
        """QPS + latency telemetry (ref analog: serve's
        serve_deployment_request_counter / processing_latency_ms);
        batched per-process, never an RPC on the request path."""
        try:
            from ray_tpu_torch.util import builtin_metrics as bm

            tags = {"app": self.app_name,
                    "deployment": self.deployment_name}
            bm.serve_requests.inc(tags=tags)
            bm.serve_request_latency.observe(
                time.perf_counter() - t0, tags=tags)
        except Exception:
            pass
        self._maybe_engine_report()

    # --------------------------------------- request-path observability
    def _begin_request(self, ctx: Optional[dict]):
        """Per-request observability setup: the engine phase-stamp
        contextvar (llm.py's generate() picks it up) and the replica
        span, remote-parented off the proxy's W3C carrier so one trace
        spans both pids. Returns (obs, reset_token, span_cm)."""
        if not ctx or not ctx.get("request_id"):
            return None, None, contextlib.nullcontext()
        try:
            from ray_tpu_torch._internal.otel import execute_span
            from ray_tpu_torch.serve.request_context import _set_request_obs

            # the request's identity rides in obs so a composed callable
            # can forward it across its own handle calls (disagg
            # decode->prefill: same id, both sides coalesce into ONE
            # waterfall); engine_section() whitelists its output keys,
            # so identity never leaks into the engine record
            obs: dict = {"request_id": ctx["request_id"]}
            if ctx.get("trace"):
                obs["trace"] = ctx["trace"]
            token = _set_request_obs(obs)
            span = execute_span(
                "serve.replica", ctx.get("trace"),
                app=self.app_name, deployment=self.deployment_name,
                request_id=ctx["request_id"])
            return obs, token, span
        except Exception:
            return None, None, contextlib.nullcontext()

    def _end_request(self, ctx: Optional[dict], obs, token, model_id: str,
                     t0: float, t_start: Optional[float], t_end: float):
        """Publish this side's PARTIAL record (batched; the GCS serve
        manager coalesces it with the proxy's final by request id)."""
        if token is not None:
            try:
                from ray_tpu_torch.serve.request_context import \
                    _reset_request_obs

                _reset_request_obs(token)
            except Exception:
                pass
        if not ctx or not ctx.get("request_id"):
            return
        try:
            from ray_tpu_torch.serve.request_context import (engine_section,
                                                             publish_record)

            rec = {
                "kind": "request", "side": "replica",
                "request_id": ctx["request_id"],
                "app": self.app_name,
                "deployment": self.deployment_name,
                "pid_replica": os.getpid(),
                "ts": time.time(),
                # queue_s = executor-dispatch wait before user code ran;
                # service_s = user-code wall time. Nested under the
                # record, not part of the proxy's tiling (cross-process
                # clocks don't line up).
                "replica_stages": {
                    "queue_s": (t_start - t0)
                    if t_start is not None else None,
                    "service_s": (t_end - t_start)
                    if t_start is not None else (t_end - t0),
                },
            }
            if model_id:
                rec["model_id"] = model_id
            eng = engine_section(obs)
            if eng is not None:
                rec["engine"] = eng
            publish_record(rec)
        except Exception:
            pass

    def _engines(self) -> list:
        """Duck-typed discovery of engine objects hosted by the user
        callable: a plain ``engine`` attribute and/or the values of any
        multiplex LRU (``_rayt_mux_cache_*``). The contract is just the
        three cumulative counters — no llm/torch import here."""
        found = []
        inst = self._callable
        eng = getattr(inst, "engine", None)
        if eng is not None:
            found.append(eng)
        try:
            for attr, val in vars(inst).items():
                if attr.startswith("_rayt_mux_cache_") and \
                        hasattr(val, "values"):
                    found.extend(val.values())
        except Exception:
            pass
        return [e for e in found
                if all(isinstance(getattr(e, k, None), int)
                       for k in ("batches", "prefills", "prefill_chunks"))]

    def _engine_stats(self) -> Optional[dict]:
        """Summed engine counters across every resident engine (one for
        LlamaService, one per resident adapter for the multiplexed
        service), plus instantaneous decode-slot occupancy."""
        engines = self._engines()
        if not engines:
            return None
        out = {"batches": 0, "prefills": 0, "prefill_chunks": 0,
               "active_slots": 0, "max_batch": 0}
        for e in engines:
            out["batches"] += int(e.batches)
            out["prefills"] += int(e.prefills)
            out["prefill_chunks"] += int(e.prefill_chunks)
            try:
                out["active_slots"] += sum(
                    1 for s in e._slots if s is not None)
                out["max_batch"] += int(e.max_batch)
            except Exception:
                pass
        return out

    def _maybe_engine_report(self):
        """Throttled cumulative engine-counter report on the serve
        channel; the GCS differences consecutive reports into the
        rayt_serve_engine_*_total counters and the occupancy gauge."""
        now = time.monotonic()
        if now - self._last_engine_report < _ENGINE_REPORT_INTERVAL_S:
            return
        self._last_engine_report = now
        try:
            st = self._engine_stats()
            if st is None:
                return
            from ray_tpu_torch.serve.request_context import publish_record

            rec = {"kind": "engine", "app": self.app_name,
                   "deployment": self.deployment_name,
                   "replica": f"pid-{os.getpid()}",
                   "prefills": st["prefills"],
                   "prefill_chunks": st["prefill_chunks"],
                   "decode_steps": st["batches"],
                   "ts": time.time()}
            if st["max_batch"]:
                rec["occupancy"] = st["active_slots"] / st["max_batch"]
            publish_record(rec)
        except Exception:
            pass

    async def handle_request(self, method_name: str, args: tuple,
                             kwargs: dict, model_id: str = "",
                             ctx: Optional[dict] = None) -> Any:
        from ray_tpu_torch.serve.multiplex import (_reset_model_id,
                                                   _set_model_id)

        self._check_capacity()
        self._ongoing += 1
        self._total += 1
        t0 = time.perf_counter()
        token = _set_model_id(model_id)
        obs, obs_token, span = self._begin_request(ctx)
        t_start = None
        try:
            with span:
                if method_name == "__call__":
                    fn = self._callable
                else:
                    fn = getattr(self._callable, method_name)
                coro_fn = fn if inspect.iscoroutinefunction(fn) else getattr(
                    fn, "__call__", None)
                if inspect.iscoroutinefunction(coro_fn):
                    t_start = time.perf_counter()
                    return await coro_fn(*args, **kwargs)
                loop = asyncio.get_running_loop()
                cvctx = contextvars.copy_context()
                marks: dict = {}

                def _run():
                    marks["t_start"] = time.perf_counter()
                    return cvctx.run(fn, *args, **kwargs)

                try:
                    return await loop.run_in_executor(None, _run)
                finally:
                    t_start = marks.get("t_start")
        finally:
            _reset_model_id(token)
            self._ongoing -= 1
            self._record_request(t0)
            self._end_request(ctx, obs, obs_token, model_id,
                              t0, t_start, time.perf_counter())

    async def handle_request_streaming(self, method_name: str, args: tuple,
                                       kwargs: dict, model_id: str = "",
                                       ctx: Optional[dict] = None):
        """Async-generator entrypoint: the user callable may be a sync
        generator, an async generator, or return either; every produced
        item streams to the caller via the core streaming-return path
        (ref: serve response streaming over ObjectRefGenerator)."""
        from ray_tpu_torch.serve.multiplex import (_reset_model_id,
                                                   _set_model_id)

        self._check_capacity()
        self._ongoing += 1
        self._total += 1
        t0 = time.perf_counter()
        token = _set_model_id(model_id)
        obs, obs_token, span = self._begin_request(ctx)
        t_start = None
        try:
            with span:
                if method_name == "__call__":
                    fn = self._callable
                else:
                    fn = getattr(self._callable, method_name)
                t_start = time.perf_counter()
                result = fn(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
                if inspect.isasyncgen(result):
                    async for item in result:
                        yield item
                elif inspect.isgenerator(result):
                    loop = asyncio.get_running_loop()
                    sentinel = object()
                    while True:
                        item = await loop.run_in_executor(
                            None, next, result, sentinel)
                        if item is sentinel:
                            break
                        yield item
                else:
                    yield result
        finally:
            _reset_model_id(token)
            self._ongoing -= 1
            self._record_request(t0)
            self._end_request(ctx, obs, obs_token, model_id,
                              t0, t_start, time.perf_counter())

    def get_stats(self) -> dict:
        from ray_tpu_torch.serve.multiplex import resident_model_ids

        out = {"ongoing": self._ongoing, "total": self._total,
               "max_ongoing": self._max_ongoing,
               "overloaded_rejects": self._overloaded_rejects,
               "models": resident_model_ids(self._callable)}
        eng = self._engine_stats()
        if eng is not None:
            out["engine"] = eng
        return out

    def reconfigure(self, user_config: Any):
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        self._user_config = user_config
        return True

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            fn()
        return True
