"""Model multiplexing: many models time-share one replica pool (ref
analog: python/ray/serve/multiplex.py `_ModelMultiplexWrapper` +
serve.get_multiplexed_model_id; counterpart of ray_tpu/serve/multiplex.py,
which is jax-free and copied here).

Usage:
    @serve.deployment
    class ModelHost:
        @serve.multiplexed(max_num_models_per_replica=3)
        async def get_model(self, model_id: str):
            return load(model_id)              # LRU-cached per replica

        async def __call__(self, payload):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return model(payload)

    handle.options(multiplexed_model_id="m7").remote(x)
    # HTTP: header `serve_multiplexed_model_id: m7`

Routing: the handle remembers which replica last served each model id and
sends repeat traffic there (model-affinity), falling back to power-of-two
choices — the single-handle version of the reference's model-id-aware
replica scheduler.
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
from collections import OrderedDict
from typing import Any, Callable

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "rayt_serve_multiplexed_model_id", default="")


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the request being handled."""
    return _current_model_id.get()


def _set_model_id(model_id: str):
    return _current_model_id.set(model_id)


def _reset_model_id(token):
    _current_model_id.reset(token)


def _mux_metric(counter_name: str, loader: str):
    """Best-effort load/eviction telemetry — cache-thrash visibility for
    the LoRA-affinity story (an affinity-routed fleet shows loads ~=
    distinct adapters; load/eviction churn at steady state means hot
    adapters are bouncing between replicas)."""
    try:
        from ray_tpu_torch.util import builtin_metrics as bm

        getattr(bm, counter_name).inc(tags={"loader": loader})
    except Exception:
        pass


def multiplexed(max_num_models_per_replica: int = 3) -> Callable:
    """Decorate the model loader method; calls are LRU-cached per replica
    (evicted models are simply dropped; define __del__ on the model for
    custom unload). An instance may override the cache size by setting
    ``self._rayt_mux_max_models`` (e.g. from an init arg) before the
    first load."""

    def wrap(loader: Callable) -> Callable:
        cache_attr = f"_rayt_mux_cache_{loader.__name__}"
        lock_attr = f"_rayt_mux_lock_{loader.__name__}"

        async def inner(self, model_id: str) -> Any:
            cache: OrderedDict = self.__dict__.setdefault(
                cache_attr, OrderedDict())
            lock: asyncio.Lock = self.__dict__.setdefault(
                lock_attr, asyncio.Lock())
            max_models = int(getattr(self, "_rayt_mux_max_models",
                                     max_num_models_per_replica))
            async with lock:
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                while len(cache) >= max(1, max_models):
                    cache.popitem(last=False)  # evict LRU
                    _mux_metric("serve_mux_evictions", loader.__name__)
                result = loader(self, model_id)
                if inspect.iscoroutine(result):
                    result = await result
                cache[model_id] = result
                _mux_metric("serve_mux_loads", loader.__name__)
                return result

        inner.__name__ = loader.__name__
        inner._rayt_multiplexed = True
        return inner

    return wrap


def loaded_model_ids(instance, loader_name: str = "get_model") -> list[str]:
    """Model ids currently cached on a replica instance (observability)."""
    cache = instance.__dict__.get(f"_rayt_mux_cache_{loader_name}", {})
    return list(cache)


def resident_model_ids(instance) -> list[str]:
    """Union of model ids across ALL multiplex LRUs on an instance —
    the replica-side residency view reported through
    ReplicaActor.get_stats (LoRA hot-adapter observability)."""
    out: list[str] = []
    try:
        for attr, val in instance.__dict__.items():
            if attr.startswith("_rayt_mux_cache_") and hasattr(val, "keys"):
                out.extend(str(k) for k in val.keys())
    except Exception:
        pass
    return out
