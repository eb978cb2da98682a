"""Utility layer: actor pool, queue, metrics (ref analog: python/ray/util/).
The collective backends (``util.collective``) wait for the device plane,
ROADMAP.md item 3."""

from __future__ import annotations

import importlib

__all__ = ["ActorPool", "Queue", "metrics", "builtin_metrics"]


def __getattr__(name):
    if name in ("metrics", "builtin_metrics"):
        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool

        return ActorPool
    if name == "Queue":
        from ray_tpu_torch.util.queue import Queue

        return Queue
    if name == "collective":
        raise NotImplementedError("ray_tpu_torch.util.collective is not "
                                  "ported yet (ROADMAP.md item 3)")
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")
