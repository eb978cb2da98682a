"""Utility layer: actor pool, queue, metrics and the host tier of the
collectives (ref analog: python/ray/util/). ``util.collective`` carries
rendezvous, barriers and numpy allreduce/allgather/broadcast between
processes over TCP; its device tier (``backend="nccl"``) is ROADMAP.md
item 6."""

from __future__ import annotations

import importlib

__all__ = ["ActorPool", "Queue", "metrics", "builtin_metrics", "collective"]


def __getattr__(name):
    if name in ("metrics", "builtin_metrics", "collective"):
        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool

        return ActorPool
    if name == "Queue":
        from ray_tpu_torch.util.queue import Queue

        return Queue
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")
