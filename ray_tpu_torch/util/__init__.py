"""Utility layer: actor pool, queue, metrics and the host tier of the
collectives (ref analog: python/ray/util/). ``util.collective`` carries
rendezvous, barriers and numpy allreduce/allgather/broadcast between
processes over TCP; the device plane is the torch.distributed collectives
inside the mesh (``ray_tpu_torch.parallel``). ``phase_spans`` reads the
process's hot-path phases (the engine round's and the train step's parts,
``_internal/otel.phase``)."""

from __future__ import annotations

import importlib

__all__ = ["ActorPool", "Queue", "metrics", "builtin_metrics", "collective",
           "phase_spans"]


def __getattr__(name):
    if name in ("metrics", "builtin_metrics", "collective"):
        return importlib.import_module(f"ray_tpu_torch.util.{name}")
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool

        return ActorPool
    if name == "phase_spans":
        from ray_tpu_torch._internal.otel import phase_spans

        return phase_spans
    if name == "Queue":
        from ray_tpu_torch.util.queue import Queue

        return Queue
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")
