"""FaultTolerantActorManager (ref analog:
rllib/utils/actor_manager.py:198): async RPC fan-out over a fleet with
per-actor health tracking — failed calls mark the actor unhealthy and are
dropped from results; a later successful probe restores it."""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional

import ray_tpu_torch as rt

logger = logging.getLogger("ray_tpu_torch.rl")


def gang_placement_options(n: int, resources: Optional[dict] = None,
                           strategy: str = "SLICE_PACK") -> list[dict]:
    """Best-effort soft co-location of an n-actor fleet through the GCS
    placement plane: asks `place_gang` (advisory — nothing reserved)
    where the gang fits whole, and returns one actor-options dict per
    member carrying a SOFT NodeAffinity to its advised node. When the
    plane can't fit the gang (or isn't reachable), returns empty dicts
    and scheduling falls back to the per-lease local policies — fleets
    must boot even on clusters that can't co-locate them."""
    opts: list[dict] = [{} for _ in range(n)]
    try:
        nodes = rt.place_gang(
            [dict(resources or {"CPU": 1.0}) for _ in range(n)],
            strategy)
    except Exception:
        logger.debug("gang placement advise failed", exc_info=True)
        return opts
    if not nodes or len(nodes) != n:
        return opts
    from ray_tpu_torch._internal.ids import NodeID
    from ray_tpu_torch.core.common import NodeAffinitySchedulingStrategy

    for i, h in enumerate(nodes):
        opts[i] = {"scheduling_strategy": NodeAffinitySchedulingStrategy(
            NodeID(bytes.fromhex(h)), soft=True)}
    return opts


class FaultTolerantActorManager:
    def __init__(self, actors: list, *, probe_method: str = "ping"):
        self._actors = list(actors)
        self._healthy = [True] * len(actors)
        self._probe_method = probe_method

    @property
    def num_healthy(self) -> int:
        return sum(self._healthy)

    def healthy_actors(self) -> list:
        return [a for a, h in zip(self._actors, self._healthy) if h]

    def foreach(self, fn: Callable, *, timeout: float = 120.0,
                healthy_only: bool = True) -> list:
        """fn(actor) -> ObjectRef; returns results from actors that
        succeeded (failures mark the actor unhealthy)."""
        targets = [(i, a) for i, (a, h) in enumerate(
            zip(self._actors, self._healthy)) if h or not healthy_only]
        refs = [(i, fn(a)) for i, a in targets]
        out = []
        for i, ref in refs:
            try:
                out.append(rt.get(ref, timeout=timeout))
                self._healthy[i] = True
            except Exception as e:
                logger.warning("actor %d failed: %r", i, e)
                self._healthy[i] = False
        return out

    def replace(self, old, new) -> None:
        """Swap a permanently-dead actor for a freshly spawned
        replacement (DAG recovery's respawn path); the replacement
        starts healthy and keeps the fleet size stable."""
        for i, a in enumerate(self._actors):
            if a is old:
                self._actors[i] = new
                self._healthy[i] = True
                return
        raise ValueError("actor is not managed by this manager")

    def probe_unhealthy(self, timeout: float = 10.0) -> int:
        """Try to restore unhealthy actors (restarted actors respond
        again); returns how many are healthy now."""
        for i, (a, h) in enumerate(zip(self._actors, self._healthy)):
            if h:
                continue
            try:
                rt.get(getattr(a, self._probe_method).remote(),
                       timeout=timeout)
                self._healthy[i] = True
            except Exception:
                pass
        return self.num_healthy
