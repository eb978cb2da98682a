"""Deployment descriptors + application graphs (ref analogs:
python/ray/serve/deployment.py:64 `Deployment`, api.py `@serve.deployment`,
handle-based composition).

`@serve.deployment class D: ...` then `D.bind(args)` builds an
Application node; bound nodes passed as init args become
DeploymentHandles inside the replica (model-composition DAG).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    """Closed-loop replica autoscaling policy (ref analog:
    serve/config.py AutoscalingConfig + autoscaling_state.py).

    The controller combines three live signals each reconcile tick:
    ongoing requests reported by replicas (+ router queue depth from the
    metrics store) against ``target_ongoing_requests``, per-deployment
    QPS from the metrics store against ``target_qps_per_replica`` (when
    set), and p99 request latency against ``latency_target_s`` (when
    set; adds one replica per decision while violated). The largest
    demand wins, clamped to [min_replicas, max_replicas], then the
    up/down delays apply hysteresis: the desired direction must hold
    continuously for the delay before replicas actually move."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    # metrics-store-driven signals (None disables the signal)
    target_qps_per_replica: Optional[float] = None
    latency_target_s: Optional[float] = None
    metrics_window_s: float = 30.0


class Deployment:
    def __init__(self, func_or_class: Any, name: str,
                 num_replicas: int | str = 1,
                 ray_actor_options: Optional[dict] = None,
                 autoscaling_config: Optional[AutoscalingConfig | dict] = None,
                 max_ongoing_requests: int = 16,
                 user_config: Any = None,
                 health_check_period_s: float = 10.0,
                 health_check_timeout_s: float = 5.0,
                 health_check_failure_threshold: int = 2,
                 drain_timeout_s: float = 30.0):
        self.func_or_class = func_or_class
        self.name = name
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        if num_replicas == "auto":
            autoscaling_config = autoscaling_config or AutoscalingConfig()
            num_replicas = autoscaling_config.min_replicas
        self.num_replicas = int(num_replicas)
        self.ray_actor_options = ray_actor_options or {}
        self.autoscaling_config = autoscaling_config
        self.max_ongoing_requests = max_ongoing_requests
        self.user_config = user_config
        self.health_check_period_s = health_check_period_s
        self.health_check_timeout_s = health_check_timeout_s
        self.health_check_failure_threshold = health_check_failure_threshold
        self.drain_timeout_s = drain_timeout_s

    def options(self, **kwargs) -> "Deployment":
        merged = dict(
            name=self.name, num_replicas=self.num_replicas,
            ray_actor_options=self.ray_actor_options,
            autoscaling_config=self.autoscaling_config,
            max_ongoing_requests=self.max_ongoing_requests,
            user_config=self.user_config,
            health_check_period_s=self.health_check_period_s,
            health_check_timeout_s=self.health_check_timeout_s,
            health_check_failure_threshold=self.health_check_failure_threshold,
            drain_timeout_s=self.drain_timeout_s)
        merged.update(kwargs)
        return Deployment(self.func_or_class, **merged)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __call__(self, *a, **kw):
        raise TypeError(
            f"Deployment {self.name!r} cannot be called directly; deploy it "
            "with serve.run(D.bind(...)) and call the handle")


class Application:
    """A bound deployment node; init args may reference other bound nodes
    (composition)."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def walk(self) -> list["Application"]:
        """All nodes reachable from this one (dependencies first)."""
        seen: dict[int, Application] = {}

        def visit(node: "Application"):
            if id(node) in seen:
                return
            for a in list(node.args) + list(node.kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            seen[id(node)] = node

        visit(self)
        return list(seen.values())


def deployment(func_or_class: Any = None, *, name: Optional[str] = None,
               num_replicas: int | str = 1,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[AutoscalingConfig | dict] = None,
               max_ongoing_requests: int = 16,
               user_config: Any = None,
               health_check_period_s: float = 10.0,
               health_check_timeout_s: float = 5.0,
               health_check_failure_threshold: int = 2,
               drain_timeout_s: float = 30.0):
    """@serve.deployment decorator (ref: serve/api.py)."""

    def wrap(target):
        return Deployment(
            target, name or target.__name__, num_replicas,
            ray_actor_options, autoscaling_config, max_ongoing_requests,
            user_config, health_check_period_s, health_check_timeout_s,
            health_check_failure_threshold, drain_timeout_s)

    if func_or_class is not None:
        return wrap(func_or_class)
    return wrap
