"""ray_tpu_torch.serve — model serving over replica actors (ref analog:
python/ray/serve; SURVEY.md §3.5 call stack; counterpart of ray_tpu/serve).

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm import llm_app

    rt.init()
    port = serve.start()                   # HTTP ingress; 0 picks a port
    handle = serve.run(llm_app("410m"))    # replica's engine on the card
    # POST http://127.0.0.1:<port>/default?stream=1 {"tokens": [...]}

The controller, proxies and replicas are actors whose workers boot without
torch, so this package never imports torch or ``serve.llm``: a replica
imports them when it unpickles an LLM callable."""

from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch.serve.admission import (  # noqa: F401
    ReplicaOverloadedError, is_overload_error)
from ray_tpu_torch.serve.deployment import (  # noqa: F401
    Application, AutoscalingConfig, Deployment, deployment)
from ray_tpu_torch.serve.handle import (  # noqa: F401
    DeploymentHandle, DeploymentResponse, DeploymentResponseGenerator)
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id, multiplexed)
from ray_tpu_torch.serve.schema import build_app, deploy_config  # noqa: F401

# HTTP ingress fleet: [(actor, port, proxy_id)], sized by start()'s
# num_proxies / RAYT_SERVE_NUM_PROXIES. _proxy/_proxy_port alias the
# first member (single-proxy callers keep working unchanged).
_proxies: list = []
_proxy = None
_proxy_port: Optional[int] = None
_grpc_proxy = None
_grpc_port: Optional[int] = None

NUM_PROXIES_ENV = "RAYT_SERVE_NUM_PROXIES"


def proxy_ports() -> list[int]:
    """Bound ports of the live HTTP ingress fleet (fan clients across
    these; any port serves any app)."""
    return [port for _, port, _ in _proxies]


def proxy_name(index: int) -> str:
    """Actor name of HTTP proxy ``index`` (chaos drills kill by name).
    Index 0 keeps the historical single-proxy name."""
    return "serve_proxy" if index == 0 else f"serve_proxy_{index}"


def _controller(create: bool = True):
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController

    try:
        return rt.get_actor(CONTROLLER_NAME)
    except ValueError:
        if not create:
            raise
    controller = rt.remote(ServeController).options(
        name=CONTROLLER_NAME, num_cpus=0, lifetime="detached").remote()
    rt.get(controller.ensure_loop.remote(), timeout=60)
    return controller


def _build_specs(app: Application) -> tuple[list[dict], str]:
    """Flatten the bound graph into deployment specs; bound-node init args
    become handle markers (composition)."""
    import cloudpickle

    from ray_tpu_torch._internal.serialization import ship_code_by_value
    from ray_tpu_torch.serve.replica import _HandleMarker

    nodes = app.walk()
    specs = []
    for node in nodes:
        d = node.deployment
        ship_code_by_value(d.func_or_class)

        def convert(arg, _app_name):
            if isinstance(arg, Application):
                return _HandleMarker(arg.deployment.name, _app_name)
            return arg

        specs.append({
            "name": d.name,
            "callable_blob": cloudpickle.dumps(d.func_or_class),
            "init_args": tuple(convert(a, "__APP__") for a in node.args),
            "init_kwargs": {k: convert(v, "__APP__")
                            for k, v in node.kwargs.items()},
            "num_replicas": d.num_replicas,
            "ray_actor_options": d.ray_actor_options,
            "autoscaling_config": d.autoscaling_config,
            "max_ongoing_requests": d.max_ongoing_requests,
            "user_config": d.user_config,
            "health_check_period_s": d.health_check_period_s,
            "health_check_timeout_s": d.health_check_timeout_s,
            "health_check_failure_threshold":
                d.health_check_failure_threshold,
            "drain_timeout_s": d.drain_timeout_s,
        })
    return specs, app.deployment.name


def run(app: Application, *, name: str = "default",
        route_prefix: Optional[str] = None, _blocking: bool = True,
        timeout: float = 120.0) -> DeploymentHandle:
    """Deploy an application and return the ingress handle (ref:
    serve/api.py:496)."""
    import ray_tpu_torch as rt

    controller = _controller()
    specs, ingress = _build_specs(app)
    for spec in specs:  # stamp the real app name into handle markers
        from ray_tpu_torch.serve.replica import _HandleMarker

        for container in (spec["init_args"], spec["init_kwargs"].values()):
            for arg in container:
                if isinstance(arg, _HandleMarker):
                    arg.app_name = name
    rt.get(controller.deploy_application.remote(name, specs), timeout=60)
    if _blocking:
        ok = rt.get(controller.wait_ready.remote(name, timeout),
                    timeout=timeout + 10)
        if not ok:
            raise TimeoutError(f"app {name!r} did not become ready")
    for proxy, _, _ in _proxies:
        rt.get(proxy.register_app.remote(name, ingress), timeout=30)
    if _grpc_proxy is not None:
        rt.get(_grpc_proxy.register_app.remote(name, ingress), timeout=30)
    return DeploymentHandle(ingress, name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    import ray_tpu_torch as rt

    controller = _controller(create=False)
    deps = rt.get(controller.get_deployments.remote(name), timeout=30)
    if not deps:
        raise ValueError(f"no application {name!r}")
    # ingress is the last-deployed spec; controller preserves dict order
    return DeploymentHandle(deps[-1]["name"], name)


def delete(name: str = "default"):
    import ray_tpu_torch as rt

    controller = _controller(create=False)
    rt.get(controller.delete_application.remote(name), timeout=60)
    for proxy, _, _ in _proxies:
        try:
            rt.get(proxy.unregister_app.remote(name), timeout=30)
        except Exception:
            pass  # a chaos-killed fleet member must not fail delete()
    if _grpc_proxy is not None:
        rt.get(_grpc_proxy.unregister_app.remote(name), timeout=30)


def start(*, http_host: str = "127.0.0.1", http_port: int = 0,
          request_timeout_s: Optional[float] = None,
          admission_headroom: Optional[float] = None,
          num_proxies: Optional[int] = None) -> int:
    """Start the HTTP ingress fleet; returns the FIRST proxy's bound
    port (``proxy_ports()`` lists them all). ``num_proxies`` (default
    RAYT_SERVE_NUM_PROXIES, else 1) shards the ingress: every proxy
    serves every app behind the shared routing table, each admitting
    its share of the cluster window (serve/admission.py), stamping
    ``X-Rayt-Proxy-Id``, and heartbeating the controller so a dead
    member's share redistributes within one table refresh.
    ``request_timeout_s`` / ``admission_headroom`` override the
    RAYT_SERVE_REQUEST_TIMEOUT_S / RAYT_SERVE_ADMISSION_HEADROOM env
    defaults (the env is read in the PROXY process, which inherits the
    driver's environment at cluster init)."""
    global _proxy, _proxy_port
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.proxy import ProxyActor

    if num_proxies is None:
        try:
            num_proxies = int(os.environ.get(NUM_PROXIES_ENV, "1"))
        except (TypeError, ValueError):
            num_proxies = 1
    num_proxies = max(1, num_proxies)
    _controller()
    while len(_proxies) < num_proxies:
        i = len(_proxies)
        proxy_id = f"http-{i}"
        # explicit ports step from the base; port 0 lets each bind its
        # own ephemeral port
        port = http_port + i if http_port else 0
        proxy = rt.remote(ProxyActor).options(
            name=proxy_name(i), num_cpus=0).remote(
            http_host, port, request_timeout_s, admission_headroom,
            proxy_id)
        bound = rt.get(proxy.start.remote(), timeout=60)
        _proxies.append((proxy, bound, proxy_id))
    _proxy, _proxy_port = _proxies[0][0], _proxies[0][1]
    return _proxy_port


def start_grpc(*, grpc_host: str = "127.0.0.1", grpc_port: int = 0,
               request_timeout_s: Optional[float] = None,
               admission_headroom: Optional[float] = None) -> int:
    """Start the gRPC ingress (generic byte service /rayt.serve.Serve;
    ref analog: serve's gRPC proxy data plane)."""
    global _grpc_proxy, _grpc_port
    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.grpc_proxy import GrpcProxyActor

    controller = _controller()
    if _grpc_proxy is None:
        _grpc_proxy = rt.remote(GrpcProxyActor).options(
            name="serve_grpc_proxy", num_cpus=0).remote(
            grpc_host, grpc_port, request_timeout_s, admission_headroom)
        _grpc_port = rt.get(_grpc_proxy.start.remote(), timeout=60)
        # register existing apps so a late-started ingress still routes
        for app_name in rt.get(controller.list_applications.remote(),
                               timeout=30):
            try:
                deps = rt.get(controller.get_deployments.remote(app_name),
                              timeout=30)
                if deps:
                    rt.get(_grpc_proxy.register_app.remote(
                        app_name, deps[-1]["name"]), timeout=30)
            except Exception:
                pass
    return _grpc_port


def shutdown():
    global _proxies, _proxy, _proxy_port, _grpc_proxy, _grpc_port
    import ray_tpu_torch as rt

    try:
        controller = _controller(create=False)
        for app_name in rt.get(controller.list_applications.remote(),
                               timeout=30):
            rt.get(controller.delete_application.remote(app_name),
                   timeout=60)
        rt.kill(controller)
    except Exception:
        pass
    try:
        # drop the HA checkpoint: an INTENTIONAL shutdown must not leave
        # state a future controller would adopt (only crashes should)
        from ray_tpu_torch.experimental.internal_kv import _internal_kv_del
        from ray_tpu_torch.serve.controller import CKPT_KEY, CKPT_NAMESPACE

        _internal_kv_del(CKPT_KEY, namespace=CKPT_NAMESPACE)
    except Exception:
        pass
    for proxy, _, _ in _proxies:
        try:
            rt.kill(proxy)
        except Exception:
            pass
    if _grpc_proxy is not None:
        try:
            rt.kill(_grpc_proxy)
        except Exception:
            pass
    _grpc_proxy = None
    _grpc_port = None
    _proxies = []
    _proxy = None
    _proxy_port = None
