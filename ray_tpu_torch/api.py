"""Public tasks/actors/objects API (ref analogs:
python/ray/remote_function.py:303, python/ray/actor.py, worker.py get/put/
wait). `import ray_tpu_torch as rt; @rt.remote` mirrors the reference surface."""

from __future__ import annotations

import functools
from typing import Any

from ray_tpu_torch._internal.ids import ActorID, PlacementGroupID
from ray_tpu_torch.core.common import (ActorOptions, ActorState, ResourceSpec,
                                       TaskOptions)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.runtime import get_runtime_context as _infra_runtime_context


def _core_worker():
    from ray_tpu_torch.core.object_ref import get_core_worker

    cw = get_core_worker()
    if cw is not None:
        return cw  # inside a worker process, or an initialized driver
    return _infra_runtime_context().core_worker


def _make_resources(num_cpus=None, num_gpus=None, memory=None,
                    resources=None) -> ResourceSpec:
    return ResourceSpec(
        num_cpus=1.0 if num_cpus is None else float(num_cpus),
        gpu=float(num_gpus or 0),
        memory=float(memory or 0),
        custom=dict(resources or {}))


_DAG_NOT_PORTED = ("compiled DAGs (.bind()) are not ported yet: the dag "
                   "package arrives with the device plane, ROADMAP.md item 3")


class RemoteFunction:
    def __init__(self, fn, **opts):
        self._fn = fn
        self._opts = opts
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update(opts)
        return RemoteFunction(self._fn, **merged)

    def _task_options(self) -> TaskOptions:
        # options are immutable per RemoteFunction (options() returns a
        # new instance), so the TaskOptions builds once, not per submit
        cached = self.__dict__.get("_opts_cache")
        if cached is not None:
            return cached
        o = self._opts
        nr = o.get("num_returns", 1)
        if nr == "streaming":
            nr = -1  # streaming-generator sentinel (ObjectRefGenerator)
        o = dict(o, num_returns=nr)
        self._opts_cache = out = self._build_task_options(o)
        return out

    @staticmethod
    def _build_task_options(o: dict) -> TaskOptions:
        return TaskOptions(
            resources=_make_resources(
                o.get("num_cpus"), o.get("num_gpus"), o.get("memory"),
                o.get("resources")),
            max_retries=o.get("max_retries", -1),
            retry_exceptions=bool(o.get("retry_exceptions", False)),
            num_returns=o.get("num_returns", 1),
            name=o.get("name", ""),
            scheduling_strategy=o.get("scheduling_strategy"),
            runtime_env=o.get("runtime_env"),
            tensor_transport=bool(o.get("tensor_transport", False)))

    def remote(self, *args, **kwargs):
        opts = self._task_options()
        refs = _core_worker().submit_task(self._fn, args, kwargs, opts)
        if opts.num_returns == -1:
            return refs  # ObjectRefGenerator
        if opts.num_returns == 1:
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called "
            "directly; use .remote()")

    def bind(self, *args, **kwargs):
        """Build a DAG task node instead of submitting."""
        raise NotImplementedError(_DAG_NOT_PORTED)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 max_retries: int = -1, tensor_transport: bool = False):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._max_retries = max_retries
        self._tensor_transport = tensor_transport

    def options(self, num_returns: int | None = None,
                max_retries: int | None = None,
                tensor_transport: bool | None = None, **_):
        return ActorMethod(
            self._handle, self._name,
            self._num_returns if num_returns is None else num_returns,
            self._max_retries if max_retries is None else max_retries,
            self._tensor_transport if tensor_transport is None
            else tensor_transport)

    def remote(self, *args, **kwargs):
        opts = self.__dict__.get("_opts_cache")
        if opts is None:
            nr = self._num_returns
            if nr == "streaming":
                nr = -1
            opts = self._opts_cache = TaskOptions(
                num_returns=nr,
                max_retries=(self._handle._max_task_retries
                             if self._max_retries < 0
                             else self._max_retries),
                tensor_transport=self._tensor_transport)
        nr = opts.num_returns
        refs = _core_worker().submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs, opts)
        if nr == -1:
            return refs  # ObjectRefGenerator
        if nr == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Build a DAG node instead of submitting (ref: dag/dag_node.py)."""
        raise NotImplementedError(_DAG_NOT_PORTED)


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = "",
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        # cache the bound method handle: repeated `h.method.remote()`
        # calls skip both this lookup and the per-call TaskOptions build
        m = ActorMethod(self, name)
        self.__dict__[name] = m
        return m

    def __reduce__(self):
        return (ActorHandle,
                (self._actor_id, self._class_name, self._max_task_retries))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"


class ActorClass:
    def __init__(self, cls, **opts):
        self._cls = cls
        self._opts = opts

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._opts)
        merged.update(opts)
        return ActorClass(self._cls, **merged)

    def _actor_options(self) -> ActorOptions:
        o = self._opts
        # Actors default to 0 CPUs while running (ref semantics:
        # python/ray/actor.py — actors need 1 CPU to schedule but hold 0,
        # so long-lived actors don't starve the node of task resources).
        return ActorOptions(
            resources=_make_resources(
                o.get("num_cpus", 0), o.get("num_gpus"), o.get("memory"),
                o.get("resources")),
            max_restarts=o.get("max_restarts", 0),
            max_task_retries=o.get("max_task_retries", 0),
            name=o.get("name", ""),
            namespace=o.get("namespace", ""),
            lifetime=o.get("lifetime", ""),
            max_concurrency=o.get("max_concurrency", 1),
            scheduling_strategy=o.get("scheduling_strategy"),
            runtime_env=o.get("runtime_env"))

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._actor_options()
        actor_id = _core_worker().create_actor(self._cls, args, kwargs, opts)
        return ActorHandle(actor_id, self._cls.__name__,
                           opts.max_task_retries)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated "
            "directly; use .remote()")


def remote(*args, **kwargs):
    """@remote decorator for functions and classes, with or without
    options: @remote / @remote(num_cpus=2, num_gpus=1, ...)."""
    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    return wrap


def get(refs, timeout: float | None = None):
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    if not all(isinstance(r, ObjectRef) for r in refs):
        raise TypeError("ray_tpu_torch.get() accepts ObjectRef or list of ObjectRef")
    values = _core_worker().get(list(refs), timeout=timeout)
    return values[0] if single else values


def put(value) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("calling put() on an ObjectRef is not allowed")
    return _core_worker().put(value)


def put_device(value) -> ObjectRef:
    """Store a torch.Tensor as a device-resident object: the payload stays
    in this process's memory (the card's, for a CUDA tensor); consumers
    elsewhere receive a host-staged copy rebuilt on their own device. See
    core/device_objects.py."""
    return _core_worker().put_device(value)


def wait(refs, *, num_returns: int = 1, timeout: float | None = None):
    if not refs:
        return [], []
    return _core_worker().wait(list(refs), num_returns=num_returns,
                               timeout=timeout)


class RuntimeContext:
    """User-facing identity of the current driver/worker process (ref
    analog: ray.runtime_context.RuntimeContext via
    ray.get_runtime_context()). Inside a task, get_task_id() names the
    executing task; inside an actor, get_actor_id() names the actor."""

    def __init__(self, cw):
        self._cw = cw

    def get_job_id(self) -> str:
        # inside a task: the owning job from the executing spec (pool
        # workers are job-agnostic, their process job id is the null job)
        jid = getattr(self._cw._exec_ctx, "job_id", None)
        return (jid or self._cw.job_id).hex()

    def get_node_id(self) -> str:
        return self._cw.node_id.hex()

    def get_worker_id(self) -> str:
        return self._cw.worker_id.hex()

    def get_task_id(self) -> str | None:
        tid = self._cw._exec_ctx.task_id
        return tid.hex() if tid is not None else None

    def get_actor_id(self) -> str | None:
        aid = self._cw.actor_id
        return aid.hex() if aid is not None else None


def get_runtime_context() -> RuntimeContext:
    """ref analog: ray.get_runtime_context() (_private/worker.py)."""
    return RuntimeContext(_core_worker())


def cancel(ref: ObjectRef, *, force: bool = False) -> bool:
    """Best-effort cancel of the task producing `ref` (ref analog:
    ray.cancel). Queued tasks fail immediately; running tasks get an
    async TaskCancelledError (force=True kills the executing worker —
    the only way to interrupt C-blocked calls like sleep/IO). Once this
    returns True, get() on the task's returns raises TaskCancelledError
    even if the worker raced to a result; returns False when the task
    already finished (its value stands). Caveat: a force-killed worker
    may hold device-plane results of earlier tasks (lease reuse) — those
    owners fall back to lineage reconstruction."""
    return _core_worker().cancel_task(ref, force)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _core_worker().kill_actor(actor._actor_id, no_restart)


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    cw = _core_worker()
    res = cw.io.run(cw.gcs.get_named_actor(name, namespace))
    if res is None:
        raise ValueError(f"no actor named {name!r}")
    info, spec = res
    if info.state == ActorState.DEAD:
        raise ValueError(f"actor {name!r} is dead")
    opts = spec.actor_options if spec is not None else None
    return ActorHandle(info.actor_id, info.class_name,
                       opts.max_task_retries if opts else 0)


def available_resources() -> dict:
    cw = _core_worker()
    view = cw.io.run(cw.gcs.get_cluster_resources())
    out: dict[str, float] = {}
    for v in view.values():
        if not v.get("alive"):
            continue
        for r, amt in v.get("available", {}).items():
            out[r] = out.get(r, 0.0) + amt
    return out


def cluster_resources() -> dict:
    cw = _core_worker()
    view = cw.io.run(cw.gcs.get_cluster_resources())
    out: dict[str, float] = {}
    for v in view.values():
        if not v.get("alive"):
            continue
        for r, amt in v.get("total", {}).items():
            out[r] = out.get(r, 0.0) + amt
    return out


def nodes() -> list:
    cw = _core_worker()
    return cw.io.run(cw.gcs.get_all_nodes())


def drain_node(node_id, deadline_s: float | None = None,
               reason: str = "") -> bool:
    """Start a deadline-bound graceful drain of a node: no new leases
    land there, restartable actors / serve replicas / placement-group
    bundles migrate to live nodes, and primary object copies are
    evacuated before the node is torn down. Accepts a NodeID or its hex
    string. Returns True if the drain was accepted."""
    from ray_tpu_torch._internal.ids import NodeID

    if isinstance(node_id, str):
        node_id = NodeID(bytes.fromhex(node_id))
    cw = _core_worker()
    return bool(cw.io.run(cw.gcs.conn.call(
        "drain_node", (node_id, deadline_s, reason))))


def drain_status() -> dict:
    """Per-node drain records keyed by node-id hex: state
    (DRAINING/DRAINED/DEAD), reason, deadline, and migrated counts."""
    cw = _core_worker()
    return cw.io.run(cw.gcs.conn.call("get_drain_status")) or {}


# ----------------------------------------------------------- placement groups
class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID, bundles, strategy, placement):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.placement = placement  # list[NodeID] per bundle

    def bundle_strategy(self, bundle_index: int = -1):
        from ray_tpu_torch.core.common import PlacementGroupSchedulingStrategy

        return PlacementGroupSchedulingStrategy(self.id, bundle_index)

    def __reduce__(self):
        return (PlacementGroup,
                (self.id, self.bundles, self.strategy, self.placement))


def placement_group(bundles: list[dict], strategy: str = "PACK",
                    timeout: float = 60.0) -> PlacementGroup:
    """Gang reservation (ref: util/placement_group.py:145). Blocks until
    reserved or raises. Bundles are resource dicts, e.g. [{"GPU": 4}] * 4."""
    import time

    cw = _core_worker()
    pg_id = PlacementGroupID.random()
    deadline = time.monotonic() + timeout
    while True:
        placement = cw.io.run(cw.gcs.conn.call(
            "create_placement_group", (pg_id, bundles, strategy)))
        if placement is not None:
            return PlacementGroup(pg_id, bundles, strategy, placement)
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"placement group {bundles} ({strategy}) not satisfiable")
        time.sleep(0.2)


def remove_placement_group(pg: PlacementGroup):
    cw = _core_worker()
    cw.io.run(cw.gcs.conn.call("remove_placement_group", pg.id))


# ------------------------------------------------------------ placement plane
def place_gang(demands: list[dict],
               strategy: str = "SLICE_PACK") -> list | None:
    """Advisory gang placement through the GCS placement plane: a
    node-id hex per demand, or None when the gang does not fit whole
    right now. Nothing is reserved — callers that need a hard
    reservation use placement_group() (same placer, behind the ordered
    admission lock). RL / train worker groups use this for soft
    co-location: pin each worker to its advised node with
    NodeAffinitySchedulingStrategy(soft=True)."""
    cw = _core_worker()
    return cw.io.run(cw.gcs.conn.call(
        "place_gang", (list(demands), strategy)))


def set_job_quota(weight: float, floor: float = 0.0,
                  job_id: str | None = None) -> None:
    """Opt a job into fair-share scheduling of the governed resource
    (RAYT_QUOTA_RESOURCE, default CPU). ``weight`` sets the job's slice
    of the weighted cluster share; ``floor`` is an absolute minimum the
    share never drops below. weight<=0 and floor<=0 removes the quota.
    Defaults to the calling job. Enforcement is node-side and
    work-conserving: an over-share job is parked only while another
    job's lease waits on the same node."""
    cw = _core_worker()
    job_hex = job_id if job_id is not None else cw.job_id.hex()
    cw.io.run(cw.gcs.conn.call(
        "set_job_quota", (str(job_hex), float(weight), float(floor))))
