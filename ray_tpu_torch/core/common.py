"""Shared control-plane types: addresses, task specs, resources, options.

TPU-native analog of ref src/ray/common/task/task_spec.h:258 and
python/ray/_private/ray_option_utils.py. These are plain dataclasses carried
over the RPC layer (pickle-5), the one-language replacement for the
reference's protobuf TaskSpec.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

from ray_tpu_torch._internal.ids import (ActorID, JobID, NodeID, ObjectID,
                                         PlacementGroupID, TaskID, WorkerID)


@dataclasses.dataclass(frozen=True)
class Address:
    """Where to reach a process's RPC server."""
    host: str
    port: int

    def key(self) -> str:
        return f"{self.host}:{self.port}"

    def __reduce__(self):
        # positional tuple: pickled on every TaskSpec/WorkerInfo on the
        # wire; the default dataclass reduce ships field-name strings
        return (Address, (self.host, self.port))


@dataclasses.dataclass
class ResourceSpec:
    """Resource demand of a task/actor. GPUs are first-class: `gpu` counts
    cards on the host (the "GPU" resource, which the TPU build's `tpu`
    field and "TPU" resource stand for there); custom covers any other
    resource."""
    num_cpus: float = 1.0
    gpu: float = 0.0
    memory: float = 0.0
    custom: dict[str, float] = dataclasses.field(default_factory=dict)

    def to_demand(self) -> dict[str, float]:
        d = {}
        if self.num_cpus:
            d["CPU"] = self.num_cpus
        if self.gpu:
            d["GPU"] = self.gpu
        if self.memory:
            d["memory"] = self.memory
        d.update(self.custom)
        return d


@dataclasses.dataclass
class TaskOptions:
    resources: ResourceSpec = dataclasses.field(default_factory=ResourceSpec)
    max_retries: int = -1            # -1 = use config default
    retry_exceptions: bool = False
    num_returns: int = 1
    name: str = ""
    scheduling_strategy: Any = None  # None | "SPREAD" | PlacementGroupSchedulingStrategy
    runtime_env: dict | None = None
    # torch.Tensor returns stay device-resident in the executing worker
    # (ref analog: dag nodes annotated with_tensor_transport)
    tensor_transport: bool = False


@dataclasses.dataclass
class ActorOptions:
    resources: ResourceSpec = dataclasses.field(default_factory=ResourceSpec)
    max_restarts: int = 0
    max_task_retries: int = 0
    name: str = ""                   # named actor (GCS-registered)
    namespace: str = ""
    lifetime: str = ""               # "" | "detached"
    max_concurrency: int = 1
    scheduling_strategy: Any = None
    runtime_env: dict | None = None


@dataclasses.dataclass
class TaskSpec:
    """Everything a worker needs to run one task (ref: task_spec.h:258)."""
    task_id: TaskID
    job_id: JobID
    name: str
    # Pickled function (normal task) or (method name, args) for actor tasks.
    function_blob: bytes | None
    args: list[Any]                  # mix of inline values and ObjectRefMeta
    kwargs: dict[str, Any]
    num_returns: int
    resources: dict[str, float]
    owner: "WorkerInfo"
    max_retries: int = 0
    retry_exceptions: bool = False
    # Current attempt number (0-based), set by the submitter before each
    # (re)dispatch so the executing worker's lifecycle events carry it —
    # the GCS task manager resolves a retried task's final verdict from
    # the LATEST attempt (ref: task attempt in gcs_task_manager.h).
    attempt: int = 0
    # Actor-task fields:
    actor_id: ActorID | None = None
    method_name: str = ""
    seq_no: int = -1                 # per-caller ordering for actor tasks
    # Actor-creation fields:
    is_actor_creation: bool = False
    actor_options: ActorOptions | None = None
    scheduling_strategy: Any = None
    # Packaged runtime env (see _internal/runtime_env.py), applied by the
    # executing worker before the function/actor-ctor runs.
    runtime_env: dict | None = None
    # jax.Array returns stay in the executing worker's device memory and
    # the owner records a device-object ref (core/device_objects.py).
    tensor_transport: bool = False
    # W3C traceparent carrier (ref: _private/tracing _inject_tracing):
    # links the executing worker's OTel span to the submitter's trace.
    trace_ctx: dict | None = None
    # Function-table id (core/function_table.py): when set, the code
    # blob travels once per worker connection / via GCS KV instead of
    # riding every spec; function_blob then only carries the piggybacked
    # first-push copy (None on all later pushes).
    function_id: str | None = None
    # The cards of the lease this spec runs on, as CUDA_VISIBLE_DEVICES
    # names them (None: a lease without a GPU). Set by the node manager on
    # an actor's creation spec, and by the owner from the lease token on
    # every normal task it pushes.
    gpu_ids: tuple | None = None

    def __reduce__(self):
        # a spec crosses the wire on EVERY submit: a positional tuple
        # (fields in declaration order) pickles ~2x smaller/faster than
        # the default dataclass __dict__ with its per-field name strings
        return (TaskSpec, (
            self.task_id, self.job_id, self.name, self.function_blob,
            self.args, self.kwargs, self.num_returns, self.resources,
            self.owner, self.max_retries, self.retry_exceptions,
            self.attempt, self.actor_id, self.method_name, self.seq_no,
            self.is_actor_creation, self.actor_options,
            self.scheduling_strategy, self.runtime_env,
            self.tensor_transport, self.trace_ctx, self.function_id,
            self.gpu_ids))


def lease_token(worker_hex: str, cards: tuple | None) -> str:
    """A lease's token: the worker it names and the cards that worker must
    see (``"<worker id>:<card>,<card>"``; the id alone for a lease without
    a GPU)."""
    return worker_hex + (":" + ",".join(cards) if cards else "")


def parse_lease_token(token: str) -> tuple[str, tuple | None]:
    """(worker id hex, the cards or None) of a ``lease_token``."""
    worker_hex, _, cards = token.partition(":")
    return worker_hex, (tuple(cards.split(",")) if cards else None)


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    worker_id: WorkerID
    node_id: NodeID
    address: Address                 # the worker's own RPC server
    # direct-call endpoint (core/direct.py): 0 = none (driver processes,
    # pre-upgrade workers). Owners push eligible tasks here, skipping
    # the asyncio stack on both sides of the round-trip.
    direct_port: int = 0

    def __reduce__(self):
        return (WorkerInfo, (self.worker_id, self.node_id, self.address,
                             self.direct_port))


@dataclasses.dataclass
class NodeInfo:
    node_id: NodeID
    address: Address                 # node manager RPC server
    resources_total: dict[str, float]
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    alive: bool = True
    # TPU topology hints for slice-aware gang scheduling:
    slice_name: str = ""
    slice_worker_index: int = -1


class ActorState:
    PENDING = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


@dataclasses.dataclass
class ActorInfo:
    actor_id: ActorID
    name: str
    namespace: str
    state: str
    address: Address | None          # actor worker RPC server when ALIVE
    worker_id: WorkerID | None
    node_id: NodeID | None
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: str = ""
    class_name: str = ""
    # the resources the actor holds while it lives, set at registration
    required_resources: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ObjectMeta:
    """Owner-side record of where an object lives."""
    object_id: ObjectID
    size: int = -1                   # -1 = unknown/pending
    inline: bool = False             # small object stored in owner memory
    in_shm: bool = False
    node_ids: list[NodeID] = dataclasses.field(default_factory=list)
    error: Any = None                # stored exception, if task failed
    # Device-resident object (payload = jax.Array in the holder worker
    # process's HBM; see core/device_objects.py). holder is a WorkerInfo.
    in_device: bool = False
    holder: Any = None


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    placement_group_id: PlacementGroupID
    bundle_index: int = -1           # -1 = any bundle


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    node_id: NodeID
    soft: bool = False


@dataclasses.dataclass
class NodeLabelSchedulingStrategy:
    """Schedule onto nodes by label (ref analog:
    node_label_scheduling_strategy in scheduling/policy/). `hard` labels
    must ALL match for a node to be feasible; `soft` labels rank matching
    nodes first but don't exclude others."""
    hard: dict = dataclasses.field(default_factory=dict)
    soft: dict = dataclasses.field(default_factory=dict)


def now() -> float:
    return time.time()


class RayTpuError(Exception):
    """Base class for framework errors (ref analog: RayError hierarchy)."""


class TaskError(RayTpuError):
    """Wraps an application exception raised in a task; re-raised on get."""

    def __init__(self, cause: BaseException, task_name: str = "",
                 remote_traceback: str = ""):
        super().__init__(f"task {task_name!r} failed: {cause!r}")
        self.cause = cause
        self.remote_traceback = remote_traceback


class WorkerCrashedError(RayTpuError):
    pass


class ActorDiedError(RayTpuError):
    def __init__(self, actor_id, cause: str = ""):
        super().__init__(f"actor {actor_id} died: {cause}")
        self.actor_id = actor_id
        self.cause = cause


class ObjectLostError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    """Raised by get() on a ref whose task was cancelled (ref analog:
    ray.exceptions.TaskCancelledError via ray.cancel)."""
    pass


class GetTimeoutError(RayTpuError):
    pass
