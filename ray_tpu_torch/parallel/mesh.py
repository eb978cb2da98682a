"""Device meshes and sharding rules (counterpart of
ray_tpu/parallel/mesh.py).

The reference names mesh axes by role and lets GSPMD insert the collectives.
The port runs one process per rank (SPMD): a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group,
with the reference's axis names and order, and the same logical-axis rule
table says which dim of which leaf each rank holds a slice of. The
collectives are explicit (``parallel/collectives.py``):

  data   — batch sharding; gradients all-reduced after the backward
  fsdp   — batch sharding, and params sharded along ``embed``: each layer's
           weights are all-gathered inside its block (ZeRO-3), with a
           reduce-scatter as the gather's backward
  tensor — Megatron tensor parallelism inside attention and the FFN
  seq    — sequence parallelism (ring or Ulysses attention)
  expert — MoE expert sharding

``build_mesh`` runs over the default process group: NCCL for the card, gloo
only when the caller asks for the CPU (``device="cpu"``). A CUDA mesh over a
gloo group raises; nothing falls back. A program that drives ranks of its
own inside a process that may hold other such programs (a tensor-parallel
engine, an IMPALA learner) builds a group of its own instead
(``new_group``, the same backends) and a ``GroupMesh`` over it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import socket
from typing import Any, Mapping, Sequence

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"

# canonical axis order: outer -> inner (the innermost axes carry the most
# traffic: tensor parallelism's per-layer all-reduces)
AXIS_ORDER = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ, AXIS_TENSOR)

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class MeshConfig:
    """Sizes per axis; at most one axis may be -1 (fill the remaining
    ranks)."""
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1

    def axis_sizes(self) -> dict[str, int]:
        return {AXIS_DATA: self.data, AXIS_FSDP: self.fsdp,
                AXIS_EXPERT: self.expert, AXIS_SEQ: self.seq,
                AXIS_TENSOR: self.tensor}

    def build(self, device=None):
        return build_mesh(self.axis_sizes(), device)


def _device_type(device) -> str:
    from ray_tpu_torch.device import resolve_device

    return resolve_device(device).type


def free_address(host: str = "127.0.0.1") -> str:
    """``tcp://host:port`` with a port free on this host, for
    ``init_process_group``."""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"tcp://{host}:{s.getsockname()[1]}"


def init_process_group(world_size: int, rank: int, address: str,
                       device=None, timeout_s: float = 300.0) -> None:
    """Start the default process group: NCCL for the card (``device=None``
    means CUDA), gloo for ``device="cpu"``. ``address`` is
    ``tcp://host:port`` (rank 0 listens there)."""
    import datetime

    import torch.distributed as dist

    backend = _BACKENDS[_device_type(device)]
    dist.init_process_group(
        backend, init_method=address, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def new_group(world: int, rank: int, address: str, device=None,
              timeout_s: float = 300.0):
    """A process group of ``world`` ranks apart from the default group ->
    (group, store). Rank 0 hosts the group's store at ``address``
    (``tcp://host:port``), the others connect there. NCCL for the card
    (``device=None`` means CUDA), gloo for ``device="cpu"``. Any number of
    such groups can live in one process, beside a default group or
    without one; pass the group to every collective (``group=``, with
    ``group_src`` for a root), and end it with ``group.shutdown()`` (the
    store goes with its last reference)."""
    import datetime

    import torch
    import torch.distributed as dist

    device_type = _device_type(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    host, port = address.removeprefix("tcp://").rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, rank == 0, timeout)
    prefix = dist.PrefixStore("ray_tpu_torch_group", store)
    group = dist.ProcessGroup(prefix, rank, world)
    kinds = dist.ProcessGroup.BackendType
    if device_type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        backend, kind = dist.ProcessGroupNCCL(prefix, rank, world, opts), \
            kinds.NCCL
        bound = torch.device("cuda", torch.cuda.current_device())
    else:
        backend, kind = dist.ProcessGroupGloo(prefix, rank, world,
                                              timeout), kinds.GLOO
        bound = torch.device("cpu")
    group._set_default_backend(kind)
    group._register_backend(bound, kind, backend)
    return group, store


class GroupMesh:
    """A mesh over a process group of its own (``new_group``): the
    reference's named axes, at most one of them larger than 1 and spanning
    the whole group. What a tensor-parallel engine's ranks run its decode
    step over; the same face as the ``DeviceMesh`` a ``Sharded`` context
    reads (names, shape, an axis's group and this rank's index on it)."""

    def __init__(self, group, axes: Mapping[str, int]):
        names, sizes = _resolve_sizes(axes, group.size())
        if sum(n > 1 for n in sizes) > 1:
            raise ValueError(f"a GroupMesh spans its group on one axis; "
                             f"{dict(zip(names, sizes))} has several")
        self.group = group
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(sizes)

    def size(self, mesh_dim: int) -> int:
        return self.shape[mesh_dim]

    def _axis_size(self, axis: str) -> int:
        return self.shape[self.mesh_dim_names.index(axis)]

    def get_group(self, axis: str):
        if self._axis_size(axis) == 1:
            raise ValueError(f"axis {axis!r} has size 1: no group")
        return self.group

    def get_local_rank(self, axis: str) -> int:
        return self.group.rank() if self._axis_size(axis) > 1 else 0


class CommandGroup:
    """A process group of ``world`` ranks of its own (``new_group``) that
    rank 0 drives: rank 0 sends each command (any picklable object) and the
    tensors it needs, and ranks 1..world-1 wait on them. A
    tensor-parallel engine's followers (``serve/llm_tp.py``) and an IMPALA
    learner's ranks (``rl/impala.py``) are such groups; several live in
    one process at once, and none touches the default group."""

    def __init__(self, world: int, rank: int, address: str, device,
                 timeout_s: float = 300.0):
        self.world, self.rank, self.device = world, rank, device
        self.group, self._store = new_group(world, rank, address, device,
                                            timeout_s)

    def objects(self, obj=None):
        """Rank 0's picklable ``obj`` on every rank (the others pass
        nothing)."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(
            box, group=self.group, group_src=0,
            device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def broadcast(self, t=None, shape=None, dtype=None):
        """Rank 0's tensor ``t`` on every rank; the others give its shape
        and dtype (or ``t`` to receive into)."""
        import torch
        import torch.distributed as dist

        if t is None:
            t = torch.empty(shape, dtype=dtype, device=self.device)
        elif self.rank == 0:
            t = t.detach().contiguous()
        dist.broadcast(t, group=self.group, group_src=0)
        return t

    def scatter(self, t, axis: int, shape, dtype):
        """This rank's part of rank 0's tensor ``t`` (of ``shape``), cut
        into ``world`` equal parts along ``axis``."""
        import torch
        import torch.distributed as dist

        local = list(shape)
        local[axis] //= self.world
        out = torch.empty(local, dtype=dtype, device=self.device)
        parts = ([p.contiguous() for p in t.chunk(self.world, dim=axis)]
                 if self.rank == 0 else None)
        dist.scatter(out, parts, group=self.group, group_src=0)
        return out

    def gather(self, t, axis: int):
        """Every rank's ``t`` joined along ``axis`` in rank order (on every
        rank)."""
        import torch
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=axis)

    def all_reduce(self, t):
        """The sum of every rank's ``t``, in place."""
        import torch.distributed as dist

        dist.all_reduce(t, group=self.group)
        return t

    def close(self) -> None:
        self.group.shutdown()
        self._store = None


def _resolve_sizes(axes: Mapping[str, int], n: int
                   ) -> tuple[list[str], list[int]]:
    names = [a for a in AXIS_ORDER if a in axes]
    names += [a for a in axes if a not in names]  # custom axes at the end
    sizes = [axes[a] for a in names]
    fills = [i for i, s in enumerate(sizes) if s == -1]
    if len(fills) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if fills:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[fills[0]] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} "
            f"devices, have {n}")
    return names, sizes


def build_mesh(axes: dict[str, int], device=None):
    """A ``DeviceMesh`` over every rank of the default process group, its
    dims named as the reference's (``AXIS_ORDER`` first, custom axes after),
    one ``-1`` filling the rest. ``device=None`` means the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs the default process group: call "
            "parallel.mesh.init_process_group (or run inside a TorchTrainer "
            "worker and use train.get_context().get_mesh())")
    device_type = _device_type(device)
    backend = dist.get_backend()
    if backend != _BACKENDS[device_type]:
        raise ValueError(
            f"a {device_type} mesh needs a {_BACKENDS[device_type]} process "
            f"group; the default group is {backend}")
    names, sizes = _resolve_sizes(axes, dist.get_world_size())
    return init_device_mesh(device_type, tuple(sizes),
                            mesh_dim_names=tuple(names))


def local_mesh(device=None, **axes: int):
    """Convenience: ``local_mesh(data=-1, tensor=2)`` over every rank."""
    return build_mesh(dict(axes), device)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size}: a ``DeviceMesh``, or a plain mapping (what
    ``spec_for`` needs of a mesh)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


# --------------------------------------------------------- logical axis rules
# flax-style logical-to-mesh rules: params carry logical axis names; the
# rules map them to mesh axes. Multiple strategies = just different rules.
DEFAULT_RULES: dict[str, Any] = {
    "batch": (AXIS_DATA, AXIS_FSDP),
    "seq": AXIS_SEQ,
    "embed": AXIS_FSDP,          # FSDP shards params along embed dim
    "heads": AXIS_TENSOR,
    "kv_heads": AXIS_TENSOR,
    "head_dim": None,
    "mlp": AXIS_TENSOR,
    "vocab": AXIS_TENSOR,
    "expert": AXIS_EXPERT,
    "layers": None,              # stacked-layer leading dim stays replicated
    None: None,
}


def spec_for(logical_axes: Sequence[str | None],
             rules: dict[str, Any] | None = None, mesh=None) -> tuple:
    """Map logical axis names to a spec: one entry per dim, each None, a mesh
    axis name or a tuple of them (the reference's PartitionSpec as a tuple).
    When ``mesh`` is given, entries naming axes absent from the mesh (or of
    size 1) are dropped, so one rule table serves every mesh shape."""
    rules = rules or DEFAULT_RULES
    present = None if mesh is None else {
        a for a, n in mesh_shape(mesh).items() if n > 1}

    def keep(entry):
        if entry is None or present is None:
            return entry
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in present)
            return kept if kept else None
        return entry if entry in present else None

    return tuple(keep(rules.get(ax)) for ax in logical_axes)


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _is_logical_leaf(x) -> bool:
    return isinstance(x, (tuple, list)) and all(
        isinstance(e, (str, type(None))) for e in x)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one spec: which mesh axes shard which dim. ``local(t)``
    cuts this rank's slice of a full tensor."""
    mesh: Any
    spec: tuple

    def shard_index(self, dim: int) -> tuple[int, int]:
        """(this rank's index, shard count) along ``dim``: the spec's axes
        flattened major first, as a PartitionSpec tuple is."""
        index, count = 0, 1
        for axis in spec_axes(self.spec[dim] if dim < len(self.spec)
                              else None):
            n = self.mesh.size(self.mesh.mesh_dim_names.index(axis))
            index = index * n + self.mesh.get_local_rank(axis)
            count *= n
        return index, count

    def local(self, t):
        """This rank's slice of the full tensor ``t`` (a view)."""
        for dim in range(len(self.spec)):
            index, count = self.shard_index(dim)
            if count == 1:
                continue
            if t.shape[dim] % count:
                raise ValueError(
                    f"dim {dim} of size {t.shape[dim]} does not divide over "
                    f"{count} shards (spec {self.spec})")
            size = t.shape[dim] // count
            t = t.narrow(dim, index * size, size)
        return t

    @property
    def placements(self) -> tuple:
        """The ``DTensor`` placements of this sharding, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(self.spec) if axis in spec_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def named_sharding(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def map_logical(fn, logical_specs: Any) -> Any:
    """Apply fn to every logical-axes tuple of a tree of them."""
    if _is_logical_leaf(logical_specs):
        return fn(tuple(logical_specs))
    if isinstance(logical_specs, dict):
        return {k: map_logical(fn, v) for k, v in logical_specs.items()}
    if isinstance(logical_specs, (list, tuple)):
        return [map_logical(fn, v) for v in logical_specs]
    raise TypeError(f"not a tree of logical axis tuples: {logical_specs!r}")


def shard_params(params: Any, logical_specs: Any, mesh,
                 rules: dict[str, Any] | None = None) -> Any:
    """Map a tree of logical axis tuples to NamedShardings (same tree
    structure as params; ``params`` is there for the reference's
    signature)."""
    del params
    return map_logical(
        lambda axes: NamedSharding(mesh, spec_for(axes, rules, mesh)),
        logical_specs)


# ------------------------------------------------ the step's sharding context
# logical axes the model computes sharded (each rank works on its slice):
# attention heads and the FFN's hidden dim over `tensor`, experts over
# `expert`. A leaf's other sharded dims are gathered before use.
COMPUTE_SHARDED = {"heads": (AXIS_TENSOR,), "kv_heads": (AXIS_TENSOR,),
                   "mlp": (AXIS_TENSOR,), "expert": (AXIS_EXPERT,)}
# axes over which ranks hold different data: a parameter's gradient sums
# over them
BATCH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """What a sharded train step tells the model it runs: the mesh, and the
    logical axes and spec of every parameter leaf (trees shaped like the
    params). ``build_train_step`` sets it around ``loss_fn``
    (``use_sharding``); the model reads it once a forward
    (``current_sharding``) and hands it down, so an activation checkpoint's
    recompute sees the same one."""
    mesh: Any
    logical: dict
    specs: dict

    def size(self, axis: str) -> int:
        return mesh_axis_size(self.mesh, axis)

    def group(self, axis: str):
        """The process group of ``axis``, None where it is absent or of
        size 1 (every collective over None is the identity)."""
        if self.size(axis) == 1:
            return None
        return self.mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        return 0 if self.size(axis) == 1 else self.mesh.get_local_rank(axis)

    def batch_groups(self) -> list:
        return [self.group(a) for a in BATCH_AXES if self.size(a) > 1]

    def batch_ranks(self) -> int:
        return math.prod(self.size(a) for a in BATCH_AXES)

    def leaf(self, *path: str) -> tuple[tuple, tuple]:
        """(logical axes, spec) of the leaf at ``path``."""
        logical, spec = self.logical, self.specs
        for key in path:
            logical, spec = logical[key], spec[key]
        return tuple(logical), tuple(spec)

    def gather(self, t, logical: tuple, spec: tuple):
        """The leaf ``t`` (this rank's shard) with every dim gathered whose
        logical axis the model does not compute sharded. A gather over an
        axis of different data (``BATCH_AXES``: FSDP) has a reduce-scatter
        as its backward; over an axis of replicated compute (``tensor`` on
        ``vocab``) its backward keeps this rank's slice."""
        from ray_tpu_torch.parallel import collectives as col

        for dim, (name, entry) in enumerate(zip(logical, spec)):
            axes = spec_axes(entry)
            if not axes:
                continue
            if name in COMPUTE_SHARDED:
                if not set(axes) <= set(COMPUTE_SHARDED[name]):
                    raise ValueError(
                        f"logical axis {name!r} maps to mesh axes {axes}; "
                        f"the model computes it sharded over "
                        f"{COMPUTE_SHARDED[name]} only")
                continue
            for axis in reversed(axes):      # minor axis first
                group = self.group(axis)
                if axis in BATCH_AXES:
                    t = col.all_gather(t, dim, group)
                else:
                    t = col.gather_replicated(t, dim, group)
        return t


_current = contextvars.ContextVar("ray_tpu_torch_sharding", default=None)


@contextlib.contextmanager
def use_sharding(sharded: Sharded | None):
    token = _current.set(sharded)
    try:
        yield sharded
    finally:
        _current.reset(token)


def current_sharding() -> Sharded | None:
    """The Sharded context of the step running on this thread, or None (one
    device, no mesh)."""
    return _current.get()
