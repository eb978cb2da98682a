"""Collective nodes for compiled DAGs (ref analog:
python/ray/dag/collective_node.py:19, experimental/collective/allreduce.py).

``allreduce.bind([n1, ..., nk])`` / ``allgather.bind([...])`` insert one
collective op per participating actor: each actor contributes its
upstream node's value and receives the reduced/gathered result in-loop.

Lowering is TWO-TIER on the channel fast path:

* **In-mesh**: when every participant is one rank of ONE device set
  (``mesh_shared`` over the fingerprints the ranks exchange at group
  init) and contributes a tensor, the reduction runs on the device: over
  the default process group the participants started (``dist.all_reduce``
  / ``dist.all_gather`` on their own device: NCCL for CUDA tensors, gloo
  for CPU ones), as the reference's ranks reduce over a ``ranks`` mesh
  axis in one jit (ray_tpu/dag/collective.py:169-206). A world of one is
  the degenerate case: the reduction is the identity and the tensor never
  leaves its device. A participant's DAG rank (its position in
  ``bind``) need not be its process-group rank: the gather returns the
  values in DAG order.
* **Out-of-band fallback**: the host tier of ``util/collective``
  (GCS-KV rendezvous, rank-0 star / peer ring) — the NCCL-group analog
  for actors that do NOT share a device set (the common CPU-actor
  case); tensors reach it as host numpy. The per-call fallback executor
  reduces the same way via one-shot groups.

For tensors of ONE torch.distributed program the right tool remains the
program's own collective — DAG collectives are the MPMD-level reduction
between separate programs.
"""

from __future__ import annotations

import sys
import uuid

from ray_tpu_torch.dag.node import ClassMethodNode


class _CollectiveBinder:
    """Shared bind machinery: one collective op node per participant,
    all members of one group (world = len(nodes), rank = position)."""

    kind = "allreduce"
    has_op = True

    def bind(self, nodes: list, op: str = "sum",
             group_name: str | None = None) -> list:
        if not nodes:
            raise ValueError(f"{self.kind}.bind needs at least one node")
        if not all(isinstance(n, ClassMethodNode) for n in nodes):
            raise TypeError(f"{self.kind}.bind takes actor-method nodes")
        actors = {id(n.actor) for n in nodes}
        if len(actors) != len(nodes):
            raise ValueError(
                f"{self.kind} participants must be distinct actors")
        name = group_name or f"dag-{self.kind[:2]}-{uuid.uuid4().hex[:8]}"
        spec = (f"{self.kind}:{op}" if self.has_op else f"{self.kind}:-")
        out = []
        for rank, n in enumerate(nodes):
            node = ClassMethodNode(n.actor,
                                   f"__collective_{self.kind}__",
                                   (n,), {})
            node.collective = spec
            node.collective_group = name
            node.collective_rank = rank
            node.collective_world = len(nodes)
            out.append(node)
        return out


class _AllgatherBinder(_CollectiveBinder):
    kind = "allgather"
    has_op = False

    def bind(self, nodes: list,
             group_name: str | None = None) -> list:
        return super().bind(nodes, group_name=group_name)


allreduce = _CollectiveBinder()
allgather = _AllgatherBinder()


# ------------------------------------------------- in-mesh lowering

def client_fingerprint():
    """This process's torch view, exchanged between collective
    participants at group init so ``mesh_shared`` can decide whether the
    group addresses ONE device set: ``(rank, world, device names, local
    device count)``, where rank and world are ``torch.distributed``'s
    when a process group is initialised (else 0 and 1) and the devices
    are the CUDA cards once this process has initialised CUDA (else the
    CPU). torch is read through ``sys.modules``: a process that never
    imported it holds no tensor and reports a world of one on the CPU.
    None when the view cannot be read."""
    torch = sys.modules.get("torch")
    if torch is None:
        return (0, 1, ("cpu",), 1)
    try:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            rank, world = int(dist.get_rank()), int(dist.get_world_size())
        else:
            rank, world = 0, 1
        if torch.cuda.is_initialized():
            n = torch.cuda.device_count()
            devices = tuple(torch.cuda.get_device_name(i) for i in range(n))
        else:
            n, devices = 1, ("cpu",)
        return (rank, world, devices, n)
    except Exception:
        return None


def mesh_shared(fingerprints: list) -> bool:
    """True when every participant is one rank of the SAME device set:
    identical device view, world == the group's world, each rank one
    distinct index, one device per rank (the MPMD actor shape — each
    actor owns one card). A world of one trivially shares its own
    device set. CPU actor fleets — each its own single-process world
    whose device view merely LOOKS identical — fail the world check and
    stay out-of-band."""
    world = len(fingerprints)
    if world == 1:
        # a lone participant shares "its mesh" only when its process is a
        # world of one — one rank of a multi-process group must not run a
        # whole-group collective alone (the other ranks would never join)
        return fingerprints[0] is not None and fingerprints[0][1] == 1
    if any(f is None for f in fingerprints):
        return False
    if len({f[2] for f in fingerprints}) != 1:
        return False                       # different device views
    if {f[1] for f in fingerprints} != {world}:
        return False                       # not world-many ranks
    if any(f[3] != 1 for f in fingerprints):
        return False                       # >1 card per rank: shape unclear
    return sorted(f[0] for f in fingerprints) == list(range(world))


def value_on_device(value) -> bool:
    from ray_tpu_torch.core.device_objects import is_device_value

    return is_device_value(value)


_REDUCERS = {"sum": "SUM", "prod": "PRODUCT", "min": "MIN", "max": "MAX"}
# in-mesh calls made in this process, by kind: where the lowering went
in_mesh_calls = {"allreduce": 0, "allgather": 0}


def _world() -> int:
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def in_mesh_allreduce(value, op: str = "sum"):
    """The in-mesh reduction — the participant calls this instead of the
    out-of-band group. World of one: the reduction is the identity, and
    the tensor stays on its device (a non-tensor becomes a CPU tensor).
    More ranks: one all-reduce over the default process group into a new
    tensor on the value's device (the value itself is not written)."""
    import torch

    if op not in _REDUCERS:
        raise ValueError(f"in-mesh allreduce does not support op {op!r}")
    t = torch.as_tensor(value)
    in_mesh_calls["allreduce"] += 1
    if _world() == 1:
        return t
    return _in_mesh_stack_reduce(t, op)


def in_mesh_allgather(value, order=None) -> list:
    """In-mesh twin of the out-of-band allgather: returns the
    participants' values on their device, in DAG order. ``order[i]`` is
    the process-group rank of DAG rank i (None: the two orders agree)."""
    import torch

    t = torch.as_tensor(value)
    in_mesh_calls["allgather"] += 1
    if _world() == 1:
        return [t]
    gathered = _in_mesh_stack_gather(t)
    return gathered if order is None else [gathered[r] for r in order]


def _in_mesh_stack_reduce(arr, op: str):
    """Every rank's ``arr`` reduced with ``op`` over the default process
    group (the participants' own backend: NCCL or gloo)."""
    import torch.distributed as dist

    out = arr.clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _REDUCERS[op]))
    return out


def _in_mesh_stack_gather(arr) -> list:
    """Every rank's ``arr``, in process-group rank order."""
    import torch
    import torch.distributed as dist

    arr = arr.contiguous()
    out = [torch.empty_like(arr) for _ in range(dist.get_world_size())]
    dist.all_gather(out, arr)
    return out
