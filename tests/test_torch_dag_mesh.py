"""The compiled-graph plane over processes that share one mesh: the in-mesh
DAG collective over 2 and 4 gloo CPU ranks (the reference's multi-controller
path, ray_tpu/dag/collective.py:169-206), leg 5 of
``__graft_entry__.dryrun_multichip`` (a mesh-sharded tensor over a device
edge) and the twin of test_device_objects.py::
test_sharded_array_device_transfer.

Each participant is an actor that joins a gloo process group of its own
making (the user's group); the DAG binds them in another order than their
group ranks. Values are small integers in f32, so every reduction order
gives the same bits, and each result is held against the out-of-band tier
and the reference's host-tier reduction (``ray_tpu.util.collective.store``)
on the same numpy values.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.util.collective.store import REDUCE_OPS as REF_REDUCE
from ray_tpu_torch.dag import InputNode, MultiOutputNode, collective
from ray_tpu_torch.parallel.mesh import free_address

GROUP_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=8)
    try:
        yield rt
    finally:
        rt.shutdown()


def _values(world: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(-8, 9, (3, 5)).astype(np.float32)
            for _ in range(world)]


@rt.remote
class Rank:
    """One rank of a gloo group its own code starts."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def join(self, address: str) -> int:
        import datetime

        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method=address, rank=self.rank,
            world_size=self.world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        return dist.get_rank()

    def value(self, seed):
        import torch

        return torch.from_numpy(_values(self.world, seed)[self.rank])

    def host_value(self, seed):
        return _values(self.world, seed)[self.rank]

    def in_mesh_calls(self) -> dict:
        from ray_tpu_torch.dag.collective import in_mesh_calls

        return dict(in_mesh_calls)

    def sharded(self, n: int):
        """A DTensor Shard(0) of arange(n) over this group's 1-d mesh."""
        import torch
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor

        mesh = init_device_mesh("cpu", (self.world,),
                                mesh_dim_names=("data",))
        return distribute_tensor(torch.arange(n, dtype=torch.float32),
                                 mesh, [Shard(0)])

    def put_sharded(self, n: int):
        """rt.put_device of the sharded tensor: every rank puts, as every
        rank runs the same program (the gather is a collective)."""
        return [rt.put_device(self.sharded(n))]

    def reshard(self, refs):
        """Read a device object, re-shard it onto this group's mesh and
        hand back its type, its whole contents and this rank's shard."""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Shard, distribute_tensor

        x = rt.get(refs[0])
        mesh = init_device_mesh("cpu", (self.world,),
                                mesh_dim_names=("data",))
        d = distribute_tensor(x, mesh, [Shard(0)])
        return (type(x).__name__, x.numpy(), d.to_local().numpy(),
                d.full_tensor().numpy())

    def leave(self) -> bool:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return True


@rt.remote
class Sum:
    def total(self, x, y):
        assert type(x) is torch.Tensor and torch.equal(x, y)
        return float(x.sum()), type(x).__name__, tuple(x.shape)


def _group(world: int) -> list:
    ranks = [Rank.remote(r, world) for r in range(world)]
    address = free_address()
    got = rt.get([a.join.remote(address) for a in ranks],
                 timeout=GROUP_TIMEOUT_S)
    assert got == list(range(world))
    return ranks


def _end(actors: list) -> None:
    try:
        rt.get([a.leave.remote() for a in actors if hasattr(a, "leave")],
               timeout=GROUP_TIMEOUT_S)
    except Exception:
        pass
    for a in actors:
        try:
            rt.kill(a)
        except Exception:
            pass


@pytest.mark.parametrize("world", [2, 4])
def test_in_mesh_collective_over_processes_in_dag_order(cluster, world):
    """Sum, max and allgather over `world` gloo ranks bound in the reverse
    of their group ranks: the in-mesh path runs (each rank counts its
    calls), the results stay tensors, the gather comes back in DAG order,
    and each equals the out-of-band tier's and the reference's host-tier
    reduction of the same numpy values."""
    ranks = _group(world)
    order = list(reversed(range(world)))      # DAG rank i = group rank order[i]
    try:
        with InputNode() as inp:
            vals = [ranks[r].value.bind(inp) for r in order]
            sums = collective.allreduce.bind(vals, op="sum", group_name="m")
            maxes = collective.allreduce.bind(
                [ranks[r].value.bind(inp) for r in order], op="max",
                group_name="m")
            gathers = collective.allgather.bind(
                [ranks[r].value.bind(inp) for r in order], group_name="m")
            dag = MultiOutputNode(sums + maxes + gathers).experimental_compile(
                channels=True)
        before = rt.get([a.in_mesh_calls.remote() for a in ranks])
        try:
            outs = [dag.execute(seed).get(timeout=GROUP_TIMEOUT_S)
                    for seed in (3, 4)]
        finally:
            dag.teardown()
        after = rt.get([a.in_mesh_calls.remote() for a in ranks])
        for b, a in zip(before, after):
            assert a["allreduce"] - b["allreduce"] == 4   # 2 ops x 2 ticks
            assert a["allgather"] - b["allgather"] == 2

        with InputNode() as inp:
            host = [ranks[r].host_value.bind(inp) for r in order]
            oob = collective.allreduce.bind(host, op="sum", group_name="h")
            oob_max = collective.allreduce.bind(
                [ranks[r].host_value.bind(inp) for r in order], op="max",
                group_name="h")
            oob_gather = collective.allgather.bind(
                [ranks[r].host_value.bind(inp) for r in order],
                group_name="h")
            fallback = MultiOutputNode(
                oob + oob_max + oob_gather).experimental_compile(
                    channels=False)
        for seed, got in zip((3, 4), outs):
            vals = _values(world, seed)
            in_dag_order = [vals[r] for r in order]
            want_sum = REF_REDUCE["sum"](in_dag_order)
            want_max = REF_REDUCE["max"](in_dag_order)
            band = fallback.execute(seed).get(timeout=GROUP_TIMEOUT_S)
            for i in range(world):
                s, m, g = got[i], got[world + i], got[2 * world + i]
                assert isinstance(s, torch.Tensor) and s.device.type == "cpu"
                assert s.numpy().tobytes() == want_sum.tobytes()
                assert m.numpy().tobytes() == want_max.tobytes()
                assert s.numpy().tobytes() == np.asarray(
                    band[i]).tobytes()
                assert m.numpy().tobytes() == np.asarray(
                    band[world + i]).tobytes()
                assert [t.numpy().tobytes() for t in g] == \
                    [v.tobytes() for v in in_dag_order]
                assert [np.asarray(t).tobytes()
                        for t in band[2 * world + i]] == \
                    [v.tobytes() for v in in_dag_order]
    finally:
        _end(ranks)


def test_sharded_tensor_rides_a_device_edge_leg5(cluster):
    """Leg 5 of dryrun_multichip, rebuilt: a DTensor Shard(0) of arange(64)
    over a 2-rank gloo mesh of two actors rides device edges to a third
    actor, which reads the whole tensor as a plain one (sum n(n-1)/2).
    Both ranks write their edge, so both stage the gather (SPMD)."""
    a, b = _group(2)
    c = Sum.remote()
    try:
        with InputNode() as inp:
            ha = a.sharded.bind(inp).with_tensor_transport()
            hb = b.sharded.bind(inp).with_tensor_transport()
            out = c.total.bind(ha, hb)
        dag = out.experimental_compile()
        n = 64
        try:
            total, kind, shape = dag.execute(n).get(timeout=GROUP_TIMEOUT_S)
        finally:
            dag.teardown()
        assert total == n * (n - 1) / 2.0
        assert (kind, shape) == ("Tensor", (n,))
    finally:
        _end([a, b, c])


def test_sharded_tensor_device_transfer_torch(cluster):
    """Twin of test_device_objects.py::test_sharded_array_device_transfer:
    a DTensor sharded over a 2-rank mesh survives the host-staged transfer
    (put on every rank; the consumer reads a plain tensor with identical
    contents) and re-shards onto the consumers' own 2-rank mesh."""
    producers = _group(2)
    consumers = _group(2)
    try:
        refs = rt.get([p.put_sharded.remote(64) for p in producers],
                      timeout=GROUP_TIMEOUT_S)
        whole = np.arange(64, dtype=np.float32)
        for ref in refs:          # each rank's put holds the whole tensor
            got = rt.get([q.reshard.remote(ref) for q in consumers],
                         timeout=GROUP_TIMEOUT_S)
            for rank, (kind, x, local, full) in enumerate(got):
                assert kind == "Tensor"
                assert x.tobytes() == whole.tobytes()
                assert full.tobytes() == whole.tobytes()
                assert local.tobytes() == \
                    whole[32 * rank:32 * (rank + 1)].tobytes()
    finally:
        _end(producers + consumers)
