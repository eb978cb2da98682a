"""The port's meshes, rule table, differentiable collectives and weight
sharding (ray_tpu_torch.parallel.mesh, parallel.collectives,
models.convert) against the reference's ray_tpu.parallel.mesh.

spec_for and shard_params are held against the reference's on five mesh
shapes over the 8 virtual CPU devices (the port reads a mesh's axis sizes,
so a mapping stands in for a mesh of ranks here); build_mesh's errors
against the reference's. The collectives and the weight round trip run on
gloo CPU ranks."""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import lora as jlora
from ray_tpu.parallel import mesh as jmesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.parallel import mesh as tmesh
from torch_mesh_ranks import run_ranks

SHAPES = [{"data": 8}, {"fsdp": 8}, {"data": 2, "fsdp": 2, "tensor": 2},
          {"data": 2, "expert": 4}, {"fsdp": 2, "seq": 2, "tensor": 2}]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _axes(spec) -> tuple:
    """Each entry's mesh axes as a tuple (a PartitionSpec writes a one-axis
    tuple as the bare name)."""
    return tuple(tmesh.spec_axes(e) for e in spec)


def _all_axes(moe: bool):
    jcfg = jllama.config_for("debug", moe_num_experts=4 if moe else 0)
    tcfg = tllama.config_for("debug", moe_num_experts=4 if moe else 0)
    lcfg = jlora.LoraConfig(rank=4)
    return ({**jllama.param_logical_axes(jcfg),
             "lora": jlora.lora_logical_axes(jcfg, lcfg)},
            {**tllama.param_logical_axes(tcfg),
             "lora": tlora.lora_logical_axes(tcfg, tlora.LoraConfig(rank=4))})


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_spec_for_and_shard_params_match_reference(cpu_mesh_devices, shape):
    mesh = jmesh.build_mesh(shape, cpu_mesh_devices)
    for moe in (False, True):
        jaxes, taxes = _all_axes(moe)
        assert _flat(jaxes) == _flat(taxes)
        want = _flat(jmesh.shard_params(None, jaxes, mesh))
        got = _flat(tmesh.shard_params(None, taxes, shape))
        assert set(got) == set(want)
        for name in want:
            assert _axes(got[name].spec) == _axes(want[name].spec), name
        for logical in _flat(jaxes).values():
            assert (_axes(tmesh.spec_for(logical, None, shape))
                    == _axes(jmesh.spec_for(logical, None, mesh)))
            assert (_axes(tmesh.spec_for(logical))
                    == _axes(jmesh.spec_for(logical)))
    # the batch rule, a tuple of axes kept in order
    assert (_axes(tmesh.spec_for(("batch", "seq"), None, shape))
            == _axes(jmesh.spec_for(("batch", "seq"), None, mesh)))


@pytest.mark.parametrize("axes", [{"data": -1, "fsdp": -1},
                                  {"data": 3, "tensor": -1},
                                  {"data": 2, "tensor": 2}],
                         ids=["two_fills", "indivisible", "wrong_count"])
def test_mesh_sizes_raise_as_the_reference(cpu_mesh_devices, axes):
    with pytest.raises(ValueError) as want:
        jmesh.build_mesh(axes, cpu_mesh_devices)
    with pytest.raises(ValueError) as got:
        tmesh._resolve_sizes(axes, 8)
    assert str(got.value) == str(want.value)


def test_mesh_order_and_fill_match_reference(cpu_mesh_devices):
    axes = {"tensor": 2, "stage": 2, "data": -1}
    mesh = jmesh.build_mesh(axes, cpu_mesh_devices)
    names, sizes = tmesh._resolve_sizes(axes, 8)
    assert tuple(names) == mesh.axis_names
    assert sizes == [mesh.shape[a] for a in names]


def test_build_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh({"data": -1}, device="cpu")


@pytest.fixture(scope="module")
def rank_runs():
    cfg = jllama.config_for("debug")
    params = jax.tree.map(np.asarray, jllama.init_params(
        cfg, jax.random.PRNGKey(0)))
    jobs = [("collectives", None),
            ("convert_roundtrip", {"cfg": {}, "params": params,
                                   "mesh": {"fsdp": 2, "tensor": 2}})]
    outs = run_ranks("many", 4, jobs)
    return params, [o[0] for o in outs], [o[1] for o in outs]


def _x(rank):
    return np.arange(32.0, dtype=np.float32).reshape(4, 8) + 100 * rank


def _w(shape, rank):
    return (np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
            + 1000 * rank)


def test_collectives_and_their_transposes(rank_runs):
    """Over 4 ranks of a tensor group, with y = op(x_r) for x_r [4, 8] and
    the gradient of sum(y * w_r) for rank-dependent x_r and w_r: psum sums
    forward and passes w_r back; psum_grad passes x_r and sums the w_r;
    all_gather concatenates and reduce-scatters back; gather_replicated
    keeps its own slice of w_r; split takes its slice and gathers the w_q
    back; all_to_all's and ppermute's backward are their inverses."""
    _, col, _ = rank_runs
    n = len(col)
    c = 8 // n
    xs = [_x(r) for r in range(n)]
    for r, res in enumerate(col):
        np.testing.assert_array_equal(res["psum"]["y"], sum(xs))
        np.testing.assert_array_equal(res["psum"]["g"], _w((4, 8), r))
        np.testing.assert_array_equal(res["psum_grad"]["y"], xs[r])
        np.testing.assert_array_equal(
            res["psum_grad"]["g"], sum(_w((4, 8), q) for q in range(n)))
        np.testing.assert_array_equal(res["all_gather"]["y"],
                                      np.concatenate(xs, 1))
        ws = [_w((4, 8 * n), q) for q in range(n)]
        np.testing.assert_array_equal(res["all_gather"]["g"],
                                      sum(ws)[:, 8 * r:8 * (r + 1)])
        np.testing.assert_array_equal(res["gather_replicated"]["g"],
                                      ws[r][:, 8 * r:8 * (r + 1)])
        np.testing.assert_array_equal(res["split"]["y"],
                                      xs[r][:, c * r:c * (r + 1)])
        np.testing.assert_array_equal(
            res["split"]["g"],
            np.concatenate([_w((4, c), q) for q in range(n)], 1))
        # all_to_all: chunk q of dim 1 goes to rank q, concatenated on dim 0
        np.testing.assert_array_equal(
            res["all_to_all"]["y"],
            np.concatenate([xs[q][:, c * r:c * (r + 1)] for q in range(n)],
                           0))
        back = [_w((4 * n, c), q)[4 * r:4 * (r + 1)] for q in range(n)]
        np.testing.assert_array_equal(res["all_to_all"]["g"],
                                      np.concatenate(back, 1))
        np.testing.assert_array_equal(res["ppermute"]["y"], xs[(r - 1) % n])
        np.testing.assert_array_equal(res["ppermute"]["g"],
                                      _w((4, 8), (r + 1) % n))


def test_local_shards_gather_back_bit_equal(rank_runs):
    """models.convert.local_params_from_numpy cuts each rank's shard by the
    rule table on fsdp 2 x tensor 2; gather_params puts the whole tree
    back, bit for bit, on every rank."""
    params, _, conv = rank_runs
    want = _flat(params)
    for res in conv:
        got = _flat(res["full"])
        assert set(got) == set(want)
        for name in want:
            assert np.array_equal(got[name], want[name]), name
        assert res["embed"] == (128, 32)         # [vocab/tensor, embed/fsdp]
        assert res["shapes"]["wk"] == (2, 32, 16)
        assert res["shapes"]["mlp_norm"] == (2, 64)


def test_named_sharding_local_slices_and_placements():
    """A rank's slice follows the spec's axes major first, as a
    PartitionSpec tuple does."""
    class Mesh:                       # the DeviceMesh calls local() makes
        mesh_dim_names = ("data", "fsdp", "tensor")
        shape = (2, 2, 2)
        coord = {"data": 1, "fsdp": 0, "tensor": 1}

        def size(self, dim):
            return self.shape[dim]

        def get_local_rank(self, axis):
            return self.coord[axis]

    t = torch.arange(8 * 6).reshape(8, 6)
    s = tmesh.NamedSharding(Mesh(), (("data", "fsdp"), "tensor"))
    # data index 1, fsdp index 0 -> shard 2 of 4 rows; tensor 1 of 2 cols
    assert torch.equal(s.local(t), t[4:6, 3:6])
    from torch.distributed.tensor import Replicate, Shard

    assert s.placements == (Shard(0), Shard(0), Shard(1))
    assert tmesh.replicated(Mesh()).placements == (Replicate(),) * 3
