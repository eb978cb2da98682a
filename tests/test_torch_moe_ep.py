"""Expert sharding in the port (ops.moe with an expert group, and the MoE
llama step over data x expert) on gloo CPU ranks, against the reference's
GSPMD on the 8 virtual CPU devices: tests/test_moe.py's
test_expert_parallel_sharding_parity (out and aux to 1e-5) and leg 3 of
``dryrun_multichip`` (3 AdamW steps of the MoE debug model on data 2 x
expert 2, f32: losses and moe_aux to 1e-5 relative, as
tests/test_torch_moe.py holds the single-device MoE trajectory).

Each expert rank holds E/n experts; the router stays replicated; the batch
is not sharded over `expert` (the rule table maps batch to data x fsdp), so
each rank runs its experts on the tokens it shares with its group and the
partial combines are summed."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.models import llama as jllama
from ray_tpu.ops.moe import MoEConfig, init_moe_params, moe_ffn
from ray_tpu.parallel.mesh import MeshConfig
from ray_tpu.parallel.spmd import build_train_step, shard_batch
from torch_mesh_ranks import run_ranks

MOE = {"num_experts": 8, "top_k": 2, "capacity_factor": 2.0}


@pytest.fixture(scope="module")
def ffn_case():
    cfg = MoEConfig(**MOE)
    params = jax.tree.map(np.asarray,
                          init_moe_params(jax.random.PRNGKey(0), 16, 32, cfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16)).astype(np.float32)
    g = rng.standard_normal((2, 16, 16)).astype(np.float32)
    outs = run_ranks("moe_ep", 4, {"cfg": MOE, "params": params, "x": x,
                                   "g": g})
    return cfg, params, x, g, outs


def test_expert_parallel_sharding_parity(cpu_mesh_devices, ffn_case):
    cfg, params, x, g, outs = ffn_case
    jp = jax.tree.map(jnp.asarray, params)
    ref, ref_aux = moe_ffn(jp, jnp.asarray(x), cfg)
    mesh = Mesh(np.array(cpu_mesh_devices[:4]), ("expert",))
    ep = NamedSharding(mesh, P("expert"))
    sharded = {"router": jax.device_put(jp["router"],
                                        NamedSharding(mesh, P())),
               **{k: jax.device_put(jp[k], ep)
                  for k in ("w_gate", "w_up", "w_down")}}
    gspmd, gspmd_aux = jax.jit(lambda p, xx: moe_ffn(p, xx, cfg))(
        sharded, jnp.asarray(x))
    for out in outs:                     # replicated over the expert group
        np.testing.assert_allclose(out["out"], ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out["out"], gspmd, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out["aux"], float(ref_aux), atol=1e-6)
        np.testing.assert_allclose(out["aux"], float(gspmd_aux), atol=1e-6)


def test_expert_parallel_gradients(ffn_case):
    """Gradients of sum(out * g) + aux: x's and the router's are whole on
    every rank, each rank's expert weights get their own experts' rows."""
    cfg, params, x, g, outs = ffn_case

    def loss(p, xx):
        out, aux = moe_ffn(p, xx, cfg)
        return (out * g).sum() + aux

    jp = jax.tree.map(jnp.asarray, params)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    n_loc = cfg.num_experts // len(outs)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["dx"], gx, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(out["grads"]["router"], gp["router"],
                                   atol=1e-5, rtol=1e-4)
        for k in ("w_gate", "w_up", "w_down"):
            want = np.asarray(gp[k])[rank * n_loc:(rank + 1) * n_loc]
            np.testing.assert_allclose(out["grads"][k], want, atol=1e-5,
                                       rtol=1e-4, err_msg=k)


CFG = {"dtype": "float32", "remat": True, "attn_impl": "xla",
       "moe_num_experts": 4, "moe_top_k": 2}


def _jcfg():
    return jllama.config_for("debug", dtype=jnp.float32, remat=True,
                             attn_impl="xla", moe_num_experts=4, moe_top_k=2)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        tokens = rng.integers(0, 256, (4, 32)).astype(np.int32)
        out.append({"tokens": tokens, "targets": np.roll(tokens, -1, 1)})
    return out


@pytest.fixture(scope="module")
def leg3(cpu_mesh_devices):
    cfg = _jcfg()
    params = jax.tree.map(np.asarray,
                          jllama.init_params(cfg, jax.random.PRNGKey(2)))
    (port,) = run_ranks("train_llama", 4, {
        "cfg": CFG, "params": params, "batches": _batches(),
        "mesh": {"data": 2, "expert": 2}})[:1]
    mesh = MeshConfig(data=2, expert=2).build(cpu_mesh_devices[:4])
    step, state = build_train_step(
        lambda p, b: jllama.loss_fn(p, b, cfg), optax.adamw(1e-3),
        jax.tree.map(jnp.asarray, params), jllama.param_logical_axes(cfg),
        mesh)
    losses, moe_aux = [], []
    for batch in _batches():
        state, aux = step(state, shard_batch(
            jax.tree.map(jnp.asarray, batch), mesh))
        losses.append(float(aux["loss"]))
        moe_aux.append(float(aux["moe_aux"]))
    return port, losses, moe_aux, jax.tree.map(np.asarray, state["params"])


def test_leg3_moe_step_on_data_x_expert(leg3):
    """Losses and moe_aux of the 3 steps, as tests/test_torch_moe.py holds
    the single-device MoE trajectory (an expert that few tokens reach has
    gradients near zero, where Adam's normalised step turns the two
    libraries' rounding into a visible parameter difference; the gradients
    themselves are held in test_expert_parallel_gradients)."""
    port, losses, moe_aux, _ = leg3
    np.testing.assert_allclose(port["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(port["moe_aux"], moe_aux, rtol=1e-5)


def test_leg3_rank_holds_half_the_experts(leg3):
    shapes = leg3[0]["local_shapes"]
    assert shapes["w_gate"] == (2, 2, 64, 128)      # [L, E/2, d, h]
    assert shapes["w_down"] == (2, 2, 128, 64)
    assert shapes["router"] == (2, 64, 4)           # replicated
