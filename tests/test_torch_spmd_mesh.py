"""The port's sharded train step (ray_tpu_torch.parallel.spmd over a mesh)
on gloo CPU ranks against the reference's GSPMD step
(ray_tpu.parallel.spmd.build_train_step) on the same mesh shape over 4 of
the 8 virtual CPU devices: legs 1 and 1b of ``dryrun_multichip``, with
grad_accum, the token-weighted data-parallel loss, and the f/g trap.

Same numpy weights and batches on both sides, debug preset in f32 (remat
"dots", the dense attention path), 3 AdamW steps at lr 1e-3. Tolerances:
losses 1e-5 relative (as the single-device parity of
tests/test_torch_train_step.py); final params 5e-5 absolute (3 steps of lr
1e-3 move a parameter by ~3e-3, and Adam's normalised step magnifies the two
libraries' rounding where a gradient is near zero). All the port's runs
share one group of 4 ranks (one process start).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu.models import llama as jllama
from ray_tpu.models import lora as jlora
from ray_tpu.parallel.mesh import MeshConfig
from ray_tpu.parallel.spmd import build_train_step, shard_batch
from torch_mesh_ranks import run_ranks

CFG = {"dtype": "float32", "remat": True, "attn_impl": "xla"}
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-5


def _jcfg(**kw):
    return jllama.config_for("debug", dtype=jnp.float32, remat=True,
                             attn_impl="xla", **kw)


def _batches(n=3, b=4, s=32, seed=0, ignore=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
        targets = np.roll(tokens, -1, 1)
        if ignore:
            # the first half of the rows (data rank 0's) loses most of its
            # targets: the rank means weigh unlike the global mean
            targets[: b // 2, 4:] = -100
        out.append({"tokens": tokens, "targets": targets})
    return out


def _params(seed=0):
    return jax.tree.map(np.asarray,
                        jllama.init_params(_jcfg(), jax.random.PRNGKey(seed)))


def _lora_params():
    cfg = _jcfg()
    lcfg = jlora.LoraConfig(rank=4, targets=("wq", "wk", "wv", "wo",
                                              "w_gate", "w_up", "w_down"))
    params = {**jllama.init_params(cfg, jax.random.PRNGKey(7)),
              "lora": jlora.init_lora_params(cfg, lcfg,
                                             jax.random.PRNGKey(8))}
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    for name, leaf in params["lora"]["layers"].items():
        if name.endswith("_b"):     # a nonzero B, so every path carries grads
            params["lora"]["layers"][name] = (
                0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
    axes = {**jllama.param_logical_axes(cfg),
            "lora": jlora.lora_logical_axes(cfg, lcfg)}
    return params, axes


def _reference(cpu_mesh_devices, mesh_axes, params, batches, axes=None,
               opt=None, **kw):
    cfg = _jcfg()
    mesh = MeshConfig(**mesh_axes).build(cpu_mesh_devices[:4])
    step, state = build_train_step(
        lambda p, b: jllama.loss_fn(p, b, cfg), opt or optax.adamw(LR),
        jax.tree.map(jnp.asarray, params),
        axes or jllama.param_logical_axes(cfg), mesh, **kw)
    losses = []
    for batch in batches:
        state, aux = step(state, shard_batch(
            jax.tree.map(jnp.asarray, batch), mesh))
        losses.append(float(aux["loss"]))
    return losses, jax.tree.map(np.asarray, state["params"])


RUNS = {
    "fsdp2_tensor2": ("train_llama", {"mesh": {"fsdp": 2, "tensor": 2}}),
    "data2_tensor2": ("train_llama", {"mesh": {"data": 2, "tensor": 2}}),
    "lora": ("train_llama", {"mesh": {"fsdp": 2, "tensor": 2},
                             "trainable_keys": ("lora",), "lora": True}),
    "accum": ("train_llama", {"mesh": {"fsdp": 2, "tensor": 2},
                              "grad_accum": 2, "b": 8}),
    "ignore": ("train_llama", {"mesh": {"data": 2, "tensor": 2},
                               "ignore": True}),
    "sgd": ("train_llama", {"mesh": {"data": 2, "tensor": 2},
                            "opt": "sgd", "lr": 0.5}),
    "wrong_psum": ("train_llama", {"mesh": {"data": 2, "tensor": 2},
                                   "opt": "sgd", "lr": 0.5,
                                   "patch": "wrong_psum"}),
}


def _inputs(spec: dict) -> dict:
    params = _lora_params()[0] if spec.get("lora") else _params()
    inp = {"cfg": CFG, "params": params, "lr": LR,
           "batches": _batches(b=spec.get("b", 4),
                               ignore=spec.get("ignore", False))}
    inp.update({k: v for k, v in spec.items()
                if k not in ("lora", "b", "ignore")})
    return inp


@pytest.fixture(scope="module")
def port_runs():
    names = list(RUNS)
    outs = run_ranks("many", 4, [(RUNS[n][0], _inputs(RUNS[n][1]))
                                 for n in names], timeout=150)
    # the loss and gathered params are the global ones on every rank
    for rank_out in outs[1:]:
        for i in range(len(names)):
            assert rank_out[i]["losses"] == outs[0][i]["losses"]
    return (dict(zip(names, outs[0])),
            {n: [o[i] for o in outs] for i, n in enumerate(names)})


def _assert_params(got: dict, want: dict, prefix=""):
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_params(got[k], w, prefix + k + "/")
        else:
            np.testing.assert_allclose(got[k], w, atol=PARAM_ATOL, rtol=0,
                                       err_msg=prefix + k)


@pytest.mark.parametrize("mesh", ["fsdp2_tensor2", "data2_tensor2"])
def test_leg1_matches_reference_gspmd_step(cpu_mesh_devices, port_runs,
                                           mesh):
    got = port_runs[0][mesh]
    want_losses, want_params = _reference(
        cpu_mesh_devices, RUNS[mesh][1]["mesh"], _params(), _batches())
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params(got["params"], want_params)


def test_leg1_rank_holds_its_shard(port_runs):
    """fsdp 2 x tensor 2: wq [L, d, h*hd] is [L, d/2, h*hd/2] on a rank,
    wo [L, h*hd, d] is [L, h*hd/2, d/2], the norms whole."""
    shapes = port_runs[0]["fsdp2_tensor2"]["local_shapes"]
    assert shapes["wq"] == (2, 32, 32)
    assert shapes["wo"] == (2, 32, 32)
    assert shapes["w_gate"] == (2, 32, 64)
    assert shapes["attn_norm"] == (2, 64)


def test_leg1b_lora_frozen_base_sharded(cpu_mesh_devices, port_runs):
    params, axes = _lora_params()
    got = port_runs[0]["lora"]
    want_losses, want_params = _reference(
        cpu_mesh_devices, {"fsdp": 2, "tensor": 2}, params, _batches(),
        axes=axes, trainable_keys=("lora",))
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params(got["params"], want_params)
    for rank_out in port_runs[1]["lora"]:
        before, after = rank_out["frozen_before"], rank_out["frozen_after"]
        for name in before["layers"]:
            assert np.array_equal(before["layers"][name],
                                  after["layers"][name]), name
        assert np.array_equal(before["embed"], after["embed"])


def test_grad_accum_on_a_mesh(cpu_mesh_devices, port_runs):
    got = port_runs[0]["accum"]
    want_losses, want_params = _reference(
        cpu_mesh_devices, {"fsdp": 2, "tensor": 2}, _params(),
        _batches(b=8), grad_accum=2)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params(got["params"], want_params)


def test_data_parallel_loss_is_token_weighted(cpu_mesh_devices, port_runs):
    """Rows with ignored targets sit on one data rank: the step's loss and
    gradients are the global batch's token mean (the reference's GSPMD
    mean), which a plain mean of the ranks' means misses by far more than
    the tolerance."""
    got = port_runs[0]["ignore"]
    batches = _batches(ignore=True)
    want_losses, want_params = _reference(
        cpu_mesh_devices, {"data": 2, "tensor": 2}, _params(), batches)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    _assert_params(got["params"], want_params)
    cfg = _jcfg()
    params = jax.tree.map(jnp.asarray, _params())
    halves = [jax.tree.map(lambda x: jnp.asarray(x[i * 2:(i + 1) * 2]),
                           batches[0]) for i in range(2)]
    rank_means = np.mean([float(jllama.loss_fn(params, h, cfg)[0])
                          for h in halves])
    assert abs(rank_means - want_losses[0]) > 100 * LOSS_RTOL * abs(
        want_losses[0])
    assert got["tokens"][0] == float((batches[0]["targets"] != -100).sum())


def test_row_parallel_sum_has_identity_backward(cpu_mesh_devices,
                                                port_runs):
    """The f/g trap: after the row-parallel wo and w_down every tensor rank
    holds the same loss, so the all-reduce there (g) must pass gradients
    through unchanged. torch.distributed.nn's all_reduce all-reduces the
    gradient again, multiplying by the tensor size the gradients that flow
    back through it. Under SGD (Adam's normalised step would hide a uniform
    scale) the right g follows the reference's trajectory within the
    tolerance, and the wrong one leaves it after the first step."""
    want_losses, _ = _reference(cpu_mesh_devices, {"data": 2, "tensor": 2},
                                _params(), _batches(), opt=optax.sgd(0.5))
    right = port_runs[0]["sgd"]["losses"]
    wrong = port_runs[0]["wrong_psum"]["losses"]
    np.testing.assert_allclose(right, want_losses, rtol=LOSS_RTOL)
    assert wrong[0] == pytest.approx(want_losses[0], rel=LOSS_RTOL)
    assert abs(wrong[1] - want_losses[1]) > 100 * LOSS_RTOL * want_losses[1]
