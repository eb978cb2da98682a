"""The port's single-device train step (ray_tpu_torch.parallel.spmd) against
ray_tpu.parallel.spmd.build_train_step with optax.adamw on a 1-device CPU
mesh: same weights, same batch, 5 AdamW steps, debug preset in f32.

Tolerances: losses 1e-5 relative; final params 2e-5 absolute (5 steps of
lr 3e-4: a parameter moves at most ~1.5e-3, and where a gradient is close to
zero Adam's normalised step magnifies the two libraries' rounding
differences in it)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.parallel.spmd import build_train_step as jax_build_train_step
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel.spmd import (adamw, build_eval_step,
                                         build_train_step)

STEPS = 5


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _setup(b=4, s=32):
    jcfg = jllama.config_for("debug", dtype=jnp.float32, remat=False,
                             attn_impl="xla")
    tcfg = tllama.config_for("debug", dtype=torch.float32, remat=False,
                             attn_impl="xla")
    params = jax.tree.map(np.asarray,
                          jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}
    return jcfg, tcfg, params, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _port_run(tcfg, params, batch, steps, **kw):
    step, state = build_train_step(
        lambda p, b: tllama.loss_fn(p, b, tcfg), adamw(3e-4),
        params_from_numpy(params, device="cpu"), device="cpu", **kw)
    losses = []
    for _ in range(steps):
        state, aux = step(state, _torch_batch(batch))
        losses.append(float(aux["loss"]))
    return state, losses


def test_adamw_trajectory_matches_optax():
    jcfg, tcfg, params, batch = _setup()
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    jstep, jstate = jax_build_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), optax.adamw(3e-4),
        jax.tree.map(jnp.asarray, params), jllama.param_logical_axes(jcfg),
        mesh)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jlosses = []
    for _ in range(STEPS):
        jstate, aux = jstep(jstate, jbatch)
        jlosses.append(float(aux["loss"]))
    state, losses = _port_run(tcfg, params, batch, STEPS)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert state["step"] == STEPS == int(jstate["step"])
    want = _named(jax.tree.map(np.asarray, jstate["params"]))
    got = _named(params_to_numpy(state["params"]))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=2e-5,
                                   rtol=0, err_msg=name)


def test_grad_accum_matches_one_big_batch():
    _, tcfg, params, batch = _setup(b=4)
    big, big_losses = _port_run(tcfg, params, batch, 2)
    acc, acc_losses = _port_run(tcfg, params, batch, 2, grad_accum=2)
    # equal token counts per micro-batch: the mean of the halves' means is
    # the big batch's mean
    np.testing.assert_allclose(acc_losses, big_losses, rtol=1e-6)
    for name, p in _named(big["params"]).items():
        np.testing.assert_allclose(
            _named(acc["params"])[name].detach().numpy(),
            p.detach().numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_grad_accum_rejects_uneven_split():
    _, tcfg, params, batch = _setup(b=3)
    with pytest.raises(ValueError):
        _port_run(tcfg, params, batch, 1, grad_accum=2)


def test_param_dtypes_stay_fixed():
    _, _, params, batch = _setup()
    tcfg = tllama.config_for("debug", dtype=torch.float32, remat=False,
                             attn_impl="xla")
    mixed = params_from_numpy(params, device="cpu")
    mixed["embed"] = mixed["embed"].to(torch.bfloat16)   # one bf16 leaf
    dtypes = {k: v.dtype for k, v in _named(mixed).items()}
    step, state = build_train_step(
        lambda p, b: tllama.loss_fn(p, b, tcfg), adamw(3e-4), mixed,
        device="cpu")
    for _ in range(2):
        state, _ = step(state, _torch_batch(batch))
    assert {k: v.dtype for k, v in _named(state["params"]).items()} == dtypes


def test_trainable_keys_freeze_the_rest():
    _, tcfg, params, batch = _setup()
    step, state = build_train_step(
        lambda p, b: tllama.loss_fn(p, b, tcfg), adamw(3e-4),
        params_from_numpy(params, device="cpu"), device="cpu",
        trainable_keys=("lm_head",))
    assert set(state["params"]) == {"lm_head"}
    before = {k: v.clone() for k, v in _named(state["frozen"]).items()}
    state, _ = step(state, _torch_batch(batch))
    for name, v in _named(state["frozen"]).items():
        assert torch.equal(v, before[name]) and v.grad is None, name
    assert not np.allclose(state["params"]["lm_head"].detach().numpy(),
                           params["lm_head"])
    with pytest.raises(ValueError):
        build_train_step(lambda p, b: tllama.loss_fn(p, b, tcfg),
                         adamw(3e-4), params_from_numpy(params, "cpu"),
                         device="cpu", trainable_keys=("nope",))


def test_eval_step_matches_train_loss():
    _, tcfg, params, batch = _setup()
    evaluate = build_eval_step(lambda p, b: tllama.loss_fn(p, b, tcfg))
    tp = params_from_numpy(params, device="cpu")
    aux = evaluate(tp, _torch_batch(batch))
    _, losses = _port_run(tcfg, params, batch, 1)
    np.testing.assert_allclose(float(aux["loss"]), losses[0], rtol=1e-6)


def test_positional_order_is_the_references():
    """Called positionally as tests/test_train.py:66 calls the reference,
    (loss_fn, optimizer, params, logical_axes, mesh, ...), on the MLP with
    its list of layers: the logical axes are taken and ignored on one
    device, and the trajectory matches the reference's on a 1-device mesh
    at 1e-5 relative. A mesh or a sequence-sharded batch raises."""
    from ray_tpu.models import mlp as jmlp
    from ray_tpu_torch.models import mlp as tmlp

    cfg = dict(in_dim=16, hidden=(32,), n_classes=4)
    jparams = jmlp.mlp_init(jmlp.MLPConfig(**cfg), jax.random.PRNGKey(0))
    axes = [{"w": (None, None), "b": (None,)} for _ in jparams]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    y = ((x.sum(-1) > 0).astype(np.int32) % 4)
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    jstep, jstate = jax_build_train_step(jmlp.mlp_loss, optax.adamw(1e-2),
                                         jparams, axes, mesh)
    tparams = [params_from_numpy(jax.tree.map(np.asarray, layer),
                                 device="cpu") for layer in jparams]
    step, state = build_train_step(tmlp.mlp_loss, adamw(1e-2), tparams,
                                   axes, None, None, False, 1, None,
                                   device="cpu")
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    jlosses, losses = [], []
    for _ in range(3):
        jstate, jaux = jstep(jstate, jbatch)
        state, aux = step(state, batch)
        jlosses.append(float(jaux["loss"]))
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="item 6"):
        build_train_step(tmlp.mlp_loss, adamw(1e-2), tparams, axes, mesh)
    with pytest.raises(NotImplementedError, match="item 6"):
        build_train_step(tmlp.mlp_loss, adamw(1e-2), tparams, axes, None,
                         None, True, device="cpu")
