"""The port's Llama (ray_tpu_torch.models.llama) against ray_tpu.models.llama
on the `debug` preset in f32, from the same weights (carried across with
params_from_numpy) and the same tokens. On the JAX side flash attention runs
the Pallas kernels in interpret mode; on the port's side its plain versions.

Tolerances: logits and loss 2e-5 (f32 through two blocks and a 256-way
softmax; the two libraries sum in different orders), grads 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

VAL_TOL = 2e-5
GRAD_TOL = 1e-4


def _cfgs(attn_impl, **torch_overrides):
    jcfg = jllama.config_for("debug", dtype=jnp.float32, remat=False,
                             attn_impl=attn_impl)
    tcfg = tllama.config_for("debug", **{
        "dtype": torch.float32, "remat": False, "attn_impl": attn_impl,
        **torch_overrides})
    return jcfg, tcfg


@functools.lru_cache(maxsize=1)
def _params_np():
    jcfg, _ = _cfgs("xla")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _batch_np(b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}


def _torch_params(cfg, grad=False):
    params = params_from_numpy(_params_np(), device="cpu", cfg=cfg)
    if grad:
        for t in _leaves(params):
            t.requires_grad_(True)
    return params


def _leaves(tree):
    return list(_named(tree).values())


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_forward_logits_and_loss(attn_impl):
    jcfg, tcfg = _cfgs(attn_impl)
    batch = _batch_np()
    jp = jax.tree.map(jnp.asarray, _params_np())
    jlogits = jllama.forward(jp, jnp.asarray(batch["tokens"]), jcfg)
    jloss, _ = jllama.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    tp = _torch_params(tcfg)
    with torch.no_grad():
        tlogits = tllama.forward(tp, _torch_batch(batch)["tokens"], tcfg)
        tloss, aux = tllama.loss_fn(tp, _torch_batch(batch), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=VAL_TOL, rtol=VAL_TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=VAL_TOL,
                               rtol=VAL_TOL)
    assert int(aux["tokens"]) == batch["tokens"].size


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_param_grads_match_jax(attn_impl):
    jcfg, tcfg = _cfgs(attn_impl)
    batch = _batch_np(seed=1)
    jp = jax.tree.map(jnp.asarray, _params_np())
    jgrads = jax.grad(lambda p: jllama.loss_fn(
        p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(jp)
    tp = _torch_params(tcfg, grad=True)
    loss, _ = tllama.loss_fn(tp, _torch_batch(batch), tcfg)
    names = _named(tp)
    grads = torch.autograd.grad(loss, list(names.values()))
    want = _named(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def _grads(tcfg, batch):
    tp = _torch_params(tcfg, grad=True)
    loss, _ = tllama.loss_fn(tp, _torch_batch(batch), tcfg)
    return torch.autograd.grad(loss, _leaves(tp))


@pytest.mark.parametrize("policy,save_attn", [("nothing", False),
                                              ("dots", False),
                                              ("dots", True),
                                              ("nothing", True)])
def test_remat_policies_keep_grads(policy, save_attn):
    batch = _batch_np(seed=2)
    _, plain = _cfgs("flash")
    _, remat = _cfgs("flash", remat=True, remat_policy=policy,
                     remat_save_attn=save_attn)
    for a, b in zip(_grads(plain, batch), _grads(remat, batch)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_unported_features_raise():
    """Ring and Ulysses attention with no seq group raise a clear error, as
    the reference's fail outside shard_map (inside a sharded step over a
    seq axis they run: tests/test_torch_sp.py)."""
    for impl in ("ring", "ulysses"):
        _, tcfg = _cfgs(impl)
        with pytest.raises(ValueError, match="needs a seq process group"):
            tllama.loss_fn(_torch_params(_cfgs("xla")[1]),
                           _torch_batch(_batch_np()), tcfg)


@pytest.mark.parametrize("preset", sorted(jllama.PRESETS))
def test_param_and_flop_counts(preset):
    jcfg = jllama.config_for(preset)
    tcfg = tllama.config_for(preset)
    assert tcfg.num_params() == jcfg.num_params()
    assert (tcfg.num_params(include_embed=False)
            == jcfg.num_params(include_embed=False))
    assert tcfg.flops_per_token() == jcfg.flops_per_token()
    assert tcfg.head_dim == jcfg.head_dim


def test_param_tree_round_trip_and_shape_check():
    _, tcfg = _cfgs("xla")
    tp = _torch_params(tcfg)
    back = params_to_numpy(tp)
    for name, arr in _named(_params_np()).items():
        np.testing.assert_array_equal(_named(back)[name], arr)
    init = tllama.init_params(tcfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in _named(init).items()} == \
        {k: v.shape for k, v in _named(_params_np()).items()}
    bad = dict(_params_np(), final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError):
        params_from_numpy(bad, device="cpu", cfg=tcfg)
    # bf16 leaves (numpy's ml_dtypes bfloat16, as JAX hands them over)
    jbf16 = np.asarray(jnp.asarray(_params_np()["final_norm"], jnp.bfloat16))
    tbf16 = params_from_numpy({"w": jbf16}, device="cpu")["w"]
    assert tbf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy({"w": tbf16})["w"],
                                  jbf16.astype(np.float32))
