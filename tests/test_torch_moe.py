"""The port's MoE FFN (ray_tpu_torch.ops.moe) and the MoE branch of its Llama
against ray_tpu, in f32, from the same weights (drawn by the JAX package,
carried across as numpy) and the same inputs.

Routing is discrete: a near-tie between the k-th and the (k+1)-th expert
probability could flip a token's expert between the two libraries. Every
per-token comparison first asserts that this margin exceeds the tolerance
on the inputs it uses. Ties that are exact (a zero router) go to the lower
expert index in both.

Tolerances: moe_ffn outputs 1e-5; the MoE Llama's loss, moe_aux and grads
1e-5; routing tensors exactly."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops import moe as jmoe
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.parallel.spmd import build_train_step as jax_build_train_step
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import moe as tmoe
from ray_tpu_torch.parallel.spmd import adamw, build_train_step
from chip_smoke import moe_margins

TOL = 1e-5


def _configs(**kw):
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _moe_params(d, h, cfg, seed=0):
    """JAX's init_moe_params as numpy, and the same as torch tensors."""
    p = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), d, h, cfg))
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def routing_margin(x: np.ndarray, router: np.ndarray, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th router probability over
    all tokens (inf when every expert is chosen)."""
    logits = (x.reshape(-1, x.shape[-1]).astype(np.float64)
              @ router.astype(np.float64))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    if k >= probs.shape[-1]:
        return float("inf")
    top = -np.sort(-probs, axis=-1)
    return float((top[:, k - 1] - top[:, k]).min())


def _dense_swiglu(params, x, expert=0):
    gate = torch.nn.functional.silu(x @ params["w_gate"][expert])
    return (gate * (x @ params["w_up"][expert])) @ params["w_down"][expert]


def _ffn_both(jparams, tparams, x, jcfg, tcfg):
    jout, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, jparams),
                              jnp.asarray(x), jcfg)
    tout, taux = tmoe.moe_ffn(tparams, torch.from_numpy(x), tcfg)
    return (np.asarray(jout), float(jaux)), (tout.numpy(), float(taux))


# ------------------------------------------------------------ moe_ffn
def test_single_expert_equals_dense():
    """E=1, k=1, ample capacity: the MoE reduces to the dense FFN."""
    jcfg, tcfg = _configs(num_experts=1, top_k=1, capacity_factor=2.0)
    jp, tp = _moe_params(16, 32, jcfg)
    x = _x((2, 8, 16))
    (jout, _), (tout, _) = _ffn_both(jp, tp, x, jcfg, tcfg)
    dense = _dense_swiglu(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tout, dense, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)


def test_topk_routing_mixes_experts():
    """top-2 of 4 experts, ample capacity: each token's output is the
    renormalised gate mix of its two experts, and equals the reference's."""
    jcfg, tcfg = _configs(num_experts=4, top_k=2, capacity_factor=4.0)
    jp, tp = _moe_params(8, 16, jcfg)
    x = _x((1, 6, 8))
    assert routing_margin(x, jp["router"], 2) > TOL
    (jout, jaux), (tout, taux) = _ffn_both(jp, tp, x, jcfg, tcfg)
    xt = torch.from_numpy(x[0])
    probs = torch.softmax(xt @ tp["router"], -1)
    top_p, top_i = probs.topk(2, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros_like(xt)
    for t in range(x.shape[1]):
        for k in range(2):
            want[t] += top_p[t, k] * _dense_swiglu(
                tp, xt[t][None], expert=int(top_i[t, k]))[0]
    np.testing.assert_allclose(tout[0], want.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux, jaux, atol=TOL, rtol=TOL)


def test_capacity_drop_with_ties_to_expert_0():
    """A zero router ties every expert: both packages send every token to
    expert 0 (the lower index), whose one capacity slot serves only the
    first token; the rest are dropped (output 0)."""
    jcfg, tcfg = _configs(num_experts=2, top_k=1, capacity_factor=0.25)
    jp, tp = _moe_params(8, 16, jcfg)
    jp = {**jp, "router": np.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _x((1, 8, 8))
    (jout, _), (tout, _) = _ffn_both(jp, tp, x, jcfg, tcfg)
    served = np.abs(tout[0]).sum(-1) > 1e-7
    assert served.tolist() == [True] + [False] * 7
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)
    dispatch, combine, _ = tmoe._route(torch.zeros(8, 2), tcfg, capacity=1)
    assert dispatch[0, 0, 0] == 1 and dispatch.sum() == 1
    assert combine[0, 0, 0] == 1


def test_aux_loss_uniform_router():
    """A zero router gives uniform probabilities: the aux loss is
    E * sum(routed_frac * 1/E) = 1, times its weight, in both packages."""
    jcfg, tcfg = _configs(num_experts=4, top_k=1, capacity_factor=4.0,
                          aux_loss_weight=0.01)
    jp, tp = _moe_params(8, 16, jcfg)
    jp = {**jp, "router": np.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    (_, jaux), (_, taux) = _ffn_both(jp, tp, _x((2, 16, 8)), jcfg, tcfg)
    assert taux == pytest.approx(0.01, abs=1e-7)
    assert taux == pytest.approx(jaux, abs=1e-7)


def test_route_matches_jax_with_drops():
    """Top-2 of 4 with capacity 3 over 16 tokens per group, so some tokens
    are dropped: dispatch and combine equal the reference's slot for slot,
    and the aux loss agrees."""
    jcfg, tcfg = _configs(num_experts=4, top_k=2)
    logits = _x((3, 16, 4), seed=7) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top = -np.sort(-probs, axis=-1)
    assert (top[..., 1] - top[..., 2]).min() > TOL
    jd, jc, jaux = jax.vmap(lambda lg: jmoe._route(lg, jcfg, 3))(
        jnp.asarray(logits))
    td, tc, taux = tmoe._route(torch.from_numpy(logits), tcfg, 3)
    assert float(td.sum()) < 3 * 16 * 2                  # some were dropped
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), atol=1e-6)


def test_moe_ffn_matches_jax_at_default_capacity():
    """E=4, top-2, capacity factor 1.25 (C = 10 for s = 16): outputs and
    aux loss against the reference, routing margin checked first."""
    jcfg, tcfg = _configs(num_experts=4, top_k=2)
    jp, tp = _moe_params(16, 24, jcfg, seed=2)
    x = _x((3, 16, 16), seed=3)
    margin = routing_margin(x, jp["router"], 2)
    assert margin > TOL, margin
    (jout, jaux), (tout, taux) = _ffn_both(jp, tp, x, jcfg, tcfg)
    np.testing.assert_allclose(tout, jout, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(taux, jaux, atol=TOL, rtol=TOL)


def test_init_and_axes_match_reference():
    jcfg, tcfg = _configs(num_experts=4)
    tp = tmoe.init_moe_params(16, 24, tcfg, seed=0, device="cpu")
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), 16, 24, jcfg)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert abs(float(tp["w_down"].std()) - 24 ** -0.5) < 0.02
    assert tmoe.moe_logical_axes() == jmoe.moe_logical_axes()
    assert tmoe.MoEConfig() == tmoe.MoEConfig(**vars(jmoe.MoEConfig()))


# ------------------------------------------------------ the MoE Llama
def _llama_cfgs(**kw):
    kw = {"remat": False, "attn_impl": "xla", "moe_num_experts": 4,
          "moe_top_k": 2, **kw}
    return (jllama.config_for("debug", dtype=jnp.float32, **kw),
            tllama.config_for("debug", dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=1)
def _llama_np():
    jcfg, _ = _llama_cfgs()
    return jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))


def _batch_np(b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _layer_margins(tcfg, params, tokens) -> float:
    """The smallest routing margin over every MoE layer's input on this
    batch (the port's forward, which the reference matches to TOL, supplies
    the inputs)."""
    with moe_margins(tllama) as margins, torch.no_grad():
        tllama.forward(params, tokens, tcfg)
    assert len(margins) == tcfg.n_layers
    return min(margins)


def test_moe_llama_param_tree_matches_reference():
    jcfg, tcfg = _llama_cfgs()
    init = tllama.init_params(tcfg, seed=0, device="cpu")
    assert ({k: tuple(v.shape) for k, v in _named(init).items()}
            == {k: v.shape for k, v in _named(_llama_np()).items()})
    params = params_from_numpy(_llama_np(), device="cpu", cfg=tcfg)
    back = _named(params_to_numpy(params))
    for name, arr in _named(_llama_np()).items():
        np.testing.assert_array_equal(back[name], arr)
    dense = {**_llama_np(), "layers": {
        k: v for k, v in _llama_np()["layers"].items() if k != "router"}}
    with pytest.raises(ValueError):
        params_from_numpy(dense, device="cpu", cfg=tcfg)
    assert tcfg.moe_config() == tmoe.MoEConfig(
        **vars(jcfg.moe_config()))


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_moe_llama_loss_aux_and_grads_match_jax(attn_impl):
    jcfg, tcfg = _llama_cfgs(attn_impl=attn_impl)
    batch = _batch_np(seed=1)
    tp = params_from_numpy(_llama_np(), device="cpu", cfg=tcfg)
    margin = _layer_margins(tcfg, tp, _torch_batch(batch)["tokens"])
    assert margin > TOL, margin
    jp = jax.tree.map(jnp.asarray, _llama_np())
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jllama.loss_fn(p, jbatch, jcfg), has_aux=True)(jp)
    names = _named(tp)
    for t in names.values():
        t.requires_grad_(True)
    loss, aux = tllama.loss_fn(tp, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, list(names.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(aux["moe_aux"].detach()),
                               float(jaux["moe_aux"]),
                               atol=TOL, rtol=TOL)
    assert float(aux["moe_aux"].detach()) > 0
    want = _named(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_moe_llama_remat_keeps_grads(policy):
    _, plain = _llama_cfgs(attn_impl="flash")
    _, remat = _llama_cfgs(attn_impl="flash", remat=True,
                           remat_policy=policy)
    batch = _torch_batch(_batch_np(seed=2))
    grads = []
    for cfg in (plain, remat):
        tp = params_from_numpy(_llama_np(), device="cpu", cfg=cfg)
        leaves = list(_named(tp).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tllama.loss_fn(tp, batch, cfg)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


def test_moe_train_trajectory_matches_jax():
    """3 AdamW steps of the MoE Llama, against the JAX package's
    build_train_step with optax.adamw on a 1-device CPU mesh."""
    jcfg, tcfg = _llama_cfgs()
    batch = _batch_np(b=4, seed=3)
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    jstep, jstate = jax_build_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), optax.adamw(3e-4),
        jax.tree.map(jnp.asarray, _llama_np()),
        jllama.param_logical_axes(jcfg), mesh)
    step, state = build_train_step(
        lambda p, b: tllama.loss_fn(p, b, tcfg), adamw(3e-4),
        params_from_numpy(_llama_np(), device="cpu", cfg=tcfg), device="cpu")
    jbatch = jax.tree.map(jnp.asarray, batch)
    jlosses, losses, jaux_l, aux_l = [], [], [], []
    for _ in range(3):
        margin = _layer_margins(tcfg, state["params"],
                                _torch_batch(batch)["tokens"])
        assert margin > TOL, margin
        jstate, jaux = jstep(jstate, jbatch)
        state, aux = step(state, _torch_batch(batch))
        jlosses.append(float(jaux["loss"]))
        losses.append(float(aux["loss"]))
        jaux_l.append(float(jaux["moe_aux"]))
        aux_l.append(float(aux["moe_aux"]))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    np.testing.assert_allclose(aux_l, jaux_l, rtol=TOL)
    assert losses[-1] < losses[0]


def test_decode_step_refuses_moe():
    """The reference's decode block has no MoE FFN; the port refuses an MoE
    config before it touches the cache."""
    _, tcfg = _llama_cfgs()
    params = params_from_numpy(_llama_np(), device="cpu", cfg=tcfg)
    cache = tllama.init_kv_cache(tcfg, 1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tllama.decode_step(params, cache, torch.ones(1, 4, dtype=torch.long),
                           tcfg)
    assert int(cache["length"]) == 0
