"""The port's LoRA (ray_tpu_torch.models.lora and the low-rank branch of
ray_tpu_torch.models.llama) against ray_tpu on the `debug` preset in f32,
from the same base weights and adapters (nonzero A and B drawn with numpy,
carried across with params_from_numpy) and the same tokens. On the JAX side
flash attention runs the Pallas kernels in interpret mode.

Tolerances: logits and loss 2e-5, decode logits 2e-5, adapter grads 1e-4
(as tests/test_torch_llama.py holds the base grads), the frozen-base
trajectory 1e-5 (losses, relative; adapters, absolute), merged weights
1e-6. A zero-B adapter and a frozen base are held bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.models import lora as jlora
from ray_tpu.parallel.mesh import build_mesh
from ray_tpu.parallel.spmd import build_train_step as jax_build_train_step
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import lora as tlora
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel.spmd import adamw, build_train_step
from chip_smoke import lora_numpy

TOL = 2e-5
GRAD_TOL = 1e-4
ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_jax_decode = jax.jit(jllama.decode_step, static_argnums=(3,))


def _cfgs(attn_impl="xla", **overrides):
    kw = {"remat": False, "attn_impl": attn_impl, **overrides}
    return (jllama.config_for("debug", dtype=jnp.float32, **kw),
            tllama.config_for("debug", dtype=torch.float32, **kw))


@functools.lru_cache(maxsize=1)
def _base_np():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))


def lora_np(cfg, rank=4, targets=ALL_TARGETS, seed=0, b_scale=0.05):
    """A nonzero adapter subtree as numpy (b_scale 0: a fresh init's
    zero-B adapter)."""
    return lora_numpy(cfg, rank, targets, seed, b_scale)


def _trees(tcfg, **lora_kw):
    """The same params with a nonzero adapter: (jax tree, torch dict)."""
    tree = {**_base_np(), "lora": lora_np(tcfg, **lora_kw)}
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu", cfg=tcfg))


def _batch_np(b=2, s=64, seed=0):
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


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_lora_forward_matches_jax(attn_impl):
    jcfg, tcfg = _cfgs(attn_impl)
    jp, tp = _trees(tcfg)
    batch = _batch_np()
    jlogits = jllama.forward(jp, jnp.asarray(batch["tokens"]), jcfg)
    jloss, _ = jllama.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jcfg)
    with torch.no_grad():
        tlogits = tllama.forward(tp, _torch_batch(batch)["tokens"], tcfg)
        tloss, _ = tllama.loss_fn(tp, _torch_batch(batch), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL,
                               rtol=TOL)
    # the adapters matter: the base model's logits are far from these
    base = params_from_numpy(_base_np(), device="cpu", cfg=tcfg)
    with torch.no_grad():
        plain = tllama.forward(base, _torch_batch(batch)["tokens"], tcfg)
    assert (plain - tlogits).abs().max() > 100 * TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_b_forward_equals_base_exactly(dtype):
    """B = 0 (a fresh init_lora_params): the forward equals the base
    model's bit for bit, in f32 and in bf16, on all seven targets."""
    cfg = tllama.config_for("debug", dtype=dtype, remat=False,
                            attn_impl="xla")
    base = params_from_numpy(_base_np(), device="cpu", cfg=cfg)
    adapter = tlora.init_lora_params(
        cfg, tlora.LoraConfig(rank=4, targets=ALL_TARGETS), seed=3,
        device="cpu")
    tokens = _torch_batch(_batch_np())["tokens"]
    with torch.no_grad():
        want = tllama.forward(base, tokens, cfg)
        got = tllama.forward({**base, "lora": adapter}, tokens, cfg)
    assert torch.equal(got, want)


def test_merge_lora_matches_jax_and_leaves_the_base_unwritten():
    jcfg, tcfg = _cfgs(lora_alpha=8.0)
    jp, tp = _trees(tcfg, targets=("wq", "wv", "w_down"))
    before = {k: v.clone() for k, v in _named(tp).items()}
    jmerged = jax.tree.map(np.asarray, jlora.merge_lora(jp, jcfg))
    tmerged = tlora.merge_lora(tp, tcfg)
    assert "lora" not in tmerged and "lora" in tp
    got, want = _named(params_to_numpy(tmerged)), _named(jmerged)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    for name, v in _named(tp).items():            # nothing written in place
        assert torch.equal(v, before[name]), name
    assert tmerged["layers"]["wk"] is tp["layers"]["wk"]   # untouched target
    assert tlora.merge_lora(tmerged, tcfg) is tmerged       # no adapters
    # folded in f32, the merged model's logits equal the low-rank path's
    tokens = _torch_batch(_batch_np())["tokens"]
    with torch.no_grad():
        np.testing.assert_allclose(
            tllama.forward(tmerged, tokens, tcfg).numpy(),
            tllama.forward(tp, tokens, tcfg).numpy(), atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------- grads
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_lora_grads_match_jax(attn_impl):
    jcfg, tcfg = _cfgs(attn_impl)
    jp, tp = _trees(tcfg)
    batch = _batch_np(seed=1)
    jbatch = jax.tree.map(jnp.asarray, batch)
    frozen = {k: v for k, v in jp.items() if k != "lora"}
    jgrads = jax.grad(lambda lp: jllama.loss_fn(
        {**frozen, "lora": lp}, jbatch, jcfg)[0])(jp["lora"])
    leaves = _named(tp["lora"])
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = tllama.loss_fn(tp, _torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = _named(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(leaves)
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[name], atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("policy", ["dots", "nothing"])
def test_lora_remat_keeps_grads(policy):
    _, plain = _cfgs("flash")
    _, remat = _cfgs("flash", remat=True, remat_policy=policy)
    batch = _torch_batch(_batch_np(seed=2))
    grads = []
    for cfg in (plain, remat):
        _, tp = _trees(cfg)
        leaves = list(_named(tp["lora"]).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tllama.loss_fn(tp, batch, cfg)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


# ------------------------------------------------- frozen-base training
def test_frozen_base_trajectory_matches_jax():
    """5 AdamW steps with trainable_keys=("lora",), against the JAX package's
    build_train_step with optax.adamw on a 1-device CPU mesh. The base gets
    no grad and no optimizer state, and stays bit-identical."""
    jcfg, tcfg = _cfgs()
    lcfg = jlora.LoraConfig(rank=4)
    tree = {**_base_np(), "lora": lora_np(tcfg, targets=lcfg.targets,
                                          b_scale=0.0)}
    batch = _batch_np(b=4, s=32)
    mesh = build_mesh({"data": 1}, jax.devices()[:1])
    jstep, jstate = jax_build_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), optax.adamw(3e-4),
        jax.tree.map(jnp.asarray, tree),
        {**jllama.param_logical_axes(jcfg),
         "lora": jlora.lora_logical_axes(jcfg, lcfg)},
        mesh, trainable_keys=("lora",))
    step, state = build_train_step(
        lambda p, b: tllama.loss_fn(p, b, tcfg), adamw(3e-4),
        params_from_numpy(tree, device="cpu", cfg=tcfg), device="cpu",
        trainable_keys=("lora",))
    assert set(state["params"]) == {"lora"}
    frozen = _named(state["frozen"])
    base_before = {k: v.clone() for k, v in frozen.items()}
    trained = list(_named(state["params"]).values())
    opt = state["opt_state"]
    assert [p for g in opt.param_groups for p in g["params"]] == trained
    jbatch = jax.tree.map(jnp.asarray, batch)
    jlosses, losses = [], []
    for _ in range(5):
        jstate, jaux = jstep(jstate, jbatch)
        jlosses.append(float(jaux["loss"]))
        state, aux = step(state, _torch_batch(batch))
        losses.append(float(aux["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    want = _named(jax.tree.map(np.asarray, jstate["params"]))
    got = _named(params_to_numpy(state["params"]))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    assert np.abs(got["lora/layers/wq_b"]).max() > 0       # B moved
    for name, v in _named(state["frozen"]).items():
        assert v.grad is None and not v.requires_grad, name
        assert torch.equal(v, base_before[name]), name
    assert set(map(id, opt.state)) == set(map(id, trained))


# ------------------------------------------------------------- decode
def test_decode_step_with_adapters_matches_jax():
    """A chunked prefill then stepwise decode over a nonzero adapter on
    all seven targets: logits and cache against the reference's."""
    jcfg, tcfg = _cfgs()
    jp, tp = _trees(tcfg)
    rng = np.random.default_rng(4)
    shape = (tcfg.n_layers, 2, 48, tcfg.n_kv_heads, tcfg.head_dim)
    cache = {"k": np.zeros(shape, np.float32),
             "v": np.zeros(shape, np.float32),
             "length": np.asarray(0, np.int32),
             "start": np.asarray([3, 0], np.int32)}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    calls = [rng.integers(1, 256, (2, 16)).astype(np.int32)
             for _ in range(2)]
    calls += [rng.integers(1, 256, (2, 1)).astype(np.int32)
              for _ in range(4)]
    base = params_from_numpy(_base_np(), device="cpu", cfg=tcfg)
    base_cache = {k: v.clone() for k, v in tc.items()}
    with torch.inference_mode():
        for tokens in calls:
            jlogits, jc = _jax_decode(jp, jc, jnp.asarray(tokens), jcfg)
            tlogits, tc = tllama.decode_step(tp, tc, torch.from_numpy(tokens),
                                             tcfg)
            np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                       atol=TOL, rtol=TOL)
            plain, base_cache = tllama.decode_step(
                base, base_cache, torch.from_numpy(tokens), tcfg)
            assert (plain - tlogits).abs().max() > 100 * TOL
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=TOL, rtol=TOL)


def test_decode_with_adapter_matches_forward():
    """The adapter acts alike at train and decode time: a prefill and
    teacher-forced steps give forward's logits at those positions."""
    _, tcfg = _cfgs()
    _, tp = _trees(tcfg, targets=tlora.DEFAULT_TARGETS, rank=8)
    tokens = torch.from_numpy(_batch_np(b=1, s=24, seed=5)["tokens"]).long()
    with torch.inference_mode():
        want = tllama.forward(tp, tokens, tcfg)[0, 15:]
        cache = tllama.init_kv_cache(tcfg, 1, max_len=32, device="cpu")
        out, cache = tllama.decode_step(tp, cache, tokens[:, :16], tcfg)
        got = [out[0]]
        for i in range(16, 24):
            out, cache = tllama.decode_step(tp, cache, tokens[:, i:i + 1],
                                            tcfg)
            got.append(out[0])
    np.testing.assert_allclose(torch.stack(got).numpy(), want.numpy(),
                               atol=TOL, rtol=TOL)


# ------------------------------------------------- init, axes, checks
def test_init_lora_params_contract():
    _, tcfg = _cfgs()
    lcfg = tlora.LoraConfig(rank=8, targets=ALL_TARGETS)
    adapter = tlora.init_lora_params(tcfg, lcfg, seed=1, device="cpu")
    ref = jlora.init_lora_params(_cfgs()[0], jlora.LoraConfig(
        rank=8, targets=ALL_TARGETS), jax.random.PRNGKey(1))
    assert ({k: tuple(v.shape) for k, v in _named(adapter).items()}
            == {k: v.shape for k, v in _named(ref).items()})
    layers = adapter["layers"]
    assert all(not layers[t + "_b"].any() for t in ALL_TARGETS)
    a = torch.cat([layers[t + "_a"].flatten() for t in ALL_TARGETS])
    assert abs(float(a.std()) - 8 ** -0.5) < 0.02          # N(0, 1/r)
    again = tlora.init_lora_params(tcfg, lcfg, seed=1, device="cpu")
    assert all(torch.equal(v, again["layers"][k]) for k, v in layers.items())
    assert lcfg.scale == 2.0
    with pytest.raises(ValueError, match="alpha"):
        tlora.init_lora_params(tcfg, tlora.LoraConfig(alpha=8.0),
                               device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tlora.init_lora_params(
            tllama.config_for("debug", moe_num_experts=4),
            tlora.LoraConfig(targets=("wq", "w_up")), device="cpu")
    with pytest.raises(ValueError, match="unknown LoRA target"):
        tlora.init_lora_params(tcfg, tlora.LoraConfig(targets=("wx",)),
                               device="cpu")


def test_lora_logical_axes_match_reference():
    jcfg, tcfg = _cfgs()
    for targets in (tlora.DEFAULT_TARGETS, ALL_TARGETS):
        assert tlora.lora_logical_axes(
            tcfg, tlora.LoraConfig(targets=targets)) == \
            jlora.lora_logical_axes(jcfg, jlora.LoraConfig(targets=targets))
    assert tlora._TARGET_AXES == jlora._TARGET_AXES
    assert tlora.DEFAULT_TARGETS == jlora.DEFAULT_TARGETS


def test_params_from_numpy_checks_the_adapter():
    _, tcfg = _cfgs()
    tree = {**_base_np(), "lora": lora_np(tcfg, targets=("wq", "w_up"))}
    back = params_to_numpy(params_from_numpy(tree, device="cpu", cfg=tcfg))
    for name, arr in _named(tree).items():
        np.testing.assert_array_equal(_named(back)[name], arr)
    layers = tree["lora"]["layers"]
    bad = {
        "two ranks": {**layers, "w_up_a": layers["w_up_a"][..., :2],
                      "w_up_b": layers["w_up_b"][:, :2]},
        "wrong out": {**layers, "wq_b": layers["wq_b"][..., :8]},
        "unpaired": {k: v for k, v in layers.items() if k != "wq_b"},
        "unknown target": {**layers, "wx_a": layers["wq_a"],
                           "wx_b": layers["wq_b"]},
    }
    for why, bad_layers in bad.items():
        with pytest.raises(ValueError):
            params_from_numpy({**_base_np(), "lora": {"layers": bad_layers}},
                              device="cpu", cfg=tcfg)
    with pytest.raises(ValueError):
        params_from_numpy({**_base_np(), "lora": layers}, device="cpu",
                          cfg=tcfg)
