"""The port's MLP (ray_tpu_torch.models.mlp) against ray_tpu.models.mlp, in
f32, from the same weights (drawn by the JAX package, carried across layer
by layer with params_from_numpy) and the same numpy batch.

Tolerances: logits and loss 1e-5; a 20-step SGD trajectory 1e-5 (relative,
on the losses), on a separable problem where both must converge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mlp as jmlp
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.models.convert import params_from_numpy

TOL = 1e-5
CFG = dict(in_dim=32, hidden=(64, 48), n_classes=5)


def _params():
    jp = jmlp.mlp_init(jmlp.MLPConfig(**CFG), jax.random.PRNGKey(0))
    return jp, [params_from_numpy(jax.tree.map(np.asarray, layer),
                                  device="cpu") for layer in jp]


def _batch(n=128, seed=0):
    """Gaussian clusters, one per class: a problem a small MLP separates."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((CFG["n_classes"], CFG["in_dim"])) * 2
    y = rng.integers(0, CFG["n_classes"], n)
    x = centers[y] + rng.standard_normal((n, CFG["in_dim"]))
    return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def _torch_batch(batch):
    return {"x": torch.from_numpy(batch["x"]),
            "y": torch.from_numpy(batch["y"]).long()}


def test_mlp_init_matches_reference_shapes():
    jp, _ = _params()
    tp = tmlp.mlp_init(tmlp.MLPConfig(**CFG), seed=0, device="cpu")
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in tp] \
        == [{k: v.shape for k, v in layer.items()} for layer in jp]
    assert all(not layer["b"].any() for layer in tp)
    assert abs(float(tp[1]["w"].std()) - 64 ** -0.5) < 0.02
    assert tmlp.MLPConfig().in_dim == jmlp.MLPConfig().in_dim == 784


def test_mlp_forward_and_loss_match_jax():
    jp, tp = _params()
    batch = _batch()
    jlogits = jmlp.mlp_forward(jp, jnp.asarray(batch["x"]))
    jloss, jaux = jmlp.mlp_loss(jp, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        tlogits = tmlp.mlp_forward(tp, torch.from_numpy(batch["x"]))
        tloss, taux = tmlp.mlp_loss(tp, _torch_batch(batch))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    assert float(taux["accuracy"]) == pytest.approx(float(jaux["accuracy"]))


def test_mlp_sgd_converges_like_jax():
    """20 steps of plain SGD (lr 0.1) from the same weights: the losses
    follow the reference's, and the model learns the clusters."""
    jp, tp = _params()
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    grad_fn = jax.jit(jax.grad(lambda p: jmlp.mlp_loss(p, jbatch)[0]))
    leaves = [t for layer in tp for t in layer.values()]
    for t in leaves:
        t.requires_grad_(True)
    jlosses, losses = [], []
    for _ in range(20):
        jlosses.append(float(jmlp.mlp_loss(jp, jbatch)[0]))
        jp = jax.tree.map(lambda p, g: p - 0.1 * g, jp, grad_fn(jp))
        loss, aux = tmlp.mlp_loss(tp, _torch_batch(batch))
        losses.append(float(loss.detach()))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t -= 0.1 * g
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    assert losses[-1] < 0.25 * losses[0]
    assert float(aux["accuracy"]) > 0.9
