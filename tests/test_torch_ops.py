"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with ray_tpu.ops on
the CPU, in f32: the same numpy inputs through both. Values to 1e-5, grads to
1e-4 unless a case states otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import cross_entropy as jce
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rope as jrope
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import cross_entropy as tce
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rope as trope

VAL_TOL = 1e-5
GRAD_TOL = 1e-4


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(a, b, tol, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol,
                               err_msg=msg)


def test_rms_norm_value_and_grad():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 8, 32), _rand(rng, 32)
    ct = _rand(rng, 2, 8, 32)
    jf = lambda x, w: (jnorms.rms_norm(x, w, 1e-5) * ct).sum()  # noqa: E731
    jv = jnorms.rms_norm(x, w, 1e-5)
    jg = jax.grad(jf, argnums=(0, 1))(x, w)
    tx, tw = _t(x, True), _t(w, True)
    tv = tnorms.rms_norm(tx, tw, 1e-5)
    tg = torch.autograd.grad((tv * _t(ct)).sum(), (tx, tw))
    _close(tv, jv, VAL_TOL)
    for a, b in zip(tg, jg):
        _close(a, b, GRAD_TOL)


def test_rope_frequencies():
    jc, js = jrope.rope_frequencies(16, 64, 10000.0)
    tc, ts = trope.rope_frequencies(16, 64, 10000.0, device="cpu")
    # angles up to 63 rad: one ulp of the inverse frequency in pow() moves
    # cos/sin by ~4e-6 between the two libraries
    _close(tc, jc, 2e-5)
    _close(ts, js, 2e-5)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope(with_positions):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 10, 3, 16)
    cos, sin = (np.asarray(a) for a in jrope.rope_frequencies(16, 32))
    pos = rng.integers(0, 32, (2, 10)) if with_positions else None
    jv = jrope.apply_rope(x, cos, sin, None if pos is None else
                          jnp.asarray(pos, jnp.int32))
    tv = trope.apply_rope(_t(x), _t(cos), _t(sin),
                          None if pos is None else torch.tensor(pos))
    _close(tv, jv, VAL_TOL)


ATTN_CASES = {
    "causal": dict(sq=16, sk=16, h=4, hk=4, causal=True, seg=False),
    "noncausal": dict(sq=16, sk=16, h=4, hk=4, causal=False, seg=False),
    "gqa": dict(sq=16, sk=16, h=4, hk=2, causal=True, seg=False),
    # sq != sk: query i sees keys up to i + (sk - sq) (bottom-right)
    "rect_bottom_right": dict(sq=6, sk=16, h=4, hk=2, causal=True, seg=False),
    "segment_ids": dict(sq=16, sk=16, h=4, hk=2, causal=True, seg=True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_dense_attention(case):
    c = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    q = _rand(rng, 2, c["sq"], c["h"], 8)
    k = _rand(rng, 2, c["sk"], c["hk"], 8)
    v = _rand(rng, 2, c["sk"], c["hk"], 8)
    ct = _rand(rng, 2, c["sq"], c["h"], 8)
    seg = (np.array([[0] * 7 + [1] * 9, [0] * 12 + [1] * 4]) if c["seg"]
           else None)

    def jf(q, k, v):
        out = jattn.xla_attention(q, k, v, causal=c["causal"],
                                  segment_ids=None if seg is None
                                  else jnp.asarray(seg))
        return (out * ct).sum(), out

    (_, jv), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        q, k, v)
    tq, tk, tv_ = _t(q, True), _t(k, True), _t(v, True)
    out = tattn.dot_product_attention(
        tq, tk, tv_, causal=c["causal"], impl="xla",
        segment_ids=None if seg is None else torch.tensor(seg))
    tg = torch.autograd.grad((out * _t(ct)).sum(), (tq, tk, tv_))
    _close(out, jv, VAL_TOL)
    for a, b, n in zip(tg, jg, "qkv"):
        _close(a, b, GRAD_TOL, f"d{n}")


def test_bottom_right_alignment_named():
    """Dense causal attention with sq < sk: the last query sees every key,
    the first sees sk - sq + 1 of them (bottom-right alignment)."""
    rng = np.random.default_rng(3)
    q, k = _t(_rand(rng, 1, 2, 1, 4)), _t(_rand(rng, 1, 5, 1, 4))
    v = torch.eye(5)[None, :, None, :]   # out row = attention weights
    probs = tattn.xla_attention(q, k, v, causal=True)[0, :, 0]
    assert (probs[0, 4:] == 0).all() and (probs[0, :4] > 0).all()
    assert (probs[1] > 0).all()


def test_auto_picks_dense_on_cpu():
    q = torch.zeros(1, 2048, 1, 16)
    out = tattn.dot_product_attention(q, q, q, impl="auto")
    assert out.shape == q.shape


def test_softmax_cross_entropy_ignore_index():
    rng = np.random.default_rng(4)
    logits = _rand(rng, 3, 5, 11)
    labels = rng.integers(0, 11, (3, 5))
    labels[0, :2] = -100
    jf = lambda lg: jce.softmax_cross_entropy(lg, jnp.asarray(labels))[0]  # noqa: E731
    jl, jn = jce.softmax_cross_entropy(logits, jnp.asarray(labels))
    jg = jax.grad(jf)(logits)
    tl_ = _t(logits, True)
    loss, n = tce.softmax_cross_entropy(tl_, torch.tensor(labels))
    (tg,) = torch.autograd.grad(loss, (tl_,))
    assert int(n) == int(jn) == 13
    _close(loss, jl, VAL_TOL)
    _close(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("n_tok,chunk", [(32, 8), (30, 8)],
                         ids=["chunked", "dense_fallback"])
def test_fused_lm_head_cross_entropy(n_tok, chunk):
    rng = np.random.default_rng(5)
    b, s = 2, n_tok // 2
    x, head = _rand(rng, b, s, 16), _rand(rng, 16, 40)
    labels = rng.integers(0, 40, (b, s))
    labels[1, -3:] = -100

    def jf(x, head):
        return jce.fused_lm_head_cross_entropy(
            x, head, jnp.asarray(labels), chunk_size=chunk)[0]

    jl = jf(x, head)
    jg = jax.grad(jf, argnums=(0, 1))(x, head)
    tx, th = _t(x, True), _t(head, True)
    loss, n = tce.fused_lm_head_cross_entropy(tx, th, torch.tensor(labels),
                                              chunk_size=chunk)
    tg = torch.autograd.grad(loss, (tx, th))
    assert int(n) == b * s - 3
    _close(loss, jl, VAL_TOL)
    for a, bb in zip(tg, jg):
        _close(a, bb, GRAD_TOL)
