"""The port's flash attention (ray_tpu_torch.ops.cuda.flash_attention) held
against the JAX package's Pallas kernels, case by case as
tests/test_attention.py holds those against XLA. On CPU tensors the port's
autograd Function runs the kernels' plain versions; the Pallas kernels run in
interpret mode. Tolerances are that file's: fwd 2e-5, bwd 5e-4, f32."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash_attention as jflash
from ray_tpu_torch.ops.attention import xla_attention
from ray_tpu_torch.ops.cuda import flash_attention as tflash

FWD_TOL = 2e-5
BWD_TOL = 5e-4


def _qkv(b, sq, sk, h, hk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, sk, hk, d), dtype=np.float32),
            rng.standard_normal((b, sk, hk, d), dtype=np.float32))


def _weight_cos(out, lib):
    return (out * lib.cos(out)).sum()


def _weight_square(out, lib):
    return (out ** 2).sum()


def _weight_position(out, lib):
    pos = lib.arange(out.shape[1], dtype=out.dtype)[None, :, None, None]
    return (out * pos).sum()


LOSSES = {"cos": _weight_cos, "square": _weight_square,
          "position": _weight_position}

# name: (h, hk, d, causal, block_q, block_k, seed, loss); d=128 is the
# second width of the bf16 wgmma kernels, whose plain versions these hold
CASES = {
    "causal": (2, 2, 64, True, 128, 128, 2, "cos"),
    "noncausal": (2, 2, 64, False, 128, 128, 2, "cos"),
    "gqa": (4, 2, 64, True, 128, 128, 3, "square"),
    "rect_64x128": (2, 2, 64, True, 64, 128, 5, "position"),
    "rect_128x64": (2, 2, 64, True, 128, 64, 5, "position"),
    "rect_32x256": (2, 2, 64, True, 32, 256, 5, "position"),
    "gqa_d128": (4, 2, 128, True, 128, 128, 3, "square"),
    "noncausal_d128": (2, 2, 128, False, 128, 128, 2, "cos"),
}


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(q, k, v, out, dq, dk, dv) from the Pallas kernels, computed once."""
    h, hk, d, causal, bq, bk, seed, loss = CASES[case]
    q, k, v = _qkv(1, 256, 256, h, hk, d, seed)

    def f(q, k, v):
        out = jflash.flash_attention(q, k, v, causal, None, bq, bk)
        return LOSSES[loss](out, jnp), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (q, k, v, np.asarray(out)) + tuple(np.asarray(g) for g in grads)


def _port(case):
    _, _, _, causal, bq, bk, _, loss = CASES[case]
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _reference(case)[:3])
    out = tflash.flash_attention(q, k, v, causal, None, bq, bk)
    grads = torch.autograd.grad(LOSSES[loss](out, torch), (q, k, v))
    return (out.detach().numpy(),) + tuple(g.numpy() for g in grads)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_fwd_parity(case):
    out, _, _, _ = _port(case)
    np.testing.assert_allclose(out, _reference(case)[3], atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_bwd_parity(case):
    _, dq, dk, dv = _port(case)
    ref = _reference(case)[4:]
    for got, want, name in zip((dq, dk, dv), ref, "qkv"):
        np.testing.assert_allclose(got, want, atol=BWD_TOL, rtol=BWD_TOL,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_parity(causal):
    q, k, v = _qkv(1, 256, 256, 4, 2, 64, 7)
    _, jlse = jflash._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal, scale=None,
                                    block_q=128, block_k=64)
    _, tlse = tflash.flash_forward_plain(torch.tensor(q), torch.tensor(k),
                                         torch.tensor(v), causal, None,
                                         128, 64)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0],
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_flash_top_left_alignment_when_sq_differs_from_sk():
    """The flash path aligns the causal mask top-left (query i sees keys
    0..i), as the Pallas kernel does; the dense path aligns it bottom-right.
    Both packages agree on the flash result, and it equals dense attention
    over the first sq keys."""
    q, k, v = _qkv(1, 128, 256, 2, 2, 64, 9)
    jout = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), True, None, 64, 64)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    tout = tflash.flash_attention(tq, tk, tv, True, None, 64, 64)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=FWD_TOL,
                               rtol=FWD_TOL)
    top_left = xla_attention(tq, tk[:, :128], tv[:, :128], causal=True)
    np.testing.assert_allclose(tout.numpy(), top_left.numpy(), atol=FWD_TOL,
                               rtol=FWD_TOL)
    bottom_right = xla_attention(tq, tk, tv, causal=True)
    assert not np.allclose(tout.numpy(), bottom_right.numpy(), atol=1e-3)


def test_plain_versions_accept_ragged_lengths():
    """The kernel masks ragged edges itself; its plain version handles a
    length that no tile divides, matching dense attention."""
    q, k, v = _qkv(1, 100, 100, 2, 1, 16, 11)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, True, None, 32, 48)
    ref = xla_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=FWD_TOL, rtol=FWD_TOL)
    g = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    gr = torch.autograd.grad((ref ** 2).sum(), (tq, tk, tv))
    for a, b in zip(g, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=BWD_TOL,
                                   rtol=BWD_TOL)


def test_cpu_tensors_do_not_count_launches():
    before = dict(tflash.launches)
    q, k, v = (torch.tensor(a) for a in _qkv(1, 64, 64, 2, 2, 16, 0))
    tflash.flash_attention(q, k, v)
    assert tflash.launches == before


@pytest.mark.parametrize("d", [64, 128])
def test_wgmma_kernels_need_a_positive_scale(d):
    """The bf16 wgmma forward and dQ kernels (d 64 and 128) need scale > 0:
    the wrappers refuse any other before a launch. The mma.sync and f32
    kernels take any scale."""
    bf16 = torch.zeros((1, 1, 1, d), dtype=torch.bfloat16)
    for scale in (0.0, -d ** -0.5, float("nan")):
        with pytest.raises(ValueError, match="scale must be positive"):
            tflash._check_scale("flash_bwd_dq", bf16, scale)
    tflash._check_scale("flash_bwd_dq", bf16, d ** -0.5)
    tflash._check_scale("flash_bwd_dq", bf16.float(), -1.0)
    tflash._check_scale("flash_bwd_dq", torch.zeros((1, 1, 1, 32),
                                                    dtype=torch.bfloat16), -1.0)
