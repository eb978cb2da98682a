"""The port's KV-cache decode (ray_tpu_torch.models.llama: init_kv_cache,
decode_step) against ray_tpu.models.llama on the `debug` preset in f32, from
the same weights (carried across with params_from_numpy), the same tokens
and the same starting cache.

Tolerance: logits and cache 2e-5, absolute and relative (f32 through two
blocks and a 256-way head; the two libraries sum in different orders). The
port's decode against its own forward: 2e-5 in f32, 2e-2 in bf16 (as
tests/test_models.py holds the reference's)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy

TOL = 2e-5
# the reference's decode_step, compiled once per shape (cfg is static)
_jax_decode = jax.jit(jllama.decode_step, static_argnums=(3,))


def _cfgs(**overrides):
    jcfg = jllama.config_for("debug", dtype=jnp.float32, remat=False,
                             **overrides)
    tcfg = tllama.config_for("debug", dtype=torch.float32, remat=False,
                             **overrides)
    return jcfg, tcfg


@functools.lru_cache(maxsize=1)
def _params_np():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(0)))


def _params(tcfg):
    return (jax.tree.map(jnp.asarray, _params_np()),
            params_from_numpy(_params_np(), device="cpu", cfg=tcfg))


def _caches(cache_np):
    """The same starting cache for both packages, from numpy."""
    return ({k: jnp.asarray(v) for k, v in cache_np.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in cache_np.items()})


def _zero_cache_np(cfg, b, max_len, length=0, start=None):
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": np.zeros(shape, np.float32), "v": np.zeros(shape, np.float32),
             "length": np.asarray(length, np.int32)}
    if start is not None:
        cache["start"] = np.asarray(start, np.int32)
    return cache


def _assert_close(t, j, name):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL,
                               rtol=TOL, err_msg=name)


def _step_both(jp, tp, jc, tc, tokens, jcfg, tcfg):
    jlogits, jc = _jax_decode(jp, jc, jnp.asarray(tokens), jcfg)
    tlogits, tc2 = tllama.decode_step(tp, tc, torch.from_numpy(tokens), tcfg)
    assert tc2 is tc                           # mutated and returned
    _assert_close(tlogits, jlogits, "logits")
    for key in ("k", "v"):
        _assert_close(tc[key], jc[key], f"cache {key}")
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))
    assert tc["length"].dtype == torch.int32
    return jc, tc


def _tokens(rng, b, s):
    return rng.integers(1, 256, (b, s)).astype(np.int32)


def test_prefill_then_stepwise_decode_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(tcfg)
    rng = np.random.default_rng(0)
    jc, tc = _caches(_zero_cache_np(jcfg, 2, 32))
    jc, tc = _step_both(jp, tp, jc, tc, _tokens(rng, 2, 8), jcfg, tcfg)
    for _ in range(4):
        jc, tc = _step_both(jp, tp, jc, tc, _tokens(rng, 2, 1), jcfg, tcfg)
    assert int(tc["length"]) == 12


def test_left_padded_batch_with_start_matches_jax():
    """Two rows of different real lengths, left-padded into one prompt
    bucket: `start` hides the pad slots and makes rope start-relative."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(tcfg)
    rng = np.random.default_rng(1)
    prompts = _tokens(rng, 2, 8)
    prompts[0, :3] = 0                          # row 0: 5 real tokens
    jc, tc = _caches(_zero_cache_np(jcfg, 2, 16, start=[3, 0]))
    jc, tc = _step_both(jp, tp, jc, tc, prompts, jcfg, tcfg)
    for _ in range(3):
        jc, tc = _step_both(jp, tp, jc, tc, _tokens(rng, 2, 1), jcfg, tcfg)
    np.testing.assert_array_equal(tc["start"].numpy(), [3, 0])


@pytest.mark.parametrize("s", [1, 3])
def test_per_row_depths_match_jax(s):
    """cache["length"] of shape [b]: each row writes at its own offset (the
    engine's decode slots). The cache starts from random contents, so stale
    slots past a row's depth must stay masked."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(tcfg)
    rng = np.random.default_rng(2)
    cache = _zero_cache_np(jcfg, 3, 24, length=[5, 9, 0], start=[0, 2, 0])
    cache["k"] = rng.standard_normal(cache["k"].shape).astype(np.float32)
    cache["v"] = rng.standard_normal(cache["v"].shape).astype(np.float32)
    jc, tc = _caches(cache)
    for _ in range(3):
        jc, tc = _step_both(jp, tp, jc, tc, _tokens(rng, 3, s), jcfg, tcfg)
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray([5, 9, 0]) + 3 * s)


def test_chunked_prefill_equals_monolithic():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(tcfg)
    prompts = _tokens(np.random.default_rng(3), 2, 24)
    prompts[1, :5] = 0
    start = [0, 5]
    _, mono = _caches(_zero_cache_np(jcfg, 2, 32, start=start))
    mono_logits, mono = tllama.decode_step(tp, mono, torch.from_numpy(prompts),
                                           tcfg)
    jc, tc = _caches(_zero_cache_np(jcfg, 2, 32, start=start))
    for i in range(0, 24, 8):                   # three chunks of 8, both sides
        jlogits, jc = _jax_decode(jp, jc, jnp.asarray(prompts[:, i:i + 8]),
                                  jcfg)
        logits, tc = tllama.decode_step(tp, tc,
                                        torch.from_numpy(prompts[:, i:i + 8]),
                                        tcfg)
        _assert_close(logits, jlogits, f"chunk at {i}")
    _assert_close(logits, mono_logits.numpy(), "chunked vs monolithic")
    # a pad query sees no key, so its uniform softmax averages whatever the
    # cache holds at that moment: pad slots past layer 0 differ between the
    # two (in both packages) and stay masked. Real slots must agree.
    for key in ("k", "v"):
        _assert_close(tc[key][:, 0], mono[key][:, 0].numpy(), key)
        _assert_close(tc[key][:, 1, 5:], mono[key][:, 1, 5:].numpy(), key)
    assert int(tc["length"]) == int(mono["length"]) == 24


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_decode_matches_forward(dtype, tol):
    """Mirrors tests/test_models.py::test_decode_matches_forward on the
    port: prefill 8 tokens, decode 4 one at a time, each last-position logit
    row against the dense forward's."""
    tcfg = tllama.config_for("debug", dtype=dtype, remat=False,
                             attn_impl="xla")
    tp = params_from_numpy(_params_np(), device="cpu", cfg=tcfg)
    tokens = torch.from_numpy(_tokens(np.random.default_rng(4), 1, 12))
    with torch.no_grad():
        dense = tllama.forward(tp, tokens, tcfg)
        cache = tllama.init_kv_cache(tcfg, 1, max_len=32, device="cpu")
        logits, cache = tllama.decode_step(tp, cache, tokens[:, :8], tcfg)
        np.testing.assert_allclose(logits.numpy(), dense[:, 7].numpy(),
                                   rtol=tol, atol=tol)
        for i in range(8, 12):
            logits, cache = tllama.decode_step(tp, cache, tokens[:, i:i + 1],
                                               tcfg)
            np.testing.assert_allclose(logits.numpy(), dense[:, i].numpy(),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_kv_cache_and_axes_match_jax(dtype):
    jcfg = jllama.config_for("debug", dtype=getattr(jnp, dtype))
    tcfg = tllama.config_for("debug", dtype=getattr(torch, dtype))
    for max_len in (None, 40):
        jc = jllama.init_kv_cache(jcfg, 3, max_len=max_len)
        tc = tllama.init_kv_cache(tcfg, 3, max_len=max_len, device="cpu")
        assert set(tc) == set(jc)
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape, key
            assert str(tc[key].dtype).split(".")[-1] == jc[key].dtype.name
            assert not tc[key].any()
    assert tllama.kv_cache_logical_axes() == jllama.kv_cache_logical_axes()


def test_free_row_overrun_is_nan_in_reference_and_finite_in_port():
    """A fault of the reference that the port does not copy. A free engine
    slot keeps decoding past max_seq_len: the reference's rope gather
    returns NaN past the table and its clamped cache write parks NaN K/V in
    the row's last slot. When a new request is grafted into that row, the
    masked NaN slot still poisons P.V (0 * NaN), so every logit is NaN. The
    port's decode_step refuses a position past the table, before it writes
    anything; its engine keeps a free row at depth 0 (as below), and then
    the reused row's logits are finite and equal to a fresh cache's."""
    jcfg, tcfg = _cfgs(max_seq_len=16)
    jp, tp = _params(tcfg)
    rng = np.random.default_rng(5)
    overrun = _zero_cache_np(jcfg, 2, 16, length=[4, 0], start=[0, 0])
    jc, tc = _caches(overrun)
    _, pinned = _caches(overrun)
    live = torch.tensor([True, False])
    for i in range(20):                         # row 1 runs to depth 20 > 16
        tok = _tokens(rng, 2, 1)
        _, jc = _jax_decode(jp, jc, jnp.asarray(tok), jcfg)
        if i < 12:                              # row 0 reaches depth 16
            tllama.decode_step(tp, tc, torch.from_numpy(tok), tcfg)
        elif i == 12:
            before = {k: v.clone() for k, v in tc.items()}
            with pytest.raises(ValueError, match="past the table"):
                tllama.decode_step(tp, tc, torch.from_numpy(tok), tcfg)
            for k in before:
                assert torch.equal(tc[k], before[k]), k
        # the engine's way: the free row 1 stays at depth 0, row 0 is
        # retired before it passes the table
        live[0] = i < 11
        tllama.decode_step(tp, pinned, torch.from_numpy(tok), tcfg)
        pinned["length"].mul_(live)
    # graft a freshly prefilled request (bucket 8, 5 real tokens) into row 1
    prompt = _tokens(rng, 1, 8)
    prompt[0, :3] = 0
    small = _zero_cache_np(jcfg, 1, 8, start=[3])
    _, small_t = _caches(small)
    _, small_t = tllama.decode_step(tp, small_t, torch.from_numpy(prompt), tcfg)
    row_k, row_v = small_t["k"][:, 0].numpy(), small_t["v"][:, 0].numpy()
    fresh = _zero_cache_np(jcfg, 2, 16, length=[0, 0], start=[0, 0])

    def graft(cache_np):
        cache_np = {k: np.array(v) for k, v in cache_np.items()}
        cache_np["k"][:, 1, :8] = row_k
        cache_np["v"][:, 1, :8] = row_v
        cache_np["length"][1] = 8
        cache_np["start"][1] = 3
        return cache_np

    tok = _tokens(rng, 2, 1)
    jc_np = graft(jax.tree.map(np.asarray, jc))
    jlogits, _ = _jax_decode(jp, _caches(jc_np)[0], jnp.asarray(tok), jcfg)
    assert np.isnan(np.asarray(jlogits)[1]).all()   # the reference's fault
    tc_np = graft({k: v.numpy() for k, v in pinned.items()})
    tlogits, _ = tllama.decode_step(tp, _caches(tc_np)[1],
                                    torch.from_numpy(tok), tcfg)
    want, _ = tllama.decode_step(tp, _caches(graft(fresh))[1],
                                 torch.from_numpy(tok), tcfg)
    assert torch.isfinite(tlogits).all()
    np.testing.assert_allclose(tlogits[1].numpy(), want[1].numpy(), atol=TOL,
                               rtol=TOL)


def test_position_past_the_table_raises():
    """A cache longer than the rope table (max_len > max_seq_len) decodes
    until a real row's position reaches the table's end, then raises."""
    tcfg = tllama.config_for("debug", dtype=torch.float32, remat=False,
                             max_seq_len=16)
    tp = params_from_numpy(_params_np(), device="cpu", cfg=tcfg)
    cache = tllama.init_kv_cache(tcfg, 1, max_len=24, device="cpu")
    tokens = torch.from_numpy(_tokens(np.random.default_rng(6), 1, 17))
    with torch.no_grad():
        _, cache = tllama.decode_step(tp, cache, tokens[:, :16], tcfg)
        with pytest.raises(ValueError, match="rope position 16"):
            tllama.decode_step(tp, cache, tokens[:, 16:], tcfg)
    assert int(cache["length"]) == 16
