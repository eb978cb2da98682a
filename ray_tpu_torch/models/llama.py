"""Llama-family transformer (counterpart of ray_tpu/models/llama.py): the
training half and the KV-cache decode half.

* Params are a plain dict of tensors with the reference's keys and layouts:
  per-layer weights are stacked on a leading ``[n_layers]`` axis, and weights
  are ``[in, out]`` (``x @ W``), so weights convert from the JAX tree with
  no transposes (``models/convert.py``).
* The block stack is a Python loop over ``unbind(0)`` of the stacked weights
  (the reference's ``lax.scan``); unbind's backward stacks the per-layer
  grads once.
* Compute in ``cfg.dtype`` (bf16), params in ``cfg.param_dtype`` (f32),
  softmax/norm/rope in f32.
* Remat: ``remat_policy="nothing"`` checkpoints each block whole;
  ``"dots"`` saves matmul outputs (``aten.mm``) and recomputes the rest via
  selective checkpointing; ``remat_save_attn`` also saves the flash
  forward's outputs, so the backward does not rerun the forward kernel.
* Attention goes to the flash kernels or the dense path (``_attention``).
* Decoding (``init_kv_cache``, ``decode_step``) appends to a KV cache that it
  writes **in place**: torch has no buffer donation, so ``decode_step``
  mutates the cache dict it is given and returns it. Write offsets are
  clamped into the cache as ``dynamic_update_slice`` clamps them; a rope
  position past the table raises, where the reference gathers NaN.
* LoRA: a ``"lora"`` subtree (``models/lora.py``) rides the block loop beside
  the base weights, and ``_proj`` adds its low-rank path at train and decode
  time alike.
* MoE: ``moe_num_experts > 0`` replaces every dense FFN with
  ``ops.moe.moe_ffn``, whose aux loss reaches ``loss_fn``. The decode path
  has no MoE FFN, as the reference's has none.

Not in this slice: ring/Ulysses attention (multi-GPU).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# registers the ray_tpu_torch::flash_fwd op that remat_save_attn names
import ray_tpu_torch.ops.cuda.flash_attention  # noqa: F401
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.attention import (NEG_INF, _repeat_kv,
                                         dot_product_attention)
from ray_tpu_torch.ops.cross_entropy import fused_lm_head_cross_entropy
from ray_tpu_torch.ops.moe import MoEConfig, moe_ffn
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    hidden_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    remat_save_attn: bool = False
    # "dots": save matmul outputs; "nothing": recompute the whole block
    remat_policy: str = "dots"
    # "auto" | "xla" | "flash" ("ring" | "ulysses" are not ported yet)
    attn_impl: str = "auto"
    # tiles of the plain flash version (the CUDA kernel picks its own)
    attn_block_q: int = 512
    attn_block_k: int = 512
    seq_axis: str = "seq"
    lora_alpha: float = 16.0
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_weight: float = 0.01

    @property
    def moe(self) -> bool:
        return self.moe_num_experts > 0

    def moe_config(self) -> MoEConfig:
        return MoEConfig(num_experts=self.moe_num_experts,
                         top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         aux_loss_weight=self.moe_aux_loss_weight)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def flops_per_token(self) -> float:
        """Approximate training FLOPs per token (fwd+bwd, 6ND rule plus
        attention quadratic term)."""
        n_params = self.num_params(include_embed=False)
        attn = 12 * self.n_layers * self.dim * self.max_seq_len
        return 6 * n_params + attn

    def num_params(self, include_embed: bool = True) -> int:
        d, h = self.dim, self.hidden_dim
        kv_dim = self.n_kv_heads * self.head_dim
        per_layer = (d * d + 2 * d * kv_dim + d * d) + 3 * d * h + 2 * d
        total = self.n_layers * per_layer + d
        if include_embed:
            total += self.vocab_size * d
            if not self.tie_embeddings:
                total += d * self.vocab_size
        return total


# ----------------------------------------------------------------- presets
PRESETS: dict[str, dict] = {
    # debug-size model for tests
    "debug": dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                  n_kv_heads=2, hidden_dim=128, max_seq_len=128),
    "160m": dict(vocab_size=32000, dim=768, n_layers=12, n_heads=12,
                 n_kv_heads=12, hidden_dim=2048, max_seq_len=2048),
    "410m": dict(vocab_size=32000, dim=1024, n_layers=24, n_heads=16,
                 n_kv_heads=16, hidden_dim=2816, max_seq_len=2048),
    # same params/FLOPs as 410m with head_dim=128 (8x128 instead of 16x64)
    "410m-hd128": dict(vocab_size=32000, dim=1024, n_layers=24, n_heads=8,
                       n_kv_heads=8, hidden_dim=2816, max_seq_len=2048),
    "1b": dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
               n_kv_heads=8, hidden_dim=5632, max_seq_len=2048),
    "llama2-7b": dict(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                      n_kv_heads=32, hidden_dim=11008, max_seq_len=4096),
    "llama2-13b": dict(vocab_size=32000, dim=5120, n_layers=40, n_heads=40,
                       n_kv_heads=40, hidden_dim=13824, max_seq_len=4096),
    "llama3-8b": dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                      n_kv_heads=8, hidden_dim=14336, max_seq_len=8192,
                      rope_theta=500000.0),
    "llama2-70b": dict(vocab_size=32000, dim=8192, n_layers=80, n_heads=64,
                       n_kv_heads=8, hidden_dim=28672, max_seq_len=4096),
}


def config_for(name: str, **overrides) -> LlamaConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return LlamaConfig(**kw)


def _check_ported(cfg: LlamaConfig) -> None:
    if cfg.attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} needs the multi-GPU slice")


# ------------------------------------------------------------------- params
def param_shapes(cfg: LlamaConfig) -> dict:
    """The parameter tree of ``init_params`` with shapes as leaves."""
    _check_ported(cfg)
    d, h, L = cfg.dim, cfg.hidden_dim, cfg.n_layers
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    shapes = {
        "embed": (cfg.vocab_size, d),
        "layers": {
            "wq": (L, d, nh * hd),
            "wk": (L, d, nkv * hd),
            "wv": (L, d, nkv * hd),
            "wo": (L, nh * hd, d),
            "attn_norm": (L, d),
            "mlp_norm": (L, d),
        },
        "final_norm": (d,),
    }
    if cfg.moe:
        E = cfg.moe_num_experts
        shapes["layers"].update({"router": (L, d, E),
                                 "w_gate": (L, E, d, h),
                                 "w_up": (L, E, d, h),
                                 "w_down": (L, E, h, d)})
    else:
        shapes["layers"].update({"w_gate": (L, d, h), "w_up": (L, d, h),
                                 "w_down": (L, h, d)})
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def init_params(cfg: LlamaConfig, seed: int = 0,
                device: str | torch.device | None = None) -> dict:
    """A parameter dict drawn from a ``torch.Generator`` seeded with
    ``seed``: weights ~ N(0, 1/fan_in), norms ones. (The draws differ from
    ``jax.random``; carry the JAX package's weights over with
    ``models.convert.params_from_numpy`` where they must match.)"""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(shape: tuple, name: str) -> torch.Tensor:
        if name.endswith("norm"):
            return torch.ones(shape, dtype=cfg.param_dtype, device=dev)
        fan_in = shape[-2] if name != "embed" else shape[-1]
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * (1.0 / math.sqrt(fan_in))).to(cfg.param_dtype)

    shapes = param_shapes(cfg)
    params = {name: leaf(shape, name) for name, shape in shapes.items()
              if name != "layers"}
    params["layers"] = {name: leaf(shape, name)
                        for name, shape in shapes["layers"].items()}
    return params


# ------------------------------------------------------------------ forward
def _attention(cfg: LlamaConfig, q, k, v):
    _check_ported(cfg)
    return dot_product_attention(q, k, v, causal=True, impl=cfg.attn_impl,
                                 block_q=cfg.attn_block_q,
                                 block_k=cfg.attn_block_k)


def _proj(cfg: LlamaConfig, layer: dict, name: str, h: torch.Tensor):
    """Matmul against one layer weight in the compute dtype, plus the LoRA
    low-rank path where the layer carries ``<name>_a``/``<name>_b`` (shared
    by the train and decode blocks, so adapters act alike in both). The
    [in, out] delta is never formed."""
    dt = cfg.dtype
    out = h @ layer[name].to(dt)
    a = layer.get(name + "_a")
    if a is not None:
        scale = cfg.lora_alpha / a.shape[-1]
        out = out + ((h @ a.to(dt)) @ layer[name + "_b"].to(dt)
                     ) * torch.tensor(scale, dtype=dt)
    return out


def _block(cfg: LlamaConfig, x, layer, cos, sin, positions):
    """One transformer block. x: [b, s, d] (cfg.dtype).
    Returns (x, moe_aux_loss); aux is 0 for the dense FFN."""
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = _proj(cfg, layer, "wq", h).reshape(b, s, nh, hd)
    kk = _proj(cfg, layer, "wk", h).reshape(b, s, nkv, hd)
    vv = _proj(cfg, layer, "wv", h).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin, positions)
    kk = apply_rope(kk, cos, sin, positions)
    attn = _attention(cfg, q, kk, vv).reshape(b, s, nh * hd)
    x = x + _proj(cfg, layer, "wo", attn)

    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    if cfg.moe:
        moe_params = {k: layer[k] for k in ("router", "w_gate", "w_up",
                                            "w_down")}
        out, aux = moe_ffn(moe_params, h, cfg.moe_config())
        return x + out, aux
    gate = F.silu(_proj(cfg, layer, "w_gate", h))
    up = _proj(cfg, layer, "w_up", h)
    x = x + _proj(cfg, layer, "w_down", gate * up)
    return x, x.new_zeros((), dtype=torch.float32)


def _saved_ops(cfg: LlamaConfig) -> frozenset:
    """Ops whose outputs the remat policy keeps for the backward."""
    if cfg.remat_policy == "dots":
        ops = {torch.ops.aten.mm.default}
    elif cfg.remat_policy == "nothing":
        ops = set()
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    if cfg.remat_save_attn:
        ops.add(torch.ops.ray_tpu_torch.flash_fwd.default)
    return frozenset(ops)


def _selective_policy(saved: frozenset, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(cfg: LlamaConfig):
    """_block, wrapped in the activation checkpoint that cfg asks for."""
    if not cfg.remat:
        return _block
    saved = _saved_ops(cfg)
    if not saved:
        return functools.partial(checkpoint, _block, use_reentrant=False)
    context_fn = functools.partial(
        create_selective_checkpoint_contexts,
        functools.partial(_selective_policy, saved))
    return functools.partial(checkpoint, _block, use_reentrant=False,
                             context_fn=context_fn)


def _stacked_layers(params: dict) -> dict:
    """The per-layer weights stacked on [n_layers], adapters included: they
    share the leading axis, so they ride the same loop (reference
    ``llama.py:322-325``)."""
    if "lora" not in params:
        return params["layers"]
    return {**params["layers"], **params["lora"]["layers"]}


def backbone(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
             positions: torch.Tensor | None = None, with_aux: bool = False):
    """tokens: [b, s] int -> final hidden states [b, s, d] (cfg.dtype), or
    (hidden, moe_aux_loss) when with_aux."""
    _check_ported(cfg)
    x = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=x.device)
    layers = _stacked_layers(params)
    names = list(layers)
    per_layer = zip(*(layers[n].unbind(0) for n in names))
    block = _remat_block(cfg)
    aux_sum = x.new_zeros((), dtype=torch.float32)
    for weights in per_layer:
        x, aux = block(cfg, x, dict(zip(names, weights)), cos, sin,
                       positions)
        aux_sum = aux_sum + aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x, aux_sum) if with_aux else x


def _head_matrix(params: dict, cfg: LlamaConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(cfg.dtype)


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: torch.Tensor | None = None) -> torch.Tensor:
    """tokens: [b, s] int -> logits [b, s, vocab] (f32)."""
    x = backbone(params, tokens, cfg, positions)
    return (x @ _head_matrix(params, cfg)).float()


def loss_fn(params: dict, batch: dict, cfg: LlamaConfig):
    """batch: {"tokens": [b, s], "targets": [b, s]} -> (loss, aux).

    Uses the fused LM head + cross entropy so the [b*s, vocab] f32 logits
    tensor never exists at once.
    """
    x, moe_aux = backbone(params, batch["tokens"], cfg, with_aux=True)
    ce_loss, n_tok = fused_lm_head_cross_entropy(
        x, _head_matrix(params, cfg), batch["targets"])
    loss = ce_loss + moe_aux
    return loss, {"loss": ce_loss, "tokens": n_tok, "moe_aux": moe_aux}


# ----------------------------------------------------------------- decoding
def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int | None = None,
                  device: str | torch.device | None = None) -> dict:
    """A zeroed KV cache: ``k``/``v`` ``[n_layers, batch, max_len, n_kv_heads,
    head_dim]`` in ``cfg.dtype``, ``length`` (int32 scalar: the write cursor)
    and ``start`` (int32 ``[batch]``: each row's first real slot; left-pad
    slots ``[0, start)`` are masked and rope positions are start-relative)."""
    dev = resolve_device(device)
    max_len = max_len or cfg.max_seq_len
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "length": torch.zeros((), dtype=torch.int32, device=dev),
        "start": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def kv_cache_logical_axes() -> dict:
    return {"k": ("layers", "batch", None, "kv_heads", "head_dim"),
            "v": ("layers", "batch", None, "kv_heads", "head_dim"),
            "length": (), "start": ("batch",)}


def _write_kv(cache: torch.Tensor, new: torch.Tensor,
              cache_len: torch.Tensor) -> None:
    """cache[i, off_i : off_i + s] = new[i] in place, for every row i, where
    off = cache_len (a scalar, or ``[b]`` per row) clamped into
    ``[0, max_len - s]`` as ``dynamic_update_slice`` clamps it."""
    b, max_len, nkv, hd = cache.shape
    s = new.shape[1]
    off = cache_len.clamp(0, max_len - s).expand(b)
    rows = torch.arange(b, device=cache.device) * max_len
    slots = torch.arange(s, device=cache.device)
    flat = (rows + off)[:, None] + slots[None, :]
    cache.view(b * max_len, nkv, hd).index_copy_(
        0, flat.reshape(-1), new.reshape(b * s, nkv, hd))


def _decode_block(cfg: LlamaConfig, x, layer, k_cache, v_cache, cos, sin,
                  positions, cache_len, start=None, abs_positions=None):
    """Single-step (or chunked prefill) block with KV cache.

    x: [b, s, d]; k_cache/v_cache: [b, max_len, nkv, hd], written in place
    at [cache_len, cache_len + s) (per row when cache_len is [b]).
    `positions` are rope positions (start-relative for left-padded rows),
    within the rope table (decode_step checks); `abs_positions` are cache-slot positions used
    for masking; `start` [b] hides the left-pad slots of each row.
    """
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    q = _proj(cfg, layer, "wq", h).reshape(b, s, nh, hd)
    kk = _proj(cfg, layer, "wk", h).reshape(b, s, nkv, hd)
    vv = _proj(cfg, layer, "wv", h).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin, positions)
    kk = apply_rope(kk, cos, sin, positions)
    _write_kv(k_cache, kk, cache_len)
    _write_kv(v_cache, vv, cache_len)
    # mask: key slot j visible iff start <= j <= query slot
    max_len = k_cache.shape[1]
    q_pos = positions if abs_positions is None else abs_positions  # [b, s]
    k_pos = torch.arange(max_len, device=x.device)[None, :]
    mask = k_pos[:, None, :] <= q_pos[..., None]          # [b, s, max_len]
    if start is not None:
        mask = mask & (k_pos[:, None, :] >= start[:, None, None])
    kr = _repeat_kv(k_cache, nh // nkv)
    vr = _repeat_kv(v_cache, nh // nkv)
    # f32 logits from the cache-typed operands (preferred_element_type)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kr.float()) * (hd ** -0.5)
    # -1e30, not -inf: a fully masked pad row stays finite
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(cfg.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, vr).reshape(b, s, nh * hd)
    x = x + _proj(cfg, layer, "wo", attn)
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    x = x + _proj(cfg, layer, "w_down",
                  F.silu(_proj(cfg, layer, "w_gate", h))
                  * _proj(cfg, layer, "w_up", h))
    return x, k_cache, v_cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: LlamaConfig) -> tuple[torch.Tensor, dict]:
    """Append `tokens` [b, s] to the cache, return logits for the last
    position [b, vocab] (f32) and the cache. s=1 for autoregressive decode;
    larger s = (chunked) prefill.

    The cache is **mutated**: its k/v are written in place and its
    ``length`` advanced by s; the same dict is returned. Clone it first to
    keep the old state.

    cache["length"] may be a scalar (whole batch in lock-step, the
    left-padded batched path) or shape [b] (per-row depths: the
    continuous-batching slot path, where each row is an independent request
    and writes at its own cache offset).

    A rope position past the table (``max_seq_len``) raises ValueError,
    before anything is written: the reference gathers NaN there, and on
    the card the gather is a device-side assert. The check reads the
    largest position back to the host (one small copy per call)."""
    _check_ported(cfg)
    if cfg.moe:
        raise ValueError(
            "decode_step has no MoE FFN: the reference's decode block takes "
            "the dense FFN keys only, so an MoE model does not decode")
    b, s = tokens.shape
    dev = tokens.device
    cache_len = torch.as_tensor(cache["length"], dtype=torch.int32,
                                device=dev)
    steps = torch.arange(s, device=dev)
    if cache_len.dim() == 0:
        abs_positions = (cache_len + steps)[None, :].expand(b, s)
    else:
        abs_positions = cache_len[:, None] + steps[None, :]
    start = cache.get("start")
    if start is None:
        positions = abs_positions
    else:
        # rope positions are relative to each row's first real token
        positions = (abs_positions - start[:, None]).clamp(min=0)
    last = int(positions.max())
    if last >= cfg.max_seq_len:
        raise ValueError(
            f"rope position {last} is past the table of max_seq_len="
            f"{cfg.max_seq_len}: a row of this cache decodes too deep")
    x = F.embedding(tokens, params["embed"]).to(cfg.dtype)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device=dev)
    layers = _stacked_layers(params)
    names = list(layers)
    per_layer = zip(*(layers[n].unbind(0) for n in names))
    for weights, kc, vc in zip(per_layer, cache["k"].unbind(0),
                               cache["v"].unbind(0)):
        x, _, _ = _decode_block(cfg, x, dict(zip(names, weights)), kc, vc,
                                cos, sin, positions, cache_len, start=start,
                                abs_positions=abs_positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ _head_matrix(params, cfg)).float()
    cache["length"] = cache_len + s
    return logits, cache
