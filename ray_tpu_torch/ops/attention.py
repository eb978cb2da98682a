"""Attention: the dense reference path and the dispatcher that picks the
flash kernel (counterpart of ray_tpu/ops/attention.py).

* ``dot_product_attention(..., impl="xla")``: dense torch einsum path,
  numerically exact, runs anywhere. The name is kept from the reference so
  ``LlamaConfig.attn_impl`` values carry over unchanged.
* ``impl="flash"``: the hand-written CUDA kernels
  (``ops/cuda/flash_attention.py``), blockwise online softmax, O(seq) memory.

``impl="auto"`` picks flash for CUDA tensors at s >= 1024 without
``segment_ids``, dense otherwise. GQA (n_kv_heads < n_heads) works on both.
Causal alignment when sq != sk: the dense path is bottom-right aligned (query
i sees keys up to i + sk - sq), the flash kernel top-left aligned, as in the
reference.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, s, hk, d] -> [b, s, hk * n_rep, d], query head i on kv head
    i // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  segment_ids: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q: [b, sq, h, d]; k/v: [b, sk, hk, d] with h % hk == 0."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    k = _repeat_kv(k, h // hk)
    v = _repeat_kv(v, h // hk)
    if scale is None:
        scale = d ** -0.5
    # f32 logits from the input-typed operands, as preferred_element_type
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sk = k.shape[1]
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        k_pos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(q_pos >= k_pos), NEG_INF)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = logits.masked_fill(~same[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          segment_ids: torch.Tensor | None = None,
                          scale: float | None = None, impl: str = "auto",
                          block_q: int = 512,
                          block_k: int = 512) -> torch.Tensor:
    if impl == "auto":
        impl = ("flash" if q.is_cuda and q.shape[1] >= 1024
                and segment_ids is None else "xla")
    if impl == "flash":
        if segment_ids is not None:
            raise ValueError("the flash kernel takes no segment_ids; "
                             "use impl='xla' for packed sequences")
        from ray_tpu_torch.ops.cuda.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_q, block_k=block_k)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return xla_attention(q, k, v, causal=causal, segment_ids=segment_ids,
                         scale=scale)
