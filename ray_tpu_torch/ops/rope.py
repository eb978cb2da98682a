"""Rotary position embeddings (counterpart of ray_tpu/ops/rope.py)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device: str | torch.device | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, shape [max_len, head_dim // 2], f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate pairs (split-half convention, llama-style).

    x: [..., seq, heads, head_dim]; cos/sin: [max_len, head_dim // 2] or
    already gathered [..., seq, head_dim // 2]. positions: [..., seq] int
    (defaults to arange, the pre-fill case).
    """
    seq = x.shape[-3]
    if positions is None and cos.dim() == 2:
        cos, sin = cos[:seq], sin[:seq]
    elif positions is not None:
        cos, sin = cos[positions], sin[positions]
    cos = cos[..., :, None, :]   # broadcast over heads
    sin = sin[..., :, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
