"""Softmax cross entropy over large vocabularies (counterpart of
ray_tpu/ops/cross_entropy.py): f32 logsumexp + gather, an ignore index for
padded batches, and a fused LM-head variant that never holds the whole
[tokens, vocab] f32 logits tensor."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = -100
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """logits: [..., vocab] (any dtype, accumulated f32); labels: [...] int.
    Returns (mean_loss, num_valid_tokens)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0]
    nll = (lse - picked) * valid
    count = valid.sum()
    return nll.sum() / count.clamp(min=1), count


def _chunk_nll(xs: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
               ignore_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    logits = (xs @ head).float()                          # [chunk, vocab]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[:, None])[:, 0]
    return ((lse - picked) * valid).sum(), valid.sum()


def fused_lm_head_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                                labels: torch.Tensor,
                                ignore_index: int = -100,
                                chunk_size: int = 1024
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """LM-head projection + cross entropy without the full logits tensor.

    x: [b, s, d] final hidden states; head: [d, vocab]; labels: [b, s].
    The token axis is walked in chunks; each chunk runs under
    ``torch.utils.checkpoint``, so only its inputs are kept and the backward
    recomputes its logits: peak memory O(chunk_size * vocab) instead of
    O(b * s * vocab) f32.
    """
    b, s, d = x.shape
    n_tok = b * s
    chunk_size = min(chunk_size, n_tok)
    if n_tok % chunk_size != 0:
        # odd shapes are test-sized: the dense path is fine there
        return softmax_cross_entropy((x @ head).float(), labels, ignore_index)
    x2 = x.reshape(n_tok, d)
    labels2 = labels.reshape(n_tok)
    nll_sum = x.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for start in range(0, n_tok, chunk_size):
        nll, cnt = checkpoint(
            _chunk_nll, x2[start:start + chunk_size], head,
            labels2[start:start + chunk_size], ignore_index,
            use_reentrant=False)
        nll_sum = nll_sum + nll
        count = count + cnt
    return nll_sum / count.clamp(min=1), count
