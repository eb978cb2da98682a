"""The plain reference of the configurations' block layout, in float32.

A Llama-layout decoder as the published configs describe it (pre-norm
RMSNorm, rotary embeddings in the split-half convention, grouped-query
causal attention, SwiGLU, an untied or tied LM head), written from that
description in plain PyTorch. It imports nothing of the program and takes
only what the benchmark made: the seeded weights (``model.make_params``,
the same tensors the program was handed) and the tokens.

* ``answer_logits``: the served model's logits at the positions whose
  tokens the program served, computed layer by layer over a few requests.
* ``train_steps``: loss, gradients and AdamW steps of the train cells, each
  layer checkpointed and attention walked in blocks of queries, so that a
  step at the cell's own batch fits beside nothing else.

``quant="fp8"`` is the control: every matmul an fp8 GEMM as the card
runs one (operands in e4m3 with one scale a tensor, f32 accumulation; in
the backward the output gradient in e5m2). Attention, norms and the
softmax stay f32.

Matmuls run with TF32 off, so float32 means float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.model import Dims, draw_leaf, leaves, make_params

ATTN_BLOCK = 512          # query rows a block of the train attention
CE_CHUNK = 2048           # tokens a chunk of the train LM head + loss


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


# ------------------------------------------------------------- arithmetic
def _fp8(x: torch.Tensor, fmt) -> torch.Tensor:
    """x rounded to an fp8 format with one scale for the whole tensor (its
    amax maps to the format's largest value), back in f32."""
    top = torch.finfo(fmt).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(fmt).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w as an fp8 GEMM computes it: the operands in e4m3 with one
    scale a tensor, the product accumulated in f32; the backward's GEMMs
    take the output gradient in e5m2 beside the same e4m3 operands."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


def matmul(x: torch.Tensor, w: torch.Tensor, quant: str | None):
    """x [..., in] @ w [in, out] in f32, or as the control's fp8 GEMM."""
    x, w = x.float(), w.float()
    if quant == "fp8":
        return _Fp8Matmul.apply(x, w)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope_tables(d: Dims, n: int, device):
    inv = 1.0 / (d.rope_theta ** (torch.arange(0, d.head_dim, 2,
                                               dtype=torch.float64,
                                               device=device) / d.head_dim))
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., s, heads, hd]; the first half of each head rotates against
    the second (HF's rotate_half)."""
    c, s_ = cos[:, None, :], sin[:, None, :]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s_, x2 * c + x1 * s_], dim=-1)


def ffn(h, w_gate, w_up, w_down, quant):
    return matmul(F.silu(matmul(h, w_gate, quant)) * matmul(h, w_up, quant),
                  w_down, quant)


# ------------------------------------------------------ serving reference
def _attend_one(q, k, v, d: Dims):
    """Causal attention of one sequence: q [T, H, hd], k/v [T, KV, hd]."""
    T = q.shape[0]
    rep = d.heads // d.kv_heads
    out = torch.empty_like(q)
    keep = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    for g in range(d.kv_heads):
        qs = q[:, g * rep:(g + 1) * rep].transpose(0, 1)       # [rep, T, hd]
        s = (qs @ k[:, g].T) * d.head_dim ** -0.5               # [rep, T, T]
        s = s.masked_fill(~keep, float("-inf"))
        out[:, g * rep:(g + 1) * rep] = (s.softmax(-1) @ v[:, g]).transpose(
            0, 1)
    return out


@torch.no_grad()
def answer_logits(params: dict, d: Dims, seqs: list[list[int]],
                  first: list[int], quant: str | None = None
                  ) -> list[torch.Tensor]:
    """For each token sequence (a prompt and the tokens served after it),
    the f32 logits [n, vocab] at positions ``first[i]`` .. end: the
    distributions the served tokens were drawn from. Layer-major: each
    layer's weights are cast to f32 once for all sequences."""
    dev = params["embed"].device
    with full_f32():
        xs = [params["embed"][torch.tensor(s, device=dev)].float()
              for s in seqs]
        cos, sin = rope_tables(d, max(len(s) for s in seqs), dev)
        lay = params["layers"]
        for li in range(d.layers):
            w = {k: lay[k][li].float() for k in lay}
            for i, x in enumerate(xs):
                T = x.shape[0]
                h = rms_norm(x, w["attn_norm"], d.norm_eps)
                q = matmul(h, w["wq"], quant).view(T, d.heads, d.head_dim)
                k = matmul(h, w["wk"], quant).view(T, d.kv_heads, d.head_dim)
                v = matmul(h, w["wv"], quant).view(T, d.kv_heads, d.head_dim)
                q, k = rope(q, cos[:T], sin[:T]), rope(k, cos[:T], sin[:T])
                a = _attend_one(q, k, v, d).reshape(T, d.q_dim)
                x = x + matmul(a, w["wo"], quant)
                h = rms_norm(x, w["mlp_norm"], d.norm_eps)
                xs[i] = x + ffn(h, w["w_gate"], w["w_up"], w["w_down"], quant)
            del w
        head = (params["embed"].T if d.tied else params["lm_head"]).float()
        out = []
        for x, f in zip(xs, first):
            x = rms_norm(x[f:], params["final_norm"], d.norm_eps)
            out.append(matmul(x, head, quant))
        return out


# ------------------------------------------------------- training reference
class _BlockAttention(torch.autograd.Function):
    """Causal attention in f32, walked in blocks of query rows so that no
    [s, s] tensor of the whole sequence is held; the backward recomputes
    each block's probabilities from the saved log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        # q, k, v: [b, h, s, hd]
        s = q.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=q.dtype, device=q.device)
        for q0 in range(0, s, ATTN_BLOCK):
            q1 = min(s, q0 + ATTN_BLOCK)
            sc = (q[:, :, q0:q1] @ k[:, :, :q1].transpose(-1, -2)) * scale
            keep = (torch.arange(q0, q1, device=q.device)[:, None]
                    >= torch.arange(q1, device=q.device)[None, :])
            sc = sc.masked_fill(~keep, float("-inf"))
            m = torch.logsumexp(sc, dim=-1)
            lse[:, :, q0:q1] = m
            out[:, :, q0:q1] = torch.exp(sc - m[..., None]) @ v[:, :, :q1]
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale = ctx.scale
        s = q.shape[2]
        dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
        delta = (do * out).sum(-1)
        for q0 in range(0, s, ATTN_BLOCK):
            q1 = min(s, q0 + ATTN_BLOCK)
            kb, vb = k[:, :, :q1], v[:, :, :q1]
            sc = (q[:, :, q0:q1] @ kb.transpose(-1, -2)) * scale
            keep = (torch.arange(q0, q1, device=q.device)[:, None]
                    >= torch.arange(q1, device=q.device)[None, :])
            p = torch.exp(sc - lse[:, :, q0:q1, None]).masked_fill(~keep, 0.0)
            dob = do[:, :, q0:q1]
            dv[:, :, :q1] += p.transpose(-1, -2) @ dob
            ds = p * (dob @ vb.transpose(-1, -2) - delta[:, :, q0:q1, None])
            dq[:, :, q0:q1] = (ds @ kb) * scale
            dk[:, :, :q1] += (ds.transpose(-1, -2) @ q[:, :, q0:q1]) * scale
        return dq, dk, dv, None


def _train_block(x, cos, sin, d: Dims, quant, wq, wk, wv, wo, attn_norm,
                 mlp_norm, w_gate, w_up, w_down):
    b, s, _ = x.shape
    h = rms_norm(x, attn_norm, d.norm_eps)
    q = rope(matmul(h, wq, quant).view(b, s, d.heads, d.head_dim), cos, sin)
    k = rope(matmul(h, wk, quant).view(b, s, d.kv_heads, d.head_dim),
             cos, sin)
    v = matmul(h, wv, quant).view(b, s, d.kv_heads, d.head_dim)
    rep = d.heads // d.kv_heads
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    a = _BlockAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), d.head_dim ** -0.5)
    x = x + matmul(a.transpose(1, 2).reshape(b, s, d.q_dim), wo, quant)
    h = rms_norm(x, mlp_norm, d.norm_eps)
    return x + ffn(h, w_gate, w_up, w_down, quant)


def _ce_chunk(x, head, targets, final_norm, eps, quant):
    logits = matmul(rms_norm(x, final_norm, eps), head, quant)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, targets[:, None])[:, 0]).sum()


_LAYER_KEYS = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm", "w_gate",
               "w_up", "w_down")


def loss(params: dict, tokens, targets, d: Dims, quant=None):
    """Mean cross entropy of next-token targets: tokens, targets [b, s]."""
    b, s = tokens.shape
    x = params["embed"][tokens]
    cos, sin = rope_tables(d, s, tokens.device)
    for li in range(d.layers):
        x = checkpoint(_train_block, x, cos, sin, d, quant,
                       *(params["layers"][k][li] for k in _LAYER_KEYS),
                       use_reentrant=False)
    head = params["embed"].T if d.tied else params["lm_head"]
    x = x.reshape(b * s, d.dim)
    t = targets.reshape(b * s)
    total = x.new_zeros(())
    for c0 in range(0, b * s, CE_CHUNK):
        total = total + checkpoint(_ce_chunk, x[c0:c0 + CE_CHUNK], head,
                                   t[c0:c0 + CE_CHUNK], params["final_norm"],
                                   d.norm_eps, quant, use_reentrant=False)
    return total / (b * s)


class AdamW:
    """torch.optim.AdamW's update written out (decoupled weight decay,
    bias-corrected moments), over a flat {name: tensor} dict."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.wd = eps, weight_decay
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, p in params.items():
            g = grads[name]
            m = self.m.setdefault(name, torch.zeros_like(p))
            v = self.v.setdefault(name, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.mul_(1 - self.lr * self.wd)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)


def train_steps(d: Dims, seed: int, batches: list, opt_kwargs: dict,
                device, quant: str | None = None) -> dict:
    """The reference's run of ``len(batches)`` steps from the seed's
    initial weights (drawn again here, in f32): each step's loss, each
    leaf's gradient norm at step 1, and each leaf's change norm after the
    last step."""
    with full_f32():
        params = make_params(d, seed, torch.float32, device)
        flat = leaves(params)
        for p in flat.values():
            p.requires_grad_(True)
        opt = AdamW(**opt_kwargs)
        losses, grad_norms = [], {}
        for i, (tokens, targets) in enumerate(batches):
            for p in flat.values():
                p.grad = None
            value = loss(params, tokens, targets, d, quant)
            value.backward()
            losses.append(float(value.detach()))
            grads = {k: p.grad for k, p in flat.items()}
            if i == 0:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            opt.step(flat, grads)
            for p in flat.values():
                p.grad = None
        del opt
        change = {}
        with torch.no_grad():
            for k, p in flat.items():
                p0 = draw_leaf(d, k, seed, torch.float32, device)
                change[k] = float((p - p0).norm())
                del p0
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
