"""Mixture-of-Experts FFN on one device (counterpart of ray_tpu/ops/moe.py):
top-k router, capacity-bounded dispatch and a grouped SwiGLU expert FFN, in
the GShard/Switch einsum formulation.

* Routing makes a dispatch one-hot ``[g, s, E, C]`` and combine weights of
  the same shape, per batch row ("group"), so C ~ s/E stays bounded.
* Expert inputs form by one einsum, the expert FFN is a grouped matmul over
  a leading expert dim, and the outputs combine by another einsum: the
  reference's einsums and bf16 casts, one to one. They are plain torch
  (cuBLAS ``bmm``), as they are plain XLA in the reference.
* Top-k takes ties to the lower expert index, as ``jax.lax.top_k`` does
  (a stable descending sort), so a router with tied logits routes the same
  tokens to the same experts in both packages.

Expert sharding (``ep``, the ``expert`` group of a sharded step): each rank
holds E/n experts' ``w_gate``, ``w_up`` and ``w_down`` and the router stays
replicated. The rule table shards the batch over data x fsdp, not over
``expert``, so every expert rank sees the same tokens: each routes them all
(the replicated router and aux loss), runs its local experts on its slice of
the dispatch tensor, and the partial combines are summed over the group,
which is what GSPMD makes of the reference's einsums under those rules. With
a ``tensor`` group (``tp``) the experts' hidden dim is split as the dense
FFN's is.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel import collectives as col


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # aux load-balancing loss weight (Switch Transformer eq. 4)
    aux_loss_weight: float = 0.01


def init_moe_params(dim: int, hidden_dim: int, cfg: MoEConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32,
                    device: str | torch.device | None = None) -> dict:
    """Router + per-expert SwiGLU weights (stacked on a leading expert axis),
    ~ N(0, 1/fan_in) from a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    e, d, h = cfg.num_experts, dim, hidden_dim

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w / math.sqrt(fan_in)).to(dtype)

    return {
        "router": dense((d, e), d),
        "w_gate": dense((e, d, h), d),
        "w_up": dense((e, d, h), d),
        "w_down": dense((e, h, d), h),
    }


def moe_logical_axes() -> dict:
    return {
        "router": ("embed", "expert_logits"),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(router_logits: torch.Tensor, cfg: MoEConfig, capacity: int):
    """router_logits [..., T, E] -> (dispatch [..., T, E, C] 0/1 f32,
    combine [..., T, E, C] f32, aux_loss [...]).

    Top-k routing with per-expert capacity: the c-th token routed to an
    expert takes slot c; tokens beyond capacity are dropped (their combine
    weight is 0 and the residual path carries them). Leading dims are
    independent groups (the reference vmaps over them)."""
    T, E = router_logits.shape[-2:]
    probs = torch.softmax(router_logits.float(), dim=-1)

    top_probs, top_idx = _top_k(probs, cfg.top_k)             # [..., T, k]
    # renormalise the chosen gates so they sum to 1 (Mixtral convention)
    top_probs = top_probs / top_probs.sum(-1, keepdim=True).clamp(min=1e-9)

    # aux load-balancing loss: mean prob per expert x fraction routed
    onehot_topk = F.one_hot(top_idx, E).float()                # [..., T, k, E]
    routed_frac = onehot_topk.sum(dim=(-3, -2)) / (T * cfg.top_k)
    mean_prob = probs.mean(dim=-2)
    aux_loss = E * (routed_frac * mean_prob).sum(-1)

    # position of each (token, choice) within its expert's queue: earlier
    # tokens' assignments (all k slots) + this token's earlier-k ones
    per_token = onehot_topk.sum(dim=-2)                         # [..., T, E]
    earlier = torch.cumsum(per_token, dim=-2) - per_token
    dispatch = combine = None
    for k in range(cfg.top_k):
        onehot = onehot_topk[..., k, :]                         # [..., T, E]
        prior = onehot_topk[..., :k, :].sum(dim=-2)
        pos = ((earlier + prior) * onehot).sum(-1)              # [..., T]
        keep = pos < capacity
        slot = torch.where(keep, pos.long(), capacity)
        slot_oh = F.one_hot(slot, capacity + 1).float()[..., :capacity]
        d_k = onehot[..., :, None] * slot_oh[..., None, :]      # [..., T, E, C]
        c_k = d_k * top_probs[..., k, None, None]
        dispatch = d_k if dispatch is None else dispatch + d_k
        combine = c_k if combine is None else combine + c_k
    return dispatch, combine, aux_loss


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig,
            activation=F.silu, ep=None,
            tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [b, s, d] -> (out [b, s, d], weighted aux_loss scalar).

    Static-shape capacity dispatch, routed per batch row, so the one-hot
    dispatch tensor is [b, s, E, C] with C ~ s/E.

    With an ``ep`` group the expert weights are this rank's
    ``[E / n, ...]`` slice; with a ``tp`` group their hidden dim is this
    rank's slice too. x is replicated over both groups."""
    b, s, d = x.shape
    E = cfg.num_experts
    capacity = max(1, int(cfg.capacity_factor * cfg.top_k * s / E))
    # einsum("gsd,de->gse") as a matmul: torch's einsum lowers it to a bmm,
    # and remat "dots" saves only mm outputs, as the reference's policy saves
    # this dot (it has no batch dims)
    router_logits = x.float() @ params["router"].float()
    dispatch, combine, aux_loss = _route(router_logits, cfg, capacity)
    aux_loss = aux_loss.mean()
    # this rank's experts: the routing is replicated, so the combine
    # weights' gradient comes back whole (split's backward gathers it);
    # the expert path's share of x's gradient is summed over both groups
    dispatch = col.split(dispatch, -2, ep)
    combine = col.split(combine, -2, ep)
    xe = col.psum_grad(col.psum_grad(x, ep), tp)

    dt = x.dtype
    # dispatch: [g, s, E, C] x [g, s, d] -> expert inputs [E, g, C, d]
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), xe)
    # grouped SwiGLU FFN over the leading expert dim
    gate = activation(torch.einsum("egcd,edh->egch", expert_in,
                                   params["w_gate"].to(dt)))
    up = torch.einsum("egcd,edh->egch", expert_in, params["w_up"].to(dt))
    expert_out = torch.einsum("egch,ehd->egcd", gate * up,
                              params["w_down"].to(dt))
    # combine: [g, s, E, C] x [E, g, C, d] -> [g, s, d]
    out = torch.einsum("gsec,egcd->gsd", combine.to(dt), expert_out)
    return col.psum(col.psum(out, tp), ep), aux_loss * cfg.aux_loss_weight
