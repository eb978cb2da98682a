"""V-trace off-policy correction (Espeholt et al. 2018, IMPALA).

Ref analog: rllib/algorithms/impala/* — the correction that lets a
learner train on trajectories sampled by stale behavior policies. Torch
on the learner's device: the JAX package's ``lax.scan(reverse=True)``
becomes a reverse loop over T.
"""

from __future__ import annotations

import torch


def vtrace(behavior_logp: torch.Tensor, target_logp: torch.Tensor,
           rewards: torch.Tensor, values: torch.Tensor,
           bootstrap_value: torch.Tensor, dones: torch.Tensor,
           trunc_values: torch.Tensor | None = None,
           gamma: float = 0.99, rho_clip: float = 1.0,
           c_clip: float = 1.0):
    """All [T, B] except bootstrap_value [B].

    `values` are the TARGET policy's value estimates for the visited
    states; `dones` cuts bootstrapping (with `trunc_values[t]` supplying
    V(final_obs) where the cut was a time-limit truncation, not a true
    terminal). Returns (vs [T, B], pg_advantages [T, B]), both detached
    (the inputs are read without their graphs)."""
    target_logp = target_logp.detach()
    values = values.detach()
    bootstrap_value = bootstrap_value.detach()
    rho = torch.exp(target_logp - behavior_logp)
    rho_bar = torch.clamp(rho, max=rho_clip)
    c_bar = torch.clamp(rho, max=c_clip)
    nonterminal = 1.0 - dones.to(values.dtype)

    # value of the successor state of step t (0 across true terminals,
    # V(final_obs) across truncations)
    v_next = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    v_next = v_next * nonterminal
    if trunc_values is not None:
        v_next = v_next + trunc_values
    deltas = rho_bar * (rewards + gamma * v_next - values)

    acc = torch.zeros_like(bootstrap_value)       # vs_{t+1} - v_{t+1}
    vs_minus_v = [None] * values.shape[0]
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * c_bar[t] * nonterminal[t] * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values

    # pg advantage: r_t + gamma * vs_{t+1} - V(x_t), with vs_{T} bootstrap
    vs_next = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    vs_next = vs_next * nonterminal
    if trunc_values is not None:
        vs_next = vs_next + trunc_values
    pg_adv = rho_bar * (rewards + gamma * vs_next - values)
    return vs.detach(), pg_adv.detach()
