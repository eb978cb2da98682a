"""TorchLearner + the host-side PPO math (ref analogs:
rllib/core/learner/learner.py:109 `compute_losses/compute_gradients`,
learner_group.py:80, DDP wrapping in torch_learner.py:409).

The whole PPO update (minibatch epochs, clipped losses, optimizer) runs on
the learner's device, the card unless the learner was leased none;
multi-learner data parallelism averages gradients over the host tier of
``util.collective``. The optimizer reproduces the JAX package's
``optax.chain(clip_by_global_norm, adam)`` and its minibatch order, so an
update is comparable across the two packages."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

@dataclasses.dataclass
class PPOLearnerConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 256
    max_grad_norm: float = 0.5


def compute_gae(rewards, values, dones, last_value, gamma, lam,
                trunc_values=None):
    """[T, N] arrays -> (advantages, returns), numpy (host side).

    `trunc_values[t, i]` is V(final_obs) where env i was *truncated*
    (time-limit cut, not a true terminal) at step t, 0 elsewhere: the GAE
    recursion still cuts at those steps, but the bootstrap target is the
    critic's value of the final state instead of 0.
    """
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    gae = np.zeros(rewards.shape[1], rewards.dtype)
    next_value = last_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(rewards.dtype)
        boot = next_value * nonterminal
        if trunc_values is not None:
            boot = boot + trunc_values[t]
        delta = rewards[t] + gamma * boot - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    return adv, adv + values


def build_ppo_batch(samples: list, gamma: float, lam: float):
    """Fold sampled [T, N] trajectories into one flat PPO batch:
    GAE per trajectory, flatten, concat. Shared by the single-agent and
    multi-agent drivers (per-policy streams are the same shape).
    Returns (batch, episode_returns, env_steps)."""
    obs, acts, logps, advs, rets = [], [], [], [], []
    ep_returns: list[float] = []
    steps = 0
    for s in samples:
        adv, ret = compute_gae(
            s["rewards"], s["values"], s["dones"], s["last_value"],
            gamma, lam, s.get("trunc_values"))
        T, N = s["rewards"].shape
        steps += T * N
        obs.append(s["obs"].reshape((T * N,) + s["obs"].shape[2:]))
        acts.append(s["actions"].reshape(T * N))
        logps.append(s["logp"].reshape(T * N))
        advs.append(adv.reshape(T * N))
        rets.append(ret.reshape(T * N))
        ep_returns.extend(s["episode_returns"])
    batch = {
        "obs": np.concatenate(obs),
        "actions": np.concatenate(acts),
        "logp_old": np.concatenate(logps),
        "advantages": np.concatenate(advs).astype(np.float32),
        "returns": np.concatenate(rets).astype(np.float32),
    }
    return batch, ep_returns, steps


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))`` over the
    tensor leaves of a params tree: the gradients are scaled by
    ``max_norm / norm`` when their global norm is not below `max_norm`
    (optax's rule, without ``clip_grad_norm_``'s +1e-6), then an Adam
    step with optax's defaults (betas 0.9/0.999, eps 1e-8, no weight
    decay). `max_norm` None skips the clip (plain ``optax.adam``)."""

    def __init__(self, leaves: list, lr: float,
                 max_norm: float | None = None):
        self.leaves = list(leaves)
        self.max_norm = max_norm
        self.opt = torch.optim.Adam(self.leaves, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.0)

    def step(self, grads) -> None:
        grads = list(grads)
        if self.max_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = norm < self.max_norm
            grads = [torch.where(keep, g, g / norm * self.max_norm)
                     for g in grads]
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.step()
        for p in self.leaves:
            p.grad = None


def grads_of(loss, leaves: list) -> list:
    """d loss / d leaves, zeros for a leaf the loss does not read (as
    jax.grad gives; DQN's loss never reads the value head)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def trainable(params):
    """Mark a params tree's tensor leaves as requiring grad; -> leaves."""
    from ray_tpu_torch.rl.module import tensor_leaves

    leaves = tensor_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def load_into(params, tree) -> None:
    """Write a tree of arrays or tensors into `params`' leaves in place,
    matching dict entries by key (the optimizer stays bound to them)."""
    def walk(dst, src):
        if isinstance(dst, dict):
            if set(dst) != set(src):
                raise ValueError(f"weights keys {sorted(src)} are not the "
                                 f"learner's {sorted(dst)}")
            for k in dst:
                walk(dst[k], src[k])
        elif isinstance(dst, (list, tuple)):
            if len(dst) != len(src):
                raise ValueError(f"{len(src)} layers for {len(dst)}")
            for d, s in zip(dst, src):
                walk(d, s)
        elif isinstance(dst, torch.Tensor):
            if not isinstance(src, torch.Tensor):
                src = torch.tensor(np.asarray(src))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"a {tuple(src.shape)} weight for "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    with torch.no_grad():
        walk(params, tree)


def batch_to(batch: dict, device) -> dict:
    """A batch dict's arrays as tensors on `device`: a tensor (a device
    edge rebuilt it) is moved if it lies elsewhere, a numpy array copied
    (it may be a read-only view of an object-store buffer)."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else torch.tensor(np.asarray(v), device=device))
            for k, v in batch.items()}


def learner_device(num_gpus: float) -> str | None:
    """The device argument of a learner leased `num_gpus`: None (the
    card, raising without one) above 0, "cpu" at 0."""
    return None if num_gpus > 0 else "cpu"


def ppo_loss(params, batch: dict, cfg):
    """The clipped-surrogate PPO loss of one minibatch -> (loss, aux)."""
    from ray_tpu_torch.rl import module as rlm

    logits, value = rlm.forward(params, batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch["logp_old"])
    adv = batch["advantages"]
    pg = -torch.minimum(
        ratio * adv, ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv)
    vf = 0.5 * (value - batch["returns"]) ** 2
    entropy = -(torch.exp(logp_all) * logp_all).sum(dim=-1)
    loss = (pg.mean() + cfg.vf_coeff * vf.mean()
            - cfg.entropy_coeff * entropy.mean())
    return loss, {"loss": loss.detach(), "pg_loss": pg.mean().detach(),
                  "vf_loss": vf.mean().detach(),
                  "entropy": entropy.mean().detach()}


class TorchLearner:
    """One learner process: the minibatch PPO update on its device (the
    counterpart of the JAX package's ``JaxLearner``). `device` None means
    the card and raises without one; the algorithms pass "cpu" for a
    learner leased no GPU."""

    def __init__(self, module_cfg_blob: bytes, learner_cfg_blob: bytes,
                 seed: int = 0, group_name: Optional[str] = None,
                 world_size: int = 1, rank: int = 0, device=None):
        import cloudpickle

        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl import module as rlm

        self.cfg: PPOLearnerConfig = cloudpickle.loads(learner_cfg_blob)
        self.module_cfg = cloudpickle.loads(module_cfg_blob)
        self.device = resolve_device(device)
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        if group_name is not None and world_size > 1:
            from ray_tpu_torch.util import collective

            collective.init_collective_group(world_size, rank,
                                             group_name=group_name)
        self.params = rlm.init_params(self.module_cfg, seed, self.device)
        self._leaves = trainable(self.params)
        self._opt = ClippedAdam(self._leaves, self.cfg.lr,
                                self.cfg.max_grad_norm)

    # ---------------------------------------------------------------- update
    def update(self, batch: dict) -> dict:
        """batch: flat [B, ...] numpy arrays (obs, actions, logp_old,
        advantages, returns). Runs epochs x minibatches; the advantages
        are normalised with numpy's std (ddof 0) and the minibatches drawn
        from ``np.random.RandomState(0)``, as the JAX package does."""
        cfg = self.cfg
        B = batch["obs"].shape[0]
        adv = np.asarray(batch["advantages"])
        batch = dict(batch)
        batch["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        on_dev = batch_to(batch, self.device)
        rng = np.random.RandomState(0)
        mb = min(cfg.minibatch_size, B)
        n_mb = max(1, B // mb)
        aux_last: dict = {}
        for _ in range(cfg.num_epochs):
            perm = rng.permutation(B)[:n_mb * mb].reshape(n_mb, mb)
            for idx in torch.as_tensor(perm, device=self.device):
                mb_batch = {k: v[idx] for k, v in on_dev.items()}
                loss, aux = ppo_loss(self.params, mb_batch, cfg)
                grads = torch.autograd.grad(loss, self._leaves)
                self._opt.step(self._sync_grads(grads))
                aux_last = aux
        return {k: float(v) for k, v in aux_last.items()}

    def _sync_grads(self, grads):
        if self.group_name is None or self.world_size <= 1:
            return grads
        from ray_tpu_torch.util import collective

        summed = [collective.allreduce(g.detach().cpu().numpy(),
                                       group_name=self.group_name)
                  for g in grads]
        return [torch.as_tensor(g / self.world_size, device=self.device)
                for g in summed]

    def get_weights(self):
        from ray_tpu_torch.rl.module import to_host

        return to_host(self.params)

    def set_weights(self, params) -> bool:
        load_into(self.params, params)
        return True

    def save_state(self) -> dict:
        return {"params": self.get_weights()}

    def load_state(self, state: dict) -> bool:
        return self.set_weights(state["params"])

    def placement(self) -> dict:
        """Where this learner runs, for checks: its params' device and
        whether the process has a CUDA context."""
        return {"device": str(self._leaves[0].device),
                "cuda_initialized": bool(torch.cuda.is_initialized())}

    def ping(self) -> bool:
        return True
