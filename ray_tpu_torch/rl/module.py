"""RLModule — the policy/value network (ref analog:
rllib/core/rl_module/rl_module.py `RLModule`), as plain trees of torch
tensors with functional `forward`s, the same trees and math as the JAX
package's `ray_tpu.rl.module`.

Two architectures share one functional interface (`init_params` /
`forward` / `sample_actions`): an MLP for vector observations and an
IMPALA-style shallow CNN for image observations (Espeholt et al. 2018's
small tower). `forward` dispatches on the params structure, so env
runners and learners are architecture-agnostic.

Tree layouts: dense weights are ``[in, out]`` as in the JAX package; conv
weights are OIHW (torch's ``conv2d``; the JAX package keeps HWIO) and a
conv layer's ``"meta"`` is its stride as a plain int.
``models.convert.params_from_numpy`` / ``params_to_numpy`` carry a tree
across packages; `to_host` / `to_device` move one within the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl.module_config import (CNNModuleConfig,  # noqa: F401
                                            ContinuousModuleConfig,
                                            MLPModuleConfig,
                                            make_module_config)


def _generator(generator_or_seed) -> torch.Generator:
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    return torch.Generator().manual_seed(int(generator_or_seed))


def _normal(gen: torch.Generator, shape: tuple, scale: float):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def _head_params(h: int, num_actions: int, gen) -> dict:
    return {
        "pi": {"w": _normal(gen, (h, num_actions), 0.01),
               "b": torch.zeros(num_actions)},
        "vf": {"w": _normal(gen, (h, 1), 1.0 / math.sqrt(h)),
               "b": torch.zeros(1)},
    }


def _mlp_params(dims: tuple, gen) -> list:
    return [{"w": _normal(gen, (a, b), math.sqrt(2.0 / a)),
             "b": torch.zeros(b)}
            for a, b in zip(dims[:-1], dims[1:])]


def init_params(cfg, generator_or_seed, device=None) -> dict:
    """Shared torso + policy and value heads (MLP or CNN by config), with
    the JAX package's init scales, drawn from `generator_or_seed` (a CPU
    ``torch.Generator`` or a seed) and placed on `device` (the card when
    None)."""
    gen = _generator(generator_or_seed)
    if isinstance(cfg, CNNModuleConfig):
        params = _init_cnn(cfg, gen)
    else:
        dims = (cfg.observation_size,) + tuple(cfg.hidden)
        params = {"torso": _mlp_params(dims, gen),
                  **_head_params(dims[-1], cfg.num_actions, gen)}
    return to_device(params, resolve_device(device))


def _init_cnn(cfg: CNNModuleConfig, gen) -> dict:
    H, W, C = cfg.obs_shape
    conv = []
    in_ch = C
    h, w = H, W
    for out_ch, k, s in cfg.conv:
        fan_in = k * k * in_ch
        conv.append({"w": _normal(gen, (out_ch, in_ch, k, k),
                                  math.sqrt(2.0 / fan_in)),
                     "b": torch.zeros(out_ch), "meta": int(s)})
        h = -(-h // s)   # SAME padding output size
        w = -(-w // s)
        in_ch = out_ch
    flat = h * w * in_ch
    dense = {"w": _normal(gen, (flat, cfg.hidden), math.sqrt(2.0 / flat)),
             "b": torch.zeros(cfg.hidden)}
    return {"conv": conv, "dense": dense,
            **_head_params(cfg.hidden, cfg.num_actions, gen)}


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's padding="SAME" on an NCHW tensor: out = ceil(in / s), the
    total padding split with ``total // 2`` low and the rest high (uneven
    at stride 2 on an even remainder; torch's padding="same" refuses
    stride > 1)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # W first, for F.pad
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def _cnn_torso(params: dict, obs: torch.Tensor) -> torch.Tensor:
    x = obs.float().permute(0, 3, 1, 2)             # NHWC -> NCHW
    for layer in params["conv"]:
        w = layer["w"]
        x = F.relu(F.conv2d(_same_pad(x, w.shape[-1], layer["meta"]), w,
                            layer["b"], stride=layer["meta"]))
    # flatten in NHWC order, so the [flat, hidden] dense weight lines up
    # with the JAX package's
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return F.relu(x @ params["dense"]["w"] + params["dense"]["b"])


def forward(params: dict, obs: torch.Tensor):
    """-> (action logits [B, A], value [B]). Dispatches on the params
    structure so callers stay architecture-agnostic."""
    if "conv" in params:
        x = _cnn_torso(params, obs)
    else:
        x = obs
        for layer in params["torso"]:
            x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[:, 0]
    return logits, value


# --- continuous control (SAC path; ref analog: the actor/critic nets in
# rllib/algorithms/sac/torch/default_sac_torch_rl_module.py — squashed
# Gaussian actor + twin Q critics) ---

LOG_STD_MIN, LOG_STD_MAX = -5.0, 2.0


def _mlp_forward(layers: list, x: torch.Tensor) -> torch.Tensor:
    for layer in layers[:-1]:
        x = F.relu(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def init_continuous_params(cfg: ContinuousModuleConfig, generator_or_seed,
                           device=None) -> dict:
    """-> {"actor", "q1", "q2"}: actor maps obs -> [mean, log_std] (2*A
    outputs); each critic maps concat(obs, action) -> scalar Q."""
    gen = _generator(generator_or_seed)
    A = cfg.action_size
    actor_dims = (cfg.observation_size,) + tuple(cfg.hidden) + (2 * A,)
    q_dims = (cfg.observation_size + A,) + tuple(cfg.hidden) + (1,)
    params = {"actor": _mlp_params(actor_dims, gen),
              "q1": _mlp_params(q_dims, gen),
              "q2": _mlp_params(q_dims, gen)}
    return to_device(params, resolve_device(device))


def actor_forward(actor_params: list, obs: torch.Tensor):
    """-> (mean [B, A], log_std [B, A]) of the pre-squash Gaussian."""
    mean, log_std = _mlp_forward(actor_params, obs).chunk(2, dim=-1)
    return mean, log_std.clamp(LOG_STD_MIN, LOG_STD_MAX)


def q_forward(q_params: list, obs: torch.Tensor,
              action: torch.Tensor) -> torch.Tensor:
    """-> Q values [B]."""
    return _mlp_forward(q_params, torch.cat([obs, action], dim=-1))[:, 0]


def sample_squashed(mean: torch.Tensor, log_std: torch.Tensor,
                    generator: torch.Generator | None = None,
                    action_high: float = 1.0, noise=None):
    """Reparameterized tanh-Gaussian sample -> (action [B, A], logp [B]).

    The standard normal draw comes from `generator` (drawn on its device,
    then moved to `mean`'s), or is given as `noise` (a test injects the
    JAX package's draw). logp includes the tanh change-of-variables
    correction (log det = sum 2*(log2 - u - softplus(-2u)), the
    numerically stable form), and the action-scale log|action_high|
    term."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=generator.device)
    if not isinstance(noise, torch.Tensor):
        noise = torch.from_numpy(np.array(noise, np.float32))
    noise = noise.to(mean.device, mean.dtype)
    std = torch.exp(log_std)
    u = mean + std * noise
    logp = -0.5 * (((u - mean) / std) ** 2
                   + 2.0 * log_std + math.log(2.0 * math.pi))
    logp = logp.sum(dim=-1)
    logp = logp - (2.0 * (math.log(2.0) - u
                          - F.softplus(-2.0 * u))).sum(dim=-1)
    if action_high != 1.0:
        logp = logp - mean.shape[-1] * math.log(action_high)
    return torch.tanh(u) * action_high, logp


def params_device(params) -> torch.device:
    """The device of a tree's first tensor leaf."""
    return next(t for t in tensor_leaves(params)).device


@torch.no_grad()
def sample_actions(params: dict, obs: np.ndarray,
                   generator: torch.Generator):
    """Sampling helper for env runners: numpy obs in, numpy (action int32,
    logp, value) out; the categorical draw comes from `generator` (on the
    CPU, where runners sample)."""
    dev = params_device(params)
    logits, value = forward(params, torch.as_tensor(obs, device=dev))
    logp_all = torch.log_softmax(logits, dim=-1)
    action = torch.multinomial(logp_all.exp().cpu(), 1,
                               generator=generator)[:, 0]
    logp = logp_all.gather(1, action.to(dev)[:, None])[:, 0]
    return (action.numpy().astype(np.int32), logp.cpu().numpy(),
            value.cpu().numpy())


# --- tree helpers ---

def tensor_leaves(tree) -> list:
    """The tensor leaves of a params tree, in order (a conv layer's int
    stride is not one: optimizers and norms never see it)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_map(fn, tree):
    """`fn` over the tensor and array leaves of a tree; other leaves (a
    conv stride) pass through."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def to_host(params):
    """A tree of tensors -> the same tree of host numpy arrays (the
    port's layout; what learners hand to runners and checkpoints)."""
    return tree_map(lambda t: (t.detach().cpu().numpy().copy()
                               if isinstance(t, torch.Tensor)
                               else np.array(t)), params)


def to_device(tree, device) -> dict:
    """A tree of numpy arrays or tensors -> a tree of tensors on `device`
    that own their storage (never aliasing a channel slot or the source
    tree)."""
    def move(t):
        if isinstance(t, np.ndarray):
            return torch.tensor(t, device=device)
        return t.detach().to(device, copy=True)
    return tree_map(move, tree)


def clone_tree(params):
    """A detached copy of every tensor leaf (a target network)."""
    return tree_map(lambda t: t.detach().clone(), params)
