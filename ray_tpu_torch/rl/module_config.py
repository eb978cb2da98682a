"""The RL modules' configurations (architecture and sizes), apart from
``rl/module.py`` so that a process that only names a configuration (a
driver, an aggregator) does not import torch; ``rl.module`` re-exports
them."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLPModuleConfig:
    observation_size: int
    num_actions: int
    hidden: tuple = (64, 64)


@dataclasses.dataclass(frozen=True)
class CNNModuleConfig:
    """Image policy: conv tower -> dense -> pi/vf heads. obs [B, H, W, C]
    float32 (connectors normalize uint8 pixels upstream)."""
    obs_shape: tuple          # (H, W, C)
    num_actions: int
    # (out_channels, kernel, stride) per conv layer
    conv: tuple = ((16, 4, 2), (32, 3, 1))
    hidden: int = 128


def make_module_config(observation, num_actions: int, **kw):
    """Pick the architecture from the observation spec: images (H, W, C)
    get the CNN, flat vectors the MLP."""
    if isinstance(observation, tuple) and len(observation) == 3:
        return CNNModuleConfig(obs_shape=tuple(observation),
                               num_actions=num_actions, **kw)
    return MLPModuleConfig(observation_size=int(observation),
                           num_actions=num_actions, **kw)


@dataclasses.dataclass(frozen=True)
class ContinuousModuleConfig:
    observation_size: int
    action_size: int
    action_high: float = 1.0
    hidden: tuple = (64, 64)
