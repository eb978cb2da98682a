"""Connector-v2 pipelines (ref analog: rllib/connectors/connector_v2.py:31
`ConnectorV2` + connector_pipeline_v2.py:19 `ConnectorPipelineV2`).

Connectors are the composable data-transform stages between environment
and module (env→module: what the runner feeds the policy) and between
episodes and learner (learner pipeline: what the update consumes). Each
connector is a picklable callable `(data, ctx) -> data`; a pipeline
chains them. Runners and learners take pipelines as config so
preprocessing (normalization, dtype casts, frame ops) is declared once
and runs identically at sampling and training time.
"""

from __future__ import annotations

import sys
from typing import Any

import numpy as np


class Connector:
    """One transform stage. `data` is a dict of arrays; `ctx` carries
    static info (module config, env spec)."""

    def __call__(self, data: Any, ctx: dict | None = None) -> Any:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class ConnectorPipeline(Connector):
    def __init__(self, connectors: list | None = None):
        self.connectors = list(connectors or [])

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def prepend(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, connector)
        return self

    def __call__(self, data, ctx=None):
        for c in self.connectors:
            data = c(data, ctx)
        return data

    def __repr__(self):
        return f"ConnectorPipeline({self.connectors})"


# ----------------------------------------------------- env->module stages
class CastF32(Connector):
    """Observations to float32 (uint8 pixel envs, float64 physics)."""

    def __call__(self, obs, ctx=None):
        return np.asarray(obs, np.float32)


class NormalizeImage(Connector):
    """Integer pixels ([0, 255] uint8 and friends) -> [0, 1] floats.
    Keyed off the DTYPE, not the frame content: a near-black uint8 frame
    must scale exactly like a bright one, or the policy sees the same
    intensity at two scales. Float inputs pass through unchanged."""

    def __init__(self, scale: float = 255.0):
        self.scale = scale

    def __call__(self, obs, ctx=None):
        obs = np.asarray(obs)
        is_int = np.issubdtype(obs.dtype, np.integer)
        obs = obs.astype(np.float32)
        if is_int:
            obs = obs / self.scale
        return obs


class FlattenObs(Connector):
    """[B, ...] -> [B, prod(...)] for MLP modules on structured obs."""

    def __call__(self, obs, ctx=None):
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)


# ------------------------------------------------------- learner stages
class BatchCastF32(Connector):
    """Learner-side: cast the float trajectory arrays of a batch dict
    (a tensor that a device edge delivered is cast where it lies)."""

    KEYS = ("obs", "rewards", "logp", "trunc_values", "last_obs")

    def __call__(self, batch: dict, ctx=None):
        torch = sys.modules.get("torch")
        for k in self.KEYS:
            if k not in batch:
                continue
            if torch is not None and isinstance(batch[k], torch.Tensor):
                batch[k] = batch[k].float()
            else:
                batch[k] = np.asarray(batch[k], np.float32)
        return batch


def default_env_to_module(module_cfg) -> ConnectorPipeline:
    """Image modules normalize pixels; vector modules just cast (ref:
    the default env-to-module pipeline assembled in connector_v2)."""
    from ray_tpu_torch.rl.module_config import CNNModuleConfig

    if isinstance(module_cfg, CNNModuleConfig):
        return ConnectorPipeline([NormalizeImage()])
    return ConnectorPipeline([CastF32()])


def default_learner_pipeline(module_cfg) -> ConnectorPipeline:
    return ConnectorPipeline([BatchCastF32()])
