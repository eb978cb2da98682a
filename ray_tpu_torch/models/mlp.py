"""Small MLP, MNIST-sized (counterpart of ray_tpu/models/mlp.py): the model
of BASELINE.json config #2. Params are a list of ``{"w": [in, out],
"b": [out]}`` layers, as in the reference, so they convert with
``models.convert.params_from_numpy`` layer by layer."""

from __future__ import annotations

import dataclasses
import math

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.cross_entropy import softmax_cross_entropy


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: tuple = (512, 512)
    n_classes: int = 10
    dtype: torch.dtype = torch.float32


def mlp_init(cfg: MLPConfig, seed: int = 0,
             device: str | torch.device | None = None) -> list[dict]:
    """Weights ~ N(0, 1/fan_in) from a ``torch.Generator`` seeded with
    ``seed``, biases zero."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)
    return [
        {"w": (torch.randn((a, b), generator=gen, device=dev)
               / math.sqrt(a)).to(cfg.dtype),
         "b": torch.zeros((b,), dtype=cfg.dtype, device=dev)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def mlp_forward(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params: list[dict], batch: dict):
    """batch: {"x": [n, in_dim], "y": [n] int} -> (loss, {loss, accuracy})."""
    logits = mlp_forward(params, batch["x"])
    loss, _ = softmax_cross_entropy(logits, batch["y"])
    acc = (logits.argmax(-1) == batch["y"]).float().mean()
    return loss, {"loss": loss, "accuracy": acc}
