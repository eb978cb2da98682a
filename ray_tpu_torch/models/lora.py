"""LoRA adapters for the Llama family (counterpart of
ray_tpu/models/lora.py).

* Adapters live in their own subtree ``{"layers": {"wq_a": [L, d, r],
  "wq_b": [L, r, out], ...}}``: per-layer A/B stacked on the leading layer
  axis like the base weights, so the block loop unbinds them with the base.
* The forward adds the low-rank path ``x @ A @ B * (alpha / r)`` beside the
  frozen matmul (``llama._proj``); the ``[d, out]`` delta is never formed.
* Training differentiates only the adapter subtree
  (``build_train_step(..., trainable_keys=("lora",))``): the frozen base gets
  no gradient and no optimizer moments.
* ``merge_lora`` folds adapters into new base weights for serving paths that
  know nothing of LoRA; it never writes the base in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ray_tpu_torch.device import resolve_device

# target name -> (A logical in-axis, B logical out-axis)
_TARGET_AXES = {
    "wq": ("embed", "heads"),
    "wk": ("embed", "kv_heads"),
    "wv": ("embed", "kv_heads"),
    "wo": ("heads", "embed"),
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
}

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")
_FFN_TARGETS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _target_dims(cfg, name: str) -> tuple[int, int]:
    """(in, out) of the base weight a target augments."""
    d, h = cfg.dim, cfg.hidden_dim
    dims = {
        "wq": (d, cfg.n_heads * cfg.head_dim),
        "wk": (d, cfg.n_kv_heads * cfg.head_dim),
        "wv": (d, cfg.n_kv_heads * cfg.head_dim),
        "wo": (cfg.n_heads * cfg.head_dim, d),
        "w_gate": (d, h),
        "w_up": (d, h),
        "w_down": (h, d),
    }
    return dims[name]


def init_lora_params(cfg, lora: LoraConfig, seed: int = 0,
                     device: str | torch.device | None = None) -> dict:
    """A ~ N(0, 1/r), B = 0, from a ``torch.Generator`` seeded with ``seed``:
    the adapter starts as an exact no-op, so step 0 equals the frozen base
    model. (The draws differ from ``jax.random``; carry the JAX package's
    adapters over with ``models.convert.params_from_numpy``.)"""
    if lora.alpha != cfg.lora_alpha:
        # the forward pass and merge_lora read cfg.lora_alpha; a LoraConfig
        # with a different alpha would silently train at the wrong scale
        raise ValueError(
            f"LoraConfig.alpha={lora.alpha} != LlamaConfig.lora_alpha="
            f"{cfg.lora_alpha}; set them consistently (e.g. "
            f"config_for(name, lora_alpha=...))")
    if cfg.moe and any(t in _FFN_TARGETS for t in lora.targets):
        raise ValueError("LoRA on MoE expert FFNs is not supported; "
                         "use attention targets")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, r = cfg.n_layers, lora.rank
    layers: dict = {}
    for name in lora.targets:
        if name not in _TARGET_AXES:
            raise ValueError(f"unknown LoRA target {name!r}; "
                             f"have {sorted(_TARGET_AXES)}")
        d_in, d_out = _target_dims(cfg, name)
        a = torch.randn((L, d_in, r), generator=gen, dtype=torch.float32,
                        device=dev)
        layers[name + "_a"] = (a * (1.0 / math.sqrt(r))).to(cfg.param_dtype)
        layers[name + "_b"] = torch.zeros((L, r, d_out),
                                          dtype=cfg.param_dtype, device=dev)
    return {"layers": layers}


def lora_logical_axes(cfg, lora: LoraConfig) -> dict:
    """Logical axes of the adapter subtree, as the reference names them: A
    shards its input dim like the base in-axis, B its output dim like the
    base out-axis (``parallel.mesh.shard_params`` places the adapters by
    them in a sharded step; one device ignores them)."""
    layers: dict = {}
    for name in lora.targets:
        in_ax, out_ax = _TARGET_AXES[name]
        layers[name + "_a"] = ("layers", in_ax, None)
        layers[name + "_b"] = ("layers", None, out_ax)
    return {"layers": layers}


def lora_targets(lora_layers: dict) -> tuple:
    """Target names of an adapter subtree, from its ``<w>_a`` keys."""
    return tuple(sorted(k[:-2] for k in lora_layers if k.endswith("_a")))


def merge_lora(params: dict, cfg) -> dict:
    """Fold adapters into the base weights. Returns a NEW params dict
    without "lora"; the base tensors it was given are not written.

    The scale comes from ``cfg.lora_alpha``, the same source the forward
    uses, and the fold is made in f32, then cast to the base weight's dtype.
    """
    if "lora" not in params:
        return params
    base_layers = dict(params["layers"])
    lora_layers = params["lora"]["layers"]
    for name in lora_targets(lora_layers):
        a = lora_layers[name + "_a"].float()
        b = lora_layers[name + "_b"].float()
        scale = cfg.lora_alpha / a.shape[-1]
        delta = torch.einsum("lir,lro->lio", a, b) * scale
        base_layers[name] = (base_layers[name].float()
                             + delta).to(base_layers[name].dtype)
    out = {k: v for k, v in params.items() if k != "lora"}
    out["layers"] = base_layers
    return out
