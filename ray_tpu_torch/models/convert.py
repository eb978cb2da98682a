"""Carry parameters between the JAX package's tree and the port's dict.

The trees have the same keys, the same stacked ``[n_layers, ...]`` layouts
and the same ``[in, out]`` weight orientation, so conversion is a dtype and
device move. The JAX side is handed over as numpy arrays, for example
``jax.tree.map(np.asarray, params)``; this module never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def params_from_numpy(tree: dict, device: str | torch.device | None = None,
                      dtype: torch.dtype | None = None,
                      cfg=None) -> dict:
    """numpy (or array-like) parameter tree -> the same tree of torch
    tensors on ``device`` (the card when None), cast to ``dtype`` when
    given. With a ``LlamaConfig``, checks that the tree has the keys and
    shapes that config's model expects."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":   # ml_dtypes bf16: torch cannot read it
            t = torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(arr)          # a copy that owns its data
        return t.to(device=dev, dtype=dtype)

    params = convert(tree)
    if cfg is not None:
        from ray_tpu_torch.models.llama import param_shapes

        got, expected = _shape_tree(params), param_shapes(cfg)
        if got != expected:
            raise ValueError(f"parameter tree does not match the config: "
                             f"got {got}, expected {expected}")
    return params


def params_to_numpy(params: dict) -> dict:
    """dict of torch tensors -> the same tree of numpy arrays on the host
    (bf16 leaves come back as float32, which numpy can hold)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
