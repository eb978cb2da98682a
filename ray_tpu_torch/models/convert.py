"""Carry parameters between the JAX package's tree and the port's dict.

The trees have the same keys, the same stacked ``[n_layers, ...]`` layouts
and the same ``[in, out]`` weight orientation, so conversion is a dtype and
device move. The JAX side is handed over as numpy arrays, for example
``jax.tree.map(np.asarray, params)``; this module never imports jax.
A ``"lora"`` adapter subtree (``models/lora.py``) and MoE layers convert and
are checked like the rest.

Over a mesh (``parallel/mesh.py``) ``local_params_from_numpy`` cuts this
rank's shard of every leaf by the rule table, and ``gather_params`` puts the
shards back together on every rank (a full checkpoint from a sharded run).

The RL trees (``rl/module.py``: MLP, CNN and continuous) convert through the
same two functions: lists of layers stay lists, and a conv layer (a dict
with a ``"meta"`` entry) has its weight moved between the JAX package's
HWIO and torch's OIHW and its stride carried as a plain int (the JAX
package's ``_ConvMeta`` static node; build one from the int to go back).
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
            if "meta" in node:               # an RL conv layer
                return {**{k: convert(v) for k, v in node.items()
                           if k not in ("w", "meta")},
                        "w": convert(np.asarray(node["w"]).transpose(
                            3, 2, 0, 1)),
                        "meta": int(getattr(node["meta"], "stride",
                                            node["meta"]))}
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":   # ml_dtypes bf16: torch cannot read it
            t = torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(arr)          # a copy that owns its data
        return t.to(device=dev, dtype=dtype)

    params = convert(tree)
    if cfg is not None:
        check_params(params, cfg)
    return params


def check_params(params: dict, cfg) -> None:
    """Raise ValueError unless ``params`` (tensors or arrays) has the keys
    and shapes of ``cfg``'s model, plus, where present, a ``"lora"`` subtree
    of known targets: A ``[L, in, r]`` and B ``[L, r, out]``, one rank."""
    from ray_tpu_torch.models.llama import param_shapes

    got = _shape_tree(params)
    lora = got.pop("lora", None)
    expected = param_shapes(cfg)
    if got != expected:
        raise ValueError(f"parameter tree does not match the config: "
                         f"got {got}, expected {expected}")
    if lora is not None:
        _check_lora(lora, cfg)


def _check_lora(lora: dict, cfg) -> None:
    from ray_tpu_torch.models.lora import (_FFN_TARGETS, _TARGET_AXES,
                                           _target_dims, lora_targets)

    layers = lora.get("layers") if set(lora) == {"layers"} else None
    if not isinstance(layers, dict) or not layers:
        raise ValueError(f"a lora subtree is {{'layers': {{<w>_a, <w>_b, "
                         f"...}}}}; got {lora}")
    targets = lora_targets(layers)
    want_keys = {t + s for t in targets for s in ("_a", "_b")}
    if set(layers) != want_keys:
        raise ValueError(f"lora keys {sorted(layers)} are not A/B pairs")
    unknown = [t for t in targets if t not in _TARGET_AXES]
    if unknown:
        raise ValueError(f"unknown LoRA targets {unknown}; "
                         f"have {sorted(_TARGET_AXES)}")
    if cfg.moe and any(t in _FFN_TARGETS for t in targets):
        raise ValueError("LoRA on MoE expert FFNs is not supported")
    ranks = {layers[t + "_a"][-1:] for t in targets}
    if len(ranks) != 1 or ranks == {()}:
        raise ValueError(f"lora adapters need one rank; got {layers}")
    (r,) = ranks.pop()
    L = cfg.n_layers
    for t in targets:
        d_in, d_out = _target_dims(cfg, t)
        got = (layers[t + "_a"], layers[t + "_b"])
        if got != ((L, d_in, r), (L, r, d_out)):
            raise ValueError(f"lora {t}: got A {got[0]}, B {got[1]}; "
                             f"expected {(L, d_in, r)}, {(L, r, d_out)}")


def params_to_numpy(params: dict) -> dict:
    """dict of torch tensors -> the same tree of numpy arrays on the host
    (bf16 leaves come back as float32, which numpy can hold). An RL conv
    layer's weight goes back to HWIO and its stride stays an int."""
    if isinstance(params, dict):
        out = {k: params_to_numpy(v) for k, v in params.items()}
        if "meta" in params:
            out["w"] = out["w"].transpose(2, 3, 1, 0).copy()
        return out
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    if not isinstance(params, torch.Tensor):
        return params
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def local_params_from_numpy(tree: dict, logical_axes: dict, mesh,
                            rules: dict | None = None,
                            device: str | torch.device | None = None,
                            dtype: torch.dtype | None = None) -> dict:
    """numpy parameter tree (the full one, the same on every rank) -> this
    rank's local shard of each leaf, by ``logical_axes`` and the rule table,
    as tensors on ``device`` (the card when None). Only the shard is copied
    to the device."""
    from ray_tpu_torch.parallel.mesh import shard_params

    dev = resolve_device(device)
    shardings = shard_params(tree, logical_axes, mesh, rules)

    def convert(node, sharding):
        if isinstance(node, dict):
            return {k: convert(v, sharding[k]) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        part = sharding.local(torch.from_numpy(arr))
        return part.to(device=dev, dtype=dtype, copy=True)

    return convert(tree, shardings)


def gather_params(local: dict, logical_axes: dict, mesh,
                  rules: dict | None = None) -> dict:
    """Every rank's local shards (as ``local_params_from_numpy`` or a
    sharded ``build_train_step`` holds them) -> the full tree, on every
    rank: each sharded dim all-gathered over its mesh axes, minor axis
    first."""
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel.mesh import shard_params, spec_axes

    shardings = shard_params(local, logical_axes, mesh, rules)

    def gather(node, sharding):
        if isinstance(node, dict):
            return {k: gather(v, sharding[k]) for k, v in node.items()}
        t = node.detach()
        for dim, entry in enumerate(sharding.spec):
            for axis in reversed(spec_axes(entry)):
                t = col._all_gather(t, dim, mesh.get_group(axis))
        return t

    return gather(local, shardings)
