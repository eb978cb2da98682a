"""Train-step builder, single device (counterpart of
ray_tpu/parallel/spmd.py, with its positional order; the mesh and sharding
arguments wait for the multi-GPU slice).

Usage:
    step, state = build_train_step(loss_fn, adamw(3e-4), params)
    state, metrics = step(state, batch)

The step updates the parameters and the optimizer state in place (the
reference donates its state buffers to the same end), so a parameter keeps
its dtype across steps. The state owns a copy of the params and its
optimizer is bound to those leaves: a restore (the train runtime's
``train.recipes.lora_finetune_loop`` after a worker restart) writes saved
values into them in place and then loads the optimizer's ``state_dict``,
whose moments pair with the trainable leaves by position (their order is
the same on every build).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch.device import resolve_device


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """Factory of a ``torch.optim.AdamW`` with ``optax.adamw``'s defaults.
    torch's own default weight decay is 0.01 and optax's 1e-4, so it is
    passed explicitly. Returns ``make(params) -> optimizer``."""
    def make(params):
        return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps,
                                 weight_decay=weight_decay)
    return make


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _split_batch(batch: dict, n: int) -> list[dict]:
    parts = {k: v.chunk(n, dim=0) for k, v in batch.items()}
    if any(len(p) != n or p[0].shape[0] * n != v.shape[0]
           for p, v in zip(parts.values(), batch.values())):
        raise ValueError(f"batch does not split into {n} equal micro-batches")
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def build_train_step(loss_fn: Callable, optimizer: Callable, params: dict,
                     logical_axes: Any = None, mesh: Any = None,
                     rules: dict | None = None,
                     seq_sharded_batch: bool = False, grad_accum: int = 1,
                     trainable_keys: tuple | None = None, *,
                     device: str | torch.device | None = None):
    """Returns (step, state). The positional order is the reference's.

    loss_fn(params, batch) -> (loss, aux_dict). state = {params, opt_state,
    step}, plus ``frozen`` when ``trainable_keys`` names the top-level keys
    to train: the rest get no gradients and no optimizer moments.
    ``optimizer`` is a factory such as ``adamw(3e-4)``. With
    ``grad_accum > 1`` the batch is cut into that many micro-batches along
    dim 0 and their gradients averaged.

    On one device ``logical_axes`` and ``rules`` are accepted and have no
    effect; a ``mesh`` or ``seq_sharded_batch=True`` needs the multi-GPU
    slice (ROADMAP.md item 6) and raises. ``device=None`` means the CUDA
    card.
    """
    if mesh is not None or seq_sharded_batch:
        raise NotImplementedError(
            "build_train_step over a mesh or with a sequence-sharded batch "
            "needs the multi-GPU slice (ROADMAP.md item 6); this port runs "
            "one device")
    dev = resolve_device(device)
    params = _map(lambda t: t.detach().to(dev).clone(), params)
    frozen = {}
    if trainable_keys is not None:
        missing = [k for k in trainable_keys if k not in params]
        if missing:
            raise ValueError(f"trainable_keys {missing} not in params")
        frozen = {k: v for k, v in params.items() if k not in trainable_keys}
        params = {k: params[k] for k in trainable_keys}
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    state = {"params": params, "opt_state": optimizer(_leaves(params)),
             "step": 0}
    if frozen:
        state["frozen"] = frozen

    def step(state: dict, batch: dict):
        batch = {k: v.to(dev) for k, v in batch.items()}
        full = ({**state["frozen"], **state["params"]} if "frozen" in state
                else state["params"])
        opt = state["opt_state"]
        opt.zero_grad(set_to_none=True)
        aux_sum = None
        for mb in (_split_batch(batch, grad_accum) if grad_accum > 1
                   else [batch]):
            loss, aux = loss_fn(full, mb)
            (loss / grad_accum).backward()
            aux = {k: v.detach() for k, v in aux.items()}
            aux_sum = aux if aux_sum is None else {
                k: aux_sum[k] + aux[k] for k in aux}
        aux = {k: v / grad_accum if grad_accum > 1 else v
               for k, v in aux_sum.items()}
        opt.step()
        return {**state, "step": state["step"] + 1}, aux

    return step, state


def build_eval_step(loss_fn: Callable):
    """eval(params, batch) -> aux, without gradients."""
    def eval_one(params: dict, batch: dict):
        with torch.no_grad():
            _, aux = loss_fn(params, batch)
        return aux
    return eval_one
