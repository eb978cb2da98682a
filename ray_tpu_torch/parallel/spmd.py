"""Train-step builder (counterpart of ray_tpu/parallel/spmd.py, with its
positional order): one device, or this rank's part of a sharded step over a
mesh.

Usage:
    step, state = build_train_step(loss_fn, adamw(3e-4), params)
    state, metrics = step(state, batch)

    mesh = MeshConfig(data=2, fsdp=2, tensor=2).build()      # every rank
    step, state = build_train_step(loss_fn, adamw(3e-4), params, axes, mesh)
    state, metrics = step(state, shard_batch(batch, mesh))

Each step names its parts as hot-path phases (``_internal/otel.phase``):
``train.step`` on the host, and under it ``train.forward``,
``train.backward`` and ``train.optimizer``, whose device spans tile the
step on the stream.

The step updates the parameters and the optimizer state in place (the
reference donates its state buffers to the same end), so a parameter keeps
its dtype across steps. The state owns a copy of the params and its
optimizer is bound to those leaves: a restore (the train runtime's
``train.recipes.lora_finetune_loop`` after a worker restart) writes saved
values into them in place and then loads the optimizer's ``state_dict``,
whose moments pair with the trainable leaves by position (their order is
the same on every build).

Over a mesh every rank runs the step on its own slice (SPMD). The rule
table (``parallel/mesh.py``) says which slice of each leaf a rank holds; the
state holds those local shards as plain tensors, and the optimizer steps
them. The model (``models/llama.py``) reads the step's ``Sharded`` context:
it all-gathers each layer's FSDP-sharded weights inside the layer's block
(so a checkpointed block gathers them again in its recompute: ZeRO-3 by
layer), keeps heads, the FFN's hidden dim and experts local, and sums
partial products with ``parallel/collectives``. The loss is the global
batch's: a rank's token-mean cross entropy is weighted by its share of the
global token count, the rest of the loss (MoE's aux) by 1 / the number of
batch shards, and after the backward each gradient is summed over the batch
axes (data, fsdp, seq) it was not already reduced over.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch._internal import otel
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import (AXIS_SEQ, BATCH_AXES, NamedSharding,
                                         Sharded, mesh_axis_size,
                                         shard_params, spec_axes, spec_for,
                                         use_sharding)


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


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


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

    With ``mesh=None`` the step runs on one device (``device=None`` means
    the CUDA card) and ``logical_axes`` and ``rules`` have no effect. With a
    mesh (``parallel.mesh.build_mesh``, on every rank) ``params`` is the full
    tree, the same on every rank, ``logical_axes`` its logical axis names,
    and the step runs this rank's part: batches come from ``shard_batch``
    (``seq_sharded_batch=True`` when they are cut along the sequence too,
    which a ``seq`` axis larger than 1 needs), and the metrics it returns
    are the global batch's.
    """
    if mesh is not None:
        return _build_mesh_step(loss_fn, optimizer, params, logical_axes,
                                mesh, rules, seq_sharded_batch, grad_accum,
                                trainable_keys, device)
    if seq_sharded_batch:
        raise ValueError("seq_sharded_batch=True needs a mesh with a seq "
                         "axis")
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
        with otel.phase("train.step"):
            batch = {k: v.to(dev) for k, v in batch.items()}
            full = ({**state["frozen"], **state["params"]}
                    if "frozen" in state else state["params"])
            opt = state["opt_state"]
            # launches nothing; here, a failed step's partial gradients
            # never reach the next one
            opt.zero_grad(set_to_none=True)
            aux_sum = None
            for mb in (_split_batch(batch, grad_accum) if grad_accum > 1
                       else [batch]):
                with otel.phase("train.forward", device=dev):
                    loss, aux = loss_fn(full, mb)
                with otel.phase("train.backward", device=dev):
                    (loss / grad_accum).backward()
                aux = {k: v.detach() for k, v in aux.items()}
                aux_sum = aux if aux_sum is None else {
                    k: aux_sum[k] + aux[k] for k in aux}
            aux = {k: v / grad_accum if grad_accum > 1 else v
                   for k, v in aux_sum.items()}
            with otel.phase("train.optimizer", device=dev):
                opt.step()
            return {**state, "step": state["step"] + 1}, aux

    return step, state


def _mesh_device(mesh, device):
    import torch.distributed as dist

    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"device {device} does not match the mesh's "
                         f"{mesh.device_type} ({dist.get_backend()} group)")
    return dev


def batch_sharding(mesh, seq_axis: bool = False) -> NamedSharding:
    """Batch dim sharded over data x fsdp; the seq dim over `seq` too when
    ``seq_axis``."""
    logical = ("batch", "seq") if seq_axis else ("batch",)
    return NamedSharding(mesh, spec_for(logical, None, mesh))


def shard_batch(batch: Any, mesh, seq_axis: bool = False) -> Any:
    """The global batch (numpy arrays or tensors, the same on every rank)
    -> this rank's slice, as tensors on the mesh's device: dim 0 cut over
    data x fsdp and, with ``seq_axis``, dim 1 over seq. Integer leaves
    become int64, torch's index type; 0-d leaves stay whole."""
    sharding = batch_sharding(mesh, seq_axis)
    dev = _mesh_device(mesh, None)

    def put(x):
        t = torch.as_tensor(x)
        if not (t.is_floating_point() or t.is_complex()):
            t = t.long()
        if t.dim() == 0:
            return t.to(dev)
        spec = sharding.spec if seq_axis and t.dim() >= 2 else \
            sharding.spec[:1]
        return NamedSharding(mesh, spec).local(t).to(dev).contiguous()

    return _map(put, batch)


def _grad_groups(sharded: Sharded, spec: tuple) -> tuple:
    """The batch axes a leaf's gradient still sums over after the backward:
    those it is not sharded (and so reduce-scattered) over."""
    held = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in BATCH_AXES
                 if sharded.size(a) > 1 and a not in held)


def _reduce_grads(sharded: Sharded, leaves: list, axes_of: list) -> None:
    """Sum each leaf's gradient over its batch axes, one flat all-reduce per
    (axis, dtype) bucket."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    for leaf in leaves:
        if leaf.grad is None:       # keep every rank's collectives aligned
            leaf.grad = torch.zeros_like(leaf)
    for axis in BATCH_AXES:
        by_dtype: dict = {}
        for leaf, axes in zip(leaves, axes_of):
            if axis in axes:
                by_dtype.setdefault(leaf.grad.dtype, []).append(leaf.grad)
        for grads in by_dtype.values():
            flat = _flatten_dense_tensors(grads)
            col.all_reduce_(flat, sharded.group(axis))
            for g, new in zip(grads, _unflatten_dense_tensors(flat, grads)):
                g.copy_(new)


def _global_loss(sharded: Sharded, loss: torch.Tensor, aux: dict):
    """(this rank's share of the global loss to differentiate, the aux dict
    of the global batch). aux["loss"] is a token mean over aux["tokens"]
    tokens when both are there (llama.loss_fn): weighted by this rank's share
    of the global token count; the rest of the loss, and a loss_fn without
    token counts, by 1 / the number of batch shards."""
    groups = sharded.batch_groups()
    ranks = sharded.batch_ranks()

    def summed(t):
        for g in groups:
            col.all_reduce_(t, g)
        return t

    out = {}
    if "tokens" in aux and "loss" in aux:
        n = aux["tokens"].detach()
        total = summed(n.clone())
        share = n.double() / total.clamp(min=1).double()
        ce = aux["loss"]
        weighted = ce * share.to(ce.dtype) + (loss - ce) / ranks
        out["tokens"] = total
        rest = [k for k in aux if k not in ("loss", "tokens")]
        vals = torch.stack([(ce.detach().double() * share)]
                           + [aux[k].detach().double() / ranks for k in rest])
        vals = summed(vals)
        out["loss"] = vals[0].to(ce.dtype)
        out.update({k: vals[i + 1].to(aux[k].dtype)
                    for i, k in enumerate(rest)})
    else:
        weighted = loss / ranks
        keys = list(aux)
        if keys:
            vals = summed(torch.stack([aux[k].detach().double() / ranks
                                       for k in keys]))
            out = {k: vals[i].to(aux[k].dtype) for i, k in enumerate(keys)}
    return weighted, out


def _build_mesh_step(loss_fn, optimizer, params, logical_axes, mesh, rules,
                     seq_sharded_batch, grad_accum, trainable_keys, device):
    if logical_axes is None:
        raise ValueError("a step over a mesh needs the params' logical_axes")
    if mesh_axis_size(mesh, AXIS_SEQ) > 1 and not seq_sharded_batch:
        raise ValueError(
            "the mesh has a seq axis larger than 1: pass seq_sharded_batch="
            "True and batches from shard_batch(..., seq_axis=True)")
    dev = _mesh_device(mesh, device)
    shardings = shard_params(params, logical_axes, mesh, rules)
    specs = _map(lambda s: s.spec, shardings)   # tuples are leaves here
    sharded = Sharded(mesh, logical_axes, specs)
    params = _map2(lambda t, s: s.local(t).detach().to(dev).clone(),
                   params, shardings)
    frozen = {}
    trainable_specs = specs
    if trainable_keys is not None:
        missing = [k for k in trainable_keys if k not in params]
        if missing:
            raise ValueError(f"trainable_keys {missing} not in params")
        frozen = {k: v for k, v in params.items() if k not in trainable_keys}
        params = {k: params[k] for k in trainable_keys}
        trainable_specs = {k: specs[k] for k in trainable_keys}
    leaves = _leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    axes_of = [_grad_groups(sharded, spec)
               for spec in _spec_leaves(params, trainable_specs)]
    state = {"params": params, "opt_state": optimizer(leaves), "step": 0}
    if frozen:
        state["frozen"] = frozen

    def step(state: dict, batch: dict):
        with otel.phase("train.step"):
            batch = {k: v.to(dev) for k, v in batch.items()}
            full = ({**state["frozen"], **state["params"]}
                    if "frozen" in state else state["params"])
            opt = state["opt_state"]
            opt.zero_grad(set_to_none=True)
            aux_sum = None
            with use_sharding(sharded):
                for mb in (_split_batch(batch, grad_accum) if grad_accum > 1
                           else [batch]):
                    with otel.phase("train.forward", device=dev):
                        loss, aux = loss_fn(full, mb)
                        weighted, aux = _global_loss(sharded, loss, aux)
                    with otel.phase("train.backward", device=dev):
                        (weighted / grad_accum).backward()
                    aux_sum = aux if aux_sum is None else {
                        k: aux_sum[k] + aux[k] for k in aux}
            # the gradients' sums over the batch axes close the backward
            with otel.phase("train.backward", device=dev):
                _reduce_grads(sharded, _leaves(state["params"]), axes_of)
            aux = {k: v / grad_accum if grad_accum > 1 else v
                   for k, v in aux_sum.items()}
            with otel.phase("train.optimizer", device=dev):
                opt.step()
            return {**state, "step": state["step"] + 1}, aux

    return step, state


def _spec_leaves(tree, specs) -> list:
    """The spec of each leaf of ``tree``, in ``_leaves`` order."""
    if isinstance(tree, dict):
        return [spec for k, v in tree.items()
                for spec in _spec_leaves(v, specs[k])]
    if isinstance(tree, (list, tuple)):
        return [spec for v, o in zip(tree, specs)
                for spec in _spec_leaves(v, o)]
    return [specs]


def build_eval_step(loss_fn: Callable):
    """eval(params, batch) -> aux, without gradients."""
    def eval_one(params: dict, batch: dict):
        with torch.no_grad():
            _, aux = loss_fn(params, batch)
        return aux
    return eval_one
