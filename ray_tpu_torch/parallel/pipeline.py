"""Pipeline parallelism: a GPipe schedule over a ``stage`` mesh axis
(counterpart of ray_tpu/parallel/pipeline.py).

One process a stage (SPMD), each holding only its own stage's params.
Every rank runs the same tick loop: T = n_micro + S - 1 ticks; at tick t
stage s works on microbatch m = t - s when 0 <= m < n_micro, stage 0 taking
a fresh microbatch and the others the activation that arrived from the stage
before; a ``ppermute`` moves each stage's output one stage on, and a final
``psum`` over the stages hands every rank the last stage's outputs. Both are
differentiable collectives (``parallel/collectives.py``) with JAX's
transposes, so autograd gives the backward pipeline as ``jax.grad`` does for
the reference: the inverse ppermutes run in reverse tick order on every
rank. As in the reference, every rank computes its stage at every tick and
selects by masks (``torch.where`` on tensors, which keeps every tick's
ppermute in every rank's graph, so the backward's collectives pair up).
The bubble share is (S - 1) / T.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import collectives as col


def _pipeline_local(stage_fn: Callable, params: Any, micro: torch.Tensor,
                    group) -> torch.Tensor:
    """This stage's part of the tick loop. micro: [n_micro, ...]
    microbatches, replicated. Returns the last stage's [n_micro, ...]
    outputs, summed over the stages (every other stage adds zeros)."""
    n_stages = col.group_size(group)
    idx = col.group_rank(group)
    n_micro = micro.shape[0]
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    dev = micro.device
    first = torch.tensor(idx == 0, device=dev)
    state = torch.zeros_like(micro[0])
    outputs = torch.zeros_like(micro)
    for t in range(n_micro + n_stages - 1):
        m = t - idx                  # the microbatch this stage works on
        active = torch.tensor(0 <= m < n_micro, device=dev)
        m_c = min(max(m, 0), n_micro - 1)
        x_in = torch.where(first, micro[min(t, n_micro - 1)], state)
        y = torch.where(active, stage_fn(params, x_in), state)
        # the last stage records its finished microbatch
        is_out = active & torch.tensor(idx == n_stages - 1, device=dev)
        outputs = outputs.index_add(
            0, torch.tensor([m_c], device=dev),
            torch.where(is_out, y, torch.zeros_like(y))[None])
        state = col.ppermute(y, perm, group)
    return col.psum(outputs, group)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   mesh, *, n_micro: int, axis: str = "stage",
                   remat: bool = False) -> torch.Tensor:
    """Apply the mesh's ``axis`` stages in sequence to ``x`` with GPipe.

    stage_fn(params_one_stage, x) -> y (same shape as x). stage_params:
    THIS rank's stage (``local_stage`` cuts it from a stacked tree).
    x: [batch, ...], the same on every rank; batch divides into n_micro.
    Returns the last stage's output on every rank; x's gradient is summed
    over the stages (only stage 0 reads it)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    group = mesh.get_group(axis)
    micro = x.reshape((n_micro, b // n_micro) + x.shape[1:])
    micro = col.psum_grad(micro, group)
    fn = stage_fn
    if remat:
        def fn(p, xx):
            return checkpoint(stage_fn, p, xx, use_reentrant=False)
    out = _pipeline_local(fn, stage_params, micro, group)
    return out.reshape((b,) + out.shape[2:])


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage: list[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    axis."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *per_stage)


def local_stage(stacked: Any, mesh, axis: str = "stage") -> Any:
    """This rank's stage of a tree with a leading stage axis (a copy, so
    the stacked tree can be dropped)."""
    idx = mesh.get_local_rank(axis)
    return _tree_map(lambda leaf: leaf[idx].clone(), stacked)
