"""Differentiable collectives over a process group: the port's counterpart
of the ``jax.lax`` collectives the reference calls inside ``shard_map``.

Each is an autograd Function whose backward is the collective JAX would
transpose it to, under the convention that a value computed alike on every
rank of a group (a replicated value) carries the same gradient on every
rank:

* ``psum`` — Megatron's g: all-reduce forward, identity backward (the
  upstream gradient is replicated). Not ``torch.distributed.nn``'s
  all_reduce, whose backward all-reduces again and so multiplies the
  gradient by the group's size.
* ``psum_grad`` — Megatron's f, g's transpose: identity forward, all-reduce
  backward. It sits where a replicated value enters rank-local compute.
* ``all_gather`` — backward a reduce-scatter (the ranks' gradients differ:
  a parameter gathered across ranks that hold different data).
* ``gather_replicated`` — an all-gather feeding compute that is replicated
  across the group: backward takes this rank's slice of the (replicated)
  gradient.
* ``split`` — this rank's slice of a replicated value: backward an
  all-gather, so the gradient comes back whole on every rank.
* ``all_to_all`` — backward the inverse all-to-all.
* ``ppermute`` — backward the inverse permutation.

``group=None`` or a group of one rank makes each an identity. Tensors cross
the group as they are: a CUDA tensor needs an NCCL group, a CPU tensor a
gloo group (the tests' CPU ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * size, size).contiguous()


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    """Tiled all-to-all: chunk j of ``split_dim`` goes to rank j; the chunks
    received are concatenated along ``concat_dim`` in rank order."""
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does "
                         f"not split over {n} ranks")
    chunks = x.movedim(split_dim, 0)
    chunks = chunks.reshape((n, chunks.shape[0] // n) + chunks.shape[1:])
    send = chunks.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    parts = [recv[j].movedim(0, split_dim) for j in range(n)]
    return torch.cat(parts, dim=concat_dim)


def _ppermute(x: torch.Tensor, perm: list, group) -> torch.Tensor:
    """Send x to every dst of (this rank, dst) in perm; return what arrives
    from the src of (src, this rank), zeros where nothing does (as
    ``lax.ppermute``). Ranks are indices in the group."""
    me = group_rank(group)
    x = x.contiguous()
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"rank {me} receives from {srcs}: a permutation "
                         "has one source a rank")
    out = torch.zeros_like(x)
    ops = []
    for d in dsts:
        if d == me:
            out = x.clone()
        else:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, d), group))
    for s in srcs:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group),
                None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, inverse, ctx.group), None, None


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the gradient passes through unchanged."""
    return x if _trivial(group) else _Psum.apply(x, group)


def psum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over the group."""
    return x if _trivial(group) else _PsumGrad.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the ranks' x along dim; backward reduce-scatters."""
    return x if _trivial(group) else _AllGather.apply(x, dim, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate the ranks' x along dim for compute replicated across the
    group; backward keeps this rank's slice of the gradient."""
    return x if _trivial(group) else _GatherReplicated.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of a replicated x along dim; backward gathers."""
    return x if _trivial(group) else _Split.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``)."""
    if _trivial(group):
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def ppermute(x: torch.Tensor, perm: list, group) -> torch.Tensor:
    """``lax.ppermute``: (src, dst) pairs of group ranks."""
    if _trivial(group):
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    return _Ppermute.apply(x, [tuple(p) for p in perm], group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group, no autograd (gradients, counts)."""
    if not _trivial(group):
        dist.all_reduce(x, group=group)
    return x
