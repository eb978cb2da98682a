"""Sequence parallelism: ring attention and Ulysses (counterpart of
ray_tpu/ops/ring_attention.py).

Each shard holds ``s_local`` consecutive positions of q, k and v
(``[b, s_local, h|hk, d]``, shard i at positions ``[i * s_local, (i + 1) *
s_local)``).

* ``ring_attention``: K/V blocks travel round the ring of shards while each
  shard attends its resident queries to the block it holds. Each step is one
  launch of the flash forward kernel (``ops/cuda/flash_attention.py``), which
  returns the block's logsumexp; the blocks merge by it. The kernel's causal
  mask is top-left aligned, so for causal attention the block from the
  shard's own positions runs causal, blocks from earlier shards run
  non-causal, and blocks from later shards are skipped: n shards make
  n (n + 1) / 2 launches where a dense ring makes n^2. The backward walks
  the ring again: each step runs the dQ and dK/dV kernels against the
  merged global lse and ``delta = rowsum(dO * O)``, and the dK/dV partials
  travel with their K/V block, reaching the shard that owns it after one
  last hop. On CPU tensors the same schedule runs the kernels' plain
  versions. GQA needs no repeated K/V: the kernels read kv head
  ``i // (h // hk)``.
* ``ulysses_attention``: an all-to-all turns the sequence shards into head
  shards, each shard attends the whole sequence for its heads (the flash
  kernels on the card), and a second all-to-all turns them back.

The schedule is written once over a transport that moves each shard's
tensors to the next shard: ``GroupTransport`` over a process group
(``batch_isend_irecv``, one process a shard) or ``LocalTransport`` over n
shards held in one process (a list; what one card can check).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import _repeat_kv, dot_product_attention
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.parallel import collectives as col


@dataclasses.dataclass(frozen=True)
class BlockOps:
    """The three block functions of the schedule: fwd(q, k, v, causal,
    scale) -> (out, lse); dq(q, k, v, do, lse, delta, causal, scale) -> dq;
    dkv(...) -> (dk, dv)."""
    fwd: Callable
    dq: Callable
    dkv: Callable


KERNEL_OPS = BlockOps(fa.flash_forward_cuda, fa.flash_bwd_dq_cuda,
                      fa.flash_bwd_dkv_cuda)
PLAIN_OPS = BlockOps(fa.flash_forward_plain, fa.flash_bwd_dq_plain,
                     fa.flash_bwd_dkv_plain)


def ops_for(t: torch.Tensor) -> BlockOps:
    """The kernels for CUDA tensors, their plain versions for CPU tensors."""
    return PLAIN_OPS if fa._on_cpu(t) else KERNEL_OPS


class GroupTransport:
    """One shard a process: this rank's index in the group's ring."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.local = [dist.get_rank(group)]

    def shift(self, shards: list) -> list:
        """[[tensor, ...]] of this rank -> the same list as sent by the
        previous rank (each tensor moved one hop forward)."""
        (tensors,) = shards
        me = self.local[0]
        nxt = dist.get_global_rank(self.group, (me + 1) % self.n)
        prv = dist.get_global_rank(self.group, (me - 1) % self.n)
        sent = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in sent]
        ops = ([dist.P2POp(dist.isend, t, nxt, self.group) for t in sent]
               + [dist.P2POp(dist.irecv, t, prv, self.group) for t in recv])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [recv]


class LocalTransport:
    """n shards held in one process: a shift rotates the list."""

    def __init__(self, n: int):
        self.n = n
        self.local = list(range(n))

    def shift(self, shards: list) -> list:
        return [shards[(j - 1) % self.n] for j in range(self.n)]


def _merge(acc, lse, out, out_lse):
    """Fold one block's (out, lse) into the running f32 (acc, lse)."""
    if acc is None:
        return out.float(), out_lse
    new = torch.logaddexp(lse, out_lse)
    old_w = torch.exp(lse - new).transpose(1, 2)[..., None]
    blk_w = torch.exp(out_lse - new).transpose(1, 2)[..., None]
    return acc * old_w + out.float() * blk_w, new


def _visits(transport, t: int, causal: bool):
    """(local position j, causal) of each block step t runs: shard i holds
    the K/V block of shard (i - t) mod n."""
    for j, i in enumerate(transport.local):
        src = (i - t) % transport.n
        if causal and src > i:
            continue            # every key of a later shard is masked
        yield j, causal and src == i


def ring_forward(qs, ks, vs, transport, causal: bool, scale: float,
                 ops: BlockOps):
    """The forward schedule: (outs in q's dtype, global lses [b, h, s] f32),
    one per local shard."""
    accs = [None] * len(qs)
    lses = [None] * len(qs)
    kv = [[k, v] for k, v in zip(ks, vs)]
    for t in range(transport.n):
        for j, diag in _visits(transport, t, causal):
            out, lse = ops.fwd(qs[j], kv[j][0], kv[j][1], diag, scale)
            accs[j], lses[j] = _merge(accs[j], lses[j], out, lse)
        if t < transport.n - 1:
            kv = transport.shift(kv)
    return [a.to(q.dtype) for a, q in zip(accs, qs)], lses


def ring_backward(qs, ks, vs, outs, lses, dos, transport, causal: bool,
                  scale: float, ops: BlockOps):
    """The backward schedule: (dqs, dks, dvs), one per local shard."""
    deltas = [(do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
              for do, o in zip(dos, outs)]
    dqs = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    # each K/V block travels with its f32 dK/dV partials
    blocks = [[k, v, torch.zeros_like(k, dtype=torch.float32),
               torch.zeros_like(v, dtype=torch.float32)]
              for k, v in zip(ks, vs)]
    for t in range(transport.n):
        for j, diag in _visits(transport, t, causal):
            k, v, dk, dv = blocks[j]
            args = (qs[j], k, v, dos[j], lses[j], deltas[j], diag, scale)
            dqs[j] += ops.dq(*args).float()
            dk_b, dv_b = ops.dkv(*args)
            dk += dk_b.float()
            dv += dv_b.float()
        if t < transport.n - 1:
            blocks = transport.shift(blocks)
    # one last hop brings each block's partials to the shard that owns it
    grads = transport.shift([b[2:] for b in blocks])
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [g[0].to(k.dtype) for g, k in zip(grads, ks)],
            [g[1].to(v.dtype) for g, v in zip(grads, vs)])


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, transport, causal, scale, ops, *tensors):
        n = len(transport.local)
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        outs, lses = ring_forward(qs, ks, vs, transport, causal, scale, ops)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.meta = (transport, causal, scale, ops, n)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        transport, causal, scale, ops, n = ctx.meta
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dos = [torch.zeros_like(o) if g is None else g.contiguous()
               for g, o in zip(gs, outs)]
        dqs, dks, dvs = ring_backward(qs, ks, vs, outs, lses, dos,
                                      transport, causal, scale, ops)
        return (None, None, None, None, *dqs, *dks, *dvs)


def ring_schedule(qs: list, ks: list, vs: list, transport, *,
                  causal: bool = True, scale: float | None = None,
                  ops: BlockOps | None = None) -> list:
    """Ring attention over ``transport`` for the shards this process holds
    (lists as long as ``transport.local``), differentiable. ``ops`` defaults
    to the kernels for CUDA tensors and the plain versions for CPU ones."""
    scale = fa._default_scale(qs[0].shape[-1], scale)
    ops = ops or ops_for(qs[0])
    return list(_RingAttention.apply(transport, causal, scale, ops,
                                     *qs, *ks, *vs))


def _need_group(group, name: str) -> None:
    if group is None:
        raise ValueError(
            f"{name} needs the seq process group (a mesh's "
            f"mesh.get_group('seq')), as the reference's needs shard_map "
            f"with the axis bound")


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = True,
                   scale: float | None = None) -> torch.Tensor:
    """This rank's shard over the seq group ``group``: q [b, s_local, h,
    d], k/v [b, s_local, hk, d] -> [b, s_local, h, d]."""
    _need_group(group, "ring_attention")
    (out,) = ring_schedule([q], [k], [v], GroupTransport(group),
                           causal=causal, scale=scale)
    return out


def ring_attention_local(qs: list, ks: list, vs: list, *,
                         causal: bool = True, scale: float | None = None,
                         ops: BlockOps | None = None) -> list:
    """Ring attention over n shards held in this process (lists of n)."""
    return ring_schedule(qs, ks, vs, LocalTransport(len(qs)), causal=causal,
                         scale=scale, ops=ops)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, *, causal: bool = True,
                      scale: float | None = None,
                      inner_impl: str | None = None) -> torch.Tensor:
    """All-to-all sequence parallelism: q [b, s_local, h, d] (h divisible by
    the group's size) -> [b, s_local, h, d]. The local attention is the
    flash kernels on the card and the dense path on the CPU unless
    ``inner_impl`` says otherwise. K/V heads are sent as they are when they
    divide over the group, else repeated to h first."""
    _need_group(group, "ulysses_attention")
    n = col.group_size(group)
    h, hk = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(f"{h} heads do not divide over a seq group of {n}")
    if hk % n:
        k, v = _repeat_kv(k, h // hk), _repeat_kv(v, h // hk)

    # [b, s_local, h, d] -> [b, n * s_local, h / n, d] and back
    def scatter_heads(x):
        return col.all_to_all(x, 2, 1, group)

    out = dot_product_attention(
        scatter_heads(q), scatter_heads(k), scatter_heads(v), causal=causal,
        scale=scale, impl=inner_impl or ("flash" if q.is_cuda else "xla"))
    return col.all_to_all(out, 1, 2, group)
