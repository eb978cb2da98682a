"""Flash attention forward + backward: hand-written CUDA kernels for the H100
and their plain PyTorch versions.

Counterpart of ``ray_tpu/ops/pallas/flash_attention.py``. Three kernels, in
``ray_tpu_torch/csrc/``:

* ``flash_fwd``: blockwise online-softmax forward, returns ``out`` and
  ``lse``;
* ``flash_bwd_dq`` and ``flash_bwd_dkv``: the two-kernel flash backward from
  the saved ``lse`` and ``delta = rowsum(dO * O)`` (computed here in f32 by
  torch).

The C entry points pick the kernel by (dtype, head dim): bf16 at d in
{64, 128} runs the warp-specialised wgmma + TMA kernels
(``flash_attention_fwd_sm90.cu``, ``flash_attention_bwd_dq_sm90.cu``,
``flash_attention_bwd_sm90.cu``); bf16 at d in {16, 32} the mma.sync
kernels; f32 the FMA kernels (``flash_attention_fwd.cu``,
``flash_attention_bwd.cu``).

Beside each kernel sits its plain version (``*_plain``), the same math
written blockwise in torch over ``block_q`` x ``block_k`` tiles. The autograd
Function uses the plain versions for CPU tensors and the kernels for CUDA
tensors; a CUDA tensor launches its kernel or raises, it never falls back.

Layouts are the reference's: q ``[b, sq, h, d]``, k and v ``[b, sk, hk, d]``
with ``h % hk == 0`` (query head ``i`` reads kv head ``i // (h // hk)``),
lse ``[b, h, sq]`` f32. The causal mask is top-left aligned
(``q_pos >= k_pos`` with both counted from 0), as in the Pallas kernel; the
dense path in ``ops/attention.py`` is bottom-right aligned, as
``xla_attention`` is. The two agree when ``sq == sk``.

The forward is also a ``torch.library`` custom op (``ray_tpu_torch::flash_fwd``)
so that a selective-checkpoint policy can name it and save its outputs
(``LlamaConfig.remat_save_attn``).
"""

import ctypes

import torch

from ray_tpu_torch.ops.cuda._build import check, library

NEG_INF = -1e30
# lse of a row with no unmasked key: exp(s - BIG) == 0 for any finite s
MASKED_LSE = 1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches per wrapper; each wrapper adds one where it launches.
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _default_scale(d: int, scale: float | None) -> float:
    return d ** -0.5 if scale is None else float(scale)


# ---------------------------------------------------------- plain versions
def _heads_first(x: torch.Tensor, n_rep: int = 1) -> torch.Tensor:
    """[b, s, hk, d] -> [b, hk * n_rep, s, d] with kv head i // n_rep."""
    if n_rep > 1:
        x = x.repeat_interleave(n_rep, dim=2)
    return x.transpose(1, 2)


def _causal_keep(q0: int, bq: int, k0: int, bk: int,
                 device: torch.device) -> torch.Tensor:
    q_pos = torch.arange(q0, q0 + bq, device=device)[:, None]
    k_pos = torch.arange(k0, k0 + bk, device=device)[None, :]
    return q_pos >= k_pos


def flash_forward_plain(q, k, v, causal=True, scale=None, block_q=512,
                        block_k=512):
    """Plain version of the forward kernel. Returns (out [b, sq, h, d] in q's
    dtype, lse [b, h, sq] f32)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = _default_scale(d, scale)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    qt = _heads_first(q).float()
    kt = _heads_first(k, h // hk).float()
    vt = _heads_first(v, h // hk)
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, block_q):
        qb = qt[:, :, q0:q0 + block_q]
        bq = qb.shape[2]
        m = torch.full((b, h, bq), NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for k0 in range(0, sk, block_k):
            if causal and q0 + bq - 1 < k0:
                break  # this and every later block lies above the diagonal
            kb = kt[:, :, k0:k0 + block_k]
            s = qb @ kb.transpose(-1, -2) * scale
            keep = None
            if causal:
                keep = _causal_keep(q0, bq, k0, kb.shape[2], q.device)
                s = s.masked_fill(~keep, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            if keep is not None:
                p = p.masked_fill(~keep, 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            vb = vt[:, :, k0:k0 + block_k]
            acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vb.float()
            m = m_new
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out[:, :, q0:q0 + bq] = (acc / l_safe[..., None]).to(q.dtype)
        lse[:, :, q0:q0 + bq] = torch.where(
            l > 0.0, m + torch.log(l_safe), torch.full_like(l, MASKED_LSE))
    return out.transpose(1, 2).contiguous(), lse


def _bwd_block(qb, kb, vb, dob, lse_b, delta_b, keep, scale, ds_dtype):
    """p and ds of one (query block, key block) pair, all f32 operands."""
    s = qb @ kb.transpose(-1, -2) * scale
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse_b[..., None])
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = dob @ vb.transpose(-1, -2)
    ds = (p * (dp - delta_b[..., None]) * scale).to(ds_dtype).float()
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True, scale=None,
                       block_q=512, block_k=512):
    """Plain version of the dQ kernel. lse, delta: [b, h, sq] f32."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = _default_scale(d, scale)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    qt, dot = _heads_first(q).float(), _heads_first(do).float()
    kt = _heads_first(k, h // hk).float()
    vt = _heads_first(v, h // hk).float()
    dq = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    for q0 in range(0, sq, block_q):
        qb, dob = qt[:, :, q0:q0 + block_q], dot[:, :, q0:q0 + block_q]
        bq = qb.shape[2]
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for k0 in range(0, sk, block_k):
            if causal and q0 + bq - 1 < k0:
                break
            kb, vb = kt[:, :, k0:k0 + block_k], vt[:, :, k0:k0 + block_k]
            keep = (_causal_keep(q0, bq, k0, kb.shape[2], q.device)
                    if causal else None)
            _, ds = _bwd_block(qb, kb, vb, dob, lse[:, :, q0:q0 + bq],
                               delta[:, :, q0:q0 + bq], keep, scale, k.dtype)
            acc = acc + ds @ kb
        dq[:, :, q0:q0 + bq] = acc.to(q.dtype)
    return dq.transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True, scale=None,
                        block_q=512, block_k=512):
    """Plain version of the dK/dV kernel: accumulates per query head in f32,
    then sums each GQA group and casts to k's and v's dtypes."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    n_rep = h // hk
    scale = _default_scale(d, scale)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    qt, dot = _heads_first(q).float(), _heads_first(do).float()
    kt = _heads_first(k, n_rep).float()
    vt = _heads_first(v, n_rep).float()
    dk_h = torch.zeros((b, h, sk, d), device=q.device)
    dv_h = torch.zeros((b, h, sk, d), device=q.device)
    for k0 in range(0, sk, block_k):
        kb, vb = kt[:, :, k0:k0 + block_k], vt[:, :, k0:k0 + block_k]
        bk = kb.shape[2]
        for q0 in range(0, sq, block_q):
            qb, dob = qt[:, :, q0:q0 + block_q], dot[:, :, q0:q0 + block_q]
            bq = qb.shape[2]
            if causal and q0 + bq - 1 < k0:
                continue
            keep = _causal_keep(q0, bq, k0, bk, q.device) if causal else None
            p, ds = _bwd_block(qb, kb, vb, dob, lse[:, :, q0:q0 + bq],
                               delta[:, :, q0:q0 + bq], keep, scale, q.dtype)
            dv_h[:, :, k0:k0 + bk] += (p.to(do.dtype).float()
                                       .transpose(-1, -2) @ dob)
            dk_h[:, :, k0:k0 + bk] += ds.transpose(-1, -2) @ qb
    dk = dk_h.view(b, hk, n_rep, sk, d).sum(2)
    dv = dv_h.view(b, hk, n_rep, sk, d).sum(2)
    return (dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


# ---------------------------------------------------------- kernel wrappers
def _check_bshd(name: str, ref: torch.Tensor, **tensors) -> None:
    """Device, dtype, rank, head dim and stride checks of [b, s, h, d]
    operands against the kernel's contract."""
    if ref.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {ref.dtype} not supported "
                         f"(float32 or bfloat16)")
    vec = 16 // ref.element_size()
    for arg, t in tensors.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name}: {arg} must be on {ref.device}, "
                             f"got {t.device}")
        if t.dtype != ref.dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, q is {ref.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} must be [b, s, h, d], "
                             f"got shape {tuple(t.shape)}")
        if t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: head dim {t.shape[-1]} not in "
                             f"{HEAD_DIMS}")
        if (t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name}: {arg} needs a contiguous last dim, strides that are "
                f"multiples of {vec} elements and a 16-byte aligned start; "
                f"got strides {t.stride()}")


def _check_gqa(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if h % k.shape[2]:
        raise ValueError(f"{name}: {h} query heads not a multiple of "
                         f"{k.shape[2]} kv heads")


def _check_rows(name: str, q: torch.Tensor, **rows) -> None:
    b, sq, h, _ = q.shape
    for arg, t in rows.items():
        if (t.dtype != torch.float32 or t.shape != (b, h, sq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name}: {arg} must be a contiguous f32 "
                             f"[{b}, {h}, {sq}] tensor on {q.device}")


def _check_scale(name: str, q: torch.Tensor, scale: float) -> None:
    """The bf16 wgmma forward takes the row max of the raw scores, and the
    bf16 wgmma dQ kernel folds log2(scale) into its exponent: both need a
    positive scale."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in (64, 128)
            and not scale > 0):
        raise ValueError(f"{name}: scale must be positive, got {scale}")


def _strides(*tensors: torch.Tensor):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _dims(q: torch.Tensor, k: torch.Tensor, causal: bool):
    b, sq, h, _ = q.shape
    return (ctypes.c_int * 6)(b, h, k.shape[2], sq, k.shape[1], int(causal))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward_cuda(q, k, v, causal=True, scale=None):
    """Launches the forward kernel. Returns (out, lse [b, h, sq] f32)."""
    _check_bshd("flash_fwd", q, q=q, k=k, v=v)
    _check_gqa("flash_fwd", q, k, v)
    b, sq, h, d = q.shape
    _check_scale("flash_fwd", q, _default_scale(d, scale))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        code = lib.rtt_flash_fwd(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, out), _dims(q, k, causal),
            _default_scale(d, scale), _stream(q))
    check(lib, "flash_fwd", code)
    launches["flash_fwd"] += 1
    return out, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=True, scale=None):
    """Launches the dQ kernel. lse, delta: contiguous [b, h, sq] f32."""
    _check_bshd("flash_bwd_dq", q, q=q, k=k, v=v, do=do)
    _check_gqa("flash_bwd_dq", q, k, v)
    _check_rows("flash_bwd_dq", q, lse=lse, delta=delta)
    if do.shape != q.shape:
        raise ValueError("flash_bwd_dq: do must have q's shape")
    d = q.shape[-1]
    _check_scale("flash_bwd_dq", q, _default_scale(d, scale))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = library()
    with torch.cuda.device(q.device):
        code = lib.rtt_flash_bwd_dq(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), _strides(q, k, v, do, dq), _dims(q, k, causal),
            _default_scale(d, scale), _stream(q))
    check(lib, "flash_bwd_dq", code)
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=True, scale=None):
    """Launches the dK/dV kernel. Returns (dk, dv) in k's dtype."""
    _check_bshd("flash_bwd_dkv", q, q=q, k=k, v=v, do=do)
    _check_gqa("flash_bwd_dkv", q, k, v)
    _check_rows("flash_bwd_dkv", q, lse=lse, delta=delta)
    if do.shape != q.shape:
        raise ValueError("flash_bwd_dkv: do must have q's shape")
    d = q.shape[-1]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = library()
    with torch.cuda.device(q.device):
        code = lib.rtt_flash_bwd_dkv(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, do, dk, dv),
            _dims(q, k, causal), _default_scale(d, scale), _stream(q))
    check(lib, "flash_bwd_dkv", code)
    launches["flash_bwd_dkv"] += 1
    return dk, dv


# ------------------------------------------------------------- public op
def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type == "cpu":
        return True
    raise ValueError(f"flash attention runs on CUDA or CPU tensors, "
                     f"not {t.device}")


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float, block_q: int,
              block_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the kernel on CUDA tensors, the plain version on CPU
    tensors. block_q/block_k tile the plain version only; the kernel picks
    its own tiles."""
    if _on_cpu(q):
        return flash_forward_plain(q, k, v, causal, scale, block_q, block_k)
    return flash_forward_cuda(q, k, v, causal, scale)


class FlashAttention(torch.autograd.Function):
    """Counterpart of the reference's ``jax.custom_vjp``: saves
    (q, k, v, out, lse) and runs the dQ and dK/dV kernels in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        out, lse = flash_fwd(q, k, v, causal, scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_q, block_k = ctx.args
        g = g.contiguous()
        # delta_i = rowsum(dO * O) in f32: a cheap bandwidth-bound prologue
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        if _on_cpu(q):
            dq = flash_bwd_dq_plain(q, k, v, g, lse, delta, causal, scale,
                                    block_q, block_k)
            dk, dv = flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal,
                                         scale, block_q, block_k)
        else:
            dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, block_q=512,
                    block_k=512):
    """q: [b, sq, h, d]; k, v: [b, sk, hk, d] -> out [b, sq, h, d]."""
    return FlashAttention.apply(q, k, v, causal,
                                _default_scale(q.shape[-1], scale),
                                block_q, block_k)
