"""Where a train step's time goes, leg by leg (the port's twin of the JAX
package's ``tools/mfu_decompose.py``): the attention of one layer on the
flash kernels, on the plain attention (``xla_attention``), and on
PyTorch's ``scaled_dot_product_attention`` (the comparison leg, where the
reference times jax's stock Pallas flash); one block's dense matmuls; the
fused LM head and cross entropy. Each leg's forward and backward is timed
over ``--steps`` calls, and its MFU is its FLOPs over the bf16 dense peak
of the H100 part found (null on the CPU). ``total_ms_in_step`` scales a
per-layer leg by the layer count.

The shapes default to the 410m step's (b8 s2048, width 1024 in 16 heads,
hidden 2816, 24 layers, vocab 32000). Run it as
``python -m ray_tpu_torch.tools.mfu_decompose [LEG ...]``; it prints
``{"legs": [{"leg", "ms", "mfu", "total_ms_in_step"}, ...]}`` as one JSON
line, on the card unless ``--device cpu``.
"""

from __future__ import annotations

import time

from ray_tpu_torch.tools import _common


def _time_ms(fn, args, steps: int, device) -> float:
    """ms of one forward and backward of ``fn(*args).sum()``, the mean over
    `steps` calls after one warm-up call (CUDA events on the card)."""
    import torch

    def once():
        out = fn(*args).float().sum()
        torch.autograd.grad(out, args)

    once()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            once()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        once()
    return (time.perf_counter() - t0) / steps * 1e3


def _leaves(device, *shapes, dtype=None, seed=0):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(device, dtype or torch.bfloat16)
            .requires_grad_(True) for s in shapes]


def legs(dims: dict, device) -> dict:
    """leg name -> () -> (fn, args, FLOPs, per layer)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops.attention import xla_attention
    from ray_tpu_torch.ops.cross_entropy import fused_lm_head_cross_entropy
    from ray_tpu_torch.ops.cuda.flash_attention import flash_attention

    b, s, d, h, kv = dims["b"], dims["s"], dims["d"], dims["h"], dims["kv"]
    hid, v = dims["hid"], dims["v"]
    hd = d // h
    # causal attention: forward 2 matmuls over half the square, backward 2x
    attn_flops = 3 * (4 * b * h * s * s * hd * 0.5)

    def qkv():
        return _leaves(device, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))

    def attn_flash():
        return (lambda q, k, v_: flash_attention(q, k, v_, True),
                qkv(), attn_flops, True)

    def attn_xla():
        return (lambda q, k, v_: xla_attention(q, k, v_, causal=True),
                qkv(), attn_flops, True)

    def attn_sdpa():
        def sdpa(q, k, v_):
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v_.transpose(1, 2),
                is_causal=True, enable_gqa=kv != h)
            return out.transpose(1, 2)
        return sdpa, qkv(), attn_flops, True

    def mlp():
        def block(x, wq, wkv, wo, w1, w2, w3):
            a = x @ wq
            kv_ = x @ wkv
            o = (a + kv_[..., :d]) @ wo
            hh = F.silu(x @ w1) * (x @ w3)
            return o + hh @ w2
        args = _leaves(device, (b, s, d), (d, d), (d, 2 * d), (d, d),
                       (d, hid), (hid, d), (d, hid))
        flops = 3 * 2 * b * s * (d * d + d * 2 * d + d * d + 3 * d * hid)
        return block, args, flops, True

    def ce():
        gen = torch.Generator().manual_seed(2)
        t = torch.randint(0, v, (b, s), generator=gen).to(device)
        x, w = _leaves(device, (b, s, d))[0], _leaves(
            device, (d, v), dtype=torch.float32, seed=1)[0]
        # the f32 head cast to the compute dtype, as the model casts it
        return ((lambda x_, w_: fused_lm_head_cross_entropy(
                    x_, w_.to(x_.dtype), t)[0]),
                [x, w], 3 * (2 * b * s * d * v), False)

    return {f.__name__: f for f in (attn_flash, attn_xla, attn_sdpa, mlp,
                                    ce)}


# a leg's name in the output, as the reference names it
LABELS = {"attn_flash": "attn_flash_fwdbwd", "attn_xla": "attn_xla_fwdbwd",
          "attn_sdpa": "attn_sdpa_fwdbwd", "mlp": "block_matmuls_fwdbwd",
          "ce": "fused_ce_fwdbwd"}


def run(device, dims: dict, names=None, steps: int = 20) -> list:
    peak = _common.peak_flops(device)
    table = legs(dims, device)
    out = []
    for name in names or table:
        fn, args, flops, per_layer = table[name]()
        ms = _time_ms(fn, args, steps, device)
        out.append({"leg": LABELS[name], "ms": ms,
                    "mfu": None if peak is None else flops / (ms / 1e3) / peak,
                    "total_ms_in_step": ms * (dims["l"] if per_layer else 1)})
        del args
    return out


def main(argv=None) -> dict:
    from ray_tpu_torch.ops.cuda import flash_attention as fa

    ap = _common.parser("ray_tpu_torch.tools.mfu_decompose",
                        __doc__.split("\n")[0])
    ap.add_argument("legs", nargs="*", help="the legs to run (all)")
    for name, default in (("b", 8), ("s", 2048), ("d", 1024), ("h", 16),
                          ("kv", None), ("hid", 2816), ("l", 24),
                          ("v", 32000), ("steps", 20)):
        ap.add_argument(f"--{name}", type=int, default=default)
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    dims = {k: getattr(args, k) for k in ("b", "s", "d", "h", "kv", "hid",
                                          "l", "v")}
    dims["kv"] = dims["kv"] or dims["h"]
    fa.reset_launches()
    rows = run(device, dims, args.legs or None, args.steps)
    return _common.finish({"legs": rows, "dims": dims,
                           "launches": dict(fa.launches),
                           "peak_flops": _common.peak_flops(device),
                           **_common.card(device)}, args)


if __name__ == "__main__":
    main()
