"""The train leg of the JAX package's ``bench.py``, on the port: the llama
train step's throughput on one card, as one JSON line
``{"metric", "value", "unit", "vs_baseline", ...}``.

Defaults are the reference's on-chip configuration: the 410m preset at
batch 8, sequence 2048, bf16 compute, flash attention (the three CUDA
kernels), remat "dots", AdamW, one warm-up step then 20 timed steps.
``value`` is tokens/s; ``mfu`` is achieved FLOP/s (the config's FLOPs per
token) over the bf16 dense peak of the H100 part found, and
``vs_baseline`` is ``mfu / 0.35`` as the reference reports it. ``--lora``
trains rank-16 adapters on wq wk wv wo over a frozen base and counts 2/3
of the FLOPs, as the reference does (the base's weight gradients are never
computed). On the CPU (``--device cpu``) there is no peak: ``mfu`` and
``vs_baseline`` are null.

Run it as ``python -m ray_tpu_torch.tools.bench``. No fallback: without a
card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

from ray_tpu_torch.tools import _common

MFU_TARGET = 0.35       # the reference's north-star MFU
LORA_RANK = 16


def run(device, preset: str = "410m", batch: int = 8, seq: int = 2048,
        steps: int = 20, lora_rank: int = 0) -> dict:
    cfg = _common.train_config(preset, seq)
    res = _common.timed_steps(cfg, batch, seq, steps, device, lora_rank)
    flops_per_token = cfg.flops_per_token()
    if lora_rank:
        flops_per_token *= 2 / 3
    peak = _common.peak_flops(device)
    mfu = (None if peak is None
           else res["tokens_per_s"] * flops_per_token / peak)
    tag = "lora_" if lora_rank else ""
    return {"metric": f"llama_{preset}_{tag}train_tokens_per_sec_per_chip",
            "value": round(res["tokens_per_s"], 1), "unit": "tokens/s",
            "vs_baseline": None if mfu is None else round(mfu / MFU_TARGET,
                                                          4),
            "mfu": mfu, "peak_flops": peak,
            "flops_per_token": flops_per_token, "step_ms": res["step_ms"],
            "batch": batch, "seq": seq, "steps": steps,
            "lora_rank": lora_rank, "losses": res["losses"],
            "launches": res["launches"], **_common.card(device)}


def main(argv=None) -> dict:
    ap = _common.parser("ray_tpu_torch.tools.bench", __doc__.split("\n")[0])
    ap.add_argument("--preset", default="410m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lora", action="store_true",
                    help="rank-16 adapters over a frozen base")
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    return _common.finish(run(device, args.preset, args.batch, args.seq,
                              args.steps,
                              LORA_RANK if args.lora else 0), args)


if __name__ == "__main__":
    main()
