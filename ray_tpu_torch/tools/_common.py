"""What the train-side tools share: their command line (``--device``,
``--out``), the output line, the H100 parts' peaks, and one timed run of
the llama train step on one device."""

from __future__ import annotations

import argparse
import json
import time

# (bf16 dense tensor-core FLOP/s, memory bytes/s) by part; NVIDIA data
# sheets. chip_smoke.py holds the same table.
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}


def parser(prog: str, description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=f"python -m {prog}",
                                 description=description)
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default (raises without one); "
                         "cpu on purpose")
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this path")
    return ap


def device_of(args):
    """The tool's device: ``resolve_device(args.device)`` (the card unless
    asked for the CPU; raises without a card)."""
    from ray_tpu_torch.device import resolve_device

    return resolve_device(args.device)


def finish(result: dict, args, more: dict | None = None) -> dict:
    """Print the result as one JSON line; write it, with `more` (what is
    too long for the line), where ``--out`` says."""
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**result, **(more or {})}, f, indent=1)
    return result


def peak_flops(device) -> float | None:
    """The bf16 dense peak of the H100 part `device` is; None on the CPU."""
    import torch

    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for part in ("H100 PCIe", "H100 NVL", "H100"):
        if part in name:
            return PEAKS[part][0]
    return PEAKS["H100"][0]


def card(device) -> dict:
    """The device's name (the card's, or "cpu")."""
    import torch

    return {"device": device.type,
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu")}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_config(preset: str, seq: int, remat_policy: str = "dots",
                 attn_impl: str = "flash"):
    from ray_tpu_torch.models import llama

    return llama.config_for(preset, max_seq_len=seq, remat=True,
                            remat_policy=remat_policy, attn_impl=attn_impl)


def build_step(cfg, batch: int, seq: int, device, lora_rank: int = 0):
    """(step, state, data) of the train step: the preset's params from
    seed 0, AdamW(3e-4), random tokens from seed 1; with ``lora_rank``,
    rank-r adapters on wq wk wv wo and only they train."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models import lora as lora_mod
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    params = llama.init_params(cfg, seed=0, device=device)
    trainable = None
    if lora_rank:
        params["lora"] = lora_mod.init_lora_params(
            cfg, lora_mod.LoraConfig(rank=lora_rank, alpha=cfg.lora_alpha),
            seed=2, device=device)
        trainable = ("lora",)
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4), params,
        trainable_keys=trainable, device=device)
    params.clear()          # the step holds its own copy
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=gen).to(device)
    return step, state, {"tokens": tokens,
                         "targets": torch.roll(tokens, -1, 1)}


def timed_steps(cfg, batch: int, seq: int, steps: int, device,
                lora_rank: int = 0) -> dict:
    """One warm-up step, then `steps` timed steps: tokens/s, step ms, the
    losses, and the flash kernels' launches over the timed steps."""
    from ray_tpu_torch.ops.cuda import flash_attention as fa

    step, state, data = build_step(cfg, batch, seq, device, lora_rank)
    state, aux = step(state, data)
    losses = [aux["loss"].item()]
    sync(device)
    fa.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, aux = step(state, data)
    losses.append(aux["loss"].item())
    sync(device)
    dt = time.perf_counter() - t0
    return {"tokens_per_s": batch * seq * steps / dt,
            "step_ms": dt / steps * 1e3, "losses": losses,
            "launches": dict(fa.launches)}
