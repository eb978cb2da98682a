#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line and raising on failure (nothing is
caught, so any failure exits non-zero):

1. device: the card's name and power limit as nvidia-smi reports them.
2. build: compiles the kernels from ray_tpu_torch/csrc with nvcc.
3. kernels: holds each CUDA kernel against its plain PyTorch version on the
   card (f32 at tight tolerances; bf16 at the train step's shapes, d=128,
   GQA, ragged lengths, strided views of a fused qkv buffer, sq != sk, the
   edges of the dQ kernel's 128-row block, and d=32 on the mma.sync
   kernels) and times kernel, plain version and PyTorch's
   scaled_dot_product_attention beside the kernel's bound, at d=64 and
   d=128.
4. train_parity: 3 AdamW steps of the debug model in f32 with the flash
   kernels on the card against the same steps on the CPU (plain versions).
5. train_410m: the Llama 410m train step at full width and depth (b8 s2048,
   bf16 compute, remat "dots", flash attention); the launch counters show
   every step went through all three kernels.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero and
prints no result.

    python3 chip_smoke.py --compare DIR

times the kernels of the checkout in DIR (for example the parent commit,
unpacked there with `git archive`) and of this one in turns, DIR, this,
this, DIR, at the timed shapes, then the 410m train step with its profile
(step ms, device busy ms, idle share, flash attention's device ms), one
process each, and prints one {"phase": "compare", ...} line per run.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS_410M = 5   # timed steps, after 2 warm-up steps
# (b, s, h, hk, d) at which the kernels are timed: the 410m train step's
# attention, and the same width in heads of 128
TIMED_SHAPES = ((8, 2048, 16, 16, 64), (8, 2048, 8, 8, 128))
# (bf16 dense tensor-core FLOP/s, memory bytes/s) by part; NVIDIA data sheets
PEAKS = {"H100 PCIe": (756e12, 2.0e12), "H100 NVL": (835e12, 3.9e12),
         "H100": (989e12, 3.35e12)}
REPLACES = {
    "flash_fwd": "ray_tpu/ops/pallas/flash_attention.py:46",
    "flash_bwd_dq": "ray_tpu/ops/pallas/flash_attention.py:168",
    "flash_bwd_dkv": "ray_tpu/ops/pallas/flash_attention.py:219",
}
# the kernels that serve the main path (bf16, d=64)
SOURCES = {
    "flash_fwd": "ray_tpu_torch/csrc/flash_attention_fwd_sm90.cu",
    "flash_bwd_dq": "ray_tpu_torch/csrc/flash_attention_bwd_dq_sm90.cu",
    "flash_bwd_dkv": "ray_tpu_torch/csrc/flash_attention_bwd_sm90.cu",
}
DESIGN = {
    "flash_fwd": "wgmma+tma, warp-specialised",
    "flash_bwd_dq": "wgmma+tma, warp-specialised",
    "flash_bwd_dkv": "wgmma+tma, warp-specialised",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def peaks(name: str) -> tuple[float, float]:
    for part in ("H100 PCIe", "H100 NVL", "H100"):
        if part in name:
            return PEAKS[part]
    return PEAKS["H100"]


def time_ms(fn, n: int = 20, runs: int = 5, warmup: int = 3) -> float:
    """Device time of one call: one CUDA-event pair around n back-to-back
    calls, divided by n; the median of `runs` such runs, after warm-up. The
    host's own time per call (wrapper, ctypes, allocation) overlaps the
    card's work instead of adding to it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def time_single_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of CUDA-event times of single calls, each synchronised: every
    reading includes the host's time to launch. Kept beside time_ms to show
    how much of a single-call reading is host time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------------ phases
def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return {"name": name, "smi": smi}


def ptxas_report(text: str) -> dict:
    """Per kernel instance of a -Xptxas=-v log: registers and spill bytes,
    keyed by kernel name and head dim (e.g. "flash_fwd_wgmma_kernel<64>")."""
    report, name = {}, None
    for line in text.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) "
                          r"'?(_Z\w+)", line)
        if entry:
            sym = entry.group(1)
            kernel = re.search(r"(flash_\w+?_kernel)I(?:\w*?)Li(\d+)E", sym)
            name = (f"{kernel.group(1)}<{kernel.group(2)}>" if kernel
                    else sym)
            report.setdefault(name, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and name:
            report[name]["spill_bytes"] = int(spill.group(1)) + int(
                spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            report[name]["registers"] = int(used.group(1))
    return report


def phase_build() -> dict:
    from ray_tpu_torch.ops.cuda import _build

    path, seconds = _build.build()
    log = _build.BUILD_DIR / (path.name + ".log")
    text = log.read_text() if log.exists() else ""
    report = ptxas_report(text)
    spills = {n: r["spill_bytes"] for n, r in report.items()
              if r.get("spill_bytes")}
    regs = [r["registers"] for r in report.values() if "registers" in r]
    lib = _build.library()
    for d in (64, 128):  # dynamic shared memory a block of each takes
        report[f"flash_fwd_wgmma_kernel<{d}>"]["smem_bytes"] = (
            lib.rtt_flash_fwd_sm90_smem(d))
        report[f"flash_bwd_dq_wgmma_kernel<{d}>"]["smem_bytes"] = (
            lib.rtt_flash_bwd_dq_sm90_smem(d))
        report[f"flash_bwd_dkv_wgmma_kernel<{d}>"]["smem_bytes"] = (
            lib.rtt_flash_bwd_dkv_sm90_smem(d))
    emit("build", seconds=seconds, library=str(path.relative_to(ROOT)),
         ptxas_log=str(log.relative_to(ROOT)),
         max_registers=max(regs) if regs else None, spills=spills,
         wgmma_kernels={n: r for n, r in report.items() if "wgmma" in n})
    return report


def _inputs(b, sq, sk, h, hk, d, dtype, seed, fused=False):
    """q, k, v, do from a seed. fused: q, k and v are views of one
    [b, s, h + 2 hk, d] buffer (head stride d, row stride (h + 2 hk) d), as a
    fused qkv projection would leave them."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if fused:
        assert sq == sk
        buf = rnd(b, sq, h + 2 * hk, d)
        q, k, v = buf[:, :, :h], buf[:, :, h:h + hk], buf[:, :, h + hk:]
    else:
        q, k, v = rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d)
    return q, k, v, rnd(b, sq, h, d)


def _run_kernels(fa, q, k, v, do, causal):
    import torch

    out, lse = fa.flash_forward_cuda(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    return out, lse, delta, dq, dk, dv


def _run_plain(fa, q, k, v, do, lse, delta, causal):
    """Plain versions in f32 on the same inputs (bf16 inputs upcast); the
    backward plain versions take the kernel's own lse and delta."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    out, lse_p = fa.flash_forward_plain(qf, kf, vf, causal)
    dq = fa.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal)
    return out, lse_p, dq, dk, dv


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _allclose_err(a, b, tol) -> float:
    """max |a - b| / (tol + tol |b|): <= 1 passes assert_allclose(atol=rtol=tol)."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (tol + tol * b.abs())).max().item()


def check_case(fa, tag, b, s, h, hk, d, dtype, causal, seed=0, sk=None,
               fused=False) -> dict:
    import torch

    sk = s if sk is None else sk
    q, k, v, do = _inputs(b, s, sk, h, hk, d, dtype, seed, fused)
    out, lse, delta, dq, dk, dv = _run_kernels(fa, q, k, v, do, causal)
    p_out, p_lse, p_dq, p_dk, p_dv = _run_plain(fa, q, k, v, do, lse, delta,
                                                causal)
    res = {"case": tag, "shape": [b, s, h, hk, d], "sk": sk, "fused": fused,
           "dtype": str(dtype), "causal": causal,
           "out_max_abs": _max_abs(out, p_out),
           "lse_max_abs": _max_abs(lse, p_lse),
           "dq_max_abs": _max_abs(dq, p_dq),
           "dkv_max_abs": max(_max_abs(dk, p_dk), _max_abs(dv, p_dv))}
    if dtype == torch.float32:
        # the CPU tests' tolerances: fwd 2e-5, bwd 5e-4 (assert_allclose form)
        checks = {"out": _allclose_err(out, p_out, 2e-5),
                  "lse": _allclose_err(lse, p_lse, 2e-5),
                  "dq": _allclose_err(dq, p_dq, 5e-4),
                  "dk": _allclose_err(dk, p_dk, 5e-4),
                  "dv": _allclose_err(dv, p_dv, 5e-4)}
        res["allclose_ratio"] = checks
        bad = {n: r for n, r in checks.items() if not r <= 1.0}
    else:
        # bf16 output rounding bounds out; dq/dk/dv by relative L2 (ds and p
        # are rounded to bf16 before their products, as in the reference)
        res["rel_l2"] = {"dq": _rel_l2(dq, p_dq), "dk": _rel_l2(dk, p_dk),
                         "dv": _rel_l2(dv, p_dv)}
        bad = {n: r for n, r in res["rel_l2"].items() if not r <= 1e-2}
        if not res["out_max_abs"] <= 2e-2:
            bad["out"] = res["out_max_abs"]
        if not res["lse_max_abs"] <= 1e-3:
            bad["lse"] = res["lse_max_abs"]
    res["ok"] = not bad
    emit("kernels", **res)
    if bad:
        raise AssertionError(f"kernel mismatch in {tag}: {bad}")
    return res


def _bound(name, b, s, h, hk, d, elem, causal, peak_flops, peak_bytes):
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    rows = b * h * s * 4                       # one f32 per query row
    q_bytes = b * s * h * d * elem
    kv_bytes = b * s * hk * d * elem
    if name == "flash_fwd":
        flops = 4 * d * pairs                  # QK^T, PV
        nbytes = 2 * q_bytes + 2 * kv_bytes + rows            # q,k,v,out,lse
    elif name == "flash_bwd_dq":
        flops = 6 * d * pairs                  # QK^T, dO V^T, dS K
        nbytes = 3 * q_bytes + 2 * kv_bytes + 2 * rows        # +dO,dq,lse,delta
    else:
        flops = 8 * d * pairs                  # QK^T, dO V^T, P^T dO, dS^T Q
        nbytes = 2 * q_bytes + 4 * kv_bytes + 2 * rows        # +dk,dv
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _time_kernels(fa, b, s, h, hk, d, peak_flops, peak_bytes,
                  plain=True) -> dict:
    """Kernel, plain-version and SDPA times at one causal bf16 shape."""
    import torch
    import torch.nn.functional as F

    q, k, v, do = _inputs(b, s, s, h, hk, d, torch.bfloat16, 1)
    out, lse = fa.flash_forward_cuda(q, k, v, True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {
        "flash_fwd": lambda: fa.flash_forward_cuda(q, k, v, True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                     True),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse,
                                                       delta, True),
    }
    plains = {
        "flash_fwd": lambda: fa.flash_forward_plain(q, k, v, True),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                      True),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, True),
    }
    ms = {name: time_ms(fn) for name, fn in calls.items()}
    single_ms = {name: time_single_ms(fn) for name, fn in calls.items()}
    plain_ms = ({name: time_ms(fn, n=2, runs=3, warmup=1)
                 for name, fn in plains.items()} if plain else {})
    # PyTorch's fused attention as the yardstick (timed here only)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=hk != h))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            enable_gqa=hk != h)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        o_sdpa, (qt, kt, vt), dot, retain_graph=True))
    library_ms = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                  "flash_bwd_dkv": sdpa_bwd}
    table = {}
    for name in calls:
        bound = _bound(name, b, s, h, hk, d, 2, True, peak_flops, peak_bytes)
        table[name] = {"ms": ms[name], "single_call_ms": single_ms[name],
                       "plain_ms": plain_ms.get(name),
                       "library_ms": library_ms[name], **bound,
                       "roofline_share": bound["bound_ms"] / ms[name]}
    return table


def _emit_times(table: dict, shape: list) -> None:
    for name, row in table.items():
        emit("kernels", kernel=name, shape=shape, dtype="bf16",
             design=DESIGN[name], **row,
             library=("sdpa_fwd" if name == "flash_fwd"
                      else "sdpa_bwd (dq, dk, dv in one call)"))


def phase_kernels(device_name: str) -> dict:
    import torch

    from ray_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    for causal in (True, False):
        check_case(fa, "f32_s256_gqa", 2, 256, 4, 2, 64, f32, causal)
    check_case(fa, "f32_s256_d128", 1, 256, 2, 2, 128, f32, True)
    check_case(fa, "f32_s200_d16_ragged", 1, 200, 4, 2, 16, f32, True)
    main = check_case(fa, "bf16_main_410m", 8, 2048, 16, 16, 64, bf16, True)
    check_case(fa, "bf16_d128", 8, 2048, 8, 8, 128, bf16, True)
    check_case(fa, "bf16_gqa", 8, 2048, 16, 4, 64, bf16, True)
    check_case(fa, "bf16_gqa_d128", 2, 2048, 16, 4, 128, bf16, True)
    check_case(fa, "bf16_ragged_s1000", 2, 1000, 4, 2, 64, bf16, True)
    check_case(fa, "bf16_ragged_s1000_d128", 2, 1000, 4, 2, 128, bf16, True)
    check_case(fa, "bf16_noncausal", 2, 1024, 4, 4, 64, bf16, False)
    check_case(fa, "bf16_fused_qkv_views", 2, 1024, 8, 2, 64, bf16, True,
               fused=True)
    check_case(fa, "bf16_fused_qkv_views_d128", 2, 1000, 4, 4, 128, bf16,
               False, fused=True)
    check_case(fa, "bf16_sq1024_sk2048", 2, 1024, 8, 4, 64, bf16, True,
               sk=2048)
    check_case(fa, "bf16_d32_mma_sync", 2, 1024, 4, 2, 32, bf16, True)
    # the dQ kernel's 128-row block and its two warpgroups: sq a multiple of
    # 64 but not of 128 (the last block's second warpgroup has no valid row);
    # sq > sk top-left (rows past sk see every key, K's last tile is ragged);
    # one key tile and one block
    check_case(fa, "bf16_s960", 2, 960, 4, 2, 64, bf16, True)
    check_case(fa, "bf16_sq2048_sk1000_d128", 2, 2048, 8, 4, 128, bf16, True,
               sk=1000)
    check_case(fa, "bf16_s64_d128", 1, 64, 2, 2, 128, bf16, True)

    peak_flops, peak_bytes = peaks(device_name)
    table = _time_kernels(fa, *TIMED_SHAPES[0], peak_flops, peak_bytes)
    _emit_times(table, list(TIMED_SHAPES[0]))
    d128 = _time_kernels(fa, *TIMED_SHAPES[1], peak_flops, peak_bytes,
                         plain=False)
    _emit_times(d128, list(TIMED_SHAPES[1]))
    err = {"flash_fwd": main["out_max_abs"], "flash_bwd_dq": main["dq_max_abs"],
           "flash_bwd_dkv": main["dkv_max_abs"]}
    for name in table:
        table[name]["max_abs_err"] = err[name]
    emit("kernels", verdict="ok", kernels=list(table),
         fwd_plus_bwd_ms=sum(r["ms"] for r in table.values()),
         sdpa_fwd_plus_bwd_ms=(table["flash_fwd"]["library_ms"]
                               + table["flash_bwd_dq"]["library_ms"]),
         d128_ms={n: r["ms"] for n, r in d128.items()})
    return table


def time_tree(tree: str) -> None:
    """--time-tree TREE: times the kernels of the ray_tpu_torch package in
    TREE (a checkout of this or another commit) at TIMED_SHAPES, then its
    410m train step."""
    import torch

    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    from ray_tpu_torch.ops.cuda import flash_attention as fa

    if not os.path.abspath(fa.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {fa.__file__}, not the package in {tree}")
    peak_flops, peak_bytes = peaks(torch.cuda.get_device_name(0))
    res = {}
    for shape in TIMED_SHAPES:
        t = _time_kernels(fa, *shape, peak_flops, peak_bytes, plain=False)
        res[f"d{shape[4]}"] = {**{n: r["ms"] for n, r in t.items()},
                               "sdpa_fwd": t["flash_fwd"]["library_ms"],
                               "sdpa_bwd": t["flash_bwd_dq"]["library_ms"]}
    step = phase_train_410m(torch.cuda.get_device_name(0), STEPS_410M)
    emit("compare", tree=tree, ms=res, step_410m={
        "step_ms": step["step_ms"], "device_busy_ms": step["device_busy_ms"],
        "device_idle_share": step["device_idle_share"],
        "flash_ms": step["groups_ms"]["flash attention (ours)"]})


def compare(other: str) -> None:
    """--compare DIR: times the kernels of DIR (e.g. the parent commit,
    unpacked with git archive) and of this checkout in turns, DIR, this,
    this, DIR, each run in a process of its own on the same card."""
    for tree in (other, ROOT, ROOT, other):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-tree", tree],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in out.stdout.splitlines() if '"compare"' in ln]
        if out.returncode != 0 or not lines:
            raise RuntimeError(f"timing {tree} failed:\n{out.stdout[-2000:]}"
                               f"\n{out.stderr[-4000:]}")
        print(lines[-1], flush=True)


def _train(cfg, params_np, batch_np, device, steps):
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    params = params_from_numpy(params_np, device=device, cfg=cfg)
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4), params,
        device=device)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    losses = []
    for _ in range(steps):
        state, aux = step(state, batch)
        losses.append(aux["loss"].item())
    return losses


def phase_train_parity() -> None:
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = llama.config_for("debug", dtype=torch.float32, attn_impl="flash",
                           remat=True, remat_policy="dots")
    params_np = params_to_numpy(llama.init_params(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (4, cfg.max_seq_len))
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches

    reset_launches()
    card = _train(cfg, params_np, batch, "cuda", 3)
    counts = dict(launches)
    cpu = _train(cfg, params_np, batch, "cpu", 3)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    # f32 throughout, TF32 off: only summation order differs
    ok = rel <= 1e-4 and all(counts[n] > 0 for n in counts)
    emit("train_parity", card_losses=card, cpu_losses=cpu, max_rel_diff=rel,
         tolerance=1e-4, launches=counts, ok=ok)
    if not ok:
        raise AssertionError("card and CPU train trajectories differ")


def phase_train_410m(device_name: str, steps: int) -> dict:
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    batch_size, seq = 8, 2048
    cfg = llama.config_for("410m", max_seq_len=seq, remat=True,
                           remat_policy="dots", attn_impl="flash")
    params = llama.init_params(cfg, seed=0)
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4), params)
    del params
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    losses = []
    for _ in range(2):                                   # warm-up
        state, aux = step(state, batch)
        losses.append(aux["loss"].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                                     # counts: main path only
    t0 = time.perf_counter()
    for _ in range(steps):
        state, aux = step(state, batch)
        losses.append(aux["loss"].item())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(launches)
    step_ms = dt / steps * 1e3
    tok_s = batch_size * seq * steps / dt
    peak_flops, _ = peaks(device_name)
    mfu = tok_s * cfg.flops_per_token() / peak_flops
    # remat "dots" saves matmul outputs only, so the backward reruns each
    # block's flash forward: 2 forward launches per layer, 1 dq, 1 dkv
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    finite = all(math.isfinite(x) for x in losses)
    emit("train_410m", losses=losses, step_ms=step_ms, tokens_per_s=tok_s,
         mfu=mfu, peak_flops=peak_flops, flops_per_token=cfg.flops_per_token(),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=counts, expected_launches=want, steps=steps,
         batch=batch_size, seq=seq, n_layers=cfg.n_layers)
    if not finite or not losses[-1] < losses[0]:
        raise AssertionError(f"410m losses not finite and falling: {losses}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    return {"launches": counts, "step_ms": step_ms,
            **profile_step(step, state, batch)}


def _kernel_group(name: str) -> str:
    lowered = name.lower()
    if "flash_" in lowered:
        return "flash attention (ours)"
    if any(t in lowered for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "adam" in lowered or "multi_tensor" in lowered:
        return "optimizer"
    return "elementwise, reductions, copies"


def profile_step(step, state, batch) -> dict:
    """Device time by kernel over one traced 410m step: where the time goes
    and how long the card sits idle."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for ev in prof.events():
        # kernels only: operator rows and annotations (such as the
        # optimizer's) repeat the device time of the kernels under them
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        row = by_name.setdefault(ev.name, [0.0, 0])
        row[0] += ev.device_time_total / 1e3
        row[1] += 1
    rows = [(name, ms, n) for name, (ms, n) in by_name.items() if ms > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    groups: dict[str, float] = {}
    for name, ms, _ in rows:
        groups[_kernel_group(name)] = groups.get(_kernel_group(name), 0.0) + ms
    res = {"traced_step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    emit("profile_410m", **res,
         top=[{"kernel": name[:90], "ms": ms, "calls": n}
              for name, ms, n in rows[:12]])
    return res


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if argv[:1] == ["--time-tree"] and len(argv) == 2:
        time_tree(argv[1])
        return 0
    sys.path.insert(0, ROOT)
    import ray_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    if argv[:1] == ["--compare"] and len(argv) == 2:
        phase_device()
        compare(argv[1])
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    info = phase_device()
    phase_build()
    table = phase_kernels(info["name"])
    phase_train_parity()
    counts = phase_train_410m(info["name"], STEPS_410M)["launches"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "design": DESIGN[name],
         "launches": counts[name],
         "max_abs_err": row["max_abs_err"], "ms": row["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
        for name, row in table.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
