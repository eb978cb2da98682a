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
6. serve_parity: the debug model in f32 with TF32 off: decode_step logits
   and cache card vs CPU (left-padded batch, per-row depths, chunked
   prefill) to 1e-4, and the engine's greedy streams card vs CPU, token for
   token (one request, three concurrent, a chunked long prompt, a prefix
   hit, a prefill_only -> generate_prefilled handoff, a free slot left free
   for more steps than its cache holds and then reused). The scenarios
   (serve_scenarios) are shared with tests/test_torch_serve_llm.py.
7. serve_410m: the 410m preset at full width and depth. decode_step
   (1024-token prefill, 8 teacher-forced steps) against the flash forward
   in f32 with TF32 off, to relative L2 1e-4, with an off-by-one control
   that must read above it (the bf16 reading, as served, is printed; 24
   flash_fwd launches each). Then LLMEngine (8 slots, buckets
   128/512/1024, chunk 256, bf16): a late-join check (7 concurrent
   requests, then a late one that must finish within 6 decode steps), and
   a load window of SERVE_REQUESTS open-loop requests at SERVE_RATE
   (serve_traffic): TTFT, TPOT, inter-token latency, tokens/s, peak
   memory; then the decode step alone, timed and traced.
8. lora_parity, moe_parity: the debug model in f32 with TF32 off, card vs
   CPU, 3 AdamW steps each, to 1e-4: a frozen base with a nonzero rank-4
   adapter on all seven targets (the base bit-identical after the steps;
   decode_step with the adapter, a chunked prefill and 4 steps), then 4
   experts top-2 (losses and moe_aux; the routing margin printed).
9. lora_train_410m, moe_train_410m: the 410m train step as in 5 with a
   rank-16 adapter on wq wk wv wo and only the adapter trained (a checksum
   of the frozen base held), then with 8 experts, top-2, capacity factor
   1.25 in every layer; each holds 48/24/24 flash launches a step and
   prints step time, tokens/s, peak memory and its traced step (the MoE
   step's device time split into dispatch/combine einsums, expert FFN,
   flash and the rest).
10. lora_serve_410m: the 410m engine with rank-16 adapters: a zero-B
   adapter's greedy streams equal the base engine's, a nonzero one's
   differ; decode with it against the flash forward with it (f32, relative
   L2 1e-4, with the off-by-one control); MultiplexedLoraService over 3
   adapter ids with 2 resident, sharing the base's storage; the decode
   step's time with and without an adapter.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without CUDA the script exits non-zero and
prints no result.

    python3 chip_smoke.py --compare DIR

times the kernels of the checkout in DIR (for example the parent commit,
unpacked there with `git archive`) and of this one in turns, DIR, this,
this, DIR, at the timed shapes, then the 410m train step with its profile
(step ms, device busy ms, idle share, flash attention's device ms), one
process each, and prints one {"phase": "compare", ...} line per run.

    python3 chip_smoke.py --serve-sweep 1,1.5,2,3 60

runs the 410m engine's load window at each rate (requests/s) with that
many requests, to find the rate it sustains; the serve_410m line holds the
last rate's window and the others under "sweep".
"""

from __future__ import annotations

import contextlib
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


def _train(cfg, params_np, batch_np, device, steps, trainable_keys=None):
    """`steps` AdamW steps from numpy params: ({"loss", "moe_aux"} per step,
    the final state)."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    params = params_from_numpy(params_np, device=device, cfg=cfg)
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4), params,
        device=device, trainable_keys=trainable_keys)
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    history = []
    for _ in range(steps):
        state, aux = step(state, batch)
        history.append({k: aux[k].item() for k in ("loss", "moe_aux")})
    return history, state


def _losses(history: list, key: str = "loss") -> list:
    return [h[key] for h in history]


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
    card = _losses(_train(cfg, params_np, batch, "cuda", 3)[0])
    counts = dict(launches)
    cpu = _losses(_train(cfg, params_np, batch, "cpu", 3)[0])
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    # f32 throughout, TF32 off: only summation order differs
    ok = rel <= 1e-4 and all(counts[n] > 0 for n in counts)
    emit("train_parity", card_losses=card, cpu_losses=cpu, max_rel_diff=rel,
         tolerance=1e-4, launches=counts, ok=ok)
    if not ok:
        raise AssertionError("card and CPU train trajectories differ")


BATCH_410M, SEQ_410M = 8, 2048


def config_410m(**overrides):
    """The 410m preset as the train phases run it: s2048, remat "dots",
    flash attention."""
    from ray_tpu_torch.models import llama

    return llama.config_for("410m", max_seq_len=SEQ_410M, remat=True,
                            remat_policy="dots", attn_impl="flash",
                            **overrides)


def run_410m_steps(cfg, params: dict, steps: int,
                   trainable_keys=None) -> dict:
    """build_train_step over `params` (consumed: the step holds its own
    copy), 2 warm-up steps, then `steps` timed steps on one random batch
    from a seed, with the launch counters and the peak memory read over the
    timed steps only. Returns the readings and the step, state and batch."""
    import gc

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4), params,
        trainable_keys=trainable_keys)
    params.clear()
    gc.collect()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH_410M, SEQ_410M),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    losses, moe_aux = [], []
    for _ in range(2):                                   # warm-up
        state, aux = step(state, batch)
        losses.append(aux["loss"].item())
        moe_aux.append(aux["moe_aux"].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                                     # counts: main path only
    t0 = time.perf_counter()
    for _ in range(steps):
        state, aux = step(state, batch)
        losses.append(aux["loss"].item())
        moe_aux.append(aux["moe_aux"].item())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # remat "dots" saves matmul outputs only, so the backward reruns each
    # block's flash forward: 2 forward launches per layer, 1 dq, 1 dkv
    want = {"flash_fwd": 2 * cfg.n_layers * steps,
            "flash_bwd_dq": cfg.n_layers * steps,
            "flash_bwd_dkv": cfg.n_layers * steps}
    return {"losses": losses, "moe_aux": moe_aux,
            "step_ms": dt / steps * 1e3,
            "tokens_per_s": BATCH_410M * SEQ_410M * steps / dt,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": dict(launches), "expected_launches": want,
            "step": step, "state": state, "batch": batch}


def _check_410m_run(phase: str, run: dict) -> None:
    losses = run["losses"]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} losses not finite and falling: {losses}")
    if run["launches"] != run["expected_launches"]:
        raise AssertionError(f"{phase} launch counts {run['launches']} != "
                             f"expected {run['expected_launches']}")


def phase_train_410m(device_name: str, steps: int) -> dict:
    from ray_tpu_torch.models import llama

    cfg = config_410m()
    run = run_410m_steps(cfg, llama.init_params(cfg, seed=0), steps)
    peak_flops, _ = peaks(device_name)
    mfu = run["tokens_per_s"] * cfg.flops_per_token() / peak_flops
    emit("train_410m", losses=run["losses"], step_ms=run["step_ms"],
         tokens_per_s=run["tokens_per_s"], mfu=mfu, peak_flops=peak_flops,
         flops_per_token=cfg.flops_per_token(),
         peak_mem_gb=run["peak_mem_gb"], launches=run["launches"],
         expected_launches=run["expected_launches"], steps=steps,
         batch=BATCH_410M, seq=SEQ_410M, n_layers=cfg.n_layers)
    _check_410m_run("410m", run)
    return {"launches": run["launches"], "step_ms": run["step_ms"],
            "tokens_per_s": run["tokens_per_s"], "mfu": mfu,
            "peak_mem_gb": run["peak_mem_gb"],
            **profile_step(run["step"], run["state"], run["batch"])}


def _kernel_group(name: str) -> str:
    lowered = name.lower()
    if "flash_" in lowered:
        return "flash attention (ours)"
    if any(t in lowered for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "adam" in lowered or "multi_tensor" in lowered:
        return "optimizer"
    return "elementwise, reductions, copies"


def profile_step(step, state, batch, phase: str = "profile_410m") -> dict:
    """Device time by kernel over one traced 410m step: where the time goes
    and how long the card sits idle."""
    return profile_call(lambda: step(state, batch), phase)


def profile_call(fn, phase: str, op_group=None) -> dict:
    """Device time by kernel group over one traced call of fn, and the
    card's idle share of the call's wall time; emitted as `phase`. With
    `op_group(op_event) -> label or None`, the trace also records input
    shapes, and the device time of the kernels each operator launched
    itself is summed by label into "ops_ms"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=op_group is not None) as prof:
        t0 = time.perf_counter()
        fn()
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
    if op_group is not None:
        ops: dict[str, float] = {}
        for ev in prof.events():
            label = (op_group(ev) if ev.device_type == DeviceType.CPU
                     else None)
            if label is not None:
                ops[label] = ops.get(label, 0.0) + (
                    ev.self_device_time_total / 1e3)
        res["ops_ms"] = ops
    emit(phase, **res, launches_traced=sum(n for _, _, n in rows),
         top=[{"kernel": name[:90], "ms": ms, "calls": n}
              for name, ms, n in rows[:12]])
    return res


# ----------------------------------------------------------------- serving
@contextlib.contextmanager
def f32_presets(llama):
    """llama.config_for returning dtype=float32 unless told otherwise: the
    debug preset in f32, wrapped the way the CPU tests wrap it."""
    import torch

    config_for = llama.config_for
    llama.config_for = lambda name, **kw: config_for(
        name, **{"dtype": torch.float32, **kw})
    try:
        yield
    finally:
        llama.config_for = config_for


async def _agen_list(agen) -> list:
    return [t async for t in agen]


def _decode_case(llama, params_np, cfg, cache_np, token_calls, device):
    """decode_step over `token_calls` from one starting cache on `device`:
    (logits of each call, final cache), on the CPU."""
    import torch

    from ray_tpu_torch.models.convert import params_from_numpy

    params = params_from_numpy(params_np, device=device, cfg=cfg)
    cache = {k: torch.from_numpy(v.copy()).to(device)
             for k, v in cache_np.items()}
    logits = []
    with torch.inference_mode():
        for tokens in token_calls:
            out, cache = llama.decode_step(
                params, cache, torch.from_numpy(tokens).to(device), cfg)
            logits.append(out.cpu())
    return logits, {k: v.cpu() for k, v in cache.items()}


def _decode_cases(cfg, rng) -> dict:
    """name -> (starting cache, token calls): a left-padded batch (two rows,
    different starts), per-row depths over a cache of random contents, and
    a prefill in three chunks."""
    import numpy as np

    def shape(b, n):
        return (cfg.n_layers, b, n, cfg.n_kv_heads, cfg.head_dim)

    def toks(b, s):
        return rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)

    def zeros(b, n, length, start):
        return {"k": np.zeros(shape(b, n), np.float32),
                "v": np.zeros(shape(b, n), np.float32),
                "length": np.asarray(length, np.int32),
                "start": np.asarray(start, np.int32)}

    padded = toks(2, 16)
    padded[0, :5] = 0
    per_row = zeros(3, 48, [7, 20, 0], [0, 3, 0])
    per_row["k"] = rng.standard_normal(shape(3, 48)).astype(np.float32)
    per_row["v"] = rng.standard_normal(shape(3, 48)).astype(np.float32)
    prompt = toks(1, 48)
    prompt[0, :6] = 0
    return {
        "left_padded": (zeros(2, 64, 0, [5, 0]),
                        [padded] + [toks(2, 1) for _ in range(4)]),
        "per_row_depths": (per_row, [toks(3, 1) for _ in range(4)]),
        "chunked_prefill": (zeros(1, 64, 0, [6]),
                            [prompt[:, i:i + 16] for i in (0, 16, 32)]),
    }


def collect(engine, tokens, **kw) -> list:
    """One generate() stream, in its own event loop."""
    import asyncio

    return asyncio.run(_agen_list(engine.generate(tokens, **kw)))


def serve_scenarios() -> dict:
    """name -> (engine kwargs, run): the engine paths whose greedy streams
    chip_smoke holds card vs CPU and tests/test_torch_serve_llm.py holds
    against the JAX package's engine. run(make) -> (streams, facts), where
    make(**overrides) builds a fresh engine with the scenario's kwargs;
    facts are counters and checks the callers assert on."""
    import asyncio

    import numpy as np

    def one(make):
        return [collect(make(), [5, 9, 11, 42, 7], max_new_tokens=8)], {}

    rng = np.random.default_rng(0)
    three = [rng.integers(1, 256, n).tolist() for n in (3, 11, 25)]

    def concurrent(make):
        eng = make()

        async def run():
            return await asyncio.gather(*[
                _agen_list(eng.generate(p, max_new_tokens=6))
                for p in three])
        out = asyncio.run(run())
        alone = collect(make(), three[1], max_new_tokens=6)
        return out, {"prefills": eng.prefills, "batches": eng.batches,
                     "alone_equals_batched": alone == out[1]}

    def chunked(make):
        eng = make()

        async def run():
            chunks_at_token = []

            async def consume_first():
                out = []
                async for t in eng.generate([1, 2, 3], max_new_tokens=40):
                    out.append(t)
                    chunks_at_token.append(eng.prefill_chunks)
                return out

            first = asyncio.ensure_future(consume_first())
            while eng.batches < 3:
                await asyncio.sleep(0.001)
            # a long prompt: bucket 512, chunk 64; the 192 leading pad
            # tokens are skipped, leaving ceil(320/64) = 5 chunk rounds
            late = await _agen_list(eng.generate(
                [1 + i % 255 for i in range(300)], max_new_tokens=3))
            return [await first, late], chunks_at_token
        out, chunks_at_token = asyncio.run(run())
        prompt = [5, 9, 11, 42, 7] * 30           # 150 tokens -> bucket 512
        mono = collect(make(prefill_chunk=0), prompt, max_new_tokens=6)
        split = collect(make(), prompt, max_new_tokens=6)
        return out + [split], {
            "prefill_chunks": eng.prefill_chunks,
            "interleaved": any(0 < c < 5 for c in chunks_at_token),
            "chunked_equals_monolithic": mono == split}

    rng = np.random.default_rng(1)
    prefix = rng.integers(1, 256, 32).tolist()
    first = prefix + rng.integers(1, 256, 8).tolist()      # start 88
    second = prefix + rng.integers(1, 256, 20).tolist()    # start 76

    def prefix_hit(make):
        eng = make()
        cold_first = collect(eng, first, max_new_tokens=6)
        after_first = eng.stats()
        warm_second = collect(eng, second, max_new_tokens=6)
        after_second = eng.stats()
        again = collect(eng, first, max_new_tokens=6)
        return [cold_first, warm_second], {
            "misses_after_first": after_first["prefix_misses"],
            "entries_after_first": after_first["prefix_entries"],
            "hits": after_second["prefix_hits"],
            "hit_tokens": after_second["prefix_hit_tokens"],
            "warm_equals_cold": warm_second == collect(
                make(), second, max_new_tokens=6),
            "again_equals_first": again == cold_first,
            "hits_after_again": eng.prefix_hits}

    handoff_prompt = list(range(3, 28))

    def handoff(make):
        import torch

        prefill_eng, decode_eng = make(), make()

        async def run():
            h = await prefill_eng.prefill_only(handoff_prompt)
            before = {k: h[k].clone() for k in ("k", "v")}
            out = await _agen_list(decode_eng.generate_prefilled(
                handoff_prompt, h, max_new_tokens=8))
            # more traffic on both engines; the payload must not change
            await _agen_list(prefill_eng.generate(handoff_prompt[:5],
                                                  max_new_tokens=4))
            await _agen_list(decode_eng.generate(handoff_prompt[:7],
                                                 max_new_tokens=4))
            unchanged = all(torch.equal(h[k], before[k]) for k in before)
            shared = any(
                h[k].untyped_storage().data_ptr()
                == e._decode_cache[k].untyped_storage().data_ptr()
                for k in before for e in (prefill_eng, decode_eng))
            return h, out, unchanged, shared
        h, out, unchanged, shared = asyncio.run(run())
        return [out], {
            "kv_handoffs": decode_eng.kv_handoffs,
            "payload_keys": sorted(h), "first_streams_first":
            out[0] == h["first"], "payload_unchanged": unchanged,
            "payload_shares_a_cache": shared,
            "equals_generate": out == collect(make(), handoff_prompt,
                                              max_new_tokens=8)}

    reuse = [[4, 5, 6], [7, 8, 9]]           # the second takes slot 1

    def overrun(make):
        eng = make()

        async def run():      # one event loop: a new one rebuilds the cache
            for first_tok in (1, 2, 3):  # 7 decode steps each, slot 1 free
                await _agen_list(eng.generate([first_tok, 2, 3],
                                              max_new_tokens=8))
            facts = {"free_steps": eng.batches,
                     "free_slot_depth": int(eng._decode_cache["length"][1])}
            return await asyncio.gather(*[
                _agen_list(eng.generate(r, max_new_tokens=8))
                for r in reuse]), facts

        async def fresh():
            f = make()
            return await asyncio.gather(*[
                _agen_list(f.generate(r, max_new_tokens=8)) for r in reuse])
        out, facts = asyncio.run(run())
        return out, {**facts, "max_len": 16,
                     "equals_fresh": out == asyncio.run(fresh())}

    return {
        "one_request": ({"max_batch": 4}, one),
        "three_concurrent": ({"max_batch": 4}, concurrent),
        "chunked_long_prompt": ({"max_batch": 4, "max_seq_len": 1024,
                                 "prompt_buckets": (32, 512),
                                 "prefill_chunk": 64}, chunked),
        "prefix_hit": ({"max_batch": 2, "max_seq_len": 256,
                        "prompt_buckets": (32, 128)}, prefix_hit),
        "prefill_only_handoff": ({"max_batch": 4}, handoff),
        "free_slot_overrun_reuse": ({"max_batch": 2, "max_seq_len": 16},
                                    overrun),
    }


def phase_serve_parity(device: str = "cuda") -> None:
    """The debug model in f32 with TF32 off: decode_step logits and cache,
    and the engine's greedy streams, on the card against the CPU."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_to_numpy
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = 1e-4
    rng = np.random.default_rng(0)
    with f32_presets(llama):
        cfg = llama.config_for("debug")
        params_np = params_to_numpy(llama.init_params(cfg, seed=0,
                                                      device="cpu"))
        decode = {}
        for name, (cache_np, calls) in _decode_cases(cfg, rng).items():
            card = _decode_case(llama, params_np, cfg, cache_np, calls, device)
            cpu = _decode_case(llama, params_np, cfg, cache_np, calls, "cpu")
            errs = [_allclose_err(a, b, tol) for a, b in zip(card[0], cpu[0])]
            errs += [_allclose_err(card[1][k], cpu[1][k], tol)
                     for k in ("k", "v")]
            decode[name] = {"allclose_ratio": max(errs),
                            "length_equal": torch.equal(card[1]["length"],
                                                        cpu[1]["length"])}
        streams = {}
        for name, (kw, run) in serve_scenarios().items():
            out = {}
            for dev in (device, "cpu"):
                out[dev] = run(lambda dev=dev, kw=kw, **o: LLMEngine(
                    "debug", params=params_np, device=dev, **{**kw, **o}))
            (card, card_facts), (cpu, cpu_facts) = out[device], out["cpu"]
            streams[name] = {"equal": card == cpu, "card": card_facts,
                             "cpu": cpu_facts,
                             "lengths": [len(s) for s in card]}
    bad = [n for n, r in decode.items()
           if not (r["allclose_ratio"] <= 1.0 and r["length_equal"])]
    bad += [n for n, r in streams.items() if not r["equal"]]
    facts = {n: r["card"] for n, r in streams.items()}
    overrun = facts["free_slot_overrun_reuse"]
    bad += [n for n, ok in (
        ("three_concurrent", facts["three_concurrent"]["prefills"] == 3
         and facts["three_concurrent"]["alone_equals_batched"]),
        ("chunked_long_prompt",
         facts["chunked_long_prompt"]["prefill_chunks"] == 5
         and facts["chunked_long_prompt"]["chunked_equals_monolithic"]),
        ("prefix_hit", facts["prefix_hit"]["hits"] == 1
         and facts["prefix_hit"]["warm_equals_cold"]),
        ("prefill_only_handoff", facts["prefill_only_handoff"]["kv_handoffs"]
         == 1 and facts["prefill_only_handoff"]["equals_generate"]
         and facts["prefill_only_handoff"]["payload_unchanged"]
         and not facts["prefill_only_handoff"]["payload_shares_a_cache"]),
        # slot 1 sat free for more steps than its cache holds, at depth 0
        ("free_slot_overrun_reuse", overrun["equals_fresh"]
         and overrun["free_steps"] > overrun["max_len"]
         and overrun["free_slot_depth"] == 0),
    ) if not ok]
    emit("serve_parity", decode_step=decode, engine=streams, tolerance=tol,
         ok=not bad)
    if bad:
        raise AssertionError(f"serve parity card vs CPU failed: {bad}")


def _percentiles(xs: list) -> dict:
    qs = statistics.quantiles(xs, n=100, method="inclusive")
    return {"p50_ms": statistics.median(xs) * 1e3, "p99_ms": qs[98] * 1e3,
            "n": len(xs)}


def phase_serve_410m(device: str = "cuda") -> dict:
    """The 410m preset at full width and depth, bf16 as served: decode_step
    against the flash forward, the engine's late-join check, its load
    window, and its decode step timed and traced."""
    from ray_tpu_torch.models import llama

    cfg = llama.config_for("410m")
    params = llama.init_params(cfg, seed=0, device=device)
    serve_vs_flash(cfg, params, device)
    return serve_engine_run(cfg, params, device)


def _decode_vs_forward(cfg, params, tokens,
                       prompt: int) -> tuple[list, list, dict, list]:
    """decode_step over tokens[:, :prompt] then one token a step, against
    forward(attn_impl="flash") at the same positions: (relative L2 per
    position, the same for the dense forward against the flash one, the
    flash launches of that forward, a control's relative L2). The control
    decodes with every position after the prompt one too far (the cache's
    depth bumped by one, so rope is off by one and an unwritten slot is
    visible): a fault the limit must catch."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches

    def decode(bump: int) -> list:
        cache = llama.init_kv_cache(cfg, 1, device=tokens.device)
        out, cache = llama.decode_step(params, cache, tokens[:, :prompt], cfg)
        cache["length"] = cache["length"] + bump
        rows = [out]
        for i in range(prompt, tokens.shape[1]):
            out, cache = llama.decode_step(params, cache, tokens[:, i:i + 1],
                                           cfg)
            rows.append(out)
        return rows

    with torch.inference_mode():
        dec, wrong = decode(0), decode(1)
        reset_launches()
        fwd = llama.forward(params, tokens, dataclasses.replace(
            cfg, attn_impl="flash", remat=False))[0, prompt - 1:]
        fwd_launches = dict(launches)
        dense = llama.forward(params, tokens, dataclasses.replace(
            cfg, attn_impl="xla", remat=False))[0, prompt - 1:]
    return ([_rel_l2(d[0], f) for d, f in zip(dec, fwd)],
            [_rel_l2(a, b) for a, b in zip(dense, fwd)], fwd_launches,
            [_rel_l2(w[0], f) for w, f in zip(wrong[1:], fwd[1:])])


def serve_vs_flash(cfg, params, device: str = "cuda") -> dict:
    """decode_step (a 1024-token prefill, then 8 teacher-forced steps)
    against forward(attn_impl="flash") at the same positions. The check is
    made in f32 with TF32 off, at relative L2 1e-4, where a wrong decode
    (the off-by-one control) reads far above the limit; the bf16 reading,
    as served, is printed beside it with its own control."""
    import dataclasses

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1032), generator=gen,
                           device=device)
    tol = 1e-4
    res = {}
    for name, c in (("f32", dataclasses.replace(cfg, dtype=torch.float32)),
                    ("bf16", cfg)):
        rel, floor, fwd_launches, control = _decode_vs_forward(
            c, params, tokens, 1024)
        res[name] = {"rel_l2": rel, "dense_forward_vs_flash_rel_l2": floor,
                     "control_rel_l2": control,
                     "flash_launches": fwd_launches}
    f32 = res["f32"]
    ok = (max(f32["rel_l2"]) <= tol and min(f32["control_rel_l2"]) > tol
          and all(r["flash_launches"]["flash_fwd"] == cfg.n_layers
                  for r in res.values()))
    emit("serve_410m_vs_flash", positions=list(range(1023, 1032)),
         tolerance_f32=tol, expected_flash_fwd=cfg.n_layers, **res, ok=ok)
    if not ok:
        raise AssertionError(f"decode_step vs flash forward: {res}")
    return res


def _cache_finite(eng) -> bool:
    return all(bool(eng._decode_cache[k].isfinite().all()) for k in "kv")


def serve_late_join(eng, cfg) -> dict:
    """A correctness check of continuous batching, not a measurement: 7
    concurrent greedy requests (prompts of 100-1000 tokens, 64 new tokens),
    then a late 32-token request (3 new tokens) into the eighth slot while
    they decode. Every stream must be complete, the late one done within 6
    decode steps while the others still run, and the cache finite."""
    import asyncio

    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(100, 1001, 7).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    late_prompt = rng.integers(0, cfg.vocab_size, 32).tolist()
    new_tokens, late_new = 64, 3

    async def run():
        tasks = [asyncio.ensure_future(_agen_list(
            eng.generate(p, max_new_tokens=new_tokens))) for p in prompts]
        while sum(s is not None and s.emitted > 0
                  for s in eng._slots) < len(prompts):   # all 7 decoding
            await asyncio.sleep(0.001)
        steps_before = eng.batches
        late = await _agen_list(eng.generate(late_prompt,
                                             max_new_tokens=late_new))
        steps_for_late = eng.batches - steps_before
        others_running = not all(t.done() for t in tasks)
        return (await asyncio.gather(*tasks), late, steps_for_late,
                others_running)

    streams, late, steps_for_late, others_running = asyncio.run(run())
    finite = _cache_finite(eng)
    res = {"prompt_lengths": lengths,
           "stream_lengths": [len(x) for x in streams],
           "late_stream_length": len(late), "late_decode_steps": steps_for_late,
           "others_running_when_late_done": others_running,
           "cache_finite": finite}
    ok = (res["stream_lengths"] == [new_tokens] * len(prompts)
          and len(late) == late_new and steps_for_late <= 6
          and others_running and finite)
    emit("serve_410m_late_join", **res, ok=ok)
    if not ok:
        raise AssertionError(f"410m late-join check failed: {res}")
    return res


def serve_traffic(vocab: int, n: int, rate: float, seed: int) -> list:
    """n requests (arrival s, prompt ids, new tokens) on an open loop:
    Poisson arrivals at `rate` requests/s, and heavy-tailed lengths with
    prompts longer than answers. Prompt tokens: log-normal, median 256,
    sigma 0.9, in [16, 1024]. New tokens: log-normal, median 48, sigma 0.7,
    in [8, 256]. The mix is a choice for this engine's buckets, fitted to
    no public trace."""
    import numpy as np

    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    prompt_n = np.clip(rng.lognormal(np.log(256), 0.9, n), 16, 1024)
    new_n = np.clip(rng.lognormal(np.log(48), 0.7, n), 8, 256)
    return [(float(t), rng.integers(0, vocab, int(p)).tolist(), int(m))
            for t, p, m in zip(arrivals, prompt_n, new_n)]


def serve_load(eng, cfg, n: int, rate: float, seed: int = 0) -> dict:
    """Drive the engine with serve_traffic(n, rate) and read each request's
    phase stamps from the engine's own observation dict (the request-obs
    contextvar a Serve replica sets): TTFT = first token - submit, TPOT =
    (last - first token) / (tokens - 1), queue and prefill time. Gaps
    between tokens are stamped where the consumer receives them."""
    import asyncio

    from ray_tpu_torch.serve.request_context import (_reset_request_obs,
                                                     _set_request_obs)

    traffic = serve_traffic(cfg.vocab_size, n, rate, seed)
    obs = [{} for _ in traffic]
    arrived: list[list[float]] = [[] for _ in traffic]

    async def one(i, t0):
        at, prompt, new = traffic[i]
        await asyncio.sleep(max(0.0, t0 + at - time.perf_counter()))
        token = _set_request_obs(obs[i])
        try:
            async for _ in eng.generate(prompt, max_new_tokens=new):
                arrived[i].append(time.perf_counter())
        finally:
            _reset_request_obs(token)

    async def run():
        await eng.ensure_started()
        t0 = time.perf_counter()
        await asyncio.gather(*[one(i, t0) for i in range(len(traffic))])
        return time.perf_counter() - t0

    before = eng.stats()
    wall = asyncio.run(run())
    after = eng.stats()
    tokens = [len(a) for a in arrived]
    ttft = [o["first_token"] - o["gen_start"] for o in obs]
    tpot = [(o["last_token"] - o["first_token"]) / (o["tokens"] - 1)
            for o in obs if o["tokens"] > 1]
    itl = [b - a for ts in arrived for a, b in zip(ts, ts[1:])]
    occupancy = [o["occupancy_sum"] / o["decode_steps"] for o in obs
                 if o.get("decode_steps")]
    return {
        "requests": n, "rate_per_s": rate, "seed": seed,
        "offered_s": traffic[-1][0], "wall_s": wall,
        "complete": tokens == [m for _, _, m in traffic],
        "cache_finite": _cache_finite(eng),
        "prompt_tokens": sum(len(p) for _, p, _ in traffic),
        "generated_tokens_per_s": sum(tokens) / wall,
        "completed_per_s": n / wall,
        "ttft": _percentiles(ttft), "tpot": _percentiles(tpot),
        "inter_token": _percentiles(itl),
        "queue": _percentiles([o["queue_s"] for o in obs]),
        "prefill": _percentiles([o.get("prefill_s", 0.0) for o in obs]),
        "mean_occupancy": statistics.mean(occupancy),
        **{k: after[k] - before[k] for k in
           ("prefills", "prefill_chunks", "batches", "generated_tokens")}}


SERVE_REQUESTS = 200
# requests/s: four fifths of the ~2/s the engine sustains at the 410m
# preset on an H100 (--serve-sweep 1,1.5,2,3 60), where the tails are judged
SERVE_RATE = 1.6


def serve_engine_run(cfg, params, device: str = "cuda",
                     rates: tuple = (SERVE_RATE,),
                     n: int = SERVE_REQUESTS) -> dict:
    """LLMEngine at the 410m preset: the late-join check, then the load
    window at each rate, then the engine's decode step alone (all 8 slots;
    its dense attention reads the whole cache whatever the depths) timed
    on this thread and on an executor thread, as the engine runs it, and
    traced."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine("410m", max_batch=8, prompt_buckets=(128, 512, 1024),
                    prefill_chunk=256, params=params, device=device)
    # warm-up: every bucket's prefill, chunked and not, and decode steps
    for i, m in enumerate((100, 400, 1000)):
        collect(eng, [1 + i] * m, max_new_tokens=4)
    serve_late_join(eng, cfg)
    reset_launches()
    loads = []
    for rate in rates:
        # each asyncio.run leaves its cancelled tasks' frames in reference
        # cycles, with whatever those frames hold: collect them first
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        load = serve_load(eng, cfg, n, rate)
        load["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        loads.append(load)
    engine_launches = dict(launches)

    def one_step():
        eng._decode_step_all(eng._epoch)

    def timed(call) -> dict:
        step_s = []
        for _ in range(23):
            t0 = time.perf_counter()
            call()
            step_s.append(time.perf_counter() - t0)
        return _percentiles(step_s[3:])
    with ThreadPoolExecutor(1) as pool:
        step_thread = timed(lambda: pool.submit(one_step).result())
    step_main = timed(one_step)
    prof = profile_call(one_step, "profile_serve_decode_step")
    res = {**loads[-1], "sweep": loads[:-1],
           "decode_step": step_main,
           "decode_step_executor_thread": step_thread,
           "launches": engine_launches,
           "traced_decode_step": {k: prof[k] for k in (
               "traced_step_wall_ms", "device_busy_ms",
               "device_idle_share")},
           "max_batch": 8, "prompt_buckets": [128, 512, 1024],
           "prefill_chunk": 256, "n_layers": cfg.n_layers}
    ok = all(x["complete"] and x["cache_finite"] for x in loads)
    emit("serve_410m", **res, ok=ok)
    if not ok:
        raise AssertionError(f"410m engine run failed its checks: {res}")
    return res


# ------------------------------------------------------------ LoRA and MoE
LORA_RANK_410M = 16      # bench.py's LoRA leg: rank 16 on wq wk wv wo


def lora_numpy(cfg, rank: int, targets: tuple, seed: int,
               b_scale: float) -> dict:
    """An adapter subtree as numpy: A ~ N(0, 1/r), B ~ N(0, b_scale)."""
    import numpy as np

    from ray_tpu_torch.models.lora import _target_dims

    rng = np.random.default_rng(seed)
    layers = {}
    for name in targets:
        d_in, d_out = _target_dims(cfg, name)
        layers[name + "_a"] = (rng.standard_normal(
            (cfg.n_layers, d_in, rank)) / np.sqrt(rank)).astype(np.float32)
        layers[name + "_b"] = (b_scale * rng.standard_normal(
            (cfg.n_layers, rank, d_out))).astype(np.float32)
    return {"layers": layers}


def nonzero_adapter(cfg, rank: int, seed: int, b_std: float,
                    device: str = "cuda") -> dict:
    """init_lora_params (A ~ N(0, 1/r), B = 0) with B drawn N(0, b_std):
    an adapter as training would leave it."""
    import torch

    from ray_tpu_torch.models import lora

    adapter = lora.init_lora_params(
        cfg, lora.LoraConfig(rank=rank, alpha=cfg.lora_alpha), seed=seed,
        device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for key, b in adapter["layers"].items():
        if key.endswith("_b"):
            b.normal_(0.0, b_std, generator=gen)
    return adapter


def base_checksum(tree: dict) -> int:
    """An exact checksum of a tree of f32 tensors: the sum of their bits as
    int32, in int64. Any write that changes a bit moves it (bar collisions
    a test could not stage by accident)."""
    import torch

    total = torch.zeros((), dtype=torch.int64, device="cuda")
    for leaf in _tree_leaves(tree):
        total += leaf.detach().contiguous().view(torch.int32).sum(
            dtype=torch.int64)
    return int(total)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


@contextlib.contextmanager
def moe_margins(llama):
    """Record the routing margin of every MoE layer the model runs inside
    the block: the smallest gap between the k-th and (k+1)-th router
    probability over its tokens, in f64 from the layer's own input. A gap
    below the comparison's tolerance could flip a token's expert between
    two devices. Yields the list the margins land in."""
    import torch

    ffn, margins = llama.moe_ffn, []

    def spy(params, x, cfg, **kw):
        logits = x.detach().double() @ params["router"].detach().double()
        top = torch.softmax(logits, -1).sort(-1, descending=True).values
        margins.append(float((top[..., cfg.top_k - 1]
                              - top[..., cfg.top_k]).min()))
        return ffn(params, x, cfg, **kw)

    llama.moe_ffn = spy
    try:
        yield margins
    finally:
        llama.moe_ffn = ffn


def _parity_batch(cfg, b: int = 4):
    import numpy as np

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, cfg.max_seq_len))
    return {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}


def phase_lora_parity(device: str = "cuda") -> None:
    """The debug preset in f32 (TF32 off, flash, remat "dots") with a
    nonzero rank-4 adapter on all seven targets: 3 frozen-base AdamW steps
    card vs CPU, the base bit-identical after them on the card, and
    decode_step with the adapter (a chunked prefill, then 4 steps) card vs
    CPU."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = 1e-4
    cfg = llama.config_for("debug", dtype=torch.float32, attn_impl="flash",
                           remat=True, remat_policy="dots")
    targets = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    tree = {**params_to_numpy(llama.init_params(cfg, seed=0, device="cpu")),
            "lora": lora_numpy(cfg, 4, targets, seed=1, b_scale=0.05)}
    batch = _parity_batch(cfg)
    base = {k: v for k, v in params_from_numpy(tree, device=device,
                                               cfg=cfg).items()
            if k != "lora"}
    reset_launches()
    card, state = _train(cfg, tree, batch, device, 3, trainable_keys=("lora",))
    counts = dict(launches)
    cpu, _ = _train(cfg, tree, batch, "cpu", 3, trainable_keys=("lora",))
    card, cpu = _losses(card), _losses(cpu)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    frozen = {name: all(torch.equal(a, b) for a, b in zip(
        _tree_leaves(state["frozen"][name]), _tree_leaves(base[name])))
        for name in base}
    no_grad = all(t.grad is None for t in _tree_leaves(state["frozen"]))
    rng = np.random.default_rng(2)
    cache_np, calls = _decode_cases(cfg, rng)["chunked_prefill"]
    calls = calls + [rng.integers(1, cfg.vocab_size, (1, 1)).astype(np.int32)
                     for _ in range(4)]
    card_dec = _decode_case(llama, tree, cfg, cache_np, calls, device)
    cpu_dec = _decode_case(llama, tree, cfg, cache_np, calls, "cpu")
    dec_err = max(_allclose_err(a, b, tol)
                  for a, b in zip(card_dec[0], cpu_dec[0]))
    ok = (rel <= tol and all(frozen.values()) and no_grad
          and all(counts[n] > 0 for n in counts) and dec_err <= 1.0
          and card[-1] < card[0])
    emit("lora_parity", card_losses=card, cpu_losses=cpu, max_rel_diff=rel,
         tolerance=tol, base_bit_identical=frozen, frozen_have_no_grad=no_grad,
         launches=counts, decode_allclose_ratio=dec_err,
         decode_calls=len(calls), rank=4, targets=list(targets), ok=ok)
    if not ok:
        raise AssertionError("LoRA parity card vs CPU failed")


def phase_moe_parity(device: str = "cuda") -> None:
    """The debug preset with 4 experts, top-2, in f32 (TF32 off, flash,
    remat "dots"): 3 AdamW steps card vs CPU, losses and moe_aux."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tol = 1e-4
    cfg = llama.config_for("debug", dtype=torch.float32, attn_impl="flash",
                           remat=True, remat_policy="dots",
                           moe_num_experts=4, moe_top_k=2)
    params_np = params_to_numpy(llama.init_params(cfg, seed=0, device="cpu"))
    batch = _parity_batch(cfg)
    with moe_margins(llama) as margins, torch.no_grad():
        llama.forward(params_from_numpy(params_np, device="cpu", cfg=cfg),
                      torch.from_numpy(batch["tokens"]), cfg)
    card, _ = _train(cfg, params_np, batch, device, 3)
    cpu, _ = _train(cfg, params_np, batch, "cpu", 3)
    rel = {key: max(abs(a - b) / abs(b) for a, b in zip(
        _losses(card, key), _losses(cpu, key))) for key in ("loss", "moe_aux")}
    ok = (max(rel.values()) <= tol and min(_losses(card, "moe_aux")) > 0
          and card[-1]["loss"] < card[0]["loss"])
    emit("moe_parity", card=card, cpu=cpu, max_rel_diff=rel, tolerance=tol,
         routing_margin_min=min(margins), experts=4, top_k=2, ok=ok)
    if not ok:
        raise AssertionError("MoE parity card vs CPU failed")


def phase_lora_train_410m(device_name: str, steps: int, full: dict) -> dict:
    """The 410m train step with a rank-16 adapter on wq wk wv wo (bench.py's
    LoRA leg) and trainable_keys=("lora",); `full` holds the full train
    step's readings from this run, printed beside."""
    import gc

    import torch

    from ray_tpu_torch.models import llama, lora

    cfg = config_410m()
    params = llama.init_params(cfg, seed=0)
    params["lora"] = lora.init_lora_params(
        cfg, lora.LoraConfig(rank=LORA_RANK_410M, alpha=cfg.lora_alpha),
        seed=2)
    before = base_checksum({k: v for k, v in params.items() if k != "lora"})
    run = run_410m_steps(cfg, params, steps, trainable_keys=("lora",))
    peak_flops, _ = peaks(device_name)
    # the frozen base takes no weight gradients: ~2N of the 6N FLOPs a
    # token are not computed (bench.py's LoRA convention)
    flops_per_token = cfg.flops_per_token() * 2 / 3
    mfu = run["tokens_per_s"] * flops_per_token / peak_flops
    prof = profile_step(run["step"], run["state"], run["batch"],
                        "profile_lora_410m")
    after = base_checksum(run["state"]["frozen"])
    n_adapter = sum(t.numel() for t in _tree_leaves(run["state"]["params"]))
    res = {"losses": run["losses"], "step_ms": run["step_ms"],
           "tokens_per_s": run["tokens_per_s"], "mfu": mfu,
           "flops_per_token": flops_per_token,
           "peak_mem_gb": run["peak_mem_gb"], "launches": run["launches"],
           "expected_launches": run["expected_launches"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_idle_share": prof["device_idle_share"],
           "groups_ms": prof["groups_ms"]}
    emit("lora_train_410m", **res, base_checksum_unchanged=before == after,
         adapter_params=n_adapter, rank=LORA_RANK_410M,
         targets=list(lora.DEFAULT_TARGETS), steps=steps, batch=BATCH_410M,
         seq=SEQ_410M, full_train_step={k: full[k] for k in (
             "step_ms", "tokens_per_s", "mfu", "peak_mem_gb",
             "device_busy_ms", "device_idle_share", "groups_ms")})
    _check_410m_run("lora_train_410m", run)
    if before != after:
        raise AssertionError("the frozen base changed during LoRA training")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return res


MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY = 8, 2, 1.25   # Mixtral-8x7B's routing


def phase_moe_train_410m(steps: int) -> dict:
    """The 410m widths with 8 experts, top-2, capacity factor 1.25 in every
    layer, AdamW over all params; the traced step's device time split into
    the dispatch/combine einsums, the expert FFN, flash and the rest."""
    import gc

    import torch

    from ray_tpu_torch.models import llama

    cfg = config_410m(moe_num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                      moe_capacity_factor=MOE_CAPACITY)
    run = run_410m_steps(cfg, llama.init_params(cfg, seed=0), steps)
    n_params = sum(t.numel() for t in _tree_leaves(run["state"]["params"]))

    def op_group(ev):
        # the einsums run as bmm: dispatch and combine contract or keep the
        # sequence axis; the grouped expert matmuls never see it
        if ev.name != "aten::bmm":
            return None
        shapes = [tuple(x) for x in (ev.input_shapes or []) if x]
        if any(SEQ_410M in shape for shape in shapes):
            return "dispatch/combine einsums"
        return "expert FFN"

    prof = profile_call(lambda: run["step"](run["state"], run["batch"]),
                        "profile_moe_410m", op_group=op_group)
    split = dict(prof["ops_ms"])
    split["flash"] = prof["groups_ms"].get("flash attention (ours)", 0.0)
    split["rest"] = prof["device_busy_ms"] - sum(split.values())
    res = {"losses": run["losses"], "moe_aux": run["moe_aux"],
           "step_ms": run["step_ms"], "tokens_per_s": run["tokens_per_s"],
           "peak_mem_gb": run["peak_mem_gb"], "launches": run["launches"],
           "expected_launches": run["expected_launches"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_idle_share": prof["device_idle_share"],
           "device_ms_split": split}
    capacity = max(1, int(MOE_CAPACITY * MOE_TOP_K * SEQ_410M / MOE_EXPERTS))
    emit("moe_train_410m", **res, params=n_params, experts=MOE_EXPERTS,
         top_k=MOE_TOP_K, capacity_factor=MOE_CAPACITY, capacity=capacity,
         steps=steps, batch=BATCH_410M, seq=SEQ_410M,
         mfu="not given: flops_per_token counts a dense FFN")
    _check_410m_run("moe_train_410m", run)
    if not min(run["moe_aux"]) > 0:
        raise AssertionError(f"moe_aux not positive: {run['moe_aux']}")
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _streams(eng, prompts: list, n: int) -> list:
    import asyncio

    async def run():
        return await asyncio.gather(*[
            _agen_list(eng.generate(p, max_new_tokens=n)) for p in prompts])
    return asyncio.run(run())


def phase_lora_serve_410m(device: str = "cuda") -> dict:
    """The 410m engine (8 slots, as serve_410m) with rank-16 adapters on the
    attention targets: a zero-B adapter's greedy streams equal the base
    engine's and a nonzero adapter's differ; decode_step with the nonzero
    adapter against the flash forward with it (f32, TF32 off, relative L2
    1e-4, with the off-by-one control); MultiplexedLoraService over 3
    adapter ids with 2 resident; decode-step ms with and without an
    adapter."""
    import asyncio
    import dataclasses
    import gc

    import numpy as np
    import torch

    from ray_tpu_torch.models import llama, lora
    from ray_tpu_torch.serve import multiplex
    from ray_tpu_torch.serve.llm import LLMEngine, MultiplexedLoraService

    cfg = llama.config_for("410m")
    base = llama.init_params(cfg, seed=0, device=device)
    zero = lora.init_lora_params(cfg, lora.LoraConfig(
        rank=LORA_RANK_410M, alpha=cfg.lora_alpha), seed=3, device=device)
    tuned = nonzero_adapter(cfg, LORA_RANK_410M, seed=4, b_std=0.01,
                            device=device)
    kw = {"max_batch": 8, "prompt_buckets": (128, 512, 1024),
          "prefill_chunk": 256, "device": device}
    engines = {name: LLMEngine("410m", params=params, **kw) for name, params
               in (("base", base), ("zero_b", {**base, "lora": zero}),
                   ("tuned", {**base, "lora": tuned}))}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 300, 700)]
    streams = {name: _streams(eng, prompts, 16)
               for name, eng in engines.items()}
    shares = all(
        eng.params["layers"][k].data_ptr() == t.data_ptr()
        for eng in engines.values() for k, t in base["layers"].items())

    def step_ms(eng) -> dict:
        times = []
        for _ in range(23):
            t0 = time.perf_counter()
            eng._decode_step_all(eng._epoch)
            times.append(time.perf_counter() - t0)
        return _percentiles(times[3:])
    decode_ms = {name: step_ms(engines[name]) for name in ("base", "tuned")}

    # decode vs the flash forward with the adapter, in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1032), generator=gen,
                           device=device)
    rel, floor, fwd_launches, control = _decode_vs_forward(
        dataclasses.replace(cfg, dtype=torch.float32),
        {**base, "lora": tuned}, tokens, 1024)
    tol = 1e-4
    engines.clear()
    gc.collect()

    # three adapter ids through an LRU of two engines
    svc = MultiplexedLoraService("410m", max_adapters_per_replica=2,
                                 lora_rank=LORA_RANK_410M, seed=0, **kw)

    async def serve(model_id: str, prompt: list) -> list:
        token = multiplex._set_model_id(model_id)
        try:
            return [d async for d in svc({"tokens": prompt,
                                          "max_new_tokens": 8})]
        finally:
            multiplex._reset_model_id(token)

    mux = [asyncio.run(serve(i, prompts[0])) for i in ("a", "b", "c")]
    resident = multiplex.loaded_model_ids(svc, "get_engine")
    mux_engines = [asyncio.run(svc.get_engine(i)) for i in resident]
    mux_shares = all(
        eng.params["layers"][k].data_ptr() == t.data_ptr()
        for eng in mux_engines for k, t in svc._base["layers"].items())
    tagged = all({d["adapter"] for d in items} == {i}
                 for items, i in zip(mux, "abc"))
    res = {"zero_b_equals_base": streams["zero_b"] == streams["base"],
           "tuned_differs": streams["tuned"] != streams["base"],
           "stream_lengths": {k: [len(x) for x in v]
                              for k, v in streams.items()},
           "engines_share_base_storage": shares,
           "decode_vs_flash_f32": {"rel_l2": rel, "control_rel_l2": control,
                                   "dense_forward_vs_flash_rel_l2": floor,
                                   "flash_launches": fwd_launches},
           "decode_step_ms": decode_ms,
           "multiplex": {"resident": resident, "tagged": tagged,
                         "engines_share_base_storage": mux_shares,
                         "stream_lengths": [len(x) for x in mux]}}
    ok = (res["zero_b_equals_base"] and res["tuned_differs"] and shares
          and max(rel) <= tol and min(control) > tol
          and fwd_launches["flash_fwd"] == cfg.n_layers
          and resident == ["b", "c"] and tagged and mux_shares
          and all(len(x) == 16 for v in streams.values() for x in v))
    emit("lora_serve_410m", **res, rank=LORA_RANK_410M, tolerance_f32=tol,
         ok=ok)
    if not ok:
        raise AssertionError(f"410m LoRA serving failed its checks: {res}")
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
    if argv[:1] == ["--serve-sweep"] and len(argv) == 3:
        from ray_tpu_torch.models import llama

        phase_device()
        cfg = llama.config_for("410m")
        serve_engine_run(cfg, llama.init_params(cfg, seed=0, device="cuda"),
                         rates=tuple(float(r) for r in argv[1].split(",")),
                         n=int(argv[2]))
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    info = phase_device()
    phase_build()
    table = phase_kernels(info["name"])
    phase_train_parity()
    full = phase_train_410m(info["name"], STEPS_410M)
    phase_serve_parity()
    phase_serve_410m()
    phase_lora_parity()
    phase_moe_parity()
    paths = {"train_410m": full["launches"],
             "lora_train_410m": phase_lora_train_410m(
                 info["name"], STEPS_410M, full)["launches"],
             "moe_train_410m": phase_moe_train_410m(STEPS_410M)["launches"]}
    phase_lora_serve_410m()
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "design": DESIGN[name],
         "launches": full["launches"][name],
         "launches_by_path": {p: c[name] for p, c in paths.items()},
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
