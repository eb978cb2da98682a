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
5b. mesh_train_410m, ring_410m (after lora_train_410m): train_410m's step
   through the sharded build_train_step on a one-rank NCCL group and
   MeshConfig(fsdp=-1), 2 + 5 steps: losses equal to train_410m's (first
   1e-6 relative, later 1e-4), 48/24/24 launches a step, step ms beside
   train_410m's. Then ring_attention over 4 in-process sequence shards at
   b8 s2048 h16 d64 bf16 causal, forward and backward on the flash
   kernels, against flash_attention over the whole sequence and the same
   schedule on the plain versions (bf16: out 2e-2 max abs, grads 1e-2
   relative L2), f32 at b2 s512 GQA (2e-5 / 5e-4) and d=128; 10/10/10
   launches; ms and traced device ms beside the unsharded flash.
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
11. runtime_cluster, runtime_serve_410m, runtime_device_objects,
   serve_app_410m, runtime_train_410m: the port's runtime (rt.init() with
   no arguments, which autodetects the GPU) runs the 410m engine in an
   async actor leased one GPU (f32 streams equal an in-process engine's;
   bf16 TTFT/TPOT/tokens/s through the actor and in process, 16 requests
   at once), holds a CUDA tensor as a device object of that actor (same
   object in the holder, equal in the driver, tensor_transport returns);
   then the Serve plane (serve.start, serve.run) serves the 410m engine:
   f32 over HTTP SSE from a replica leased the GPU (streams equal the
   in-process ones; GPU 0 while it lives, 1 after serve.delete), bf16
   llm_app with the same 16 requests over HTTP SSE and through the
   DeploymentHandle, and lora_llm_app routing rank-16 adapters by
   multiplexed model id (tags, zero-B streams equal the base's, the LRU's
   residents); last, the 410m train step in a task leased the GPU once
   the replicas are gone (48/24/24 launches a step in the worker; losses
   against train_410m's). The cluster is shut down on the way out, with
   every process it started.
12. trainer_lora_410m, trainer_corpus, on that cluster once the train
   task has returned the GPU: two TorchTrainer fits of the reference
   recipe lora_finetune_loop at the 410m's full width (as
   lora_train_410m: rank 16, frozen base, b8 s2048, remat "dots", flash),
   8 steps, a checkpoint every 2, each in a TrainWorker leased the GPU:
   a clean fit, and one whose batch_fn hard-exits the worker at step 5,
   restarted from the step-4 checkpoint. Both end at step 8, the
   restarted fit's final loss equals the clean one's to 1e-6 relative,
   each worker counts 48/24/24 flash launches a step, the GPU reads 0
   free while a worker lives and 1 after; wall times and the mean step
   ms from the step-4 report on, beside lora_train_410m's in-process
   step. Then corpus_pretrain_loop on the card from a seeded jsonl
   corpus, uninterrupted and killed once at step 8: the effective
   consumed token streams are equal, bit for bit.
13. dag_device, dag_train_410m, disagg_app_410m, on that cluster once the
   trainers have returned the GPU: the compiled-graph plane. dag_device: a
   same-process DeviceChannel hands a CUDA tensor over as the same object
   (same data_ptr); a compiled DAG of two actors leased half the card each
   sends a bf16 and an f32 CUDA tensor (33.5 MB each) over a
   with_tensor_transport() edge, rebuilt on cuda in the consumer and
   bit-equal (ticks/s and MB/s of the edge); device_input=True broadcasts
   CUDA weights to both; then _internal/perf's DAG legs on this host, the
   device legs' tensors on the card.
   dag_train_410m: InputNode -> a CPU feeder sending batch_410m's batch as
   numpy over a device edge -> a learner actor leased the GPU running the
   410m train step on the CUDA tensors the edge rebuilt: 2 + 3 ticks whose
   losses equal train_410m's to 1e-6 relative, 48/24/24 flash launches a
   tick, tick ms beside the in-process step. disagg_app_410m:
   disagg_llm_app's two pools (PrefillWorker, DecodeLlamaService) of the
   410m engine, leased half the card each: f32 streams of the 3 parity
   requests over HTTP SSE equal the in-process engine's; bf16 with the 16
   concurrent requests (TTFT, TPOT, tokens/s beside serve_app_410m's
   llm_app; each stream equal to llm_app's); the handoffs the decode pool
   read under that load, from its stats (edge kind, bytes, the call's and
   the read's ms); no prefill in the decode pool and no flash kernel in
   either. Each holds the GPU's
   reading at 0 while its actors or pools live and 1 after.
14. rl_parity, rl_ppo_cartpole, rl_impala_cartpole, rl_impala_catch_cnn,
   rl_offpolicy, rl_multi_agent, on that cluster once the GPU is free
   again: RL with its learners on the card and its env runners on the
   CPU. rl_parity: each algorithm's update (PPO, IMPALA and APPO with the
   MLP and the CNN, DQN, SAC with the same normal draws, the offline BC
   and CQL) on the card
   against the CPU in f32 with TF32 off for matmul and cuDNN, to 1e-4
   relative L2 per leaf, with the update's ms on each. Then the learning
   runs of the reference's tests, each against its gate: PPO on CartPole
   (weights over device input edges), IMPALA on CartPole (batches over
   device edges, arriving as CUDA tensors; the test's env-steps/s and
   updates/s floors), IMPALA's CNN on Catch, DQN and SAC with their
   learners in this process, and two-policy PPO with each learner leased
   half the GPU. Each reads the GPU free at 0 while an actor learner
   lives and 1 after stop(), checks that no env runner has a CUDA context
   after reading its weights, and counts the flash launches of its
   processes (0: RL runs no attention).
14b. data_corpus_410m, tune_410m, rl_offline, on that cluster once the GPU
   is free again. data_corpus_410m: build_corpus over a raw jsonl corpus
   made from --seed (16 files, 15% duplicate documents): content-hash
   dedup (hash exchange), a byte tokenizer into the 410m vocabulary, the
   random_shuffle exchange, 8 npz shards of at least 2M tokens; the
   shard-task token stream equals the inline one bit for bit; then a
   TorchTrainer worker leased the GPU runs the 410m train step (b8 s2048,
   bf16, remat "dots", flash) on what its ingest (seq_len 2048, 8 blocks,
   shard_tasks=True) delivers, 5 steps: 48/24/24 flash launches a step,
   its first loss equal to an in-process step's on the same batch from
   the same weights to 1e-6 relative, the GPU 0 free while it lives and 1
   after; the build's wall s and exchange stats, data_wait ms per step
   beside the step ms and tokens/s. tune_410m: Tuner(lora_finetune_loop)
   at the 410m's full width (rank 16 on wq wk wv wo), a grid of 4 learning
   rates under ASHA (max_t 6, grace 2) on the loss, each trial a
   TrainWorker leased half the GPU: 48/24/24 launches a step in every
   trial, two trials at once while the GPU reads 0 free (1 after), at
   least one trial stopped before max_t, the best full-length trial's
   losses equal to the recipe's in-process steps at its lr to 1e-6
   relative; the fit's wall s, each trial's step ms, the time to the first
   result. rl_offline: test_rl_offline's expert CartPole dataset through
   the data plane; BC (4 iterations) and CQL (3 x 400 updates) with their
   learners on the card, each scoring above 60; no flash launch.

15. surfaces_410m, once the runtime cluster is shut down: the runtime's
   surfaces on a head started through the CLI. `python -m ray_tpu_torch
   start --head --dashboard-port 0` with no --num-gpus advertises the
   cards nvidia-smi lists and labels the head with the part's name;
   `status` prints the GPU line. `job submit -- python <driver>` runs a
   3-step TorchTrainer fit of the 410m train step (b8 s2048, bf16,
   remat "dots", flash) in a TrainWorker leased the GPU: the job reads
   SUCCEEDED, the worker counts 48/24/24 flash launches a step, `list
   actors` shows the TrainWorker holding GPU 1 while it lives, `train
   status` and the dashboard's /api/train list the run with cuda:0's
   memory within 5% of the worker's own torch.cuda.memory_stats reading,
   /metrics carries rayt_device_memory_used_bytes for cuda:0, and the GPU
   reads 1 free after the fit. A client process that never imports torch
   runs a num_gpus=1 task through `client-server` that names the part.
   `stop` leaves no process of the cluster behind. Prints the head's
   start ms, status's wall ms, the job's submit-to-SUCCEEDED s, its step
   ms beside train_410m's, and the client task's round trip.

16. launcher_410m: the cluster-operations layer on a cluster of its own.
   `python -m ray_tpu_torch up` from a JSON config (a fresh cluster name,
   the local provider, a head with 4 CPUs and no GPU, one node type
   h100-1 of {CPU: 2, GPU: 1} per host, 0 to 1 slices, idle timeout
   LAUNCHER_IDLE_S s). `exec` starts a driver running a three-step
   workflow (launcher_workflow): batch (batch_410m's tokens, drawn on the
   CPU), train (a CPU step whose num_gpus=1 task stays pending until the
   autoscaler launches an h100-1 node, then runs the 410m step there from
   the train phases' seed: 2 + LAUNCHER_STEPS steps), report (which also
   waits for a `go` event). The driver is SIGKILLed as soon as train's
   checkpoint lands; the event is sent and a second `exec`'d driver
   resumes the workflow. Checks: no GPU in the cluster before; the GPU
   task ran on the autoscaled node (labels autoscaled "1", gpu-type the
   part) with 48/24/24 flash launches a step and its first loss equal to
   train_410m's to LAUNCHER_LOSS_RTOL; batch, train and the GPU task ran
   once (0 launches on the resume), the output's losses equal the
   checkpoint's bit for bit; the autoscaler's status reads one scale-up,
   then after the idle timeout one scale-down and no GPU in the cluster;
   `down` leaves no process of the cluster's session. Prints up s,
   scale-up s (the GPU task's submission to its node's registration), the
   GPU task's first-step and mean step ms beside train_410m's, the killed
   driver's death to the resumed output, scale-down s (the GPU task's end
   to the scale-down), down s and the phase's wall s.

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

    python3 chip_smoke.py --runtime

runs device, build, train_410m (for its losses and step time),
lora_train_410m (for its step time) and the runtime phases (serve_app_410m,
the trainer, the compiled-graph and the RL phases among them) alone.

    python3 chip_smoke.py --rl

runs device, build and the RL phases alone, on a cluster of their own.

    python3 chip_smoke.py --surfaces

runs device, build, train_410m (for its step time) and surfaces_410m
alone.

    python3 chip_smoke.py --data

runs device, build, train_410m and lora_train_410m (for their step
times), then rl_parity and the data plane, Tune and offline RL phases
alone, on a cluster of their own.

    python3 chip_smoke.py --launcher

runs device, build, train_410m (for its first loss and step time) and
launcher_410m alone.

    python3 chip_smoke.py --mesh

runs device, build, train_410m (for its losses and step time),
mesh_train_410m and ring_410m alone.

    python3 chip_smoke.py --gloo-cuda

says which gloo collectives take CUDA tensors on this machine (each in a
2-rank group of its own, both ranks on the one card).

    python3 chip_smoke.py --seed N [...]

makes data_corpus_410m's raw corpus from seed N (default 0).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import uuid

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
def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    import torch

    smi = card_line()
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


def batch_410m(vocab: int, device: str = "cuda") -> dict:
    """The 410m train phases' batch: random tokens from a seed, drawn on
    the CPU (so a process without the card, such as launcher_410m's
    batch step, makes the same batch) and moved to `device`."""
    import torch

    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, vocab, (BATCH_410M, SEQ_410M), generator=gen)
    tokens = tokens.to(device)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}


def run_410m_steps(cfg, params: dict, steps: int, trainable_keys=None,
                   batch: dict | None = None, mesh=None) -> dict:
    """build_train_step over `params` (consumed: the step holds its own
    copy), 2 warm-up steps, then `steps` timed steps on one batch
    (`batch_410m` unless given), with the launch counters and the peak
    memory read over the timed steps only. Returns the readings and the
    step, state and batch. The first warm-up step's ms includes what a
    first call pays (library handles, the allocator's growth). With a
    `mesh`, the sharded step over it (the model's logical axes, the batch
    through shard_batch)."""
    import gc

    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.parallel.spmd import (adamw, build_train_step,
                                             shard_batch)

    axes = None if mesh is None else llama.param_logical_axes(cfg)
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4), params, axes,
        mesh, trainable_keys=trainable_keys)
    params.clear()
    gc.collect()
    if batch is None:
        batch = batch_410m(cfg.vocab_size)
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    losses, moe_aux = [], []
    t0 = time.perf_counter()
    for _ in range(2):                                   # warm-up
        state, aux = step(state, batch)
        losses.append(aux["loss"].item())
        moe_aux.append(aux["moe_aux"].item())
        if len(losses) == 1:        # .item() waited for the card
            first_step_ms = (time.perf_counter() - t0) * 1e3
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
            "first_step_ms": first_step_ms, "step_ms": dt / steps * 1e3,
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
    return {"launches": run["launches"], "losses": run["losses"],
            "step_ms": run["step_ms"],
            "tokens_per_s": run["tokens_per_s"], "mfu": mfu,
            "peak_mem_gb": run["peak_mem_gb"],
            **profile_step(run["step"], run["state"], run["batch"])}


MESH_FIRST_RTOL = 1e-6    # the same computation: the first loss
MESH_LATER_RTOL = 1e-4    # after AdamW steps, as the train phases' parity


def phase_mesh_train_410m(full: dict, steps: int) -> dict:
    """train_410m's step through the sharded build_train_step: a one-rank
    NCCL process group, MeshConfig(fsdp=-1) over it (every axis of size 1:
    the rule table keeps every leaf whole, no collective runs), the same
    config, seed and batch. Holds the losses against train_410m's and the
    launch counts at 48/24/24 a step; the step ms beside train_410m's is
    the cost of the mesh plumbing."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import (MeshConfig, free_address,
                                             init_process_group)

    init_process_group(1, 0, free_address())
    try:
        mesh = MeshConfig(fsdp=-1).build()
        cfg = config_410m()
        run = run_410m_steps(cfg, llama.init_params(cfg, seed=0), steps,
                             mesh=mesh)
        backend = dist.get_backend()
        mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        del run["step"], run["state"]
    finally:
        dist.destroy_process_group()
    ref = full["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref)]
    ok = (rel[0] <= MESH_FIRST_RTOL
          and all(r <= MESH_LATER_RTOL for r in rel[1:])
          and run["launches"] == run["expected_launches"])
    emit("mesh_train_410m", backend=backend, mesh=mesh_shape,
         losses=run["losses"], train_410m_losses=ref,
         first_rel_diff=rel[0], max_rel_diff=max(rel),
         tolerance={"first": MESH_FIRST_RTOL, "later": MESH_LATER_RTOL},
         step_ms=run["step_ms"], train_410m_step_ms=full["step_ms"],
         mesh_overhead_ms=run["step_ms"] - full["step_ms"],
         tokens_per_s=run["tokens_per_s"], peak_mem_gb=run["peak_mem_gb"],
         launches=run["launches"],
         expected_launches=run["expected_launches"], steps=steps, ok=ok)
    if not ok:
        raise AssertionError("the 410m step over a one-card mesh differs "
                             "from train_410m's")
    return run


RING_SHARDS = 4
RING_BF16_OUT_ABS = 2e-2     # phase_kernels' bf16 bounds: bf16 output
RING_BF16_GRAD_L2 = 1e-2     # rounding, and ds/p rounded before products
RING_F32_FWD, RING_F32_BWD = 2e-5, 5e-4   # the f32 kernels' bounds


def _leaves(tensors, n=1):
    """Each tensor cut into n sequence shards, as contiguous leaves that
    take gradients."""
    return [[t.clone().requires_grad_(True) for t in x.chunk(n, 1)]
            for x in tensors]


def _ring_call(ra, shards, dos, causal=True, ops=None):
    """ring_attention_local over the shards, forward and backward: the
    outputs and the gradients, per shard."""
    import torch

    outs = ra.ring_attention_local(*shards, causal=causal, ops=ops)
    grads = torch.autograd.grad(outs, [t for s in shards for t in s], dos)
    return outs, grads


def _ring_run(ra, q, k, v, do, n, causal=True, ops=None):
    """_ring_call over n sequence shards of q, k, v (cut here): (out, dq,
    dk, dv) put back together."""
    import torch

    outs, grads = _ring_call(ra, _leaves((q, k, v), n), list(do.chunk(n, 1)),
                             causal, ops)
    out = torch.cat([o.detach() for o in outs], 1)
    return (out, *(torch.cat(grads[i * n:(i + 1) * n], 1)
                   for i in range(3)))


def _flash_call(fa, qkv, do, causal=True):
    import torch

    out = fa.flash_attention(*qkv, causal=causal)
    return (out.detach(), *torch.autograd.grad(out, qkv, do))


def _flash_run(fa, q, k, v, do, causal=True):
    return _flash_call(fa, [s[0] for s in _leaves((q, k, v))], do, causal)


def _ring_errors(got, want, dtype) -> dict:
    """Each of out, dq, dk, dv against want, in phase_kernels' terms."""
    import torch

    names = ("out", "dq", "dk", "dv")
    if dtype == torch.float32:
        tols = (RING_F32_FWD,) + (RING_F32_BWD,) * 3
        return {n: _allclose_err(a, b, t)
                for n, a, b, t in zip(names, got, want, tols)}
    errs = {"out": _max_abs(got[0], want[0]) / RING_BF16_OUT_ABS}
    errs.update({n: _rel_l2(a, b) / RING_BF16_GRAD_L2
                 for n, a, b in zip(names[1:], got[1:], want[1:])})
    return errs


def phase_ring_410m() -> dict:
    """ring_attention over RING_SHARDS in-process sequence shards of the
    410m step's attention (b8 s2048 h16 d64, bf16, causal), forward and
    backward on the flash kernels: against flash_attention over the whole
    sequence and against the same schedule on the kernels' plain versions.
    Then f32 at a small size and d=128 (the 410m-hd128 preset's heads).
    Each check is a ratio to its tolerance (<= 1 passes). Launches from the
    main case only: 10 forward launches and 10 + 10 backward for 4 causal
    shards. Times ring vs unsharded flash, forward + backward, and traces
    one ring call for its device time."""
    import torch

    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.ops.cuda import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    n = RING_SHARDS
    checks, errors = {}, {}
    q, k, v, do = _inputs(8, 2048, 2048, 16, 16, 64, bf16, 7)
    fa.reset_launches()
    ring = _ring_run(ra, q, k, v, do, n)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    flash = _flash_run(fa, q, k, v, do)
    checks["bf16_main_vs_flash"] = _ring_errors(ring, flash, bf16)
    plain = _ring_run(ra, q, k, v, do, n, ops=ra.PLAIN_OPS)
    checks["bf16_main_vs_plain_schedule"] = _ring_errors(ring, plain, bf16)
    errors["flash_fwd"] = _max_abs(ring[0], plain[0])
    errors["flash_bwd_dq"] = _max_abs(ring[1], plain[1])
    errors["flash_bwd_dkv"] = max(_max_abs(ring[2], plain[2]),
                                  _max_abs(ring[3], plain[3]))
    # timed on shards and leaves made once: the ring's forward and
    # backward, and flash_attention's over the whole sequence
    shards, dos = _leaves((q, k, v), n), list(do.chunk(n, 1))
    qkv = [s[0] for s in _leaves((q, k, v))]
    ring_ms = time_ms(lambda: _ring_call(ra, shards, dos), n=5, runs=3)
    flash_ms = time_ms(lambda: _flash_call(fa, qkv, do), n=5, runs=3)
    # the ring's device time apart from the host's (flash's kernels alone:
    # phase_kernels' times at this shape)
    traced = profile_call(lambda: _ring_call(ra, shards, dos),
                          "profile_ring_410m")
    del ring, flash, plain, shards, qkv

    with tf32_off():
        qs, ks, vs, dos = _inputs(2, 512, 512, 4, 2, 64, f32, 8)
        checks["f32_s512_gqa_vs_plain_schedule"] = _ring_errors(
            _ring_run(ra, qs, ks, vs, dos, n),
            _ring_run(ra, qs, ks, vs, dos, n, ops=ra.PLAIN_OPS), f32)
        checks["f32_s512_gqa_noncausal_vs_flash"] = _ring_errors(
            _ring_run(ra, qs, ks, vs, dos, n, causal=False),
            _flash_run(fa, qs, ks, vs, dos, causal=False), f32)
    q, k, v, do = _inputs(8, 2048, 2048, 8, 8, 128, bf16, 9)
    checks["bf16_d128_vs_flash"] = _ring_errors(
        _ring_run(ra, q, k, v, do, n), _flash_run(fa, q, k, v, do), bf16)
    want = {"flash_fwd": n * (n + 1) // 2, "flash_bwd_dq": n * (n + 1) // 2,
            "flash_bwd_dkv": n * (n + 1) // 2}
    bad = {c: e for c, errs in checks.items() for e in errs.values()
           if not e <= 1.0}
    ok = not bad and launches == want
    emit("ring_410m", shards=n, shape=[8, 2048, 16, 16, 64], dtype="bf16",
         checks=checks, tolerance={
             "bf16": {"out_max_abs": RING_BF16_OUT_ABS,
                      "grad_rel_l2": RING_BF16_GRAD_L2},
             "f32": {"fwd": RING_F32_FWD, "bwd": RING_F32_BWD}},
         launches=launches, expected_launches=want, ring_ms=ring_ms,
         flash_ms=flash_ms,
         ring_device_busy_ms=traced["device_busy_ms"],
         ring_device_idle_share=traced["device_idle_share"],
         max_abs_err_vs_plain_schedule=errors, ok=ok)
    if not ok:
        raise AssertionError(f"ring_410m: checks over tolerance {bad}, "
                             f"launches {launches} != {want}")
    return {"launches": launches, "ring_ms": ring_ms, "flash_ms": flash_ms}


_GLOO_CUDA_OPS = ("all_reduce", "all_gather", "all_to_all_single",
                  "batch_isend_irecv")
_GLOO_CUDA_RANK = r"""
import sys, torch, torch.distributed as dist
op, rank, address = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=address, rank=rank,
                        world_size=2)
x = torch.full((4, 8), float(rank + 1), device="cuda")
out = torch.empty_like(x)
if op == "all_reduce":
    dist.all_reduce(x)
    ok = float(x[0, 0]) == 3.0
elif op == "all_gather":
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    ok = float(parts[1][0, 0]) == 2.0
elif op == "all_to_all_single":
    dist.all_to_all_single(out, x)
    ok = float(out[2, 0]) == 2.0
else:
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, 1 - rank),
            dist.P2POp(dist.irecv, out, 1 - rank)]):
        req.wait()
    ok = float(out[0, 0]) == 2.0 - rank
torch.cuda.synchronize()
dist.destroy_process_group()
sys.exit(0 if ok else 3)
"""


def phase_gloo_cuda() -> dict:
    """Which gloo collectives take CUDA tensors on this machine (the
    multi-rank checks could run as two processes on one card only over
    gloo: NCCL refuses two ranks on one card). Each op runs in a 2-rank
    group of its own, so one that aborts its processes hides no other."""
    from ray_tpu_torch.parallel.mesh import free_address

    verdicts = {}
    for op in _GLOO_CUDA_OPS:
        address = free_address()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _GLOO_CUDA_RANK, op, str(rank), address],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            for rank in range(2)]
        errs = []
        for p in procs:
            try:
                errs.append(p.communicate(timeout=120)[1])
            except subprocess.TimeoutExpired:
                p.kill()
                errs.append(p.communicate()[1] + " (timed out)")
        codes = [p.returncode for p in procs]
        verdicts[op] = ("ok" if codes == [0, 0] else
                        f"exit {codes}: " + errs[0].strip().splitlines()[-1]
                        if errs[0].strip() else f"exit {codes}")
    emit("gloo_cuda", ops=verdicts)
    return verdicts


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


# the 410m engine as the serve phases run it
ENGINE_410M = dict(max_batch=8, prompt_buckets=(128, 512, 1024),
                   prefill_chunk=256)


def warm_up(eng) -> None:
    """Every bucket's prefill, chunked and not, and decode steps."""
    for i, m in enumerate((100, 400, 1000)):
        collect(eng, [1 + i] * m, max_new_tokens=4)


# 120 (75 s of traffic at SERVE_RATE) keeps the whole script well inside
# its 1200 s limit
SERVE_REQUESTS = 120
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

    eng = LLMEngine("410m", params=params, device=device, **ENGINE_410M)
    warm_up(eng)
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


# ------------------------------------------------------------ the runtime
RUNTIME_PARITY_PROMPTS = (40, 300, 700)   # prompt tokens, one at a time
RUNTIME_NEW_TOKENS = 16
RUNTIME_CONCURRENT = 16                   # bf16 requests sent at once
RUNTIME_TRAIN_STEPS = 3                   # timed, after 2 warm-up steps


def phase_runtime_cluster() -> dict:
    """rt.init() with no arguments on the card's host: the GPU resource
    equals the cards nvidia-smi lists, the head node's label names the
    part, a CPU task's worker has not imported torch; the init time and a
    no-op task's round trip."""
    import ray_tpu_torch as rt

    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split("\n")
    names = [n.strip() for n in names if n.strip()]
    t0 = time.perf_counter()
    rt.init()
    init_ms = (time.perf_counter() - t0) * 1e3
    resources = rt.cluster_resources()
    labels = next(n.labels for n in rt.nodes() if n.labels.get("head"))

    @rt.remote
    def cpu_task():
        import sys

        return ("torch" in sys.modules,
                sys.modules["__main__"].__spec__.name)

    torch_in_worker, worker_main = rt.get(cpu_task.remote(), timeout=120)

    @rt.remote
    def noop():
        return None

    for _ in range(5):
        rt.get(noop.remote(), timeout=60)
    rtt = []
    for _ in range(50):
        t0 = time.perf_counter()
        rt.get(noop.remote(), timeout=60)
        rtt.append(time.perf_counter() - t0)
    res = {"init_ms": init_ms, "noop_round_trip": _percentiles(rtt),
           "resources_gpu": resources.get("GPU"), "nvidia_smi_cards": names,
           "head_labels": labels, "torch_in_cpu_worker": torch_in_worker,
           "worker_module": worker_main}
    ok = (resources.get("GPU") == float(len(names)) and bool(names)
          and labels.get("gpu-type") == names[0] and not torch_in_worker
          and worker_main == "ray_tpu_torch.core.worker_main")
    emit("runtime_cluster", **res, ok=ok)
    if not ok:
        raise AssertionError(f"runtime_cluster failed its checks: {res}")
    return res


class LlamaHost:
    """An async actor hosting the port's LlamaService("410m") on the card,
    with the engine of the serve phases; streams token ids. With `f32` the
    preset runs in float32 with TF32 off."""

    def __init__(self, f32: bool):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("a GPU-leased actor sees no CUDA device")
        from ray_tpu_torch.ops.cuda import _build
        from ray_tpu_torch.serve import llm

        _build.library()                 # the kernel library loads here
        if f32:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        with (f32_presets(llm.llama) if f32 else contextlib.nullcontext()):
            self.svc = llm.LlamaService("410m", device="cuda", seed=0,
                                        **ENGINE_410M)

    def probe(self) -> dict:
        import sys

        import torch

        return {"cuda": torch.cuda.is_available(),
                "device": torch.cuda.get_device_name(0),
                "dtype": str(self.svc.engine.cfg.dtype),
                "python_S": sys.flags.no_site == 1}

    def warm_up(self):
        warm_up(self.svc.engine)

    async def generate(self, payload: dict):
        async for out in self.svc(payload):
            yield out["token"]

    def reset_launches(self):
        from ray_tpu_torch.ops.cuda.flash_attention import reset_launches

        reset_launches()

    def launches(self) -> dict:
        from ray_tpu_torch.ops.cuda.flash_attention import launches

        return dict(launches)

    def put_kv(self) -> list:
        """Layer 0's K cache as a device object, returned inside a list so
        the caller receives the ref itself."""
        import ray_tpu_torch as rt

        self.kv = self.svc.engine._decode_cache["k"][0]
        self.kv_ref = rt.put_device(self.kv)
        return [self.kv_ref]

    def holder_gets_the_same_object(self) -> bool:
        import ray_tpu_torch as rt

        return rt.get(self.kv_ref) is self.kv

    def kv_on_host(self):
        return self.kv.cpu()

    def kv_tensor(self):
        return self.kv


async def _stream_all(submit, requests: list) -> dict:
    """Send every (prompt, new tokens) request at once through
    `submit(prompt, new) -> async iterator of token ids`; stamp each token
    where it arrives, in seconds from its request's submission."""
    import asyncio

    arrived = [[] for _ in requests]
    streams = [[] for _ in requests]

    async def one(i, prompt, new):
        t_submit = time.perf_counter()
        async for tok in submit(prompt, new):
            arrived[i].append(time.perf_counter() - t_submit)
            streams[i].append(tok)

    t0 = time.perf_counter()
    await asyncio.gather(*[one(i, p, n) for i, (p, n) in enumerate(requests)])
    return {"streams": streams, "arrived": arrived,
            "wall_s": time.perf_counter() - t0}


def _latencies(run: dict) -> dict:
    """TTFT and TPOT seen where the tokens arrived, and tokens/s."""
    arrived = run["arrived"]
    return {"wall_s": run["wall_s"],
            "tokens_per_s": sum(len(a) for a in arrived) / run["wall_s"],
            "ttft": _percentiles([a[0] for a in arrived]),
            "tpot": _percentiles([(a[-1] - a[0]) / (len(a) - 1)
                                  for a in arrived if len(a) > 1])}


def _actor_submit(actor):
    async def submit(prompt, new):
        gen = actor.generate.options(num_returns="streaming").remote(
            {"tokens": prompt, "max_new_tokens": new})
        async for ref in gen:
            yield await ref
    return submit


def _engine_submit(eng):
    def submit(prompt, new):
        return eng.generate(prompt, max_new_tokens=new)
    return submit


def parity_requests(vocab: int) -> list:
    """The f32 parity requests of the runtime and Serve phases: prompts of
    RUNTIME_PARITY_PROMPTS tokens, RUNTIME_NEW_TOKENS new each."""
    import numpy as np

    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, n).tolist(), RUNTIME_NEW_TOKENS)
            for n in RUNTIME_PARITY_PROMPTS]


def concurrent_requests(vocab: int) -> list:
    """The bf16 timing requests of the runtime and Serve phases, sent at
    once: RUNTIME_CONCURRENT (prompt, new tokens) pairs of serve_traffic."""
    return [(p, m) for _, p, m in
            serve_traffic(vocab, RUNTIME_CONCURRENT, 1.0, seed=4)]


def _one_at_a_time(submit, requests: list) -> list:
    import asyncio

    async def run():
        return [(await _stream_all(submit, [r]))["streams"][0]
                for r in requests]
    return asyncio.run(run())


def phase_runtime_serve_410m():
    """LlamaService("410m") in an async actor leased one GPU, streaming
    through a num_returns="streaming" method. Parity in f32 (TF32 off,
    greedy): 3 requests of 40, 300 and 700 prompt tokens and 16 new, one
    after another, equal token for token to an in-process engine of the
    same config and seed on the same card. Timing in bf16: 16 requests at
    once through the actor and in process, TTFT and TPOT seen at the
    driver and tokens/s. Returns the bf16 actor (it holds the device
    object of runtime_device_objects) and the phase's readings."""
    import asyncio
    import gc

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.serve.llm import LLMEngine

    from ray_tpu_torch.models import llama

    host = rt.remote(num_gpus=1, max_restarts=0)(LlamaHost)
    vocab = llama.config_for("410m").vocab_size
    parity_reqs = parity_requests(vocab)
    # f32 parity: actor, then the same requests in process
    actor = host.remote(True)
    probe = rt.get(actor.probe.remote(), timeout=600)
    rt.get(actor.reset_launches.remote(), timeout=60)
    through_actor = _one_at_a_time(_actor_submit(actor), parity_reqs)
    actor_launches = rt.get(actor.launches.remote(), timeout=60)
    rt.kill(actor)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with f32_presets(llama):
        eng = LLMEngine("410m", device="cuda", seed=0, **ENGINE_410M)
        assert eng.cfg.dtype == torch.float32
        in_process = _one_at_a_time(_engine_submit(eng), parity_reqs)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    parity = (through_actor == in_process
              and [len(s) for s in through_actor]
              == [RUNTIME_NEW_TOKENS] * len(parity_reqs))
    # bf16 timing: the same 16 requests at once, actor then in process
    requests = concurrent_requests(vocab)
    actor = host.remote(False)
    bf16_probe = rt.get(actor.probe.remote(), timeout=600)
    rt.get(actor.warm_up.remote(), timeout=600)
    timed_actor = asyncio.run(_stream_all(_actor_submit(actor), requests))
    eng = LLMEngine("410m", device="cuda", seed=0, **ENGINE_410M)
    warm_up(eng)
    timed_local = asyncio.run(_stream_all(_engine_submit(eng), requests))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    complete = all([len(s) for s in t["streams"]] == [m for _, m in requests]
                   for t in (timed_actor, timed_local))
    summary = {"actor": _latencies(timed_actor),
               "in_process": _latencies(timed_local)}
    res = {"f32_actor_probe": probe, "bf16_actor_probe": bf16_probe,
           "parity_prompts": list(RUNTIME_PARITY_PROMPTS),
           "new_tokens": RUNTIME_NEW_TOKENS,
           "parity_streams_equal": parity,
           "parity_streams_actor": through_actor,
           "parity_streams_in_process": in_process,
           # the engine's prefill and decode attend over the cache densely
           # (models/llama._decode_block): no flash kernel on this path
           "actor_flash_launches": actor_launches,
           "concurrent_requests": RUNTIME_CONCURRENT,
           "prompt_tokens": sum(len(p) for p, _ in requests),
           "generated_tokens": sum(m for _, m in requests),
           "complete": complete, **summary}
    ok = (parity and complete and probe["cuda"] and probe["python_S"]
          and probe["dtype"] == "torch.float32"
          and bf16_probe["dtype"] == "torch.bfloat16")
    emit("runtime_serve_410m", **res, ok=ok)
    if not ok:
        rt.kill(actor)
        raise AssertionError("runtime_serve_410m failed its checks")
    return actor, res


def train_410m_task(batch: dict, steps: int) -> dict:
    """The 410m train step in a GPU-leased worker: params from seed 0, the
    batch as numpy (rt.put by the driver)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("a GPU-leased task sees no CUDA device")
    from ray_tpu_torch.models import llama

    cfg = config_410m()
    run = run_410m_steps(
        cfg, llama.init_params(cfg, seed=0), steps,
        batch={k: torch.tensor(v, device="cuda") for k, v in batch.items()})
    return {k: run[k] for k in ("losses", "step_ms", "tokens_per_s",
                                "peak_mem_gb", "launches",
                                "expected_launches")}


def phase_runtime_train_410m(reference_losses: list) -> dict:
    """train_410m_task leased one GPU: 2 warm-up and 3 timed steps, the
    batch through rt.put as numpy. The worker's launch counters show
    48/24/24 flash launches a step; its first loss (forward only, before
    any update) equals train_410m's on the same seed and batch to 1e-6
    relative, and the later ones agree to 1e-3 (the embedding backward
    accumulates with atomics)."""
    import ray_tpu_torch as rt

    batch = {k: v.cpu().numpy()
             for k, v in batch_410m(config_410m().vocab_size).items()}
    ref = rt.put(batch)
    task = rt.remote(num_gpus=1, max_retries=0)(train_410m_task)
    t0 = time.perf_counter()
    run = rt.get(task.remote(ref, RUNTIME_TRAIN_STEPS), timeout=900)
    wall_s = time.perf_counter() - t0
    losses = run["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, reference_losses)]
    ok = (run["launches"] == run["expected_launches"]
          and rel[0] <= 1e-6 and max(rel) <= 1e-3
          and len(rel) == len(losses))
    emit("runtime_train_410m", **run, reference_losses=reference_losses,
         rel_diff=rel, tolerance_first=1e-6, tolerance_later=1e-3,
         task_wall_s=wall_s, steps=RUNTIME_TRAIN_STEPS, ok=ok)
    if not ok:
        raise AssertionError("runtime_train_410m failed its checks")
    return run


# ---------------------------------------------------- the train runtime
TRAINER_STEPS, TRAINER_REPORT_EVERY = 8, 2
TRAINER_CRASH_AT = 5          # step index whose batch_fn kills the worker
TRAINER_TIMED_FROM = 4        # mean step ms from the step-4 report on
CORPUS_STEPS, CORPUS_CRASH_AT = 16, 8


def trainer_batch(i: int, rank: int, vocab: int) -> dict:
    """The trainer phase's batch for step i: numpy tokens from a seed,
    [BATCH_410M, SEQ_410M]."""
    import numpy as np

    rng = np.random.default_rng(1000 * rank + i)
    tokens = rng.integers(0, vocab, (BATCH_410M, SEQ_410M)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def trainer_lora_loop(config: dict):
    """lora_finetune_loop inside a TrainWorker, with the readings only
    the worker's process has: its flash launch counters (set to 0 before
    the loop, read after), the steps it ran, the GPU the cluster shows
    free while it lives, its peak memory, whether the worker was warm
    (torch already imported: an idle worker reused), the time from the
    loop's entry to its first batch (params, train step, restore) and
    from the batch of step TRAINER_TIMED_FROM to the end. A batch_fn
    hard-exits the worker once at config["crash_at"] (None: never). They
    ride one more report, after the loop's last."""
    warm = "torch" in sys.modules
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.train.recipes import lora_finetune_loop

    deadline = time.monotonic() + 30   # the view follows a lease
    gpu_free = rt.available_resources().get("GPU")
    while gpu_free != 0.0 and time.monotonic() < deadline:
        time.sleep(0.1)
        gpu_free = rt.available_resources().get("GPU")
    stamps = {}
    crash_at, marker = config["crash_at"], config["marker"]
    entered = time.perf_counter()

    def batch_fn(i, rank):
        if i == crash_at and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)                # a hard worker kill, mid-run
        stamps[i] = time.perf_counter()
        return trainer_batch(i, rank, config["vocab"])

    reset_launches()                   # counts: the main path only
    loss = lora_finetune_loop({**config, "batch_fn": batch_fn})
    torch.cuda.synchronize()
    end = time.perf_counter()
    steps = sorted(stamps)
    train.report({
        "loss": loss, "step": steps[-1] + 1, "steps_run": steps,
        "launches": dict(launches), "gpu_free_in_worker": gpu_free,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mean_step_ms": (end - stamps[TRAINER_TIMED_FROM])
        / (steps[-1] + 1 - TRAINER_TIMED_FROM) * 1e3,
        "warm_worker": warm, "setup_s": stamps[steps[0]] - entered,
        "loop_s": end - entered,
        "device": str(train.get_context().get_device())})
    return loss


def _trainer_fit(rt, loop, config: dict, name: str, storage: str,
                 max_failures: int, ingest=None):
    """One TorchTrainer fit on one GPU worker; returns the result, its
    wall time and the GPU free after it."""
    from ray_tpu_torch import train

    t0 = time.perf_counter()
    result = train.TorchTrainer(
        loop, train_loop_config=config,
        scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True,
                                           ingest=ingest),
        run_config=train.RunConfig(
            name=name, storage_path=storage,
            failure_config=train.FailureConfig(
                max_failures=max_failures))).fit()
    wall_s = time.perf_counter() - t0
    return result, wall_s, _gpus_free(rt, 1.0)


def phase_trainer_lora_410m(lora_step_ms: float, storage: str) -> dict:
    """Two TorchTrainer fits of the reference recipe lora_finetune_loop at
    the 410m's full width (config_410m: s2048, remat "dots", flash; rank
    16 on wq wk wv wo, frozen base; b8, bf16 compute, f32 params, AdamW),
    TRAINER_STEPS steps, a checkpoint every TRAINER_REPORT_EVERY: a clean
    fit, and one whose batch_fn hard-exits the worker once at step
    TRAINER_CRASH_AT, which restarts from the step-4 checkpoint. Holds:
    both end at step 8; the restarted fit's final loss equals the clean
    one's to 1e-6 relative (the base is frozen: no embedding atomics);
    48/24/24 flash launches a step in each worker; the GPU free at 0
    while a worker lives and at 1 after. Prints each fit's wall time and
    mean step ms beside lora_train_410m's in-process step."""
    import ray_tpu_torch as rt

    cfg = config_410m()
    config = {"preset": "410m", "lora_rank": LORA_RANK_410M,
              "model_overrides": {"max_seq_len": SEQ_410M, "remat": True,
                                  "remat_policy": "dots",
                                  "attn_impl": "flash"},
              "steps": TRAINER_STEPS, "report_every": TRAINER_REPORT_EVERY,
              "batch_size": BATCH_410M, "seq_len": SEQ_410M, "lr": 3e-4,
              "seed": 0, "vocab": cfg.vocab_size}
    fits = {}
    for name, crash_at in (("clean", None), ("restarted", TRAINER_CRASH_AT)):
        marker = os.path.join(storage, f"lora-{name}.crashed")
        result, wall_s, gpu_after = _trainer_fit(
            rt, trainer_lora_loop,
            {**config, "crash_at": crash_at, "marker": marker},
            f"lora-{name}", storage, max_failures=int(crash_at is not None))
        m = result.metrics
        steps_run = len(m["steps_run"])
        want = {"flash_fwd": 2 * cfg.n_layers * steps_run,
                "flash_bwd_dq": cfg.n_layers * steps_run,
                "flash_bwd_dkv": cfg.n_layers * steps_run}
        fits[name] = {"loss": m["loss"], "step": m["step"],
                      "steps_run": m["steps_run"], "launches": m["launches"],
                      "expected_launches": want,
                      "mean_step_ms": m["mean_step_ms"],
                      "peak_mem_gb": m["peak_mem_gb"], "wall_s": wall_s,
                      "warm_worker": m["warm_worker"],
                      "setup_s": m["setup_s"], "loop_s": m["loop_s"],
                      "gpu_free_in_worker": m["gpu_free_in_worker"],
                      "gpu_free_after": gpu_after, "device": m["device"],
                      "crashed": os.path.exists(marker)}
    clean, restarted = fits["clean"], fits["restarted"]
    # the restarted worker resumes from the last checkpoint before the crash
    resume = TRAINER_CRASH_AT // TRAINER_REPORT_EVERY * TRAINER_REPORT_EVERY
    rel = abs(restarted["loss"] - clean["loss"]) / abs(clean["loss"])
    ok = (all(f["step"] == TRAINER_STEPS and f["launches"] ==
              f["expected_launches"] and f["gpu_free_in_worker"] == 0.0
              and f["gpu_free_after"] == 1.0 and f["device"] == "cuda"
              and math.isfinite(f["loss"]) for f in fits.values())
          and not clean["crashed"] and restarted["crashed"]
          and clean["steps_run"] == list(range(TRAINER_STEPS))
          and restarted["steps_run"] == list(range(resume, TRAINER_STEPS))
          and rel <= 1e-6)
    emit("trainer_lora_410m", **fits, loss_rel_diff=rel,
         loss_abs_diff=abs(restarted["loss"] - clean["loss"]),
         tolerance=1e-6, lora_train_410m_step_ms=lora_step_ms,
         clean_vs_in_process=clean["mean_step_ms"] / lora_step_ms,
         steps=TRAINER_STEPS, report_every=TRAINER_REPORT_EVERY,
         crash_at=TRAINER_CRASH_AT, timed_from=TRAINER_TIMED_FROM,
         rank=LORA_RANK_410M, batch=BATCH_410M, seq=SEQ_410M, ok=ok)
    if not ok:
        raise AssertionError("trainer_lora_410m failed its checks")
    return clean["launches"]


def write_corpus(root: str, shards: int = 8, docs: int = 30,
                 seed: int = 1) -> str:
    """A seeded jsonl token corpus (the reference ingest test's shape)."""
    import numpy as np

    corpus = os.path.join(root, "corpus")
    os.makedirs(corpus, exist_ok=True)
    rng = np.random.default_rng(seed)
    for s in range(shards):
        with open(os.path.join(corpus, f"s{s:03d}.jsonl"), "w") as f:
            for _ in range(docs):
                toks = rng.integers(1, 100, rng.integers(5, 60)).tolist()
                f.write(json.dumps({"tokens": toks}) + "\n")
    return corpus


def phase_trainer_corpus(storage: str) -> dict:
    """corpus_pretrain_loop on the card from a seeded jsonl corpus through
    the session's ingest (pinned host copies moved to the card), with
    trace_dir: an uninterrupted fit, and one killed once with
    crash_at_step that resumes from its checkpoint (the cursor rides in
    it). The effective consumed token streams are equal, bit for bit."""
    import glob

    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.train import IngestSpec, corpus_pretrain_loop

    corpus = write_corpus(storage)
    spec = IngestSpec(paths=corpus, seq_len=32, batch_blocks=4, eos_id=0,
                      epochs=4)
    traces, res = {}, {}
    for name, crash_at in (("clean", None), ("restarted", CORPUS_CRASH_AT)):
        trace = os.path.join(storage, f"trace-{name}")
        config = {"steps": CORPUS_STEPS, "checkpoint_every": 3,
                  "trace_dir": trace, "vocab_size": 101}
        if crash_at is not None:
            config["crash_at_step"] = crash_at
        result, wall_s, gpu_after = _trainer_fit(
            rt, corpus_pretrain_loop, config, f"corpus-{name}", storage,
            max_failures=1, ingest=spec)
        traces[name] = sorted(glob.glob(os.path.join(trace, "rank0",
                                                     "step_*.npy")))
        res[name] = {"step": result.metrics["step"], "wall_s": wall_s,
                     "loss": result.metrics["loss"],
                     "gpu_free_after": gpu_after, "crashed": os.path.exists(
                         os.path.join(storage, f"corpus-{name}",
                                      ".crashed-rank_0"))}
    same = [np.array_equal(np.load(a), np.load(b))
            for a, b in zip(traces["clean"], traces["restarted"])]
    ok = (len(traces["clean"]) == len(traces["restarted"]) == CORPUS_STEPS
          and all(same) and res["restarted"]["crashed"]
          and not res["clean"]["crashed"]
          and all(r["step"] == CORPUS_STEPS and r["gpu_free_after"] == 1.0
                  for r in res.values()))
    emit("trainer_corpus", **res, steps_equal=sum(same),
         steps=CORPUS_STEPS, crash_at=CORPUS_CRASH_AT, ok=ok)
    if not ok:
        raise AssertionError("trainer_corpus failed its checks")
    return res


def phase_trainer(lora_step_ms: float) -> dict:
    """The train runtime's phases, in a temporary directory removed on
    the way out. Returns the clean LoRA fit's launch counts."""
    import shutil
    import tempfile

    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        launches = phase_trainer_lora_410m(lora_step_ms, storage)
        phase_trainer_corpus(storage)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    return launches


def phase_runtime_device_objects(actor) -> dict:
    """In the GPU actor, rt.put_device of layer 0's K cache ([8, 2048, 16,
    64] bf16, 33.5 MB): rt.get in the holder is the same object; rt.get in
    the driver gives a CUDA tensor equal to it (host-staged fetch, timed
    over 5 gets); a tensor_transport=True return arrives the same way."""
    import ray_tpu_torch as rt
    import torch

    [ref] = rt.get(actor.put_kv.remote(), timeout=60)
    same = rt.get(actor.holder_gets_the_same_object.remote(), timeout=60)
    want = rt.get(actor.kv_on_host.remote(), timeout=120).to("cuda")
    fetch_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = rt.get(ref, timeout=120)
        torch.cuda.synchronize()
        fetch_s.append(time.perf_counter() - t0)
    equal = (got.is_cuda and got.dtype == torch.bfloat16
             and tuple(got.shape) == (8, 2048, 16, 64)
             and torch.equal(got, want))
    returned = rt.get(actor.kv_tensor.options(tensor_transport=True).remote(),
                      timeout=120)
    equal_transport = returned.is_cuda and torch.equal(returned, want)
    nbytes = want.numel() * want.element_size()
    res = {"shape": list(want.shape), "dtype": str(want.dtype),
           "mbytes": nbytes / 1e6, "holder_same_object": same,
           "driver_get_equal": equal, "tensor_transport_equal":
           equal_transport, "fetch_ms": _percentiles(fetch_s),
           "fetch_mb_per_s": nbytes / 1e6 / statistics.median(fetch_s),
           "nonzero": bool(want.abs().sum() > 0)}
    ok = same and equal and equal_transport and res["nonzero"]
    emit("runtime_device_objects", **res, ok=ok)
    if not ok:
        raise AssertionError("runtime_device_objects failed its checks")
    return res


def served(cls, f32: bool = False):
    """`cls` (LlamaService or MultiplexedLoraService) as a Serve replica
    hosts it, with three methods more to read the replica's process:
    probe (cuda, device, engine dtype, pid) and the flash launch counters.
    With `f32` its constructor builds the engine in float32 with TF32 off;
    the wrap runs where the constructor runs, in the replica's own process
    (engines built later, as the LoRA service builds its adapters', are
    not covered)."""
    class Served(cls):
        def __init__(self, *args, **kwargs):
            import torch

            from ray_tpu_torch.serve import llm

            if f32:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            with (f32_presets(llm.llama) if f32
                  else contextlib.nullcontext()):
                super().__init__(*args, **kwargs)

        def probe(self) -> dict:
            import torch

            cfg = self.engine.cfg if hasattr(self, "engine") else self.cfg
            cuda = torch.cuda.is_available()
            return {"cuda": cuda, "pid": os.getpid(), "dtype": str(cfg.dtype),
                    "device": torch.cuda.get_device_name(0) if cuda
                    else "cpu"}

        def reset_launches(self):
            from ray_tpu_torch.ops.cuda.flash_attention import reset_launches

            reset_launches()

        def launches(self) -> dict:
            from ray_tpu_torch.ops.cuda.flash_attention import launches

            return dict(launches)

    Served.__name__ = cls.__name__
    return Served


def sse_events(port: int, app: str, payload: dict, model_id: str = ""):
    """POST `payload` to the Serve HTTP proxy on `port` asking for
    server-sent events (Accept: text/event-stream), with `model_id` in the
    multiplexing header; yields each event's JSON as it arrives (urllib of
    the stdlib). An error event raises."""
    import urllib.request

    headers = {"Content-Type": "application/json",
               "Accept": "text/event-stream"}
    if model_id:
        headers["serve_multiplexed_model_id"] = model_id
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{app}", method="POST", headers=headers,
        data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        kind = resp.headers["Content-Type"]
        if not kind.startswith("text/event-stream"):
            raise RuntimeError(f"{app}: expected an event stream, got {kind}")
        for line in resp:
            if line.startswith(b"event: error"):
                raise RuntimeError(f"{app}: error event {resp.read()!r}")
            if line.startswith(b"data: "):
                yield json.loads(line[len(b"data: "):])


def http_submit(port: int, app: str):
    """A `submit(prompt, new)` for _stream_all over HTTP SSE: each request
    reads its stream on a thread of its own and hands the token ids to the
    event loop as they arrive."""
    import asyncio
    import threading

    async def submit(prompt, new):
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        done = object()

        def pump():
            try:
                for item in sse_events(port, app, {
                        "tokens": prompt, "max_new_tokens": new}):
                    loop.call_soon_threadsafe(queue.put_nowait, item)
                loop.call_soon_threadsafe(queue.put_nowait, done)
            except BaseException as e:  # handed to the consumer, raised
                loop.call_soon_threadsafe(queue.put_nowait, e)

        threading.Thread(target=pump, daemon=True).start()
        while True:
            item = await queue.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item["token"]
    return submit


def handle_submit(handle):
    """A `submit(prompt, new)` for _stream_all through a DeploymentHandle's
    stream (routed on an executor thread, as the HTTP proxy routes)."""
    import asyncio

    async def submit(prompt, new):
        gen = await asyncio.get_running_loop().run_in_executor(
            None, lambda: handle.options(stream=True).remote(
                {"tokens": prompt, "max_new_tokens": new}))
        async for item in gen:
            yield item["token"]
    return submit


def _call(handle, method: str, timeout: float):
    """The result of `method` of a deployment's callable, called through
    its handle."""
    return handle.options(method_name=method).remote().result(
        timeout=timeout)


def _tagged_stream(handle, model_id: str, prompt: list, new: int) -> list:
    """One request through the LoRA app's handle: its (token, adapter)
    items."""
    return [(d["token"], d["adapter"]) for d in handle.options(
        stream=True, multiplexed_model_id=model_id or None).remote(
        {"tokens": prompt, "max_new_tokens": new})]


def _gpus_free(rt, want: float, timeout_s: float = 60.0) -> float:
    """rt.available_resources()["GPU"] once it reads `want` (a killed
    replica returns its lease asynchronously), or its last reading."""
    deadline = time.monotonic() + timeout_s
    while True:
        free = rt.available_resources().get("GPU", 0.0)
        if free == want or time.monotonic() > deadline:
            return free
        time.sleep(0.2)


def phase_serve_app_410m(runtime: dict) -> dict:
    """The 410m engine behind the port's Serve plane: controller, replica,
    router (DeploymentHandle) and HTTP proxy, on the runtime phases'
    cluster. Parity in f32: LlamaService deployed with serve.deployment
    and ray_actor_options={"num_gpus": 1} holds the GPU while it lives
    (available GPU 0, then 1 after serve.delete); the runtime phase's
    three parity prompts sent one at a time as HTTP POSTs with Accept:
    text/event-stream stream the in-process engine's f32 tokens of
    runtime_serve_410m, token for token. Timing in bf16: serve.run(llm_app)
    and the same 16 concurrent requests once over HTTP SSE and once
    through the handle's stream, TTFT (first SSE chunk) and TPOT at the
    client beside runtime_serve_410m's actor and in-process readings.
    LoRA: lora_llm_app with rank-16 adapters, requests routed by
    multiplexed model id ad-a, ad-b, ad-a, ad-c: each stream tagged with
    its adapter, the seeded (zero-B) adapters' streams equal to the bare
    base's (a first request to the base's first, the repeat of ad-a, which
    hits the prefix store, to the base's repeat), two adapters resident
    before ad-c and ad-c among the two after. Returns the flash launch
    counts of each app's requests, read in the replica's process, and
    llm_app's latencies over HTTP (TTFT, TPOT, tokens/s)."""
    import asyncio

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm import (LlamaService, MultiplexedLoraService,
                                         llm_app, lora_llm_app)

    vocab = llama.config_for("410m").vocab_size
    paths = {}
    t0 = time.perf_counter()
    port = serve.start(http_port=0)
    try:
        # f32 parity through HTTP, the replica leased the node's GPU
        gpus = rt.available_resources().get("GPU", 0.0)
        dep = serve.deployment(served(LlamaService, f32=True),
                               ray_actor_options={"num_gpus": 1},
                               max_ongoing_requests=64)
        handle = serve.run(dep.bind("410m", seed=0, **ENGINE_410M),
                           name="llm_f32")
        probe = _call(handle, "probe", 600)
        gpus_while_up = rt.available_resources().get("GPU", 0.0)
        _call(handle, "reset_launches", 60)
        via_http = _one_at_a_time(http_submit(port, "llm_f32"),
                                  parity_requests(vocab))
        paths["serve_app_f32_http"] = _call(handle, "launches", 60)
        serve.delete("llm_f32")
        gpus_after = _gpus_free(rt, gpus)
        parity = via_http == runtime["parity_streams_in_process"]

        # bf16 timing through llm_app, over HTTP and through the handle
        app = llm_app("410m", **ENGINE_410M)
        app.deployment.func_or_class = served(LlamaService)
        handle = serve.run(app, name="llm")
        bf16_probe = _call(handle, "probe", 600)
        warm = _one_at_a_time(handle_submit(handle), [
            ([1 + i] * m, 4) for i, m in enumerate((100, 400, 1000))])
        requests = concurrent_requests(vocab)
        timed = {}
        for leg, submit in (("http", http_submit(port, "llm")),
                            ("handle", handle_submit(handle))):
            _call(handle, "reset_launches", 60)
            timed[leg] = asyncio.run(_stream_all(submit, requests))
            paths[f"serve_app_{leg}"] = _call(handle, "launches", 60)
        engine = _call(handle, "stats", 60)
        serve.delete("llm")
        complete = {leg: [len(s) for s in t["streams"]]
                    == [m for _, m in requests] for leg, t in timed.items()}

        # the LoRA app: routing by multiplexed model id, the LRU's residents
        app = lora_llm_app("410m", max_adapters_per_replica=2,
                           lora_rank=LORA_RANK_410M, **ENGINE_410M)
        app.deployment.func_or_class = served(MultiplexedLoraService)
        lora = serve.run(app, name="lora")
        prompt, new = parity_requests(vocab)[0]
        lora_probe = _call(lora, "probe", 600)
        _call(lora, "reset_launches", 60)
        # the bare base ("" id) first, cold and then again: a repeat of a
        # prompt hits its engine's prefix store, whose bf16 rounding
        # differs from a cold prefill's, so each adapter's stream is held
        # against the base's stream of the same kind
        base = {kind: [t for t, _ in _tagged_stream(lora, "", prompt, new)]
                for kind in ("cold", "warm")}
        adapters = ("ad-a", "ad-b", "ad-a", "ad-c")
        kinds = ("cold", "cold", "warm", "cold")
        tagged, resident = [], []
        lora._refresh(force=True)
        [replica] = lora._replicas
        for model_id in adapters:
            if model_id == "ad-c":
                resident.append(rt.get(replica.get_stats.remote(),
                                       timeout=60)["models"])
            tagged.append(_tagged_stream(lora, model_id, prompt, new))
        resident.append(rt.get(replica.get_stats.remote(),
                               timeout=60)["models"])
        paths["serve_app_lora"] = _call(lora, "launches", 60)
    finally:
        serve.shutdown()
    tags_ok = all(len(items) == new and {a for _, a in items} == {model_id}
                  for model_id, items in zip(adapters, tagged))
    zero_b_equal = all([t for t, _ in items] == base[kind]
                       for kind, items in zip(kinds, tagged))
    residency_ok = (sorted(resident[0]) == ["ad-a", "ad-b"]
                    and len(resident[1]) == 2 and "ad-c" in resident[1])
    summary = {leg: _latencies(t) for leg, t in timed.items()}
    res = {"f32_replica_probe": probe, "bf16_replica_probe": bf16_probe,
           "lora_replica_probe": lora_probe,
           "gpu_before": gpus, "gpu_while_f32_replica_up": gpus_while_up,
           "gpu_after_delete": gpus_after,
           "parity_streams_equal": parity, "parity_streams_http": via_http,
           "concurrent_requests": len(requests),
           "prompt_tokens": sum(len(p) for p, _ in requests),
           "generated_tokens": sum(m for _, m in requests),
           "complete": complete,
           "completed_requests": {
               leg: sum(len(s) == m for s, (_, m) in zip(t["streams"],
                                                         requests))
               for leg, t in timed.items()},
           **summary,
           "runtime_actor": {k: runtime["actor"][k] for k in (
               "ttft", "tpot", "tokens_per_s", "wall_s")},
           "runtime_in_process": {k: runtime["in_process"][k] for k in (
               "ttft", "tpot", "tokens_per_s", "wall_s")},
           "engine_after_timing": {k: engine[k] for k in (
               "prefills", "prefill_chunks", "batches", "generated_tokens")},
           "lora_adapters": list(adapters), "lora_tags_ok": tags_ok,
           "lora_streams": [[t for t, _ in items] for items in tagged],
           "lora_base_streams": base,
           "lora_warm_equals_cold": base["warm"] == base["cold"],
           "lora_zero_b_equal_base": zero_b_equal,
           "lora_resident_before_ad_c": resident[0],
           "lora_resident_after": resident[1],
           "launches": paths, "phase_s": time.perf_counter() - t0,
           "card": card_line()}
    ok = (parity and all(complete.values()) and tags_ok and zero_b_equal
          and residency_ok and probe["cuda"]
          and probe["dtype"] == "torch.float32"
          and bf16_probe["dtype"] == "torch.bfloat16"
          and gpus == 1.0 and gpus_while_up == 0.0 and gpus_after == 1.0)
    emit("serve_app_410m", **res, ok=ok)
    if not ok:
        raise AssertionError("serve_app_410m failed its checks")
    return paths, {**summary["http"], "streams": timed["http"]["streams"]}


# ------------------------------------------------ the compiled-graph plane
# dag_device's cross-process edge: layer 0's K cache of runtime_device_
# objects in bf16 and an f32 tensor of the same byte size, 33.5 MB each
DAG_KV_SHAPE = (8, 2048, 16, 64)
DAG_F32_SHAPE = (4, 2048, 16, 64)
DAG_DEVICE_TICKS = 10          # timed, after 2 warm-up ticks
DAG_TRAIN_TICKS = 3            # timed, after 2 warm-up ticks


def _seeded_payload(seed: int) -> dict:
    """dag_device's edge payload on the card, drawn from `seed`: a bf16
    tensor of DAG_KV_SHAPE and an f32 one of DAG_F32_SHAPE; any process
    on the same card draws the same bits."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn(DAG_KV_SHAPE, generator=gen, device="cuda")
    v = torch.randn(DAG_F32_SHAPE, generator=gen, device="cuda")
    return {"k": k.to(torch.bfloat16), "v": v}


def _same_bits(got: dict, want: dict) -> bool:
    import torch

    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return all(got[key].is_cuda and got[key].dtype == want[key].dtype
               and torch.equal(got[key].view(ints[got[key].dtype]),
                               want[key].view(ints[want[key].dtype]))
               for key in want)


class DagStage:
    """An actor of dag_device, leased half the card: `make` draws the
    seeded payload on the card and returns it onto a device edge (never
    touching it again); `check` receives it rebuilt in its own process and
    draws the same payload to compare, bit for bit; `load` checks a
    broadcast of weights the same way."""

    def __init__(self):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("a GPU-leased actor sees no CUDA device")

    def make(self, seed: int) -> dict:
        return {"seed": seed, **_seeded_payload(seed)}

    def check(self, payload: dict) -> dict:
        import torch

        torch.cuda.synchronize()
        want = _seeded_payload(payload["seed"])
        return {"seed": payload["seed"], "on_cuda": all(
            payload[k].is_cuda for k in ("k", "v")),
            "bit_equal": _same_bits(payload, want),
            "dtypes": [str(payload[k].dtype) for k in ("k", "v")]}

    def load(self, weights: dict) -> dict:
        want = _seeded_payload(weights["seed"])
        return {"on_cuda": all(weights[k].is_cuda for k in ("k", "v")),
                "bit_equal": _same_bits(weights, want)}


def phase_dag_device(fetch_mb_per_s: float) -> dict:
    """Device edges of a compiled DAG on the card. (1) A same-process
    DeviceChannel hands a CUDA tensor over: the read is the same object
    with the same data_ptr. (2) Two DagStage actors, each leased
    num_gpus=0.5: make -> check over a with_tensor_transport() edge
    carrying a bf16 and an f32 CUDA tensor (33.5 MB each); the consumer's
    tensors are on cuda and bit-equal to the producer's draw; ticks/s and
    MB/s of the edge over DAG_DEVICE_TICKS timed ticks, beside
    runtime_device_objects' host-staged fetch of this run
    (`fetch_mb_per_s`). (3) device_input=True broadcasts CUDA weights from
    the driver to both actors, bit-equal in each. Then the DAG legs of
    _internal/perf.run_microbenchmarks on this host."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._internal.perf import run_microbenchmarks
    from ray_tpu_torch.dag import InputNode, MultiOutputNode
    from ray_tpu_torch.dag.device_channel import DeviceChannel, attach_device

    t_phase = time.perf_counter()
    # (1) the same-process handoff: the tensor object itself
    ch = DeviceChannel.create(n_slots=2)
    peer = attach_device(ch.spec)
    sent = _seeded_payload(0)["k"]
    ch.write(sent)
    got = peer.read(timeout=10)
    same_object = got is sent and got.data_ptr() == sent.data_ptr()
    peer.close()
    ch.close()

    # (2) a cross-process device edge between two actors sharing the card
    stage = rt.remote(num_gpus=0.5, max_restarts=0)(DagStage)
    prod, cons = stage.remote(), stage.remote()
    gpus_while_up = _gpus_free(rt, 0.0)
    payload_bytes = 2 * math.prod(DAG_KV_SHAPE) * 2
    with InputNode() as inp:
        out = cons.check.bind(prod.make.bind(inp).with_tensor_transport())
    dag = out.experimental_compile(
        buffer_size_bytes=payload_bytes + (1 << 20), max_inflight=2)
    kinds = dict(dag.channel_kinds)
    checks, tick_s = [], []
    try:
        for i in range(2 + DAG_DEVICE_TICKS):
            t0 = time.perf_counter()
            checks.append(dag.execute(i).get(timeout=120))
            if i >= 2:
                tick_s.append(time.perf_counter() - t0)
    finally:
        dag.teardown()
    edge_ok = all(c["on_cuda"] and c["bit_equal"] and c["seed"] == i
                  for i, c in enumerate(checks))

    # (3) device_input=True: the driver's CUDA weights to both actors
    with InputNode() as inp:
        bcast = MultiOutputNode([prod.load.bind(inp), cons.load.bind(inp)])
    bdag = bcast.experimental_compile(
        device_input=True, buffer_size_bytes=payload_bytes + (1 << 20),
        max_inflight=2)
    try:
        loads = [bdag.execute({"seed": s, **_seeded_payload(s)}).get(
            timeout=120) for s in (7, 8)]
        bcast_kinds = dict(bdag.channel_kinds)
    finally:
        bdag.teardown()
    bcast_ok = all(r["on_cuda"] and r["bit_equal"] for pair in loads
                   for r in pair)
    rt.kill(prod)
    rt.kill(cons)
    gpus_after = _gpus_free(rt, 1.0)

    # _internal/perf's DAG legs on this host (0.5 s a leg), the device
    # legs' tensors on the card
    records = run_microbenchmarks(duration=0.5, device="cuda")
    bench = {r["benchmark"]: r["rate_per_s"] for r in records}
    perf_devices = sorted({r["device"] for r in records if "device" in r})
    med = statistics.median(tick_s)
    res = {"same_process_same_object": same_object,
           "channel_kinds": kinds, "edge_payload_mbytes": payload_bytes / 1e6,
           "edge_dtypes": checks[0]["dtypes"], "edge_ticks": len(checks),
           "edge_bit_equal": edge_ok, "edge_tick_ms": _percentiles(tick_s),
           "edge_ticks_per_s": 1.0 / med,
           "edge_mb_per_s": payload_bytes / 1e6 / med,
           "device_object_fetch_mb_per_s": fetch_mb_per_s,
           "broadcast_channel_kinds": bcast_kinds,
           "broadcast_bit_equal": bcast_ok,
           "gpu_while_actors_up": gpus_while_up,
           "gpu_after_kill": gpus_after,
           "perf_dag": {k: v for k, v in bench.items() if "dag" in k},
           "perf_other": {k: v for k, v in bench.items() if "dag" not in k},
           "perf_device_legs_on": perf_devices,
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    ok = (same_object and edge_ok and bcast_ok and kinds["device"] == 1
          and bcast_kinds["device"] == 2 and gpus_while_up == 0.0
          and gpus_after == 1.0 and perf_devices == ["cuda"])
    emit("dag_device", **res, ok=ok)
    if not ok:
        raise AssertionError("dag_device failed its checks")
    return res


class DagFeeder:
    """dag_train_410m's feeder, a CPU actor that never imports torch: it
    holds batch_410m's seeded batch as numpy and sends it every tick as
    host arrays marked for the device framing (wrap_host_arrays), so the
    learner rebuilds them on its card."""

    def __init__(self, batch: dict):
        self._batch = batch

    def batch(self, tick: int) -> dict:
        from ray_tpu_torch.dag.device_channel import wrap_host_arrays

        return wrap_host_arrays(self._batch)[0]

    def torch_loaded(self) -> bool:
        return "torch" in sys.modules


class DagLearner:
    """dag_train_410m's learner, leased the GPU: train_410m's model and
    step (config_410m, params from seed 0, adamw(3e-4)); `step` runs one
    train step on the batch the edge rebuilt on the card and reports its
    loss, the flash launches it made and its time."""

    def __init__(self):
        import gc

        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("a GPU-leased actor sees no CUDA device")
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.parallel.spmd import adamw, build_train_step

        cfg = config_410m()
        params = llama.init_params(cfg, seed=0)
        self._step, self._state = build_train_step(
            lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4), params)
        params.clear()
        gc.collect()

    def step(self, batch: dict) -> dict:
        import torch

        from ray_tpu_torch.ops.cuda.flash_attention import (launches,
                                                            reset_launches)

        on_card = {k: (v.is_cuda, str(v.dtype)) for k, v in batch.items()}
        reset_launches()
        t0 = time.perf_counter()
        # the DAG loop runs on a thread of its own: grad mode is per thread
        with torch.enable_grad():
            self._state, aux = self._step(self._state, batch)
            loss = aux["loss"].item()
        return {"loss": loss, "launches": dict(launches),
                "step_ms": (time.perf_counter() - t0) * 1e3,
                "batch": on_card}

    def gpu_free(self) -> float:
        import ray_tpu_torch as rt

        return rt.available_resources().get("GPU", 0.0)


def phase_dag_train_410m(reference_losses: list, step_ms: float) -> dict:
    """train_410m's step driven through a compiled DAG: InputNode ->
    feeder.batch (a CPU actor, numpy over a with_tensor_transport() edge)
    -> learner.step (an actor leased the GPU, on the CUDA tensors the edge
    rebuilt). 2 + DAG_TRAIN_TICKS ticks: the losses equal train_410m's
    in-process losses to 1e-6 relative, the learner counts 48/24/24 flash
    launches a tick, the GPU reads 0 free while the learner lives and 1
    after the teardown; tick ms beside the in-process step ms."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    cfg = config_410m()
    batch = {k: v.cpu().numpy() for k, v in batch_410m(cfg.vocab_size).items()}
    t_phase = time.perf_counter()
    feeder = rt.remote(num_cpus=1, max_restarts=0)(DagFeeder).remote(batch)
    learner = rt.remote(num_gpus=1, max_restarts=0)(DagLearner).remote()
    with InputNode() as inp:
        out = learner.step.bind(feeder.batch.bind(inp).with_tensor_transport())
    dag = out.experimental_compile(max_inflight=2)
    kinds = dict(dag.channel_kinds)
    ticks, tick_s = [], []
    try:
        for i in range(2 + DAG_TRAIN_TICKS):
            t0 = time.perf_counter()
            ticks.append(dag.execute(i).get(timeout=900))
            if i >= 2:
                tick_s.append(time.perf_counter() - t0)
        gpus_while_up = rt.get(learner.gpu_free.remote(), timeout=60)
        feeder_torch = rt.get(feeder.torch_loaded.remote(), timeout=60)
    finally:
        dag.teardown()
    rt.kill(learner)
    rt.kill(feeder)
    gpus_after = _gpus_free(rt, 1.0)
    losses = [t["loss"] for t in ticks]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, reference_losses)]
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers}
    launches = {k: sum(t["launches"][k] for t in ticks[2:]) for k in want}
    res = {"channel_kinds": kinds, "losses": losses,
           "reference_losses": reference_losses[:len(losses)],
           "rel_diff": rel, "tolerance": 1e-6,
           "launches_per_tick": [t["launches"] for t in ticks],
           "expected_per_tick": want, "batch_on_card": ticks[0]["batch"],
           "tick_ms": [s * 1e3 for s in tick_s],
           "learner_step_ms": [t["step_ms"] for t in ticks[2:]],
           "in_process_step_ms": step_ms,
           "tick_vs_in_process": statistics.median(tick_s) * 1e3 / step_ms,
           "feeder_imported_torch": feeder_torch,
           "gpu_while_learner_up": gpus_while_up,
           "gpu_after_teardown": gpus_after,
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    ok = (len(rel) == 2 + DAG_TRAIN_TICKS and max(rel) <= 1e-6
          and all(t["launches"] == want for t in ticks)
          and all(c for c, _ in ticks[0]["batch"].values())
          and kinds["device"] == 1 and not feeder_torch
          and gpus_while_up == 0.0 and gpus_after == 1.0)
    emit("dag_train_410m", **res, ok=ok)
    if not ok:
        raise AssertionError("dag_train_410m failed its checks")
    return launches


def _disagg_app(f32: bool):
    """disagg_llm_app("410m") with the serve phases' engine, its two
    deployments (the same classes, the same bind graph) leased half the
    card each and wrapped by `served` (f32: float32, TF32 off)."""
    from ray_tpu_torch.serve.llm import disagg_llm_app

    app = disagg_llm_app("410m", seed=0, **ENGINE_410M)
    for node in app.walk():
        cls = node.deployment.func_or_class
        node.deployment = node.deployment.options(
            ray_actor_options={"num_gpus": 0.5})
        node.deployment.func_or_class = served(cls, f32=f32)
    return app


def phase_disagg_app_410m(runtime: dict, llm_app_run: dict) -> dict:
    """disagg_llm_app's two pools of the 410m engine behind the Serve
    plane, leased half the card each. f32 (TF32 off): the 3 parity
    requests over HTTP SSE, one at a time, stream runtime_serve_410m's
    in-process tokens; the GPU reads 0 free while the pools live and 1
    after serve.delete. bf16: the 16 concurrent requests over HTTP SSE
    (TTFT, TPOT, tokens/s beside serve_app_410m's llm_app over HTTP from
    this run), each stream equal to llm_app's of the same request (both
    cold: no prefix-store hit; the decode batch is max_batch fixed slots,
    so a row's tokens do not depend on its neighbours); the handoffs the
    decode pool read in that window, from its stats (edge kinds, bytes,
    the call's and the read's ms as awaited there); the decode pool ran
    no prefill; no flash kernel launched in either pool."""
    import asyncio

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.handle import DeploymentHandle

    vocab = llama.config_for("410m").vocab_size
    shm = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t_phase = time.perf_counter()
    launches = {}
    port = serve.start(http_port=0)
    try:
        gpus = _gpus_free(rt, 1.0)
        handle = serve.run(_disagg_app(f32=True), name="disagg_f32")
        prefill = DeploymentHandle("PrefillWorker", "disagg_f32")
        probes = {"decode": _call(handle, "probe", 600),
                  "prefill": _call(prefill, "probe", 600)}
        gpus_while_up = rt.available_resources().get("GPU", 0.0)
        via_http = _one_at_a_time(http_submit(port, "disagg_f32"),
                                  parity_requests(vocab))
        serve.delete("disagg_f32")
        gpus_after = _gpus_free(rt, gpus)
        parity = via_http == runtime["parity_streams_in_process"]

        handle = serve.run(_disagg_app(f32=False), name="disagg")
        prefill = DeploymentHandle("PrefillWorker", "disagg")
        bf16_probe = _call(handle, "probe", 600)
        _one_at_a_time(handle_submit(handle), [
            ([1 + i] * m, 4) for i, m in enumerate((100, 400, 1000))])
        for h in (handle, prefill):
            _call(h, "reset_launches", 60)
        requests = concurrent_requests(vocab)
        stats0 = _call(handle, "stats", 60)
        timed = asyncio.run(_stream_all(http_submit(port, "disagg"),
                                        requests))
        stats1 = _call(handle, "stats", 60)
        for role, h in (("decode", handle), ("prefill", prefill)):
            launches[role] = _call(h, "launches", 60)
        serve.delete("disagg")
    finally:
        serve.shutdown()
    complete = [len(s) for s in timed["streams"]] == [m for _, m in requests]
    bf16_equal = [a == b for a, b in zip(timed["streams"],
                                         llm_app_run["streams"])]
    summed = {k: launches["decode"].get(k, 0) + launches["prefill"].get(k, 0)
              for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    delta = {k: stats1[k] - stats0[k] for k in (
        "prefills", "kv_handoffs", "handoff_reads", "handoff_bytes",
        "handoff_call_s", "handoff_read_s", "handoff_on_engine_device")}
    edges = {k: n - stats0["handoff_edges"].get(k, 0)
             for k, n in stats1["handoff_edges"].items()}
    reads = delta["handoff_reads"]
    handoffs = {"reads": reads, "edges": edges,
                "on_card": delta["handoff_on_engine_device"],
                "bytes_mean": delta["handoff_bytes"] / reads,
                "call_ms_mean": delta["handoff_call_s"] * 1e3 / reads,
                "read_ms_mean": delta["handoff_read_s"] * 1e3 / reads,
                "read_mb_per_s": (delta["handoff_bytes"] / 1e6
                                  / delta["handoff_read_s"]),
                "ring_bytes_a_request": 2 * stats1["handoff_slot_bytes"]}
    res = {"dev_shm": shm, "probes": probes, "bf16_probe": bf16_probe,
           "gpu_before": gpus, "gpu_while_pools_up": gpus_while_up,
           "gpu_after_delete": gpus_after, "parity_streams_equal": parity,
           "parity_streams_http": via_http,
           "concurrent_requests": len(requests), "complete": complete,
           "bf16_streams_equal_llm_app": sum(bf16_equal),
           "http": _latencies(timed),
           "serve_app_llm_app_http": {k: v for k, v in llm_app_run.items()
                                      if k != "streams"},
           "decode_prefills": delta["prefills"],
           "decode_kv_handoffs": delta["kv_handoffs"],
           "handoffs": handoffs, "flash_launches": launches,
           "phase_s": time.perf_counter() - t_phase, "card": card_line()}
    ok = (parity and complete and gpus == 1.0 and gpus_while_up == 0.0
          and gpus_after == 1.0
          and all(p["cuda"] and p["dtype"] == "torch.float32"
                  for p in probes.values())
          and bf16_probe["dtype"] == "torch.bfloat16"
          and len(bf16_equal) == len(requests) and all(bf16_equal)
          and res["decode_prefills"] == 0
          and res["decode_kv_handoffs"] == len(requests)
          and reads == len(requests) and edges == {"shm": len(requests)}
          and handoffs["on_card"] == len(requests)
          and not any(summed.values()))
    emit("disagg_app_410m", **res, ok=ok)
    if not ok:
        raise AssertionError("disagg_app_410m failed its checks")
    return summed


# ------------------------------------------------------------------- RL
RL_PHASES = ("rl_parity", "rl_ppo_cartpole", "rl_impala_cartpole",
             "rl_impala_catch_cnn", "rl_offpolicy", "rl_multi_agent")
RL_TIMED_CALLS = 3      # timed updates per device, after one warm-up


@contextlib.contextmanager
def tf32_off():
    """f32 matmuls and convolutions as f32 (cuDNN's convolutions default to
    TF32), restored on the way out."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _rel_tree(a, b) -> float:
    """The largest per-leaf relative L2 distance of two params trees."""
    from ray_tpu_torch.rl.module import tensor_leaves

    worst = 0.0
    for x, y in zip(tensor_leaves(a), tensor_leaves(b)):
        x, y = x.detach().double().cpu(), y.detach().double().cpu()
        worst = max(worst, float((x - y).norm() / max(float(y.norm()),
                                                      1e-30)))
    return worst


def _timed_ms(fn) -> float:
    """Median wall ms of RL_TIMED_CALLS calls of `fn` (each returns host
    floats, so it waits for the device), after one warm-up call."""
    fn()
    times = []
    for _ in range(RL_TIMED_CALLS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rl_ppo_batch(rng, n: int) -> dict:
    """A seeded flat PPO batch of n CartPole timesteps."""
    import numpy as np

    return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "logp_old": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "returns": rng.normal(size=n).astype(np.float32) * 10}


def rl_impala_batch(rng, T: int, B: int, obs_shape: tuple) -> dict:
    """A seeded IMPALA batch [T, B, ...] as an aggregator releases it."""
    import numpy as np

    dones = rng.random((T, B)) < 0.05
    return {"obs": rng.random((T, B) + obs_shape).astype(np.float32),
            "last_obs": rng.random((B,) + obs_shape).astype(np.float32),
            "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, (T, B))).astype(np.float32),
            "rewards": rng.normal(size=(T, B)).astype(np.float32),
            "dones": dones,
            "trunc_values": np.zeros((T, B), np.float32)}


def rl_replay_batch(rng, obs: int, B: int, continuous: int = 0) -> dict:
    import numpy as np

    actions = (rng.uniform(-1, 1, (B, continuous)).astype(np.float32)
               if continuous else rng.integers(0, 2, B).astype(np.int32))
    return {"obs": rng.normal(size=(B, obs)).astype(np.float32),
            "actions": actions,
            "rewards": rng.normal(size=B).astype(np.float32),
            "next_obs": rng.normal(size=(B, obs)).astype(np.float32),
            "dones": rng.random(B) < 0.1}


def phase_rl_parity() -> dict:
    """Each RL update on the card against the same update on the CPU, in
    f32 with TF32 off for matmul and cuDNN: the same init (drawn on the
    CPU from the same seed), the same seeded batch, two updates each; the
    params agree to 1e-4 relative L2 per leaf. The shapes are the learning
    phases': PPO 2048 timesteps in minibatches of 256 for 6 epochs; IMPALA
    and APPO [64, 8] CartPole and [32, 32, 10, 10, 1] Catch batches; DQN
    and SAC minibatches of 128 (SAC with the same normal draws on both),
    BC and CQL of 512.
    Also the update's wall ms on each device (the median of 3 timed calls
    after those two)."""
    import cloudpickle
    import numpy as np
    import torch

    from ray_tpu_torch.rl import dqn, impala, learner, module, offline, sac

    t0 = time.perf_counter()
    rows = {}

    def compare(name, make, run, tol=1e-4):
        card, cpu = make("cuda"), make("cpu")
        for i in range(2):
            run(card, i)
            run(cpu, i)
        rel = _rel_tree(card.params, cpu.params)
        rows[name] = {"rel_l2": rel, "tolerance": tol,
                      "card_ms": _timed_ms(lambda: run(card, 0)),
                      "cpu_ms": _timed_ms(lambda: run(cpu, 0))}

    with tf32_off():
        rng = np.random.default_rng(0)
        ppo_batch = rl_ppo_batch(rng, 2048)
        lcfg = learner.PPOLearnerConfig(lr=1e-3, entropy_coeff=0.0,
                                        minibatch_size=256, num_epochs=6)
        mlp = module.MLPModuleConfig(4, 2)
        compare("ppo", lambda dev: learner.TorchLearner(
            cloudpickle.dumps(mlp), cloudpickle.dumps(lcfg), 3,
            device=None if dev == "cuda" else "cpu"),
            lambda lr, i: lr.update(dict(ppo_batch)))
        for arch, appo in (("mlp", False), ("mlp", True), ("cnn", False),
                           ("cnn", True)):
            if arch == "mlp":
                mod, batch = mlp, rl_impala_batch(rng, 64, 8, (4,))
            else:
                mod = module.CNNModuleConfig((10, 10, 1), 3)
                batch = rl_impala_batch(rng, 32, 32, (10, 10, 1))
            compare(f"{'appo' if appo else 'impala'}_{arch}",
                    lambda dev, mod=mod, appo=appo: impala.IMPALALearner(
                        cloudpickle.dumps(mod), cloudpickle.dumps(
                            impala.IMPALAConfig(
                                use_appo_loss=appo, lr=3e-3,
                                num_gpus_per_learner=int(dev == "cuda")))),
                    lambda lr, i, batch=batch: lr.update(dict(batch)))
        dbatch = rl_replay_batch(rng, 4, 128)
        compare("dqn", lambda dev: dqn.DQNLearner(
            mlp, dqn.DQNConfig(target_update_freq=50), dev),
            lambda lr, i: float(lr.update(lr.to_device(dbatch))))
        sbatch = rl_replay_batch(rng, 1, 128, continuous=1)
        noise = [(rng.normal(size=(128, 1)), rng.normal(size=(128, 1)))
                 for _ in range(2)]
        ccfg = module.ContinuousModuleConfig(1, 1, hidden=(32, 32))
        compare("sac", lambda dev: sac.SACLearner(
            ccfg, sac.SACConfig(actor_lr=3e-3, critic_lr=3e-3,
                                alpha_lr=3e-3, initial_alpha=0.2), dev),
            lambda lr, i: {k: float(v) for k, v in lr.update(
                lr.to_device(sbatch), noise=noise[i]).items()})
        # the offline learners at test_rl_offline's minibatch of 512
        obatch = rl_replay_batch(rng, 4, 512)
        compare("bc", lambda dev: offline.BCLearner(
            mlp, offline.BCConfig(lr=3e-3), dev),
            lambda lr, i: float(lr.update(lr.to_device(
                {k: obatch[k] for k in ("obs", "actions")}))))
        compare("cql", lambda dev: offline.CQLLearner(
            mlp, offline.CQLConfig(), dev),
            lambda lr, i: float(lr.update(lr.to_device(obatch))))
        torch.cuda.synchronize()
    ok = all(r["rel_l2"] <= r["tolerance"] for r in rows.values())
    emit("rl_parity", updates=rows, phase_s=time.perf_counter() - t0,
         card=card_line(), ok=ok)
    if not ok:
        raise AssertionError("rl_parity failed its checks")
    return rows


def _runner_cuda(runners) -> list:
    """Each env runner's answer to "has this process initialised CUDA"."""
    return runners.foreach(lambda a: a.cuda_initialized.remote())


def _rl_flash_launches() -> dict:
    from ray_tpu_torch.ops.cuda.flash_attention import launches

    return dict(launches)


def _launch_sum(by_process: dict) -> dict:
    """Flash launches of a path: its processes' counts added up."""
    out: dict = {}
    for counts in by_process.values():
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


def _flash_launches_of(actor_self) -> dict:
    """Run in an actor's process (``__rayt_apply__``): its flash counts."""
    return _rl_flash_launches()


def _actor_flash_launches(rt, actor) -> dict:
    from ray_tpu_torch.api import ActorMethod

    return rt.get(ActorMethod(actor, "__rayt_apply__").remote(
        _flash_launches_of), timeout=60)


def _input_edge_bytes(dag) -> dict:
    """Writes and bytes of a compiled DAG's device input edges (the weight
    broadcasts), from the driver's channel stats."""
    chans = list(getattr(dag, "_device_input_channels", []))
    writes = sum(ch.stats.writes for ch in chans)
    nbytes = sum(ch.stats.bytes_written for ch in chans)
    return {"edges": len(chans), "writes": writes, "bytes": nbytes,
            "bytes_per_write": nbytes / writes if writes else 0.0,
            "device_arrays": sum(ch.device_arrays for ch in chans)}


def _tree_nbytes(tree) -> int:
    import numpy as np

    from ray_tpu_torch.rl.impala import _tree_leaves

    return sum(int(np.asarray(x).nbytes) for x in _tree_leaves(tree)
               if hasattr(x, "shape"))


def _stop_and_free(rt, algo) -> float:
    algo.stop()
    return _gpus_free(rt, 1.0)


def phase_rl_ppo_cartpole() -> dict:
    """test_ppo_learns_cartpole's config with its learner leased the GPU
    (num_gpus_per_learner=1, the default) and the weights broadcast over
    device input edges of the compiled sampling DAG: best >= 80 within 25
    iterations (and above twice the first return, capped at 40), the
    learner on cuda, the GPU reading 0 free while it lives and 1 after
    stop(), no runner with a CUDA context after reading the weights;
    build and first-iteration seconds (the learner's process start and
    CUDA context), iteration seconds, env-steps/s, the broadcast's bytes."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops.cuda.flash_attention import reset_launches
    from ray_tpu_torch.rl import PPOConfig

    reset_launches()
    t0 = time.perf_counter()
    algo = PPOConfig(num_env_runners=2, num_envs_per_runner=8,
                     rollout_fragment_length=64, lr=1e-3, entropy_coeff=0.0,
                     minibatch_size=256, num_epochs=6, seed=3).build()
    build_s = time.perf_counter() - t0
    first, best, iters, results = None, 0.0, 0, []
    try:
        placement = rt.get(algo._learners[0].placement.remote(), timeout=120)
        gpu_up = _gpus_free(rt, 0.0)
        for i in range(25):
            r = algo.train()
            results.append(r)
            iters = i + 1
            ret = r["episode_return_mean"]
            if first is None and ret > 0:
                first = ret
            best = max(best, ret)
            if best >= 80.0 and i >= 4:
                break
        runner_cuda = _runner_cuda(algo._runners)
        kinds = dict(algo._dag.channel_kinds)
        edges = _input_edge_bytes(algo._dag.dag)
        weights_bytes = _tree_nbytes(algo._weights)
        learner_flash = _actor_flash_launches(rt, algo._learners[0])
    finally:
        gpu_after = _stop_and_free(rt, algo)
    iter_s = [r["time_this_iter_s"] for r in results]
    steps = sum(r["num_env_steps_sampled"] for r in results)
    res = {"best": best, "first": first, "iterations": iters,
           "gate": {"best": 80.0, "within": 25}, "placement": placement,
           "gpu_while_learner_up": gpu_up, "gpu_after_stop": gpu_after,
           "runner_cuda_initialized": runner_cuda, "channel_kinds": kinds,
           "weight_broadcast": {**edges, "weights_bytes": weights_bytes},
           "build_s": build_s, "first_iteration_s": iter_s[0],
           "time_to_first_update_s": build_s + iter_s[0],
           "iteration_s": iter_s,
           "env_steps_per_s": steps / sum(iter_s[1:] or iter_s),
           "updates_per_s": len(iter_s) / sum(iter_s),
           "flash_launches": {"driver": _rl_flash_launches(),
                              "learner": learner_flash},
           "phase_s": time.perf_counter() - t0, "card": card_line()}
    ok = (first is not None and best >= 80.0 and best > 2 * min(first, 40.0)
          and placement["device"].startswith("cuda")
          and gpu_up == 0.0 and gpu_after == 1.0
          and runner_cuda == [False, False] and kinds.get("device", 0) > 0
          and edges["device_arrays"] > 0
          and not any(learner_flash.values()))
    emit("rl_ppo_cartpole", **res, ok=ok)
    if not ok:
        raise AssertionError("rl_ppo_cartpole failed its checks")
    return _launch_sum(res["flash_launches"])


def _impala_run(rt, config, iters: int, gate: float) -> dict:
    """Drive an IMPALA/APPO config until its best mean return reaches
    `gate` (at most `iters` iterations after one warm-up) and read what the
    phases check."""
    import numpy as np

    t_phase = t0 = time.perf_counter()
    algo = config.build()
    build_s = time.perf_counter() - t0
    best, results = -1e9, []
    try:
        gpu_up = _gpus_free(rt, 0.0)
        t1 = time.perf_counter()
        warm = algo.train()
        first_s = time.perf_counter() - t1
        s0, t0 = algo._total_steps, time.perf_counter()
        updates = 0
        for _ in range(iters):
            r = algo.train()
            results.append(r)
            updates += r["num_learner_updates"]
            best = max(best, r["episode_return_mean"])
            if best >= gate:
                break
        dt = time.perf_counter() - t0
        placement = rt.get(algo._learner.placement.remote(), timeout=60)
        runner_cuda = _runner_cuda(algo._runners)
        kinds = dict(algo._dag.channel_kinds)
        edges = _input_edge_bytes(algo._dag.dag)
        weights = rt.get(algo._learner.get_weights.remote(), timeout=60)
        learner_flash = _actor_flash_launches(rt, algo._learner)
        cfg = algo.config
        T, B = cfg.rollout_fragment_length, cfg.num_envs_per_runner
        per_step = _tree_nbytes(rl_impala_batch(
            np.random.default_rng(0), T, B,
            tuple(getattr(algo.module_cfg, "obs_shape", None)
                  or (algo.module_cfg.observation_size,)))) / (T * B)
    finally:
        gpu_after = _stop_and_free(rt, algo)
    return {"best": best, "iterations": len(results),
            "warmup_iteration": {k: warm[k] for k in (
                "episode_return_mean", "num_learner_updates",
                "time_this_iter_s")},
            "build_s": build_s, "time_to_first_update_s": build_s + first_s,
            "iteration_s": [r["time_this_iter_s"] for r in results],
            "env_steps_per_s": (algo._total_steps - s0) / dt,
            "updates_per_s": updates / dt, "updates": updates,
            "placement": placement, "gpu_while_learner_up": gpu_up,
            "gpu_after_stop": gpu_after,
            "runner_cuda_initialized": runner_cuda, "channel_kinds": kinds,
            "weight_broadcast": {**edges,
                                 "weights_bytes": _tree_nbytes(weights)},
            "batch_edge_bytes_per_timestep": per_step,
            "batch_edge_bytes": per_step * cfg.train_batch_size,
            "flash_launches": {"driver": _rl_flash_launches(),
                               "learner": learner_flash},
            "phase_s": time.perf_counter() - t_phase, "card": card_line()}


def _impala_ok(res: dict, gate: float) -> bool:
    arrivals = res["placement"]["batch_arrivals"]
    return (res["best"] >= gate
            and res["placement"]["device"].startswith("cuda")
            and set(arrivals) == {res["placement"]["device"]}
            and res["gpu_while_learner_up"] == 0.0
            and res["gpu_after_stop"] == 1.0
            and not any(res["runner_cuda_initialized"])
            and res["channel_kinds"].get("device", 0) > 0
            and res["weight_broadcast"]["device_arrays"] > 0
            and not any(res["flash_launches"]["learner"].values()))


def phase_rl_impala_cartpole() -> dict:
    """test_impala_learns_cartpole's config with its learner leased the
    GPU: the aggregator->learner batch edges and the weight edges
    device-kind, every batch arriving in the learner as CUDA tensors;
    best >= 100 within 40 iterations, env-steps/s >= 250 and updates/s >=
    0.25 (the test's floors)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops.cuda.flash_attention import reset_launches
    from ray_tpu_torch.rl import IMPALAConfig

    reset_launches()
    res = _impala_run(rt, IMPALAConfig(
        env="CartPole-v1", num_env_runners=2, num_envs_per_runner=8,
        rollout_fragment_length=64, train_batch_size=512, vf_coeff=0.25,
        lr=1e-3, entropy_coeff=0.01, seed=1), 40, 100.0)
    res["floors"] = {"env_steps_per_s": 250.0, "updates_per_s": 0.25}
    ok = (_impala_ok(res, 100.0) and res["env_steps_per_s"] >= 250.0
          and res["updates_per_s"] >= 0.25)
    emit("rl_impala_cartpole", **res, ok=ok)
    if not ok:
        raise AssertionError("rl_impala_cartpole failed its checks")
    return _launch_sum(res["flash_launches"])


def phase_rl_impala_catch_cnn() -> dict:
    """test_impala_learns_catch_with_cnn's config (Catch [10, 10, 1], the
    CNN learner on the card): best >= -0.2 within 60 iterations."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops.cuda.flash_attention import reset_launches
    from ray_tpu_torch.rl import IMPALAConfig

    reset_launches()
    res = _impala_run(rt, IMPALAConfig(
        env="Catch-v0", num_env_runners=2, num_envs_per_runner=16,
        rollout_fragment_length=32, train_batch_size=1024,
        min_updates_per_iteration=2, lr=3e-3, entropy_coeff=0.01, seed=0),
        60, -0.2)
    ok = _impala_ok(res, -0.2)
    emit("rl_impala_catch_cnn", **res, ok=ok)
    if not ok:
        raise AssertionError("rl_impala_catch_cnn failed its checks")
    return _launch_sum(res["flash_launches"])


def phase_rl_offpolicy() -> dict:
    """DQN (test_dqn_learns_cartpole's config: best >= 120 within 70
    iterations) and SAC (test_sac_learns_line_reach's: mean |err| of the
    policy mean < 0.12 within 40 iterations, return > -0.2, alpha moved)
    with their learners in this process, on the card; no runner with a
    CUDA context."""
    import numpy as np

    from ray_tpu_torch.ops.cuda.flash_attention import reset_launches
    from ray_tpu_torch.rl import DQNConfig, SACConfig

    reset_launches()
    t_phase = t0 = time.perf_counter()
    algo = DQNConfig(
        env="CartPole-v1", num_env_runners=2, num_envs_per_runner=8,
        rollout_fragment_length=32, learning_starts=500,
        train_batch_size=128, updates_per_iteration=48,
        target_update_freq=50, epsilon_decay_steps=4000,
        lr=1e-3, seed=0).build()
    best, it, times = -1.0, 0, []
    try:
        dqn_device = str(algo.learner.device)
        for it in range(1, 71):
            r = algo.train()
            times.append(r["time_s"])
            if r["episode_return_mean"] is not None:
                best = max(best, r["episode_return_mean"])
            if best >= 120.0:
                break
        dqn_runner_cuda = _runner_cuda(algo._runners)
        updates = algo._updates
    finally:
        algo.stop()
    dqn = {"best": best, "iterations": it, "device": dqn_device,
           "updates": updates, "iteration_s": times,
           "wall_s": time.perf_counter() - t0,
           "runner_cuda_initialized": dqn_runner_cuda}
    t0 = time.perf_counter()
    algo = SACConfig(
        env="LineReach-v0", num_env_runners=1, num_envs_per_runner=8,
        rollout_fragment_length=16, hidden=(32, 32),
        actor_lr=3e-3, critic_lr=3e-3, alpha_lr=3e-3,
        initial_alpha=0.2, learning_starts=256,
        train_batch_size=128, updates_per_iteration=32, seed=0).build()
    probes = np.linspace(-1, 1, 9, dtype=np.float32)[:, None]
    err, it, times = None, 0, []
    try:
        sac_device = str(algo.learner.device)
        for it in range(1, 41):
            r = algo.train()
            times.append(r["time_s"])
            if r["num_updates"] == 0:
                continue
            err = float(np.abs(algo.policy_mean(probes)
                               - 0.7 * probes).mean())
            if err < 0.12 and it >= 5:
                break
        sac_runner_cuda = _runner_cuda(algo._runners)
    finally:
        algo.stop()
    sac = {"err": err, "iterations": it, "device": sac_device,
           "alpha": r.get("alpha"), "return_mean": r["episode_return_mean"],
           "iteration_s": times, "wall_s": time.perf_counter() - t0,
           "runner_cuda_initialized": sac_runner_cuda}
    launches = _rl_flash_launches()
    ok = (best >= 120.0 and dqn_device.startswith("cuda")
          and err is not None and err < 0.12
          and r["episode_return_mean"] > -0.2 and r["alpha"] != 0.2
          and sac_device.startswith("cuda")
          and not any(dqn_runner_cuda + sac_runner_cuda)
          and not any(launches.values()))
    emit("rl_offpolicy", dqn=dqn, sac=sac, gates={"dqn_best": 120.0,
         "sac_err": 0.12, "sac_return": -0.2}, flash_launches=launches,
         phase_s=time.perf_counter() - t_phase, card=card_line(), ok=ok)
    if not ok:
        raise AssertionError("rl_offpolicy failed its checks")
    return launches


def phase_rl_multi_agent() -> dict:
    """MultiAgentPPO with two policies, each learner leased half the GPU
    (num_gpus_per_learner=0.5): 3 iterations, finite metrics, both
    learners on cuda, the GPU reading 0 free while both live and 1
    after."""
    import math as _math

    import ray_tpu_torch as rt
    from ray_tpu_torch.ops.cuda.flash_attention import reset_launches
    from ray_tpu_torch.rl import MultiAgentPPOConfig

    reset_launches()
    t0 = time.perf_counter()
    algo = MultiAgentPPOConfig(
        env="MultiAgentCartPole", env_config={"num_agents": 2},
        num_env_runners=2, num_envs_per_runner=8,
        rollout_fragment_length=64,
        policies={"agent_0": {}, "agent_1": {"hidden": (32, 32)}},
        policy_mapping_fn=lambda aid: aid, minibatch_size=512, seed=0,
        num_gpus_per_learner=0.5).build()
    results = []
    try:
        gpu_up = _gpus_free(rt, 0.0)
        placements = {p: rt.get(lr.placement.remote(), timeout=120)
                      for p, lr in algo._learners.items()}
        for _ in range(3):
            results.append(algo.train())
        runner_cuda = _runner_cuda(algo._runners)
        launches = {"driver": _rl_flash_launches(), **{
            p: _actor_flash_launches(rt, lr)
            for p, lr in algo._learners.items()}}
    finally:
        gpu_after = _stop_and_free(rt, algo)
    finite = all(_math.isfinite(v) for r in results
                 for pol in r["policies"].values() for v in pol.values())
    res = {"policies": {p: results[-1]["policies"][p] for p in placements},
           "placements": placements, "finite": finite,
           "iteration_s": [r["time_this_iter_s"] for r in results],
           "gpu_while_learners_up": gpu_up, "gpu_after_stop": gpu_after,
           "runner_cuda_initialized": runner_cuda,
           "flash_launches": launches,
           "phase_s": time.perf_counter() - t0, "card": card_line()}
    ok = (finite and len(placements) == 2
          and all(p["device"].startswith("cuda")
                  for p in placements.values())
          and gpu_up == 0.0 and gpu_after == 1.0 and not any(runner_cuda)
          and not any(_launch_sum(launches).values()))
    emit("rl_multi_agent", **res, ok=ok)
    if not ok:
        raise AssertionError("rl_multi_agent failed its checks")
    return _launch_sum(launches)


# ------------------------------------- the data plane, Tune, offline RL
CORPUS_FILES, CORPUS_DOCS_PER_FILE = 16, 1100
CORPUS_DUP_SHARE = 0.15        # share of raw documents that copy another
CORPUS_SHARDS = 8
# build_corpus's all-to-alls, in order: each must have reported its stats
CORPUS_EXCHANGES = ["dedup", "shuffle", "repartition"]
CORPUS_MIN_TOKENS = 2_000_000
CORPUS_410M_STEPS = 5          # train steps on delivered batches
CORPUS_TIMED_FROM = 1          # step ms and data_wait from step 1 on
BYTE_OFFSET, EOS_ID = 3, 2     # ids 0-2 reserved (pad, bos, eos)
# proposed in this order, two at a time: on the 410m a larger lr reads a
# higher loss at ASHA's rung (step 2: one update on batch 0, the loss on
# batch 1), so the second pair meets better peers there
TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
TUNE_MAX_T, TUNE_GRACE = 6, 2
TUNE_GPU_SHARE = 0.5


def byte_tokenize(text: str) -> list:
    """A deterministic byte tokenizer into the 410m vocabulary: each UTF-8
    byte b is the id b + BYTE_OFFSET (3..258 of 32000)."""
    return [b + BYTE_OFFSET for b in text.encode("utf-8")]


def write_raw_corpus(root: str, seed: int) -> dict:
    """CORPUS_FILES jsonl files of CORPUS_DOCS_PER_FILE documents each,
    made from `seed` with numpy: words of 2-9 letters, 10-50 words a
    document, CORPUS_DUP_SHARE of the documents copies of earlier ones
    (across files too)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, int(n)))
             for n in rng.integers(2, 10, 4096)]
    docs, dups = [], 0
    for i in range(CORPUS_FILES * CORPUS_DOCS_PER_FILE):
        if docs and rng.random() < CORPUS_DUP_SHARE:
            docs.append(docs[int(rng.integers(0, len(docs)))])
            dups += 1
        else:
            picks = rng.integers(0, len(words), int(rng.integers(10, 51)))
            docs.append(f"{i}: " + " ".join(words[j] for j in picks))
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    per = CORPUS_DOCS_PER_FILE
    for f in range(CORPUS_FILES):
        with open(os.path.join(raw, f"part-{f:03d}.jsonl"), "w") as out:
            for text in docs[f * per:(f + 1) * per]:
                out.write(json.dumps({"text": text}) + "\n")
    return {"path": raw, "files": CORPUS_FILES, "docs": len(docs),
            "duplicates": dups, "distinct": len(set(docs)),
            "bytes": sum(len(d.encode()) for d in docs)}


def recording_executor():
    """A StreamingExecutor that keeps every exchange's stats (the
    executor itself keeps the last one's)."""
    import dataclasses

    from ray_tpu_torch.data.executor import StreamingExecutor

    class RecordingExecutor(StreamingExecutor):
        def __init__(self):
            super().__init__()
            self.exchanges = []

        def _exchange(self, spec, refs):
            out = super()._exchange(spec, refs)
            self.exchanges.append({"op": spec.name, **dataclasses.asdict(
                self.last_exchange)})
            return out

    return RecordingExecutor()


def corpus_410m_loop(config: dict):
    """In a TrainWorker leased the GPU: the 410m train step (config_410m,
    b8 s2048, bf16, remat "dots", flash; params from seed 0, AdamW) on
    each batch the session's ingest delivers, CORPUS_410M_STEPS steps,
    targets the rolled tokens. Saves the consumed token stream to config["trace"]
    and reports per step the loss, the ingest's queue wait (data_wait)
    and the step's end; with the flash launch counters, the GPU free
    while the worker lives and its device."""
    warm = "torch" in sys.modules
    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    entered = time.perf_counter()
    deadline = time.monotonic() + 30   # the view follows a lease
    gpu_free = rt.available_resources().get("GPU")
    while gpu_free != 0.0 and time.monotonic() < deadline:
        time.sleep(0.1)
        gpu_free = rt.available_resources().get("GPU")
    ctx = train.get_context()
    device = ctx.get_device()
    cfg = config_410m()
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4),
        llama.init_params(cfg, seed=0, device=device), device=device)
    ingest = ctx.get_ingest(device=device)
    reset_launches()                   # counts: the main path only
    losses, waits, ends, consumed = [], [], [], []
    t_first = time.perf_counter()
    for _ in range(config["steps"]):
        batch = next(ingest)
        waits.append(ingest.stats.last_stall_s * 1e3)
        tokens = batch["tokens"].long()
        state, aux = step(state, {"tokens": tokens,
                                  "targets": torch.roll(tokens, -1, 1)})
        losses.append(aux["loss"].item())
        ends.append(time.perf_counter())
        consumed.append(tokens.cpu().numpy().astype(np.int32))
    ingest.close()
    np.save(config["trace"], np.stack(consumed))
    timed = ends[CORPUS_TIMED_FROM - 1:]
    step_ms = (timed[-1] - timed[0]) / (len(timed) - 1) * 1e3
    train.report({
        "losses": losses, "data_wait_ms": waits, "step_ms": step_ms,
        "first_step_ms": (ends[0] - t_first) * 1e3,
        "tokens_per_s": BATCH_410M * SEQ_410M / step_ms * 1e3,
        "launches": dict(launches), "gpu_free_in_worker": gpu_free,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "warm_worker": warm, "setup_s": t_first - entered,
        "device": str(device)})


def phase_data_corpus_410m(step_ms: float, seed: int) -> dict:
    """build_corpus (content-hash dedup through a hash exchange, the byte
    tokenizer, the random_shuffle exchange, CORPUS_SHARDS packed npz
    shards) over a raw jsonl corpus made from `seed`, then a TorchTrainer
    worker leased the GPU trains the 410m step on what its ingest
    (IngestSpec(seq_len=2048, batch_blocks=8, shard_tasks=True)) delivers.
    Holds: at least CORPUS_MIN_TOKENS tokens built, every distinct
    document kept once; the shard-task token stream equals the inline one
    bit for bit (over the whole corpus, and the worker's consumed batches
    against the inline ingest's first ones); 48/24/24 flash launches a
    step in the worker; its first loss equals an in-process step's on the
    same batch from the same weights to 1e-6 relative; the GPU free at 0
    while the worker lives and at 1 after. Prints the build's wall s, each
    exchange's stats, and the ingest's data_wait ms per step beside the
    step ms and tokens/s (train_410m's in-process step beside them)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.data.llm_corpus import TokenCorpus, build_corpus
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step
    from ray_tpu_torch.train import IngestSpec
    from ray_tpu_torch.train.ingest import CorpusIngestIterator

    t_phase = time.perf_counter()
    storage = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        raw = write_raw_corpus(storage, seed)
        out = os.path.join(storage, "corpus")
        executor = recording_executor()
        t0 = time.perf_counter()
        paths = build_corpus(raw["path"], out, tokenize=byte_tokenize,
                             num_shards=CORPUS_SHARDS, seed=seed,
                             executor=executor)
        build_s = time.perf_counter() - t0
        docs = tokens = 0
        for p in paths:
            with np.load(p) as z:
                docs += len(z["doc_lens"])
                tokens += int(z["tokens"].size)
        kw = dict(seq_len=SEQ_410M, eos_id=EOS_ID)
        t0 = time.perf_counter()
        with_tasks = np.stack([b["tokens"] for b in TokenCorpus(
            out, shard_tasks=True, **kw)])
        stream_tasks_s = time.perf_counter() - t0
        inline = np.stack([b["tokens"] for b in TokenCorpus(out, **kw)])
        spec = IngestSpec(paths=out, seq_len=SEQ_410M,
                          batch_blocks=BATCH_410M, eos_id=EOS_ID,
                          shard_tasks=True)
        trace = os.path.join(storage, "consumed.npy")
        result, wall_s, gpu_after = _trainer_fit(
            rt, corpus_410m_loop,
            {"steps": CORPUS_410M_STEPS, "trace": trace}, "corpus-410m",
            storage, max_failures=0, ingest=spec)
        m = result.metrics
        consumed = np.load(trace)
        plain = CorpusIngestIterator(dataclasses.replace(
            spec, shard_tasks=False))
        want = np.stack([next(plain)["tokens"]
                         for _ in range(CORPUS_410M_STEPS)])
        plain.close()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    # the in-process step on the worker's first batch, from the same
    # weights (the first loss is the forward before any update)
    torch.cuda.empty_cache()
    cfg = config_410m()
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4),
        llama.init_params(cfg, seed=0, device="cuda"), device="cuda")
    first = torch.tensor(consumed[0], device="cuda").long()
    _, aux = step(state, {"tokens": first,
                          "targets": torch.roll(first, -1, 1)})
    in_process_loss = aux["loss"].item()
    del step, state, aux
    torch.cuda.empty_cache()
    rel = abs(m["losses"][0] - in_process_loss) / abs(in_process_loss)
    expected = {"flash_fwd": 2 * cfg.n_layers * CORPUS_410M_STEPS,
                "flash_bwd_dq": cfg.n_layers * CORPUS_410M_STEPS,
                "flash_bwd_dkv": cfg.n_layers * CORPUS_410M_STEPS}
    waits = m["data_wait_ms"][CORPUS_TIMED_FROM:]
    res = {"raw": {k: v for k, v in raw.items() if k != "path"},
           "build_s": build_s, "exchanges": executor.exchanges,
           "shards": len(paths), "docs_built": docs, "tokens_built": tokens,
           "blocks": int(len(inline)), "stream_tasks_s": stream_tasks_s,
           "stream_equal_inline": bool(np.array_equal(with_tasks, inline)),
           "consumed_equal_inline": bool(np.array_equal(consumed, want)),
           "losses": m["losses"], "in_process_first_loss": in_process_loss,
           "first_loss_rel_diff": rel, "tolerance": 1e-6,
           "data_wait_ms": m["data_wait_ms"],
           "data_wait_ms_mean": statistics.mean(waits),
           "step_ms": m["step_ms"], "first_step_ms": m["first_step_ms"],
           "tokens_per_s": m["tokens_per_s"],
           "train_410m_step_ms": step_ms,
           "step_vs_in_process": m["step_ms"] / step_ms,
           "launches": m["launches"], "expected_launches": expected,
           "gpu_free_in_worker": m["gpu_free_in_worker"],
           "gpu_free_after": gpu_after, "device": m["device"],
           "warm_worker": m["warm_worker"], "setup_s": m["setup_s"],
           "peak_mem_gb": m["peak_mem_gb"], "fit_wall_s": wall_s,
           "steps": CORPUS_410M_STEPS, "batch": BATCH_410M, "seq": SEQ_410M,
           "seed": seed, "phase_s": time.perf_counter() - t_phase,
           "card": card_line()}
    ok = (tokens >= CORPUS_MIN_TOKENS and docs == raw["distinct"]
          and [x["op"] for x in executor.exchanges] == CORPUS_EXCHANGES
          and res["stream_equal_inline"] and res["consumed_equal_inline"]
          and m["launches"] == expected and rel <= 1e-6
          and all(math.isfinite(x) for x in m["losses"])
          and m["gpu_free_in_worker"] == 0.0 and gpu_after == 1.0
          and m["device"] == "cuda" and len(paths) == CORPUS_SHARDS)
    emit("data_corpus_410m", **res, ok=ok)
    if not ok:
        raise AssertionError("data_corpus_410m failed its checks")
    return m["launches"]


def tune_lora_loop(config: dict):
    """lora_finetune_loop as a Tune trial, with what only the trial's
    process reads added to each of its reports: the flash launch counts
    since the loop began (set to 0 there), the GPU the cluster shows free,
    the wall clock, whether the worker was warm, and its device. Every
    step reports (ASHA decides on each report)."""
    warm = "torch" in sys.modules
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.train.recipes import lora_finetune_loop

    entered = time.time()
    report = train.report

    def report_with_readings(metrics, checkpoint=None):
        report({**metrics, "launches": dict(launches),
                "gpu_free": rt.available_resources().get("GPU"),
                "t": time.time(), "entered": entered, "warm_worker": warm,
                "device": str(train.get_context().get_device())},
               checkpoint=checkpoint)

    reset_launches()                   # counts: the main path only
    train.report = report_with_readings
    try:
        lora_finetune_loop({**config, "batch_fn": lambda i, rank:
                            trainer_batch(i, rank, config["vocab"])})
    finally:
        train.report = report


def lora_recipe_config(lr: float, steps: int) -> dict:
    cfg = config_410m()
    return {"preset": "410m", "lora_rank": LORA_RANK_410M,
            "model_overrides": {"max_seq_len": SEQ_410M, "remat": True,
                                "remat_policy": "dots",
                                "attn_impl": "flash"},
            "steps": steps, "report_every": 1, "batch_size": BATCH_410M,
            "seq_len": SEQ_410M, "lr": lr, "seed": 0,
            "vocab": cfg.vocab_size}


def lora_recipe_in_process(lr: float, steps: int) -> list:
    """The same recipe (lora_finetune_loop, same config and batches) in
    this process on the card, under a train context of its own: its
    reported losses."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.recipes import lora_finetune_loop

    config = lora_recipe_config(lr, steps)
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_ref_")
    ctx = session.TrainContext(0, 1, storage, "tune-in-process", None,
                               use_gpu=True)
    session.set_context(ctx)
    try:
        lora_finetune_loop({**config, "batch_fn": lambda i, rank:
                            trainer_batch(i, rank, config["vocab"])})
        return [e["metrics"]["loss"] for e in ctx.drain_results()]
    finally:
        session.set_context(None)
        shutil.rmtree(storage, ignore_errors=True)
        torch.cuda.empty_cache()


def _ran_together(a: dict, b: dict) -> bool:
    """Two trials' reports overlap in time, and each report of either made
    while both were reporting reads 0 GPUs free."""
    lo, hi = max(a["first_t"], b["first_t"]), min(a["last_t"], b["last_t"])
    inside = [free for trial in (a, b)
              for t, free in zip(trial["report_t"], trial["gpu_free"])
              if lo <= t <= hi]
    return lo < hi and bool(inside) and all(f == 0.0 for f in inside)


def phase_tune_410m(lora_step_ms: float) -> dict:
    """Tuner(lora_finetune_loop) at the 410m's full width (rank 16 on wq
    wk wv wo, frozen base, b8 s2048, bf16, remat "dots", flash), a grid of
    4 learning rates under ASHAScheduler(max_t=6, grace_period=2) on the
    loss, each trial a TrainWorker leased {"GPU": 0.5}, so two trials
    share the card. Holds: every trial's reports count 48/24/24 flash
    launches a step; two trials ran at once while the GPU read 0 free,
    and it reads 1 after; ASHA stopped at least one trial before max_t;
    the reported losses of the best trial that ran to max_t equal the same
    recipe's in-process steps at its lr to 1e-6 relative. Prints the fit's wall s, each
    trial's step ms beside lora_train_410m's in-process step, and the time
    to the first result."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig, ScalingConfig

    cfg = config_410m()
    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    t0 = time.time()
    try:
        grid = tune.Tuner(
            tune_lora_loop,
            param_space={**lora_recipe_config(0.0, TUNE_MAX_T),
                         "lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                scheduler=tune.ASHAScheduler(
                    metric="loss", mode="min", max_t=TUNE_MAX_T,
                    grace_period=TUNE_GRACE)),
            run_config=RunConfig(name="tune-410m", storage_path=storage),
            scaling_config=ScalingConfig(resources_per_worker={
                "CPU": 1, "GPU": TUNE_GPU_SHARE})).fit()
        wall_s = time.time() - t0
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    gpu_after = _gpus_free(rt, 1.0)
    trials = []
    for t in grid._trials:
        rs = t.results
        steps = [r["step"] for r in rs]
        per_step = [r["launches"] == {
            "flash_fwd": 2 * cfg.n_layers * r["step"],
            "flash_bwd_dq": cfg.n_layers * r["step"],
            "flash_bwd_dkv": cfg.n_layers * r["step"]} for r in rs]
        ts = [r["t"] for r in rs]
        trials.append({
            "lr": t.config["lr"], "status": t.status.value,
            "losses": [r["loss"] for r in rs], "steps": steps,
            "launches": rs[-1]["launches"] if rs else None,
            "launches_per_step_ok": all(per_step) and bool(rs),
            "gpu_free": [r["gpu_free"] for r in rs], "report_t": ts,
            "first_t": ts[0], "last_t": ts[-1],
            "step_ms": ((ts[-1] - ts[0]) / (len(ts) - 1) * 1e3
                        if len(ts) > 1 else None),
            "setup_s": ts[0] - rs[0]["entered"],
            "warm_worker": rs[0]["warm_worker"],
            "device": rs[0]["device"]})
    together = [(a["lr"], b["lr"]) for i, a in enumerate(trials)
                for b in trials[i + 1:] if _ran_together(a, b)]
    stopped = [t["lr"] for t in trials if len(t["steps"]) < TUNE_MAX_T]
    # the best of the trials ASHA let run to max_t, by its last loss
    best = min((t for t in trials if len(t["steps"]) == TUNE_MAX_T),
               key=lambda t: t["losses"][-1])
    ref = lora_recipe_in_process(best["lr"], len(best["losses"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(best["losses"], ref)]
    first_result_s = min(t["first_t"] for t in trials) - t0
    for t in trials:
        t["first_t"] -= t0
        t["last_t"] -= t0
        t["report_t"] = [x - t0 for x in t["report_t"]]
    ok = (len(trials) == len(TUNE_LRS)
          and all(t["launches_per_step_ok"] and t["device"] == "cuda"
                  for t in trials)
          and bool(together) and bool(stopped) and gpu_after == 1.0
          and len(ref) == len(best["losses"]) and max(rel) <= 1e-6)
    emit("tune_410m", trials=trials, ran_together=together,
         stopped_before_max_t=stopped, best_lr=best["lr"],
         best_losses=best["losses"], in_process_losses=ref,
         rel_diff=rel, tolerance=1e-6, fit_wall_s=wall_s,
         first_result_s=first_result_s,
         lora_train_410m_step_ms=lora_step_ms,
         step_vs_in_process=[t["step_ms"] / lora_step_ms for t in trials
                             if t["step_ms"]],
         gpu_free_after=gpu_after, gpu_share=TUNE_GPU_SHARE,
         max_t=TUNE_MAX_T, grace_period=TUNE_GRACE, rank=LORA_RANK_410M,
         batch=BATCH_410M, seq=SEQ_410M, card=card_line(), ok=ok)
    if not ok:
        raise AssertionError("tune_410m failed its checks")
    return _launch_sum({t["lr"]: t["launches"] for t in trials})


def _expert_policy(obs):
    """test_rl_offline's CartPole heuristic (~120 mean return)."""
    import numpy as np

    theta, theta_dot = obs[:, 2], obs[:, 3]
    return (theta + 0.5 * theta_dot > 0).astype(np.int32)


def phase_rl_offline() -> dict:
    """test_rl_offline's fixture and gates with the learners on the card:
    CartPole expert transitions (6000 steps, 8 envs, seed 0) written with
    write_offline_dataset, read back as read_npz NumpyBlocks; BC (2 epochs
    an iteration, lr 3e-3, 4 iterations) and CQL (3 iterations of 400
    updates), each scoring above 60 over 10 greedy episodes, both learners
    on cuda, and no flash launch. Prints each iteration's update ms on the
    card (the card-vs-CPU update times are rl_parity's bc and cql rows)."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.data.block import is_numpy_block
    from ray_tpu_torch.ops.cuda.flash_attention import reset_launches
    from ray_tpu_torch.rl import (BCConfig, CQLConfig, collect_transitions,
                                  read_offline_dataset,
                                  write_offline_dataset)

    reset_launches()
    t0 = time.perf_counter()
    storage = tempfile.mkdtemp(prefix="chip_smoke_offline_")
    try:
        path = os.path.join(storage, "cartpole-expert")
        rows = write_offline_dataset(collect_transitions(
            "CartPole-v1", _expert_policy, num_steps=6000, num_envs=8,
            seed=0), path, shard_rows=1024)
        blocks = [rt.get(r) for r in
                  read_offline_dataset(path)._iter_block_refs()]
        dataset = {"rows": rows, "blocks": len(blocks),
                   "numpy_blocks": all(is_numpy_block(b) for b in blocks),
                   "obs_width": int(blocks[0].cols["obs"].shape[1])}
        runs = {}
        for name, algo, iters in (
                ("bc", BCConfig(dataset_path=path, epochs_per_iteration=2,
                                lr=3e-3, seed=0).build(), 4),
                ("cql", CQLConfig(dataset_path=path,
                                  updates_per_iteration=400,
                                  seed=0).build(), 3)):
            t1 = time.perf_counter()
            results = [algo.train() for _ in range(iters)]
            score = algo.evaluate(num_episodes=10)
            # BC counts an iteration's updates, CQL all of them so far
            updates = [r["num_updates"] if name == "bc"
                       else algo.config.updates_per_iteration
                       for r in results]
            runs[name] = {
                "device": str(algo.learner.device), "score": score,
                "losses": [r["loss"] for r in results],
                "iteration_s": [r["time_s"] for r in results],
                "update_ms": [r["time_s"] / n * 1e3
                              for r, n in zip(results, updates)],
                "updates": sum(updates),
                "wall_s": time.perf_counter() - t1}
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    launches = _rl_flash_launches()
    ok = (rows >= 6000 and dataset["numpy_blocks"]
          and dataset["obs_width"] == 4
          and all(r["score"] > 60 and r["device"].startswith("cuda")
                  for r in runs.values())
          and runs["bc"]["losses"][-1] < runs["bc"]["losses"][0]
          and not any(launches.values()))
    emit("rl_offline", dataset=dataset, **runs, gate=60.0,
         flash_launches=launches, phase_s=time.perf_counter() - t0,
         card=card_line(), ok=ok)
    if not ok:
        raise AssertionError("rl_offline failed its checks")
    return launches


def phase_data_tune_offline(step_ms: float, lora_step_ms: float,
                            seed: int) -> dict:
    """The data plane, Tune and offline RL phases on the running cluster
    (the GPU free). Returns each path's flash launches."""
    return {"data_corpus_410m": phase_data_corpus_410m(step_ms, seed),
            "tune_410m": phase_tune_410m(lora_step_ms),
            "rl_offline": phase_rl_offline()}


# --------------------------------------------------------- the surfaces
SURFACES_STEPS = 3          # the job's train steps; ms from the 2nd on
SURFACES_REST_S = 3.0       # the worker at rest after its last step
SURFACES_MEM_TOLERANCE = 0.05


def surfaces_train_loop(config: dict):
    """The 410m train step (config_410m: b8 s2048, bf16 compute, remat
    "dots", flash) in a TrainWorker, SURFACES_STEPS steps, each recorded
    by the session's step recorder. Reports the losses, the flash launch
    counts of the steps, the mean step ms from the 2nd step on, the GPU
    free while the worker lives, and the worker's own
    torch.cuda.memory_stats reading after the last step. The worker then
    rests SURFACES_REST_S s inside a recorder phase named "rest", which
    no step stage accumulates: an open phase keeps the recorder's flush
    cycle (and its once-a-second memory snapshot) running, so the run's
    last snapshot samples the card at rest, and no stage of the run shows
    the rest as time it spent."""
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.cuda.flash_attention import launches, reset_launches
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    ctx = train.get_context()
    rec = ctx.recorder
    if rec is None:
        raise RuntimeError("the session has no step recorder")
    device = ctx.get_device()
    cfg = config_410m()
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw(3e-4),
        llama.init_params(cfg, seed=0, device=device), device=device)
    batch = batch_410m(cfg.vocab_size)
    deadline = time.monotonic() + 30   # the view follows a lease
    gpu_free = rt.available_resources().get("GPU")
    while gpu_free != 0.0 and time.monotonic() < deadline:
        time.sleep(0.1)
        gpu_free = rt.available_resources().get("GPU")
    reset_launches()                   # counts: the job's steps only
    losses, stamps = [], []
    for i in range(SURFACES_STEPS):
        stamps.append(time.perf_counter())
        with rec.phase("step"):
            state, aux = step(state, batch)
            losses.append(aux["loss"].item())   # waits for the card
        rec.end_step(i + 1, loss=losses[-1])
    torch.cuda.synchronize()
    end = time.perf_counter()
    counts = dict(launches)
    mem = torch.cuda.memory_stats(0)
    mine = int(mem["allocated_bytes.all.current"])
    mine_at = time.time()
    with rec.phase("rest"):
        time.sleep(SURFACES_REST_S)
    train.report({
        "loss": losses[-1], "losses": losses, "launches": counts,
        "step_ms": (end - stamps[1]) / (SURFACES_STEPS - 1) * 1e3,
        "first_step_ms": (stamps[1] - stamps[0]) * 1e3,
        "gpu_free_in_worker": gpu_free, "mem_bytes": mine,
        "mem_at": mine_at, "device": str(device),
        "n_layers": cfg.n_layers})
    return losses[-1]


_SURFACES_JOB = """
import json, os, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
import ray_tpu_torch as rt
from ray_tpu_torch import train

rt.init(address=os.environ["RAYT_ADDRESS"])
result = train.TorchTrainer(
    chip_smoke.surfaces_train_loop, train_loop_config={{}},
    scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
    run_config=train.RunConfig(name="surfaces-410m",
                               storage_path={storage!r})).fit()
if result.error is not None:
    rt.shutdown()
    raise SystemExit(f"the fit failed: {{result.error}}")
print("SURFACES_RESULT " + json.dumps(result.metrics), flush=True)
# the GCS drops a job's train runs when its driver exits: hold the job
# until the phase has read the run through the CLI and the dashboard
deadline = time.monotonic() + 600
while not os.path.exists({done!r}) and time.monotonic() < deadline:
    time.sleep(0.2)
rt.shutdown()
"""

_SURFACES_CLIENT = """
import json, sys, time
from ray_tpu_torch import client

ctx = client.connect({addr!r})


@ctx.remote(num_gpus=1)
def card_name():
    import torch

    return torch.cuda.get_device_name(0)


times, names = [], []
for _ in range(3):
    t0 = time.perf_counter()
    names.append(ctx.get(card_name.remote(), timeout=300))
    times.append((time.perf_counter() - t0) * 1e3)
ctx.disconnect()
print("CLIENT_RESULT " + json.dumps({{
    "names": names, "round_trip_ms": times,
    "torch_in_client": "torch" in sys.modules}}), flush=True)
"""


def _cli(*args, timeout: float = 120) -> tuple[str, float]:
    """`python -m ray_tpu_torch <args>` from the checkout: its stdout and
    wall ms; raises on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if proc.returncode != 0:
        raise AssertionError(f"ray_tpu_torch {' '.join(args)} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout, wall_ms


def _gpu_line(status: str) -> str:
    return next((ln.strip() for ln in status.splitlines()
                 if ln.strip().startswith("GPU:")), "")


def phase_surfaces_410m(step_ms: float) -> dict:
    """The runtime's surfaces on a head started through the CLI: start,
    status, job submit of a 3-step 410m TorchTrainer fit, list actors,
    train status, the dashboard's /api/train and /metrics, a thin client's
    GPU task, stop (see the module docstring, 15). Returns the job's
    worker's flash launch counts."""
    import tempfile
    import urllib.request

    import torch

    from ray_tpu_torch.scripts.launcher import session_pids

    card = card_line()
    names = subprocess.run(
        ["nvidia-smi", "--query-gpu=name", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split("\n")
    names = [n.strip() for n in names if n.strip()]
    torch.cuda.empty_cache()
    res: dict = {"card": card, "nvidia_smi_cards": names,
                 "in_process_step_ms": step_ms}
    job_id = f"surfaces-410m-{uuid.uuid4().hex[:8]}"
    proxy = None
    head_pid = None
    head_up = False
    try:
        out, res["head_start_ms"] = _cli("start", "--head",
                                         "--dashboard-port", "0")
        head_up = True
        head_pid = int(re.search(r"head started \(pid (\d+)\)",
                                 out).group(1))
        address = re.search(r"address: (\S+)", out).group(1)
        dash_port = int(re.search(r"dashboard: http://127\.0\.0\.1:(\d+)",
                                  out).group(1))
        status, res["status_wall_ms"] = _cli("status")
        res["status_gpu_line"] = _gpu_line(status)
        nodes = json.loads(_cli("list", "nodes")[0])
        [head] = [n for n in nodes if n.get("labels", {}).get("head")]
        res["head_resources_gpu"] = head["resources"].get("GPU")
        res["head_labels"] = head["labels"]

        work = tempfile.mkdtemp(prefix="rayt_torch_surfaces_")
        driver = os.path.join(work, "surfaces_job.py")
        done = os.path.join(work, "read")
        with open(driver, "w") as f:
            f.write(_SURFACES_JOB.format(root=ROOT, storage=work, done=done))
        t_submit = time.perf_counter()
        _cli("job", "submit", "--submission-id", job_id, "--",
             sys.executable, driver)
        job_status, worker_row, job, logs = "", None, None, ""
        deadline = time.monotonic() + 900
        while job is None and time.monotonic() < deadline:
            job_status = json.loads(_cli("job", "status",
                                         job_id)[0])["status"]
            if worker_row is None:
                worker_row = next(
                    (a for a in json.loads(_cli("list", "actors")[0])
                     if a["class_name"] == "TrainWorker"
                     and a["state"] == "ALIVE"), None)
            logs = _cli("job", "logs", job_id)[0]
            line = next((ln for ln in logs.splitlines()
                         if ln.startswith("SURFACES_RESULT ")), None)
            if line is not None:
                job = json.loads(line.split(" ", 1)[1])
            elif job_status in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            else:
                time.sleep(0.5)
        res["job_submit_to_result_s"] = time.perf_counter() - t_submit
        if job is None:
            raise AssertionError(f"the job ended {job_status} with no "
                                 f"result: {logs[-4000:]}")
        res["worker_row"] = worker_row
        res["job"] = {k: job[k] for k in (
            "losses", "launches", "step_ms", "first_step_ms",
            "gpu_free_in_worker", "mem_bytes", "device")}
        res["step_ms_vs_in_process"] = job["step_ms"] / step_ms
        n = job["n_layers"] * SURFACES_STEPS
        want = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        res["expected_launches"] = want

        # the run as `train status` and the dashboard show it
        train_status = _cli("train", "status")[0]
        m = re.search(r"run (\w+) experiment='surfaces-410m'.*?"
                      r"mem_used=([\d.]+)MB", train_status, re.S)
        res["train_status_mem_mb"] = float(m.group(2)) if m else None
        api = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{dash_port}/api/train", timeout=30).read())
        [run] = [r for r in api["runs"]
                 if r["experiment"] == "surfaces-410m"]
        devices = run["workers"]["0"]["memory"]["devices"]
        res["api_train_devices"] = devices
        res["api_train_memory_ts_after_reading"] = (
            run["workers"]["0"]["memory"]["ts"] >= job["mem_at"])
        cuda0 = next((d for d in devices if d["device"] == "cuda:0"), {})
        res["api_mem_rel_diff"] = (
            abs(cuda0.get("bytes_in_use", 0) - job["mem_bytes"])
            / job["mem_bytes"])
        res["train_status_mem_rel_diff"] = (
            abs(res["train_status_mem_mb"] * 1e6 - job["mem_bytes"])
            / job["mem_bytes"] if m else None)
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{dash_port}/metrics", timeout=30).read()
        res["metrics_cuda0_line"] = next(
            (ln for ln in metrics.decode().splitlines()
             if ln.startswith("rayt_device_memory_used_bytes")
             and 'device="cuda:0"' in ln), None)
        open(done, "w").close()            # the job may end now
        deadline = time.monotonic() + 120
        while job_status not in ("SUCCEEDED", "FAILED", "STOPPED") \
                and time.monotonic() < deadline:
            time.sleep(0.5)
            job_status = json.loads(_cli("job", "status",
                                         job_id)[0])["status"]
        res["job_status"] = job_status
        res["job_submit_to_end_s"] = time.perf_counter() - t_submit
        deadline = time.monotonic() + 60   # the view follows a lease
        while True:
            res["status_gpu_line_after"] = _gpu_line(_cli("status")[0])
            if (res["status_gpu_line_after"] == f"GPU: {len(names)}/"
                    f"{len(names)} available"
                    or time.monotonic() > deadline):
                break
            time.sleep(0.5)

        # a thin client: a GPU task through the client proxy
        proxy = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "client-server",
             "--address", address, "--port", "0"],
            cwd=ROOT, stdout=subprocess.PIPE, text=True)
        port = json.loads(proxy.stdout.readline())["client_port"]
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c",
             _SURFACES_CLIENT.format(addr=f"127.0.0.1:{port}")],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": ROOT})
        res["client_wall_s"] = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"the client failed: {out.stderr[-3000:]}")
        res["client"] = json.loads(next(
            ln for ln in out.stdout.splitlines()
            if ln.startswith("CLIENT_RESULT ")).split(" ", 1)[1])
    finally:
        if proxy is not None:
            proxy.terminate()
            proxy.wait(timeout=30)
        if head_up:
            _cli("stop")
    deadline = time.monotonic() + 60
    while (head_pid is not None and session_pids(head_pid)
           and time.monotonic() < deadline):
        time.sleep(0.5)
    res["cluster_pids_after_stop"] = (
        None if head_pid is None else sorted(session_pids(head_pid)))
    job, client = res["job"], res["client"]
    ok = (res["head_resources_gpu"] == float(len(names)) and bool(names)
          and res["head_labels"].get("gpu-type") == names[0]
          and res["status_gpu_line"] == f"GPU: {len(names)}/{len(names)} "
          "available"
          and res["job_status"] == "SUCCEEDED"
          and job["launches"] == res["expected_launches"]
          and job["device"] == "cuda" and job["gpu_free_in_worker"] == 0.0
          and all(math.isfinite(x) for x in job["losses"])
          and res["worker_row"] is not None
          and res["worker_row"]["required_resources"].get("GPU") == 1.0
          and res["api_train_memory_ts_after_reading"]
          and res["api_mem_rel_diff"] <= SURFACES_MEM_TOLERANCE
          and res["train_status_mem_rel_diff"] is not None
          and res["train_status_mem_rel_diff"] <= SURFACES_MEM_TOLERANCE
          and res["metrics_cuda0_line"] is not None
          and res["status_gpu_line_after"] == f"GPU: {len(names)}/"
          f"{len(names)} available"
          and client["names"] == [names[0]] * len(client["names"])
          and not client["torch_in_client"]
          and res["cluster_pids_after_stop"] == [])
    emit("surfaces_410m", **res, steps=SURFACES_STEPS,
         mem_tolerance=SURFACES_MEM_TOLERANCE, ok=ok)
    if not ok:
        raise AssertionError("surfaces_410m failed its checks")
    return job["launches"]


LAUNCHER_STEPS = 3          # the GPU task's timed steps, after 2 warm-up
LAUNCHER_IDLE_S = 10.0      # the autoscaler's idle timeout
LAUNCHER_LOSS_RTOL = 1e-6   # as data_corpus_410m's first loss
LAUNCHER_WORKFLOW = "launcher-410m"


def _mark(marks: str, step: str) -> None:
    with open(os.path.join(marks, step), "a") as f:
        f.write("x")


def launcher_batch_step(seed: int, marks: str) -> dict:
    """Workflow step `batch` (a CPU task): batch_410m's tokens, drawn on
    the CPU, as numpy."""
    _mark(marks, "batch")
    batch = batch_410m(config_410m().vocab_size, device="cpu")
    return {"seed": seed,
            **{k: v.numpy() for k, v in batch.items()}}


def launcher_gpu_run(batch: dict, steps: int, marks: str) -> dict:
    """The GPU task: the 410m params from the train phases' seed, and
    run_410m_steps over `batch` on the card (2 warm-up steps, `steps`
    timed ones with the launch counters). Appends its launch counts to
    `marks`/gpu_runs.jsonl, one line a run."""
    import torch

    from ray_tpu_torch.models import llama

    if not torch.cuda.is_available():
        raise RuntimeError("the GPU task found no CUDA device")
    cfg = config_410m()
    run = run_410m_steps(cfg, llama.init_params(cfg, seed=0, device="cuda"),
                         steps, batch={k: torch.from_numpy(batch[k]).cuda()
                                       for k in ("tokens", "targets")})
    out = {k: run[k] for k in ("losses", "first_step_ms", "step_ms",
                               "tokens_per_s", "launches",
                               "expected_launches")}
    out["node_id"] = os.environ["RAYT_NODE_ID"]
    out["device"] = torch.cuda.get_device_name(0)
    out["finished_at"] = time.time()
    with open(os.path.join(marks, "gpu_runs.jsonl"), "a") as f:
        f.write(json.dumps(out["launches"]) + "\n")
    return out


def launcher_train_step(batch: dict, steps: int, marks: str) -> dict:
    """Workflow step `train` (a CPU task): submits the GPU task, which
    stays pending until the autoscaler has launched a GPU node, and
    waits for it."""
    import ray_tpu_torch as rt

    _mark(marks, "train")
    submitted_at = time.time()
    out = rt.get(rt.remote(num_gpus=1)(launcher_gpu_run).remote(
        batch, steps, marks))
    return {**out, "submitted_at": submitted_at}


def launcher_report_step(trained: dict, go) -> dict:
    """Workflow step `report` (a CPU task), run once the harness's `go`
    event has arrived."""
    return {"losses": trained["losses"], "launches": trained["launches"],
            "node_id": trained["node_id"], "go": go}


def launcher_workflow(marks: str, seed: int = 0):
    """batch -> train -> report, with report also waiting for the `go`
    event (so a driver killed once train is checkpointed has not run it)."""
    from ray_tpu_torch import workflow

    batch = workflow.step(launcher_batch_step).bind(seed, marks)
    trained = workflow.step(launcher_train_step).bind(batch, LAUNCHER_STEPS,
                                                      marks)
    return workflow.step(launcher_report_step).bind(
        trained, workflow.wait_for_event("go"))


_LAUNCHER_DRIVER = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
import ray_tpu_torch as rt
from ray_tpu_torch import workflow

rt.init(address=os.environ["RAYT_ADDRESS"])
final = chip_smoke.launcher_workflow({marks!r})
if sys.argv[1] == "run":
    out = workflow.run(final, workflow_id={wid!r}, storage={store!r})
else:
    out = workflow.resume({wid!r}, final, storage={store!r})
print("LAUNCHER_RESULT " + json.dumps(out), flush=True)
rt.shutdown()
"""


def _exec_driver(name: str, driver: str, mode: str) -> subprocess.Popen:
    """`python -m ray_tpu_torch exec <name> -- python <driver> <mode>` in
    a session of its own, so one signal ends it and the driver."""
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "exec", name, "--",
         sys.executable, driver, mode],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _api(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _alive_gpus(status: dict) -> float:
    return sum(n["resources_total"].get("GPU", 0.0)
               for n in status["nodes"] if n["alive"])


def phase_launcher_410m(first_loss: float, step_ms: float) -> dict:
    """The cluster-operations layer on the card (see the module
    docstring, 16): `up` from a JSON config whose head has no GPU, a
    three-step workflow `exec`'d against it whose GPU task makes the
    autoscaler launch an h100-1 node and runs the 410m step there, the
    driver killed once `train` is checkpointed and the workflow resumed
    by a second one, the idle node retired, `down`. Returns the GPU
    task's flash launch counts."""
    import signal
    import tempfile

    import torch

    from ray_tpu_torch import workflow
    from ray_tpu_torch.scripts.launcher import session_pids

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()       # the card's memory for the GPU task
    work = tempfile.mkdtemp(prefix="rayt_torch_launcher_")
    marks, store = os.path.join(work, "marks"), os.path.join(work, "store")
    os.makedirs(marks)
    name = f"launcher-410m-{uuid.uuid4().hex[:8]}"
    cfg_path = os.path.join(work, "cluster.json")
    with open(cfg_path, "w") as f:
        json.dump({"cluster_name": name, "provider": {"type": "local"},
                   "head": {"resources": {"CPU": 4}, "dashboard_port": 0},
                   "node_types": [{"name": "h100-1", "resources_per_host":
                                   {"CPU": 2, "GPU": 1}, "hosts": 1,
                                   "max_slices": 1, "min_slices": 0}],
                   "autoscaler": {"idle_timeout_s": LAUNCHER_IDLE_S,
                                  "reconcile_interval_s": 0.5}}, f)
    driver = os.path.join(work, "driver.py")
    with open(driver, "w") as f:
        f.write(_LAUNCHER_DRIVER.format(root=ROOT, marks=marks, store=store,
                                        wid=LAUNCHER_WORKFLOW))
    res: dict = {"card": card_line(), "cluster": name,
                 "in_process_first_loss": first_loss,
                 "in_process_step_ms": step_ms}
    head_pid = None
    up = False
    try:
        out, up_ms = _cli("up", cfg_path)
        up = True
        res["up_s"] = up_ms / 1e3
        info = json.loads(out.strip().splitlines()[-1])
        dash = info["dashboard_port"]
        from ray_tpu_torch.scripts.launcher import load_state

        head_pid = load_state(name)["head_pid"]
        before = _api(dash, "/api/cluster_status")
        res["gpus_before"] = _alive_gpus(before)

        # the first driver, killed once train is checkpointed
        first = _exec_driver(name, driver, "run")
        steps_dir = os.path.join(store, LAUNCHER_WORKFLOW, "steps")
        deadline = time.monotonic() + 600
        while not any(n.startswith("launcher_train_step-")
                      and n.endswith(".pkl")
                      for n in (os.listdir(steps_dir)
                                if os.path.isdir(steps_dir) else ())):
            if first.poll() is not None or time.monotonic() > deadline:
                first.kill()
                raise AssertionError(
                    "the first driver ended before train was checkpointed: "
                    + first.communicate()[1][-4000:])
            time.sleep(0.05)
        os.killpg(first.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        first.wait(timeout=30)
        [ckpt] = [n for n in os.listdir(steps_dir)
                  if n.startswith("launcher_train_step-")
                  and n.endswith(".pkl")]
        import pickle

        with open(os.path.join(steps_dir, ckpt), "rb") as f:
            trained = pickle.load(f)
        res["meta_after_kill"] = workflow.list_workflows(storage=store)[0][
            "status"]
        res["report_ran_before_kill"] = any(
            n.startswith("launcher_report_step-")
            for n in os.listdir(steps_dir))

        # the resume
        workflow.send_event(LAUNCHER_WORKFLOW, "go", True, storage=store)
        second = _exec_driver(name, driver, "resume")
        sout, serr = second.communicate(timeout=600)
        res["death_to_resumed_output_s"] = time.perf_counter() - t_kill
        if second.returncode != 0:
            raise AssertionError(f"the resumed driver failed: {serr[-4000:]}")
        resumed = json.loads(next(
            ln for ln in sout.splitlines()
            if ln.startswith("LAUNCHER_RESULT ")).split(" ", 1)[1])
        output = workflow.get_output(LAUNCHER_WORKFLOW, storage=store)
        with open(os.path.join(marks, "gpu_runs.jsonl")) as f:
            gpu_runs = [json.loads(ln) for ln in f]
        res["gpu_task_runs"] = len(gpu_runs)
        res["launches_resume"] = {k: sum(run[k] for run in gpu_runs[1:])
                                  for k in gpu_runs[0]}
        for step in ("batch", "train"):
            with open(os.path.join(marks, step)) as f:
                res[f"{step}_step_runs"] = len(f.read())

        # the node the GPU task ran on, and the scale-up
        status = _api(dash, "/api/cluster_status")
        [node] = [n for n in status["nodes"]
                  if n["node_id"] == trained["node_id"]]
        res["gpu_node_labels"] = node["labels"]
        events = _api(dash, "/api/events?kind=node_registered&limit=0")
        [reg] = [e for e in events["events"]
                 if e["node_id"] == trained["node_id"]]
        res["scale_up_s"] = reg["ts"] - trained["submitted_at"]
        res["autoscaler_at_resume"] = {
            k: status["autoscaler"][k]
            for k in ("num_scale_ups", "num_scale_downs")}
        res["gpu_task"] = {k: trained[k] for k in (
            "losses", "first_step_ms", "step_ms", "tokens_per_s",
            "launches", "expected_launches", "device")}
        res["step_ms_vs_in_process"] = trained["step_ms"] / step_ms
        res["first_loss_rel_diff"] = (abs(trained["losses"][0] - first_loss)
                                      / abs(first_loss))
        res["resumed_losses_bit_equal"] = (
            output["losses"] == trained["losses"]
            and resumed["losses"] == trained["losses"])

        # the idle node retired: a short poll of the cluster status
        deadline = time.monotonic() + LAUNCHER_IDLE_S + 60
        while True:
            status = _api(dash, "/api/cluster_status")
            down_seen = status["autoscaler"]["num_scale_downs"] >= 1
            if (down_seen and _alive_gpus(status) == 0.0) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        events = _api(dash, "/api/events?source=autoscaler&limit=0")
        downs = [e for e in events["events"]
                 if e["kind"] == "autoscaler_scale_down"]
        res["scale_down_s"] = (downs[0]["ts"] - trained["finished_at"]
                               if downs else None)
        res["autoscaler_after_idle"] = {
            k: status["autoscaler"][k]
            for k in ("num_scale_ups", "num_scale_downs")}
        res["gpus_after_idle"] = _alive_gpus(status)
    finally:
        if up:
            _, down_ms = _cli("down", name)
            res["down_s"] = down_ms / 1e3
    res["cluster_pids_after_down"] = (
        None if head_pid is None else session_pids(head_pid))
    res["phase_s"] = time.perf_counter() - t_phase
    gpu = res["gpu_task"]
    ok = (res["gpus_before"] == 0.0
          and res["meta_after_kill"] == "RUNNING"
          and not res["report_ran_before_kill"]
          and res["gpu_node_labels"].get("autoscaled") == "1"
          and res["gpu_node_labels"].get("gpu-type")
          == torch.cuda.get_device_name(0)
          and gpu["device"] == torch.cuda.get_device_name(0)
          and gpu["launches"] == gpu["expected_launches"]
          and all(math.isfinite(x) for x in gpu["losses"])
          and res["first_loss_rel_diff"] <= LAUNCHER_LOSS_RTOL
          and res["gpu_task_runs"] == 1 and res["batch_step_runs"] == 1
          and res["train_step_runs"] == 1
          and set(res["launches_resume"].values()) == {0}
          and res["resumed_losses_bit_equal"]
          and res["autoscaler_at_resume"]["num_scale_ups"] == 1
          and res["autoscaler_after_idle"] == {"num_scale_ups": 1,
                                               "num_scale_downs": 1}
          and res["gpus_after_idle"] == 0.0
          and res["cluster_pids_after_down"] == [])
    emit("launcher_410m", **res, steps=LAUNCHER_STEPS,
         idle_timeout_s=LAUNCHER_IDLE_S, loss_rtol=LAUNCHER_LOSS_RTOL, ok=ok)
    if not ok:
        raise AssertionError("launcher_410m failed its checks")
    return gpu["launches"]


def phase_rl() -> dict:
    """The RL phases on the running cluster (the GPU free): parity, then
    each algorithm's learning run. Returns each path's flash launches."""
    phase_rl_parity()
    return {"rl_ppo_cartpole": phase_rl_ppo_cartpole(),
            "rl_impala_cartpole": phase_rl_impala_cartpole(),
            "rl_impala_catch_cnn": phase_rl_impala_catch_cnn(),
            "rl_offpolicy": phase_rl_offpolicy(),
            "rl_multi_agent": phase_rl_multi_agent()}


def phase_runtime(reference_losses: list, lora_step_ms: float,
                  step_ms: float, seed: int) -> dict:
    """The runtime phases, serve_app_410m, the train runtime's phases and
    the compiled-graph phases on one cluster, shut down on the way out
    (its head and every worker stop with it). Returns the launch counts of
    the Serve apps' paths, of the train task, of the clean TorchTrainer
    LoRA fit, of the DAG-driven train ticks, of the disaggregated pools,
    of the RL paths and of the data plane, Tune and offline RL paths."""
    import gc

    import torch

    import ray_tpu_torch as rt

    gc.collect()
    torch.cuda.empty_cache()       # the card's memory for the workers
    try:
        phase_runtime_cluster()
        actor, serve_run = phase_runtime_serve_410m()
        objects = phase_runtime_device_objects(actor)
        # the actor holds the node's one GPU until it dies: the Serve
        # phase's replica, then the train task, are leased that GPU next
        rt.kill(actor)
        paths, llm_app_http = phase_serve_app_410m(serve_run)
        paths["runtime_train_410m"] = phase_runtime_train_410m(
            reference_losses)["launches"]
        # the train task has returned the GPU: the TrainWorkers lease it
        paths["trainer_lora_410m"] = phase_trainer(lora_step_ms)
        # then the compiled-graph plane: each phase returns the GPU
        phase_dag_device(objects["fetch_mb_per_s"])
        paths["dag_train_410m"] = phase_dag_train_410m(reference_losses,
                                                       step_ms)
        paths["disagg_app_410m"] = phase_disagg_app_410m(serve_run,
                                                         llm_app_http)
        # then RL: learners on the card, env runners on the CPU
        paths.update(phase_rl())
        # then the data plane, Tune and offline RL, once the GPU is free
        paths.update(phase_data_tune_offline(step_ms, lora_step_ms, seed))
    finally:
        rt.shutdown()
    return paths


def _on_cluster(run):
    import ray_tpu_torch as rt

    rt.init()
    try:
        return run()
    finally:
        rt.shutdown()


# one part of the script alone: which of the 410m step's and the LoRA
# step's readings it needs first ("full", "lora"), and what it runs with
# them (the readings by name, the seed)
PHASE_GROUPS = {
    "--runtime": (("full", "lora"), lambda r, seed: phase_runtime(
        r["full"]["losses"], r["lora"]["step_ms"], r["full"]["step_ms"],
        seed)),
    "--data": (("full", "lora"), lambda r, seed: _on_cluster(lambda: (
        phase_rl_parity(), phase_data_tune_offline(
            r["full"]["step_ms"], r["lora"]["step_ms"], seed)))),
    "--rl": ((), lambda r, seed: _on_cluster(phase_rl)),
    "--surfaces": (("full",), lambda r, seed: phase_surfaces_410m(
        r["full"]["step_ms"])),
    "--launcher": (("full",), lambda r, seed: phase_launcher_410m(
        r["full"]["losses"][0], r["full"]["step_ms"])),
    "--mesh": (("full",), lambda r, seed: (
        phase_mesh_train_410m(r["full"], STEPS_410M), phase_ring_410m())),
}


def run_group(flag: str, seed: int):
    needs, run = PHASE_GROUPS[flag]
    info = phase_device()
    phase_build()
    readings = {}
    if "full" in needs:
        readings["full"] = phase_train_410m(info["name"], STEPS_410M)
    if "lora" in needs:
        readings["lora"] = phase_lora_train_410m(info["name"], STEPS_410M,
                                                 readings["full"])
    run(readings, seed)


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

    seed = 0            # the data plane's raw corpus
    if argv[:1] == ["--seed"] and len(argv) >= 2:
        seed, argv = int(argv[1]), argv[2:]

    if argv == ["--gloo-cuda"]:
        phase_device()
        phase_gloo_cuda()
        return 0
    if argv[:1] == ["--compare"] and len(argv) == 2:
        phase_device()
        compare(argv[1])
        return 0
    if len(argv) == 1 and argv[0] in PHASE_GROUPS:
        run_group(argv[0], seed)
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
    lora_run = phase_lora_train_410m(info["name"], STEPS_410M, full)
    paths = {"train_410m": full["launches"],
             "mesh_train_410m": phase_mesh_train_410m(
                 full, STEPS_410M)["launches"],
             "ring_410m": phase_ring_410m()["launches"],
             "lora_train_410m": lora_run["launches"],
             "moe_train_410m": phase_moe_train_410m(STEPS_410M)["launches"]}
    phase_lora_serve_410m()
    paths.update(phase_runtime(full["losses"], lora_run["step_ms"],
                               full["step_ms"], seed))
    paths["surfaces_job_410m"] = phase_surfaces_410m(full["step_ms"])
    paths["launcher_410m"] = phase_launcher_410m(full["losses"][0],
                                                 full["step_ms"])
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
