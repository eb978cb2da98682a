"""Reusable train-loop recipes for TorchTrainer.

The reference ships fine-tuning as free-standing torch/DeepSpeed example
scripts (ref: doc/source/train/examples/deepspeed/,
release/air_examples/dolly_v2_lightning_fsdp_finetuning/); here the
canonical loops are library code so tests, benches, and users share one
implementation. The port of ray_tpu/train/recipes.py, with the reference's
config keys: each loop trains on ``get_context().get_device()`` and
imports torch inside its body (workers boot without it).
"""

from __future__ import annotations

from typing import Any, Callable


def _sync(device) -> None:
    """Wait for the card, so a timed ``step`` phase holds its compute
    (the reference's block_until_ready)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``
    (the reference's shard_batch on one device); integer leaves as int64,
    torch's index dtype."""
    import torch

    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not (t.is_floating_point() or t.is_complex()):
            t = t.long()
        out[k] = t.to(device)
    return out


def corpus_pretrain_loop(config: dict):
    """Pre-train from a sharded tokenized corpus via session ingest
    (train/ingest.py). The model is a deliberately tiny embedding net —
    this recipe is the canonical wiring of the INGEST contract: the
    corpus cursor is saved inside every checkpoint and restored on
    (re)start, so a run killed mid-epoch resumes consuming exactly the
    tokens an uninterrupted run would have.

    config keys:
      vocab_size, dim      — toy model size (default 128 / 8)
      lr, steps            — SGD rate / max train steps (corpus may end
                             earlier; the loop stops at either)
      checkpoint_every     — steps between checkpointed reports (def. 5)
      use_mesh             — build the ScalingConfig mesh first
                             (get_mesh; the ingest already hands each
                             rank its own slice of the corpus)
      trace_dir            — debug/test hook: persist the consumed token
                             ids per step (trace_dir/rank{r}/step_*.npy);
                             re-executed steps overwrite, so the dir
                             always holds the EFFECTIVE consumed stream
      crash_at_step        — fault-injection hook: hard-exit the worker
                             before that step, once per marker file
    """
    import os
    import shutil

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.train.checkpoint import Checkpoint

    ctx = train.get_context()
    rank = ctx.get_world_rank()
    if config.get("use_mesh"):
        ctx.get_mesh()
    device = ctx.get_device()

    vocab = config.get("vocab_size", 128)
    dim = config.get("dim", 8)
    lr = config.get("lr", 1e-2)
    steps = config.get("steps", 20)
    ckpt_every = config.get("checkpoint_every", 5)

    start_step = 0
    ingest_state = None
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn((vocab, dim), generator=gen) * 0.02).to(device)
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        restored = Checkpoint(
            os.path.join(ckpt.path, f"rank_{rank}")).to_dict()
        w = torch.as_tensor(restored["w"]).to(device)
        start_step = int(restored["step"])
        ingest_state = restored["ingest"]

    # batches arrive on the device (ingest stamps data_wait and h2d)
    it = ctx.get_ingest(device=device, state=ingest_state)

    def sgd_step(w, tokens):
        w = w.detach().requires_grad_(True)
        # the cast is the step's first op: the first op after a dequeue
        # may wait for the GIL while the prefetch thread builds the next
        # batch, and that wait belongs to a stage, not to the residual
        emb = w[tokens.long()]  # (B, T, dim) gather
        loss = torch.mean(torch.square(emb - torch.mean(emb)))
        (grad,) = torch.autograd.grad(loss, w)
        return (w - lr * grad).detach(), loss.detach()

    # per-step waterfall (train/telemetry): ingest stamps data_wait/h2d,
    # the compute phase synchronizes so step_s is honest, report stamps
    # ckpt_block — the four stages tile step wall by construction.
    # wrap_jit adds first-call accounting on the train step.
    rec = ctx.recorder
    if rec is not None:
        sgd_step = rec.wrap_jit(sgd_step, "sgd_step")

    trace_dir = config.get("trace_dir")
    if trace_dir:
        os.makedirs(os.path.join(trace_dir, f"rank{rank}"), exist_ok=True)
    crash_at = config.get("crash_at_step")

    loss = None
    try:
        for step in range(start_step, steps):
            if crash_at is not None and step == crash_at:
                marker = os.path.join(ctx.experiment_path,
                                      f".crashed-rank_{rank}")
                if not os.path.exists(marker):
                    open(marker, "w").close()
                    os._exit(1)  # simulate a hard worker kill mid-epoch
            try:
                batch = next(it)  # ingest stamps data_wait and h2d
            except StopIteration:
                break  # corpus exhausted before `steps`
            tokens = batch["tokens"]
            n_tokens = tokens.numel()
            if trace_dir:
                np.save(os.path.join(trace_dir, f"rank{rank}",
                                     f"step_{step:05d}.npy"),
                        batch["tokens"].cpu().numpy())
            if rec is not None:
                with rec.phase("step"):
                    w, loss = sgd_step(w, tokens)
                    _sync(device)
            else:
                w, loss = sgd_step(w, tokens)
            if (step + 1) % ckpt_every == 0 or step == steps - 1:
                c = Checkpoint.from_dict({
                    "w": w.cpu().numpy(), "step": step + 1,
                    "ingest": it.state_dict()})
                train.report(
                    {"loss": float(loss), "step": step + 1,
                     "tokens": n_tokens,
                     "ingest_stall_s": it.stats.stall_s,
                     "ingest_load_s": it.stats.load_s},
                    checkpoint=c)
                shutil.rmtree(c.path, ignore_errors=True)  # report copied
            if rec is not None:
                rec.end_step(step + 1, tokens=n_tokens, loss=float(loss))
    finally:
        it.close()  # a failed step must not leak the prefetch thread
    return float(loss) if loss is not None else None


def _copy_into(live, saved) -> None:
    """Write a saved tree into the live tensors in place, key by key (the
    optimizer holds the live leaves: replacing them would leave it
    stepping tensors no longer in the state)."""
    import torch

    if isinstance(live, dict):
        if set(live) != set(saved):
            raise ValueError(f"checkpoint keys {sorted(saved)} != "
                             f"{sorted(live)}")
        for k in live:
            _copy_into(live[k], saved[k])
        return
    live.copy_(torch.as_tensor(saved))


def _host_state_dict(tree):
    """A host copy of an optimizer ``state_dict()``: every tensor cloned
    to the CPU, everything else as is."""
    import torch

    if isinstance(tree, dict):
        return {k: _host_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_state_dict(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def lora_finetune_loop(config: dict):
    """LoRA fine-tune a Llama-family model (BASELINE.json config #3).

    Runs inside each TrainWorker: initializes (or loads) frozen base
    params + LoRA adapters on ``get_device()``, and trains ONLY the
    adapters (build_train_step(trainable_keys=("lora",)) — the backward
    computes no base-weight gradients and the optimizer holds moments
    only for A/B). With ``ScalingConfig.mesh``, or more than one worker,
    the step is sharded over ``get_mesh()`` by the rule table: every rank
    draws the mesh's global batch (``batch_fn(step, 0)``), takes its slice
    (``shard_batch``), and checkpoints its own shards of the adapters and
    their moments.

    config keys:
      preset        — llama preset name (default "debug")
      model_overrides — dict merged into the preset config
      lora_rank / lora_alpha / lora_targets
      lr, steps, batch_size, seq_len, grad_accum, seed
      report_every  — steps between train.report calls (default 10)
      batch_fn      — optional callable (step, rank) -> {"tokens","targets"}
                      as numpy arrays or tensors (defaults to synthetic LM
                      data from a torch.Generator seeded 1000 * rank + step)
      init_params_fn — optional callable (cfg) -> base params as tensors
                      (defaults to llama.init_params(cfg, seed); real runs
                      pass a checkpoint loader); the adapters come from
                      lora.init_lora_params(cfg, lcfg, seed + 1)
    """
    import os
    import pickle
    import tempfile

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import llama, lora
    from ray_tpu_torch.parallel.spmd import (adamw, build_train_step,
                                             shard_batch)
    from ray_tpu_torch.train.checkpoint import Checkpoint, save_pytree

    ctx = train.get_context()
    device = ctx.get_device()
    mesh = (ctx.get_mesh() if ctx.mesh_axes is not None
            or ctx.get_world_size() > 1 else None)

    overrides = dict(config.get("model_overrides") or {})
    overrides.setdefault("lora_alpha", config.get("lora_alpha", 16.0))
    cfg = llama.config_for(config.get("preset", "debug"), **overrides)
    lcfg = lora.LoraConfig(
        # cfg.lora_alpha is the single source of truth for the scale (the
        # forward and merge_lora both read it); mirror it here for repr
        rank=config.get("lora_rank", 8),
        alpha=cfg.lora_alpha,
        targets=tuple(config.get("lora_targets", lora.DEFAULT_TARGETS)))

    seed = config.get("seed", 0)
    init_fn: Callable[[Any], Any] = config.get("init_params_fn") \
        or (lambda c: llama.init_params(c, seed=seed, device=device))
    params = {**init_fn(cfg),
              "lora": lora.init_lora_params(cfg, lcfg, seed + 1,
                                            device=device)}

    loss = lambda p, b: llama.loss_fn(p, b, cfg)  # noqa: E731
    # the step holds its own copy of the params (this rank's shards over a
    # mesh), on the device
    axes = None
    if mesh is not None:
        axes = {**llama.param_logical_axes(cfg),
                "lora": lora.lora_logical_axes(cfg, lcfg)}
    step, state = build_train_step(
        loss, adamw(config.get("lr", 1e-3)), params, axes, mesh,
        grad_accum=config.get("grad_accum", 1),
        trainable_keys=("lora",), device=device)
    del params

    rank = ctx.get_world_rank()
    start_step = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        # failure-policy restart: reload adapters + optimizer moments +
        # step so a resumed run continues EXACTLY where it stopped —
        # resetting AdamW's moments (or its step count, which its bias
        # correction reads) would silently change training dynamics after
        # every restart. Moments cover only the adapters, so the artifact
        # stays small and serving-loadable.
        from ray_tpu_torch.train.checkpoint import load_pytree

        ckpt_dir = ckpt.subdir(f"rank_{rank}").path
        restored = load_pytree(ckpt_dir)
        with torch.no_grad():
            _copy_into(state["params"]["lora"], restored["lora"])
        opt_path = os.path.join(ckpt_dir, "opt_state.pkl")
        if os.path.exists(opt_path):
            # AdamW's state_dict pairs moments with params by position:
            # build_train_step orders the adapter leaves the same way on
            # every build
            with open(opt_path, "rb") as f:
                state["opt_state"].load_state_dict(pickle.load(f))
        start_step = int(restored["step"])

    bsz = config.get("batch_size", 8)
    seq = config.get("seq_len", min(128, cfg.max_seq_len))
    batch_fn = config.get("batch_fn")

    def synthetic(i, rank):
        gen = torch.Generator().manual_seed(1000 * rank + i)
        toks = torch.randint(0, cfg.vocab_size, (bsz, seq), generator=gen)
        return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}

    make_batch = batch_fn or synthetic
    if mesh is None:
        def place(i):
            return _to_device(make_batch(i, rank), device)
    else:
        def place(i):
            return shard_batch(make_batch(i, 0), mesh)
    report_every = config.get("report_every", 10)
    steps = config.get("steps", 50)

    # same waterfall as corpus_pretrain_loop (h2d = the move to the
    # device, step = the update up to a synchronize, ckpt_block stamped
    # inside report)
    rec = ctx.recorder
    if rec is not None:
        step = rec.wrap_jit(step, "lora_step")

    last_loss = first_loss = None
    for i in range(start_step, steps):
        if rec is not None:
            with rec.phase("h2d"):
                batch = place(i)
            with rec.phase("step"):
                state, aux = step(state, batch)
                _sync(device)
        else:
            state, aux = step(state, place(i))
        if (i + 1) % report_every == 0 or i == steps - 1:
            last_loss = float(aux["loss"])
            if first_loss is None:
                first_loss = last_loss
            with tempfile.TemporaryDirectory() as d:
                # adapters-only checkpoint: the LoRA artifact is the
                # deliverable (base stays wherever it was loaded from);
                # optimizer moments and step count ride along so
                # restarts resume the exact trajectory
                save_pytree({"lora": state["params"]["lora"],
                             "step": i + 1}, d)
                with open(os.path.join(d, "opt_state.pkl"), "wb") as f:
                    pickle.dump(_host_state_dict(
                        state["opt_state"].state_dict()), f)
                train.report({"loss": last_loss, "first_loss": first_loss,
                              "step": i + 1},
                             checkpoint=Checkpoint(d))
        if rec is not None:
            rec.end_step(i + 1, loss=float(aux["loss"]))
    return last_loss
