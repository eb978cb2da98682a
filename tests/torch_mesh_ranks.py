"""Run the port on gloo CPU ranks, one process a rank, for the multi-rank
tests (tests/test_torch_mesh.py, test_torch_spmd_mesh.py, test_torch_sp.py,
test_torch_moe_ep.py, test_torch_pipeline.py).

``run_ranks(program, world, inputs)`` starts ``world`` processes, each of
which joins one gloo process group, runs ``PROGRAMS[program](rank, world,
inputs)`` and pickles its result; it returns the results in rank order, and
kills every rank and raises when one fails or the group outlives its
timeout. This module imports no jax: the ranks run the port only, and the
tests hold what they return against the JAX package.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_ranks(program: str, world: int, inputs=None,
              timeout: float = 90.0) -> list:
    from ray_tpu_torch.parallel.mesh import free_address

    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "inputs.pkl")
        with open(src, "wb") as f:
            pickle.dump(inputs, f)
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(
                   [ROOT, HERE, os.environ.get("PYTHONPATH", "")])}
        address = free_address()
        procs, logs = [], []
        for rank in range(world):
            log = open(os.path.join(d, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import torch_mesh_ranks as r; r._child()", program,
                 str(rank), str(world), address, src,
                 os.path.join(d, f"out{rank}.pkl")],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for rank, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if p.returncode != 0:
                raise RuntimeError(
                    f"{program} rank {rank}/{world} exited {p.returncode} "
                    f"(timeout {timeout}s):\n{text[-4000:]}")
            with open(os.path.join(d, f"out{rank}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs


def _child() -> None:
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import init_process_group

    program, rank, world, address, src, dst = sys.argv[1:7]
    rank, world = int(rank), int(world)
    with open(src, "rb") as f:
        inputs = pickle.load(f)
    init_process_group(world, rank, address, device="cpu", timeout_s=60)
    try:
        out = PROGRAMS[program](rank, world, inputs)
    finally:
        dist.destroy_process_group()
    with open(dst, "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------------ helpers
def _np(tree):
    from ray_tpu_torch.models.convert import params_to_numpy

    return params_to_numpy(tree)


def _t(x, requires_grad=False):
    import torch

    t = torch.tensor(x)
    return t.requires_grad_(True) if requires_grad else t


def _llama_cfg(overrides: dict):
    import torch

    from ray_tpu_torch.models import llama

    kw = dict(overrides)
    kw["dtype"] = getattr(torch, kw.pop("dtype", "float32"))
    return llama.config_for(kw.pop("preset", "debug"), **kw)


def _llama_axes(cfg, params: dict) -> dict:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.lora import _TARGET_AXES

    axes = llama.param_logical_axes(cfg)
    if "lora" in params:
        layers = {}
        for name in params["lora"]["layers"]:
            in_ax, out_ax = _TARGET_AXES[name[:-2]]
            layers[name] = (("layers", in_ax, None) if name.endswith("_a")
                            else ("layers", None, out_ax))
        axes["lora"] = {"layers": layers}
    return axes


# ----------------------------------------------------------------- programs
def train_llama(rank, world, inp):
    """The sharded llama step: ``steps`` AdamW steps on the global batches,
    -> losses, moe_aux, the final params gathered whole, and the frozen
    leaves before and after (LoRA)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel.mesh import build_mesh

    cfg = _llama_cfg(inp["cfg"])
    mesh = build_mesh(inp["mesh"], device="cpu")
    patch = inp.get("patch")
    real_psum, real_dist = col.psum, llama._dist
    if patch == "wrong_psum":
        # torch.distributed.nn's all_reduce: its backward all-reduces again
        import torch.distributed.nn.functional as dnn

        col.psum = lambda x, group: x if group is None else dnn.all_reduce(
            x, group=group)
    elif patch == "local_positions":
        import dataclasses

        def local(cfg, params):
            d = real_dist(cfg, params)
            return None if d is None else dataclasses.replace(d, seq_rank=0)

        llama._dist = local
    try:
        return _train(cfg, mesh, inp)
    finally:
        col.psum, llama._dist = real_psum, real_dist


def _train(cfg, mesh, inp):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import gather_params, params_from_numpy
    from ray_tpu_torch.parallel.spmd import (adamw, build_train_step,
                                             shard_batch)

    params = params_from_numpy(inp["params"], device="cpu")
    axes = _llama_axes(cfg, params)
    seq = inp["mesh"].get("seq", 1) > 1
    import torch

    lr = inp.get("lr", 1e-3)
    opt = (adamw(lr) if inp.get("opt", "adamw") == "adamw"
           else lambda leaves: torch.optim.SGD(leaves, lr=lr))
    step, state = build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt,
        params, axes, mesh, None, seq, inp.get("grad_accum", 1),
        inp.get("trainable_keys"), device="cpu")
    frozen_before = _np(state.get("frozen", {}))
    losses, moe_aux, tokens = [], [], []
    for batch in inp["batches"]:
        state, aux = step(state, shard_batch(batch, mesh, seq_axis=seq))
        losses.append(float(aux["loss"]))
        moe_aux.append(float(aux["moe_aux"]))
        tokens.append(float(aux["tokens"]))
    trained = gather_params(state["params"],
                            {k: axes[k] for k in state["params"]}, mesh)
    return {"losses": losses, "moe_aux": moe_aux, "tokens": tokens,
            "params": _np(trained), "frozen_before": frozen_before,
            "frozen_after": _np(state.get("frozen", {})),
            "local_shapes": {k: tuple(v.shape) for k, v in
                             state["params"].get("layers", {}).items()}}


def ring_group(rank, world, inp):
    """Ring (or Ulysses) attention over a seq group of every rank: this
    rank's output and the gradients of sum(out * g) for its q, k, v."""
    import torch

    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"seq": world}, device="cpu")
    group = mesh.get_group("seq")
    q, k, v, g = (_t(inp[n]).chunk(world, 1)[rank].clone()
                  for n in ("q", "k", "v", "g"))
    for t in (q, k, v):
        t.requires_grad_(True)
    fn = ra.ulysses_attention if inp["impl"] == "ulysses" else \
        ra.ring_attention
    out = fn(q, k, v, group, causal=inp["causal"])
    dq, dk, dv = torch.autograd.grad((out * g).sum(), (q, k, v))
    return {"out": out.detach().numpy(), "dq": dq.numpy(), "dk": dk.numpy(),
            "dv": dv.numpy()}


def moe_ep(rank, world, inp):
    """moe_ffn with this rank's experts (an expert group of every rank):
    output, aux and the gradients of sum(out * g) + aux."""
    import torch

    from ray_tpu_torch.ops.moe import MoEConfig, moe_ffn
    from ray_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"expert": world}, device="cpu")
    ep = mesh.get_group("expert")
    cfg = MoEConfig(**inp["cfg"])
    n_loc = cfg.num_experts // world
    params = {k: _t(v) for k, v in inp["params"].items()}
    for k in ("w_gate", "w_up", "w_down"):
        params[k] = params[k][rank * n_loc:(rank + 1) * n_loc].clone()
    for t in params.values():
        t.requires_grad_(True)
    x = _t(inp["x"], requires_grad=True)
    out, aux = moe_ffn(params, x, cfg, ep=ep)
    loss = (out * _t(inp["g"])).sum() + aux
    grads = torch.autograd.grad(loss, [x] + list(params.values()))
    return {"out": out.detach().numpy(), "aux": float(aux),
            "dx": grads[0].numpy(),
            "grads": {k: g.numpy() for k, g in zip(params, grads[1:])}}


def _mlp_stage(p, x):
    import torch

    h = torch.tanh(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def pipeline(rank, world, inp):
    """pipeline_apply over a stage axis of every rank: the MLP stages of
    tests/test_pipeline.py, or llama blocks; output and the gradients of
    this rank's stage params for mean((out - tgt)^2)."""
    import torch

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.rope import rope_frequencies
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.parallel.pipeline import local_stage, pipeline_apply

    mesh = build_mesh({"stage": world}, device="cpu")
    stacked = {k: _t(v) for k, v in inp["stage_params"].items()}
    params = local_stage(stacked, mesh)
    for t in params.values():
        t.requires_grad_(True)
    if inp["kind"] == "mlp":
        stage_fn = _mlp_stage
    else:
        cfg = _llama_cfg(inp["cfg"])
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta)

        def stage_fn(stage_layers, x):
            x = x.to(cfg.dtype)
            names = list(stage_layers)
            for weights in zip(*(stage_layers[n].unbind(0) for n in names)):
                x, _ = llama._block(cfg, x, dict(zip(names, weights)), cos,
                                    sin, None)
            return x.float()

    x = _t(inp["x"])
    out = pipeline_apply(stage_fn, params, x, mesh, n_micro=inp["n_micro"],
                         remat=inp.get("remat", False))
    res = {"out": out.detach().numpy()}
    if "tgt" in inp:
        loss = ((out - _t(inp["tgt"])) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        res["grads"] = {k: g.numpy() for k, g in zip(params, grads)}
    return res


def collectives(rank, world, inp):
    """Each differentiable collective on a group of every rank: forward and
    the backward of sum(y * w) for a rank-dependent w."""
    import torch

    from ray_tpu_torch.parallel import collectives as col
    from ray_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"tensor": world}, device="cpu")
    group = mesh.get_group("tensor")
    res = {}
    cases = {
        "psum": lambda x: col.psum(x, group),
        "psum_grad": lambda x: col.psum_grad(x, group),
        "all_gather": lambda x: col.all_gather(x, 1, group),
        "gather_replicated": lambda x: col.gather_replicated(x, 1, group),
        "split": lambda x: col.split(x, 1, group),
        "all_to_all": lambda x: col.all_to_all(x, 1, 0, group),
        "ppermute": lambda x: col.ppermute(
            x, [(i, (i + 1) % world) for i in range(world)], group),
    }
    for name, fn in cases.items():
        x = (torch.arange(32.).reshape(4, 8) + 100 * rank).requires_grad_()
        y = fn(x)
        w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape) \
            + 1000 * rank
        (g,) = torch.autograd.grad((y * w).sum(), x)
        res[name] = {"y": y.detach().numpy(), "g": g.numpy()}
    return res


def convert_roundtrip(rank, world, inp):
    """local_params_from_numpy then gather_params: this rank's shard shapes
    and the tree put back together."""
    from ray_tpu_torch.models.convert import (gather_params,
                                              local_params_from_numpy)
    from ray_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(inp["mesh"], device="cpu")
    cfg = _llama_cfg(inp["cfg"])
    axes = _llama_axes(cfg, inp["params"])
    local = local_params_from_numpy(inp["params"], axes, mesh, device="cpu")
    full = gather_params(local, axes, mesh)
    shapes = {k: tuple(v.shape) for k, v in local["layers"].items()}
    return {"full": _np(full), "shapes": shapes,
            "embed": tuple(local["embed"].shape)}


def many(rank, world, inp):
    """Several programs on one group, one after another: [(name, inputs)]
    -> their results (one process start for all)."""
    return [PROGRAMS[name](rank, world, args) for name, args in inp]


PROGRAMS = {f.__name__: f for f in (train_llama, ring_group, moe_ep,
                                    pipeline, collectives,
                                    convert_roundtrip, many)}
