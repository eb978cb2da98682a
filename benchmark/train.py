"""The training driver: the port's ``parallel.spmd.build_train_step`` over
``models.llama.loss_fn``, built once, driven from the seed through its
first steps (whose readings ``correct`` compares), then through the
measured window, and checked against the reference's steps.

The program's readings are taken from the same step object the window
uses: each check step's loss, the first gradient as AdamW holds it after
one step (its first moment over 1 - beta1), and after the last check step
each leaf's distance from its initial value (the initial leaf drawn again
from the seed). The reference runs once the window has closed, the peak
memory has been read and the program's state is freed.
"""

from __future__ import annotations

import functools
import gc
import time

import torch

from benchmark import model, reference, traffic
from benchmark.trace import Trace

TRACE_STEPS = 2
CHANGE_RULE = 1e-3     # leaves whose reference gradient is under this
                       # share of the median leaf's are left out of the change


def build_step(conf: dict, params: dict, device):
    """(step, state, optimizer kwargs) of the port's train step."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    tr = conf["assumed"]["train"]
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cfg = llama.LlamaConfig(**model.llama_kwargs(conf),
                            dtype=dtypes[tr["compute_dtype"]],
                            param_dtype=dtypes[tr["param_dtype"]],
                            remat=tr["remat"],
                            remat_policy=tr["remat_policy"],
                            attn_impl=tr["attn_impl"])
    opt = dict(tr["adamw"])
    step, state = build_train_step(functools.partial(llama.loss_fn, cfg=cfg),
                                   adamw(**opt), params, device=device)
    return step, state, opt


def _program_leaves(state: dict) -> dict:
    return model.leaves(state["params"])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(conf_name: str, conf: dict, mix: dict, seed: int, seconds: float,
        trace_on: bool, device, t_start: float, control: bool = False
        ) -> dict:
    """One run of a training cell. Returns the readers' context. With
    ``control``, the checks also hold the control's readings (the fp8
    reference's steps compared with the f32 reference's as the program's
    are) and those of the half-batch fault planted in the reference."""
    d = model.dims(conf)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    param_dtype = dtypes[conf["assumed"]["train"]["param_dtype"]]
    params = model.make_params(d, seed, param_dtype, device)
    step, state, opt_kwargs = build_step(conf, params, device)
    del params              # the step holds its own copy
    gc.collect()

    def feed(i):
        tokens, targets = traffic.train_rows(mix, seed, i, d.vocab, device)
        return {"tokens": tokens, "targets": targets}

    n_check = mix["check_steps"]
    losses, grad_norms = [], {}
    b1 = opt_kwargs.get("b1", 0.9)
    for i in range(n_check):
        state, aux = step(state, feed(i))
        losses.append(float(aux["loss"]))
        if i == 0:
            opt = state["opt_state"]
            grad_norms = {}
            for name, p in _program_leaves(state).items():
                m = opt.state.get(p, {}).get("exp_avg")
                grad_norms[name] = (0.0 if m is None
                                    else float(m.norm()) / (1 - b1))
    change_norms = {}
    with torch.no_grad():
        for name, p in _program_leaves(state).items():
            p0 = model.draw_leaf(d, name, seed, p.dtype, device)
            change_norms[name] = float((p - p0).norm())
            del p0
    _sync(device)

    t_open = time.perf_counter()
    n = 0
    while True:
        state, aux = step(state, feed(n_check + n))
        n += 1
        if time.perf_counter() - t_open >= seconds:
            break
    last_loss = float(aux["loss"])      # waits for the device
    _sync(device)
    t_close = time.perf_counter()

    tr = Trace(trace_on)
    if trace_on:
        with tr:
            with tr.slice():
                for j in range(TRACE_STEPS):
                    state, aux = step(state, feed(n_check + n + j))
                _sync(device)
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device.type == "cuda" else 0)
    del step, state, aux
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    program = {"losses": losses, "grad_norms": grad_norms,
               "change_norms": change_norms}
    checks = judge(program, d, mix, seed, opt_kwargs, device, feed,
                   last_loss, control)
    return {"kind": "train", "dims": d, "mix": mix, "conf": conf,
            "steps": n, "tokens": n * mix["batch"] * mix["seq"],
            "t_open": t_open, "t_close": t_close,
            "window_s": t_close - t_open, "setup_s": t_open - t_start,
            "memory_peak_bytes": memory_peak, "trace": tr.summary,
            "trace_steps": TRACE_STEPS if trace_on else 0,
            "checks": checks}


def compare(program: dict, ref: dict) -> dict:
    """The three numbers ``correct`` compares, each a relative gap:

    * ``loss_gap``: the largest |program - reference| / reference over the
      check steps' losses;
    * ``grad_gap``: over leaves, the largest gap between the program's and
      the reference's first-gradient norms, over the larger of the
      reference's norm of that leaf and of the median leaf;
    * ``change_gap``: the same for each leaf's change over the check steps,
      leaving out leaves whose reference gradient is under ``CHANGE_RULE``
      of the median leaf's."""
    def rel_gaps(prog: dict, refn: dict, names) -> dict:
        med = sorted(refn[k] for k in names)[len(names) // 2]
        return {k: abs(prog[k] - refn[k]) / max(refn[k], med, 1e-30)
                for k in names}

    loss_gaps = [abs(p - r) / abs(r)
                 for p, r in zip(program["losses"], ref["losses"])]
    names = sorted(ref["grad_norms"])
    g = rel_gaps(program["grad_norms"], ref["grad_norms"], names)
    med_g = sorted(ref["grad_norms"].values())[len(names) // 2]
    moved = [k for k in names if ref["grad_norms"][k] >= CHANGE_RULE * med_g]
    c = rel_gaps(program["change_norms"], ref["change_norms"], moved)
    worst_g = max(g, key=g.get)
    worst_c = max(c, key=c.get)
    return {"readings": {"loss_gap": max(loss_gaps), "grad_gap": g[worst_g],
                         "change_gap": c[worst_c]},
            "info": {"worst_grad_leaf": worst_g, "worst_change_leaf": worst_c,
                     "loss_gap_by_step": loss_gaps, "grad_gap_by_leaf": g,
                     "change_gap_by_leaf": c,
                     "left_out_of_change": [k for k in names
                                            if k not in moved],
                     "program_losses": program["losses"],
                     "reference_losses": ref["losses"]}}


def judge(program: dict, d, mix: dict, seed: int, opt_kwargs: dict, device,
          feed, last_loss: float, control: bool = False) -> dict:
    batches = []
    for i in range(mix["check_steps"]):
        b = feed(i)
        batches.append((b["tokens"], b["targets"]))
    ref = reference.train_steps(d, seed, batches, opt_kwargs, device)
    out = compare(program, ref)
    if control:
        low = reference.train_steps(d, seed, batches, opt_kwargs, device,
                                    quant="fp8")
        half = reference.train_steps(
            d, seed, [(t[:len(t) // 2], y[:len(y) // 2]) for t, y in batches],
            opt_kwargs, device)
        for tag, run_ in (("control.", low), ("fault.half_batch.", half)):
            got = compare(run_, ref)
            for k, v in got["readings"].items():
                out["readings"][tag + k] = v
            for k in ("loss_gap_by_step", "grad_gap_by_leaf",
                      "change_gap_by_leaf"):
                out["info"][tag + k] = got["info"][k]
    out["problems"] = ([] if torch.isfinite(torch.tensor(last_loss))
                       else [f"the window's last loss is {last_loss}"])
    return out

