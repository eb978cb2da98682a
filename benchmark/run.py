"""Run one cell of the benchmark of ray_tpu_torch and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. One process, one card: the cell's inputs and
weights are made on the card from ``--seed``, every shape the traffic uses
is warmed up (set-up, ``setup_s``), the window measures for ``--seconds``,
and the program's output is judged against the plain reference
(``correct``). The last line of standard output is one JSON object; the
numbers compared, each beside its limit, close standard error and the line.
With ``--trace 1`` the line carries the cell's per-layer metrics, read
over the window and a traced slice after it, and a ``breakdown`` of device
time; with ``--trace 0`` its end-to-end metrics.

Build and kernel caches stay inside the checkout (``build/``); no module
of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE_ENV = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
             "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def _pin_caches(root: Path) -> None:
    """Every kernel cache at a fixed path inside the checkout (the port's
    own flash build already lives under ``build/ray_tpu_torch``)."""
    base = root / "build" / "benchmark"
    for var, sub in CACHE_ENV.items():
        os.environ[var] = str(base / sub)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, layout, device, t_start: float = T_START) -> dict:
    """Run the cell on ``device``; returns {"line": result dict, "stderr":
    lines}. Raises where no result may be printed."""
    from benchmark import harness

    spec = layout.spec()
    cell = harness.cell_of(spec, args.workload)
    conf = layout.json("configs", cell["config"])
    mix = layout.json("traffic", cell["traffic"])
    limits = layout.json("cells", cell["name"])["limits"]
    if mix["kind"] == "serve":
        from benchmark import serve as driver
    elif mix["kind"] == "train":
        from benchmark import train as driver
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    ctx = driver.run(cell["config"], conf, mix, args.seed, args.seconds,
                     bool(args.trace), device, t_start)
    ctx["cell"] = cell["name"]
    ctx["device_name"] = _device_name(device)
    found = harness.banned_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found[:10]}")
    metrics = {}
    for m in harness.metrics_of(spec, cell["name"], bool(args.trace)):
        if m["name"] == "setup_s":
            value = ctx["setup_s"]
        else:
            value = harness.read_metric(layout, m, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = harness.compare_limits(ctx["checks"], limits)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": ctx["device_name"], "count": 1,
                   "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    breakdown = None
    if args.trace and ctx["trace"] is not None:
        tr = ctx["trace"]
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
    attempted, failed = _counts(ctx)
    line = harness.result_line(correct, attempted, failed, metrics,
                               device_info, checks, breakdown)
    info = dict(ctx["checks"].get("info", {}))
    info.update({f"{k} (not compared)": v
                 for k, v in ctx["checks"].get("readings", {}).items()
                 if k not in limits})
    if ctx.get("late_s"):
        info["generator_late_ms_max_in_window"] = 1e3 * max(ctx["late_s"])
    if ctx["kind"] == "serve" and ctx["mix"]["loop"] == "open":
        # too few requests due in a window to bound a tail (PERF.md), so
        # time to first token is printed here and not reported as a metric
        from benchmark import readers

        ttft = readers.ttft_ms(ctx)
        info["requests_due_in_window"] = len(ttft)
        info["ttft_p50_ms (not a metric)"] = readers.percentile(ttft, 50)
        info["ttft_p90_ms (not a metric)"] = readers.percentile(ttft, 90)
        if ttft:
            info["ttft_mean_ms (not a metric)"] = sum(ttft) / len(ttft)
    stderr = [f"info {k}: {v!r}" for k, v in info.items()]
    stderr += harness.check_lines(checks, ctx["checks"].get("problems", []))
    return {"line": line, "stderr": stderr, "correct": correct, "ctx": ctx}


def _device_name(device) -> str:
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _counts(ctx: dict) -> tuple[int, int]:
    """(attempted, failed): train steps of the window, or the requests of
    the window (due in it for an open loop; in flight during it for a
    closed one)."""
    if ctx["kind"] == "train":
        return ctx["steps"], 0
    t_open, t_close = ctx["t_open"], ctx["t_close"]
    if ctx["mix"]["loop"] == "open":
        reqs = [r for r in ctx["records"] if t_open <= r["due"] < t_close]
    else:
        reqs = [r for r in ctx["records"] if r["sent"] < t_close
                and not (r["done"] and r["t"][-1] < t_open)]
    return len(reqs), sum(1 for r in reqs if r["error"])


def main(argv=None) -> int:
    args = parse(argv)
    root = Path.cwd()
    _pin_caches(root)
    import torch

    from benchmark import harness

    need = harness.cell_of(harness.Layout(root).spec(),
                           args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"the cell needs {need} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(args, harness.Layout(root), torch.device("cuda", 0))
    print(out["line"], flush=True)
    for line in out["stderr"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
