"""Readings the benchmark's limits and rates were set from (not part of a
benchmark run).

    python3 -m benchmark.calibrate control --workload <cell> --seeds 1,2,3 \
        --seconds <s>
        For each seed, one run of the cell with the control beside it: the
        program's readings of ``correct`` and the control's (the plain
        reference computed with fp8 matmul operands in the program's
        place), one JSON line a seed, with ``correct`` as a run would judge
        the program and ``control.correct`` as it would judge the control
        (and a training cell's planted half-batch fault) against the cell's
        limits. A limit lies above the program's largest reading and below
        the control's smallest.

    python3 -m benchmark.calibrate sweep --workload <open-loop cell> \
        --rates 1.5,2,2.5 --seconds 51
        The open loop at each rate on a fresh engine: requests due in the
        window against requests completed in it. The knee is the highest
        rate at which completions keep within 5% of arrivals.

Each runs in one process on the card, from the root of a checkout.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import sys
import time
from pathlib import Path


def _cell(layout, name):
    from benchmark import harness

    cell = harness.cell_of(layout.spec(), name)
    return (cell, layout.json("configs", cell["config"]),
            layout.json("traffic", cell["traffic"]))


def control(layout, name: str, seeds: list, seconds: float, device) -> list:
    from benchmark import harness

    cell, conf, mix = _cell(layout, name)
    limits = layout.json("cells", name)["limits"]
    driver = __import__(f"benchmark.{mix['kind']}", fromlist=["run"])
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = driver.run(cell["config"], conf, mix, seed, seconds, False,
                         device, t0, control=True)
        ctx["cell"], ctx["device_name"] = name, _name(device)
        readings = ctx["checks"]["readings"]
        row = {"workload": name, "seed": seed,
               "correct": harness.compare_limits(ctx["checks"], limits)[0]}
        for tag in sorted({k.rsplit(".", 1)[0] + "." for k in readings
                           if "." in k}):
            # the control (or a planted fault) judged as a run would be:
            # its readings against the cell's own limits
            own = {k[len(tag):]: v for k, v in readings.items()
                   if k.startswith(tag)}
            row[tag + "correct"] = harness.compare_limits(
                {"readings": own}, limits)[0]
        row.update({"readings": readings,
                    "problems": ctx["checks"].get("problems", []),
                    "info": ctx["checks"].get("info", {}),
                    "seconds": time.perf_counter() - t0})
        for m in harness.metrics_of(layout.spec(), name, False):
            if m["name"] != "setup_s":
                row[m["name"]] = harness.read_metric(layout, m, ctx)
        print(json.dumps(row), flush=True)
        out.append(row)
        del ctx
    return out


def sweep(layout, name: str, rates: list, seconds: float, device,
          seed: int = 7) -> list:
    import torch

    from benchmark import model

    cell, conf, mix = _cell(layout, name)
    if mix["loop"] != "open":
        raise ValueError("the sweep drives an open loop")
    d = model.dims(conf)
    params = model.make_params(d, seed, torch.bfloat16, device)
    out = []
    for rate in rates:
        row = _sweep_one(cell, conf, dict(mix, rate_per_s=rate), params, d,
                         seconds, device, seed)
        print(json.dumps(dict(row, workload=name)), flush=True)
        out.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _sweep_one(cell, conf, mix, params, d, seconds, device, seed) -> dict:
    from benchmark import readers, serve, traffic
    from benchmark.trace import Trace

    engine = serve.build_engine(cell["config"], conf, params, device)
    reqs = traffic.serve_requests(mix, seed, traffic.open_loop_count(
        mix, seconds), d.vocab)
    client = serve._Client(engine, float(mix["temperature"]))

    async def main():
        await serve._warm_up(engine, mix, reqs, client.temperature, d.vocab,
                             seed)
        return await serve._open_loop(engine, client, mix, reqs, seconds,
                                      Trace(False))

    t_open, t_close, stats_close, extra = asyncio.run(main())
    ctx = {"kind": "serve", "mix": mix, "records": client.records,
           "t_open": t_open, "t_close": t_close}
    due = readers.due_in_window(ctx)
    done = [r for r in client.records
            if r["done"] and t_open <= r["t"][-1] <= t_close]
    ttft = readers.ttft_ms(ctx)
    return {"rate_per_s": mix["rate_per_s"], "due_in_window": len(due),
            "completed_in_window": len(done),
            "completed_over_due": len(done) / max(1, len(due)),
            "ttft_p50_ms": readers.percentile(ttft, 50),
            "ttft_p90_ms": readers.percentile(ttft, 90),
            "unfinished_at_end": sum(1 for r in due if not r["done"]),
            "decode_steps": stats_close["batches"]
            - extra["stats_open"]["batches"],
            "late_ms_max": 1e3 * max(extra["late_s"] or [0.0])}


def _name(device) -> str:
    import torch

    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def main(argv=None) -> int:
    from benchmark.run import _pin_caches

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("what", choices=("control", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _pin_caches(Path.cwd())
    import torch

    from benchmark.harness import Layout

    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    layout, device = Layout(Path.cwd()), torch.device("cuda", 0)
    if args.what == "control":
        control(layout, args.workload,
                [int(s) for s in args.seeds.split(",")], args.seconds,
                device)
    else:
        sweep(layout, args.workload,
              [float(r) for r in args.rates.split(",")], args.seconds,
              device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
