"""The train step's tokens/s and MFU over (preset, batch, remat policy,
attention) configurations (the port's twin of the JAX package's
``tools/mfu_sweep.py``): one child process a configuration, so one that
runs out of memory costs only its row.

The matrix is the reference's, less its flash tile sizes (the CUDA
kernels' tiles are fixed): head_dim 64 (``410m``, 16 heads) against 128
(``410m-hd128``, 8 heads, the same params), remat "dots" (saves matmul
outputs) against "nothing" (saves only the block carries, which leaves
room for larger batches), and the flash kernels against the plain
attention. MFU is against the bf16 dense peak of the H100 part found.

Run it as ``python -m ray_tpu_torch.tools.mfu_sweep`` (the matrix) or with
``--one PRESET BATCH POLICY ATTN`` (one configuration); it prints
``{"rows": [{"cfg", "tok_s", "mfu"} or {"cfg", "error"}, ...], "best"}``
as one JSON line, on the card unless ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from ray_tpu_torch.tools import _common

SEQ = 2048
STEPS = 15

CONFIGS = [
    # (preset, batch, remat policy, attention)
    ("410m", 8, "dots", "flash"),        # bench's configuration
    ("410m", 8, "nothing", "flash"),
    ("410m", 16, "nothing", "flash"),
    ("410m", 24, "nothing", "flash"),
    ("410m-hd128", 8, "dots", "flash"),
    ("410m-hd128", 16, "nothing", "flash"),
    ("410m-hd128", 8, "dots", "xla"),
]


def measure(device, preset: str, batch: int, policy: str, attn: str,
            seq: int = SEQ, steps: int = STEPS) -> dict:
    cfg = _common.train_config(preset, seq, remat_policy=policy,
                               attn_impl=attn)
    res = _common.timed_steps(cfg, batch, seq, steps, device)
    peak = _common.peak_flops(device)
    return {"tok_s": round(res["tokens_per_s"], 1),
            "mfu": (None if peak is None else
                    round(res["tokens_per_s"] * cfg.flops_per_token()
                          / peak, 4)),
            "step_ms": res["step_ms"], "launches": res["launches"]}


def _child_env() -> dict:
    """This environment with the package's root first on the path."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    return {**os.environ,
            "PYTHONPATH": root + (os.pathsep + path if path else "")}


def sweep(args, configs) -> dict:
    rows = []
    for preset, batch, policy, attn in configs:
        label = {"preset": preset, "batch": batch, "policy": policy,
                 "attn": attn}
        cmd = [sys.executable, "-m", "ray_tpu_torch.tools.mfu_sweep",
               "--one", preset, str(batch), policy, attn,
               "--seq", str(args.seq), "--steps", str(args.steps)]
        if args.device:
            cmd += ["--device", args.device]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout, env=_child_env())
        except subprocess.TimeoutExpired:
            rows.append({"cfg": label, "error": "timeout"})
            continue
        line = next((ln for ln in reversed(r.stdout.splitlines())
                     if ln.startswith("{")), None)
        if r.returncode != 0 or line is None:
            rows.append({"cfg": label, "error": r.stderr[-300:]})
            continue
        rows.append({"cfg": label, **json.loads(line)})
    done = [r for r in rows if r.get("tok_s") is not None]
    key = "mfu" if all(r.get("mfu") is not None for r in done) else "tok_s"
    return {"rows": rows,
            "best": max(done, key=lambda r: r[key]) if done else None}


def main(argv=None) -> dict:
    ap = _common.parser("ray_tpu_torch.tools.mfu_sweep",
                        __doc__.split("\n")[0])
    ap.add_argument("--one", nargs=4, metavar=("PRESET", "BATCH", "POLICY",
                                               "ATTN"))
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a configuration may take")
    ap.add_argument("--configs", default=None,
                    help="PRESET:BATCH:POLICY:ATTN,... instead of the "
                         "matrix")
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    if args.one:
        preset, batch, policy, attn = args.one
        return _common.finish(measure(device, preset, int(batch), policy,
                                      attn, args.seq, args.steps), args)
    configs = CONFIGS
    if args.configs:
        configs = [(p, int(b), pol, a) for p, b, pol, a in
                   (c.split(":") for c in args.configs.split(","))]
    return _common.finish({**sweep(args, configs), "seq": args.seq,
                           "steps": args.steps, **_common.card(device)},
                          args)


if __name__ == "__main__":
    main()
