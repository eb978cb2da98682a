"""A device profile of ``bench``'s train step (the port's twin of the JAX
package's ``tools/profile_step.py``): one warm-up step, then three steps
traced with ``torch.profiler``, and the top operators by device time, as
one JSON line.

Each operator row gives its own device time (the kernels it launched
itself), its calls and its host time; ``kernels`` sums device time by
kernel name. The trace is held to what the steps launched: a trace with no
kernel, or whose flash kernels differ in number from the launches the
flash wrappers counted, raises. The window opens with 64 tiny spin kernels
and half a second of idle before the steps and closes half a second after
them, since kineto drops kernel records it places outside the window
(chip_smoke.profile_call does the same). With ``--out`` the full operator
table is written there.

Run it as ``python -m ray_tpu_torch.tools.profile_step [--preset P
--batch B --seq S]`` (410m, 8, 2048 by default; the card unless
``--device cpu``).
"""

from __future__ import annotations

import time

from ray_tpu_torch.tools import _common

TRACED_STEPS = 3
# kineto drops a kernel record whose timestamp falls outside the trace
# window: on the H100 machines the first records of a session, and now and
# then a session's kernels mapped ms early. So the window opens with tiny
# spin kernels (counted nowhere), then idle seconds before the steps, and
# closes idle seconds after them
WARMUP_KERNELS = 64
SLACK_S = 0.5


def profile(device, preset: str = "410m", batch: int = 8, seq: int = 2048,
            attn_impl: str = "flash", top: int = 25) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    from ray_tpu_torch.ops.cuda import flash_attention as fa

    cfg = _common.train_config(preset, seq, attn_impl=attn_impl)
    step, state, data = _common.build_step(cfg, batch, seq, device)
    state, aux = step(state, data)
    aux["loss"].item()
    _common.sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    fa.reset_launches()
    with trace(activities=activities) as prof:
        if device.type == "cuda":
            for _ in range(WARMUP_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        time.sleep(SLACK_S)
        t0 = time.perf_counter()
        for _ in range(TRACED_STEPS):
            state, aux = step(state, data)
        aux["loss"].item()
        _common.sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(SLACK_S)
    counted = sum(fa.launches.values())
    ops = []
    for row in prof.key_averages():
        if row.device_type != DeviceType.CPU:     # kernels: in `kernels`
            continue
        dev_us = getattr(row, "self_device_time_total", 0.0)
        ops.append({"op": row.key, "calls": row.count,
                    "self_device_ms": dev_us / 1e3,
                    "self_cpu_ms": row.self_cpu_time_total / 1e3})
    ops.sort(key=lambda r: (-r["self_device_ms"], -r["self_cpu_ms"]))
    kernels: dict[str, list] = {}
    for ev in prof.events():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or "spin_kernel" in ev.name):      # the window's warm-up
            continue
        row = kernels.setdefault(ev.name, [0.0, 0])
        row[0] += ev.device_time_total / 1e3
        row[1] += 1
    traced = sum(n for _, n in kernels.values())
    flash_traced = sum(n for name, (_, n) in kernels.items()
                       if "flash_" in name.lower())
    if device.type == "cuda" and (traced == 0 or flash_traced != counted):
        raise RuntimeError(
            f"the trace caught {traced} kernel launches, {flash_traced} of "
            f"them flash, while the flash wrappers counted {counted}")
    busy_ms = sum(ms for ms, _ in kernels.values())
    by_kernel = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"preset": preset, "batch": batch, "seq": seq,
            "traced_steps": TRACED_STEPS, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": (max(0.0, 1 - busy_ms / wall_ms)
                                  if device.type == "cuda" else None),
            "launches_traced": traced, "flash_launches_traced": flash_traced,
            "flash_launches_counted": counted, "top_ops": ops[:top],
            "all_ops": ops,
            "kernels": [{"kernel": name[:120], "ms": ms, "calls": n}
                        for name, (ms, n) in by_kernel[:top]],
            **_common.card(device)}


def main(argv=None) -> dict:
    ap = _common.parser("ray_tpu_torch.tools.profile_step",
                        __doc__.split("\n")[0])
    ap.add_argument("--preset", default="410m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--attn", default="flash")
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    res = profile(device, args.preset, args.batch, args.seq, args.attn)
    return _common.finish(res, args, {"ops": res.pop("all_ops")})


if __name__ == "__main__":
    main()
