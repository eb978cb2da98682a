"""IMPALA on pixels (the port's twin of the JAX package's
``tools/rl_image_bench.py``): a rollout fleet streaming Catch-v0's
[10, 10, 1] frames through aggregators into a CNN V-trace learner,
samples/s and the learning curve up to a return threshold, as one JSON
line.

The learner leases the card and updates there unless ``--device cpu`` is
given; the run stops at the threshold or after ``max_minutes``. The
cluster advertises at least ``num_runners + 8`` CPUs whatever the host
has. Run it as ``python -m ray_tpu_torch.tools.rl_image_bench
[num_runners] [max_minutes]`` (64 and 20 by default).
"""

from __future__ import annotations

import os
import time

from ray_tpu_torch.tools import _common, _rl

RETURN_THRESHOLD = 0.8   # random play ~-0.8, perfect play 1.0


def bench(num_runners: int, max_minutes: float, device) -> dict:
    from ray_tpu_torch.rl.impala import IMPALAConfig
    from ray_tpu_torch.rl.module import CNNModuleConfig

    algo = IMPALAConfig(
        env="Catch-v0",
        num_env_runners=num_runners,
        num_envs_per_runner=2,
        rollout_fragment_length=32,
        num_aggregators=4,
        train_batch_size=2048,
        lr=3e-3,
        max_requests_in_flight=2,
        boot_wave=8,
        call_timeout_s=600.0,
        seed=0,
        num_gpus_per_learner=_rl.learner_gpus(device)).build()
    try:
        assert isinstance(algo.module_cfg, CNNModuleConfig)
        r = algo.train()  # pipeline fill
        t0 = time.perf_counter()
        steps0 = r["num_env_steps_sampled"]
        curve = []
        best = -1.0
        deadline = time.monotonic() + max_minutes * 60
        last = r
        while time.monotonic() < deadline:
            last = algo.train()
            ret = last["episode_return_mean"]
            best = max(best, ret)
            curve.append(round(ret, 3))
            if best >= RETURN_THRESHOLD:
                break
        dt = time.perf_counter() - t0
    finally:
        algo.stop()
    steps = last["num_env_steps_sampled"] - steps0
    return {
        "bench": "impala_image",
        "env": "Catch-v0 (pixel [10,10,1] obs, CNN module)",
        "num_env_runners": num_runners,
        "num_envs_per_runner": 2,
        "host_cores": os.cpu_count(),
        "env_steps": steps,
        "samples_per_s": round(steps / dt, 1),
        "episode_return_best": round(best, 3),
        "return_threshold": RETURN_THRESHOLD,
        "threshold_reached": best >= RETURN_THRESHOLD,
        "learner_updates_total": last["training_iteration"],
        "return_curve_tail": curve[-20:],
        "learner_device": device.type,
    }


def main(argv=None) -> dict:
    ap = _common.parser("ray_tpu_torch.tools.rl_image_bench",
                        __doc__.split("\n")[0])
    ap.add_argument("num_runners", nargs="?", type=int, default=64)
    ap.add_argument("max_minutes", nargs="?", type=float, default=20.0)
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    with _rl.cluster(max(args.num_runners + 8, os.cpu_count() or 1)):
        out = bench(args.num_runners, args.max_minutes, device)
    return _common.finish(out, args)


if __name__ == "__main__":
    main()
