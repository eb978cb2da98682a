"""IMPALA at scale (the port's twin of the JAX package's
``tools/rl_scale_bench.py``): N rollout runners pipelining through
aggregators into the learner, the steady-state samples/s, as one JSON
line.

The learner leases the card and updates there unless ``--device cpu`` is
given. The cluster advertises at least ``num_runners + 8`` CPUs whatever
the host has: the point is the control plane's scale (N actors through
the aggregators), not the host's cores. Run it as
``python -m ray_tpu_torch.tools.rl_scale_bench [num_runners] [iters]``
(32 and 10 by default).
"""

from __future__ import annotations

import os
import sys
import time

from ray_tpu_torch.tools import _common, _rl


def bench(num_runners: int, iters: int, device) -> dict:
    from ray_tpu_torch.rl.impala import IMPALAConfig

    algo = IMPALAConfig(
        env="CartPole-v1",
        num_env_runners=num_runners,
        num_envs_per_runner=2,
        rollout_fragment_length=32,
        num_aggregators=4,
        train_batch_size=2048,
        max_requests_in_flight=2,
        boot_wave=4,
        call_timeout_s=600.0,
        seed=0,
        num_gpus_per_learner=_rl.learner_gpus(device)).build()
    try:
        r = algo.train()  # warm-up: let the pipeline fill
        t0 = time.perf_counter()
        steps0 = r["num_env_steps_sampled"]
        last = r
        for _ in range(iters):
            last = algo.train()
        dt = time.perf_counter() - t0
    finally:
        algo.stop()
    return {
        "bench": "impala_scale",
        "num_env_runners": num_runners,
        "num_envs_per_runner": 2,
        "host_cores": os.cpu_count(),
        "iterations": iters,
        "env_steps": last["num_env_steps_sampled"] - steps0,
        "samples_per_s": round(
            (last["num_env_steps_sampled"] - steps0) / dt, 1),
        "episode_return_mean": last["episode_return_mean"],
        "learner_updates_total": last["training_iteration"],
        "learner_device": device.type,
    }


def _dump_state() -> None:
    """Which actors never came up, and the cluster's resources (stderr)."""
    try:
        from ray_tpu_torch import state_api

        for a in state_api.list_actors():
            if a.get("state") != "ALIVE":
                print("NOT-ALIVE ACTOR:", a, file=sys.stderr)
        print("STATUS:", state_api.cluster_status(), file=sys.stderr)
    except Exception as e:
        print("state dump failed:", e, file=sys.stderr)


def main(argv=None) -> dict:
    ap = _common.parser("ray_tpu_torch.tools.rl_scale_bench",
                        __doc__.split("\n")[0])
    ap.add_argument("num_runners", nargs="?", type=int, default=32)
    ap.add_argument("iters", nargs="?", type=int, default=10)
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    with _rl.cluster(max(args.num_runners + 8, os.cpu_count() or 1)):
        try:
            out = bench(args.num_runners, args.iters, device)
        except BaseException:
            _dump_state()
            raise
    return _common.finish(out, args)


if __name__ == "__main__":
    main()
