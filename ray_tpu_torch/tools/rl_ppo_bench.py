"""PPO on CartPole (the port's twin of the JAX package's
``tools/rl_ppo_bench.py``): the sustained sample rate through the sample ->
GAE -> update -> broadcast loop, and the return curve that shows the rate
is a learning run's, as one JSON line.

The learner leases the card and updates there unless ``--device cpu`` is
given. Run it as ``python -m ray_tpu_torch.tools.rl_ppo_bench
[num_runners] [iters]`` (4 and 20 by default).
"""

from __future__ import annotations

import os
import time

from ray_tpu_torch.tools import _common, _rl


def bench(num_runners: int, iters: int, device) -> dict:
    from ray_tpu_torch.rl.ppo import PPOConfig

    algo = PPOConfig(
        env="CartPole-v1",
        num_env_runners=num_runners,
        num_envs_per_runner=8,
        rollout_fragment_length=128,
        minibatch_size=1024,
        num_epochs=6,
        entropy_coeff=0.003,
        lr=4e-4,
        seed=0,
        num_gpus_per_learner=_rl.learner_gpus(device)).build()
    try:
        r = algo.train()  # warm-up: the learner's first update
        curve = [r["episode_return_mean"]]
        steps = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            r = algo.train()
            steps += r["num_env_steps_sampled"]
            curve.append(r["episode_return_mean"])
        dt = time.perf_counter() - t0
    finally:
        algo.stop()
    return {
        "bench": "ppo_cartpole",
        "num_env_runners": num_runners,
        "num_envs_per_runner": 8,
        "rollout_fragment_length": 128,
        "host_cores": os.cpu_count(),
        "iterations": iters,
        "env_steps": steps,
        "samples_per_s": round(steps / dt, 1),
        "episode_return_mean_final": r["episode_return_mean"],
        "episode_return_best": max(curve),
        "return_curve": [round(c, 1) for c in curve],
        "learner_device": device.type,
    }


def main(argv=None) -> dict:
    ap = _common.parser("ray_tpu_torch.tools.rl_ppo_bench",
                        __doc__.split("\n")[0])
    ap.add_argument("num_runners", nargs="?", type=int, default=4)
    ap.add_argument("iters", nargs="?", type=int, default=20)
    args = ap.parse_args(argv)
    device = _common.device_of(args)
    with _rl.cluster(max(args.num_runners + 4, os.cpu_count() or 1)):
        out = bench(args.num_runners, args.iters, device)
    return _common.finish(out, args)


if __name__ == "__main__":
    main()
