"""SAC — soft actor-critic for continuous control (ref analogs:
rllib/algorithms/sac/sac.py + sac_learner.py: twin Q critics, squashed
Gaussian actor, automatic entropy-temperature tuning; Haarnoja et al.
2018).

Dataflow mirrors DQN's off-policy loop: SACRunner actors step continuous
envs sampling from the tanh-Gaussian policy -> transitions into a
ReplayBuffer actor -> driver samples minibatches -> one update on the
learner's device (in the driver's process: the card unless
``num_gpus_per_learner`` is 0) does critic + actor + alpha steps and the
polyak target move -> actor weights broadcast back to runners as host
arrays.
"""

from __future__ import annotations

import dataclasses
import time

import cloudpickle
import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rl.env import make_vector_env
from ray_tpu_torch.rl.module_config import ContinuousModuleConfig
from ray_tpu_torch.rl.replay import ReplayBuffer, ReplayRolloutMixin


class SACRunner(ReplayRolloutMixin):
    """Rollout actor sampling from the squashed-Gaussian policy (on the
    CPU, one intra-op thread)."""

    def __init__(self, env_name: str, num_envs: int, seed: int,
                 module_cfg_blob: bytes):
        from ray_tpu_torch.rl.env_runner import runner_torch

        self._torch, self._gen = runner_torch(seed)
        self.env = make_vector_env(env_name, num_envs, seed)
        self.module_cfg = cloudpickle.loads(module_cfg_blob)
        self._obs = self.env.reset(seed)
        self._actor = None
        self._ep_return = np.zeros(num_envs, np.float32)
        self._completed: list[float] = []

    def set_weights(self, actor_params) -> bool:
        from ray_tpu_torch.rl.module import to_device

        self._actor = to_device(actor_params, "cpu")
        return True

    def sample(self, num_steps: int, random_actions: bool = False) -> dict:
        """[T*N] flat transition arrays + completed episode returns.

        random_actions drives uniform exploration before learning starts
        (the reference's `num_steps_sampled_before_learning_starts`)."""
        from ray_tpu_torch.rl import module as rlm

        torch = self._torch
        cfg = self.module_cfg
        N, A, high = self.env.num_envs, cfg.action_size, cfg.action_high

        def select(obs):
            if random_actions or self._actor is None:
                u = torch.rand((N, A), generator=self._gen)
                return ((2.0 * u - 1.0) * high).numpy().astype(np.float32)
            with torch.no_grad():
                mean, log_std = rlm.actor_forward(self._actor,
                                                  torch.as_tensor(obs))
                a, _ = rlm.sample_squashed(mean, log_std, self._gen, high)
            return a.numpy().astype(np.float32)

        return self._rollout(num_steps, select)

    def cuda_initialized(self) -> bool:
        return bool(self._torch.cuda.is_initialized())

    def ping(self) -> bool:
        return True


@dataclasses.dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_fragment_length: int = 32
    hidden: tuple = (64, 64)
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005                  # polyak rate for target critics
    initial_alpha: float = 1.0
    target_entropy: float | None = None  # default: -action_size
    buffer_capacity: int = 100_000
    learning_starts: int = 1_000
    train_batch_size: int = 128
    updates_per_iteration: int = 16
    seed: int = 0
    # rllib's AlgorithmConfig.learners(num_gpus_per_learner=...): the
    # learner lives in the driver's process and runs on the card when
    # this is above 0, on the CPU at 0
    num_gpus_per_learner: float = 1

    def build(self) -> "SAC":
        return SAC(self)


class SACLearner:
    """SAC's learner state on one device: the actor, the twin critics and
    their targets (copies, never the same tensors: the critic step writes
    the Q params in place), the temperature and three Adams."""

    def __init__(self, module_cfg: ContinuousModuleConfig, config: SACConfig,
                 device=None):
        import torch

        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl import module as rlm
        from ray_tpu_torch.rl.learner import ClippedAdam, trainable

        self.config = config
        self.module_cfg = module_cfg
        self.device = resolve_device(device)
        self.params = rlm.init_continuous_params(module_cfg, config.seed,
                                                 self.device)
        self.target_q = rlm.clone_tree(
            {"q1": self.params["q1"], "q2": self.params["q2"]})
        self.log_alpha = torch.tensor(float(np.log(config.initial_alpha)),
                                      dtype=torch.float32,
                                      device=self.device)
        self.target_entropy = (config.target_entropy
                               if config.target_entropy is not None
                               else -float(module_cfg.action_size))
        self._actor_leaves = trainable(self.params["actor"])
        self._q_leaves = trainable({"q1": self.params["q1"],
                                    "q2": self.params["q2"]})
        self._actor_opt = ClippedAdam(self._actor_leaves, config.actor_lr)
        self._critic_opt = ClippedAdam(self._q_leaves, config.critic_lr)
        self._alpha_opt = ClippedAdam([self.log_alpha], config.alpha_lr)
        # the learner's normal draws: a generator on its device
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed + 1)

    def to_device(self, batch: dict) -> dict:
        from ray_tpu_torch.rl.learner import batch_to

        return batch_to(batch, self.device)

    def update(self, batch: dict, noise: tuple | None = None) -> dict:
        """One SAC step on a minibatch of tensors on the learner's device:
        the critic step, then the actor step against the UPDATED critics,
        then the temperature step with the hand-written gradient, then the
        polyak move of the targets toward the updated critics. `noise`
        = (critic's, actor's) standard normal draws, each [B, A]; drawn
        from the learner's generator when None. -> stats as tensors."""
        import torch

        from ray_tpu_torch.rl import module as rlm

        c = self.config
        high = self.module_cfg.action_high
        p = self.params
        noise_c, noise_a = noise if noise is not None else (None, None)
        with torch.no_grad():
            alpha = torch.exp(self.log_alpha)
            mean, log_std = rlm.actor_forward(p["actor"], batch["next_obs"])
            next_a, next_logp = rlm.sample_squashed(
                mean, log_std, self._gen, high, noise=noise_c)
            tq1 = rlm.q_forward(self.target_q["q1"], batch["next_obs"],
                                next_a)
            tq2 = rlm.q_forward(self.target_q["q2"], batch["next_obs"],
                                next_a)
            soft_q = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch["rewards"] + c.gamma * soft_q * (
                1.0 - batch["dones"].float())
        q1 = rlm.q_forward(p["q1"], batch["obs"], batch["actions"])
        q2 = rlm.q_forward(p["q2"], batch["obs"], batch["actions"])
        closs = ((q1 - target) ** 2).mean() + ((q2 - target) ** 2).mean()
        self._critic_opt.step(torch.autograd.grad(closs, self._q_leaves))

        # the actor's loss reads the updated critics; its gradient goes
        # to the actor's params only
        mean, log_std = rlm.actor_forward(p["actor"], batch["obs"])
        a, logp = rlm.sample_squashed(mean, log_std, self._gen, high,
                                      noise=noise_a)
        q1 = rlm.q_forward(p["q1"], batch["obs"], a)
        q2 = rlm.q_forward(p["q2"], batch["obs"], a)
        aloss = (alpha * logp - torch.minimum(q1, q2)).mean()
        self._actor_opt.step(torch.autograd.grad(aloss,
                                                 self._actor_leaves))

        # alpha step: loss(log_alpha) = E[-log_alpha*(logp + H_target)],
        # so grad = -(logp + H_target).mean(); entropy below target
        # (logp + H_target > 0) pushes log_alpha UP -> more exploration
        logp = logp.detach()
        self._alpha_opt.step([-(logp + self.target_entropy).mean()])

        with torch.no_grad():
            tau = c.tau
            for key in ("q1", "q2"):
                for t, s in zip(rlm.tensor_leaves(self.target_q[key]),
                                rlm.tensor_leaves(p[key])):
                    t.copy_((1.0 - tau) * t + tau * s)
        return {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
                "alpha": torch.exp(self.log_alpha.detach()),
                "entropy": -logp.mean()}

    def policy_mean(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic (mean) action for evaluation."""
        import torch

        from ray_tpu_torch.rl import module as rlm

        with torch.no_grad():
            mean, _ = rlm.actor_forward(
                self.params["actor"], torch.as_tensor(obs,
                                                      device=self.device))
            return (torch.tanh(mean)
                    * self.module_cfg.action_high).cpu().numpy()



class SAC:
    def __init__(self, config: SACConfig):
        from ray_tpu_torch.rl.learner import learner_device

        self.config = config
        probe = make_vector_env(config.env, 1, config.seed)
        if not probe.continuous:
            raise ValueError(
                f"SAC needs a continuous-action env; {config.env!r} is "
                "discrete (use DQN/PPO, or give the env `continuous=True` "
                "with `action_size`/`action_high`)")
        self.module_cfg = ContinuousModuleConfig(
            observation_size=probe.observation_size,
            action_size=probe.action_size,
            action_high=float(probe.action_high), hidden=config.hidden)
        self.learner = SACLearner(self.module_cfg, config, learner_device(
            config.num_gpus_per_learner))

        blob = cloudpickle.dumps(self.module_cfg)
        runner_cls = rt.remote(num_cpus=1)(SACRunner)
        self._runners = FaultTolerantActorManager([
            runner_cls.remote(config.env, config.num_envs_per_runner,
                              config.seed + 1 + i, blob)
            for i in range(config.num_env_runners)])
        self._buffer = rt.remote(num_cpus=0)(ReplayBuffer).remote(
            config.buffer_capacity, config.seed)
        self._broadcast_weights()
        self._iteration = 0
        self._env_steps = 0
        self._updates = 0
        self._last_returns: list[float] = []

    @property
    def params(self):
        return self.learner.params

    def policy_mean(self, obs: np.ndarray) -> np.ndarray:
        """Deterministic (mean) action for evaluation."""
        return self.learner.policy_mean(obs)

    # ------------------------------------------------------------------ api
    def _broadcast_weights(self):
        from ray_tpu_torch.rl.module import to_host

        ref = rt.put(to_host(self.params["actor"]))
        self._runners.foreach(lambda a: a.set_weights.remote(ref))

    def train(self) -> dict:
        c = self.config
        t0 = time.monotonic()
        warmup = self._env_steps < c.learning_starts
        samples = self._runners.foreach(
            lambda a: a.sample.remote(c.rollout_fragment_length, warmup))
        returns = []
        for s in samples:
            self._env_steps += s["steps"]
            returns.extend(s["episode_returns"])
            rt.get(self._buffer.add.remote(s["transitions"]), timeout=60)
        stats = None
        if self._env_steps >= c.learning_starts:
            for _ in range(c.updates_per_iteration):
                batch = rt.get(
                    self._buffer.sample.remote(c.train_batch_size),
                    timeout=60)
                if batch is None:
                    break
                stats = self.learner.update(self.learner.to_device(batch))
                self._updates += 1
            self._broadcast_weights()
        self._iteration += 1
        self._last_returns = (self._last_returns + returns)[-100:]
        mean_ret = (float(np.mean(self._last_returns))
                    if self._last_returns else None)
        out = {
            "training_iteration": self._iteration,
            "env_steps": self._env_steps,
            "num_updates": self._updates,
            "episode_return_mean": mean_ret,
            "time_s": time.monotonic() - t0,
        }
        if stats is not None:
            out.update({k: float(v) for k, v in stats.items()})
        return out

    def stop(self):
        for a in [self._buffer] + list(self._runners._actors):
            try:
                rt.kill(a)
            except Exception:
                pass
