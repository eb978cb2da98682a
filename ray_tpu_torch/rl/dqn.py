"""DQN — value-based off-policy algorithm (ref analogs:
rllib/algorithms/dqn/dqn.py + dqn_rainbow_learner.py: replay-buffer
training loop, target network, double-Q).

Dataflow: DQNRunner actors step envs with epsilon-greedy over Q =
module logits -> transitions into a ReplayBuffer actor -> driver samples
minibatches -> double-DQN Huber TD update on the learner's device (in the
driver's process: the card unless ``num_gpus_per_learner`` is 0) ->
periodic hard target sync -> weights broadcast to runners as host arrays
(same weight-sync pattern as PPO).
"""

from __future__ import annotations

import dataclasses
import time

import cloudpickle
import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rl.env import make_vector_env, require_discrete
from ray_tpu_torch.rl.module_config import MLPModuleConfig
from ray_tpu_torch.rl.replay import ReplayBuffer, ReplayRolloutMixin


class DQNRunner(ReplayRolloutMixin):
    """Epsilon-greedy rollout actor producing replay transitions (on the
    CPU, one intra-op thread)."""

    def __init__(self, env_name: str, num_envs: int, seed: int,
                 module_cfg_blob: bytes):
        from ray_tpu_torch.rl.env_runner import runner_torch

        self._torch, _ = runner_torch(seed)
        self.env = make_vector_env(env_name, num_envs, seed)
        self.module_cfg = cloudpickle.loads(module_cfg_blob)
        self._rng = np.random.default_rng(seed)
        self._obs = self.env.reset(seed)
        self._params = None
        self._ep_return = np.zeros(num_envs, np.float32)
        self._completed: list[float] = []

    def set_weights(self, params) -> bool:
        from ray_tpu_torch.rl.module import to_device

        self._params = to_device(params, "cpu")
        return True

    def sample(self, num_steps: int, epsilon: float) -> dict:
        """[T*N] flat transition arrays + completed episode returns."""
        from ray_tpu_torch.rl import module as rlm

        assert self._params is not None, "set_weights first"
        N = self.env.num_envs
        torch = self._torch

        def select(obs):
            with torch.no_grad():
                q, _ = rlm.forward(self._params, torch.as_tensor(obs))
            greedy = q.argmax(dim=-1).numpy()
            explore = self._rng.random(N) < epsilon
            return np.where(
                explore,
                self._rng.integers(0, self.module_cfg.num_actions, N),
                greedy).astype(np.int32)

        return self._rollout(num_steps, select)

    def cuda_initialized(self) -> bool:
        return bool(self._torch.cuda.is_initialized())

    def ping(self) -> bool:
        return True


@dataclasses.dataclass
class DQNConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_fragment_length: int = 32
    hidden: tuple = (64, 64)
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    learning_starts: int = 1_000
    train_batch_size: int = 128
    updates_per_iteration: int = 16
    target_update_freq: int = 100       # updates between hard target syncs
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 10_000
    double_q: bool = True
    seed: int = 0
    # rllib's AlgorithmConfig.learners(num_gpus_per_learner=...): the
    # learner lives in the driver's process and runs on the card when
    # this is above 0, on the CPU at 0
    num_gpus_per_learner: float = 1

    def build(self) -> "DQN":
        return DQN(self)


def td_loss(params, target_params, batch: dict, gamma: float,
            double_q: bool):
    """Double-DQN (or plain) Huber TD loss of a replay minibatch."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.rl import module as rlm

    q, _ = rlm.forward(params, batch["obs"])
    q_sa = q.gather(1, batch["actions"].long()[:, None])[:, 0]
    with torch.no_grad():
        q_next_target, _ = rlm.forward(target_params, batch["next_obs"])
        if double_q:
            q_next_online, _ = rlm.forward(params, batch["next_obs"])
            next_a = q_next_online.argmax(dim=-1)
        else:
            next_a = q_next_target.argmax(dim=-1)
        q_next = q_next_target.gather(1, next_a[:, None])[:, 0]
        target = batch["rewards"] + gamma * q_next * (
            1.0 - batch["dones"].float())
    return F.huber_loss(q_sa, target, delta=1.0)


class DQNLearner:
    """DQN's learner state on one device: the online and target
    Q-networks (the target a copy, never the same tensors: the optimizer
    steps the online params in place) and Adam."""

    def __init__(self, module_cfg, config: DQNConfig, device=None):
        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl import module as rlm
        from ray_tpu_torch.rl.learner import ClippedAdam, trainable

        self.config = config
        self.device = resolve_device(device)
        self.params = rlm.init_params(module_cfg, config.seed, self.device)
        self._leaves = trainable(self.params)
        self.target_params = rlm.clone_tree(self.params)
        self._opt = ClippedAdam(self._leaves, config.lr)

    def to_device(self, batch: dict) -> dict:
        from ray_tpu_torch.rl.learner import batch_to

        return batch_to(batch, self.device)

    def update(self, batch: dict):
        """One TD step on a minibatch of tensors on this device -> the
        loss (a tensor; reading it waits for the step)."""
        from ray_tpu_torch.rl.learner import grads_of

        loss = td_loss(self.params, self.target_params, batch,
                       self.config.gamma, self.config.double_q)
        self._opt.step(grads_of(loss, self._leaves))
        return loss.detach()

    def sync_target(self) -> None:
        from ray_tpu_torch.rl.module import clone_tree

        self.target_params = clone_tree(self.params)


class DQN:
    def __init__(self, config: DQNConfig):
        from ray_tpu_torch.rl.learner import learner_device

        self.config = config
        probe = make_vector_env(config.env, 1, config.seed)
        require_discrete(probe, "DQN")
        self.module_cfg = MLPModuleConfig(
            observation_size=probe.observation_size,
            num_actions=probe.num_actions, hidden=config.hidden)
        self.learner = DQNLearner(self.module_cfg, config, learner_device(
            config.num_gpus_per_learner))

        blob = cloudpickle.dumps(self.module_cfg)
        runner_cls = rt.remote(num_cpus=1)(DQNRunner)
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

    # ------------------------------------------------------------------ api
    def _broadcast_weights(self):
        from ray_tpu_torch.rl.module import to_host

        ref = rt.put(to_host(self.params))
        self._runners.foreach(lambda a: a.set_weights.remote(ref))

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._env_steps / max(1, c.epsilon_decay_steps))
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def train(self) -> dict:
        c = self.config
        t0 = time.monotonic()
        eps = self._epsilon()
        samples = self._runners.foreach(
            lambda a: a.sample.remote(c.rollout_fragment_length, eps))
        returns = []
        for s in samples:
            self._env_steps += s["steps"]
            returns.extend(s["episode_returns"])
            rt.get(self._buffer.add.remote(s["transitions"]), timeout=60)
        losses = []
        if self._env_steps >= c.learning_starts:
            for _ in range(c.updates_per_iteration):
                batch = rt.get(
                    self._buffer.sample.remote(c.train_batch_size),
                    timeout=60)
                if batch is None:
                    break
                losses.append(self.learner.update(
                    self.learner.to_device(batch)))
                self._updates += 1
                if self._updates % c.target_update_freq == 0:
                    self.learner.sync_target()
            self._broadcast_weights()
        self._iteration += 1
        self._last_returns = (self._last_returns + returns)[-100:]
        mean_ret = (float(np.mean(self._last_returns))
                    if self._last_returns else None)
        return {
            "training_iteration": self._iteration,
            "env_steps": self._env_steps,
            "num_updates": self._updates,
            "epsilon": eps,
            "episode_return_mean": mean_ret,
            "loss": (float(np.mean([float(x) for x in losses]))
                     if losses else None),
            "time_s": time.monotonic() - t0,
        }

    def stop(self):
        for a in [self._buffer] + list(self._runners._actors):
            try:
                rt.kill(a)
            except Exception:
                pass
