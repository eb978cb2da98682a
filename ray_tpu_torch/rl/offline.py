"""Offline RL: datasets of recorded transitions + offline learners
(ref analogs: rllib/offline/offline_data.py:22 + offline_prelearner.py,
algorithms/bc/bc.py, and CQL's conservative penalty in
algorithms/cql/cql_learner.py — re-designed over ray_tpu_torch.data's
columnar blocks instead of the reference's Arrow/JSON readers).

Storage: directories of .npz shards (one per block). Unlike parquet,
npz holds multi-dim columns (obs matrices, image stacks) natively, and
the shards load back as the data module's NumpyBlocks — so offline
training rides the same streaming/batching path as any other Dataset.

The port of ray_tpu/rl/offline.py. The learners live in the driver's
process, on the card unless ``num_gpus_per_learner`` is 0 (as DQN's):
torch trees of the JAX package's layout, Adam with optax's defaults (eps
1e-8), CQL's target network a ``clone()``. The dataset scan-out
(shuffle, batch) is the distributed part, matching the reference's split
(OfflineData does the IO fan-out, the Learner is one update fn).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from ray_tpu_torch.rl.env import make_vector_env, require_discrete
from ray_tpu_torch.rl.module_config import MLPModuleConfig


# ------------------------------------------------------------ dataset IO
def write_offline_dataset(transitions: dict, path: str,
                          shard_rows: int = 4096) -> int:
    """Append transition columns ({name: [N, ...] array}) to `path` as
    .npz shards; returns rows written. Ref: offline_data writes
    experiences as sharded files keyed by column."""
    os.makedirs(path, exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in transitions.items()}
    n = len(next(iter(arrays.values())))
    existing = len([f for f in os.listdir(path)
                    if f.startswith("shard-") and f.endswith(".npz")])
    written = 0
    for shard_i, start in enumerate(range(0, n, shard_rows)):
        shard = {k: v[start:start + shard_rows] for k, v in arrays.items()}
        final = os.path.join(path, f"shard-{existing + shard_i:06d}.npz")
        # tmp suffix the readers' shard filter EXCLUDES: a crash between
        # write and rename must not leave a file that reads as a shard
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **shard)
        os.replace(tmp, final)
        written += len(next(iter(shard.values())))
    return written


def read_offline_dataset(path: str):
    """-> data.Dataset of columnar NumpyBlocks, one per shard file
    (delegates to the data module's npz reader)."""
    from ray_tpu_torch.data.datasource import read_npz

    return read_npz(os.path.join(path, "shard-*.npz"))


def collect_transitions(env_name: str, policy_fn, num_steps: int,
                        num_envs: int = 8, seed: int = 0) -> dict:
    """Roll a host-side policy (obs [N, ...] -> actions [N]) and record
    SARS'D columns — the offline dataset's producer side."""
    env = make_vector_env(env_name, num_envs, seed)
    obs = env.reset(seed)
    cols: dict[str, list] = {k: [] for k in
                             ("obs", "actions", "rewards", "next_obs",
                              "dones")}
    steps = 0
    while steps < num_steps:
        actions = np.asarray(policy_fn(obs))
        nxt, rew, term, trunc, final = env.step(actions)
        cols["obs"].append(obs.copy())
        cols["actions"].append(actions)
        cols["rewards"].append(rew)
        cols["next_obs"].append(final)
        cols["dones"].append(term)  # truncation is not a true terminal
        obs = nxt
        steps += env.num_envs
    return {k: np.concatenate(v) for k, v in cols.items()}


def evaluate_policy(params, env_name: str, num_episodes: int = 20,
                    seed: int = 1000) -> float:
    """Greedy rollout of a module's policy (on the device its params lie
    on); mean episode return."""
    import torch

    from ray_tpu_torch.rl import module as rlm

    env = make_vector_env(env_name, 1, seed)
    obs = env.reset(seed)
    dev = rlm.params_device(params)
    returns: list[float] = []
    ep_ret = 0.0
    while len(returns) < num_episodes:
        with torch.no_grad():
            logits, _ = rlm.forward(params, torch.as_tensor(obs, device=dev))
        action = logits.argmax(dim=-1).cpu().numpy()
        obs, rew, term, trunc, _ = env.step(action)
        ep_ret += float(rew[0])
        if term[0] or trunc[0]:
            returns.append(ep_ret)
            ep_ret = 0.0
    return float(np.mean(returns))


def _mean_loss(losses: list):
    """The mean of an iteration's loss tensors, read once (None for none)."""
    if not losses:
        return None
    import torch

    return float(np.mean(torch.stack(losses).cpu().numpy()))


# ------------------------------------------------------------- learners
class _OfflineLearner:
    """An offline learner's state on one device: the Q or policy network
    (the JAX package's tree layout) and Adam with optax's defaults."""

    def __init__(self, module_cfg, config, device=None):
        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.rl import module as rlm
        from ray_tpu_torch.rl.learner import ClippedAdam, trainable

        self.config = config
        self.device = resolve_device(device)
        self.params = rlm.init_params(module_cfg, config.seed, self.device)
        self._leaves = trainable(self.params)
        self._opt = ClippedAdam(self._leaves, config.lr)

    def to_device(self, batch: dict) -> dict:
        from ray_tpu_torch.rl.learner import batch_to

        return batch_to(batch, self.device)

    def loss(self, batch: dict):
        raise NotImplementedError

    def update(self, batch: dict):
        """One Adam step on a minibatch of tensors on this device -> the
        loss (a tensor; reading it waits for the step)."""
        from ray_tpu_torch.rl.learner import grads_of

        loss = self.loss(batch)
        self._opt.step(grads_of(loss, self._leaves))
        return loss.detach()


class _OfflineAlgo:
    """Shared offline-algorithm scaffolding: env-probed module config, the
    learner in this process (on the card unless ``num_gpus_per_learner``
    is 0), dataset handle, greedy evaluation."""
    learner_cls: type

    def __init__(self, config):
        from ray_tpu_torch.rl.learner import learner_device

        self.config = config
        probe = make_vector_env(config.env, 1, config.seed)
        require_discrete(probe, type(self).__name__)
        self.module_cfg = MLPModuleConfig(
            observation_size=probe.observation_size,
            num_actions=probe.num_actions, hidden=tuple(config.hidden))
        self.learner = self.learner_cls(self.module_cfg, config,
                                        learner_device(
                                            config.num_gpus_per_learner))
        self.dataset = read_offline_dataset(config.dataset_path)
        self._iteration = 0

    @property
    def params(self):
        return self.learner.params

    def evaluate(self, num_episodes: int = 20) -> float:
        return evaluate_policy(self.params, self.config.env,
                               num_episodes)


@dataclasses.dataclass
class BCConfig:
    """Behavioral cloning (ref: algorithms/bc/bc.py — supervised policy
    imitation over an offline dataset)."""
    dataset_path: str = ""
    env: str = "CartPole-v1"   # for module shapes + evaluation
    hidden: tuple = (64, 64)
    lr: float = 1e-3
    batch_size: int = 512
    epochs_per_iteration: int = 1
    seed: int = 0
    # the learner lives in the driver's process and runs on the card when
    # this is above 0, on the CPU at 0 (as DQNConfig's)
    num_gpus_per_learner: float = 1

    def build(self) -> "BC":
        return BC(self)


class BCLearner(_OfflineLearner):
    def loss(self, batch: dict):
        """Mean negative log-likelihood of the data's actions."""
        import torch

        from ray_tpu_torch.rl import module as rlm

        logits, _ = rlm.forward(self.params, batch["obs"])
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, batch["actions"].long()[:, None])[:, 0].mean()


class BC(_OfflineAlgo):
    learner_cls = BCLearner

    def train(self) -> dict:
        c = self.config
        t0 = time.monotonic()
        losses = []
        for epoch in range(c.epochs_per_iteration):
            # distinct shuffle per EPOCH, not just per iteration
            shuffled = self.dataset.random_shuffle(
                seed=c.seed + self._iteration * c.epochs_per_iteration
                + epoch)
            for batch in shuffled.iter_batches(batch_size=c.batch_size,
                                               drop_last=True):
                losses.append(self.learner.update(self.learner.to_device(
                    {"obs": batch["obs"], "actions": batch["actions"]})))
        self._iteration += 1
        return {"training_iteration": self._iteration,
                "loss": _mean_loss(losses),
                "num_updates": len(losses),
                "time_s": time.monotonic() - t0}


@dataclasses.dataclass
class CQLConfig:
    """Conservative Q-learning over an offline dataset (ref:
    algorithms/cql/ — the discrete-action conservative penalty
    logsumexp(Q) - Q(s, a_data) keeps the learned policy near the data
    distribution, where plain offline DQN overestimates unseen
    actions)."""
    dataset_path: str = ""
    env: str = "CartPole-v1"
    hidden: tuple = (64, 64)
    lr: float = 5e-4
    gamma: float = 0.99
    cql_alpha: float = 1.0     # conservative penalty weight
    batch_size: int = 512
    target_update_freq: int = 100
    updates_per_iteration: int = 200
    seed: int = 0
    # the learner lives in the driver's process and runs on the card when
    # this is above 0, on the CPU at 0 (as DQNConfig's)
    num_gpus_per_learner: float = 1

    def build(self) -> "CQL":
        return CQL(self)


class CQLLearner(_OfflineLearner):
    """The Q-network, its target network (a copy, never the same
    tensors: Adam steps the online params in place) and Adam."""

    def __init__(self, module_cfg, config, device=None):
        from ray_tpu_torch.rl.module import clone_tree

        super().__init__(module_cfg, config, device)
        self.target_params = clone_tree(self.params)

    def loss(self, batch: dict):
        """Huber TD loss against the target network plus `cql_alpha`
        times the conservative term logsumexp(Q) - Q(s, a_data)."""
        import torch
        import torch.nn.functional as F

        from ray_tpu_torch.rl import module as rlm

        c = self.config
        q, _ = rlm.forward(self.params, batch["obs"])
        q_sa = q.gather(1, batch["actions"].long()[:, None])[:, 0]
        with torch.no_grad():
            q_next, _ = rlm.forward(self.target_params, batch["next_obs"])
            target = batch["rewards"] + c.gamma * q_next.max(
                dim=-1).values * (1.0 - batch["dones"].float())
        td = F.huber_loss(q_sa, target, reduction="none", delta=1.0)
        # conservative term: push down out-of-data actions
        cql = torch.logsumexp(q, dim=-1) - q_sa
        return (td + c.cql_alpha * cql).mean()

    def sync_target(self) -> None:
        from ray_tpu_torch.rl.module import clone_tree

        self.target_params = clone_tree(self.params)


class CQL(_OfflineAlgo):
    learner_cls = CQLLearner

    def __init__(self, config: CQLConfig):
        super().__init__(config)
        # materialize the columns ONCE, on the learner's device: the
        # dataset is immutable, and re-fetching every shard per train()
        # would repeat the full-copy cost each iteration
        self._cols = self.learner.to_device(next(
            self.dataset.iter_batches(batch_size=1 << 62)))
        self._n = len(self._cols["actions"])
        self._updates = 0

    def train(self) -> dict:
        import torch

        c = self.config
        t0 = time.monotonic()
        rng = np.random.default_rng(c.seed + self._iteration)
        losses = []
        for _ in range(c.updates_per_iteration):
            # the reference's draws, indexing the columns where they lie
            idx = torch.as_tensor(rng.integers(0, self._n, c.batch_size),
                                  device=self.learner.device)
            losses.append(self.learner.update(
                {k: v[idx] for k, v in self._cols.items()}))
            self._updates += 1
            if self._updates % c.target_update_freq == 0:
                self.learner.sync_target()
        self._iteration += 1
        return {"training_iteration": self._iteration,
                "loss": _mean_loss(losses),
                "num_updates": self._updates,
                "time_s": time.monotonic() - t0}
