"""Replay buffer actor for off-policy RL (ref analogs:
rllib/utils/replay_buffers/replay_buffer.py — uniform ring buffer —
and multi_agent_replay_buffer usage in rllib/algorithms/dqn/).

A plain remote actor: rollout actors `add` transition batches, the
learner `sample`s uniform minibatches. Storage is preallocated numpy
rings (stable memory, O(1) add), created lazily from the first batch's
shapes so the buffer is agnostic to observation spaces.
"""

from __future__ import annotations

import numpy as np


class ReplayRolloutMixin:
    """Shared rollout loop for off-policy runner actors (DQN/SAC). The
    host class provides `self.env`, `self._obs`, `self._ep_return`,
    `self._completed`; action selection is the only per-algorithm part.

    Truncation semantics (rllib's): truncation is NOT a terminal for
    bootstrapping — `dones` records true terminations only, and the
    stored next_obs of a truncated env is its pre-reset final_obs so the
    critic can bootstrap from the real final state."""

    def _rollout(self, num_steps: int, select_action) -> dict:
        env = self.env
        obs_l, act_l, rew_l, nxt_l, done_l = [], [], [], [], []
        for _ in range(num_steps):
            action = select_action(self._obs)
            obs_l.append(self._obs.copy())
            (next_obs, reward, terminated, truncated,
             final_obs) = env.step(action)
            truncated = truncated & ~terminated
            stored_next = next_obs.copy()
            if truncated.any():
                idxs = np.nonzero(truncated)[0]
                stored_next[idxs] = final_obs[idxs]
            act_l.append(action)
            rew_l.append(reward.astype(np.float32))
            nxt_l.append(stored_next)
            done_l.append(terminated.copy())
            self._ep_return += reward
            for i in np.nonzero(terminated | truncated)[0]:
                self._completed.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
            self._obs = next_obs
        completed, self._completed = self._completed, []
        return {
            "transitions": {
                "obs": np.concatenate(obs_l),
                "actions": np.concatenate(act_l),
                "rewards": np.concatenate(rew_l),
                "next_obs": np.concatenate(nxt_l),
                "dones": np.concatenate(done_l),
            },
            "episode_returns": completed,
            "steps": num_steps * env.num_envs,
        }


class ReplayBuffer:
    """Uniform-sampling ring buffer over transition dicts."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._store: dict[str, np.ndarray] | None = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)
        self._added = 0

    def _init_store(self, batch: dict):
        self._store = {}
        for k, v in batch.items():
            v = np.asarray(v)
            self._store[k] = np.zeros((self.capacity,) + v.shape[1:],
                                      v.dtype)

    def add(self, batch: dict) -> int:
        """batch: dict of [N, ...] arrays (same N). Returns total added."""
        arrays = {k: np.asarray(v) for k, v in batch.items()}
        if self._store is None:
            self._init_store(arrays)
        n = len(next(iter(arrays.values())))
        i = self._idx
        for k, v in arrays.items():
            end = min(i + n, self.capacity)
            first = end - i
            self._store[k][i:end] = v[:first]
            if first < n:  # wrap
                self._store[k][:n - first] = v[first:]
        self._idx = (i + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        self._added += n
        return self._added

    def sample(self, batch_size: int) -> dict | None:
        if self._size < batch_size:
            return None
        idxs = self._rng.integers(0, self._size, batch_size)
        return {k: v[idxs] for k, v in self._store.items()}

    def size(self) -> int:
        return self._size

    def stats(self) -> dict:
        return {"size": self._size, "added": self._added,
                "capacity": self.capacity}
