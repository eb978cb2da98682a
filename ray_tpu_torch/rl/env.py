"""Vectorized environments (ref analog: rllib's gymnasium vector envs in
env/single_agent_env_runner.py:64 — the env API is gymnasium-shaped so
real gym envs drop in, but CartPole ships built-in so the library has no
gym dependency)."""

from __future__ import annotations

import numpy as np


class VectorEnv:
    """num_envs independent environments stepped in lockstep with
    auto-reset (done envs restart immediately, final obs in info)."""

    num_envs: int
    observation_size: int
    num_actions: int
    # continuous-action envs set these instead of num_actions (SAC path):
    # actions are float arrays [n, action_size] in [-action_high, action_high]
    continuous: bool = False
    action_size: int = 0
    action_high: float = 1.0

    def reset(self, seed: int | None = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        """-> (obs [n, obs_size], reward [n], terminated [n], truncated [n],
        final_obs [n, obs_size]).

        `obs` is post-auto-reset; `final_obs` is the pre-reset observation
        of each env (== obs where not done) so truncated episodes can be
        bootstrapped with the critic's value of the true final state."""
        raise NotImplementedError


class CartPoleVectorEnv(VectorEnv):
    """Classic cart-pole balancing, vectorized in numpy (dynamics match
    gymnasium's CartPole-v1: max 500 steps, +1 reward per step)."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    def __init__(self, num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self.observation_size = 4
        self.num_actions = 2
        self._rng = np.random.RandomState(seed)
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._state = self._rng.uniform(-0.05, 0.05, (self.num_envs, 4))
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def _reset_envs(self, mask: np.ndarray):
        n = int(mask.sum())
        if n:
            self._state[mask] = self._rng.uniform(-0.05, 0.05, (n, 4))
            self._steps[mask] = 0

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(actions == 1, self.FORCE, -self.FORCE)
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        temp = (force + pole_ml * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0
                                  - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        theta = theta + self.DT * theta_dot
        theta_dot = theta_dot + self.DT * theta_acc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1

        terminated = ((np.abs(x) > self.X_LIMIT)
                      | (np.abs(theta) > self.THETA_LIMIT))
        truncated = (self._steps >= self.MAX_STEPS) & ~terminated
        reward = np.ones(self.num_envs, np.float32)
        final_obs = self._state.astype(np.float32)
        self._reset_envs(terminated | truncated)
        return (self._state.astype(np.float32), reward,
                terminated, truncated, final_obs)


class CatchVectorEnv(VectorEnv):
    """Pixel-observation catch game (the classic DeepMind toy pixel env;
    stands in for ALE where gym/ALE isn't installable — same image-CNN
    training path as config #4's Atari shape).

    A fruit falls from a random top column of a GRID x GRID board; the
    agent moves a paddle on the bottom row (left/stay/right). Episode ends
    when the fruit reaches the bottom: reward +1 if caught, -1 if missed.
    Observations are [GRID, GRID, 1] float32 images (0/1 pixels).

    Committed learning curve (tools/rl_image_bench.py): random policy
    averages ~0.0 (catch probability ~1/GRID gives ~-0.8); a trained CNN
    exceeds +0.8 mean return within a few thousand episodes.
    """

    GRID = 10

    def __init__(self, num_envs: int = 8, seed: int = 0):
        g = self.GRID
        self.num_envs = num_envs
        self.observation_shape = (g, g, 1)
        self.observation_size = g * g  # flat fallback for MLP paths
        self.num_actions = 3           # left, stay, right
        self._rng = np.random.RandomState(seed)
        self._fruit_row = np.zeros(num_envs, np.int64)
        self._fruit_col = np.zeros(num_envs, np.int64)
        self._paddle = np.zeros(num_envs, np.int64)

    def _spawn(self, mask: np.ndarray):
        n = int(mask.sum())
        if n:
            self._fruit_row[mask] = 0
            self._fruit_col[mask] = self._rng.randint(0, self.GRID, n)
            self._paddle[mask] = self._rng.randint(0, self.GRID, n)

    def _render(self) -> np.ndarray:
        g = self.GRID
        obs = np.zeros((self.num_envs, g, g, 1), np.float32)
        idx = np.arange(self.num_envs)
        obs[idx, self._fruit_row, self._fruit_col, 0] = 1.0
        obs[idx, g - 1, self._paddle, 0] = 1.0
        return obs

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._spawn(np.ones(self.num_envs, bool))
        return self._render()

    def step(self, actions: np.ndarray):
        g = self.GRID
        self._paddle = np.clip(self._paddle + (actions - 1), 0, g - 1)
        self._fruit_row += 1
        landed = self._fruit_row >= g - 1
        caught = landed & (self._fruit_col == self._paddle)
        reward = np.where(landed,
                          np.where(caught, 1.0, -1.0), 0.0).astype(np.float32)
        terminated = landed
        truncated = np.zeros(self.num_envs, bool)
        final_obs = self._render()
        self._spawn(landed)
        return self._render(), reward, terminated, truncated, final_obs


class PendulumVectorEnv(VectorEnv):
    """Inverted-pendulum swing-up with a continuous torque action
    (dynamics match gymnasium's Pendulum-v1: obs [cos th, sin th, thdot],
    torque in [-2, 2], 200-step truncation, never terminates)."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    GRAVITY = 10.0
    MASS = 1.0
    LENGTH = 1.0
    MAX_STEPS = 200

    continuous = True
    action_size = 1
    action_high = MAX_TORQUE

    def __init__(self, num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self.observation_size = 3
        self.num_actions = 0
        self._rng = np.random.RandomState(seed)
        self._theta = np.zeros(num_envs, np.float64)
        self._thdot = np.zeros(num_envs, np.float64)
        self._steps = np.zeros(num_envs, np.int64)

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self._theta), np.sin(self._theta),
                         self._thdot], axis=1).astype(np.float32)

    def _reset_envs(self, mask: np.ndarray):
        n = int(mask.sum())
        if n:
            self._theta[mask] = self._rng.uniform(-np.pi, np.pi, n)
            self._thdot[mask] = self._rng.uniform(-1.0, 1.0, n)
            self._steps[mask] = 0

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._reset_envs(np.ones(self.num_envs, bool))
        return self._obs()

    def step(self, actions: np.ndarray):
        u = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th, thdot = self._theta, self._thdot
        # angle normalized to [-pi, pi] for the cost
        th_norm = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = th_norm ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        g, m, ln, dt = self.GRAVITY, self.MASS, self.LENGTH, self.DT
        thdot = thdot + (3 * g / (2 * ln) * np.sin(th)
                         + 3.0 / (m * ln ** 2) * u) * dt
        thdot = np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED)
        self._theta = th + thdot * dt
        self._thdot = thdot
        self._steps += 1
        terminated = np.zeros(self.num_envs, bool)
        truncated = self._steps >= self.MAX_STEPS
        final_obs = self._obs()
        self._reset_envs(truncated)
        return (self._obs(), -cost.astype(np.float32),
                terminated, truncated, final_obs)


class LineReachVectorEnv(VectorEnv):
    """One-step continuous bandit: observe a target t ~ U(-1, 1), act with
    a in [-1, 1], reward -(a - 0.7 t)^2, episode ends. The optimal policy
    mean is 0.7*obs — a fast deterministic learning gate for SAC-style
    actor-critic on a single-core CI host (Pendulum needs ~10k steps)."""

    continuous = True
    action_size = 1
    action_high = 1.0

    def __init__(self, num_envs: int = 8, seed: int = 0):
        self.num_envs = num_envs
        self.observation_size = 1
        self.num_actions = 0
        self._rng = np.random.RandomState(seed)
        self._target = np.zeros(num_envs, np.float64)

    def _spawn(self, mask: np.ndarray):
        n = int(mask.sum())
        if n:
            self._target[mask] = self._rng.uniform(-1.0, 1.0, n)

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._spawn(np.ones(self.num_envs, bool))
        return self._target[:, None].astype(np.float32)

    def step(self, actions: np.ndarray):
        a = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs),
                    -1.0, 1.0)
        reward = -((a - 0.7 * self._target) ** 2).astype(np.float32)
        terminated = np.ones(self.num_envs, bool)
        truncated = np.zeros(self.num_envs, bool)
        final_obs = self._target[:, None].astype(np.float32)
        self._spawn(terminated)
        return (self._target[:, None].astype(np.float32), reward,
                terminated, truncated, final_obs)


_ENV_REGISTRY = {"CartPole-v1": CartPoleVectorEnv,
                 "Catch-v0": CatchVectorEnv,
                 "Pendulum-v1": PendulumVectorEnv,
                 "LineReach-v0": LineReachVectorEnv}


def register_env(name: str, creator):
    """creator(num_envs, seed) -> VectorEnv (ref analog: tune.register_env)."""
    _ENV_REGISTRY[name] = creator


def make_vector_env(name: str, num_envs: int, seed: int = 0) -> VectorEnv:
    if name not in _ENV_REGISTRY:
        raise KeyError(f"unknown env {name!r}; register_env() it first")
    return _ENV_REGISTRY[name](num_envs, seed)


def require_discrete(env: VectorEnv, algo: str):
    """Fail fast when a discrete-action algorithm is pointed at a
    continuous env (the SAC constructor guards the reverse direction —
    without this the failure is an opaque zero-width-head shape
    error deep inside the first forward pass)."""
    if env.continuous:
        raise ValueError(
            f"{algo} needs a discrete-action env; this one is continuous "
            f"(action_size={env.action_size}) — use SAC")
