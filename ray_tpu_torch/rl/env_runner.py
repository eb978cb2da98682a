"""EnvRunner actor — CPU sampling fleet (ref analog:
rllib/env/single_agent_env_runner.py:64; episodes stream back as numpy
trajectory dicts, weights arrive as object-store refs or over a compiled
DAG's input edge, exactly the reference's weight-sync pattern).

Runners sample on the CPU with one intra-op thread (their lease is one
CPU: a fleet at torch's default thread count would oversubscribe the
host) and never touch CUDA: weights arrive as numpy arrays or as CPU
tensors (``core.device_objects.rebuild_device``) and are copied into CPU
tensors the runner owns.
"""

from __future__ import annotations

import numpy as np


def runner_torch(seed: int):
    """Import torch for a sampling actor: one intra-op thread, and a CPU
    generator seeded from `seed`."""
    import torch

    torch.set_num_threads(1)
    return torch, torch.Generator().manual_seed(int(seed))


class EnvRunner:
    def __init__(self, env_name: str, num_envs: int, seed: int,
                 module_cfg_blob: bytes,
                 connector_blob: bytes | None = None):
        import cloudpickle

        from ray_tpu_torch.rl.connectors import default_env_to_module
        from ray_tpu_torch.rl.env import make_vector_env

        self._torch, self._gen = runner_torch(seed)
        self.env = make_vector_env(env_name, num_envs, seed)
        self.module_cfg = cloudpickle.loads(module_cfg_blob)
        # env->module connector pipeline (ref: connector_v2.py:31): the
        # same transforms run here at sampling time and in the learner
        self._to_module = (cloudpickle.loads(connector_blob)
                           if connector_blob is not None
                           else default_env_to_module(self.module_cfg))
        self._obs = self._to_module(self.env.reset(seed))
        self._params = None
        # per-env running episode returns (for metrics)
        self._ep_return = np.zeros(num_envs, np.float32)
        self._completed: list[float] = []

    def set_weights(self, params) -> bool:
        """Keep a CPU copy of `params` (numpy arrays or tensors): nothing
        held here aliases a channel slot or an object-store buffer."""
        from ray_tpu_torch.rl.module import to_device

        self._params = to_device(params, "cpu")
        return True

    def sample_dag(self, weights, num_steps: int) -> dict:
        """Compiled-DAG tick (Podracer Sebulba shape): fresh weights ride
        the DAG's input channel edge when the learner broadcast them this
        tick (None = keep sampling with the current, possibly stale,
        weights — IMPALA's defining asynchrony). The weights are copied
        out of the channel as CPU tensors (set_weights)."""
        if weights is not None:
            self.set_weights(weights)
        return self.sample(num_steps)

    def sample(self, num_steps: int) -> dict:
        """Rollout num_steps per env; returns flat [T, N, ...] arrays plus
        completed-episode returns for metrics."""
        from ray_tpu_torch.rl import module as rlm

        torch = self._torch
        assert self._params is not None, "set_weights first"
        T, N = num_steps, self.env.num_envs
        # buffer shape follows the CONNECTOR OUTPUT (self._obs already
        # went through the env->module pipeline, which may reshape)
        obs_buf = np.zeros((T, N) + tuple(np.shape(self._obs)[1:]),
                           np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        trunc_val_buf = np.zeros((T, N), np.float32)
        pending_trunc: list[tuple] = []  # (t, env idxs, final obs rows)
        for t in range(T):
            action, logp, value = rlm.sample_actions(
                self._params, self._obs, self._gen)
            obs_buf[t] = self._obs
            act_buf[t] = action
            logp_buf[t] = logp
            val_buf[t] = value
            (raw_obs, reward, terminated, truncated,
             final_obs) = self.env.step(action)
            self._obs = self._to_module(raw_obs)
            final_obs = self._to_module(final_obs)
            rew_buf[t] = reward
            truncated = truncated & ~terminated
            done = terminated | truncated
            done_buf[t] = done
            if truncated.any():
                idxs = np.nonzero(truncated)[0]
                pending_trunc.append((t, idxs, final_obs[idxs]))
            self._ep_return += reward
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
        with torch.no_grad():
            # bootstrap value for the final observation
            _, last_value = rlm.forward(self._params,
                                        torch.as_tensor(self._obs))
            # truncated (not terminated) episodes bootstrap with
            # V(final_obs) rather than 0 — rllib's truncation semantics
            if pending_trunc:
                cat = np.concatenate([rows for _, _, rows in pending_trunc])
                _, vals = rlm.forward(self._params, torch.as_tensor(cat))
                vals = vals.numpy()
                i = 0
                for t, idxs, rows in pending_trunc:
                    trunc_val_buf[t, idxs] = vals[i:i + len(idxs)]
                    i += len(idxs)
        completed, self._completed = self._completed, []
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "trunc_values": trunc_val_buf,
            "last_value": last_value.numpy(),
            "last_obs": np.asarray(self._obs),  # V-trace bootstrap input
            "episode_returns": completed,
        }

    def cuda_initialized(self) -> bool:
        """Whether this process has created a CUDA context (a runner never
        should)."""
        return bool(self._torch.cuda.is_initialized())

    def ping(self) -> bool:
        return True
