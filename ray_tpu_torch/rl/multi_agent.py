"""Multi-agent RL: env API, env runner, and PPO driver (ref analogs:
rllib/env/multi_agent_env.py + multi_agent_env_runner.py,
core/rl_module/multi_rl_module.py MultiRLModule, and the
policy_mapping_fn config surface of algorithm_config.py).

Design: a MultiAgentVectorEnv steps ALL agents in lockstep over N
vectorized env copies (dict-of-arrays per agent — the vectorized analog
of the reference's per-agent obs dicts). A policy_mapping_fn assigns
each agent_id to a policy_id; the runner batches every agent of one
policy into a single forward pass, and the driver trains one TorchLearner
per policy on that policy's combined (agent x env) streams. Each
(agent, env) column is an independent experience stream, so GAE and
minibatching reuse the single-agent code unchanged.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rl.env import CartPoleVectorEnv
from ray_tpu_torch.rl.learner import (PPOLearnerConfig, TorchLearner,
                                      build_ppo_batch, learner_device)
from ray_tpu_torch.rl.module_config import MLPModuleConfig


class MultiAgentVectorEnv:
    """N lockstep copies of a multi-agent episode. All dicts are keyed
    by agent_id; every agent reports every tick (ref:
    multi_agent_env.py, vectorized)."""

    agent_ids: tuple[str, ...]
    num_envs: int

    def observation_size(self, agent_id: str) -> int:
        raise NotImplementedError

    def num_actions(self, agent_id: str) -> int:
        raise NotImplementedError

    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: dict[str, np.ndarray]):
        """-> (obs, rewards, terminated, truncated, final_obs), each a
        dict agent_id -> [N, ...] array, with auto-reset semantics
        matching VectorEnv.step."""
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentVectorEnv):
    """K independent cart-poles sharing one vectorized env — the
    reference's standard multi-agent smoke env (rllib
    examples/envs/classes/multi_agent/: MultiAgentCartPole). Each agent
    runs its own episode stream; policy mapping decides who controls
    which pole."""

    def __init__(self, num_envs: int = 8, seed: int = 0,
                 num_agents: int = 2):
        self.num_envs = num_envs
        self.agent_ids = tuple(f"agent_{i}" for i in range(num_agents))
        self._envs = {
            aid: CartPoleVectorEnv(num_envs, seed + 97 * i)
            for i, aid in enumerate(self.agent_ids)}

    def observation_size(self, agent_id: str) -> int:
        return self._envs[agent_id].observation_size

    def num_actions(self, agent_id: str) -> int:
        return self._envs[agent_id].num_actions

    def reset(self, seed=None):
        return {aid: env.reset(None if seed is None else seed + 31 * i)
                for i, (aid, env) in enumerate(self._envs.items())}

    def step(self, actions):
        obs, rew, term, trunc, final = {}, {}, {}, {}, {}
        for aid, env in self._envs.items():
            (obs[aid], rew[aid], term[aid], trunc[aid],
             final[aid]) = env.step(actions[aid])
        return obs, rew, term, trunc, final


_MA_ENV_REGISTRY: dict[str, Callable] = {
    "MultiAgentCartPole": MultiAgentCartPole,
}


def register_multi_agent_env(name: str, creator: Callable) -> None:
    """creator(num_envs, seed, **cfg) -> MultiAgentVectorEnv."""
    _MA_ENV_REGISTRY[name] = creator


def make_multi_agent_env(name: str, num_envs: int, seed: int = 0,
                         **env_cfg) -> MultiAgentVectorEnv:
    if name not in _MA_ENV_REGISTRY:
        raise KeyError(f"unknown multi-agent env {name!r}; "
                       "register_multi_agent_env() it first")
    return _MA_ENV_REGISTRY[name](num_envs, seed, **env_cfg)


class MultiAgentEnvRunner:
    """Sampling actor (ref: multi_agent_env_runner.py): one forward pass
    per POLICY per step (all of that policy's agents batched together),
    per-policy trajectory dicts out — shaped exactly like the
    single-agent runner's so the learner stack is reused unchanged."""

    def __init__(self, env_name: str, num_envs: int, seed: int,
                 module_cfg_blob: bytes, mapping_blob: bytes,
                 env_cfg_blob: bytes | None = None):
        import cloudpickle

        from ray_tpu_torch.rl.env_runner import runner_torch

        # sampling is host-side: one CPU thread, never CUDA
        self._torch, self._gen = runner_torch(seed)
        env_cfg = (cloudpickle.loads(env_cfg_blob)
                   if env_cfg_blob is not None else {})
        self.env = make_multi_agent_env(env_name, num_envs, seed,
                                        **env_cfg)
        self.module_cfgs: dict = cloudpickle.loads(module_cfg_blob)
        self.policy_mapping: Callable = cloudpickle.loads(mapping_blob)
        # policy -> the agents it controls, in a FIXED order (stream
        # layout: columns [agent0_env0..agent0_envN, agent1_env0..])
        self.policy_agents: dict[str, list[str]] = {}
        for aid in self.env.agent_ids:
            self.policy_agents.setdefault(
                self.policy_mapping(aid), []).append(aid)
        self._params: dict | None = None
        obs = self.env.reset(seed)
        self._obs = {p: self._cat(obs, agents)
                     for p, agents in self.policy_agents.items()}
        n_streams = {p: num_envs * len(a)
                     for p, a in self.policy_agents.items()}
        self._ep_return = {p: np.zeros(n, np.float32)
                           for p, n in n_streams.items()}
        self._completed: dict[str, list[float]] = {
            p: [] for p in self.policy_agents}

    def _cat(self, per_agent: dict, agents: list[str]) -> np.ndarray:
        return np.concatenate([per_agent[a] for a in agents])

    def set_weights(self, params_by_policy: dict) -> bool:
        from ray_tpu_torch.rl.module import to_device

        self._params = {p: to_device(w, "cpu")
                        for p, w in params_by_policy.items()}
        return True

    def cuda_initialized(self) -> bool:
        return bool(self._torch.cuda.is_initialized())

    def sample(self, num_steps: int) -> dict:
        """-> {"policies": {policy_id: traj dict}, per-policy episode
        returns inside each traj}. Stream axis = agents x envs."""
        from ray_tpu_torch.rl import module as rlm

        torch = self._torch
        assert self._params is not None, "set_weights first"
        T, N = num_steps, self.env.num_envs
        bufs = {}
        for p, agents in self.policy_agents.items():
            S = N * len(agents)
            obs_dim = np.shape(self._obs[p])[1:]
            bufs[p] = {
                "obs": np.zeros((T, S) + tuple(obs_dim), np.float32),
                "actions": np.zeros((T, S), np.int32),
                "logp": np.zeros((T, S), np.float32),
                "values": np.zeros((T, S), np.float32),
                "rewards": np.zeros((T, S), np.float32),
                "dones": np.zeros((T, S), np.bool_),
                "trunc_values": np.zeros((T, S), np.float32),
            }
        pending_trunc: dict[str, list[tuple]] = {
            p: [] for p in self.policy_agents}
        for t in range(T):
            actions_by_agent: dict[str, np.ndarray] = {}
            for p, agents in self.policy_agents.items():
                action, logp, value = rlm.sample_actions(
                    self._params[p], self._obs[p], self._gen)
                b = bufs[p]
                b["obs"][t] = self._obs[p]
                b["actions"][t] = action
                b["logp"][t] = logp
                b["values"][t] = value
                for i, a in enumerate(agents):
                    actions_by_agent[a] = np.asarray(
                        action[i * N:(i + 1) * N])
            obs, rew, term, trunc, final = self.env.step(actions_by_agent)
            for p, agents in self.policy_agents.items():
                b = bufs[p]
                self._obs[p] = self._cat(obs, agents)
                rewards = self._cat(rew, agents)
                terminated = self._cat(term, agents)
                truncated = self._cat(trunc, agents) & ~terminated
                done = terminated | truncated
                b["rewards"][t] = rewards
                b["dones"][t] = done
                if truncated.any():
                    idxs = np.nonzero(truncated)[0]
                    pending_trunc[p].append(
                        (t, idxs, self._cat(final, agents)[idxs]))
                self._ep_return[p] += rewards
                for i in np.nonzero(done)[0]:
                    self._completed[p].append(
                        float(self._ep_return[p][i]))
                    self._ep_return[p][i] = 0.0
        out = {}
        for p, agents in self.policy_agents.items():
            b = bufs[p]
            with torch.no_grad():
                _, last_value = rlm.forward(
                    self._params[p], torch.as_tensor(self._obs[p]))
            if pending_trunc[p]:
                cat = np.concatenate(
                    [rows for _, _, rows in pending_trunc[p]])
                with torch.no_grad():
                    _, vals = rlm.forward(self._params[p],
                                          torch.as_tensor(cat))
                vals = vals.numpy()
                i = 0
                for t, idxs, rows in pending_trunc[p]:
                    b["trunc_values"][t, idxs] = vals[i:i + len(idxs)]
                    i += len(idxs)
            completed = self._completed[p]
            self._completed[p] = []
            out[p] = {**b, "last_value": last_value.numpy(),
                      "episode_returns": completed}
        return {"policies": out}

    def ping(self) -> bool:
        return True


@dataclasses.dataclass
class MultiAgentPPOConfig:
    """Config #1's multi-agent extension (ref: AlgorithmConfig
    .multi_agent(policies=..., policy_mapping_fn=...))."""
    env: str = "MultiAgentCartPole"
    env_config: dict = dataclasses.field(default_factory=dict)
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_fragment_length: int = 64
    # policy_id -> module-config overrides ({} = defaults); None derives
    # one policy per agent_id
    policies: Optional[dict[str, dict]] = None
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    hidden: tuple = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 256
    seed: int = 0
    # rllib's AlgorithmConfig.learners(num_gpus_per_learner=...): each
    # policy's learner actor is leased this many GPUs (two policies share
    # one card at 0.5) and runs on the card above 0, on the CPU at 0
    num_gpus_per_learner: float = 1

    def learner_config(self) -> PPOLearnerConfig:
        return PPOLearnerConfig(
            lr=self.lr, gamma=self.gamma, gae_lambda=self.gae_lambda,
            clip_eps=self.clip_eps, vf_coeff=self.vf_coeff,
            entropy_coeff=self.entropy_coeff, num_epochs=self.num_epochs,
            minibatch_size=self.minibatch_size)

    def build(self) -> "MultiAgentPPO":
        return MultiAgentPPO(self)


class MultiAgentPPO:
    """One TorchLearner per policy (the MultiRLModule analog: independent
    modules, shared driver); iteration = sample -> per-policy GAE +
    update -> per-policy weight broadcast."""

    def __init__(self, config: MultiAgentPPOConfig):
        import cloudpickle

        self.config = config
        probe = make_multi_agent_env(config.env, 1, config.seed,
                                     **config.env_config)
        mapping = config.policy_mapping_fn or (lambda aid: aid)
        self.policy_agents: dict[str, list[str]] = {}
        for aid in probe.agent_ids:
            self.policy_agents.setdefault(mapping(aid), []).append(aid)
        if config.policies is not None:
            missing = set(self.policy_agents) - set(config.policies)
            if missing:
                raise ValueError(
                    f"policy_mapping_fn produced policies {missing} "
                    f"absent from config.policies")
        self.module_cfgs = {}
        for p, agents in self.policy_agents.items():
            a0 = agents[0]
            # every agent sharing a policy must share spaces — catch the
            # mismatch here with a clear error, not as a shape crash
            # deep inside the runner's concat/forward
            for a in agents[1:]:
                if (probe.observation_size(a) != probe.observation_size(a0)
                        or probe.num_actions(a) != probe.num_actions(a0)):
                    raise ValueError(
                        f"agents {a0!r} and {a!r} map to policy {p!r} "
                        f"but have different spaces (obs "
                        f"{probe.observation_size(a0)} vs "
                        f"{probe.observation_size(a)}, actions "
                        f"{probe.num_actions(a0)} vs "
                        f"{probe.num_actions(a)})")
            overrides = (config.policies or {}).get(p, {})
            self.module_cfgs[p] = MLPModuleConfig(
                observation_size=probe.observation_size(a0),
                num_actions=probe.num_actions(a0),
                hidden=tuple(overrides.get("hidden", config.hidden)))
        module_blob = cloudpickle.dumps(self.module_cfgs)
        mapping_blob = cloudpickle.dumps(mapping)
        env_cfg_blob = cloudpickle.dumps(config.env_config)

        runner_cls = rt.remote(num_cpus=1,
                               max_restarts=-1)(MultiAgentEnvRunner)
        self._runners = FaultTolerantActorManager([
            runner_cls.remote(config.env, config.num_envs_per_runner,
                              config.seed + i, module_blob, mapping_blob,
                              env_cfg_blob)
            for i in range(config.num_env_runners)])

        learner_cls = rt.remote(
            num_cpus=1, num_gpus=config.num_gpus_per_learner)(TorchLearner)
        lcfg_blob = cloudpickle.dumps(config.learner_config())
        device = learner_device(config.num_gpus_per_learner)
        self._learners = {
            p: learner_cls.remote(cloudpickle.dumps(cfg), lcfg_blob,
                                  config.seed + 7 * i, device=device)
            for i, (p, cfg) in enumerate(sorted(self.module_cfgs.items()))}
        init_refs = {p: lr.get_weights.remote()
                     for p, lr in self._learners.items()}
        self._weights = dict(zip(
            init_refs, rt.get(list(init_refs.values()), timeout=120)))
        self._iteration = 0
        self._recent: dict[str, list[float]] = {
            p: [] for p in self.policy_agents}

    def train(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        weights_ref = rt.put(self._weights)
        self._runners.foreach(lambda a: a.set_weights.remote(weights_ref))
        samples = self._runners.foreach(
            lambda a: a.sample.remote(cfg.rollout_fragment_length))
        if not samples:
            self._runners.probe_unhealthy()
            raise RuntimeError("all multi-agent env runners unhealthy")

        update_refs, steps_total = {}, 0
        for p in self.policy_agents:
            batch, ep_returns, steps = build_ppo_batch(
                [s["policies"][p] for s in samples],
                cfg.gamma, cfg.gae_lambda)
            steps_total += steps
            self._recent[p].extend(ep_returns)
            self._recent[p] = self._recent[p][-100:]
            update_refs[p] = self._learners[p].update.remote(batch)
        # collect in parallel: all refs issued before any get
        policies = list(update_refs)
        aux = dict(zip(policies,
                       rt.get([update_refs[p] for p in policies],
                              timeout=600)))
        weight_refs = {p: lr.get_weights.remote()
                       for p, lr in self._learners.items()}
        self._weights = dict(zip(
            weight_refs,
            rt.get(list(weight_refs.values()), timeout=120)))
        self._runners.probe_unhealthy()
        self._iteration += 1
        per_policy = {
            p: {"episode_return_mean": (float(np.mean(r)) if r else 0.0),
                **{f"learner/{k}": v for k, v in aux[p].items()}}
            for p, r in self._recent.items()}
        all_recent = [x for r in self._recent.values() for x in r]
        return {
            "training_iteration": self._iteration,
            "num_env_steps_sampled": steps_total,
            "episode_return_mean": (float(np.mean(all_recent))
                                    if all_recent else 0.0),
            "policies": per_policy,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def get_weights(self) -> dict:
        return self._weights

    def stop(self):
        for a in self._runners._actors + list(self._learners.values()):
            try:
                rt.kill(a)
            except Exception:
                pass
