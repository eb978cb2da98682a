"""PPO algorithm (ref analogs: rllib/algorithms/ppo/ppo.py:363,
training_step:389; dataflow per SURVEY.md §3.6: EnvRunner actors sample →
GAE → LearnerGroup update → weights broadcast back via the object
store)."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import cloudpickle
import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager
from ray_tpu_torch.rl.env import make_vector_env, require_discrete
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.impala import _sample_fragment_nbytes, _tree_leaves
from ray_tpu_torch.rl.learner import (PPOLearnerConfig, TorchLearner,
                                      learner_device)
from ray_tpu_torch.rl.module_config import CNNModuleConfig, MLPModuleConfig


@dataclasses.dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_env_runners: int = 2
    num_envs_per_runner: int = 8
    rollout_fragment_length: int = 64
    num_learners: int = 1
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
    # steady-state sampling plane: compile the runner fleet onto a
    # channel DAG (dag/channel_exec.py) — weights broadcast over the
    # input edge, fragments stream back over output rings; one iteration
    # submits `sample_waves` pipelined ticks (the waves overlap through
    # the rings, so 2 waves cost ~1.2x one wave's wall time and double
    # the on-policy batch per update). False restores per-call sampling.
    use_compiled_dag: bool = True
    sample_waves: int = 2
    # device edges: wave-0's weight broadcast rides a DEVICE input edge
    # (dag/device_channel.py — array leaves as raw host bytes, rebuilt as
    # CPU tensors in each runner; never a host pickle of the buffers).
    # False restores host framing on the input edges.
    use_device_edges: bool = True
    # rllib's AlgorithmConfig.learners(num_gpus_per_learner=...): each
    # learner actor is leased this many GPUs and runs on the card when it
    # is above 0, on the CPU at 0
    num_gpus_per_learner: float = 1

    def learner_config(self) -> PPOLearnerConfig:
        return PPOLearnerConfig(
            lr=self.lr, gamma=self.gamma, gae_lambda=self.gae_lambda,
            clip_eps=self.clip_eps, vf_coeff=self.vf_coeff,
            entropy_coeff=self.entropy_coeff, num_epochs=self.num_epochs,
            minibatch_size=self.minibatch_size)

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    """Algorithm driver (ref: Algorithm.train()); iteration =
    sample → update → broadcast."""

    def __init__(self, config: PPOConfig):
        self.config = config
        probe = make_vector_env(config.env, 1, config.seed)
        require_discrete(probe, "PPO")
        obs_shape = getattr(probe, "observation_shape", None)
        if obs_shape is not None:
            self.module_cfg = CNNModuleConfig(
                obs_shape=tuple(obs_shape), num_actions=probe.num_actions)
        else:
            self.module_cfg = MLPModuleConfig(
                observation_size=probe.observation_size,
                num_actions=probe.num_actions, hidden=tuple(config.hidden))
        module_blob = cloudpickle.dumps(self.module_cfg)
        learner_blob = cloudpickle.dumps(self.config.learner_config())

        runner_cls = rt.remote(num_cpus=1, max_restarts=-1)(EnvRunner)
        # runner spec retained for DAG recovery's respawn path (a dead
        # runner with no restarts left is replaced from here)
        self._runner_cls = runner_cls
        self._module_blob = module_blob
        self._spawned_runners = config.num_env_runners
        # placement-plane consult: soft co-location of the runner fleet
        # (see rl/actor_manager.gang_placement_options)
        from ray_tpu_torch.rl.actor_manager import gang_placement_options

        gang_opts = gang_placement_options(config.num_env_runners)
        self._runners = FaultTolerantActorManager([
            runner_cls.options(**gang_opts[i]).remote(
                config.env, config.num_envs_per_runner,
                config.seed + i, module_blob)
            for i in range(config.num_env_runners)])

        n_learn = config.num_learners
        group = f"ppo-learners-{id(self):x}" if n_learn > 1 else None
        learner_cls = rt.remote(
            num_cpus=1, num_gpus=config.num_gpus_per_learner)(TorchLearner)
        device = learner_device(config.num_gpus_per_learner)
        self._learners = [
            learner_cls.remote(module_blob, learner_blob, config.seed,
                               group, n_learn, rank, device)
            for rank in range(n_learn)]
        self._iteration = 0
        self._recent_returns: list[float] = []
        self._weights = rt.get(self._learners[0].get_weights.remote(),
                               timeout=120)
        # compiled-DAG sampling plane (see PPOConfig.use_compiled_dag)
        self._dag = None
        if config.use_compiled_dag:
            self._build_dag()

    def _build_dag(self):
        """Recovery-wrapped compiled sampling plane: a dead runner
        mid-wave triggers teardown → restart/respawn → recompile →
        resume (see dag/recovery.py) instead of failing the iteration."""
        from ray_tpu_torch.dag.recovery import RecoverableDag

        self._dag = RecoverableDag(
            self._compile_dag, recover_cb=self._recover_runners,
            name="ppo")

    def _compile_dag(self, epoch: int = 0, recovered_from: str = ""):
        from ray_tpu_torch.dag import InputNode, MultiOutputNode

        cfg = self.config
        runners = self._runners.healthy_actors()
        with InputNode() as inp:
            outs = [r.sample_dag.bind(inp, cfg.rollout_fragment_length)
                    for r in runners]
        node = MultiOutputNode(outs) if len(outs) > 1 else outs[0]
        self._dag_multi = len(outs) > 1
        sample_nbytes = 2 * _sample_fragment_nbytes(
            self.module_cfg, cfg.rollout_fragment_length,
            cfg.num_envs_per_runner) + (1 << 16)
        weights_nbytes = 2 * sum(
            int(np.asarray(w).nbytes) for w in _tree_leaves(self._weights)
        ) + (1 << 16)
        return node.experimental_compile(
            buffer_size_bytes=max(sample_nbytes, weights_nbytes, 1 << 20),
            max_inflight=max(2, cfg.sample_waves + 1),
            device_input=cfg.use_device_edges,
            epoch=epoch, recovered_from=recovered_from)

    def _recover_runners(self, failed: dict):
        """RecoverableDag recover_cb (same policy as IMPALA's): wait for
        GCS restarts, respawn replacements for runners that stay dead,
        and push the driver's current weights so a restarted runner does
        not sample from its init params until wave 0 replays."""
        from ray_tpu_torch._internal.config import get_config
        from ray_tpu_torch.dag.recovery import DagRecoveryError, wait_actor_alive

        cfg = self.config
        by_hex = {a._actor_id.hex(): a for a in self._runners._actors}
        fatal = [h for h in failed if h not in by_hex]
        if fatal:
            raise DagRecoveryError(
                f"non-runner DAG peers died ({fatal}); PPO's sampling "
                "ring only spans env runners")
        timeout = get_config().dag_recovery_restart_timeout_s
        for hexid in failed:
            runner = by_hex[hexid]
            if wait_actor_alive(runner, timeout) != "ALIVE":
                replacement = self._runner_cls.remote(
                    cfg.env, cfg.num_envs_per_runner,
                    cfg.seed + self._spawned_runners, self._module_blob)
                self._spawned_runners += 1
                self._runners.replace(runner, replacement)
        self._runners.probe_unhealthy(timeout=timeout)
        weights_ref = rt.put(self._weights)
        self._runners.foreach(
            lambda a: a.set_weights.remote(weights_ref))

    # ------------------------------------------------------------------ train
    def train(self) -> dict:
        cfg = self.config
        t0 = time.perf_counter()
        if self._dag is not None:
            # compiled-DAG sampling: wave 0 carries this iteration's
            # weights over the input edge; later waves pipeline through
            # the rings with the same weights (still on-policy — no
            # update happens between waves)
            from ray_tpu_torch.util import builtin_metrics as _bm

            w0 = self._weights
            if cfg.use_device_edges:
                # device input edges ship raw host bytes: mark the HOST
                # weight leaves for the framing directly — moving them to
                # the card and packing would round-trip every leaf
                # H2D+D2H for nothing
                from ray_tpu_torch.dag.device_channel import wrap_host_arrays

                w0, _ = wrap_host_arrays(w0)
            refs = [self._dag.execute(w0 if k == 0 else None)
                    for k in range(max(1, cfg.sample_waves))]
            # PPO stays on-policy: staleness is bounded by the wave
            # count (all waves sample the weights broadcast on wave 0)
            _bm.rl_dag_staleness.set(len(refs), tags={"algo": "ppo"})
            _bm.rl_dag_weight_broadcasts.inc(tags={"algo": "ppo"})
            samples = []
            for ref in refs:
                vals = ref.get(timeout=600)
                samples.extend(vals if self._dag_multi else [vals])
        else:
            weights_ref = rt.put(self._weights)
            self._runners.foreach(
                lambda a: a.set_weights.remote(weights_ref))
            samples = self._runners.foreach(
                lambda a: a.sample.remote(cfg.rollout_fragment_length))
        if not samples:
            self._runners.probe_unhealthy()
            raise RuntimeError("all env runners unhealthy")
        batch, ep_returns, steps = self._build_batch(samples)
        self._recent_returns.extend(ep_returns)
        self._recent_returns = self._recent_returns[-100:]

        shards = self._split_batch(batch, len(self._learners))
        aux = rt.get([lr.update.remote(s)
                      for lr, s in zip(self._learners, shards)],
                     timeout=600)[0]
        self._weights = rt.get(self._learners[0].get_weights.remote(),
                               timeout=120)
        self._runners.probe_unhealthy()
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else 0.0),
            "num_env_steps_sampled": steps,
            "time_this_iter_s": time.perf_counter() - t0,
            **{f"learner/{k}": v for k, v in aux.items()},
        }

    def _build_batch(self, samples: list[dict]):
        from ray_tpu_torch.rl.learner import build_ppo_batch

        cfg = self.config
        return build_ppo_batch(samples, cfg.gamma, cfg.gae_lambda)

    @staticmethod
    def _split_batch(batch: dict, n: int) -> list[dict]:
        if n == 1:
            return [batch]
        return [{k: v[i::n] for k, v in batch.items()} for i in range(n)]

    # ------------------------------------------------------- checkpointable
    def save_to_path(self, path: str) -> str:
        import os
        import pickle

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            pickle.dump({"weights": self._weights,
                         "iteration": self._iteration,
                         "config": self.config}, f)
        return path

    def restore_from_path(self, path: str) -> None:
        import os
        import pickle

        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self._weights = state["weights"]
        self._iteration = state["iteration"]
        rt.get([lr.set_weights.remote(self._weights)
                for lr in self._learners], timeout=120)

    def stop(self):
        if self._dag is not None:
            try:
                self._dag.teardown()
            except Exception:
                pass
            self._dag = None
        for a in self._runners._actors + self._learners:
            try:
                rt.kill(a)
            except Exception:
                pass
