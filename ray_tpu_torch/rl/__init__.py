"""ray_tpu_torch.rl — reinforcement learning on the actor substrate (ref
analog: rllib new API stack): env runners sample on the CPU, learners
update on the card. The offline algorithms (BC, CQL; ``offline``) read
recorded transitions through the data plane.

The names below load their submodule on first use, so a process that
only needs a torch-free one (IMPALA's aggregator, the replay buffer)
never imports torch.
"""

import importlib

_EXPORTS = {
    "actor_manager": ("FaultTolerantActorManager",),
    "connectors": ("CastF32", "Connector", "ConnectorPipeline",
                   "FlattenObs", "NormalizeImage"),
    "env": ("CartPoleVectorEnv", "CatchVectorEnv", "LineReachVectorEnv",
            "PendulumVectorEnv", "VectorEnv", "make_vector_env",
            "register_env", "require_discrete"),
    "learner": ("PPOLearnerConfig", "TorchLearner", "compute_gae"),
    "module_config": ("CNNModuleConfig", "MLPModuleConfig",
                      "make_module_config"),
    "ppo": ("PPO", "PPOConfig"),
    "impala": ("APPOConfig", "IMPALA", "AggregatorActor", "IMPALAConfig",
               "IMPALALearner"),
    "vtrace": ("vtrace",),
    "dqn": ("DQN", "DQNConfig", "DQNRunner"),
    "replay": ("ReplayBuffer",),
    "multi_agent": ("MultiAgentCartPole", "MultiAgentEnvRunner",
                    "MultiAgentPPO", "MultiAgentPPOConfig",
                    "MultiAgentVectorEnv", "make_multi_agent_env",
                    "register_multi_agent_env"),
    "sac": ("SAC", "SACConfig", "SACRunner"),
    "offline": ("BC", "BCConfig", "BCLearner", "CQL", "CQLConfig",
                "CQLLearner", "collect_transitions", "evaluate_policy",
                "read_offline_dataset", "write_offline_dataset"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'ray_tpu_torch.rl' has no attribute {name!r}")
    return getattr(importlib.import_module(f"ray_tpu_torch.rl.{mod}"), name)


def __dir__():
    return __all__
