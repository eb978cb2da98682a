"""The reference's RL library tests, re-pointed at ray_tpu_torch.

``tests/test_rl.py`` (env physics, GAE, the fault-tolerant fleet, PPO's,
DQN's, CNN IMPALA's and APPO's learning gates, PPO's checkpoint round trip,
the replay ring, connectors) runs through ``torch_repoint`` in a pytest
subprocess, with the RL rewrite (``num_gpus_per_learner=0`` in every
algorithm config: learners on the CPU) and its four jax-bodied tests
deselected (``torch_repoint.DESELECT``: each has a twin in
``tests/test_torch_rl.py``). Seeds, thresholds and throughput floors are
the reference's. Every selected test passes with no import of jax or
ray_tpu in that process. The reference file stays untouched.
"""

from torch_repoint import run_repointed


def test_reference_rl_file_passes_on_the_port(tmp_path):
    run_repointed("test_rl", 12, tmp_path, timeout=400)
