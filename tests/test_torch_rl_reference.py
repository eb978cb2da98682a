"""The reference's RL library tests, re-pointed at ray_tpu_torch.

``tests/test_rl.py`` (env physics, GAE, the fault-tolerant fleet, PPO's,
DQN's, CNN IMPALA's and APPO's learning gates, PPO's checkpoint round trip,
the replay ring, connectors) runs through ``torch_repoint`` in a pytest
subprocess, with the RL rewrite (``num_gpus_per_learner=0`` in every
algorithm config: learners on the CPU) and its four jax-bodied tests
deselected (``torch_repoint.DESELECT``: each has a twin in
``tests/test_torch_rl.py``). Its three slowest learning gates run as
entries of their own (SPLIT). Seeds, thresholds and throughput floors are
the reference's. Every selected test passes with no import of jax or
ray_tpu in that process. The reference file stays untouched.
"""

import pytest

from torch_repoint import run_repointed

# the slowest learning gates (30-50 s each on the CPU), each run as an
# entry of its own, so that under a loaded xdist run the file's entry
# stays well inside the per-test alarm (RAYT_TEST_TIMEOUT_S, 180 s)
SPLIT = ("test_dqn_learns_cartpole", "test_impala_learns_catch_with_cnn",
         "test_ppo_learns_cartpole")


def test_reference_rl_file_passes_on_the_port(tmp_path):
    run_repointed("test_rl", 12 - len(SPLIT), tmp_path, timeout=170,
                  split=SPLIT)


@pytest.mark.parametrize("test", SPLIT)
def test_reference_rl_test_passes_on_the_port(test, tmp_path):
    run_repointed("test_rl", 1, tmp_path, timeout=170, only=test)
