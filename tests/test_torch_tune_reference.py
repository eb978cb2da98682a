"""The reference's Tune and offline-RL tests, re-pointed at
ray_tpu_torch.

``tests/test_tune.py`` (grid and random search, ASHA, PBT, resume, trials
of two workers, TPE and BOHB; its ScalingConfig asks for the CPU, as the
train files' do) and ``tests/test_rl_offline.py`` (an expert CartPole
dataset through the data plane; BC and CQL learners, on the CPU through
the RL rewrite, past the reference's gates) run through ``torch_repoint``
in a pytest subprocess each. Every selected test passes with no import of
jax or ray_tpu in that process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run
FILES = {"test_tune": 11, "test_rl_offline": 3}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_tune_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
