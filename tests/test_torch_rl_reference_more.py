"""The reference's SAC and multi-agent tests, re-pointed at ray_tpu_torch.

``tests/test_sac.py`` (continuous envs, SAC's refusal of a discrete env,
its LineReach learning gate) and ``tests/test_rl_multi_agent.py`` (the
lockstep env, two policies learning MultiAgentCartPole) run through
``torch_repoint``, one pytest subprocess each, with the RL rewrite
(``num_gpus_per_learner=0`` in every algorithm config) and their jax-bodied
tests deselected (each has a twin in ``tests/test_torch_rl.py``). A file of
its own beside ``test_torch_rl_reference.py``, so that ``--dist loadfile``
spreads the RL gates over two workers. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run (all but DESELECT's)
FILES = {"test_sac": 5, "test_rl_multi_agent": 2}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_rl_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=300)
