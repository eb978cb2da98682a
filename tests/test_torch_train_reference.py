"""The reference's train-runtime tests, re-pointed at ray_tpu_torch.

``tests/test_train.py`` (checkpoints, the top-k manager, the trainer's
restart from a checkpoint, failure exhaustion, two workers over the host
collective group) and ``tests/test_collective.py`` (the host collective
tier: group ops, the declarative lazy join, the ring allreduce) run
through ``torch_repoint``, one pytest subprocess each, with the train
files' rewrites (``JaxTrainer`` -> ``TorchTrainer``, ``use_gpu=False`` in
every ``ScalingConfig``) and test_train's five jax-bodied tests deselected
(``torch_repoint.DESELECT``: each has a twin in
``tests/test_torch_train.py``). Every selected test passes with no import
of jax or ray_tpu in that process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run (all but DESELECT's)
FILES = {"test_train": 5, "test_collective": 3}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_train_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
