"""The reference's ingest and train-observability tests, re-pointed at
ray_tpu_torch.

``tests/test_ingest_train.py`` (a corpus_pretrain_loop fit killed
mid-epoch resumes onto a bit-identical token stream, disjoint shards over
two workers, ingest metrics, the prefetch perf gate) and
``tests/test_train_observability.py`` (the GCS train manager, the step
recorder's waterfall, heartbeat and memory, the async checkpoint split)
run through ``torch_repoint``, one pytest subprocess each, with the train
files' rewrites. Four observability tests are deselected
(``torch_repoint.DESELECT``): wrap_jit with jnp arrays has a twin in
``tests/test_torch_train.py``; three read ``state_api`` or the CLI
(ROADMAP.md item 2b), the RL learner's waterfall among them (its twin is
in ``tests/test_torch_rl.py``). Every
selected test passes with no import of jax or ray_tpu in that process.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run (all but DESELECT's)
FILES = {"test_ingest_train": 6, "test_train_observability": 16}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_ingest_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
