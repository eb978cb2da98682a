"""The reference's ingest and train-observability tests, re-pointed at
ray_tpu_torch.

``tests/test_ingest_train.py`` (a corpus_pretrain_loop fit killed
mid-epoch resumes onto a bit-identical token stream, disjoint shards over
two workers, ingest metrics, the prefetch perf gate) and
``tests/test_train_observability.py`` (the GCS train manager, the step
recorder's waterfall, heartbeat and memory, the async checkpoint split)
run through ``torch_repoint``, one pytest subprocess each, with the train
files' rewrites. One observability test is deselected
(``torch_repoint.DESELECT``): wrap_jit with jnp arrays has a twin in
``tests/test_torch_train.py``. The tests that read ``state_api`` and the
CLI run, the RL learner's waterfall among them. The end-to-end waterfall
test, whose tiling bound is load-sensitive (ROADMAP.md §3), runs as an
entry of its own (SPLIT). Every selected test passes with no import of
jax or ray_tpu in that process.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run in the file's entry
# (all but DESELECT's and SPLIT's)
FILES = {"test_ingest_train": 6, "test_train_observability": 18}
# load-sensitive tests (ROADMAP.md §3), each run as an entry of its own:
# the waterfall's residual share of a ~2 ms CPU step sits near its 10%
# bound in both packages
SPLIT = {"test_train_observability":
         ("test_e2e_run_waterfall_compile_memory_and_cli",)}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_ingest_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170,
                  split=SPLIT.get(name, ()))


@pytest.mark.parametrize("name,test", [(name, test)
                                       for name, tests in SPLIT.items()
                                       for test in tests])
def test_reference_ingest_test_passes_on_the_port(name, test, tmp_path):
    run_repointed(name, 1, tmp_path, timeout=120, only=test)
