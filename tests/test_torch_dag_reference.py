"""The reference's compiled-DAG and device-object tests, re-pointed at
ray_tpu_torch.

Each reference file runs through ``torch_repoint`` in a pytest subprocess
of its own: ``tests/test_dag.py`` (actor and function DAGs, the channel
fast path, pipelining, the shm ring's slot-pin rule, allreduce on both
executors, the tick deadline, teardown), ``tests/test_dag_dcn.py`` (the
DCN ring channels of a two-node cluster), ``tests/test_dag_observability.py``
(channel stats, the GCS dag manager, the tick timeout's cursors, per-tick
tracing) and ``tests/test_device_objects.py`` (the device plane's
refusals). The tests ``torch_repoint.DESELECT`` leaves out run jax in their
bodies (each has a torch twin in ``tests/test_torch_dag_device.py``, or,
for the array sharded over a mesh, in ``tests/test_torch_dag_mesh.py``). test_dag's load-sensitive
allreduce-fallback test runs as an entry of its own (SPLIT). Every
selected test passes with no import of jax or ray_tpu in that process. The
reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run in the file's entry
# (all but DESELECT's and SPLIT's)
FILES = {"test_dag": 15, "test_dag_dcn": 5, "test_dag_observability": 7,
         "test_device_objects": 2}
# load-sensitive tests (ROADMAP.md §3), each run as an entry of its own so
# that a flake under load costs one count and not the file's: test_dag's
# allreduce over the per-call executor's one-shot host groups
SPLIT = {"test_dag": ("test_dag_allreduce_fallback_path",)}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_dag_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170,
                  split=SPLIT.get(name, ()))


@pytest.mark.parametrize("name,test", [(name, test)
                                       for name, tests in SPLIT.items()
                                       for test in tests])
def test_reference_dag_test_passes_on_the_port(name, test, tmp_path):
    run_repointed(name, 1, tmp_path, timeout=120, only=test)
