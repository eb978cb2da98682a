"""The reference's tests of the runtime's core, re-pointed at
ray_tpu_torch (part one).

Each reference file runs through ``torch_repoint`` in a pytest subprocess
of its own: ``tests/test_multi_node.py`` (clusters of several node
managers, spillback, node death), ``tests/test_cancel.py`` (task
cancellation), ``tests/test_object_transfer.py`` (objects pulled between
nodes), ``tests/test_serialization.py`` and ``tests/test_ids.py``. Every
test of each file passes with no import of jax or ray_tpu in that process.
The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests
FILES = {"test_multi_node": 8, "test_cancel": 5, "test_object_transfer": 4,
         "test_serialization": 6, "test_ids": 4}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_core_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
