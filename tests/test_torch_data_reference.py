"""The reference's data-plane tests, re-pointed at ray_tpu_torch (part
one): datasets and their sinks.

``tests/test_data.py`` (datasources, map/filter/flat_map, the streaming
executor's backpressure and actor pools, groupby and aggregates,
iter_batches, streaming_split, columnar blocks) and
``tests/test_datasink.py`` (the write path: atomic commits, retry-safe
names, partitioned writes) run through ``torch_repoint`` in a pytest
subprocess each. Every selected test passes with no import of jax or
ray_tpu in that process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run
FILES = {"test_data": 33, "test_datasink": 12}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_data_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
