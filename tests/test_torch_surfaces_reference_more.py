"""The reference's tests of the runtime's surfaces, re-pointed at
ray_tpu_torch (part two): Serve's request observability and node drain.

Each reference file runs through ``torch_repoint`` in a pytest subprocess
of its own: ``tests/test_serve_observability.py`` (request waterfalls,
`list requests`, `serve status`) and ``tests/test_drain.py`` (graceful
drain, the drain CLI's rendering, the pending-group prune knob; its
bare-name ``import ray_tpu`` becomes the port under that name). test_drain's
load-sensitive re-register test runs as an entry of its own (SPLIT).
Every selected test passes with no import of jax or ray_tpu in that
process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run in the file's entry
# (all but SPLIT's)
FILES = {"test_serve_observability": 18, "test_drain": 5}
# load-sensitive tests (ROADMAP.md §3), each run as an entry of its own
SPLIT = {"test_drain": ("test_reregister_after_completed_drain_clears_label",)}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_surfaces_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170,
                  split=SPLIT.get(name, ()))


@pytest.mark.parametrize("name,test", [(name, test)
                                       for name, tests in SPLIT.items()
                                       for test in tests])
def test_reference_surfaces_test_passes_on_the_port(name, test, tmp_path):
    run_repointed(name, 1, tmp_path, timeout=120, only=test)
