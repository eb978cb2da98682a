"""The reference's tests of the cluster's util, events, runtime envs and
placement plane, re-pointed at ray_tpu_torch.

Each reference file runs through ``torch_repoint`` in a pytest subprocess
of its own: ``tests/test_util.py`` (ActorPool, Queue, multiprocessing's
Pool, the joblib backend), ``tests/test_cluster_events.py`` (the event
manager, scheduling decisions, why-pending), ``tests/test_runtime_env.py``
and ``tests/test_placement.py``'s non-slow tests. The tests
``torch_repoint.DESELECT`` leaves out exercise the PJRT site-import modes
the port drops (twin in ``tests/test_torch_surfaces.py``);
test_cluster_events' chaos test runs the port's autoscaler with the local
provider. test_placement's load-sensitive DAG placement gate runs as an
entry of its own (SPLIT). Every selected test
passes with no import of jax or ray_tpu in that process. The reference
files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its non-slow tests that run in the
# file's entry (all but DESELECT's and SPLIT's)
FILES = {"test_util": 6, "test_cluster_events": 10, "test_runtime_env": 14,
         "test_placement": 10}
# load-sensitive tests (ROADMAP.md §3), each run as an entry of its own:
# the DAG gate asks the placement plane for a gang right after killing the
# baseline's actors, before their leases are freed
SPLIT = {"test_placement": ("test_plane_placed_dag_compiles_preferred_kinds",)}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_cluster_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170,
                  split=SPLIT.get(name, ()))


@pytest.mark.parametrize("name,test", [(name, test)
                                       for name, tests in SPLIT.items()
                                       for test in tests])
def test_reference_cluster_test_passes_on_the_port(name, test, tmp_path):
    run_repointed(name, 1, tmp_path, timeout=120, only=test)
