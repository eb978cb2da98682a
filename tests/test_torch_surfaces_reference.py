"""The reference's tests of the runtime's surfaces, re-pointed at
ray_tpu_torch (part one): the thin client, the state API with the CLI,
and the dashboard.

Each reference file runs through ``torch_repoint`` in a pytest subprocess
of its own, with its own rewrites where it starts the package from a
string: ``tests/test_client.py`` spawns the client proxy from a ``-c``
string, ``tests/test_state_cli.py`` runs ``python -m ray_tpu`` (and asks
the port's microbenchmark for the CPU), ``tests/test_dashboard.py``
submits a job whose script imports the package; each now starts the
port; test_dashboard's data endpoint reads the counters the port's
exchange publishes. Every selected test passes with no import of jax or
ray_tpu in that process. The reference files
stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of its tests that run
FILES = {"test_client": 2, "test_state_cli": 9, "test_dashboard": 12}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_surfaces_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
