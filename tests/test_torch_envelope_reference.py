"""The reference's envelope gates, re-pointed at ray_tpu_torch: the
shuffle's GB/s floor and its win over a barrier exchange
(``tests/test_shuffle_envelope.py``), and a cluster of many nodes, an
actor fleet and placement groups with bounded GCS memory
(``tests/test_scale_envelope.py``).

Slow-marked, as the reference files are: run with ``pytest -m slow
tests/test_torch_envelope_reference.py``. Each copy runs through
``torch_repoint`` with ``tools/envelope_bench.py`` copied beside it with
the same rewrites (``SUPPORT_FILES``), and the reference's floors. Every
test passes with no import of jax or ray_tpu in that process. The
reference files stay untouched.
"""

import signal

import pytest

from torch_repoint import run_repointed

pytestmark = pytest.mark.slow

# reference file -> (its tests, the seconds its copy may take: the
# reference's own alarms, 600 s for the shuffle, 1800 + 2400 + 1800 s for
# the scale tests at 160 nodes)
FILES = {"test_shuffle_envelope": (1, 900), "test_scale_envelope": (3, 6000)}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_envelope_file_passes_on_the_port(name, tmp_path):
    n_tests, timeout = FILES[name]
    signal.alarm(timeout + 60)   # the per-test alarm is sized for fast tests
    run_repointed(name, n_tests, tmp_path, timeout=timeout, markers="slow")
