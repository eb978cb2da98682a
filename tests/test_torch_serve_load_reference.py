"""The reference's sustained-load serve gates (``tests/test_serve_load.py``:
the sustained, latency, multi-proxy, prefix-reuse and disaggregated legs,
each held to its floors), re-pointed at ray_tpu_torch.

Slow-marked, as the reference file is: outside the tier-1 run, and run
with ``pytest -m slow tests/test_torch_serve_load_reference.py``. The copy
runs through ``torch_repoint`` with the port's twin of the reference's
``tools/serve_bench.py`` (``ray_tpu_torch/tools/serve_bench.py``) copied
to where the reference's sits (``SUPPORT_FILES``), and its in-process
engine legs asked for the CPU (``SERVE_LOAD_REWRITES``): the
disaggregated leg's prefill and decode engines are tensor-parallel at
``tp=2`` on gloo CPU ranks, as the reference's are at ``tp=2``. The floors
are the reference's, unchanged. Every test passes with no import of jax or
ray_tpu in that process. The reference file stays untouched.
"""

import signal

import pytest

from torch_repoint import run_repointed

pytestmark = pytest.mark.slow


def test_reference_serve_load_file_passes_on_the_port(tmp_path):
    signal.alarm(960)     # the per-test alarm is sized for fast tests
    run_repointed("test_serve_load", 5, tmp_path, timeout=900,
                  markers="slow")
