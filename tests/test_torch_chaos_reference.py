"""The reference's chaos suite (``tests/test_chaos.py``: a worker node,
a DAG ring runner, the serve controller and an IMPALA runner killed under
load, each held to its recovery SLO), re-pointed at ray_tpu_torch.

Slow-marked, as the reference file is: outside the tier-1 run, and run
with ``pytest -m slow tests/test_torch_chaos_reference.py``. The copy runs
through ``torch_repoint`` with its helpers ``tools/chaos.py`` and
``tools/envelope_bench.py`` copied beside it with the same rewrites, its
bare-name ``import ray_tpu`` made the port under that name, and its IMPALA
learner asked for the CPU. Every test passes with no import of jax or
ray_tpu in that process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

pytestmark = pytest.mark.slow


def test_reference_chaos_file_passes_on_the_port(tmp_path):
    run_repointed("test_chaos", 8, tmp_path, timeout=600, markers="slow")
