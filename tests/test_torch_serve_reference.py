"""The reference's own Serve tests, re-pointed at ray_tpu_torch.

``tests/test_serve.py`` (the controller, replicas, router, HTTP and gRPC
ingress, composition, multiplexing, admission and health probes) and
``tests/test_serve_autoscale.py`` (the autoscaling policy and an end-to-end
scale up and down) run through ``torch_repoint``, one pytest subprocess
each: every test of the file passes, with no import of jax or ray_tpu in
that process. The reference files stay untouched.
"""

import pytest

from torch_repoint import run_repointed

# reference file -> the number of tests it holds
FILES = {"test_serve": 28, "test_serve_autoscale": 9}


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_serve_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=300)
