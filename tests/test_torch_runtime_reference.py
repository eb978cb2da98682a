"""The reference's own runtime tests, re-pointed at ray_tpu_torch.

Each case runs one reference test file through ``torch_repoint``: a copy
with exactly the rewrites listed in its REWRITES, run under pytest in a
subprocess. A case passes when pytest exits 0, every test of the file
passed, and no import of jax or ray_tpu happened in that process. The
reference files stay untouched.
"""

import pytest

from torch_repoint import repoint, run_repointed

# reference file -> the number of tests it holds
FILES = {"test_core_tasks": 19, "test_core_actors": 12, "test_rpc": 7,
         "test_zero_copy": 16, "test_control_fastpath": 5,
         "test_native_store": 8}


def test_rewrites_touch_only_what_they_list():
    src = ("import ray_tpu as rt\n    from ray_tpu.core import x\n"
           "f = rt.remote(num_tpus=2)\nr = {\"TPU\": 8}\n"
           "assert total.get(\"TPU\") == 8.0\n"
           "doc = 'ray_tpu/_native/shm_store.cpp'\n"
           "assert handle.remote(\"TPU\").result(timeout=30) == "
           "\"Hello, TPU!\"\n")
    assert repoint(src) == (
        "import ray_tpu_torch as rt\n    from ray_tpu_torch.core import x\n"
        "f = rt.remote(num_gpus=2)\nr = {\"GPU\": 8}\n"
        "assert total.get(\"GPU\") == 8.0\n"
        "doc = 'ray_tpu/_native/shm_store.cpp'\n"
        "assert handle.remote(\"TPU\").result(timeout=30) == "
        "\"Hello, TPU!\"\n")


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
