"""The reference's own runtime tests, re-pointed at ray_tpu_torch.

Each case runs one reference test file through ``torch_repoint``: a copy
with exactly the rewrites listed in its REWRITES, run under pytest in a
subprocess. A case passes when pytest exits 0, every test of the file
passed, and no import of jax or ray_tpu happened in that process. The
reference files stay untouched.
"""

import pytest

import torch_repoint
from torch_repoint import (FILE_REWRITES, repoint, repointed_copy,
                           run_repointed, strings_starting_the_reference)

# reference file -> the number of its non-slow tests
FILES = {"test_core_tasks": 19, "test_core_actors": 12, "test_rpc": 7,
         "test_zero_copy": 16, "test_control_fastpath": 5,
         "test_native_store": 8, "test_object_state": 22,
         "test_task_events": 22}


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


def test_file_rewrites_for_strings_touch_only_what_they_list():
    """The rewrites of the files that start the package from a string
    change those strings and nothing else: the CLI's `-m` target and its
    node's "TPU" read (plus the CPU asked for by the microbenchmark),
    the client proxy's `-c` import, a submitted job's import line."""
    cli = ('[sys.executable, "-m", "ray_tpu", *args],\n'
           '[sys.executable, "-m", "ray_tpu", "microbenchmark",\n'
           '"--duration", "0.3",\n'
           'assert nodes[0]["resources"]["TPU"] == 8.0\n'
           'greet("TPU")\n'
           'doc = "-m ray_tpu is the reference"\n')
    assert repoint(cli, FILE_REWRITES["test_state_cli"]) == (
        '[sys.executable, "-m", "ray_tpu_torch", *args],\n'
        '[sys.executable, "-m", "ray_tpu_torch", "microbenchmark", '
        '"--device", "cpu",\n'
        '"--duration", "0.3",\n'
        'assert nodes[0]["resources"]["GPU"] == 8.0\n'
        'greet("TPU")\n'
        'doc = "-m ray_tpu is the reference"\n')
    client = ('         "from ray_tpu.client.server import main; "\n'
              '    from ray_tpu.core.runtime import get_runtime_context\n'
              '         "from ray_tpu.client import connect; "\n')
    assert repoint(client, FILE_REWRITES["test_client"]) == (
        '         "from ray_tpu_torch.client.server import main; "\n'
        '    from ray_tpu_torch.core.runtime import get_runtime_context\n'
        '         "from ray_tpu.client import connect; "\n')
    dash = ('        "import ray_tpu as rt\\n"\n'
            '        "import ray_tpu.serve as serve\\n"\n'
            '        "rt.init(address=os.environ[\'RAYT_ADDRESS\'])\\n"\n')
    assert repoint(dash, FILE_REWRITES["test_dashboard"]) == (
        '        "import ray_tpu_torch as rt\\n"\n'
        '        "import ray_tpu.serve as serve\\n"\n'
        '        "rt.init(address=os.environ[\'RAYT_ADDRESS\'])\\n"\n')
    drain = "    import ray_tpu\n    import ray_tpu as rt\n"
    assert repoint(drain, FILE_REWRITES["test_drain"]) == (
        "    import ray_tpu_torch as ray_tpu\n"
        "    import ray_tpu_torch as rt\n")


def test_strings_that_start_the_reference_are_found():
    """The guard sees a string that would start the reference in another
    process, and lets a path or a word that merely names it pass."""
    src = ('subprocess.run([sys.executable, "-m", "ray_tpu", "status"])\n'
           'code = "from ray_tpu.client.server import main; main()"\n'
           "script = 'import ray_tpu as rt\\nrt.init()\\n'\n"
           'cmd = f"{python} -m ray_tpu.core.worker_main --x {n}"\n'
           'doc = "ray_tpu/_native/shm_store.cpp"\n'
           'name = "ray_tpu_torch"\n'
           'msg = "the ray_tpu reference"\n')
    found = strings_starting_the_reference(src)
    assert [line for line, _ in found] == [1, 2, 3, 4]


@pytest.mark.parametrize("name,unrewritten", [
    ("test_state_cli", "ray_tpu"),
    ("test_client", "from ray_tpu.client.server import main; ")])
def test_run_repointed_refuses_a_copy_that_starts_the_reference(
        name, unrewritten, monkeypatch, tmp_path):
    """Without its string rewrites the copy would start the reference's
    CLI or client proxy in a subprocess (the import watch sees only the
    pytest process): run_repointed refuses it before running anything,
    naming the line."""
    assert "ray_tpu_torch" in repointed_copy(name)
    monkeypatch.setitem(torch_repoint.FILE_REWRITES, name, ())
    with pytest.raises(AssertionError, match="starts the reference"):
        run_repointed(name, 1, tmp_path, timeout=10)
    assert not (tmp_path / "tests" / f"{name}.py").exists()
    hits = strings_starting_the_reference(
        repoint(open(f"{torch_repoint.ROOT}/tests/{name}.py").read()))
    assert unrewritten in [text for _, text in hits], hits


@pytest.mark.parametrize("name", sorted(FILES))
def test_reference_file_passes_on_the_port(name, tmp_path):
    run_repointed(name, FILES[name], tmp_path, timeout=170)
