"""Runs a reference test file of the JAX package against ray_tpu_torch.

``run_repointed`` copies one reference test file into a temporary directory
with exactly the rewrites listed in REWRITES (the package name in import
statements, ``num_tpus`` -> ``num_gpus``, the "TPU" resource -> "GPU" where
a resource dict or a resource read names it) plus the file's own in
FILE_REWRITES, and runs the copy under pytest in a subprocess beside a
conftest that imports no jax and keeps the reference conftest's per-test
time cap and its ``local_cluster`` fixture. The tests named in DESELECT for
that file are deselected; each names why, the ROADMAP.md item that brings
it and the torch test that stands in for it. It asserts that pytest exits
0, that every selected test of the file passed, and that an import hook
installed before any test saw no import of jax or ray_tpu in that process.
The reference files stay untouched.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (pattern, replacement), applied line by line in this order
REWRITES = (
    (r"^(\s*)import ray_tpu\b", r"\1import ray_tpu_torch"),
    (r"^(\s*)from ray_tpu\b", r"\1from ray_tpu_torch"),
    (r"\bnum_tpus\b", "num_gpus"),
    # the "TPU" resource, where a resource dict or a resource read names
    # it; a "TPU" that is data (a greeting's argument) stays as it is
    (r'\{"TPU":', '{"GPU":'),
    (r'\.get\("TPU"\)', '.get("GPU")'),
)

# the train files' own rewrites: the trainer's name, and the CPU asked for
# where a ScalingConfig is built (the port's default leases a GPU, as the
# reference's loops ask for the CPU with jax_platforms=cpu)
TRAIN_REWRITES = (
    (r"\bJaxTrainer\b", "TorchTrainer"),
    (r"\bScalingConfig\(", "ScalingConfig(use_gpu=False, "),
)
# test_dag_observability imports the bare package name and calls it
# (``import ray_tpu; ray_tpu.init(...)``): the port, under that name
DAG_OBS_REWRITES = (
    (r"^(\s*)import ray_tpu_torch$", r"\1import ray_tpu_torch as ray_tpu"),
)
FILE_REWRITES = {"test_train": TRAIN_REWRITES,
                 "test_ingest_train": TRAIN_REWRITES,
                 "test_train_observability": TRAIN_REWRITES,
                 "test_dag_observability": DAG_OBS_REWRITES}


@dataclasses.dataclass(frozen=True)
class Deselect:
    """A reference test left out of a re-pointed run: why, the ROADMAP.md
    item that brings it (None when a twin covers all of it), and its twin,
    ``"tests/<file>.py::<test>"`` (None when only the item covers it)."""
    reason: str
    item: str | None
    twin: str | None


_JAX_BODY = "its body runs jax"
_TWINS = "tests/test_torch_train.py::"
_DAG_TWINS = "tests/test_torch_dag_device.py::"
DESELECT = {
    "test_train": {
        "test_save_load_pytree": Deselect(
            _JAX_BODY + " (jnp leaves)", None,
            _TWINS + "test_save_load_pytree_torch"),
        "test_jax_trainer_ddp_mesh": Deselect(
            _JAX_BODY + " (an optax MLP step over a mesh)", "6",
            _TWINS + "test_torch_trainer_mlp_on_get_device"),
        "test_lora_finetune": Deselect(
            _JAX_BODY + " (the JAX recipe on a dp x fsdp x tensor mesh)",
            "6", _TWINS + "test_lora_finetune_torch"),
        "test_lora_resume_restores_exact_trajectory": Deselect(
            _JAX_BODY + " (jax.random batches in its batch_fn)", None,
            _TWINS + "test_lora_resume_restores_exact_trajectory_torch"),
        "test_elastic_scaling_remesh_on_node_death": Deselect(
            _JAX_BODY + " (a jitted sum over each group's mesh)", "6",
            "tests/test_torch_train_elastic.py::"
            "test_elastic_scaling_on_node_death_torch"),
    },
    "test_train_observability": {
        "test_recorder_wrap_jit_compile_and_retrace": Deselect(
            _JAX_BODY + " (jnp arrays through wrap_jit)", None,
            _TWINS + "test_recorder_wrap_jit_torch_tensors"),
        "test_e2e_run_waterfall_compile_memory_and_cli": Deselect(
            "reads state_api and the rayt CLI", "2b", None),
        "test_pause_ingest_stall_drill": Deselect(
            "reads state_api", "2b", None),
        "test_rl_learner_emits_step_waterfall": Deselect(
            "drives the RL learner (ray_tpu.rl)", "7", None),
    },
    "test_dag_dcn": {
        "test_mixed_kind_graph_with_allreduce_fast_path": Deselect(
            _JAX_BODY + " (jnp device-edge payloads)", None,
            _DAG_TWINS
            + "test_mixed_kind_graph_with_allreduce_fast_path_torch"),
    },
    "test_dag_observability": {
        "test_dag_record_lifecycle": Deselect(
            "reads state_api", "2b", None),
        "test_stall_watchdog_e2e_dead_runner": Deselect(
            "reads state_api and the rayt CLI", "2b", None),
        "test_dag_state_disabled_no_records": Deselect(
            "reads state_api", "2b", None),
    },
    "test_device_objects": {
        "test_put_device_get_same_process_zero_copy": Deselect(
            _JAX_BODY + " (a jnp array)", None,
            _DAG_TWINS + "test_put_device_get_same_process_zero_copy_torch"),
        "test_device_ref_as_task_arg": Deselect(
            _JAX_BODY + " (a jnp array, a jax.Array check in the task)",
            None, _DAG_TWINS + "test_device_ref_as_task_arg_torch"),
        "test_device_return_stays_in_actor": Deselect(
            _JAX_BODY + " (the actor returns a jnp array)", None,
            _DAG_TWINS + "test_device_return_stays_in_actor_torch"),
        "test_compiled_dag_device_edge": Deselect(
            _JAX_BODY + " (the stage returns a jnp array)", None,
            _DAG_TWINS + "test_compiled_dag_device_edge_torch"),
        "test_device_object_free_releases_holder_memory": Deselect(
            _JAX_BODY + " (the actor returns a jnp array)", None,
            _DAG_TWINS
            + "test_device_object_free_releases_holder_memory_torch"),
        "test_sharded_array_device_transfer": Deselect(
            _JAX_BODY + " (an array sharded over a 2-device mesh)", "6",
            None),
        "test_device_object_lost_when_holder_dies": Deselect(
            _JAX_BODY + " (the actor returns a jnp array)", None,
            _DAG_TWINS + "test_device_object_lost_when_holder_dies_torch"),
    },
}

CONFTEST = '''
import os
import signal
import sys

sys.path.insert(0, {root!r})

# record every import of jax or ray_tpu, however it is reached
_seen = []


class _Watch:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ray_tpu"):
            _seen.append(name)
        return None


sys.meta_path.insert(0, _Watch())

import pytest  # noqa: E402

# the reference conftest's per-test wall-clock cap
TEST_TIMEOUT_S = int(os.environ.get("RAYT_TEST_TIMEOUT_S", "180"))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    def _on_timeout(signum, frame):
        raise TimeoutError(
            f"test exceeded {{TEST_TIMEOUT_S}}s (RAYT_TEST_TIMEOUT_S)")

    old = signal.signal(signal.SIGALRM, _on_timeout)
    signal.alarm(TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def local_cluster():
    """A started single-node cluster, shut down after the test."""
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4, resources={{"GPU": 8}})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def pytest_sessionfinish(session, exitstatus):
    seen = sorted(set(_seen) | {{m for m in sys.modules
                               if m.split(".")[0] in
                               ("jax", "jaxlib", "ray_tpu")}})
    with open(os.environ["RAYT_REPOINT_REPORT"], "w") as f:
        f.write(__import__("json").dumps(seen))
'''


def repoint(src: str, extra: tuple = ()) -> str:
    lines = []
    for line in src.split("\n"):
        for pattern, repl in REWRITES + tuple(extra):
            line = re.sub(pattern, repl, line)
        lines.append(line)
    return "\n".join(lines)


def _defines(path: str, test: str) -> bool:
    with open(path) as f:
        return re.search(rf"^def {test}\(", f.read(), re.M) is not None


def check_deselects(name: str) -> dict:
    """DESELECT's entries for tests/<name>.py, after checking that each
    names a test the file defines, gives a reason, and has a ROADMAP item
    or a twin that exists."""
    entries = DESELECT.get(name, {})
    for test, why in entries.items():
        assert _defines(os.path.join(ROOT, "tests", f"{name}.py"), test), \
            f"{name}.py has no test {test}"
        assert why.reason and (why.item or why.twin), (test, why)
        if why.twin:
            path, twin = why.twin.split("::")
            assert _defines(os.path.join(ROOT, path), twin), why.twin
    return entries


def run_repointed(name: str, n_tests: int, tmp_path, timeout: float,
                  split: tuple = (), only: str | None = None) -> None:
    """Run tests/<name>.py re-pointed at the port in a pytest subprocess
    (at most `timeout` s), its DESELECT entries and the tests in `split`
    (each run as an entry of its own) left out, or only the test `only`,
    and assert that all `n_tests` selected tests passed with no import of
    jax or ray_tpu."""
    with open(os.path.join(ROOT, "tests", f"{name}.py")) as f:
        copy = repoint(f.read(), FILE_REWRITES.get(name, ()))
    assert "ray_tpu_torch" in copy
    deselect = [f"--deselect={name}.py::{test}"
                for test in (*check_deselects(name), *split)]
    target = str(tmp_path) if only is None else f"{name}.py::{only}"
    (tmp_path / f"{name}.py").write_text(copy)
    (tmp_path / "conftest.py").write_text(CONFTEST.format(root=ROOT))
    report, xml = tmp_path / "imports.json", tmp_path / "junit.xml"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["RAYT_REPOINT_REPORT"] = str(report)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", f"--junitxml={xml}",
         f"--rootdir={tmp_path}", f"--confcutdir={tmp_path}",
         *deselect, target],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=timeout)
    tail = (proc.stdout + proc.stderr)[-4000:]
    assert proc.returncode == 0, tail
    suite = ET.parse(xml).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    counts = {k: int(suite.get(k)) for k in
              ("tests", "failures", "errors", "skipped")}
    assert counts == {"tests": n_tests, "failures": 0, "errors": 0,
                      "skipped": 0}, tail
    assert json.loads(report.read_text()) == [], "jax or ray_tpu imported"
