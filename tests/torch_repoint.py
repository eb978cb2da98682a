"""Runs a reference test file of the JAX package against ray_tpu_torch.

``run_repointed`` copies one reference test file into a temporary directory
with exactly the rewrites listed in REWRITES (the package name in import
statements, ``num_tpus`` -> ``num_gpus``, the "TPU" resource -> "GPU" where
a resource dict or a resource read names it) plus the file's own in
FILE_REWRITES, and runs the copy under pytest in a subprocess beside a
conftest that imports no jax and keeps the reference conftest's per-test
time cap and its ``local_cluster`` fixture. The copy sits in a directory
named tests/ (with the helpers SUPPORT_FILES lists, re-pointed, beside
it), the repo's root is on the subprocess's PYTHONPATH, and tier-1's
``-m "not slow"`` selects its tests unless the caller names other
markers. A copy in which a string literal would still start the reference
in another process (``-m ray_tpu``, an import inside quotes) is refused
before it runs: the import hook sees only the pytest process. The tests
named in DESELECT for that file are deselected; each names why, the
ROADMAP.md item that brings it and the torch test that stands in for it.
It asserts that pytest exits 0, that every selected test of the file
passed, and that an import hook installed before any test saw no import
of jax or ray_tpu in that process. The reference files stay untouched.
"""

import ast
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tokenize
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
# test_dag_observability, test_drain, test_train_observability and
# test_chaos import the bare package name and call it (``import ray_tpu;
# ray_tpu.init(...)``): the port, under that name
BARE_NAME_REWRITES = (
    (r"^(\s*)import ray_tpu_torch$", r"\1import ray_tpu_torch as ray_tpu"),
)
# the RL files' own rewrite (and test_train_observability's, whose IMPALA
# learner emits a waterfall): every algorithm config asks for a learner on
# the CPU (the port's default leases it a GPU, as the reference's learners
# take the CPU when jax_platforms=cpu pins it)
RL_REWRITES = (
    (r"\b(PPO|IMPALA|APPO|DQN|SAC|MultiAgentPPO|BC|CQL)Config\(",
     r"\1Config(num_gpus_per_learner=0, "),
)
# test_tune names the train config module in an __import__ string, and
# every Tuner asks for trials on the CPU (the port's default leases each
# trial a GPU, as the reference's trials take the CPU when jax_platforms=cpu
# pins it); each Tuner call of the file has its run_config= on a line of
# its own
TUNE_REWRITES = (
    (r'"ray_tpu\.train\.config"', '"ray_tpu_torch.train.config"'),
    (r"^(\s*)run_config=", r'\1resources_per_trial={"CPU": 1}, run_config='),
)
# files that start the package from inside a string: the CLI run as
# `python -m ray_tpu` (and its node's "TPU" read), the client proxy
# spawned from a `-c` string, a submitted job's script
STATE_CLI_REWRITES = (
    (r'"-m", "ray_tpu"', '"-m", "ray_tpu_torch"'),
    (r'\["TPU"\]', '["GPU"]'),
    # the port's microbenchmark puts its device legs on the card unless
    # asked for the CPU
    (r'"microbenchmark",$', '"microbenchmark", "--device", "cpu",'),
)
CLIENT_REWRITES = (
    (r'"from ray_tpu\.client\.server import main; "',
     '"from ray_tpu_torch.client.server import main; "'),
)
DASHBOARD_REWRITES = (
    (r'"import ray_tpu as rt\\n"', r'"import ray_tpu_torch as rt\\n"'),
)
# test_scheduling_policy names the "TPU" resource as a key inside dicts
# that hold other keys first: every "TPU" key, the resource
RESOURCE_KEY_REWRITES = (
    (r'"TPU":', '"GPU":'),
)
# files that find the repo from their own path (its writer scripts, the
# tools dir): the repo's root, as the copy lives elsewhere
REPO_PATH_REWRITES = (
    (r"os\.path\.dirname\(os\.path\.dirname\(os\.path\.abspath\("
     r"__file__\)\)\)", repr(ROOT)),
)
# test_launcher runs the CLI as a module named in a string, its cluster
# YAML names the resource in flow style (``{CPU: 2, TPU: 4}``), and it
# reads the launcher's state file, which the port keeps under its own dir
LAUNCHER_REWRITES = (
    (r'"ray_tpu\.scripts\.cli"', '"ray_tpu_torch.scripts.cli"'),
    (r"\bTPU: (\d)", r"GPU: \1"),
    (r"~/\.rayt/clusters/", "~/.ray_tpu_torch/clusters/"),
)
# test_perf_gate: the port's microbenchmark puts its device legs on the
# card unless asked for the CPU, and the DAG-overhead child finds the
# package at this checkout's root (the file names a fixed path)
PERF_GATE_REWRITES = (
    (r"\brun_microbenchmarks\(duration=",
     'run_microbenchmarks(device="cpu", duration='),
    (r'(env\["PYTHONPATH"\] = )"[^"]*"', r"\1" + repr(ROOT)),
)
# test_serve_load: serve_bench's in-process engine legs run on the card
# unless asked for the CPU
SERVE_LOAD_REWRITES = (
    (r"\brun_(prefix_reuse|disagg)\(\)", r'run_\1(device="cpu")'),
)
FILE_REWRITES = {"test_rl": RL_REWRITES, "test_sac": RL_REWRITES,
                 "test_rl_multi_agent": RL_REWRITES,
                 "test_train": TRAIN_REWRITES,
                 "test_ingest_train": TRAIN_REWRITES,
                 "test_train_observability": TRAIN_REWRITES
                 + BARE_NAME_REWRITES + RL_REWRITES,
                 "test_dag_observability": BARE_NAME_REWRITES,
                 "test_drain": BARE_NAME_REWRITES,
                 "test_state_cli": STATE_CLI_REWRITES,
                 "test_client": CLIENT_REWRITES,
                 "test_dashboard": DASHBOARD_REWRITES,
                 "test_scheduling_policy": RESOURCE_KEY_REWRITES,
                 # {"CPU": 2.0, "TPU": 4.0}: the key after another
                 "test_autoscaler": RESOURCE_KEY_REWRITES,
                 "test_launcher": LAUNCHER_REWRITES,
                 "test_native_store_stress": REPO_PATH_REWRITES,
                 "test_chaos": BARE_NAME_REWRITES + RL_REWRITES,
                 "test_rl_offline": RL_REWRITES,
                 "test_tune": TRAIN_REWRITES + TUNE_REWRITES,
                 "test_perf_gate": PERF_GATE_REWRITES,
                 "test_serve_load": SERVE_LOAD_REWRITES}

# helper modules outside tests/ that a file imports from the repo: each is
# copied with REWRITES beside the copy (the file finds it from its own
# path: test_chaos puts ../tools on sys.path), to the same relative path,
# or, given as (source, destination), from the port's twin of the
# reference's tool to where the reference's tool sits
_ENVELOPE = "tools/envelope_bench.py"
SUPPORT_FILES = {"test_chaos": ("tools/chaos.py", _ENVELOPE),
                 "test_shuffle_envelope": (_ENVELOPE,),
                 "test_scale_envelope": (_ENVELOPE,),
                 "test_serve_load": (("ray_tpu_torch/tools/serve_bench.py",
                                      "tools/serve_bench.py"),)}

# a string literal that would start the reference package in another
# process: a module name on its own (what `-m` takes) or an import
# statement inside the string
_STARTS_REFERENCE = re.compile(
    r"^ray_tpu(\.\w+)*$|\b(import|from)\s+ray_tpu\b|-m\s+ray_tpu\b")


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
_RL_TWINS = "tests/test_torch_rl.py::"
DESELECT = {
    "test_train": {
        "test_save_load_pytree": Deselect(
            _JAX_BODY + " (jnp leaves)", None,
            _TWINS + "test_save_load_pytree_torch"),
        "test_jax_trainer_ddp_mesh": Deselect(
            _JAX_BODY + " (an optax MLP step over a mesh)", None,
            _TWINS + "test_torch_trainer_ddp_mesh"),
        "test_lora_finetune": Deselect(
            _JAX_BODY + " (the JAX recipe on a dp x fsdp x tensor mesh)",
            None, _TWINS + "test_lora_finetune_on_a_mesh_torch"),
        "test_lora_resume_restores_exact_trajectory": Deselect(
            _JAX_BODY + " (jax.random batches in its batch_fn)", None,
            _TWINS + "test_lora_resume_restores_exact_trajectory_torch"),
        "test_elastic_scaling_remesh_on_node_death": Deselect(
            _JAX_BODY + " (a jitted sum over each group's mesh)", None,
            "tests/test_torch_train_elastic.py::"
            "test_elastic_scaling_on_node_death_torch"),
    },
    "test_train_observability": {
        "test_recorder_wrap_jit_compile_and_retrace": Deselect(
            _JAX_BODY + " (jnp arrays through wrap_jit)", None,
            _TWINS + "test_recorder_wrap_jit_torch_tensors"),
    },
    "test_util": {
        "test_site_import_modes": Deselect(
            "the port drops the PJRT site-import modes of _internal/spawn "
            "(no PJRT plugin to defer)", None,
            "tests/test_torch_surfaces.py::"
            "test_spawn_has_no_site_import_modes"),
    },
    "test_autoscaler": {
        f"test_gcp_provider_{test}": Deselect(
            "the reference's provider requests TPU VMs (queuedResources); "
            "the port's requests A3 GPU VMs from Compute Engine", None,
            f"tests/test_torch_autoscaler.py::test_gcp_gpu_provider_{test}")
        for test in ("request_shapes", "paginates_and_encodes_tokens",
                     "midlisting_failure_aborts_observation",
                     "reconciler_survives_listing_outage")
    },
    "test_rl": {
        "test_vtrace_on_policy_reduces_to_returns": Deselect(
            _JAX_BODY + " (jnp inputs to vtrace)", None,
            _RL_TWINS + "test_vtrace_on_policy_reduces_to_returns_torch"),
        "test_vtrace_done_cuts_bootstrap": Deselect(
            _JAX_BODY + " (jnp inputs to vtrace)", None,
            _RL_TWINS + "test_vtrace_done_cuts_bootstrap_torch"),
        "test_impala_learns_cartpole": Deselect(
            _JAX_BODY + " (its pack-coverage tail packs jnp weights)",
            None, _RL_TWINS + "test_impala_learns_cartpole_torch"),
        "test_cnn_module_forward_and_grad": Deselect(
            _JAX_BODY + " (jax.random keys, an optax round trip)", None,
            _RL_TWINS + "test_cnn_module_forward_and_grad_torch"),
    },
    "test_sac": {
        "test_sample_squashed_logp_matches_density": Deselect(
            _JAX_BODY + " (jnp inputs, a jax.random key)", None,
            _RL_TWINS + "test_sample_squashed_logp_matches_density_torch"),
    },
    "test_rl_multi_agent": {
        "test_policy_mapping_groups_agents": Deselect(
            _JAX_BODY + " (jax.random init of the policies' params)", None,
            _RL_TWINS + "test_policy_mapping_groups_agents_torch"),
    },
    "test_dag_dcn": {
        "test_mixed_kind_graph_with_allreduce_fast_path": Deselect(
            _JAX_BODY + " (jnp device-edge payloads)", None,
            _DAG_TWINS
            + "test_mixed_kind_graph_with_allreduce_fast_path_torch"),
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
            _JAX_BODY + " (an array sharded over a 2-device mesh)", None,
            "tests/test_torch_dag_mesh.py::"
            "test_sharded_tensor_device_transfer_torch"),
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


def strings_starting_the_reference(src: str) -> list[tuple[int, str]]:
    """(line, text) of each string literal in `src` that would start the
    reference package: ``"-m", "ray_tpu"``, ``"from ray_tpu.x import y"``,
    ``"import ray_tpu"`` (f-string parts included)."""
    middle = getattr(tokenize, "FSTRING_MIDDLE", None)  # 3.12 on
    found = []
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.STRING:
            try:
                text = ast.literal_eval(tok.string)
            except (SyntaxError, ValueError):  # an f-string before 3.12
                text = tok.string
        elif tok.type == middle:
            text = tok.string
        else:
            continue
        if isinstance(text, bytes):
            text = text.decode("latin-1")
        if _STARTS_REFERENCE.search(text.strip()):
            found.append((tok.start[0], text))
    return found


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


def repointed_copy(name: str) -> str:
    """tests/<name>.py with its rewrites, after checking that no string
    literal left in it starts the reference package in a subprocess."""
    with open(os.path.join(ROOT, "tests", f"{name}.py")) as f:
        copy = repoint(f.read(), FILE_REWRITES.get(name, ()))
    assert "ray_tpu_torch" in copy
    starts = strings_starting_the_reference(copy)
    assert not starts, (
        f"{name}.py still starts the reference from a string: {starts}")
    return copy


def run_repointed(name: str, n_tests: int, tmp_path, timeout: float,
                  split: tuple = (), only: str | None = None,
                  markers: str = "not slow") -> None:
    """Run tests/<name>.py re-pointed at the port in a pytest subprocess
    (at most `timeout` s), its DESELECT entries and the tests in `split`
    (each run as an entry of its own) left out, or only the test `only`,
    selecting the tests that `markers` matches (tier-1's "not slow" by
    default), and assert that all `n_tests` selected tests passed with no
    import of jax or ray_tpu."""
    copy = repointed_copy(name)
    deselect = [f"--deselect={name}.py::{test}"
                for test in (*check_deselects(name), *split)]
    # the copy sits in a directory named tests/, as the reference file
    # does (a callsite the runtime records reads "tests/<file>:<line>")
    work = tmp_path / "tests"
    work.mkdir(exist_ok=True)
    target = str(work) if only is None else f"{name}.py::{only}"
    (work / f"{name}.py").write_text(copy)
    for entry in SUPPORT_FILES.get(name, ()):
        src, dst = (entry, entry) if isinstance(entry, str) else entry
        with open(os.path.join(ROOT, src)) as f:
            support = repoint(f.read())
        assert not strings_starting_the_reference(support), src
        (tmp_path / dst).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / dst).write_text(support)
    (work / "conftest.py").write_text(CONFTEST.format(root=ROOT))
    report, xml = work / "imports.json", work / "junit.xml"
    # the repo's root on the path, as where the reference runs from it: a
    # `python -c` child the test starts finds the port
    # torch's intra-op threads capped at one in the pytest process and the
    # cluster it starts: a CPU learner's small MLP updates (DQN's, in the
    # driver) otherwise spin a thread per core, ~10x the CPU for the same
    # work, and under a loaded xdist run that can pass the per-test alarm
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "RAYT_REPOINT_REPORT": str(report)}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", f"--junitxml={xml}",
         f"--rootdir={work}", f"--confcutdir={work}",
         "-m", markers, *deselect, target],
        cwd=work, env=env, capture_output=True, text=True,
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
