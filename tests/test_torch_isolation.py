"""The port stands alone: it imports no jax, optax or ray_tpu module, its
compute entry points run on the card unless told otherwise, its runtime
(host code, as the reference's runs without a TPU) runs without a card, and
its kernel wrappers never fall back to a plain version on a CUDA tensor."""

import ast
import inspect
import json
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.ops.cuda import flash_attention as tflash

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ray_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                               "ray_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "ray_tpu"))
print(len(names), ",".join(bad))
"""


def test_package_imports_no_jax_optax_or_ray_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    n_modules, bad = int(out[0]), out[1:]
    assert n_modules >= 128
    assert bad == [], f"ray_tpu_torch pulled in {bad}"


def test_chip_smoke_imports_no_jax_optax_or_ray_tpu():
    """Every import statement of chip_smoke.py, at any depth (its imports
    sit inside the phase functions), stays off jax, optax and ray_tpu."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "ray_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "optax", "ray_tpu"}, roots


def _entry_points():
    from ray_tpu_torch._internal import perf
    from ray_tpu_torch.models import llama, lora, mlp
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step
    from ray_tpu_torch.serve.llm import (DecodeLlamaService, LLMEngine,
                                         MultiplexedLoraService, PrefillWorker)

    cfg = llama.config_for("debug")
    return {
        "init_params": lambda: llama.init_params(cfg),
        "init_kv_cache": lambda: llama.init_kv_cache(cfg, 1),
        "LLMEngine": lambda: LLMEngine("debug"),
        "init_lora_params": lambda: lora.init_lora_params(
            cfg, lora.LoraConfig()),
        "MultiplexedLoraService": lambda: MultiplexedLoraService("debug"),
        "PrefillWorker": lambda: PrefillWorker("debug"),
        "DecodeLlamaService": lambda: DecodeLlamaService(None, "debug"),
        "init_moe_params": lambda: moe.init_moe_params(8, 16,
                                                       moe.MoEConfig()),
        "mlp_init": lambda: mlp.mlp_init(mlp.MLPConfig()),
        "params_from_numpy": lambda: params_from_numpy({}),
        "build_train_step": lambda: build_train_step(
            lambda p, b: (None, {}), adamw(1e-3), {}),
        "resolve_device": lambda: ray_tpu_torch.resolve_device(None),
        "run_microbenchmarks": lambda: perf.run_microbenchmarks(0.01),
        **_rl_entry_points(),
    }


def _rl_entry_points():
    """The RL learners' entry points: each leases the card by default."""
    import cloudpickle

    from ray_tpu_torch.rl import dqn, impala, learner, module, sac

    mlp = module.MLPModuleConfig(4, 2)
    return {
        "rl_init_params": lambda: module.init_params(mlp, 0),
        "rl_init_continuous_params": lambda: module.init_continuous_params(
            module.ContinuousModuleConfig(3, 1), 0),
        "TorchLearner": lambda: learner.TorchLearner(
            cloudpickle.dumps(mlp),
            cloudpickle.dumps(learner.PPOLearnerConfig())),
        "IMPALALearner": lambda: impala.IMPALALearner(
            cloudpickle.dumps(mlp), cloudpickle.dumps(impala.IMPALAConfig())),
        "DQN": lambda: dqn.DQNConfig().build(),
        "SAC": lambda: sac.SACConfig().build(),
        "Tuner": _default_tuner_fit,
    }


def _default_tuner_fit():
    """Tuner with neither a ScalingConfig nor resources_per_trial, on a
    cluster of this host: each trial leases a GPU."""
    import tempfile

    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import RunConfig

    ray_tpu_torch.init(num_cpus=1)
    try:
        with tempfile.TemporaryDirectory() as storage:
            tune.Tuner(lambda config: None, run_config=RunConfig(
                name="default", storage_path=storage)).fit()
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("name", ["init_params", "params_from_numpy",
                                  "build_train_step", "resolve_device",
                                  "init_kv_cache", "LLMEngine",
                                  "init_lora_params",
                                  "MultiplexedLoraService",
                                  "PrefillWorker", "DecodeLlamaService",
                                  "init_moe_params", "mlp_init",
                                  "run_microbenchmarks", "rl_init_params",
                                  "rl_init_continuous_params",
                                  "TorchLearner", "IMPALALearner", "DQN",
                                  "SAC", "Tuner"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


_RUNTIME = """
import sys
import ray_tpu_torch as rt
rt.init(num_cpus=1)

@rt.remote
def f(x):
    return x + 1

print(rt.get(f.remote(1), timeout=60), "torch" in sys.modules)
rt.shutdown()
"""


def test_runtime_entry_points_run_without_a_card():
    """rt.init and @rt.remote are host code: they run on a host without a
    card, and neither the driver's init nor a CPU task imports torch."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-c", _RUNTIME], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["2", "False"]


def test_kernel_wrappers_have_no_fallback():
    src = inspect.getsource(tflash)
    assert "except" not in src, "flash wrappers must not catch and fall back"
    for fn in (tflash.flash_forward_cuda, tflash.flash_bwd_dq_cuda,
               tflash.flash_bwd_dkv_cuda):
        assert "_plain(" not in inspect.getsource(fn)


def test_engine_has_no_cpu_fallback():
    """No exception handler in the decode path, the engine, LoRA, the MoE
    FFN or the multiplex LRU carries on elsewhere: none names a device or
    calls a plain version, and the step's failure path (reseed, then raise)
    has no device in it."""
    from ray_tpu_torch.models import llama, lora
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.serve import llm, multiplex

    for module in (llm, llama, lora, moe, multiplex):
        tree = ast.parse(inspect.getsource(module))
        handlers = [n for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        for handler in handlers:
            body = ast.unparse(handler).lower()
            for word in ("cpu", "device", "_plain("):
                assert word not in body, (module.__name__, body)
    assert "cpu" not in inspect.getsource(llm.LLMEngine._step).lower()


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="must be on"):
        tflash.flash_forward_cuda(q, q, q)


def test_every_module_is_walked():
    names = {m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                                   "ray_tpu_torch.")}
    assert {"ray_tpu_torch.ops.cuda.flash_attention",
            "ray_tpu_torch.models.llama", "ray_tpu_torch.parallel.spmd",
            "ray_tpu_torch.models.convert", "ray_tpu_torch.serve.llm",
            "ray_tpu_torch.serve.llm_tp",
            "ray_tpu_torch.serve.request_context",
            "ray_tpu_torch.serve.handle", "ray_tpu_torch.serve.deployment",
            "ray_tpu_torch.serve.schema", "ray_tpu_torch.serve.admission",
            "ray_tpu_torch.serve.replica", "ray_tpu_torch.serve.controller",
            "ray_tpu_torch.serve.proxy", "ray_tpu_torch.serve.grpc_proxy",
            "ray_tpu_torch.models.lora",
            "ray_tpu_torch.models.mlp", "ray_tpu_torch.ops.moe",
            "ray_tpu_torch.serve.multiplex", "ray_tpu_torch.api",
            "ray_tpu_torch.cluster_utils", "ray_tpu_torch._native",
            "ray_tpu_torch._internal.accelerators",
            "ray_tpu_torch._internal.rpc", "ray_tpu_torch.core.gcs",
            "ray_tpu_torch.core.node_manager",
            "ray_tpu_torch.core.core_worker",
            "ray_tpu_torch.core.device_objects",
            "ray_tpu_torch.core.worker_main",
            "ray_tpu_torch.util.builtin_metrics",
            "ray_tpu_torch.experimental.internal_kv",
            "ray_tpu_torch.util.collective.collective",
            "ray_tpu_torch.util.collective.store",
            "ray_tpu_torch.data.llm_corpus",
            "ray_tpu_torch.train.checkpoint", "ray_tpu_torch.train.config",
            "ray_tpu_torch.train.controller", "ray_tpu_torch.train.ingest",
            "ray_tpu_torch.train.recipes", "ray_tpu_torch.train.session",
            "ray_tpu_torch.train.telemetry", "ray_tpu_torch.train.trainer",
            "ray_tpu_torch.train.worker_group", "ray_tpu_torch.dag",
            "ray_tpu_torch.dag.node", "ray_tpu_torch.dag.channel",
            "ray_tpu_torch.dag.device_channel",
            "ray_tpu_torch.dag.dcn_channel", "ray_tpu_torch.dag.collective",
            "ray_tpu_torch.dag.compiled", "ray_tpu_torch.dag.channel_exec",
            "ray_tpu_torch.dag.recovery",
            "ray_tpu_torch._internal.perf", "ray_tpu_torch.rl",
            "ray_tpu_torch.rl.actor_manager", "ray_tpu_torch.rl.connectors",
            "ray_tpu_torch.rl.dqn", "ray_tpu_torch.rl.env",
            "ray_tpu_torch.rl.env_runner", "ray_tpu_torch.rl.impala",
            "ray_tpu_torch.rl.learner", "ray_tpu_torch.rl.module",
            "ray_tpu_torch.rl.module_config",
            "ray_tpu_torch.rl.multi_agent", "ray_tpu_torch.rl.ppo",
            "ray_tpu_torch.rl.replay", "ray_tpu_torch.rl.sac",
            "ray_tpu_torch.rl.vtrace", "ray_tpu_torch.state_api",
            "ray_tpu_torch.__main__", "ray_tpu_torch.scripts",
            "ray_tpu_torch.scripts.cli", "ray_tpu_torch.dashboard",
            "ray_tpu_torch.dashboard.head", "ray_tpu_torch.client",
            "ray_tpu_torch.client.server",
            "ray_tpu_torch.util.multiprocessing",
            "ray_tpu_torch.util.joblib_backend"} <= names
    assert {f"ray_tpu_torch.{m}" for m in _OPS_MODULES} <= names
    assert {f"ray_tpu_torch.data.{m}" for m in _DATA_MODULES} <= names
    assert {f"ray_tpu_torch.tune.{m}" for m in _TUNE_MODULES} <= names
    assert "ray_tpu_torch.rl.offline" in names


# the twins of the reference's tools (ray_tpu_torch/tools/)
_TOOLS = sorted(f[:-3] for f in os.listdir(
    os.path.join(ROOT, "ray_tpu_torch", "tools")) if f.endswith(".py"))
# the JAX package's records, which its tools write; a twin writes only the
# path its caller names
_RECORDS = ("SERVE_BENCH.json", "RL_BENCH.json", "LORA_BENCH.json",
            "MICROBENCH.json", "ENVELOPE.json", "TPU_BENCH_CACHE",
            "BENCH_r", "MULTICHIP_r")


@pytest.mark.parametrize("name", _TOOLS)
def test_tools_import_no_jax_and_write_no_reference_record(name):
    """Every import statement of a tool, at any depth, stays off jax, optax
    and ray_tpu, and no tool names a record of the reference's."""
    with open(os.path.join(ROOT, "ray_tpu_torch", "tools",
                           f"{name}.py")) as f:
        src = f.read()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "optax", "ray_tpu"}, roots
    assert not [r for r in _RECORDS if r in src], name


def test_every_tool_is_walked():
    names = {m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                                   "ray_tpu_torch.")}
    assert {"bench", "lora_bench", "profile_step", "mfu_sweep",
            "mfu_decompose", "serve_bench", "rl_ppo_bench",
            "rl_image_bench", "rl_scale_bench"} <= set(_TOOLS)
    assert {f"ray_tpu_torch.tools.{t}" for t in _TOOLS if t != "__init__"} \
        <= names


# the cluster-operations layer: the autoscaler, its providers, the
# launcher and durable workflows
_OPS_MODULES = ("autoscaler", "autoscaler.autoscaler", "autoscaler.gcp",
                "autoscaler.instance_manager", "autoscaler.node_provider",
                "workflow", "workflow.api", "scripts.launcher")
_OPS_IMPORT = f"""
import importlib, sys
for m in {_OPS_MODULES!r}:
    importlib.import_module("ray_tpu_torch." + m)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "optax",
                                    "ray_tpu", "yaml")))
"""


def test_autoscaler_workflow_and_launcher_import_no_jax_and_no_torch():
    """The autoscaler (with both providers), the workflow executor and the
    launcher are host code: they import neither jax nor ray_tpu, nor
    torch, nor PyYAML (a YAML config imports it inside the call; the
    machine with the card has none)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _OPS_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    assert out == "[]"


_DATA_MODULES = ("aggregate", "block", "dataset", "datasink", "datasource",
                 "exchange", "executor", "grouped", "llm_corpus",
                 "partitioning", "plan", "streaming_executor")
_TUNE_MODULES = ("controller", "result_grid", "schedulers", "search", "tpe",
                 "trial", "tuner")
_DATA_TUNE_IMPORT = f"""
import importlib, sys
import ray_tpu_torch.data, ray_tpu_torch.tune, ray_tpu_torch.rl.offline
for m in {_DATA_MODULES!r}:
    importlib.import_module("ray_tpu_torch.data." + m)
for m in {_TUNE_MODULES!r}:
    importlib.import_module("ray_tpu_torch.tune." + m)
from ray_tpu_torch.rl import BCConfig, CQLConfig
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "optax",
                                    "ray_tpu", "pyarrow", "pandas")))
"""


def test_data_tune_and_offline_rl_import_no_jax_and_no_torch():
    """ray_tpu_torch.data, .tune and .rl.offline (every module) import
    neither jax nor ray_tpu; none imports torch (the offline learners
    import it in their bodies), nor pyarrow or pandas (the machine with
    the card has neither: only the Arrow, parquet, csv and pandas paths
    import them)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _DATA_TUNE_IMPORT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    assert out == "[]"


_RL_TORCH_FREE = """
import sys
import ray_tpu_torch.rl.impala, ray_tpu_torch.rl.replay
from ray_tpu_torch.rl import AggregatorActor, IMPALAConfig, ReplayBuffer
print("torch" in sys.modules)
"""


def test_rl_aggregator_and_replay_buffer_import_no_torch():
    """IMPALA's aggregator and the replay buffer are numpy actors: their
    processes boot without torch (rl/__init__ loads submodules lazily and
    the module configs live in the torch-free module_config)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RL_TORCH_FREE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["False"]


def test_rl_runners_and_aggregators_name_no_cuda_path():
    """The sampling actors and the aggregator never place anything on the
    card: the only CUDA their sources name is the probe that reports that
    the process never initialised it."""
    from ray_tpu_torch.rl import dqn, env_runner, impala, multi_agent, sac

    for obj in (env_runner.EnvRunner, dqn.DQNRunner, sac.SACRunner,
                multi_agent.MultiAgentEnvRunner, impala.AggregatorActor,
                env_runner.runner_torch):
        tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.ClassDef, ast.FunctionDef))
                and isinstance(n.body[0], ast.Expr)}
        probes = {id(n.value) for n in ast.walk(tree)
                  if isinstance(n, ast.Attribute)
                  and n.attr == "is_initialized"}
        for n in ast.walk(tree):
            if isinstance(n, ast.Attribute) and n.attr == "cuda":
                assert id(n) in probes, (obj.__name__, ast.unparse(n))
            if isinstance(n, ast.Constant) and id(n) not in docs:
                assert "cuda" not in str(n.value).lower(), obj.__name__


_TRAIN_IMPORT = """
import sys
import ray_tpu_torch.train
import ray_tpu_torch.util.collective
import ray_tpu_torch.data.llm_corpus
from ray_tpu_torch.train import (checkpoint, config, controller, ingest,
                                 recipes, session, telemetry, trainer,
                                 worker_group)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "optax",
                                    "ray_tpu")))
"""


def test_train_collective_and_corpus_import_no_jax_and_no_torch():
    """ray_tpu_torch.train (every module), util.collective and
    data.llm_corpus import neither jax nor ray_tpu, and none of them
    imports torch: train workers boot without it, and a numpy-only train
    loop never pays for it (the recipes import torch in their bodies)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _TRAIN_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


_DAG_IMPORT = """
import sys
import ray_tpu_torch.dag
import ray_tpu_torch._internal.perf
from ray_tpu_torch.dag import (channel, channel_exec, collective, compiled,
                               dcn_channel, device_channel, node, recovery)
from ray_tpu_torch.dag.collective import client_fingerprint
client_fingerprint()
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "optax",
                                    "ray_tpu")))
"""


def test_dag_plane_imports_no_torch():
    """ray_tpu_torch.dag (every module) and _internal.perf import neither
    torch nor jax nor ray_tpu, and reading a process's device view for a
    DAG collective does not import torch: a worker running a DAG loop over
    host values boots and ticks without it (tensor edges import it when a
    tensor is rebuilt)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _DAG_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


def test_disagg_serving_lives_in_serve_llm():
    """The disaggregated serving classes sit in serve.llm with the engine
    (the one serve module that imports torch), under the reference's
    names, and the pools' sizes read the reference's variables."""
    from ray_tpu_torch.serve import llm

    for name in ("PrefillWorker", "DecodeLlamaService", "disagg_llm_app",
                 "_pool_size", "_edge_kind"):
        assert callable(getattr(llm, name)), name
    assert (llm.PREFILL_REPLICAS_ENV, llm.DECODE_REPLICAS_ENV) == (
        "RAYT_SERVE_PREFILL_REPLICAS", "RAYT_SERVE_DECODE_REPLICAS")


_SERVE_IMPORT = """
import sys
import ray_tpu_torch.serve
from ray_tpu_torch.serve import (admission, controller, deployment,
                                 grpc_proxy, handle, multiplex, proxy,
                                 replica, request_context, schema)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "optax",
                                    "ray_tpu")))
"""


def test_serve_plane_imports_no_torch():
    """The Serve plane's modules (all but serve.llm) import neither torch
    nor jax: the controller, proxy and replica workers boot without
    them."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SERVE_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


_SURFACES_IMPORT = """
import sys
import ray_tpu_torch.state_api
import ray_tpu_torch.scripts.cli
import ray_tpu_torch.dashboard
import ray_tpu_torch.dashboard.head
import ray_tpu_torch.client
import ray_tpu_torch.client.server
import ray_tpu_torch.util.multiprocessing
import ray_tpu_torch.util.joblib_backend
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "jaxlib", "optax",
                                    "ray_tpu")))
"""


def test_surfaces_import_no_torch():
    """state_api, the CLI, the dashboard, the client and the rest of util
    import neither torch nor jax: `status` on a CPU box builds no CUDA
    context, and a thin client needs neither."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SURFACES_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


_STATUS = """
import subprocess, sys
import ray_tpu_torch as rt
from ray_tpu_torch.core.runtime import get_runtime_context
rt.init(num_cpus=1)
gcs = get_runtime_context().gcs_address
try:
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ray_tpu_torch", "status",
         "--address", f"{gcs.host}:{gcs.port}"],
        capture_output=True, text=True, timeout=60, check=True)
finally:
    rt.shutdown()
print(proc.stdout)
imported = [ln.rsplit("|", 1)[1].strip() for ln in proc.stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln]
print("IMPORTED", "ray_tpu_torch.scripts.cli" in imported,
      sorted({m.split(".")[0] for m in imported}
             & {"torch", "jax", "ray_tpu"}))
"""


def test_cli_status_imports_no_torch():
    """`python -m ray_tpu_torch status --address ...` prints the cluster
    and never imports torch (read from the process's own -X importtime
    log)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _STATUS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert "resources:" in out and "CPU: " in out
    assert out.splitlines()[-1] == "IMPORTED True []"


_SERVE_DRIVER = r"""
import json
import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._internal.rpc import connect
from ray_tpu_torch.core.object_ref import get_core_worker

rt.init(num_cpus=2)
serve.start(http_port=0)
from ray_tpu_torch.serve.llm import llm_app

h = serve.run(llm_app("debug", device="cpu", max_batch=2), name="llm")
out = {"tokens": [d["token"] for d in h.options(stream=True).remote(
    {"tokens": [1, 2, 3], "max_new_tokens": 2})]}
h._refresh(force=True)
actors = {"controller": rt.get_actor("serve_controller"),
          "proxy": rt.get_actor("serve_proxy"),
          "replica": h._replicas[0]}
cw = get_core_worker()
[node] = cw.io.run(cw.gcs.get_all_nodes())


async def workers():
    conn = await connect(node.address.host, node.address.port)
    try:
        return await conn.call("list_workers", timeout=10)
    finally:
        await conn.close()


pids = {w["actor_id"]: w["pid"] for w in cw.io.run(workers())
        if w.get("actor_id")}
for role, actor in actors.items():
    pid = pids[actor._actor_id.hex()]
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        cmdline = f.read().replace(b"\0", b" ").decode().strip()
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    out[role] = {"cmdline": cmdline, "libtorch": "libtorch" in maps,
                 "jaxlib": "jaxlib" in maps}
serve.shutdown()
rt.shutdown()
print("RESULT", json.dumps(out), flush=True)
"""


def test_serve_processes_run_the_ports_modules():
    """llm_app served on the CPU: the controller's, the proxy's and the
    replica's processes are the port's workers, booted with -S; no process
    of the cluster (nor the driver) imports jax or the JAX package; only
    the replica, which builds the engine, maps libtorch."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, PYTHONPROFILEIMPORTTIME="1")
    proc = subprocess.run([sys.executable, "-c", _SERVE_DRIVER], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=150)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    out = json.loads(line[len("RESULT "):])
    assert len(out.pop("tokens")) == 2
    for role, seen in out.items():
        assert "-S -m ray_tpu_torch.core.worker_main" in seen["cmdline"], role
        assert not seen["jaxlib"], role
        assert seen["libtorch"] == (role == "replica"), role
    imported = [ln.rsplit("|", 1)[1].strip()
                for ln in proc.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    # the driver, the head and the three actors' workers each log
    assert imported.count("ray_tpu_torch._internal.ids") >= 5
    assert "ray_tpu_torch.serve.llm" in imported
    tops = {name.split(".")[0] for name in imported}
    assert not tops & {"jax", "jaxlib", "optax", "ray_tpu"}, tops
