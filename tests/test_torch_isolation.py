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
    assert n_modules >= 104
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
    }


@pytest.mark.parametrize("name", ["init_params", "params_from_numpy",
                                  "build_train_step", "resolve_device",
                                  "init_kv_cache", "LLMEngine",
                                  "init_lora_params",
                                  "MultiplexedLoraService",
                                  "PrefillWorker", "DecodeLlamaService",
                                  "init_moe_params", "mlp_init",
                                  "run_microbenchmarks"])
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
            "ray_tpu_torch._internal.perf"} <= names


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
