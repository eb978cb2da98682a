"""The port stands alone: it imports no jax, optax or ray_tpu module, its
entry points run on the card unless told otherwise, and its kernel wrappers
never fall back to a plain version on a CUDA tensor."""

import ast
import inspect
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
    assert n_modules >= 16
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
    from ray_tpu_torch.models import llama, lora, mlp
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.ops import moe
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step
    from ray_tpu_torch.serve.llm import LLMEngine, MultiplexedLoraService

    cfg = llama.config_for("debug")
    return {
        "init_params": lambda: llama.init_params(cfg),
        "init_kv_cache": lambda: llama.init_kv_cache(cfg, 1),
        "LLMEngine": lambda: LLMEngine("debug"),
        "init_lora_params": lambda: lora.init_lora_params(
            cfg, lora.LoraConfig()),
        "MultiplexedLoraService": lambda: MultiplexedLoraService("debug"),
        "init_moe_params": lambda: moe.init_moe_params(8, 16,
                                                       moe.MoEConfig()),
        "mlp_init": lambda: mlp.mlp_init(mlp.MLPConfig()),
        "params_from_numpy": lambda: params_from_numpy({}),
        "build_train_step": lambda: build_train_step(
            lambda p, b: (None, {}), adamw(1e-3), {}),
        "resolve_device": lambda: ray_tpu_torch.resolve_device(None),
    }


@pytest.mark.parametrize("name", ["init_params", "params_from_numpy",
                                  "build_train_step", "resolve_device",
                                  "init_kv_cache", "LLMEngine",
                                  "init_lora_params",
                                  "MultiplexedLoraService",
                                  "init_moe_params", "mlp_init"])
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


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
            "ray_tpu_torch.serve.handle", "ray_tpu_torch.models.lora",
            "ray_tpu_torch.models.mlp", "ray_tpu_torch.ops.moe",
            "ray_tpu_torch.serve.multiplex"} <= names
