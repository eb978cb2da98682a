"""The port stands alone: it imports no jax, optax or ray_tpu module, its
entry points run on the card unless told otherwise, and its kernel wrappers
never fall back to a plain version on a CUDA tensor."""

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
    assert n_modules >= 12
    assert bad == [], f"ray_tpu_torch pulled in {bad}"


def _entry_points():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.spmd import adamw, build_train_step

    cfg = llama.config_for("debug")
    return {
        "init_params": lambda: llama.init_params(cfg),
        "params_from_numpy": lambda: params_from_numpy({}),
        "build_train_step": lambda: build_train_step(
            lambda p, b: (None, {}), adamw(1e-3), {}),
        "resolve_device": lambda: ray_tpu_torch.resolve_device(None),
    }


@pytest.mark.parametrize("name", ["init_params", "params_from_numpy",
                                  "build_train_step", "resolve_device"])
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


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="must be on"):
        tflash.flash_forward_cuda(q, q, q)


def test_every_module_is_walked():
    names = {m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                                   "ray_tpu_torch.")}
    assert {"ray_tpu_torch.ops.cuda.flash_attention",
            "ray_tpu_torch.models.llama", "ray_tpu_torch.parallel.spmd",
            "ray_tpu_torch.models.convert"} <= names
