"""The port's twins of the JAX package's tools and of ``bench.py``'s train
leg (``ray_tpu_torch/tools/``): each runs as ``python -m
ray_tpu_torch.tools.<name> --device cpu`` at its smallest size and prints
one JSON line that carries the keys the reference tool's result carries
(read from the reference's source); without a card and without
``--device cpu`` each raises before it measures anything. The RL benches'
runs are in ``test_torch_tools_rl.py``; ``test_torch_isolation.py`` holds
the twins to no import of jax or ray_tpu and no write of the reference's
records."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("bench", "lora_bench", "profile_step", "mfu_sweep",
         "mfu_decompose", "serve_bench", "rl_ppo_bench", "rl_image_bench",
         "rl_scale_bench")


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}


def run_twin(name: str, *args: str, timeout: float = 120) -> dict:
    """The twin's JSON line, run on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", f"ray_tpu_torch.tools.{name}",
         "--device", "cpu", *args], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout[-2000:]
    return json.loads(lines[0])


def reference_keys(tool: str, func: str, var: str | None = None) -> set:
    """The string keys of the dict literal that ``func`` of the reference's
    ``tool`` returns (or assigns to ``var``)."""
    with open(os.path.join(ROOT, tool)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
              and n.name == func)
    for node in ast.walk(fn):
        if var is None and isinstance(node, ast.Return):
            value = node.value
        elif (var is not None and isinstance(node, ast.Assign)
              and any(isinstance(t, ast.Name) and t.id == var
                      for t in node.targets)):
            value = node.value
        else:
            continue
        if isinstance(value, ast.Dict):
            return {k.value for k in value.keys
                    if isinstance(k, ast.Constant)}
    raise AssertionError(f"{tool}:{func} returns no dict literal")


def test_bench_twin_prints_the_reference_keys():
    out = run_twin("bench", "--preset", "debug", "--batch", "1", "--seq",
                   "32", "--steps", "1")
    assert reference_keys("bench.py", "_run") <= set(out)
    assert out["metric"] == "llama_debug_train_tokens_per_sec_per_chip"
    assert out["value"] > 0 and out["unit"] == "tokens/s"
    # no peak for a CPU: no MFU
    assert out["mfu"] is None and out["vs_baseline"] is None
    assert out["device"] == "cpu"


def test_lora_bench_twin_counts_two_thirds_of_the_flops():
    out = run_twin("lora_bench", "--preset", "debug", "--batch", "1",
                   "--seq", "32", "--steps", "1", "--rank", "4")
    assert reference_keys("bench.py", "_run") | {"captured_at"} <= set(out)
    assert out["metric"] == "llama_debug_lora_train_tokens_per_sec_per_chip"
    full = run_twin("bench", "--preset", "debug", "--batch", "1", "--seq",
                    "32", "--steps", "1")
    assert out["flops_per_token"] == pytest.approx(
        full["flops_per_token"] * 2 / 3)


def test_profile_step_twin_ranks_the_ops(tmp_path):
    """The reference writes framework op stats of an XLA trace; the twin
    prints the top operators by device time (the CPU's own time here) and
    writes the whole table to --out."""
    path = tmp_path / "ops.json"
    out = run_twin("profile_step", "--preset", "debug", "--batch", "1",
                   "--seq", "32", "--out", str(path))
    assert {"top_ops", "kernels", "wall_ms", "device_busy_ms",
            "launches_traced", "flash_launches_counted"} <= set(out)
    assert out["top_ops"] and {"op", "calls", "self_device_ms",
                               "self_cpu_ms"} <= set(out["top_ops"][0])
    table = json.loads(path.read_text())
    assert len(table["ops"]) >= len(out["top_ops"])


def test_mfu_sweep_twin_measures_each_config_in_a_child():
    out = run_twin("mfu_sweep", "--seq", "32", "--steps", "1", "--configs",
                   "debug:1:dots:flash,debug:1:nothing:xla")
    keys = reference_keys("tools/mfu_sweep.py", "measure")
    assert [r["cfg"]["attn"] for r in out["rows"]] == ["flash", "xla"]
    for row in out["rows"]:
        assert keys <= set(row), row
    assert out["best"] in out["rows"]


def test_mfu_decompose_twin_times_every_leg():
    out = run_twin("mfu_decompose", "--b", "1", "--s", "32", "--d", "32",
                   "--h", "2", "--hid", "64", "--l", "2", "--v", "128",
                   "--steps", "1")
    keys = reference_keys("tools/mfu_decompose.py", "leg_mlp")
    assert [r["leg"] for r in out["legs"]] == [
        "attn_flash_fwdbwd", "attn_xla_fwdbwd", "attn_sdpa_fwdbwd",
        "block_matmuls_fwdbwd", "fused_ce_fwdbwd"]
    for row in out["legs"]:
        assert keys <= set(row) and row["ms"] > 0


def test_serve_bench_twin_engine_leg():
    out = run_twin("serve_bench", "--leg", "engine", "--concurrency", "2",
                   "--requests", "2", "--max-new", "4", "--prompt-len", "8")
    assert reference_keys("tools/serve_bench.py", "_run_bench") <= \
        set(out["engine"])
    assert out["engine"]["platform"] == "cpu"
    assert out["engine"]["tokens_per_sec"] > 0 and "captured_at" in out


def test_every_twin_raises_without_a_card():
    """No card here, and no --device cpu: each twin raises before it
    measures anything and prints no result."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"ray_tpu_torch.tools.{name}"], cwd=ROOT,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in TWINS}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode != 0, name
        assert "CUDA device" in err and "device='cpu'" in err, (name, err)
        assert "{" not in out, (name, out)
