"""CPU tests of the benchmark harness: cells found by name, generators that
repeat from the seed, FLOP and byte counts against hand sums, the result
line's keys, and no module of JAX or the JAX package loaded.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import flops, harness, model, run, traffic
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(layout, cell, trace=0, seconds=1.5, seed=2**31 + 7):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return run.execute(args, layout, torch.device("cpu"))


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.make_layout(tmp_path_factory.mktemp("layout"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_new_config_and_traffic_are_found_by_name(layout, cell):
    """The tiny cells exist only as data files of their own, beside the
    real readers: the harness runs them without an edit, and judges them
    correct against their limits."""
    out = _run(layout, cell)
    line = json.loads(out["line"])
    assert line["correct"], out["stderr"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"]
    assert len(line["metrics"]) >= 2


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_last_line_has_the_contract_keys_and_checks_last(layout, cell):
    line = json.loads(_run(layout, cell)["line"])
    assert set(line) == CONTRACT_KEYS | {"checks"}
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_every_declared_metric_has_a_reader_and_every_cell_its_files():
    layout = harness.Layout(ROOT)
    spec = layout.spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] != "setup_s":
            layout.file("metrics", m["name"], ".py")
    for w in spec["workloads"]:
        layout.json("configs", w["config"])
        layout.json("traffic", w["traffic"])
        assert layout.json("cells", w["name"])["limits"]
        per_layer = harness.metrics_of(spec, w["name"], True)
        e2e = harness.metrics_of(spec, w["name"], False)
        assert per_layer and len(e2e) >= 2, w["name"]
        moved = {m["moves"] for m in per_layer}
        assert moved <= {m["name"] for m in e2e}


def test_serve_generator_repeats_from_the_seed_and_keeps_the_work():
    mix = harness.Layout(ROOT).json("traffic", "code")
    a = traffic.serve_requests(mix, 2**33 + 5, 64, 32768)
    b = traffic.serve_requests(mix, 2**33 + 5, 64, 32768)
    c = traffic.serve_requests(mix, 12, 64, 32768)
    assert [(r.prompt, r.answer, r.due) for r in a] == \
        [(r.prompt, r.answer, r.due) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in c]
    # the seed draws the order of lengths and arrivals, not only the ids
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]
    assert [r.due for r in a] != [r.due for r in c]
    # another seed sends the same multiset of lengths and gaps
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt)
                                                      for r in c)
    assert sorted(r.answer for r in a) == sorted(r.answer for r in c)
    assert a[-1].due == pytest.approx(c[-1].due)
    for r in a:
        assert 256 <= len(r.prompt) <= 3584 and 4 <= r.answer <= 128


def test_train_rows_repeat_from_the_seed():
    mix = {"batch": 2, "seq": 16}
    a = traffic.train_rows(mix, 2**35, 3, 100, "cpu")
    b = traffic.train_rows(mix, 2**35, 3, 100, "cpu")
    c = traffic.train_rows(mix, 2**35, 4, 100, "cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert torch.equal(a[0][:, 1:], a[1][:, :-1])


def test_weights_repeat_and_a_leaf_redraws_alone():
    d = model.dims(tiny.TRAIN_CONF)
    p = model.make_params(d, 9, torch.float32, "cpu")
    q = model.make_params(d, 9, torch.float32, "cpu")
    for k, v in model.leaves(p).items():
        assert torch.equal(v, model.leaves(q)[k])
        assert torch.equal(v, model.draw_leaf(d, k, 9, torch.float32, "cpu"))


def test_flop_and_byte_counts_match_hand_sums():
    d = model.Dims(vocab=10, dim=4, layers=2, heads=2, kv_heads=1,
                   head_dim=2, ffn=6, max_seq=8, rope_theta=1e4,
                   norm_eps=1e-5, tied=True)
    # per layer: wq 4x4, wk 4x2, wv 4x2, wo 4x4, three FFN 4x6 = 120
    assert d.matmul_params() == 2 * 120
    # 6 x (240 + head 40) + 2 layers x 12 x 2 heads x 2 hd x (3 pairs / 2)
    assert flops.train_flops_per_token(d, 2) == 6 * 280 + 2 * 12 * 2 * 2 * 1.5
    assert flops.prompt_flops(d, 3) == 2 * 240 * 3 + 2 * 40 + 2 * 4 * 4 * 6
    assert flops.decode_token_flops(d, 5) == 2 * 280 + 2 * 4 * 4 * 5
    assert flops.kv_bytes_per_position(d) == 2 * 2 * 2 * 2
    bound = flops.decode_step_bound_s(d, 2, 7, 1.0, 1.0)
    assert bound["flops"] == 2 * 2 * 280 + 2 * 4 * 4 * 7
    assert bound["bytes"] == 280 * 2 + 16 * 7 + 16 * 2
    # flash: b1 s2 h1 hd2, pairs 3
    assert flops.flash_bound("flash_fwd", 1, 2, 1, 1, 2) == (
        4 * 2 * 3, 2 * 8 + 2 * 8 + 8)
    assert flops.flash_bound("flash_bwd_dq", 1, 2, 1, 1, 2) == (
        6 * 2 * 3, 3 * 8 + 2 * 8 + 16)
    assert flops.flash_bound("flash_bwd_dkv", 1, 2, 1, 1, 2) == (
        8 * 2 * 3, 2 * 8 + 4 * 8 + 16)


def test_the_published_widths_reach_the_port_unchanged():
    from ray_tpu_torch.models import llama

    for name, width in (("mistral-7b-v0.3", 4096), ("smollm2-1.7b", 2048)):
        conf = harness.Layout(ROOT).json("configs", name)
        cfg = llama.LlamaConfig(**model.llama_kwargs(conf))
        assert cfg.dim == width == conf["hidden_size"]
        assert cfg.head_dim == conf["head_dim"]
        assert cfg.hidden_dim == conf["intermediate_size"]
        assert cfg.n_kv_heads == conf["num_key_value_heads"]
        shapes = {k: v[0] for k, v in model.leaf_shapes(model.dims(conf))
                  .items()}
        want = llama.param_shapes(cfg)
        assert shapes["wq"] == want["layers"]["wq"]
        assert shapes["w_down"] == want["layers"]["w_down"]


def test_no_jax_module_is_loaded_by_a_run():
    """A run's modules (the harness, both drivers, the port's engine and
    train step) hold no module named jax, jaxlib, flax or ray_tpu, compared
    by the whole top-level name."""
    code = ("import benchmark.run, benchmark.serve, benchmark.train, "
            "benchmark.calibrate, benchmark.reference\n"
            "import ray_tpu_torch.serve.llm, ray_tpu_torch.parallel.spmd\n"
            "from benchmark.harness import banned_modules\n"
            "print(banned_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_probe", object())
    monkeypatch.setitem(sys.modules, "ray_tpu.probe", object())
    found = harness.banned_modules()
    assert "ray_tpu.probe" in found
    assert "ray_tpu_torch_probe" not in found


def test_no_card_no_result(tmp_path):
    """Without CUDA (this machine) a run exits non-zero and prints no
    result; so does a directory holding only the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload",
             "mistral-7b.code", "--seed", "5", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
