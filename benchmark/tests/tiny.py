"""A benchmark layout of tiny cells for CPU tests: the real metric readers,
and configurations, mixes and limits of their own, found by name as the
real cells' are."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

SERVE_CONF = {
    "source": "test", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
    "max_position_embeddings": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "sliding_window": None,
    "tie_word_embeddings": False,
    "assumed": {"engine": {"tp": 1, "max_batch": 4, "prefill_chunk": 32,
                           "prompt_buckets": [32, 64, 128],
                           "prefix_cache_entries": 8, "eos": None}},
}
TRAIN_CONF = {
    "source": "test", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "head_dim": 16, "vocab_size": 256,
    "max_position_embeddings": 64, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-5, "tie_word_embeddings": True,
    "assumed": {"train": {"param_dtype": "float32",
                          "compute_dtype": "bfloat16",
                          "adamw": {"lr": 3e-4, "b1": 0.9, "b2": 0.999,
                                    "eps": 1e-8, "weight_decay": 1e-4},
                          "remat": True, "remat_policy": "dots",
                          "attn_impl": "flash"}},
}
CHECK = {"min_requests": 4, "min_served_tokens": 30, "max_requests": 8}
MIXES = {
    "tiny-closed": {"kind": "serve", "loop": "closed",
                    "queued_beyond_slots": 4, "pool": 400,
                    "prompt": {"dist": "lognormal", "median": 24,
                               "sigma": 0.7, "min": 8, "max": 100},
                    "answer": {"dist": "lognormal", "median": 8,
                               "sigma": 0.5, "min": 4, "max": 16},
                    "temperature": 0.0, "check": CHECK},
    "tiny-open": {"kind": "serve", "loop": "open", "rate_per_s": 8.0,
                  "lead_in_s": 0.5,
                  "prompt": {"dist": "lognormal", "median": 40,
                             "sigma": 0.6, "min": 8, "max": 120},
                  "answer": {"dist": "lognormal", "median": 6, "sigma": 0.8,
                             "min": 2, "max": 12},
                  "temperature": 0.0, "check": CHECK},
    "tiny-train": {"kind": "train", "batch": 4, "seq": 32,
                   "check_steps": 3},
}
CELLS = {"tiny.closed": ("tiny-serve", "tiny-closed"),
         "tiny.open": ("tiny-serve", "tiny-open"),
         "tiny.train": ("tiny-train", "tiny-train")}
# the real cell each tiny one stands for (its metrics' workloads)
STANDS_FOR = {"tiny.closed": "mistral-7b.batch",
              "tiny.open": "mistral-7b.code",
              "tiny.train": "smollm2-1.7b.train-2k"}
# set from the tiny cells' own readings on the CPU, as the real cells'
# were on the card: the program's largest over seeds (serve 0.010; train
# loss 2.7e-4, gradient 3.0e-3, change 1.1e-3) below, the fp8 control's
# smallest (serve 0.22; train 1.6e-3, 1.2e-2, 5.5e-3) above
SERVE_LIMITS = {"max_logit_gap": 0.06}
LIMITS = {"tiny.closed": SERVE_LIMITS, "tiny.open": SERVE_LIMITS,
          "tiny.train": {"loss_gap": 8e-4, "grad_gap": 6e-3,
                         "change_gap": 3e-3}}


def make_layout(tmp: Path):
    """A root with its own BENCHMARK.json and data folder; returns the
    harness's Layout over it."""
    from benchmark.harness import Layout

    data = tmp / "bench"
    shutil.copytree(BENCH / "metrics", data / "metrics")
    for kind in ("configs", "traffic", "cells"):
        (data / kind).mkdir(parents=True)
    (data / "configs" / "tiny-serve.json").write_text(json.dumps(SERVE_CONF))
    (data / "configs" / "tiny-train.json").write_text(json.dumps(TRAIN_CONF))
    for name, mix in MIXES.items():
        (data / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, limits in LIMITS.items():
        (data / "cells" / f"{cell}.json").write_text(
            json.dumps({"limits": limits}))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": c, "config": conf, "traffic": mix,
                          "chips": 1, "why": "test"}
                         for c, (conf, mix) in CELLS.items()]
    real_cells = {v: k for k, v in STANDS_FOR.items()}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real_cells[w] for w in m["workloads"]
                              if w in real_cells]
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Layout(tmp, data)
