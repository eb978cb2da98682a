"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped (the tiny cells run on the CPU), the
rest of the run is driven as on the card, and ``correct`` reads false for
each fault a cell can have. The control (the reference computed as fp8
GEMMs) reads above the limits too.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import argparse
import json

import pytest
import torch

from benchmark import calibrate, run
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.make_layout(tmp_path_factory.mktemp("layout"))


def _correct(layout, cell, seed=2**32 + 11) -> tuple[bool, dict]:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=1.5,
                              trace=0)
    line = json.loads(run.execute(args, layout, torch.device("cpu"))["line"])
    return line["correct"], line["checks"]


def test_a_step_that_returns_its_state_unchanged_is_caught(layout,
                                                           monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    ok, checks = _correct(layout, "tiny.train")
    assert not ok
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(layout, monkeypatch):
    from ray_tpu_torch.models import llama

    full = llama.loss_fn

    def half(params, batch, cfg):
        n = batch["tokens"].shape[0] // 2
        return full(params, {k: v[:n] for k, v in batch.items()}, cfg)

    monkeypatch.setattr(llama, "loss_fn", half)
    ok, checks = _correct(layout, "tiny.train")
    assert not ok, checks


@pytest.mark.parametrize("cell", ["tiny.closed", "tiny.open"])
def test_a_token_altered_where_it_is_produced_is_caught(layout, monkeypatch,
                                                        cell):
    from ray_tpu_torch.serve.llm import LLMEngine

    sample = LLMEngine._sample
    calls = {"n": 0}

    def altered(self, params, cache, tokens, temperature):
        nxt, cache = sample(self, params, cache, tokens, temperature)
        calls["n"] += 1
        if calls["n"] % 3 == 0:           # every third step, every row
            nxt = (nxt + 1) % self.cfg.vocab_size
        return nxt, cache

    monkeypatch.setattr(LLMEngine, "_sample", altered)
    ok, checks = _correct(layout, cell)
    assert not ok, checks


@pytest.mark.parametrize("cell", ["tiny.closed", "tiny.train"])
def test_the_control_reads_above_the_limits(layout, cell):
    """The fp8 control in the program's place fails at least one of the
    cell's limits on each seed, where the program passes them all."""
    limits = layout.json("cells", cell)["limits"]
    rows = calibrate.control(layout, cell, [3, 2**31 + 9], 1.5,
                             torch.device("cpu"))
    for row in rows:
        r = row["readings"]
        assert all(r[k] <= v for k, v in limits.items()), r
        assert any(r["control." + k] > v for k, v in limits.items()), r
        # and the harness's own comparison says so
        assert row["correct"] and row["control.correct"] is False, row
        if cell == "tiny.train":
            assert row["fault.half_batch.correct"] is False, row
