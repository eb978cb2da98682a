"""Card tests: each cell at its own size, a short window, the program within
its limits and the fp8 control above at least one of them, so that the
harness's own comparison judges the control not correct. They skip on a
machine without a CUDA card (the decision is made inside the test).

    python -m pytest benchmark/tests/test_benchmark_card.py -q   # on the card
"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, harness

CELLS = ("smollm2-1.7b.train-2k", "mistral-7b.batch", "mistral-7b.code",
         "smollm2-1.7b.train-8k")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_passes_and_its_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    layout = harness.Layout()
    limits = layout.json("cells", cell)["limits"]
    row, = calibrate.control(layout, cell, [2**31 + 101], 20.0,
                             torch.device("cuda", 0))
    r = row["readings"]
    assert not row["problems"], row
    assert all(r[k] <= v for k, v in limits.items()), r
    assert any(r["control." + k] > v for k, v in limits.items()), r
    assert row["correct"] and row["control.correct"] is False, row
