"""The control on the card: the program with TF32 matrix products, the
precision just below the configurations' float32 with TF32 off, held to
the cells' limits, must come out not correct; the program as configured,
on the same inputs, correct. At the cells' widths (CAP 100), with fewer
instances and a short window so that a test run holds it.

    python -m pytest benchmark/tests -m cuda
"""

import time

import pytest
import torch

from benchmark.harness import main, spec
from benchmark.tests.tiny import CELLS, bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_tf32_control_is_not_correct(card, cell, seed):
    c = spec.cell(bench(), cell)
    c["traffic"].update(instances=min(c["traffic"]["instances"], 64))
    sound = main.run_cell(c, seed, 1.0, False, card, time.perf_counter())
    assert sound["correct"], sound["checks"]
    control = main.run_cell(c, seed, 1.0, False, card, time.perf_counter(),
                            control="tf32")
    assert not control["correct"], control["checks"]
