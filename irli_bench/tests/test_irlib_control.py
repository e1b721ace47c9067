"""The control comes out not correct: the plain reference at TF32, the
next precision below the configurations' IEEE fp32, put in the program's
place, held to each cell's limits at the tiny size on the CPU (the card's
readings at the cells' own sizes are in PERF.md)."""
import pytest
import torch

import tiny
from irli_bench import check, harness


@pytest.mark.parametrize("name", list(tiny.TRAFFIC))
def test_the_control_fails_the_cells_limits(name):
    cell = tiny.cell(name)
    numbers = harness.generator(cell).control(cell, 2**31 + 41, 2.0,
                                           torch.device("cpu"))
    correct, out = check.verdict(numbers, cell["check"], 0)
    assert not correct, out
