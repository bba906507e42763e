"""The control and the planted fault fail the check: the plain reference
in float8 e4m3 in the program's place, and the reference on half of each
batch, read against the reference at the tiny preset on the CPU, on three
seeds each: the check's verdict on them is not correct, and at least
one of the cell's limits is exceeded. (On the card, at
the cells' own size, ``cardbench/calibrate.py`` gives the readings the
limits were set from: PERF.md.)"""

from __future__ import annotations

import pytest
import torch

from cardbench.calibrate import readings
from conftest import CELLS, tiny

NUMBERS = ("loss_gap", "grad_gap", "change_gap")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_and_half_batch_fail(cell):
    config, traffic = tiny(cell)
    limits = traffic["limits"]
    for seed in (11, 12, 13):
        lines = readings(config, traffic, seed, ("control", "half_batch"), torch.device("cpu"), log=None)
        for line in lines[1:]:
            assert line["correct"] is False, (line, limits)
            assert any(line[n] > limits[n] for n in NUMBERS), (line, limits)
