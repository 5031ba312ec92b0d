"""The control (the reference in bfloat16 in the program's place) fails at
least one of each cell's numbers, at a tiny size on the CPU; the same
tool runs it on the card at each cell's own size."""

import pytest
import torch

from rtbench import control
from rtbench.tests.tiny import CELLS, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name):
    checks = control.control_checks(tiny_cell(name), 2**31 + 3,
                                    torch.device("cpu"), log=lambda m: None)
    assert any(v > lim for _, v, lim in checks), checks
