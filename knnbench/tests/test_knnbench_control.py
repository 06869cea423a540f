"""Each cell's control comes out not correct: the reference in TF32, the
precision below the configurations' f32, put in the program's place and
judged against the cell's own limits. At the published widths, with fewer
rows and requests than the cell's (the limits scale with the width, not
with the rows). On the CPU the TF32 product is emulated by rounding both
operands to TF32's mantissa; on a card it is cuBLAS's own."""
from __future__ import annotations

import pytest
import torch

from knnbench import control, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(cell):
    ok, checks = control.control(cell, 2 ** 31 + 3, torch.device("cpu"), {"n": 8192},
                                 {"query_pool": 256}, requests=4)
    assert not ok, checks
    assert checks["score_err"]["value"] > checks["score_err"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison_on_the_card(cell, card):
    ok, checks = control.control(cell, 2 ** 31 + 3, card, {"n": 65536},
                                 {"query_pool": 1024}, requests=16)
    assert not ok, checks
