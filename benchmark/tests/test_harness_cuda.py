"""On the card: the control comes out not correct, the program correct.

The control puts TF32 products in place of the float32 ones the
configuration states: the program's own TF32 path for the training
cell (SVMConfig matmul_precision "high"). At a size a test run holds
(60000 rows; the cell's own size is run by benchmark/controls.py), one
seed each. Run with ``python -m pytest benchmark/tests -m cuda``."""

import pytest

from benchmark import controls

from conftest import make_cell


@pytest.mark.cuda
def test_tf32_control_fails_and_program_passes(card):
    cell = make_cell("mnist8m.block", "mnist8m", "train-jobs", rows=60000,
                     q=256)
    lim = cell.limits
    prog = controls.readings(cell, 11, 1.0, "program", "cuda")
    ctl = controls.readings(cell, 11, 1.0, "control", "cuda")
    assert all(prog[nm] <= lim[nm] for nm in lim), prog
    assert ctl["f_gap"] > lim["f_gap"]
