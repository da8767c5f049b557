"""A run with the timed path broken underneath comes out not correct.

The look for a card is skipped: each test drives the rest of a run on
the CPU at a tiny size (run.measure, then run.result_line) with one
fault planted in the port. The one-card cell has no exchange between
cards to leave out."""

import sys

import numpy as np
import pytest
import torch

from benchmark import run as bench_run

from conftest import make_cell


def _line(cell, seconds=1.0, plant=None):
    """A run's result line; `plant` breaks the port after set-up."""
    drv = cell.driver
    state = drv.setup(cell, 2**33 + 1, "cpu")
    if plant is not None:
        plant()
    run = drv.window(state, seconds, False)
    run["setup_s"] = 0.0
    run["memory_peak_bytes"] = 0
    drv.close(state)
    checks = drv.check(state, run)
    return bench_run.result_line(cell, run, checks, False, "cpu", "none")


@pytest.fixture
def train_cell():
    return make_cell("mnist8m.block", "mnist8m", "train-jobs")


def test_sound_train_run_is_correct(train_cell):
    line = _line(train_cell)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0


def test_step_returning_its_state_unchanged(train_cell, monkeypatch):
    from dpsvm_tpu_torch.solver import block

    def unchanged(x, y, x_sq, k_diag, state, max_iter, *a, **k):
        # Nothing moves; the extremes read those of the start (alpha 0,
        # f -y) and the pair budget reads spent, so the loop ends.
        return state._replace(b_hi=torch.full_like(state.b_hi, -1.0),
                              b_lo=torch.full_like(state.b_lo, 1.0),
                              pairs=torch.full_like(state.pairs, max_iter),
                              rounds=state.rounds + 1)

    line = _line(train_cell, plant=lambda: monkeypatch.setattr(
        block, "run_chunk_block", unchanged))
    assert line["correct"] is False
    assert line["checks"]["kkt_gap"]["value"] > 1.0


def test_half_of_the_rows_left_out_of_the_fold(train_cell, monkeypatch):
    from dpsvm_tpu_torch.solver import block

    fold = block.fold_block

    def half(x, x_sq, qx, qsq, kp, f, f_err, *rest):
        alpha, f_new, f_err = fold(x, x_sq, qx, qsq, kp, f, f_err, *rest)
        h = f.shape[0] // 2
        return alpha, torch.cat([f_new[:h], f[h:]]), f_err

    line = _line(train_cell, plant=lambda: monkeypatch.setattr(
        block, "fold_block", half))
    assert line["correct"] is False
    assert line["checks"]["f_gap"]["value"] > \
        line["checks"]["f_gap"]["limit"]


def test_an_alpha_altered_where_the_solve_returns_it(train_cell,
                                                     monkeypatch):
    train_mod = sys.modules["dpsvm_tpu_torch.train"]
    solve_on = train_mod.solve_on

    def altered(*a, **k):
        res = solve_on(*a, **k)
        i = int(np.flatnonzero(res.alpha > 0)[0])
        res.alpha[i] *= 0.5
        return res

    line = _line(train_cell, plant=lambda: monkeypatch.setattr(
        train_mod, "solve_on", altered))
    assert line["correct"] is False
    assert line["checks"]["f_gap"]["value"] > \
        line["checks"]["f_gap"]["limit"]


@pytest.mark.parametrize("fault", ["b_lo alone", "sign"])
def test_an_intercept_altered_where_the_solve_returns_it(train_cell,
                                                         monkeypatch, fault):
    # The model is assembled from the altered result, so its b agrees
    # with the result's: only the reference's intercept can tell.
    train_mod = sys.modules["dpsvm_tpu_torch.train"]
    solve_on = train_mod.solve_on

    def altered(*a, **k):
        res = solve_on(*a, **k)
        res.b = res.b_lo if fault == "b_lo alone" else -res.b
        return res

    line = _line(train_cell, plant=lambda: monkeypatch.setattr(
        train_mod, "solve_on", altered))
    assert line["correct"] is False
    assert line["checks"]["b_gap"]["value"] > \
        line["checks"]["b_gap"]["limit"]
    assert line["checks"]["model_diff"]["value"] == 0


def test_a_model_assembled_wrong(train_cell, monkeypatch):
    from dpsvm_tpu_torch.models.svm_model import SVMModel

    from_dense = SVMModel.from_dense.__func__

    def shifted(cls, *a, **k):
        model = from_dense(cls, *a, **k)
        model.b += 1.0
        return model

    line = _line(train_cell, plant=lambda: monkeypatch.setattr(
        SVMModel, "from_dense", classmethod(shifted)))
    assert line["correct"] is False
    assert line["checks"]["model_diff"]["value"] >= 1
