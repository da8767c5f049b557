"""Whole block-engine solves of the port against the JAX package's
solve(engine="block") on the same data (both on the CPU).

The two packages sum the fold's matmuls in different orders, so their
trajectories part after the first rounds; what must agree is the
optimum and the stopping rule: both converge, dual objective within
rel 1e-4, SV count within 2%, |b - b_jax| <= 5e-3, and the first
round's working set identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops.select import extrema_np as jax_extrema_np
from dpsvm_tpu.solver import block as jblock
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.ops.select import extrema_np
from dpsvm_tpu_torch.solver import block as tblock
from dpsvm_tpu_torch.solver.solve import block_height

BASE = dict(c=1.0, gamma=0.1, engine="block", working_set_size=64)


def _dual_obj(res, y):
    a, f = np.asarray(res.alpha, np.float64), np.asarray(res.stats["f"],
                                                         np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


@pytest.fixture(params=["small", "medium"])
def data(request, blobs_small, blobs_medium):
    return blobs_small if request.param == "small" else blobs_medium


@pytest.mark.parametrize("kw", [
    dict(dtype="float32", selection="mvp"),
    dict(dtype="float32", selection="second_order"),
    dict(dtype="bfloat16", selection="mvp"),
    dict(dtype="bfloat16", selection="second_order"),
    dict(dtype="float32", selection="mvp", compensated=True),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_solve_matches_jax(data, kw):
    x, y = data
    cfg = {**BASE, **kw}
    rj = jax_solve(x, y, JaxConfig(**cfg))
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    assert rj.converged and rt.converged
    assert rt.stats["outer_rounds"] > 0
    obj_j, obj_t = _dual_obj(rj, y), _dual_obj(rt, y)
    assert abs(obj_t - obj_j) <= 1e-4 * abs(obj_j), (obj_t, obj_j)
    assert abs(rt.n_sv - rj.n_sv) <= 0.02 * rj.n_sv, (rt.n_sv, rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3, (rt.b, rj.b)
    # The stopping rule holds on the port's own final state.
    b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, 1.0)
    assert b_lo <= b_hi + 2 * 1e-3 + 1e-6
    assert rt.alpha.min() >= 0 and rt.alpha.max() <= 1.0
    assert abs(float(np.sum(rt.alpha * y))) < 1e-3


@pytest.mark.parametrize("rule", ["mvp", "second_order"])
def test_first_round_working_set_identical(data, rule):
    x, y = data
    yf = y.astype(np.float32)
    jw, jok, _, _ = jblock.select_block(jnp.asarray(-yf),
                                        jnp.zeros(len(y), jnp.float32),
                                        jnp.asarray(yf), 1.0, 64, rule=rule)
    tw, tok, _, _ = tblock.select_block(torch.as_tensor(-yf),
                                        torch.zeros(len(y)),
                                        torch.as_tensor(yf), 1.0, 64,
                                        rule=rule)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("rule", ["mvp", "second_order"])
def test_max_iter_budget_exit_refreshes_extrema(blobs_medium, rule):
    x, y = blobs_medium
    cfg = {**BASE, "selection": rule, "max_iter": 150}
    rj = jax_solve(x, y, JaxConfig(**cfg))
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    assert rt.iterations == rj.iterations == 150
    assert not rt.converged and not rj.converged
    # The reported extrema are those of the final state, not the carried
    # (one-fold-behind) ones.
    assert (rt.b_hi, rt.b_lo) == extrema_np(rt.stats["f"], rt.alpha, y, 1.0)
    assert (rj.b_hi, rj.b_lo) == jax_extrema_np(rj.stats["f"], rj.alpha, y,
                                                1.0)
    assert abs(rt.b_hi - rj.b_hi) < 1e-3 and abs(rt.b_lo - rj.b_lo) < 1e-3


@pytest.mark.parametrize("rule", ["mvp", "second_order"])
def test_budget_mode_runs_the_exact_pair_budget(blobs_small, rule):
    x, y = blobs_small
    cfg = {**BASE, "selection": rule, "budget_mode": True, "max_iter": 1500}
    rj = jax_solve(x, y, JaxConfig(**cfg))
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    assert rt.iterations == rj.iterations == 1500
    # `converged` is still judged at the real epsilon on the final state.
    assert rt.converged == rj.converged
    b_hi, b_lo = extrema_np(rt.stats["f"], rt.alpha, y, 1.0)
    assert rt.converged == (not (b_lo > b_hi + 2e-3))


def test_working_set_clamps_to_small_data():
    x = np.random.default_rng(1).normal(size=(9, 3)).astype(np.float32)
    y = np.array([1, -1, 1, -1, 1, -1, 1, -1, 1], np.int32)
    cfg = dict(c=1.0, gamma=0.5, engine="block", working_set_size=128)
    rj = jax_solve(x, y, JaxConfig(**cfg))
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    assert rt.converged and rj.converged
    # q clamps to 8 of the 9 rows (even, for balanced halves): the first
    # round's (and so every round's) working set covers 8 rows.
    assert block_height(SVMConfig(**cfg), 9) == (8, 16)
    obj_j, obj_t = _dual_obj(rj, y), _dual_obj(rt, y)
    assert abs(obj_t - obj_j) <= 1e-4 * abs(obj_j), (obj_t, obj_j)
    assert abs(rt.b - rj.b) <= 5e-3
