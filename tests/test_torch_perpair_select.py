"""The per-pair engines' selection (ops/select.py select_working_set)
against the JAX package's, bit for bit: the same pair ids and the same
float32 extrema, on random states, with class weights, padded rows, and
ties and signed zeros."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.ops.select import select_working_set as jax_select
from dpsvm_tpu_torch.ops.select import ieee_max, select_working_set


def _state(seed, n, c=(1.0, 1.0)):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    c_row = np.where(y > 0, c[0], c[1]).astype(np.float32)
    pick = rng.integers(0, 3, n)
    alpha = np.where(pick == 0, 0.0, np.where(
        pick == 1, c_row, rng.random(n) * c_row)).astype(np.float32)
    f = rng.normal(size=n).astype(np.float32)
    return f, alpha, y


def _both(f, alpha, y, c, valid=None):
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.as_tensor(valid)
    got = select_working_set(torch.as_tensor(f), torch.as_tensor(alpha),
                             torch.as_tensor(y), c, tv)
    want = jax_select(jnp.asarray(f), jnp.asarray(alpha), jnp.asarray(y), c,
                      jv)
    return got, want


def _assert_same(got, want):
    i_up, b_hi, i_low, b_lo = got
    assert int(i_up) == int(want[0]) and int(i_low) == int(want[2])
    for g, w in ((b_hi, want[1]), (b_lo, want[3])):
        assert np.asarray(g.numpy()).view(np.uint32) == \
            np.asarray(w).view(np.uint32)
    assert b_hi.dtype == torch.float32 and b_hi.dim() == 0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("c", [1.0, (2.0, 0.5)])
def test_select_working_set_bitwise(seed, c):
    cpair = c if isinstance(c, tuple) else (c, c)
    f, alpha, y = _state(seed, 257 + 64 * seed, cpair)
    _assert_same(*_both(f, alpha, y, c))


@pytest.mark.parametrize("seed", range(3))
def test_valid_masks_padded_rows(seed):
    f, alpha, y = _state(seed + 10, 1024)
    valid = np.zeros(1024, bool)
    valid[:700] = True
    # The padding holds the would-be extrema: they must never win.
    f[700:] = np.where(y[700:] > 0, -50.0, 50.0)
    got, want = _both(f, alpha, y, 1.0, valid)
    _assert_same(got, want)
    assert int(got[0]) < 700 and int(got[2]) < 700


def test_ties_go_to_the_lowest_index():
    n = 300
    y = np.ones(n, np.float32)
    y[::2] = -1.0
    alpha = np.full(n, 0.5, np.float32)  # every row in both sets
    f = np.round(np.random.default_rng(1).normal(size=n), 0).astype(
        np.float32)
    f[[17, 80, 255]] = f.min()
    f[[9, 140]] = f.max()
    got, want = _both(f, alpha, y, 1.0)
    _assert_same(got, want)
    assert int(got[0]) == int(np.flatnonzero(f == f.min())[0])
    assert int(got[2]) == int(np.flatnonzero(f == f.max())[0])


@pytest.mark.parametrize("order", [(0.0, -0.0), (-0.0, 0.0)])
def test_signed_zero_ties_report_the_element(order):
    """A +-0 tie: the id is the lowest index and the value is the element
    there (not an IEEE minimum / maximum), in both packages."""
    n = 16
    alpha = np.full(n, 0.5, np.float32)  # every row in both sets
    y = np.ones(n, np.float32)
    for sign in (1.0, -1.0):
        f = np.full(n, sign, np.float32)
        f[[3, 11]] = order
        got, want = _both(f, alpha, y, 1.0)
        _assert_same(got, want)
        side = 0 if sign > 0 else 2
        assert int(got[side]) == 3
        assert np.asarray(got[side + 1]).view(np.uint32) == \
            np.float32(order[0]).view(np.uint32)


def test_empty_sets_report_infinities():
    n = 64
    y = np.ones(n, np.float32)
    alpha = np.full(n, 1.0, np.float32)  # every y=+1 row at C: I_up empty
    f = np.random.default_rng(0).normal(size=n).astype(np.float32)
    got, want = _both(f, alpha, y, 1.0)
    _assert_same(got, want)
    assert float(got[1]) == np.inf


@pytest.mark.parametrize("vals", [[0.0, -0.0, -1.0], [-0.0, 0.0, -2.0],
                                  [-0.0, -0.0], [3.0, -np.inf, 3.0]])
def test_ieee_max_matches_jnp_max(vals):
    v = np.asarray(vals, np.float32)
    got = ieee_max(torch.as_tensor(v)).numpy()
    want = np.asarray(jnp.max(jnp.asarray(v)))
    assert got.view(np.uint32) == want.view(np.uint32)
