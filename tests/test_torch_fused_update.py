"""Kernel B6's plain version (ops/fused_update.py _fused_update_select)
against the JAX kernel fused_update_select in interpret mode, on the
inputs of tests/test_pallas_fused.py and on ties and signed zeros.

XLA on the CPU contracts the update f + coef_hi k_hi + coef_lo k_lo into
two fused multiply-adds; the port does the same, so with the same kernel
values f' is bitwise JAX's. exp (rbf) and pow may differ by a few ulps
between XLA and torch (ROADMAP C.2), so where they enter, f' is held
within 4 ulps of the update's scale and the extrema within the same; the
ids are held exactly, and so are the extrema the port's own reduction
gives from its own f'."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.ops.pallas_fused import fused_update_select as jax_fused
from dpsvm_tpu_torch.ops import fold_select as tfs
from dpsvm_tpu_torch.ops import fused_update as tfu
from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_from_dots

LANES = 128


def _inputs(n_pad, n_valid, c, seed=3):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n_pad).astype(np.float32)
    alpha = rng.choice([0.0, c, 0.6], size=n_pad).astype(np.float32)
    y = rng.choice([-1.0, 1.0], size=n_pad).astype(np.float32)
    valid = np.zeros(n_pad, np.float32)
    valid[:n_valid] = 1
    d_hi = rng.normal(size=n_pad).astype(np.float32)
    d_lo = rng.normal(size=n_pad).astype(np.float32)
    x_sq = np.abs(rng.normal(size=n_pad)).astype(np.float32)
    return f, alpha, y, valid, d_hi, d_lo, x_sq


def _run_both(arrays, scalars, kind, c, block_rows=8, **kp_kw):
    rows = arrays[0].size // LANES
    shp = (rows, LANES)
    jkp = JaxKP(kind=kind, **kp_kw)
    tkp = KernelParams(kind=kind, **kp_kw)
    want = jax_fused(*(jnp.asarray(a.reshape(shp)) for a in arrays),
                     jnp.asarray(scalars), jkp, c, block_rows=block_rows,
                     interpret=True)
    t_in = [torch.as_tensor(a.reshape(shp)) for a in arrays]
    tfu.fused_update_select.launches = 0
    got = tfu.fused_update_select(*t_in, torch.as_tensor(scalars), tkp, c)
    assert tfu.fused_update_select.launches == 0  # the CPU runs the plain
    return got, want, t_in, tkp


def _scale(t_in, scalars, tkp):
    f, _, _, _, d_hi, d_lo, x_sq = t_in
    sc = torch.as_tensor(scalars)
    k_hi = kernel_from_dots(d_hi, x_sq, sc[2], tkp)
    k_lo = kernel_from_dots(d_lo, x_sq, sc[3], tkp)
    return (f.abs() + (sc[0] * k_hi).abs() + (sc[1] * k_lo).abs()).numpy()


def _bits(v):
    return np.asarray(v, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["rbf", "linear", "poly"])
@pytest.mark.parametrize("n_valid", [700, 1024])
def test_plain_matches_jax_kernel(kind, n_valid):
    c = 1.5
    arrays = _inputs(2048, n_valid, c)
    scalars = np.array([0.37, -0.21, 1.3, 0.8], np.float32)
    got, want, t_in, tkp = _run_both(arrays, scalars, kind, c, gamma=0.3,
                                     degree=2, coef0=0.5)
    g_f, j_f = got[0].numpy(), np.asarray(want[0])
    if kind == "linear":  # no transcendental: bit for bit
        np.testing.assert_array_equal(_bits(g_f), _bits(j_f))
        for g, w in zip(got[1:], want[1:]):
            assert _bits(g.numpy()) == _bits(w)
    else:
        tol = 4 * 2.0 ** -24 * _scale(t_in, scalars, tkp)
        assert np.all(np.abs(g_f - j_f) <= tol)
        assert float(got[1]) == pytest.approx(float(want[1]), rel=1e-6)
        assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-6)
    assert int(got[2]) == int(want[2]) and int(got[4]) == int(want[4])
    assert got[2].dtype == torch.int32 and got[1].dtype == torch.float32
    # The selection is exact on the port's own f'.
    own = tfu.reduce_candidates(*tfs.emit_row_candidates(
        got[0], t_in[1], t_in[2], t_in[3], c))
    assert all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b)
               for a, b in zip(got[1:], own))


def test_plain_matches_jax_with_class_weights():
    c = (2.0, 0.5)
    arrays = _inputs(4096, 3900, 0.5, seed=11)
    scalars = np.array([-0.8, 0.45, 0.0, 2.5], np.float32)
    got, want, _, _ = _run_both(arrays, scalars, "linear", c)
    np.testing.assert_array_equal(_bits(got[0].numpy()),
                                  _bits(np.asarray(want[0])))
    assert [int(got[2]), int(got[4])] == [int(want[2]), int(want[4])]
    assert _bits(got[1].numpy()) == _bits(want[1])
    assert _bits(got[3].numpy()) == _bits(want[3])


def test_tie_break_lowest_index_across_blocks():
    """Equal extrema in different blocks: the lowest flat id wins (the
    JAX test's case, f = 0 everywhere)."""
    n_pad = 16 * LANES
    zeros = np.zeros(n_pad, np.float32)
    arrays = (zeros, np.full(n_pad, 0.5, np.float32),
              np.ones(n_pad, np.float32), np.ones(n_pad, np.float32),
              zeros, zeros, zeros)
    got, want, _, _ = _run_both(arrays, np.zeros(4, np.float32), "linear",
                                1.0)
    assert int(got[2]) == int(want[2]) == 0
    assert int(got[4]) == int(want[4]) == 0


@pytest.mark.parametrize("first", [0.0, -0.0])
def test_signed_zero_tie(first):
    """A +-0 tie across blocks: the value is the IEEE minimum (-0.0) for
    b_hi and maximum (+0.0) for b_lo, the id the lowest flat id, in both
    packages."""
    n_pad = 16 * LANES
    f = np.ones(n_pad, np.float32)
    f[5] = first
    f[1500] = np.copysign(0.0, -np.copysign(1.0, first))  # the other zero
    arrays = (f, np.full(n_pad, 0.5, np.float32), np.ones(n_pad, np.float32),
              np.ones(n_pad, np.float32), *([np.zeros(n_pad, np.float32)] * 3))
    # -0.0 coefficients on zero kernel rows keep f' = f, signs included
    # (a +0.0 term would turn -0.0 into +0.0).
    scalars = np.array([-0.0, -0.0, 0.0, 0.0], np.float32)
    got, want, _, _ = _run_both(arrays, scalars, "linear", 1.0)
    assert int(got[2]) == int(want[2]) == 5
    assert _bits(got[1].numpy()) == _bits(want[1]) == _bits(-0.0)
    # I_low's max is 1.0; flip f to put the zeros on top of I_low.
    arrays = (-f,) + arrays[1:]
    got, want, _, _ = _run_both(arrays, scalars, "linear", 1.0)
    assert int(got[4]) == int(want[4]) == 5
    assert _bits(got[3].numpy()) == _bits(want[3]) == _bits(0.0)


def test_wrapper_validates_its_inputs():
    shp = (2, LANES)
    v = [torch.zeros(shp) for _ in range(7)]
    kp = KernelParams("rbf", 0.5)
    with pytest.raises(ValueError, match="scalars"):
        tfu.fused_update_select(*v, torch.zeros(3), kp, 1.0)
    with pytest.raises(ValueError, match="feature kernels"):
        tfu.fused_update_select(*v, torch.zeros(4),
                                KernelParams("precomputed"), 1.0)
    with pytest.raises(ValueError, match="views"):
        tfu.fused_update_select(*v[:6], torch.zeros((2, 64)),
                                torch.zeros(4), kp, 1.0)


SMS = 132  # the H100's streaming multiprocessors
SMEM_LIMIT = 232_448  # shared memory one block may have on sm_90


def _plan_ok(n: int) -> bool:
    """Kernel B6's launch for n elements (ops/fused_update.py
    fused_update_plan), as csrc/fused_update.cu maps it: thread t of block
    b takes the group of four b threads + t when it is below n / 4. Every
    group exactly once, no block without a group, the records within
    shared memory."""
    p = tfu.fused_update_plan(n)
    groups = n // 4
    grp = (np.arange(p.blocks)[:, None] * p.threads
           + np.arange(p.threads)).ravel()
    hits = np.bincount(grp[grp < groups], minlength=groups)
    first = np.arange(p.blocks) * p.threads  # each block's first group
    return (bool((hits == 1).all()) and bool((first < groups).all())
            and 32 <= p.threads <= 1024 and p.threads % 32 == 0
            and p.smem == 20 * (p.threads // 32) and p.smem <= SMEM_LIMIT)


# n_pad from 128 to 2^20 in steps of 128: every block edge.
@pytest.mark.parametrize("lo,hi", [(128, 16384), (16384, 131072),
                                   (131072, 262144), (262144, 393216),
                                   (393216, 786432), (786432, 2 ** 20 + 128)])
def test_fused_update_plan_covers_every_element_once(lo, hi):
    bad = [n for n in range(lo, hi, LANES) if not _plan_ok(n)]
    assert not bad, bad[:5]


def test_fused_update_plan_fills_the_card_at_the_headline():
    """At the per-pair headline's n_pad 65536 the grid is one wave of 128
    blocks of 128 threads, one group of four a thread: all but four of
    the 132 SMs stream (the block size measured fastest on the H100,
    ahead of the 64-thread blocks that reach every SM)."""
    p = tfu.fused_update_plan(65536)
    assert p.blocks * p.threads * 4 == 65536
    assert SMS - 4 <= p.blocks <= SMS
    with pytest.raises(ValueError, match="multiple of 4"):
        tfu.fused_update_plan(130)
