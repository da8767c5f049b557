"""Kernel primitives, set masks, stopping extrema and the SMO pair algebra
of the port against the JAX package on identical numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.ops import kernels as jk
from dpsvm_tpu.ops import select as jsel
from dpsvm_tpu.solver import smo as jsmo
from dpsvm_tpu_torch.ops import kernels as tk
from dpsvm_tpu_torch.ops import select as tsel
from dpsvm_tpu_torch.solver import smo as tsmo

KERNELS = [("rbf", 0.3, 3, 0.0), ("linear", 1.0, 3, 0.0),
           ("poly", 0.2, 3, 0.5), ("sigmoid", 0.1, 3, 0.25)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _features(dtype):
    """Non-negative rows and coef0 >= 0 (no cancellation in the dots or in
    gamma * dot + coef0), stored in `dtype`:
    both packages see the same rounded values."""
    rng = np.random.default_rng(4)
    x = rng.random((40, 12)).astype(np.float32)
    q = rng.random((6, 12)).astype(np.float32)
    if dtype == "bfloat16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        q = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    return x, q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,gamma,degree,coef0", KERNELS)
def test_kernel_rows_match_jax(kind, gamma, degree, coef0, dtype):
    x, q = _features(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jkp = jk.KernelParams(kind, gamma, degree, coef0)
    tkp = tk.KernelParams(kind, gamma, degree, coef0)
    jx, jq = jnp.asarray(x, jdt), jnp.asarray(q, jdt)
    tx, tq = torch.as_tensor(x).to(tdt), torch.as_tensor(q).to(tdt)

    j_sq = np.array(jk.squared_norms(jx))
    t_sq = tk.squared_norms(tx).numpy()
    np.testing.assert_allclose(t_sq, j_sq, rtol=1e-6)
    j_qsq = jk.squared_norms(jq)
    t_qsq = tk.squared_norms(tq)

    j_rows = np.asarray(jk.kernel_rows(jx, jnp.asarray(j_sq), jq, j_qsq, jkp))
    t_rows = tk.kernel_rows(tx, t_sq_t := tk.squared_norms(tx), tq, t_qsq,
                            tkp).numpy()
    assert t_rows.shape == j_rows.shape == (6, 40)
    assert t_rows.dtype == np.float32
    np.testing.assert_allclose(t_rows, j_rows, rtol=1e-6)
    # One query row (1-D path) and the diagonal.
    j_row = np.asarray(jk.kernel_rows(jx, jnp.asarray(j_sq), jq[0],
                                      j_qsq[0], jkp))
    t_row = tk.kernel_rows(tx, t_sq_t, tq[0], t_qsq[0], tkp).numpy()
    np.testing.assert_allclose(t_row, j_row, rtol=1e-6)
    np.testing.assert_allclose(
        tk.kernel_diag(t_sq_t, tkp).numpy(),
        np.asarray(jk.kernel_diag(jnp.asarray(j_sq), jkp)), rtol=1e-6)
    # Same dots in: kernel_from_dots is elementwise with the same
    # operation order, so the values agree to the last ulps. Not bit for
    # bit: exp, tanh and pow are not correctly rounded, and XLA and torch
    # use different approximations of them (up to 3 ulps seen for tanh),
    # hence the float32 rtol of 1e-6.
    dots = np.array(jk.row_dots(jx, jq))
    t_k = tk.kernel_from_dots(torch.as_tensor(dots), torch.as_tensor(j_sq),
                              torch.as_tensor(np.array(j_qsq)), tkp).numpy()
    j_k = np.asarray(jk.kernel_from_dots(jnp.asarray(dots),
                                         jnp.asarray(j_sq), j_qsq, jkp))
    np.testing.assert_allclose(t_k, j_k, rtol=1e-6)
    np.testing.assert_allclose(
        tk.kernel_matrix(torch.as_tensor(q), torch.as_tensor(x), tkp).numpy(),
        np.asarray(jk.kernel_matrix(jnp.asarray(q), jnp.asarray(x), jkp)),
        rtol=1e-6)


def _state(seed, n, c):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    alpha = rng.choice([0.0, c, 0.25 * c, 0.9 * c], size=n).astype(np.float32)
    f = rng.normal(size=n).astype(np.float32)
    return alpha, y, f


@pytest.mark.parametrize("c", [2.0, (3.0, 0.7)])
def test_masks_and_extrema_bitwise(c):
    alpha, y, f = _state(5, 300, 2.0)
    cp, cn = tsel.split_c(c)
    ta, ty, tf = map(torch.as_tensor, (alpha, y, f))
    ja, jy, jf = map(jnp.asarray, (alpha, y, f))
    np.testing.assert_array_equal(tsel.up_mask(ta, ty, cp, cn).numpy(),
                                  np.asarray(jsel.up_mask(ja, jy, cp, cn)))
    np.testing.assert_array_equal(tsel.low_mask(ta, ty, cp, cn).numpy(),
                                  np.asarray(jsel.low_mask(ja, jy, cp, cn)))
    valid = np.arange(300) < 280
    for v in (None, valid):
        t_ext = tsel.stopping_extrema(tf, ta, ty, c, None if v is None
                                      else torch.as_tensor(v))
        j_ext = jsel.stopping_extrema(jf, ja, jy, c, None if v is None
                                      else jnp.asarray(v))
        for t_v, j_v in zip(t_ext, j_ext):
            np.testing.assert_array_equal(_bits(t_v.numpy()), _bits(j_v))
    assert tsel.extrema_np(f, alpha, y, c) == jsel.extrema_np(f, alpha, y, c)
    for eps in (1e-3, 10.0):
        assert (tsel.refresh_extrema_host(f, alpha, y, c, eps)
                == jsel.refresh_extrema_host(f, alpha, y, c, eps))


def _pair_sweep(c, n=4000):
    """Pair-update inputs covering the bound, equal-label, opposite-label
    and gated cases, at and next to the box edges."""
    rng = np.random.default_rng(11)
    cp, cn = c if isinstance(c, tuple) else (c, c)
    y_hi = rng.choice([-1.0, 1.0], n).astype(np.float32)
    y_lo = rng.choice([-1.0, 1.0], n).astype(np.float32)
    c_hi = np.where(y_hi > 0, cp, cn).astype(np.float32)
    c_lo = np.where(y_lo > 0, cp, cn).astype(np.float32)

    def alphas(cb):
        pick = rng.integers(0, 5, n)
        edge = np.nextafter(cb, np.float32(0.0))
        return np.choose(pick, [np.zeros(n, np.float32), cb, edge,
                                (rng.random(n) * cb).astype(np.float32),
                                np.full(n, 1e-9, np.float32)]).astype(np.float32)

    a_hi, a_lo = alphas(c_hi), alphas(c_lo)
    b_hi = rng.normal(size=n).astype(np.float32)
    b_lo = (b_hi + rng.normal(size=n) * 2).astype(np.float32)
    b_hi[::97] = np.inf  # empty-set sentinels must gate out
    b_lo[::89] = -np.inf
    eta = np.where(rng.random(n) < 0.1, np.float32(1e-12),
                   rng.random(n) * 2).astype(np.float32)
    gate = rng.random(n) < 0.8
    return a_hi, a_lo, y_hi, y_lo, b_hi, b_lo, eta, gate


@pytest.mark.parametrize("c", [1.0, 10.0, (3.0, 0.7)])
def test_pair_alpha_update_bitwise(c):
    a_hi, a_lo, y_hi, y_lo, b_hi, b_lo, eta, gate = _pair_sweep(c)
    cp, cn = c if isinstance(c, tuple) else (c, c)
    args = (a_hi, a_lo, y_hi, y_lo, b_hi, b_lo, eta)
    j_out = jsmo.pair_alpha_update(
        *map(jnp.asarray, args), jsel.c_of(jnp.asarray(y_hi), cp, cn),
        jsel.c_of(jnp.asarray(y_lo), cp, cn), gate=jnp.asarray(gate))
    t_args = [torch.as_tensor(a) for a in args]
    t_out = tsmo.pair_alpha_update(
        *t_args, tsel.c_of(t_args[2], cp, cn), tsel.c_of(t_args[3], cp, cn),
        gate=torch.as_tensor(gate))
    for t_v, j_v in zip(t_out, j_out):
        np.testing.assert_array_equal(_bits(t_v.numpy()), _bits(j_v))
    # The sweep really reaches every case: updates taken and gated,
    # results snapped to both bounds and left interior.
    moved = t_out[1].numpy() != a_lo
    assert moved.any() and (~moved & ~gate).any()
    assert (t_out[1].numpy() == 0).any()
    assert np.isin(t_out[1].numpy(), [cp, cn]).any()


def test_kahan_add_bitwise():
    rng = np.random.default_rng(3)
    f = (rng.normal(size=1000) * 100).astype(np.float32)
    err = (rng.normal(size=1000) * 1e-5).astype(np.float32)
    delta = (rng.normal(size=1000) * 1e-3).astype(np.float32)
    j_out = jsmo.kahan_add(*map(jnp.asarray, (f, err, delta)))
    t_out = tsmo.kahan_add(*map(torch.as_tensor, (f, err, delta)))
    for t_v, j_v in zip(t_out, j_out):
        np.testing.assert_array_equal(_bits(t_v.numpy()), _bits(j_v))
    t_plain = tsmo.maybe_kahan(torch.as_tensor(f), None, torch.as_tensor(delta))
    assert t_plain[1] is None
    np.testing.assert_array_equal(t_plain[0].numpy(), f + delta)


def test_init_state_and_eff_f():
    y = torch.tensor([1.0, -1.0, 1.0])
    alpha, f, b_hi, b_lo = tsmo.init_state(y)
    assert alpha.tolist() == [0.0, 0.0, 0.0]
    assert f.tolist() == [-1.0, 1.0, -1.0]
    assert float(b_hi) == -np.inf and float(b_lo) == np.inf

    class S:
        pass

    s = S()
    s.f, s.f_err = f, None
    assert tsmo.eff_f(s) is f
    s.f_err = torch.full_like(f, 0.5)
    assert tsmo.eff_f(s).tolist() == [-1.5, 0.5, -1.5]


def _bf16_warnings(fn):
    import warnings

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in rec
            if "destroy solution quality" in str(w.message)]


def test_bf16_quality_warning_matches_jax():
    """Fault C.18: dtype="bfloat16" where storage rounding is likely to
    destroy the solution warns in the port too, with the JAX package's
    text, from solve and from solve_mesh (covtype-shaped probe, c=1000,
    gamma=0.1, block engine, 500 pairs)."""
    from dpsvm_tpu.config import SVMConfig as JaxConfig
    from dpsvm_tpu.data.synth import make_covtype_like
    from dpsvm_tpu.solver.smo import solve as jax_solve
    from dpsvm_tpu_torch import Mesh, SVMConfig, solve, solve_mesh

    x, y = make_covtype_like(2000, seed=0)
    kw = dict(c=1000.0, gamma=0.1, dtype="bfloat16", engine="block",
              max_iter=500)
    jw = _bf16_warnings(lambda: jax_solve(x, y, JaxConfig(**kw)))
    tw = _bf16_warnings(lambda: solve(x, y, SVMConfig(**kw), device="cpu"))
    assert len(jw) == 1 and tw == jw
    assert "C * p90|dK| = 0.375 > 0.1" in tw[0]
    mw = _bf16_warnings(lambda: solve_mesh(
        x[:400], y[:400], SVMConfig(**{**kw, "max_iter": 50}),
        mesh=Mesh(["cpu"] * 2)))
    assert len(mw) == 1
    # float32 storage, or a small C, does not warn.
    assert not _bf16_warnings(lambda: solve(
        x[:400], y[:400], SVMConfig(**{**kw, "dtype": "float32",
                                       "max_iter": 50}), device="cpu"))
    assert not _bf16_warnings(lambda: solve(
        x[:400], y[:400], SVMConfig(**{**kw, "c": 1.0, "max_iter": 50}),
        device="cpu"))


@pytest.mark.parametrize("kind,gamma,degree,coef0", KERNELS)
def test_bf16_perturbation_and_gate_are_jaxs(kind, gamma, degree, coef0):
    """The probes behind the guard: the same sampled pairs and the same
    bf16 rounding (round to nearest even) give the same p90, and the
    bf16-Gram gate the same verdict and note."""
    from dpsvm_tpu.config import SVMConfig as JaxConfig
    from dpsvm_tpu_torch import SVMConfig

    x = np.random.default_rng(9).normal(size=(300, 7)).astype(np.float32)
    jkp = jk.KernelParams(kind, gamma, degree, coef0)
    tkp = tk.KernelParams(kind, gamma, degree, coef0)
    assert tk.bf16_kernel_perturbation(x, tkp, sample=200, pairs=500) == \
        jk.bf16_kernel_perturbation(x, jkp, sample=200, pairs=500)
    for c in (1.0, 1e4):
        cfg = dict(c=c, kernel=kind, degree=degree, coef0=coef0)
        assert tk.resolve_bf16_gram(x, SVMConfig(**cfg), gamma) == \
            jk.resolve_bf16_gram(x, JaxConfig(**cfg), gamma)
    assert tk.BF16_RISK_THRESHOLD == jk.BF16_RISK_THRESHOLD
