"""The host backends (counterpart of dpsvm_tpu/solver/reference.py):
``smo_reference``, the pure-NumPy sequential modified SMO (Keerthi et
al. "modification 2", the global most-violating pair) that
backend="reference" runs; ``smo_native``, the same algorithm compiled
(native/seqsmo.cpp) that backend="native" runs; and ``duality_gap``.

The NumPy algebra is the JAX package's step for step, so both packages'
host backends give the same iterates on the same inputs.
"""

from __future__ import annotations

import time

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver.result import SolveResult


def _kernel_row_np(x: np.ndarray, x_sq: np.ndarray, i: int, p: KernelParams) -> np.ndarray:
    dots = x @ x[i]
    if p.kind == "linear":
        return dots.astype(np.float32)
    if p.kind == "rbf":
        sq = np.maximum(x_sq + x_sq[i] - 2.0 * dots, 0.0)
        return np.exp(-p.gamma * sq).astype(np.float32)
    if p.kind == "poly":
        return ((p.gamma * dots + p.coef0) ** p.degree).astype(np.float32)
    if p.kind == "sigmoid":
        return np.tanh(p.gamma * dots + p.coef0).astype(np.float32)
    raise ValueError(p.kind)


def smo_reference(
    x: np.ndarray,
    y: np.ndarray,
    config: SVMConfig,
    full_gram_limit: int = 6000,
) -> SolveResult:
    """Train binary C-SVC by sequential modified SMO (NumPy, host).

    For n <= full_gram_limit the Gram matrix is precomputed; above that,
    kernel rows are evaluated on demand."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    n = x.shape[0]
    gamma = config.resolve_gamma(x.shape[1])
    p = KernelParams(config.kernel, gamma, config.degree, config.coef0)
    eps = np.float32(config.epsilon)
    c_pos, c_neg = config.c_bounds()
    cp = np.float32(c_pos)
    cn = np.float32(c_neg)
    c_arr = np.where(y > 0, cp, cn).astype(np.float32)

    x_sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    gram = None
    if n <= full_gram_limit:
        dots = (x @ x.T).astype(np.float32)
        if p.kind == "linear":
            gram = dots
        elif p.kind == "rbf":
            sq = np.maximum(x_sq[:, None] + x_sq[None, :] - 2.0 * dots, 0.0)
            gram = np.exp(-p.gamma * sq).astype(np.float32)
        elif p.kind == "poly":
            gram = ((p.gamma * dots + p.coef0) ** p.degree).astype(np.float32)
        elif p.kind == "sigmoid":
            gram = np.tanh(p.gamma * dots + p.coef0).astype(np.float32)

    def row(i: int) -> np.ndarray:
        if gram is not None:
            return gram[i]
        return _kernel_row_np(x, x_sq, i, p)

    alpha = np.zeros(n, np.float32)
    f = (-y).astype(np.float32)  # f_i = -y_i at alpha = 0

    yp = y > 0
    t0 = time.perf_counter()
    it = 0
    b_hi = np.float32(0.0)
    b_lo = np.float32(0.0)
    empty_iset = False
    while it < config.max_iter:
        up = np.where(yp, alpha < c_arr, alpha > 0)
        low = np.where(yp, alpha > 0, alpha < c_arr)
        if not up.any() or not low.any():
            # Degenerate I-set (single-class data, extreme class-weight/C
            # corners): no feasible ascent pair exists, so the current
            # iterate is optimal (native/seqsmo.cpp breaks the same way).
            empty_iset = True
            break
        f_up = np.where(up, f, np.inf)
        f_low = np.where(low, f, -np.inf)
        i_hi = int(np.argmin(f_up))
        i_lo = int(np.argmax(f_low))
        b_hi = f[i_hi]
        b_lo = f[i_lo]

        k_hi = row(i_hi)
        k_lo = row(i_lo)
        eta = k_hi[i_hi] + k_lo[i_lo] - 2.0 * k_hi[i_lo]
        eta = max(float(eta), config.tau)  # LibSVM-style clamp

        y_hi = np.float32(y[i_hi])
        y_lo = np.float32(y[i_lo])
        a_hi_old = alpha[i_hi]
        a_lo_old = alpha[i_lo]
        # Pair update with the joint [L, H] clip (solver/smo.py
        # pair_alpha_update). c_hi/c_lo are the per-variable box bounds
        # (class-weighted C).
        c_hi = c_arr[i_hi]
        c_lo = c_arr[i_lo]
        s = y_hi * y_lo
        w = a_hi_old + s * a_lo_old
        if s > 0:
            lo_b, hi_b = max(np.float32(0.0), w - c_hi), min(c_lo, w)
        else:
            lo_b, hi_b = max(np.float32(0.0), -w), min(c_lo, c_hi - w)
        a_lo_new = np.float32(np.clip(a_lo_old + y_lo * (b_hi - b_lo) / eta, lo_b, hi_b))
        # Bound snap (solver/smo.py pair_alpha_update); a_lo snaps BEFORE
        # a_hi is derived from it so conservation survives the snap.
        snap_lo = np.float32(1e-6) * c_lo
        snap_hi = np.float32(1e-6) * c_hi
        if a_lo_new < snap_lo:
            a_lo_new = np.float32(0.0)
        elif a_lo_new > c_lo - snap_lo:
            a_lo_new = c_lo
        a_hi_new = np.float32(np.clip(a_hi_old + s * (a_lo_old - a_lo_new), 0.0, c_hi))
        if a_hi_new < snap_hi:
            a_hi_new = np.float32(0.0)
        elif a_hi_new > c_hi - snap_hi:
            a_hi_new = c_hi
        alpha[i_lo] = a_lo_new
        alpha[i_hi] = a_hi_new

        f += (a_hi_new - a_hi_old) * y_hi * k_hi + (a_lo_new - a_lo_old) * y_lo * k_lo
        it += 1
        # do-while: test AFTER the update.
        if not (b_lo > b_hi + 2.0 * eps):
            break

    # On the empty-I-set break b_hi/b_lo are the PREVIOUS iteration's
    # (pre-update) envelope, whose gap may still read open — but the break
    # itself certifies optimality (the true gap is -inf).
    converged = empty_iset or not (b_lo > b_hi + 2.0 * eps)
    return SolveResult(
        alpha=alpha,
        b=float((b_lo + b_hi) / 2.0),
        b_hi=float(b_hi),
        b_lo=float(b_lo),
        iterations=it,
        converged=converged,
        train_seconds=time.perf_counter() - t0,
        stats={"f": f},
    )


def smo_native(x: np.ndarray, y: np.ndarray, config: SVMConfig) -> SolveResult:
    """Train with the native C++ sequential engine (native/seqsmo.cpp),
    the compiled counterpart of ``smo_reference``. Raises RuntimeError if
    it cannot be built (no g++); ``smo_reference`` always runs."""
    from dpsvm_tpu_torch.utils.native import build_errors, get_seqsmo

    eng = get_seqsmo()
    if eng is None:
        raise RuntimeError(
            "native seqsmo engine unavailable (g++ missing or build "
            f"failed: {build_errors.get('seqsmo')}); use "
            "backend='reference' for the NumPy oracle")
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    gamma = config.resolve_gamma(x.shape[1])
    t0 = time.perf_counter()
    c_pos, c_neg = config.c_bounds()
    alpha, f, b, b_hi, b_lo, it, converged = eng.train(
        x, y, c=c_pos, c_neg=c_neg, gamma=gamma, epsilon=config.epsilon,
        tau=max(config.tau, 1e-20), max_iter=config.max_iter,
        kernel=config.kernel, degree=config.degree, coef0=config.coef0)
    return SolveResult(
        alpha=alpha, b=b, b_hi=b_hi, b_lo=b_lo, iterations=it,
        converged=converged, train_seconds=time.perf_counter() - t0,
        stats={"f": f, "engine": "native-seqsmo"},
    )


def duality_gap(alpha, y, f, c, b) -> float:
    """The duality-gap invariant of the reference's formulation:
    sum_i alpha_i y_i f_i + C sum_i slack_i; approaches ~0 at
    convergence."""
    alpha = np.asarray(alpha, np.float64)
    y = np.asarray(y, np.float64)
    f = np.asarray(f, np.float64)
    slack = np.where(y > 0, np.maximum(0.0, b - f), np.maximum(0.0, f - b))
    return float(np.sum(alpha * y * f) + c * np.sum(slack))
