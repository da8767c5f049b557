"""Platt probability calibration, P(y=+1 | f) = 1 / (1 + exp(-(a f + b)))
(counterpart of dpsvm_tpu/models/platt.py; the fit and the probability
helpers are host NumPy and this module keeps its own copy of them).

The fit is the improved Platt algorithm (Newton's method with
backtracking on the regularized maximum-likelihood objective, after Lin
and Weng's note on Platt's algorithm) over decision values; a model
file carries the pair as prob_a / prob_b (models/svm_model.py).
"""

from __future__ import annotations

import numpy as np


def fit_platt(decision: np.ndarray, y: np.ndarray, max_iter: int = 100,
              tol: float = 1e-10) -> tuple[float, float]:
    """Fit (A, B) on decision values and +-1 labels.

    Uses the regularized targets t+ = (N+ + 1)/(N+ + 2), t- = 1/(N- + 2)
    so the fit is well-posed even when a class is tiny."""
    f = np.asarray(decision, np.float64)
    y = np.asarray(y)
    pos = y > 0
    n_pos = int(pos.sum())
    n_neg = int(len(y) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Platt calibration needs both classes present")
    t = np.where(pos, (n_pos + 1.0) / (n_pos + 2.0), 1.0 / (n_neg + 2.0))

    # Warm start: a plane whose p(f=0) is the (regularized) positive-class
    # prior. LibSVM's B0 = log((N-+1)/(N++1)) belongs to its
    # 1/(1+exp(Af+B)) form; under this module's p = sigmoid(a f + b) the
    # sign flips.
    a = 0.0
    b = np.log((n_pos + 1.0) / (n_neg + 1.0))

    def nll(a_, b_):
        z = a_ * f + b_
        # log(1 + e^z) - t*z, computed stably on both signs of z.
        return float(np.sum(np.logaddexp(0.0, z) - t * z))

    prev = nll(a, b)
    for _ in range(max_iter):
        z = a * f + b
        p = 1.0 / (1.0 + np.exp(-np.clip(z, -500, 500)))  # sigmoid(z)
        g_a = float(np.sum(f * (p - t)))
        g_b = float(np.sum(p - t))
        if abs(g_a) < tol and abs(g_b) < tol:
            break
        w = np.maximum(p * (1.0 - p), 1e-12)
        h_aa = float(np.sum(f * f * w)) + 1e-12
        h_ab = float(np.sum(f * w))
        h_bb = float(np.sum(w)) + 1e-12
        det = h_aa * h_bb - h_ab * h_ab
        da = -(h_bb * g_a - h_ab * g_b) / det
        db = -(-h_ab * g_a + h_aa * g_b) / det
        # Backtracking line search on the NLL.
        step = 1.0
        for _ in range(30):
            cand = nll(a + step * da, b + step * db)
            if cand < prev + 1e-4 * step * (g_a * da + g_b * db):
                a += step * da
                b += step * db
                prev = cand
                break
            step *= 0.5
        else:
            break
    return float(a), float(b)


def platt_probability(decision: np.ndarray, a: float, b: float) -> np.ndarray:
    """P(y=+1 | f) = sigmoid(a f + b), matching the fit's parameterization
    (classic Platt writes 1/(1+exp(A f + B)); that A is our -a)."""
    z = a * np.asarray(decision, np.float64) + b
    return 1.0 / (1.0 + np.exp(-np.clip(z, -500, 500)))


def platt_probability_matrix(decision: np.ndarray, ab) -> np.ndarray:
    """Per-column Platt probabilities for an (n, k) decision matrix —
    the multiclass layout decision_matrix / the serving engine produce.
    ``ab`` is a length-k sequence of (A, B) planes (one per column, the
    OvR calibration set estimators.SVC fits); one vectorized sigmoid
    replaces the per-column python loop."""
    dec = np.asarray(decision, np.float64)
    ab = np.asarray(ab, np.float64)
    if dec.ndim != 2 or ab.shape != (dec.shape[1], 2):
        raise ValueError(
            f"expected (n, k) decisions with k (A, B) rows; got "
            f"{dec.shape} and {ab.shape}")
    z = dec * ab[None, :, 0] + ab[None, :, 1]
    return 1.0 / (1.0 + np.exp(-np.clip(z, -500, 500)))


def fit_platt_cv(x, y_pm, config, backend: str = "auto",
                 num_devices=None, k: int = 5, seed=0, train_fn=None,
                 device=None) -> tuple[float, float]:
    """(A, B) from decision values on held-out folds, LibSVM-style: k-fold
    refits, so the calibration never sees its own training residuals
    (in-sample |f| is biased toward the margin). Shared by
    estimators.SVC and the CLI's -b 1. `seed` None gives fresh-entropy
    fold shuffles (sklearn's random_state=None); the default 0 keeps the
    CLI deterministic. `train_fn(x, y, config, backend=, num_devices=)
    -> (model, result)` refits another family (nu-SVC); the default is
    C-SVC train on `device` (None: the CUDA card)."""
    from dpsvm_tpu_torch.predict import decision_function
    from dpsvm_tpu_torch.train import train

    if train_fn is None:
        def train_fn(xf, yf, cfg, backend="auto", num_devices=None):
            return train(xf, yf, cfg, backend=backend, device=device,
                         num_devices=num_devices)
    x = np.asarray(x, np.float32)
    y_pm = np.asarray(y_pm)
    k = max(2, int(k))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y_pm))
    folds = np.array_split(perm, k)
    dec = np.empty(len(y_pm), np.float64)
    for i, held in enumerate(folds):
        tr = np.concatenate([f for j, f in enumerate(folds) if j != i])
        if len(np.unique(y_pm[tr])) < 2:
            raise ValueError(
                "probability calibration fold lost a class; lower the "
                "fold count or provide more data")
        m, _ = train_fn(x[tr], y_pm[tr], config, backend=backend,
                        num_devices=num_devices)
        dec[held] = decision_function(m, x[held], device=device)
    return fit_platt(dec, y_pm)
