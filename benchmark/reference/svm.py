"""The plain reference of binary C-SVC with the RBF kernel.

Written from the dual alone: K(a, b) = exp(-gamma |a - b|^2); the
gradient of the dual at alpha, in the solver's sign convention,
f_i = sum_j alpha_j y_j K_ij - y_i; I_up = {y = +1, alpha < C} u
{y = -1, alpha > 0}, I_low = {y = +1, alpha > 0} u {y = -1, alpha < C};
the KKT gap b_lo - b_hi = max_{I_low} f - min_{I_up} f, which the
stopping rule holds to 2 eps; the intercept b = (b_lo + b_hi) / 2 (for a
free support vector f_i = b); the decision of a model,
sum_j coef_j K(q, sv_j) - b.

Everything is computed in float64 from the benchmark's own inputs, in
blocks of rows so that it fits beside what is left on the card. With
``tf32=True`` the same arithmetic runs in float32 with TF32 products:
the lower precision of the control. Imports neither the JAX package nor
anything of the measured program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_BYTES = 1 << 30


def _kernel_block(xb, sv, sv_sq, gamma: float):
    xb_sq = (xb * xb).sum(1)
    d2 = xb_sq[:, None] + sv_sq[None, :] - 2.0 * (xb @ sv.t())
    return torch.exp(-gamma * d2.clamp_min(0.0))


def _weighted_sums(x, sv, weights, gamma: float, device, tf32: bool):
    """(K(x, sv) @ w for each w in weights, K(x, sv) @ |w0|) over the
    rows of x in blocks, in float64 (float32 with TF32 products when
    `tf32`)."""
    dt = torch.float32 if tf32 else torch.float64
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        svd = torch.as_tensor(np.asarray(sv), device=device).to(dt)
        sv_sq = (svd * svd).sum(1)
        ws = [torch.as_tensor(np.asarray(w, np.float64), device=device).to(dt)
              for w in weights]
        absw = ws[0].abs()
        rows = max(256, BLOCK_BYTES // (8 * max(1, svd.shape[0])))
        outs = [[] for _ in ws]
        scale = []
        for lo in range(0, x.shape[0], rows):
            xb = torch.as_tensor(np.asarray(x[lo:lo + rows]),
                                 device=device).to(dt)
            k = _kernel_block(xb, svd, sv_sq, gamma)
            for o, w in zip(outs, ws):
                o.append((k @ w).double().cpu())
            scale.append((k @ absw).double().cpu())
            del k, xb
        return ([torch.cat(o).numpy() for o in outs],
                torch.cat(scale).numpy())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gradient(x, y, alpha, gamma: float, device, tf32: bool = False):
    """(f, scale): the dual gradient f_i = sum_j alpha_j y_j K_ij - y_i at
    `alpha`, and the size of its terms, sum_j alpha_j K_ij + 1, by which
    a gap in f is judged."""
    alpha = np.asarray(alpha, np.float64)
    y = np.asarray(y, np.float64)
    sv = alpha > 0
    (s,), scale = _weighted_sums(x, np.asarray(x)[sv],
                                 [alpha[sv] * y[sv]], gamma, device, tf32)
    return s - y, scale + 1.0


def extremes(f, alpha, y, c: float) -> tuple:
    """(i_low, i_up): the row of I_low with the largest f (b_lo) and the
    row of I_up with the smallest (b_hi), for the gradient f at alpha
    (box [0, c])."""
    f = np.asarray(f, np.float64)
    alpha = np.asarray(alpha, np.float64)
    pos = np.asarray(y) > 0
    up = np.where(pos, alpha < c, alpha > 0)
    low = np.where(pos, alpha > 0, alpha < c)
    rows = np.arange(f.shape[0])
    return (int(rows[low][np.argmax(f[low])]),
            int(rows[up][np.argmin(f[up])]))


def kkt_gap(f, alpha, y, c: float) -> float:
    """b_lo - b_hi of the gradient f at alpha (box [0, c])."""
    lo, up = extremes(f, alpha, y, c)
    return float(f[lo] - f[up])


def intercept(f, scale, alpha, y, c: float) -> tuple:
    """(b, size): the intercept (b_lo + b_hi) / 2 of the gradient f at
    alpha, and the size of its terms, the mean of `scale` at the two
    rows that define it, by which a gap in b is judged."""
    lo, up = extremes(f, alpha, y, c)
    return (float((f[lo] + f[up]) / 2.0),
            float((scale[lo] + scale[up]) / 2.0))


def decisions(q, sv_x, coef, b: float, gamma: float, device,
              tf32: bool = False):
    """(dec, scale): the decisions sum_j coef_j K(q, sv_j) - b of the rows
    of q, and the size of their terms, sum_j |coef_j| K(q, sv_j) + |b|."""
    (s,), scale = _weighted_sums(q, sv_x, [np.asarray(coef, np.float64)],
                                 gamma, device, tf32)
    return s - b, scale + abs(b)


def model_of(x, y, alpha):
    """The support vectors a model of this solution holds, re-derived:
    (rows of x with alpha > 0, their alphas, their labels)."""
    alpha = np.asarray(alpha, np.float32)
    sv = alpha > 0
    return np.asarray(x)[sv], alpha[sv], np.asarray(y, np.int32)[sv]
