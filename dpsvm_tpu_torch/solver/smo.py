"""SMO algebra shared by the port's engines (counterpart of the algebra
half of dpsvm_tpu/solver/smo.py: init_state, eff_f, kahan_add,
maybe_kahan, pair_alpha_update).

The operation order of every expression is the JAX package's, so the
elementwise steps agree bit for bit on identical float32 inputs.
"""

from __future__ import annotations

import torch


def init_state(y: torch.Tensor) -> tuple:
    """The C-SVC start point (alpha, f, b_hi, b_lo): alpha = 0, f = -y,
    and extrema that read as an open gap so the first round always
    runs."""
    dev = y.device
    return (torch.zeros_like(y, dtype=torch.float32),
            (-y).float(),
            torch.tensor(-float("inf"), dtype=torch.float32, device=dev),
            torch.tensor(float("inf"), dtype=torch.float32, device=dev))


def eff_f(state):
    """The best estimate of the true gradient: f minus the Kahan residual
    when compensation is on."""
    return state.f if state.f_err is None else state.f - state.f_err


def kahan_add(f, err, delta):
    """One compensated (Kahan) accumulation step: returns the new (f, err)
    with true_sum ~= f - err."""
    y_v = delta - err
    t = f + y_v
    return t, (t - f) - y_v


def maybe_kahan(f, err, delta):
    """Plain add when compensation is off (err is None), Kahan otherwise."""
    if err is None:
        return f + delta, None
    return kahan_add(f, err, delta)


def pair_alpha_update(a_hi_old, a_lo_old, y_hi, y_lo, b_hi_pair, b_lo_pair,
                      eta, c_hi, c_lo=None, gate=None):
    """The alpha-pair algebra: returns (a_hi_new, a_lo_new).

    a_lo is clipped to the joint feasible segment [L, H] (box intersected
    with the equality-constraint line), snapped to the box bounds within
    1e-6 * C, and a_hi is derived from it so sum(alpha * y) is conserved.
    `c_hi`/`c_lo` are Python floats (equal class weights: the snap
    constants are then computed in double and rounded once, as the JAX
    package does) or float32 tensors. `gate` (bool tensor) forces a
    no-op when False; non-finite pair values are always gated out."""
    if c_lo is None:
        c_lo = c_hi
    ok = torch.isfinite(b_hi_pair) & torch.isfinite(b_lo_pair)
    if gate is not None:
        ok = ok & gate
    s = y_hi * y_lo
    w = a_hi_old + s * a_lo_old
    lo_bound = torch.where(s > 0, torch.clamp(w - c_hi, min=0.0),
                           torch.clamp(-w, min=0.0))
    hi_bound = torch.where(s > 0, torch.clamp(w, max=c_lo),
                           torch.clamp(c_hi - w, max=c_lo))
    a_lo_new = torch.clamp(a_lo_old + y_lo * (b_hi_pair - b_lo_pair) / eta,
                           min=lo_bound, max=hi_bound)
    snap_lo = 1e-6 * c_lo
    snap_hi = 1e-6 * c_hi
    a_lo_new = torch.where(a_lo_new < snap_lo, 0.0,
                           torch.where(a_lo_new > c_lo - snap_lo, c_lo,
                                       a_lo_new))
    a_hi_new = torch.clamp(a_hi_old + s * (a_lo_old - a_lo_new),
                           min=0.0).clamp(max=c_hi)
    a_hi_new = torch.where(a_hi_new < snap_hi, 0.0,
                           torch.where(a_hi_new > c_hi - snap_hi, c_hi,
                                       a_hi_new))
    a_lo_new = torch.where(ok, a_lo_new, a_lo_old)
    a_hi_new = torch.where(ok, a_hi_new, a_hi_old)
    return a_hi_new, a_lo_new
