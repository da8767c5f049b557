"""nu-SVC and nu-SVR on the same SMO engine (counterpart of
dpsvm_tpu/models/nusvm.py).

The nu duals carry TWO equality constraints, one per (pseudo-)class, so
a pair update must stay inside a class: the trainers run the standard
solver with selection="nu" (per-class maximal violating pairs:
ops/select.py select_working_set_nu on the per-pair engine, per-class
quarters and kernel B1's nu rule on the block engine), from a feasible
warm start that fixes both constraint values, and read rho / r from the
final gradient as LibSVM does:

  nu-SVC  (box [0, 1], p = 0): per class, sum alpha = nu * n / 2. r1, r2
          are the free-SV averages of the gradient per class (the
          midpoint of the bound envelope where a class has no free SV);
          the solution is rescaled by r = (r1 + r2) / 2 so the margin is
          1: dual_coef = alpha * y / r, b = (r1 - r2) / 2 / r.
  nu-SVR  (2n expansion, p = [-z; z]): sum(alpha + alpha*) = C * n * nu,
          sum(alpha - alpha*) = 0. The tube width comes out as
          -(r1 + r2) / 2 and the offset b = (r1 - r2) / 2.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.models.svr import (SVRModel, expand_2n, refuse_precomputed,
                                        regressor)
from dpsvm_tpu_torch.ops.kernels import KernelParams, blocked_kernel_matvec
from dpsvm_tpu_torch.solver.result import SolveResult


def _warn_nu_fallbacks(config: SVMConfig, trainer: str) -> None:
    """The per-class selection keeps the PLAIN round body, so several
    fast paths a user may have configured do not run here. Name what was
    requested and what runs, once (the JAX package's text)."""
    dropped = []
    if config.ooc:
        dropped.append("ooc (in-core solve)" if not config.active_set_size
                       else "ooc + shrunken stream (in-core solve, no "
                            "shrinking)")
    if config.pair_batch > 1:
        dropped.append(f"pair_batch={config.pair_batch} "
                       "(single-pair updates)")
    if config.pipeline_rounds:
        dropped.append("pipeline_rounds (plain serial rounds)")
    if config.fused_fold:
        dropped.append("fused_fold (plain fold + select)")
    if config.fused_round:
        dropped.append("fused_round (plain round body)")
    if config.local_working_sets is not None \
            and config.local_working_sets >= 2:
        dropped.append("local_working_sets (global working set)")
    if config.ring_exchange:
        dropped.append("ring_exchange (all_gather exchange — the nu "
                       "rule's per-class quarters keep the psum path)")
    if dropped:
        import warnings

        warnings.warn(
            f"{trainer} runs selection='nu' (per-class pairing) on the "
            f"requested engine={config.engine!r}; the effective engine "
            f"falls back from: {'; '.join(dropped)}",
            stacklevel=3)


def _capped_fill(count: int, total: float, cap: float) -> np.ndarray:
    """LibSVM's warm-start walk: `cap` per slot in order until `total` is
    spent, the fractional remainder on the next slot."""
    return np.minimum(
        cap, np.maximum(0.0, total - np.arange(count) * cap)).astype(np.float32)


def _rho_r(f, alpha, y, c_cap, eps_box=1e-9):
    """(r1, r2) from the final state, per LibSVM's Solver_NU
    calculate_rho. grad_i = y_i * f_i. Per class: the mean gradient over
    free SVs; a class with none takes the midpoint of [max grad at the
    upper bound, min grad at the lower bound]."""
    grad = y * f
    out = []
    for cls in (y > 0, y < 0):
        free = cls & (alpha > eps_box) & (alpha < c_cap - eps_box)
        if free.any():
            out.append(float(grad[free].mean()))
        else:
            at_upper = cls & (alpha >= c_cap - eps_box)
            at_lower = cls & (alpha <= eps_box)
            lb = float(grad[at_upper].max()) if at_upper.any() else -np.inf
            ub = float(grad[at_lower].min()) if at_lower.any() else np.inf
            out.append((ub + lb) / 2.0)
    return out[0], out[1]


def _refuse_pallas(config: SVMConfig) -> None:
    if config.engine == "pallas":
        raise ValueError(
            "engine='pallas' does not implement the per-class nu "
            "selection; use engine='xla' (per-pair) or engine='block' "
            "(decomposition with per-class quarters)")


def _nu_config(config: SVMConfig, c: float) -> SVMConfig:
    """The solve's config: box C, no class weights, the nu rule, and the
    knobs the nu rule does not run reset (their fallback is named by
    _warn_nu_fallbacks)."""
    return config.replace(c=c, weight_pos=1.0, weight_neg=1.0,
                          selection="nu", pair_batch=1,
                          pipeline_rounds=None, ooc=False)


def train_nusvc(x, y, nu: float = 0.5, config: SVMConfig = SVMConfig(),
                backend: str = "auto", num_devices: Optional[int] = None,
                device=None, mesh=None, callback=None,
                checkpoint_path: Optional[str] = None,
                resume: bool = False) -> tuple[SVMModel, SolveResult]:
    """Train binary nu-SVC: nu in (0, 1] bounds the margin-error fraction
    from above and the SV fraction from below. config.c is ignored (the
    box is [0, 1] before rescaling); labels must be +-1. Runs on
    `device` (None: the CUDA card). `callback`, `checkpoint_path` and
    `resume` follow solver/solve.py solve's contract (the checkpoint
    holds this dual's unscaled state)."""
    from dpsvm_tpu_torch.train import host_device, resolve_backend, solve_on

    refuse_precomputed(config, "the nu-SVC dual rescales alpha")
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    n, d = x.shape
    pos_idx = np.nonzero(y > 0)[0]
    neg_idx = np.nonzero(y < 0)[0]
    if len(pos_idx) == 0 or len(neg_idx) == 0:
        raise ValueError("nu-SVC needs both classes present")
    if not 0.0 < nu <= 1.0:
        raise ValueError("nu must be in (0, 1]")
    # Each class must be able to absorb nu * n / 2 at alpha <= 1.
    if nu * n / 2.0 > min(len(pos_idx), len(neg_idx)) + 1e-12:
        raise ValueError("specified nu is infeasible")
    _refuse_pallas(config)
    _warn_nu_fallbacks(config, "train_nusvc")
    cfg = _nu_config(config, 1.0)
    backend = resolve_backend(backend, cfg, device, num_devices, mesh,
                              warm=True)

    half = nu * n / 2.0
    alpha0 = np.zeros((n,), np.float32)
    alpha0[pos_idx] = _capped_fill(len(pos_idx), half, 1.0)
    alpha0[neg_idx] = _capped_fill(len(neg_idx), half, 1.0)
    kp = KernelParams(config.kernel, config.resolve_gamma(d), config.degree,
                      config.coef0)
    # p = 0: the indicator is f = y * Q alpha = K @ (alpha * y).
    f_init = blocked_kernel_matvec(x, alpha0 * y, kp, config.dtype,
                                   device=host_device(backend, device, mesh))
    result = solve_on(backend, x, y, cfg, device, num_devices, mesh,
                      alpha_init=alpha0, f_init=f_init, callback=callback,
                      checkpoint_path=checkpoint_path, resume=resume)

    r1, r2 = _rho_r(result.stats["f"], result.alpha, y, 1.0)
    r = (r1 + r2) / 2.0
    if r <= 0:
        raise FloatingPointError(
            f"nu-SVC margin scale r={r} <= 0; solution degenerate "
            "(nu too large for this data?)")
    rho = (r1 - r2) / 2.0
    alpha_scaled = (result.alpha / r).astype(np.float32)
    mask = alpha_scaled > 0
    model = SVMModel(
        sv_x=np.ascontiguousarray(x[mask], np.float32),
        sv_alpha=alpha_scaled[mask],
        sv_y=y[mask].astype(np.int32),
        b=float(rho / r),  # decision = sum a y K - b
        kernel=kp)
    # The result stays self-consistent: alpha and b rebuild the model as
    # SVMModel.from_dense would, and f = y * Q alpha is linear in alpha,
    # so the same 1/r rescale keeps (alpha, f) a consistent pair.
    result.alpha = alpha_scaled
    result.b = model.b
    result.stats["f"] = (result.stats["f"] / r).astype(np.float32)
    result.stats["nu_r"] = r
    result.stats["nu_rho"] = rho
    return model, result


def train_nusvr(x, z, nu: float = 0.5, c: Optional[float] = None,
                config: SVMConfig = SVMConfig(), backend: str = "auto",
                num_devices: Optional[int] = None, device=None,
                mesh=None, callback=None,
                checkpoint_path: Optional[str] = None,
                resume: bool = False) -> tuple[SVRModel, SolveResult]:
    """Train nu-SVR: nu replaces epsilon-SVR's tube width (the tube
    adapts so that at most a nu fraction of points fall outside it).
    `c` defaults to config.c. Runs on `device` (None: the CUDA card).
    `callback`, `checkpoint_path` and `resume` follow solver/solve.py
    solve's contract (the checkpoint holds the 2n-variable dual)."""
    from dpsvm_tpu_torch.train import resolve_backend, solve_on

    refuse_precomputed(config, "nu-SVR doubles the variable set")
    x = np.asarray(x, np.float32)
    z = np.asarray(z, np.float32)
    n = x.shape[0]
    x2, y2 = expand_2n(x, z)
    if not 0.0 < nu <= 1.0:
        raise ValueError("nu must be in (0, 1]")
    C = float(config.c if c is None else c)
    # LibSVM's start (solve_nu_svr): alpha_i = alpha*_i walk C n nu / 2
    # down the rows. The symmetric start zeroes the K part of the
    # gradient, so f_init = y * p with p = [-z; z], i.e. [-z; -z].
    a = _capped_fill(n, C * n * nu / 2.0, C)
    alpha0 = np.concatenate([a, a])
    f_init = np.concatenate([-z, -z]).astype(np.float32)
    _refuse_pallas(config)
    _warn_nu_fallbacks(config, "train_nusvr")
    cfg = _nu_config(config, C)
    backend = resolve_backend(backend, cfg, device, num_devices, mesh,
                              warm=True)
    result = solve_on(backend, x2, y2, cfg, device, num_devices, mesh,
                      alpha_init=alpha0, f_init=f_init, callback=callback,
                      checkpoint_path=checkpoint_path, resume=resume)

    r1, r2 = _rho_r(result.stats["f"], result.alpha,
                    y2.astype(np.float32), C)
    b = (r1 - r2) / 2.0
    result.b = float(b)
    # Under grad = y * f the adaptive tube width is -(r1 + r2) / 2.
    result.stats["nu_tube_eps"] = -(r1 + r2) / 2.0
    coef = result.alpha[:n] - result.alpha[n:]
    return regressor(x, coef, b, config), result
