"""Single-device block-engine solve (counterpart of the block branch of
dpsvm_tpu/solver/smo.py solve / _solve_impl)."""

from __future__ import annotations

import time

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.device import resolve_device, synchronize
from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_diag, squared_norms
from dpsvm_tpu_torch.ops.select import refresh_extrema_host
from dpsvm_tpu_torch.solver.block import BlockState, run_chunk_block
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.smo import eff_f, init_state

# budget_mode runs the stopping test at this epsilon: b_lo > b_hi + 2 eps
# then never closes, so the loop runs to exactly max_iter pairs; finite
# so b_hi + 2 eps stays inf-free.
_BUDGET_EPS = -1e30


def block_height(config: SVMConfig, n: int) -> tuple:
    """(q, inner): the working-set height clamped to the data and kept
    even (balanced up/low halves), and the per-round pair budget
    (inner_iters, or 2q when 0)."""
    q = max(2, min(config.working_set_size, n))
    q -= q % 2
    return q, config.inner_iters or 2 * q


def solve(x, y, config: SVMConfig, device=None) -> SolveResult:
    """Train binary C-SVC with the block engine on one device.

    `device=None` means the CUDA card (raises without one); pass
    device="cpu" for the plain PyTorch path. X is stored in
    config.dtype; the solver state (alpha, f) is float32. Rows are never
    padded on this path."""
    config.check_ported()
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y_np = np.asarray(y, np.int32)
    n, d = x.shape
    kp = KernelParams(config.kernel, config.resolve_gamma(d),
                      config.degree, config.coef0)
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
    x_dev = torch.as_tensor(x, device=dev).to(dtype)
    x_sq = squared_norms(x_dev)  # from the STORED (possibly rounded) rows
    k_diag = kernel_diag(x_sq, kp)
    y_dev = torch.as_tensor(y_np.astype(np.float32), device=dev)
    q, inner = block_height(config, n)
    alpha0, f0, b_hi0, b_lo0 = init_state(y_dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = BlockState(alpha0, f0, b_hi0, b_lo0, zero, zero,
                       torch.zeros_like(f0) if config.compensated else None)
    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    c = config.c_bounds()
    synchronize(dev)
    t0 = time.perf_counter()
    state = run_chunk_block(x_dev, y_dev, x_sq, k_diag, state,
                            int(config.max_iter), kp, c, eps_run,
                            float(config.tau), q, inner, config.selection)
    synchronize(dev)
    train_seconds = time.perf_counter() - t0
    it = int(state.pairs)
    b_hi = float(state.b_hi)
    b_lo = float(state.b_lo)
    converged = not (b_lo > b_hi + 2.0 * eps_run)
    alpha = state.alpha.cpu().numpy()
    f_final = eff_f(state).cpu().numpy()
    if not converged:
        # Budget exits report the stopping rule at the REAL epsilon on the
        # final state (the carried extrema are one fold behind).
        b_hi, b_lo, converged = refresh_extrema_host(
            f_final, alpha, y_np, c, config.epsilon, rule=config.selection)
    return SolveResult(
        alpha=alpha,
        b=float((b_lo + b_hi) / 2.0),
        b_hi=b_hi,
        b_lo=b_lo,
        iterations=it,
        converged=converged,
        train_seconds=train_seconds,
        stats={"f": f_final, "outer_rounds": int(state.rounds),
               "device": str(dev)},
    )
