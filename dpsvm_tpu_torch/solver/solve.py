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
from dpsvm_tpu_torch.solver import block
from dpsvm_tpu_torch.solver.block import BlockState
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


def choose_engine(config: SVMConfig, n: int, dev: torch.device) -> dict:
    """Which block engine runs, as the JAX package's solve picks it
    (solver/smo.py): pipeline_rounds first, then fused_round, then
    fused_fold, each only when its knob is True; None (auto) stays off
    on every device until an H100 measurement decides a gate. The fused
    engines, and the pipelined engine's one-pass selection (on CUDA
    only, as the JAX package takes it on the TPU only), need q/2 <=
    n_pad/128 with n_pad = n rounded up to 1024; where that fails the
    plain engine runs. Returns the flags under the JAX package's stats
    names and n_pad."""
    n_pad_fused = -(-n // 1024) * 1024
    shape_ok = (min(config.working_set_size, n_pad_fused)
                <= n_pad_fused // 64)
    pipelined = bool(config.pipeline_rounds)
    pipe_select = pipelined and dev.type == "cuda" and shape_ok
    fused_round = not pipelined and bool(config.fused_round) and shape_ok
    fused_fold = (not pipelined and not fused_round
                  and bool(config.fused_fold) and shape_ok)
    pad = fused_fold or fused_round or pipe_select
    return {"pipelined": pipelined, "pipe_select": pipe_select,
            "fused_round": fused_round, "fused_fold": fused_fold,
            "pad": pad, "n_pad": n_pad_fused if pad else n}


def solve(x, y, config: SVMConfig, device=None) -> SolveResult:
    """Train binary C-SVC with the block engine on one device.

    `device=None` means the CUDA card (raises without one); pass
    device="cpu" for the plain PyTorch path. X is stored in
    config.dtype; the solver state (alpha, f) is float32. The fused
    engines pad the rows to a multiple of 1024 (padded rows: y = 1,
    alpha = 0, f = -1, zero features, masked out of every selection);
    alpha and f come back trimmed to n."""
    config.check_ported()
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    y_np = np.asarray(y, np.int32)
    n, d = x.shape
    kp = KernelParams(config.kernel, config.resolve_gamma(d),
                      config.degree, config.coef0)
    eng = choose_engine(config, n, dev)
    n_pad = eng["n_pad"]
    x_p, y_p, valid = x, y_np.astype(np.float32), None
    if eng["pad"]:
        x_p = np.zeros((n_pad, d), np.float32)
        x_p[:n] = x
        y_p = np.ones((n_pad,), np.float32)
        y_p[:n] = y_np
        valid = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        valid[:n] = True
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
    x_dev = torch.as_tensor(x_p, device=dev).to(dtype)
    x_sq = squared_norms(x_dev)  # from the STORED (possibly rounded) rows
    k_diag = kernel_diag(x_sq, kp)
    y_dev = torch.as_tensor(y_p, device=dev)
    q, inner = block_height(config, n_pad)
    alpha0, f0, b_hi0, b_lo0 = init_state(y_dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    state = BlockState(alpha0, f0, b_hi0, b_lo0, zero, zero,
                       torch.zeros_like(f0) if config.compensated else None)
    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    c = config.c_bounds()
    synchronize(dev)
    t0 = time.perf_counter()
    args = (x_dev, y_dev, x_sq, k_diag)
    rest = (int(config.max_iter), kp, c, eps_run, float(config.tau), q,
            inner, config.selection)
    if eng["pipelined"]:
        state = block.run_chunk_block_pipelined(
            *args, valid, state, *rest, pallas_select=eng["pipe_select"])
    elif eng["fused_round"]:
        state = block.run_chunk_block_fusedround(*args, valid, state, *rest)
    elif eng["fused_fold"]:
        state = block.run_chunk_block_fused(*args, valid, state, *rest)
    else:
        state = block.run_chunk_block(*args, state, *rest)
    synchronize(dev)
    train_seconds = time.perf_counter() - t0
    it = int(state.pairs)
    b_hi = float(state.b_hi)
    b_lo = float(state.b_lo)
    converged = not (b_lo > b_hi + 2.0 * eps_run)
    alpha = state.alpha[:n].cpu().numpy()
    f_final = eff_f(state)[:n].cpu().numpy()
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
               "device": str(dev), "n_pad": n_pad,
               **{k: eng[k] for k in ("pipelined", "fused_fold",
                                      "fused_round")}},
    )
