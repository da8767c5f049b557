"""Tests that need the CUDA card (marked `cuda`; they skip elsewhere).

The hand-written kernels have no CPU form, so they are held against
their plain PyTorch versions on the card. This file imports neither jax
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops import subproblem as tsub
from dpsvm_tpu_torch.ops.kernels import KernelParams, kernel_matrix
from dpsvm_tpu_torch.solver.block import select_block

C, EPS, TAU = 1.0, 1e-3, 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["mvp", "second_order"])
@pytest.mark.parametrize("q", [100, 256, 1500, 3000])
def test_subproblem_kernel_matches_plain(cuda, q, rule):
    """Kernel B1 against the plain version on the same CUDA tensors:
    same pair count; alpha within rtol 1e-6 / atol 1e-7 (bitwise is
    expected). q covers one, two and four slots per thread and an
    unaligned block."""
    x, y = make_blobs_binary(n=4000, d=10, seed=3, sep=1.2)
    rng = np.random.default_rng(0)
    alpha = np.clip(rng.normal(0.5, 0.5, len(y)), 0, C).astype(np.float32)
    xt = torch.as_tensor(x, device=cuda)
    K = kernel_matrix(xt, xt, KernelParams("rbf", 0.2))
    yt = torch.as_tensor(y.astype(np.float32), device=cuda)
    at = torch.as_tensor(alpha, device=cuda)
    f = (at * yt) @ K - yt
    w, ok, _, _ = select_block(f, at, yt, C, q)
    kb = K[w][:, w].contiguous()
    args = (kb, at[w], yt[w], f[w], torch.diagonal(K)[w].contiguous(),
            ok.float())
    lim = torch.tensor(2 * q, dtype=torch.int32, device=cuda)
    tsub.solve_subproblem.launches = 0
    a_k, t_k = tsub.solve_subproblem(*args, lim, C, EPS, TAU, rule=rule)
    torch.cuda.synchronize()
    assert tsub.solve_subproblem.launches == 1
    a_p, _, t_p = tsub._solve_subproblem(kb, args[4], ok, args[1], args[2],
                                         args[3], C, EPS, TAU, 2 * q, rule)
    assert int(t_k) == int(t_p) > 0
    np.testing.assert_allclose(a_k.cpu().numpy(), a_p.cpu().numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_solve_on_card_matches_cpu(cuda, dtype):
    """The whole solve on the card (kernel B1, cuBLAS folds) reaches the
    optimum of the CPU plain path: dual objective within rel 1e-4."""
    x, y = make_blobs_binary(n=1200, d=24, seed=11, sep=1.0)
    cfg = SVMConfig(c=1.0, gamma=0.1, engine="block", working_set_size=64,
                    dtype=dtype)
    tsub.solve_subproblem.launches = 0
    rg = solve(x, y, cfg)
    assert tsub.solve_subproblem.launches == rg.stats["outer_rounds"] > 0
    rc = solve(x, y, cfg, device="cpu")
    assert rg.converged and rc.converged

    def obj(r):
        a, f = r.alpha.astype(np.float64), r.stats["f"].astype(np.float64)
        return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))

    assert abs(obj(rg) - obj(rc)) <= 1e-4 * abs(obj(rc))
    assert abs(rg.n_sv - rc.n_sv) <= 0.02 * rc.n_sv
