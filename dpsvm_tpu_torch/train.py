"""High-level training API: data in, SVMModel out (counterpart of
dpsvm_tpu/train.py, the single-device and mesh backends)."""

from __future__ import annotations

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.solve import solve


def resolve_backend(backend: str, config: SVMConfig, device=None,
                    num_devices=None, mesh=None, warm: bool = False) -> str:
    """"single" or "mesh" for a `backend` request. "auto" takes the mesh
    when one is given, or when no `device` is named and more than one
    card is visible (or asked for), and only where the mesh runs the
    request: engine="block" with a cold start (`warm` False; the mesh
    runs no warm start and no nu rule). Otherwise the single device. An
    explicit "mesh" stands: solve_mesh refuses what the mesh does not
    run."""
    if backend == "auto":
        import torch

        multi = (device is None
                 and (num_devices or torch.cuda.device_count()) > 1)
        # The mesh runs the block engine only; auto must not swap a
        # per-pair request for another engine.
        backend = ("mesh" if (multi or mesh is not None)
                   and config.engine == "block" and not warm else "single")
    if backend not in ("single", "mesh"):
        raise NotImplementedError(
            f"backend={backend!r} is not ported; use 'single', 'mesh' or "
            "'auto'")
    return backend


def solve_on(backend: str, x, y, config: SVMConfig, device=None,
             num_devices=None, mesh=None, alpha_init=None,
             f_init=None) -> SolveResult:
    """Run the solve on a resolved backend ("single" or "mesh")."""
    if backend == "mesh":
        from dpsvm_tpu_torch.parallel.dist_smo import solve_mesh

        return solve_mesh(x, y, config, num_devices=num_devices, mesh=mesh,
                          alpha_init=alpha_init, f_init=f_init)
    return solve(x, y, config, device=device, alpha_init=alpha_init,
                 f_init=f_init)


def train(x, y, config: SVMConfig = SVMConfig(), backend: str = "auto",
          device=None, num_devices=None,
          mesh=None) -> tuple[SVMModel, SolveResult]:
    """Train binary C-SVC with the engine config.engine names. Labels
    must be in {-1, +1}.

    backend "single" runs on `device` (None: the CUDA card; the tests
    pass "cpu"). backend "mesh" shards the rows over `mesh`
    (parallel/mesh.py Mesh; None: the first `num_devices` visible cards)
    and runs the mesh block engines. backend "auto" (the default, as in
    the JAX package) takes the mesh only where the mesh runs the request
    (resolve_backend); on a one-card host it is the single device."""
    backend = resolve_backend(backend, config, device, num_devices, mesh)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    labels = set(np.unique(y).tolist())
    if labels != {-1, 1}:
        raise ValueError(
            f"labels must contain both classes -1 and +1, got {sorted(labels)}")
    result = solve_on(backend, x, y, config, device, num_devices, mesh)
    kp = KernelParams(config.kernel, config.resolve_gamma(x.shape[1]),
                      config.degree, config.coef0)
    return SVMModel.from_dense(x, y, result.alpha, result.b, kp), result
