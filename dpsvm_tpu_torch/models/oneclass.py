"""One-class SVM (novelty detection) on the same SMO engine (counterpart
of dpsvm_tpu/models/oneclass.py).

The nu one-class dual in the engine's generic form (min 1/2 a^T Q a +
p^T a, Q_ij = y_i y_j K_ij) is y_i = +1 for all i, p = 0,
0 <= a_i <= 1, sum a_i = nu * n. Pair updates conserve sum(alpha * y),
so the START point fixes the constraint: the first floor(nu * n) points
at the bound and the remainder on the next (LibSVM's start). With p = 0
the indicator starts at f_init = K @ alpha_init
(ops/kernels.py blocked_kernel_matvec).

Decision: g(q) = sum_i a_i K(x_i, q) - rho with rho = (b_lo + b_hi) / 2
from the engine; q is an inlier when g(q) >= 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.models.svr import refuse_precomputed
from dpsvm_tpu_torch.ops.kernels import KernelParams, blocked_kernel_matvec
from dpsvm_tpu_torch.solver.result import SolveResult


@dataclasses.dataclass
class OneClassModel:
    """Trained novelty detector: g(q) = sum_i coef_i K(x_i, q) - rho."""

    sv_x: np.ndarray  # (n_sv, d)
    coef: np.ndarray  # (n_sv,) alpha_i in (0, 1]
    rho: float
    kernel: KernelParams

    @property
    def n_sv(self) -> int:
        return int(self.sv_x.shape[0])

    def as_classifier_model(self) -> SVMModel:
        """View as an SVMModel (all-positive coefficients, b = rho) so
        predict.py's decision path applies as is."""
        return SVMModel(sv_x=self.sv_x, sv_alpha=self.coef,
                        sv_y=np.ones(self.n_sv, np.int32), b=self.rho,
                        kernel=self.kernel)

    def decision_function(self, q, block: int = 8192,
                          device=None) -> np.ndarray:
        from dpsvm_tpu_torch.predict import decision_function

        return decision_function(self.as_classifier_model(), q, block,
                                 device=device)

    def predict(self, q, block: int = 8192, device=None) -> np.ndarray:
        """+1 = inlier, -1 = outlier (sklearn convention)."""
        dec = self.decision_function(q, block, device=device)
        return np.where(dec >= 0, 1, -1).astype(np.int32)

    def save(self, path: str) -> None:
        if not path.endswith(".npz"):
            raise ValueError("one-class models use the .npz format")
        np.savez_compressed(
            path, format_version=1, model_type="oneclass",
            sv_x=self.sv_x, coef=self.coef, rho=np.float32(self.rho),
            **self.kernel.npz_fields())

    @classmethod
    def load(cls, path: str) -> "OneClassModel":
        with np.load(path, allow_pickle=False) as z:
            if str(z.get("model_type", "")) != "oneclass":
                raise ValueError(f"{path}: not a one-class model")
            return cls(sv_x=z["sv_x"].astype(np.float32),
                       coef=z["coef"].astype(np.float32),
                       rho=float(z["rho"]), kernel=KernelParams.from_npz(z))


def train_oneclass(x, nu: float = 0.5, config: SVMConfig = SVMConfig(),
                   backend: str = "auto", num_devices: Optional[int] = None,
                   device=None, mesh=None, callback=None,
                   checkpoint_path: Optional[str] = None,
                   resume: bool = False) -> tuple[OneClassModel,
                                                    SolveResult]:
    """Fit nu one-class SVM: nu bounds the outlier fraction from above
    and the SV fraction from below. config.c and the class weights are
    ignored (the box is [0, 1]); config.epsilon stays the tolerance.
    Runs on `device` (None: the CUDA card). `callback`, `checkpoint_path`
    and `resume` follow solver/solve.py solve's contract."""
    from dpsvm_tpu_torch.train import host_device, resolve_backend, solve_on

    refuse_precomputed(config, "one-class has no labels to pair with "
                               "kernel rows")
    x = np.asarray(x, np.float32)
    n, d = x.shape
    if not 0.0 < nu <= 1.0:
        raise ValueError("nu must be in (0, 1]")
    l = int(nu * n)
    alpha0 = np.zeros((n,), np.float32)
    alpha0[:l] = 1.0
    if l < n:
        alpha0[l] = nu * n - l
    cfg = config.replace(c=1.0, weight_pos=1.0, weight_neg=1.0)
    backend = resolve_backend(backend, cfg, device, num_devices, mesh,
                              warm=True)
    kp = KernelParams(config.kernel, config.resolve_gamma(d), config.degree,
                      config.coef0)
    f_init = blocked_kernel_matvec(x, alpha0, kp, config.dtype,
                                   device=host_device(backend, device, mesh))
    y = np.ones((n,), np.int32)
    result = solve_on(backend, x, y, cfg, device, num_devices, mesh,
                      alpha_init=alpha0, f_init=f_init, callback=callback,
                      checkpoint_path=checkpoint_path, resume=resume)
    mask = result.alpha > 0
    model = OneClassModel(sv_x=np.ascontiguousarray(x[mask], np.float32),
                          coef=result.alpha[mask].astype(np.float32),
                          rho=float(result.b), kernel=kp)
    return model, result
