"""Epsilon-SVR on the same SMO engine (counterpart of
dpsvm_tpu/models/svr.py).

The SVR dual

    min 1/2 (a - a*)^T K (a - a*) + eps sum(a + a*) - z^T (a - a*)
    s.t. sum(a - a*) = 0,  0 <= a_i, a*_i <= C

is the generic SMO problem over 2n variables with the rows duplicated,
pseudo-labels y = [+1]*n ++ [-1]*n (so Q_ij = y_i y_j K_ij has the block
form [[K, -K], [-K, K]]) and linear term p = [eps - z; eps + z]. The
engine's indicator f = y * (Q alpha + p) therefore starts at
f_init = [eps - z; -eps - z]; selection, the pair update and the kernel
rows are the C-SVC engine's.

Prediction: z_hat(q) = sum_i coef_i K(x_i, q) - b with coef_i = a_i - a*_i,
the classifier's decision convention, so predict.py applies to the
flattened model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver.result import SolveResult


@dataclasses.dataclass
class SVRModel:
    """Trained regressor: z_hat(q) = sum_i coef_i K(x_i, q) - b."""

    sv_x: np.ndarray  # (n_sv, d)
    coef: np.ndarray  # (n_sv,) signed dual coefficients a_i - a*_i, != 0
    b: float
    kernel: KernelParams

    @property
    def n_sv(self) -> int:
        return int(self.sv_x.shape[0])

    def as_classifier_model(self) -> SVMModel:
        """View as an SVMModel (sv_alpha = |coef|, sv_y = sign(coef)) so
        predict.py's decision path applies as is."""
        sign = np.where(self.coef >= 0, 1, -1).astype(np.int32)
        return SVMModel(sv_x=self.sv_x, sv_alpha=np.abs(self.coef),
                        sv_y=sign, b=self.b, kernel=self.kernel)

    def predict(self, q, block: int = 8192, device=None) -> np.ndarray:
        """Regression estimates for query rows (on the CUDA card unless
        `device` names another)."""
        from dpsvm_tpu_torch.predict import decision_function

        return decision_function(self.as_classifier_model(), q, block,
                                 device=device)

    def save(self, path: str) -> None:
        if not path.endswith(".npz"):
            raise ValueError("SVR models use the .npz format (the reference "
                             "text format encodes a classifier)")
        np.savez_compressed(
            path, format_version=1, model_type="svr",
            sv_x=self.sv_x, coef=self.coef, b=np.float32(self.b),
            **self.kernel.npz_fields())

    @classmethod
    def load(cls, path: str) -> "SVRModel":
        with np.load(path, allow_pickle=False) as z:
            if str(z.get("model_type", "")) != "svr":
                raise ValueError(f"{path}: not an SVR model")
            return cls(sv_x=z["sv_x"].astype(np.float32),
                       coef=z["coef"].astype(np.float32),
                       b=float(z["b"]), kernel=KernelParams.from_npz(z))


def refuse_precomputed(config: SVMConfig, why: str) -> None:
    """The model families take feature kernels only."""
    if config.kernel == "precomputed":
        raise ValueError(
            "kernel='precomputed' is implemented for binary C-SVC only "
            f"({why}); the reduction would need a transformed Gram "
            "matrix, not transformed features")


def expand_2n(x, z) -> tuple:
    """The 2n expansion of the SVR duals: (x2, y2) with the rows twice
    and pseudo-labels [+1]*n ++ [-1]*n. Checks z's shape."""
    n = x.shape[0]
    if z.shape != (n,):
        raise ValueError(f"targets must be shape ({n},), got {z.shape}")
    return (np.vstack([x, x]),
            np.concatenate([np.ones(n, np.int32), -np.ones(n, np.int32)]))


def regressor(x, coef, b: float, config: SVMConfig) -> SVRModel:
    """The SVRModel of the expansion's signed coefficients (n,)."""
    mask = coef != 0
    kp = KernelParams(config.kernel, config.resolve_gamma(x.shape[1]),
                      config.degree, config.coef0)
    return SVRModel(sv_x=np.ascontiguousarray(x[mask], np.float32),
                    coef=coef[mask].astype(np.float32), b=float(b),
                    kernel=kp)


def train_svr(x, z, config: SVMConfig = SVMConfig(),
              svr_epsilon: float = 0.1, backend: str = "auto",
              num_devices: Optional[int] = None, device=None,
              mesh=None, callback=None,
              checkpoint_path: Optional[str] = None,
              resume: bool = False) -> tuple[SVRModel, SolveResult]:
    """Train epsilon-SVR: fit z ~ f(x) within an `svr_epsilon` tube.

    `config.epsilon` stays the SMO tolerance; the tube width is
    `svr_epsilon` (LibSVM's -p against -e). Runs on `device` (None: the
    CUDA card), or on `mesh` (backend "mesh", or "auto" with a mesh
    given or several cards visible). `callback`, `checkpoint_path` and
    `resume` follow solver/solve.py solve's contract (the checkpoint
    holds the 2n-variable dual)."""
    from dpsvm_tpu_torch.train import resolve_backend, solve_on

    refuse_precomputed(config, "epsilon-SVR doubles the variable set")
    x = np.asarray(x, np.float32)
    z = np.asarray(z, np.float32)
    n = x.shape[0]
    x2, y2 = expand_2n(x, z)
    if svr_epsilon < 0:
        raise ValueError("svr_epsilon must be >= 0")
    f_init = np.concatenate([svr_epsilon - z,
                             -svr_epsilon - z]).astype(np.float32)
    # One C for both halves: the pseudo-labels are bookkeeping, not
    # classes, so class weights must not bound a and a* differently.
    config = config.replace(weight_pos=1.0, weight_neg=1.0)
    backend = resolve_backend(backend, config, device, num_devices, mesh,
                              warm=True)
    result = solve_on(backend, x2, y2, config, device, num_devices, mesh,
                      f_init=f_init, callback=callback,
                      checkpoint_path=checkpoint_path, resume=resume)
    coef = result.alpha[:n] - result.alpha[n:]
    return regressor(x, coef, result.b, config), result
