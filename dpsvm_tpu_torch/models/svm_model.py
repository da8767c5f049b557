"""Trained-model container and serialization (counterpart of
dpsvm_tpu/models/svm_model.py; the two packages read each other's files).

* ``.txt``: the reference text format — gamma, b, then one
  ``alpha,y,x_1,...,x_d`` row per support vector; a 1-line header (no b)
  is tolerated on load. RBF only.
* ``.npz``: sv_x, sv_alpha, sv_y, b and the kernel fields, any kernel,
  and the Platt pair prob_a / prob_b when the model carries it.

Decision convention: f(q) = sum_j alpha_j y_j K(x_j, q) - b.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dpsvm_tpu_torch.ops.kernels import KernelParams


@dataclasses.dataclass
class SVMModel:
    sv_x: np.ndarray  # (n_sv, d) support vectors
    sv_alpha: np.ndarray  # (n_sv,) alpha_i > 0
    sv_y: np.ndarray  # (n_sv,) labels in {-1, +1}
    b: float
    kernel: KernelParams
    # Platt calibration plane, P(y=+1 | f) = sigmoid(prob_a * f + prob_b)
    # (models/platt.py). None = uncalibrated. Carried by the .npz format
    # only.
    prob_a: float | None = None
    prob_b: float | None = None

    @property
    def has_probability(self) -> bool:
        return self.prob_a is not None

    @property
    def n_sv(self) -> int:
        return int(self.sv_x.shape[0])

    @property
    def num_features(self) -> int:
        return int(self.sv_x.shape[1])

    @property
    def dual_coef(self) -> np.ndarray:
        """alpha_j * y_j, the weights of the decision sum."""
        return (self.sv_alpha * self.sv_y).astype(np.float32)

    @classmethod
    def from_dense(cls, x, y, alpha, b, kernel: KernelParams) -> "SVMModel":
        """Extract the support vectors (alpha > 0) from full training
        arrays."""
        alpha = np.asarray(alpha, np.float32)
        mask = alpha > 0
        return cls(
            sv_x=np.ascontiguousarray(np.asarray(x)[mask], np.float32),
            sv_alpha=alpha[mask],
            sv_y=np.asarray(y, np.int32)[mask],
            b=float(b),
            kernel=kernel,
        )

    def npz_payload(self, prefix: str = "") -> dict:
        """The model's .npz fields under a key prefix: one definition
        shared by save (prefix "") and the multiclass bundle (prefix
        "m{i}_", models/multiclass.py), as in the JAX package."""
        return {
            f"{prefix}sv_x": self.sv_x,
            f"{prefix}sv_alpha": self.sv_alpha,
            f"{prefix}sv_y": self.sv_y,
            f"{prefix}b": np.float32(self.b),
            **{f"{prefix}{k}": v
               for k, v in self.kernel.npz_fields().items()},
        }

    @classmethod
    def from_npz_payload(cls, z, prefix: str = "") -> "SVMModel":
        """Inverse of npz_payload over an opened .npz mapping."""
        return cls(
            sv_x=z[f"{prefix}sv_x"].astype(np.float32),
            sv_alpha=z[f"{prefix}sv_alpha"].astype(np.float32),
            sv_y=z[f"{prefix}sv_y"].astype(np.int32),
            b=float(z[f"{prefix}b"]),
            kernel=KernelParams(
                kind=str(z[f"{prefix}kernel_kind"]),
                gamma=float(z[f"{prefix}gamma"]),
                degree=int(z[f"{prefix}degree"]),
                coef0=float(z[f"{prefix}coef0"])))

    def save(self, path: str) -> None:
        if path.endswith(".npz"):
            prob = ({"prob_a": np.float64(self.prob_a),
                     "prob_b": np.float64(self.prob_b)}
                    if self.has_probability else {})
            np.savez_compressed(path, format_version=1,
                                **self.npz_payload(), **prob)
            return
        if self.kernel.kind != "rbf":
            raise ValueError(
                "the text model format only expresses RBF; save non-RBF "
                "models to .npz")
        if self.has_probability:
            raise ValueError(
                "the text model format cannot carry Platt calibration "
                "(reference format); save probability models to .npz")
        with open(path, "w") as fh:
            fh.write(f"{self.kernel.gamma}\n")
            fh.write(f"{self.b}\n")
            for i in range(self.n_sv):
                row = ",".join(repr(float(v)) for v in self.sv_x[i])
                fh.write(f"{float(self.sv_alpha[i])!r},{int(self.sv_y[i])},{row}\n")

    @classmethod
    def load(cls, path: str) -> "SVMModel":
        if path.endswith(".npz"):
            with np.load(path, allow_pickle=False) as z:
                model = cls.from_npz_payload(z)
                if "prob_a" in z:
                    model.prob_a = float(z["prob_a"])
                    model.prob_b = float(z["prob_b"])
                return model
        with open(path) as fh:
            lines = [ln.strip() for ln in fh if ln.strip()]
        if len(lines) < 2:
            raise ValueError(f"{path}: not a model file")
        gamma = float(lines[0])
        # 2-line header vs 1-line header: an SV row has >= 3
        # comma-separated fields, a b line exactly one.
        if "," in lines[1]:
            b, first_sv = 0.0, 1
        else:
            b, first_sv = float(lines[1]), 2
        alphas, ys, xs = [], [], []
        for ln in lines[first_sv:]:
            parts = ln.split(",")
            alphas.append(float(parts[0]))
            ys.append(int(float(parts[1])))
            xs.append([float(v) for v in parts[2:]])
        return cls(sv_x=np.asarray(xs, np.float32),
                   sv_alpha=np.asarray(alphas, np.float32),
                   sv_y=np.asarray(ys, np.int32),
                   b=b,
                   kernel=KernelParams(kind="rbf", gamma=gamma))
