"""Model container for precomputed-kernel C-SVC, LibSVM -t 4 (counterpart
of dpsvm_tpu/models/precomputed.py; the two packages read each other's
files).

A precomputed-kernel model has no SV feature rows: the trainer consumed
the user's Gram matrix. It carries the support indices into the training
set instead, and prediction reads rows of K(query, train) at those
columns, as LibSVM's svm-predict treats a precomputed test file.
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.device import resolve_device


class PrecomputedSVCModel:
    """Binary C-SVC trained on a user-supplied Gram matrix.

    sv_idx   (n_sv,) int32: support-vector indices into the TRAINING set
             (the Gram columns prediction gathers);
    coef     (n_sv,) float32: alpha_i * y_i at those indices;
    b        decision = K[:, sv_idx] @ coef - b;
    n_train  the training-set size (the width prediction rows must have).
    """

    def __init__(self, sv_idx, coef, b: float, n_train: int):
        self.sv_idx = np.asarray(sv_idx, np.int32)
        self.coef = np.asarray(coef, np.float32)
        self.b = float(b)
        self.n_train = int(n_train)

    @classmethod
    def from_solution(cls, y, alpha, b: float) -> "PrecomputedSVCModel":
        y = np.asarray(y, np.float32)
        alpha = np.asarray(alpha, np.float32)
        idx = np.nonzero(alpha > 0)[0]
        return cls(idx, alpha[idx] * y[idx], b, len(y))

    @property
    def n_sv(self) -> int:
        return int(self.sv_idx.size)

    def decision_function(self, k_rows, block: int = 8192,
                          device=None) -> np.ndarray:
        """Decision values from K(query, train) rows, (m, n_train) ->
        (m,), on `device` (None: the CUDA card): the support columns
        gathered and contracted in float64, as the JAX package does on
        the host. Only the support columns are read."""
        dev = resolve_device(device)
        k_rows = np.asarray(k_rows, np.float32)
        if k_rows.ndim != 2 or k_rows.shape[1] != self.n_train:
            raise ValueError(
                f"precomputed prediction needs K(query, train) rows of "
                f"width {self.n_train}, got {k_rows.shape}")
        idx = torch.as_tensor(self.sv_idx.astype(np.int64), device=dev)
        coef = torch.as_tensor(self.coef, device=dev).double()
        out = []
        for s in range(0, k_rows.shape[0], block):
            rows = torch.as_tensor(k_rows[s:s + block], device=dev)
            dec = rows.index_select(1, idx).double() @ coef - self.b
            out.append(dec.cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0,), np.float64)

    def predict(self, k_rows, block: int = 8192, device=None) -> np.ndarray:
        dec = self.decision_function(k_rows, block, device=device)
        return np.where(dec >= 0, 1, -1).astype(np.int32)

    def save(self, path: str) -> None:
        if not path.endswith(".npz"):
            raise ValueError(
                "precomputed models use the .npz format (the reference "
                "text format stores SV feature rows, which do not exist)")
        np.savez(path, model_type="precomputed_svc",
                 sv_idx=self.sv_idx, coef=self.coef,
                 b=np.float32(self.b), n_train=np.int32(self.n_train))

    @classmethod
    def load(cls, path: str) -> "PrecomputedSVCModel":
        with np.load(path, allow_pickle=False) as z:
            if str(z.get("model_type", "")) != "precomputed_svc":
                raise ValueError(f"{path} is not a precomputed-kernel model")
            return cls(z["sv_idx"], z["coef"], float(z["b"]),
                       int(z["n_train"]))
