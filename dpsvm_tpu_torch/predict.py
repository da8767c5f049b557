"""Batched inference (counterpart of dpsvm_tpu/predict.py).

f(q) = sum_j alpha_j y_j K(x_j, q) - b, evaluated in float32 on the
device in query blocks, or exactly in float64 on the host;
decision_function_mesh row-shards the support vectors over a mesh and
sums the shards' partial decisions.
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.device import resolve_device
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import kernel_matrix
from dpsvm_tpu_torch.solver.reconstruct import gram_matvec_f64

# decision_risk at or above this routes precision='auto' to the float64
# host path (the JAX package's calibration, predict.AUTO_F64_RISK).
AUTO_F64_RISK = 0.1


def decision_function(model: SVMModel, q, block: int = 8192,
                      precision: str = "float32", device=None) -> np.ndarray:
    """f(q_i) for a batch of query points, in query blocks of `block`.

    precision: "float32" (device), "float64" (exact, host) or "auto"
    (float64 when decision_risk(model) >= AUTO_F64_RISK)."""
    # Resolved before the precision branch, so every path refuses
    # device=None on a machine without CUDA.
    dev = resolve_device(device)
    if precision == "auto":
        precision = resolve_precision(model)
    if precision == "float64":
        return gram_matvec_f64(model.sv_x, model.dual_coef, model.kernel,
                               block=block,
                               queries=np.asarray(q, np.float64)) - model.b
    if precision != "float32":
        raise ValueError("precision must be 'auto', 'float32' or 'float64'")
    q = np.asarray(q, np.float32)
    sv = torch.as_tensor(model.sv_x, device=dev)
    coef = torch.as_tensor(model.dual_coef, device=dev)
    out = []
    for s in range(0, q.shape[0], block):
        qb = torch.as_tensor(q[s:s + block], device=dev)
        dec = kernel_matrix(qb, sv, model.kernel) @ coef - model.b
        out.append(dec.cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0,), np.float32)


def decision_risk(model: SVMModel) -> float:
    """A-priori estimate of float32 decision-evaluation noise:
    sqrt(n_sv) * eps_f32 * rms|coef|."""
    coef = np.asarray(model.dual_coef, np.float64)
    if coef.size == 0:
        return 0.0
    return float(np.sqrt(coef.size) * 2.0 ** -23
                 * np.sqrt(np.mean(coef ** 2)))


def decision_risk_columns(coef) -> np.ndarray:
    """decision_risk per COLUMN of an (S, k) dual-coefficient matrix (the
    compacted multiclass layout, models/multiclass.py CompactedEnsemble):
    sqrt(nnz_j) * eps_f32 * rms|nonzero coef_j|, all k columns in one
    pass."""
    coef = np.asarray(coef, np.float64)
    nnz = np.count_nonzero(coef, axis=0).astype(np.float64)
    sq = np.sum(coef ** 2, axis=0)
    rms = np.sqrt(sq / np.maximum(nnz, 1.0))
    return np.sqrt(nnz) * 2.0 ** -23 * rms


def resolve_precision(model: SVMModel) -> str:
    """The path precision='auto' resolves to: 'float64' when the float32
    noise estimate reaches AUTO_F64_RISK, else 'float32'."""
    return ("float64" if decision_risk(model) >= AUTO_F64_RISK
            else "float32")


def predict(model: SVMModel, q, block: int = 8192, precision: str = "auto",
            device=None) -> np.ndarray:
    """Class labels in {-1, +1}; sign(0) maps to +1."""
    d = decision_function(model, q, block, precision=precision, device=device)
    return np.where(d >= 0, 1, -1).astype(np.int32)


def accuracy(model: SVMModel, q, y, block: int = 8192,
             precision: str = "auto", device=None) -> float:
    """Fraction of labels predicted correctly."""
    pred = predict(model, q, block, precision=precision, device=device)
    return float(np.mean(pred == np.asarray(y)))


def decision_function_mesh(model: SVMModel, q, num_devices=None,
                           block: int = 8192, mesh=None) -> np.ndarray:
    """The decision function with the support vectors row-sharded over a
    mesh (the JAX package's decision_function_mesh): each shard takes
    its partial sum K(query block, sv shard) @ coef shard, and a sum over
    the shards in rank order combines them; query blocks are replicated.
    The kernel is decision_function's (kernel_matrix), so the two differ
    only in how the float32 sum over the support vectors is grouped.
    `mesh` is a parallel/mesh.py Mesh (None: the first `num_devices`
    visible cards). The padded and sharded support vectors are cached on
    the model (`_mesh_prepared`), so a serving loop uploads them once."""
    from dpsvm_tpu_torch.parallel.mesh import make_data_mesh, shard_padded_rows

    if mesh is None:
        mesh = make_data_mesh(num_devices)
    for dev in {d for d, _ in mesh.groups}:
        resolve_device(dev)
    q = np.asarray(q, np.float32)
    prepared = getattr(model, "_mesh_prepared", None)
    if prepared is not None and prepared[0] == mesh.devices:
        sv_sh, coef_sh = prepared[1]
    else:
        sv_sh = shard_padded_rows(mesh, np.asarray(model.sv_x, np.float32))
        # Padded rows carry coef 0: inert.
        coef_sh = shard_padded_rows(mesh, np.asarray(model.dual_coef,
                                                     np.float32))
        model._mesh_prepared = (mesh.devices, (sv_sh, coef_sh))
    out = []
    for s in range(0, q.shape[0], block):
        qb = [torch.as_tensor(q[s:s + block], device=dev)
              for dev, _ in mesh.groups]
        parts = [kernel_matrix(qb[mesh.group_of[r]], sv_sh[r], model.kernel)
                 @ coef_sh[r] for r in range(mesh.size)]
        out.append(mesh.psum(parts)[0].cpu().numpy() - model.b)
    return np.concatenate(out) if out else np.zeros((0,), np.float32)
