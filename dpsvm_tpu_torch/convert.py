"""State carried across from the JAX package.

The JAX package is never imported here: the converters read plain
attributes (numpy-convertible arrays and scalars), so any object with the
JAX package's field names works — a dpsvm_tpu SVMModel / SVRModel /
OneClassModel / PrecomputedSVCModel / MulticlassSVM / BlockState, or a
namespace rebuilt from saved arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.models.multiclass import (CompactedEnsemble,
                                               MulticlassSVM)
from dpsvm_tpu_torch.models.oneclass import OneClassModel
from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.models.svr import SVRModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver.block import BlockState


def _kernel(k) -> KernelParams:
    return KernelParams(str(k.kind), float(k.gamma), int(k.degree),
                        float(k.coef0))


def _rows(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), np.float32)


def model_from_reference(m) -> SVMModel:
    """A port SVMModel from the JAX package's model fields (sv_x,
    sv_alpha, sv_y, b, kernel.{kind, gamma, degree, coef0}, and the
    Platt pair prob_a / prob_b when present)."""
    prob_a = getattr(m, "prob_a", None)
    return SVMModel(
        sv_x=_rows(m.sv_x),
        sv_alpha=np.asarray(m.sv_alpha, np.float32),
        sv_y=np.asarray(m.sv_y, np.int32),
        b=float(m.b),
        kernel=_kernel(m.kernel),
        prob_a=None if prob_a is None else float(prob_a),
        prob_b=None if prob_a is None else float(m.prob_b))


def svr_model_from_reference(m) -> SVRModel:
    """A port SVRModel from the JAX package's (sv_x, coef, b, kernel)."""
    return SVRModel(sv_x=_rows(m.sv_x), coef=np.asarray(m.coef, np.float32),
                    b=float(m.b), kernel=_kernel(m.kernel))


def oneclass_model_from_reference(m) -> OneClassModel:
    """A port OneClassModel from the JAX package's (sv_x, coef, rho,
    kernel)."""
    return OneClassModel(sv_x=_rows(m.sv_x),
                         coef=np.asarray(m.coef, np.float32),
                         rho=float(m.rho), kernel=_kernel(m.kernel))


def precomputed_model_from_reference(m) -> PrecomputedSVCModel:
    """A port PrecomputedSVCModel from the JAX package's (sv_idx, coef,
    b, n_train)."""
    return PrecomputedSVCModel(np.asarray(m.sv_idx, np.int32),
                               np.asarray(m.coef, np.float32), float(m.b),
                               int(m.n_train))


def multiclass_from_reference(m) -> MulticlassSVM:
    """A port MulticlassSVM from the JAX package's (classes, models,
    strategy, compacted): every submodel through model_from_reference,
    and the compacted arrays when the JAX object carries them."""
    models = [model_from_reference(mm) for mm in m.models]
    out = MulticlassSVM(classes=np.asarray(m.classes),
                        models=models, strategy=str(m.strategy))
    comp = getattr(m, "compacted", None)
    if comp is not None:
        out.compacted = CompactedEnsemble(
            sv_union=_rows(comp.sv_union),
            coef=np.asarray(comp.coef, np.float32),
            b=np.asarray(comp.b, np.float32),
            idx=np.asarray(comp.idx, np.int32),
            coef_pad=np.asarray(comp.coef_pad, np.float32),
            counts=np.asarray(comp.counts, np.int32),
            kernel=models[0].kernel)
    return out


def block_state_from_reference(st, device) -> BlockState:
    """A port BlockState on `device` from the JAX package's BlockState
    arrays (alpha, f, f_err, b_hi, b_lo, pairs, rounds)."""
    dev = torch.device(device)

    def vec(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def scalar(a, dtype):
        return torch.tensor(np.asarray(a).item(), dtype=dtype, device=dev)

    return BlockState(
        alpha=vec(st.alpha), f=vec(st.f),
        b_hi=scalar(st.b_hi, torch.float32),
        b_lo=scalar(st.b_lo, torch.float32),
        pairs=scalar(st.pairs, torch.int32),
        rounds=scalar(st.rounds, torch.int32),
        f_err=None if st.f_err is None else vec(st.f_err))


def shard_state(alpha, f, f_err, mesh) -> tuple:
    """A solver state of n_pad rows (JAX or numpy arrays; n_pad divisible
    by the mesh's size) as the port's per-shard lists: (alpha, f, f_err),
    each a list of P float32 tensors, shard r on mesh.devices[r]; f_err
    None when not carried."""
    def cut(a):
        if a is None:
            return None
        a = np.asarray(a, np.float32)
        if a.shape[0] % mesh.size:
            raise ValueError(f"{a.shape[0]} rows do not divide over "
                             f"{mesh.size} shards")
        n_loc = a.shape[0] // mesh.size
        return [torch.tensor(a[r * n_loc:(r + 1) * n_loc], device=dev)
                for r, dev in enumerate(mesh.devices)]

    return cut(alpha), cut(f), cut(f_err)


def unshard_state(alpha, f, f_err=None) -> tuple:
    """The per-shard lists back as host arrays of n_pad rows:
    (alpha, f, f_err or None)."""
    from dpsvm_tpu_torch.parallel.mesh import unshard

    return (unshard(alpha), unshard(f),
            None if f_err is None else unshard(f_err))
