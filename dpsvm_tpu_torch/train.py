"""High-level training API: data in, SVMModel out (counterpart of
dpsvm_tpu/train.py, single-device backend)."""

from __future__ import annotations

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.solve import solve


def train(x, y, config: SVMConfig = SVMConfig(), backend: str = "single",
          device=None) -> tuple[SVMModel, SolveResult]:
    """Train binary C-SVC with the engine config.engine names. Labels
    must be in {-1, +1}. `device=None` means the CUDA card; the tests
    pass "cpu"."""
    if backend != "single":
        raise NotImplementedError(
            f"backend={backend!r} is not ported (multi-GPU: ROADMAP queue A "
            "item 10); use backend='single'")
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.int32)
    labels = set(np.unique(y).tolist())
    if labels != {-1, 1}:
        raise ValueError(
            f"labels must contain both classes -1 and +1, got {sorted(labels)}")
    result = solve(x, y, config, device=device)
    kp = KernelParams(config.kernel, config.resolve_gamma(x.shape[1]),
                      config.degree, config.coef0)
    return SVMModel.from_dense(x, y, result.alpha, result.b, kp), result
