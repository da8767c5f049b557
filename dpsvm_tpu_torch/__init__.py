"""dpsvm_tpu_torch: the PyTorch/CUDA port of dpsvm_tpu for one NVIDIA
Hopper card.

Binary C-SVC, train -> save -> load -> predict, on the block engines
(the active-set engine among them), the per-pair engines and the mesh
engines (row shards over a parallel.mesh.Mesh: the block runners and the
per-pair mesh engine); nu-SVC, epsilon-SVR, nu-SVR and one-class SVM on
one device and on the mesh (models/); precomputed Grams
(models/precomputed.py); multiclass OvR / OvO, sequential or batched in
a fleet (models/multiclass.py, solver/fleet.py); Platt probabilities
(models/platt.py) and the sklearn-style estimators (estimators, loaded
on first use); serving from a resident SV union (serve.py
PredictServer; the v2 engine, front door and replica fleet in serving/);
every kernel of those paths hand-written in CUDA C++ (csrc/). Around them: CSV and LIBSVM data (data/), the host backends
(solver/reference.py), solves observed chunk by chunk with checkpoints
either package resumes (solver/chunks.py, utils/checkpoint.py) and
float64 reconstruction legs (solver/reconstruct.py); out-of-core training
with X on the host (solver/ooc.py), warm starts and the cascade
(solver/warmstart.py, solver/cascade.py) and the continuous-learning
loop (learn.py; like the JAX package, the package namespace exports none
of these modules' names). Entry points run on
the CUDA card unless the caller passes device="cpu" (or a CPU mesh).
This package imports neither jax nor dpsvm_tpu.
"""

from dpsvm_tpu_torch.config import ServeConfig, SVMConfig
from dpsvm_tpu_torch.models import (OneClassModel, SVMModel, SVRModel,
                                    train_nusvc, train_nusvr, train_oneclass,
                                    train_svr)
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.parallel.dist_smo import solve_mesh
from dpsvm_tpu_torch.parallel.mesh import Mesh, make_data_mesh
from dpsvm_tpu_torch.predict import (accuracy, decision_function,
                                     decision_risk, predict)
from dpsvm_tpu_torch.serve import PredictServer
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.solve import solve
from dpsvm_tpu_torch.train import train
from dpsvm_tpu_torch import data

__version__ = "0.1.0"


def __getattr__(name):
    # The estimator facade tries to import scikit-learn; solver-only
    # users do not pay for it until they ask.
    if name == "estimators":
        import importlib

        return importlib.import_module("dpsvm_tpu_torch.estimators")
    raise AttributeError(f"module 'dpsvm_tpu_torch' has no attribute "
                         f"{name!r}")


__all__ = ["SVMConfig", "SVMModel", "KernelParams", "SolveResult", "solve",
           "solve_mesh", "Mesh", "make_data_mesh", "train",
           "decision_function", "decision_risk", "predict", "accuracy",
           "SVRModel", "OneClassModel", "train_svr", "train_oneclass",
           "train_nusvc", "train_nusvr", "estimators", "ServeConfig",
           "PredictServer", "data", "__version__"]
