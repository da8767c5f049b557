"""dpsvm_tpu_torch: the PyTorch/CUDA port of dpsvm_tpu for one NVIDIA
Hopper card.

The first slice ports the main path: binary C-SVC on the block engine,
train -> save -> load -> predict, with the block subproblem solve as a
hand-written CUDA kernel (csrc/subproblem.cu). Entry points run on the
CUDA card unless the caller passes device="cpu". This package imports
neither jax nor dpsvm_tpu.
"""

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.predict import accuracy, decision_function, predict
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.solve import solve
from dpsvm_tpu_torch.train import train

__all__ = ["SVMConfig", "SVMModel", "KernelParams", "SolveResult", "solve",
           "train", "decision_function", "predict", "accuracy"]
