"""The solvers: the block and per-pair engines on one device, the host
backends, and what they share (chunks, the row cache, the results)."""

from dpsvm_tpu_torch.solver.reference import smo_reference
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.solve import solve as solve_single_chip

__all__ = ["SolveResult", "smo_reference", "solve_single_chip"]
