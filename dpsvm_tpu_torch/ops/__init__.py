"""Kernel primitives and the hand-written Hopper kernels."""

from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_from_dots,
                                         kernel_matrix, kernel_rows,
                                         row_dots, squared_norms)
from dpsvm_tpu_torch.ops.select import low_mask, select_working_set, up_mask

__all__ = ["KernelParams", "row_dots", "kernel_from_dots", "kernel_rows",
           "kernel_matrix", "squared_norms", "select_working_set",
           "up_mask", "low_mask"]
