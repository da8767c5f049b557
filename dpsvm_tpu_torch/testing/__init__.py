"""Deterministic fault injection (counterpart of dpsvm_tpu/testing)."""

from dpsvm_tpu_torch.testing import faults  # noqa: F401

__all__ = ["faults"]
