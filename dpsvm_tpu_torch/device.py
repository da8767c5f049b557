"""Device resolution shared by every entry point of the port.

Entry points take ``device=None``, which means the CUDA card. Without a
card they raise: the port never carries on quietly on the CPU. The CPU
runs only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on: CUDA unless the caller
    names another. Raises RuntimeError when CUDA is asked for (or
    defaulted to) on a machine without it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dpsvm_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        # Full-float32 products everywhere: TF32 keeps ~3 decimal digits
        # and would perturb kernel rows and the gradient fold; reduced-
        # precision bf16 reductions would round the accumulation. Both
        # are stated here rather than left to the library defaults.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextmanager
def precision_ctx(config):
    """Scoped matmul precision of the solver's cuBLAS products
    (config.resolve_precision): "high" allows TF32, anything else
    (None, "default", "highest") keeps full float32, the setting
    resolve_device states. The previous setting is restored on exit;
    the hand-written kernels keep their own precision."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = config.resolve_precision() == "high"
    try:
        yield
    finally:
        matmul.allow_tf32 = prev
