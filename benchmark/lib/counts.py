"""Operations and bytes the work needs, from shapes alone, and the least
time the card could take for it.

Peaks are the data sheet's for one NVIDIA H100 SXM (dense, at the full
700 W power limit): 67 TFLOP/s in float32 outside the tensor cores and
3.35 TB/s of HBM. Every product here is float32 with TF32 off, so the
float32 peak is the one that bounds it. A share of these peaks is stated
beside the card's power limit, which the run prints.

Bytes count each input read once and each output written once; where a
kernel reads a row again, that is its cost, not the work's.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def round_flops(n: int, d: int, q: int) -> float:
    """One plain block round on n rows of d features with a working set
    of q rows: the kernel rows K(W, :) (2 q n d), the fold of the q
    coefficients into the gradient (2 q n) and K(W, W) (2 q^2 d)."""
    return 2.0 * q * n * d + 2.0 * q * n + 2.0 * q * q * d


def round_bytes(n: int, d: int, q: int) -> float:
    """X read once, the gradient read and written, alpha and the labels
    read, alpha written (the working set's rows are X's own)."""
    return F32 * (n * d + 5.0 * n) + F32 * q * d


def round_bound_s(n: int, d: int, q: int) -> float:
    return max(round_flops(n, d, q) / PEAK_F32_FLOPS,
               round_bytes(n, d, q) / PEAK_HBM_BYTES)

