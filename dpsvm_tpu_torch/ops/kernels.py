"""Kernel (Gram) evaluation primitives (counterpart of
dpsvm_tpu/ops/kernels.py).

Every kernel family is derived from dot products plus cached squared
norms. Dots are accumulated in float32 whatever the storage dtype of X;
under bfloat16 storage the squared norms come from the STORED (rounded)
rows, so the kernel values are those of the problem actually solved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Static kernel parameters."""

    kind: str = "rbf"  # rbf | linear | poly | sigmoid
    gamma: float = 1.0
    degree: int = 3
    coef0: float = 0.0

    def npz_fields(self) -> dict:
        """The .npz serialization of the kernel (same keys and dtypes as
        the JAX package writes)."""
        return {
            "kernel_kind": self.kind,
            "gamma": np.float32(self.gamma),
            "degree": np.int32(self.degree),
            "coef0": np.float32(self.coef0),
        }

    @classmethod
    def from_npz(cls, z) -> "KernelParams":
        return cls(kind=str(z["kernel_kind"]), gamma=float(z["gamma"]),
                   degree=int(z["degree"]), coef0=float(z["coef0"]))


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in float32.

    bfloat16 operands on CUDA go to the bf16 GEMM with a float32 output
    (each bf16 product is exact in float32, the sum is float32) — never a
    bf16 output, which would round every kernel row by ~0.4%. Elsewhere
    the operands are upcast to float32 first: the same products, summed
    in float32."""
    if a.dtype == torch.bfloat16 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Per-row |x_i|^2 in float32, shape (n,)."""
    xf = x.float()
    return (xf * xf).sum(dim=1)


def row_dots(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Dot-product rows q . X^T in float32: (k, n) for q (k, d), (n,) for
    q (d,)."""
    squeeze = q.dim() == 1
    q2 = torch.atleast_2d(q).to(x.dtype)
    out = mm_f32(q2, x.t())
    return out[0] if squeeze else out


def kernel_from_dots(dots: torch.Tensor, x_sq: torch.Tensor, q_sq,
                     params: KernelParams) -> torch.Tensor:
    """Turn dot-product rows into kernel rows.

    dots: (..., n); x_sq: (n,) squared norms of the data rows; q_sq:
    (...,) squared norms of the query rows (read for rbf only). The rbf
    operation order is the JAX package's: x_sq + q_sq, then - 2 dots,
    then max(., 0), then exp(-gamma .)."""
    dots = dots.float()
    if params.kind == "precomputed":
        raise ValueError(
            "precomputed kernels have no dot-product form; gather rows of "
            "the Gram matrix instead (kernel_rows handles this)")
    if params.kind == "linear":
        return dots
    if params.kind == "rbf":
        q_sq = torch.as_tensor(q_sq, dtype=torch.float32, device=dots.device)
        sq_dist = x_sq + q_sq[..., None] if dots.dim() > 1 else x_sq + q_sq
        sq_dist = torch.clamp(sq_dist - 2.0 * dots, min=0.0)
        return torch.exp(-params.gamma * sq_dist)
    if params.kind == "poly":
        return (params.gamma * dots + params.coef0) ** params.degree
    if params.kind == "sigmoid":
        return torch.tanh(params.gamma * dots + params.coef0)
    raise ValueError(f"unknown kernel kind {params.kind!r}")


def kernel_diag(x_sq: torch.Tensor, params: KernelParams) -> torch.Tensor:
    """Diagonal K(x_i, x_i) from the squared norms (exact ones for rbf)."""
    x_sq = x_sq.float()
    if params.kind == "rbf":
        return torch.ones_like(x_sq)
    return kernel_from_dots(x_sq, x_sq, x_sq, params)


def kernel_rows(x: torch.Tensor, x_sq: torch.Tensor, q: torch.Tensor,
                q_sq, params: KernelParams) -> torch.Tensor:
    """Full kernel rows K(q_k, x_i): (k, n) or (n,).

    kind="precomputed": `x` IS the (n, n) Gram matrix, so a gathered
    query row already holds its kernel values and is returned as is."""
    if params.kind == "precomputed":
        return q.float()
    return kernel_from_dots(row_dots(x, q), x_sq, q_sq, params)


def resident_gram(x: torch.Tensor, x_sq: torch.Tensor, params: KernelParams,
                  tile: int = 2048) -> torch.Tensor:
    """The whole (n, n) float32 Gram matrix on x's device, built in
    tiles of `tile` rows of kernel_rows (one (tile, n) block live at a
    time besides the result). The last tile starts at n - tile and
    recomputes the rows it overlaps, as the JAX package does."""
    n = x.shape[0]
    t = min(tile, n)
    g = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for i in range(-(-n // t)):
        s = min(i * t, n - t)
        g[s:s + t] = kernel_rows(x, x_sq, x[s:s + t], x_sq[s:s + t], params)
    return g


def kernel_matrix(a: torch.Tensor, b: torch.Tensor,
                  params: KernelParams) -> torch.Tensor:
    """Dense K(a_i, b_j) of shape (n_a, n_b), in float32 (the
    predictor's form)."""
    a = a.float()
    b = b.float()
    a_sq = squared_norms(a)
    b_sq = squared_norms(b)
    dots = a @ b.t()
    if params.kind == "linear":
        return dots
    if params.kind == "rbf":
        sq = torch.clamp(a_sq[:, None] + b_sq[None, :] - 2.0 * dots, min=0.0)
        return torch.exp(-params.gamma * sq)
    if params.kind == "poly":
        return (params.gamma * dots + params.coef0) ** params.degree
    if params.kind == "sigmoid":
        return torch.tanh(params.gamma * dots + params.coef0)
    raise ValueError(f"unknown kernel kind {params.kind!r}")
