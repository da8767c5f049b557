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


def blocked_kernel_matvec(x, coef, params: KernelParams,
                          dtype: str = "float32", block: int = 8192,
                          device=None) -> np.ndarray:
    """K(x, x_active) @ coef_active on `device`, at most a (block,
    n_active) kernel tile live at a time: the start gradient of the
    warm-started duals (one-class, nu-SVC).

    `dtype` is the solver's X storage dtype. With bfloat16 storage the
    solver's kernel rows see the bf16-rounded features, so this evaluates
    on the same rounded values; otherwise the start gradient would be
    ~1e-3-relative off every later rank-2 update, an error the solver
    never repairs. Returns float32 (n,) on the host."""
    x = np.asarray(x, np.float32)
    coef = np.asarray(coef, np.float32)
    active = coef != 0
    if not active.any():
        return np.zeros((x.shape[0],), np.float32)
    xt = torch.as_tensor(x, device=device)
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    xa = xt[torch.as_tensor(np.nonzero(active)[0], device=xt.device)]
    ca = torch.as_tensor(coef[active], device=xt.device)
    out = np.empty((x.shape[0],), np.float32)
    for s in range(0, x.shape[0], block):
        k = kernel_matrix(xt[s:s + block], xa, params)
        out[s:s + block] = (k @ ca).cpu().numpy()
    return out


def _bf16_sample(x, sample: int, pairs: int, seed: int) -> tuple:
    """The seeded pair population of the bf16 perturbation probes: the
    sampled rows exactly and bf16-rounded (round to nearest even, as
    ml_dtypes rounds), in float64, and the pair index vectors."""
    x = np.asarray(x, np.float32)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, min(sample, n), replace=False)
    s = x[idx].astype(np.float64)
    sb = (torch.from_numpy(np.ascontiguousarray(x[idx]))
          .to(torch.bfloat16).double().numpy())
    i = rng.integers(0, len(s), pairs)
    j = rng.integers(0, len(s), pairs)
    return s, sb, i, j


def bf16_rbf_perturbation(x, gamma: float, sample: int = 2048,
                          pairs: int = 4096, seed: int = 0) -> float:
    """p90 of |K_exact - K_bf16-stored| over sampled pairs: how much
    storing X in bfloat16 perturbs RBF kernel values for THIS data. The
    box bound C amplifies it into decision changes, so the risk scale is
    C * p90|dK|. Host NumPy on a seeded sample."""
    s, sb, i, j = _bf16_sample(x, sample, pairs, seed)

    def kvals(a):
        nrm = (a ** 2).sum(1)
        d2 = np.maximum(nrm[i] + nrm[j]
                        - 2.0 * np.einsum("nd,nd->n", a[i], a[j]), 0.0)
        return np.exp(-gamma * d2)

    return float(np.percentile(np.abs(kvals(s) - kvals(sb)), 90))


def bf16_kernel_perturbation(x, params: KernelParams, sample: int = 2048,
                             pairs: int = 4096, seed: int = 0) -> float:
    """bf16_rbf_perturbation for any feature kernel: rbf delegates to it;
    linear / poly / sigmoid sample the same pairs through their own
    dot-product algebra (float64, exact against bf16-rounded rows)."""
    if params.kind == "rbf":
        return bf16_rbf_perturbation(x, params.gamma, sample=sample,
                                     pairs=pairs, seed=seed)
    if params.kind == "precomputed":
        raise ValueError(
            "precomputed kernels carry values, not features; there is "
            "no storage-rounding perturbation to sample")
    s, sb, i, j = _bf16_sample(x, sample, pairs, seed)

    def kvals(a):
        dots = np.einsum("nd,nd->n", a[i], a[j])
        if params.kind == "linear":
            return dots
        if params.kind == "poly":
            return (params.gamma * dots + params.coef0) ** params.degree
        if params.kind == "sigmoid":
            return np.tanh(params.gamma * dots + params.coef0)
        raise ValueError(f"unknown kernel kind {params.kind!r}")

    return float(np.percentile(np.abs(kvals(s) - kvals(sb)), 90))


# C * p90|dK| above this warns (see bf16_rbf_perturbation): the JAX
# package's calibration, between a measured-failing covtype-shaped
# stress config (0.46) and passing configurations (<= 0.001).
BF16_RISK_THRESHOLD = 0.1


def resolve_bf16_gram(x, config, gamma: float, c_max: float = None,
                      scope: str = ""):
    """The per-problem bf16-Gram gate: whether storing X in bfloat16 is
    safe for THIS (data, config) by C * p90|dK| against
    BF16_RISK_THRESHOLD. Returns (active, risk, stats_entry); a refusal
    carries a `note`. (config.bf16_gram itself is not ported yet: the
    gate is here for the guard's shared definition.)"""
    kp = KernelParams(config.kernel, gamma, config.degree, config.coef0)
    c_ref = max(config.c_bounds()) if c_max is None else float(c_max)
    risk = c_ref * bf16_kernel_perturbation(x, kp)
    active = risk <= BF16_RISK_THRESHOLD
    entry = {"active": active, "risk": round(risk, 6),
             "threshold": BF16_RISK_THRESHOLD}
    if not active:
        where = f" {scope}" if scope else ""
        entry["note"] = (
            f"bf16_gram REFUSED{where}: C * p90|dK| = {risk:.4g} > "
            f"{BF16_RISK_THRESHOLD} — storage rounding at this (C, "
            f"kernel, data) risks O(1) decision changes; Gram stays "
            f"float32 (lower C / raise gamma to re-qualify)")
    return active, risk, entry


def warn_if_bf16_degrades(x, config) -> None:
    """Warn when dtype='bfloat16' is configured where storage rounding is
    likely to destroy solution quality (rbf only). Called by solve and
    solve_mesh before any device work; the text is the JAX package's."""
    if config.dtype != "bfloat16" or config.kernel != "rbf":
        return
    import warnings

    gamma = config.resolve_gamma(np.asarray(x).shape[1])
    risk = max(config.c_bounds()) * bf16_rbf_perturbation(x, gamma)
    if risk > BF16_RISK_THRESHOLD:
        warnings.warn(
            f"dtype='bfloat16' is likely to destroy solution quality for "
            f"this data: C * p90|dK| = {risk:.3f} > {BF16_RISK_THRESHOLD} "
            f"(bf16 feature rounding perturbs RBF kernel values enough "
            f"for the box bound C to amplify into O(1) decision changes; "
            f"measured on the covtype stress config this costs 0.97 -> "
            f"0.59 train accuracy, BENCH_COVTYPE.md). Use "
            f"dtype='float32', or lower C / raise gamma.",
            stacklevel=3)
