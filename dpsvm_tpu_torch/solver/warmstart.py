"""Warm-start carries for the solver stack (counterpart of
dpsvm_tpu/solver/warmstart.py).

A solve seeded from a previous model's support vectors converges in a
fraction of a cold solve's pairs (Graf et al.'s cascade SVM). Pieces:

* :class:`WarmStart`: seed alpha values and an optional row map placing
  them in the NEW training set (:func:`seed_from_model` builds the
  layout ``concat(prev.sv_x, fresh_rows)``);
* :func:`repair_seed`: the feasibility repair in host float64, the JAX
  package's NumPy code: clip into the new per-class box, scale the
  heavier class side down to the lighter one's mass, and push the
  round-off residual of sum(alpha_i y_i) onto a coordinate with slack;
* :func:`warm_f_rebuild`: f = K (alpha y) - y in ONE streamed pass over
  X through the out-of-core solver's double-buffered stream
  (solver/ooc.py TileStream) and its tile fold (ops/ooc.py
  ooc_fold_tile, want_dots=False): no second Gram pass exists here. Its
  float64 counterpart is solver/reconstruct.py gram_matvec_f64;
* :func:`prepare_warm_start`: repair + rebuild, the solvers' front door.

* :func:`warm_rebuild_mesh`: the same gradient on a mesh (solve_mesh's
  warm starts): one masked sum a seed block gathers the seed rows from
  the row-sharded X, and each shard folds its slice locally.

The zero-seed contract: a seed that repairs to all zeros (warm_start=None
included) returns (None, None, stats), so the solvers' cold branches run
bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Seed rows are folded in device blocks of this many query rows
# (zero-coefficient padding is inert in coef @ K).
Q_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """A solver seed: ``alpha[i]`` seeds training row ``rows[i]``;
    ``rows=None`` means ``alpha`` is a full (n,) vector. The values are
    repaired before use, so a carry from another C or class weighting is
    legal (the cascade and C-sweep case)."""

    alpha: np.ndarray
    rows: Optional[np.ndarray] = None

    def dense(self, n: int) -> np.ndarray:
        """The seed as a float64 (n,) vector."""
        a = np.asarray(self.alpha, np.float64).ravel()
        if self.rows is None:
            if a.shape[0] != n:
                raise ValueError(
                    f"WarmStart without rows wants a full ({n},) alpha "
                    f"vector, got shape {a.shape}")
            return a.copy()
        rows = np.asarray(self.rows, np.int64).ravel()
        if rows.shape != a.shape:
            raise ValueError(
                f"WarmStart rows/alpha length mismatch: {rows.shape} "
                f"vs {a.shape}")
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise ValueError(
                f"WarmStart rows out of range for n={n}: "
                f"[{rows.min()}, {rows.max()}]")
        out = np.zeros(n, np.float64)
        out[rows] = a
        return out


def seed_from_model(model) -> WarmStart:
    """A prior SVMModel's SV alphas seeding rows 0..n_sv-1: the layout
    of an increment built as concat(model.sv_x, fresh_rows)."""
    n_sv = int(model.sv_alpha.shape[0])
    return WarmStart(alpha=np.asarray(model.sv_alpha, np.float64),
                     rows=np.arange(n_sv, dtype=np.int64))


def repair_seed(alpha: np.ndarray, y: np.ndarray, c_bounds: tuple,
                max_fix_rounds: int = 8):
    """Feasibility repair in host float64. Returns (repaired (n,)
    float64, stats): 0 <= a_i <= box_i (c_pos for y_i = +1, c_neg for
    -1) and sum(a_i y_i) = 0, driven to exactly 0.0 by the slack
    correction in the generic case. The clip runs first (a shrunk box can
    unbalance the sides), then each side is scaled DOWN to the lighter
    side's mass, then the residual lands on one coordinate with room."""
    y64 = np.asarray(y, np.float64)
    a = np.asarray(alpha, np.float64).copy()
    n = a.shape[0]
    if y64.shape[0] != n:
        raise ValueError(f"alpha/y length mismatch: {n} vs {y64.shape[0]}")
    c_pos, c_neg = float(c_bounds[0]), float(c_bounds[1])
    box = np.where(y64 > 0, c_pos, c_neg)
    clipped = np.clip(a, 0.0, box)
    n_clipped = int(np.count_nonzero(clipped != a))
    a = clipped
    pos, neg = y64 > 0, y64 <= 0
    s_pos = float(a[pos].sum())
    s_neg = float(a[neg].sum())
    target = min(s_pos, s_neg)
    if target <= 0.0:
        # One side carries no mass: scaling down reaches only alpha = 0,
        # the cold start.
        a[:] = 0.0
        return a, {"seed_nnz": 0, "clipped": n_clipped,
                   "side_sums": (s_pos, s_neg), "scaled_to": 0.0,
                   "residual": 0.0, "zero_seed": True}
    if s_pos > target:
        a[pos] *= target / s_pos
    if s_neg > target:
        a[neg] *= target / s_neg
    residual = float(np.dot(a, y64))
    for _ in range(max_fix_rounds):
        if residual == 0.0:
            break
        # a_j -> a_j - r y_j zeroes the sum if the move stays in the box.
        need = residual * y64
        ok = (a - need >= 0.0) & (a - need <= box)
        cand = np.nonzero(ok & (a > 0.0))[0]
        if cand.size == 0:
            cand = np.nonzero(ok)[0]
        if cand.size == 0:  # pragma: no cover - degenerate box
            break
        j = int(cand[np.argmax(a[cand])])
        a[j] -= residual * y64[j]
        residual = float(np.dot(a, y64))
    nnz = int(np.count_nonzero(a))
    return a, {"seed_nnz": nnz, "clipped": n_clipped,
               "side_sums": (s_pos, s_neg), "scaled_to": target,
               "residual": residual, "zero_seed": nnz == 0}


def warm_f_rebuild(x, y, alpha: np.ndarray, kp, device=None,
                   tile_rows: int = 8192, q_block: int = Q_BLOCK,
                   dtype: str = "float32", stream=None) -> np.ndarray:
    """f = K (alpha y) - y from a repaired seed in ONE streamed pass over
    X, as float32 (n,) on the host.

    Host X goes through solver/ooc.py TileStream (`stream`, or a new one
    of `tile_rows` rows): on the card two pinned buffers, the uploads on
    a side stream, each buffer reused only behind its fold's event. Each
    tile's gradient slice is folded by ops/ooc.py ooc_fold_tile
    (want_dots=False) against the seed rows, held on the device in
    `q_block`-row blocks. The gradient stays on the device until the pass
    ends. `dtype` is X's storage dtype as the solve stores it (the JAX
    package folds float32 X whatever the solve stores; the port folds
    the stored rows, so a bfloat16 solve starts from its own problem's
    gradient). The norms are the device squared_norms of the stored rows
    (the JAX package takes them on the host)."""
    import torch

    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.ops import ooc as ooc_ops
    from dpsvm_tpu_torch.ops.kernels import squared_norms
    from dpsvm_tpu_torch.solver.ooc import TileStream
    from dpsvm_tpu_torch.solver.solve import _tdtype

    x = np.asarray(x)  # a memmap stays a lazy view
    n, d = x.shape
    y_np = np.asarray(y, np.float32)
    coef = (np.asarray(alpha, np.float64)
            * np.asarray(y, np.float64)).astype(np.float32)
    f = (-y_np).astype(np.float32)
    nz = np.nonzero(coef != 0.0)[0]
    if nz.size == 0:
        return f
    dev = resolve_device(device)
    qblocks = []
    for s in range(0, nz.size, q_block):
        idx = nz[s:s + q_block]
        qx = np.zeros((q_block, d), np.float32)
        qx[:idx.size] = np.asarray(x[idx], np.float32)
        qc = np.zeros((q_block,), np.float32)
        qc[:idx.size] = coef[idx]
        qx_d = torch.from_numpy(qx).to(dev).to(_tdtype(dtype))
        qblocks.append((qx_d, squared_norms(qx_d),
                        torch.from_numpy(qc).to(dev)))
    if stream is None:
        stream = TileStream(x, n, d, max(1, min(int(tile_rows), n)), dev,
                            dtype)
    tile = stream.tile
    f_dev = torch.from_numpy(f).to(dev)
    for i, xt, rows in stream.walk(range(-(-n // tile))):
        s = i * tile
        xsq = squared_norms(xt)
        ft = f_dev[s:s + rows]
        for qx_d, qsq_d, qc_d in qblocks:
            ft, _, _ = ooc_ops.ooc_fold_tile(xt, xsq, ft, None, qx_d, qsq_d,
                                             qc_d, kp, want_dots=False,
                                             compensated=False)
        f_dev[s:s + rows] = ft
    return f_dev.cpu().numpy()


def warm_rebuild_mesh(x, y, alpha: np.ndarray, kp, mesh,
                      q_block: int = Q_BLOCK,
                      dtype: str = "float32") -> np.ndarray:
    """The mesh form of :func:`warm_f_rebuild` (the JAX package's
    warm_rebuild_mesh), same contract: X row-sharded over `mesh`
    (parallel/mesh.py Mesh) as the solve shards it, in `dtype`; per
    block of `q_block` seed rows ONE masked sum gathers the block's rows,
    norms and coefficients from the shards that own them, and each shard
    folds its gradient slice locally. The norms are the squared norms of
    the stored rows, on the device. On a mesh that spans processes each
    process folds its own ranks' slices and the result is gathered from
    every process (the same array in each)."""
    import torch

    from dpsvm_tpu_torch.ops.kernels import kernel_rows, squared_norms
    from dpsvm_tpu_torch.parallel.mesh import shard_padded_rows, unshard
    from dpsvm_tpu_torch.solver.solve import _tdtype

    x = np.asarray(x, np.float32)
    n, d = x.shape
    y_np = np.asarray(y, np.float32)
    coef = (np.asarray(alpha, np.float64)
            * np.asarray(y, np.float64)).astype(np.float32)
    f = (-y_np).astype(np.float32)
    nz = np.nonzero(coef != 0.0)[0]
    if nz.size == 0:
        return f
    x_sh = shard_padded_rows(mesh, x, dtype=_tdtype(dtype))
    n_loc = x_sh[0].shape[0]
    xsq = [squared_norms(xr) for xr in x_sh]
    f_sh = shard_padded_rows(mesh, np.pad(f, (0, n_loc * mesh.size - n)))
    coef_sh = shard_padded_rows(mesh, np.pad(coef, (0, n_loc * mesh.size
                                                    - n)))
    for s in range(0, nz.size, q_block):
        idx = np.zeros(q_block, np.int64)
        idx[:min(q_block, nz.size - s)] = nz[s:s + q_block]
        live = np.arange(q_block) < nz.size - s
        parts = []
        for r, xr, sq, cr in zip(mesh.local_ranks, x_sh, xsq, coef_sh):
            loc = idx - r * n_loc
            own = torch.as_tensor(live & (loc >= 0) & (loc < n_loc),
                                  device=xr.device)[:, None]
            l_safe = torch.as_tensor(np.clip(loc, 0, n_loc - 1),
                                     device=xr.device)
            packed = torch.cat([xr[l_safe].float(), sq[l_safe, None],
                                cr[l_safe, None]], dim=1)
            parts.append(torch.where(own, packed, 0.0))
        seeds = mesh.psum(parts)  # (q_block, d + 2) per device group
        for i, (xr, sq) in enumerate(zip(x_sh, xsq)):
            seed = seeds[mesh.group_of[i]]
            k = kernel_rows(xr, sq, seed[:, :d].to(xr.dtype), seed[:, d],
                            kp)
            f_sh[i] = f_sh[i] + seed[:, d + 1] @ k
    return unshard(f_sh, mesh)[:n]


def prepare_warm_start(x, y, config, warm: Optional[WarmStart],
                       device=None, mesh=None):
    """Repair + rebuild. Returns (alpha_init, f_init, stats) as float32
    host arrays for the solvers' alpha_init / f_init, or (None, None,
    stats) when the repaired seed is all zeros, so the caller's cold
    branch runs bit for bit. `mesh` (a parallel/mesh.py Mesh of more than
    one shard) rebuilds the gradient on the mesh (warm_rebuild_mesh);
    otherwise one streamed pass on `device` (warm_f_rebuild)."""
    x = np.asarray(x)
    n, d = x.shape
    stats: dict = {"seed_rows": 0}
    if warm is None:
        return None, None, {**stats, "zero_seed": True}
    dense = warm.dense(n)
    stats["seed_rows"] = int(np.count_nonzero(dense))
    repaired, rstats = repair_seed(dense, y, config.c_bounds())
    stats.update(rstats)
    if rstats["zero_seed"]:
        return None, None, stats
    from dpsvm_tpu_torch.ops.kernels import KernelParams

    kp = KernelParams(config.kernel, config.resolve_gamma(d), config.degree,
                      config.coef0)
    if mesh is not None and mesh.size > 1:
        f = warm_rebuild_mesh(x, y, repaired, kp, mesh, dtype=config.dtype)
    else:
        f = warm_f_rebuild(x, y, repaired, kp,
                           device=device if mesh is None else mesh.devices[0],
                           tile_rows=int(config.ooc_tile_rows),
                           dtype=config.dtype)
    return repaired.astype(np.float32), f, stats
