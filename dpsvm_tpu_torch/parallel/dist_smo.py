"""Distributed SMO over the data mesh (counterpart of
dpsvm_tpu/parallel/dist_smo.py: ``solve_mesh`` and the block branch of
``_solve_mesh_impl``).

Everything row-indexed is sharded over the mesh's ranks: X, y, f, alpha.
Shards are equal by construction: rows are padded to a multiple of the
shard count and masked out of selection. One Python process drives all
shards (parallel/mesh.py); the engines are parallel/dist_block.py's
global and shard-local runners.

The solve is observed chunk by chunk as on one device
(solver/chunks.py): a callback, verbose and check_numerics on every
runner; checkpoints and resume on the global runner, with the same file
as one device's (a one-device checkpoint resumes on the mesh and back).

Not ported (each refused with NotImplementedError naming its ROADMAP
item): the per-pair mesh engine (engine="xla" on the mesh), the
pipelined, fused, active-set and out-of-core mesh runners, warm starts
and the nu rule (so the model families), reconstruction legs and
checkpoints of the shard-local runner (queue A item 10b), fault retry
and obs.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.device import precision_ctx, resolve_device
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                         squared_norms,
                                         warn_if_bf16_degrades)
from dpsvm_tpu_torch.ops.select import refresh_extrema_host
from dpsvm_tpu_torch.parallel.dist_block import (
    MeshBlockState, make_block_chunk_runner,
    make_block_shardlocal_chunk_runner)
from dpsvm_tpu_torch.parallel.mesh import (Mesh, make_data_mesh, pad_rows,
                                           replicate_array,
                                           shard_padded_rows, unshard)
from dpsvm_tpu_torch.solver import chunks
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.smo import read_obs
from dpsvm_tpu_torch.solver.solve import _BUDGET_EPS, storage_dtype
from dpsvm_tpu_torch.utils.checkpoint import PeriodicCheckpointer

# Shard-local chunks are bounded to this many sync windows: the host's
# endgame-demotion check reads the gap at chunk boundaries. Small enough
# that a stalled engine is demoted promptly; large enough that the check
# is amortized over thousands of pair updates.
_SHARDLOCAL_WINDOWS_PER_CHUNK = 8


def _refuse_unported(config: SVMConfig) -> None:
    """The mesh knobs of the JAX package this slice does not port."""
    if config.engine == "xla":
        raise NotImplementedError(
            "engine='xla' on the mesh (the per-pair mesh engine) is not "
            "ported (ROADMAP queue A item 10b); use engine='block'")
    later = (
        (bool(config.pipeline_rounds), "pipeline_rounds=True"),
        (bool(config.fused_fold), "fused_fold=True"),
        (bool(config.fused_round), "fused_round=True"),
        (config.active_set_size > 0, "active_set_size>0"),
        (config.ooc, "ooc=True"),
    )
    for bad, what in later:
        if bad:
            raise NotImplementedError(
                f"{what} on the mesh is not ported (ROADMAP queue A item "
                "10b); the mesh runs the global and the shard-local block "
                "runners")


def solve_mesh(x, y, config: SVMConfig, num_devices: Optional[int] = None,
               mesh: Optional[Mesh] = None, callback=None,
               checkpoint_path: Optional[str] = None, resume: bool = False,
               alpha_init=None, f_init=None,
               warm_start=None) -> SolveResult:
    """Train binary C-SVC row-sharded over the mesh.

    `mesh=None` takes the visible CUDA cards (the first `num_devices` of
    them) and raises without one. ``Mesh([torch.device("cuda:0")] * 4)``
    runs four logical shards on one card; ``Mesh(["cpu"] * 2)`` runs the
    plain PyTorch path. stats["mesh_devices"] lists the devices by rank.
    `callback`, `checkpoint_path` and `resume` follow solve()'s contract
    (solver/solve.py). Warm starts (`alpha_init` / `f_init`,
    `warm_start`) and selection="nu", which the model families need,
    the out-of-core stream (ooc), reconstruction legs and checkpoints of
    the shard-local runner are refused (ROADMAP queue A item 10b).
    """
    if config.engine not in ("xla", "block"):
        raise ValueError(
            f"engine={config.engine!r} is implemented for the single-chip "
            "solver only; the mesh backend supports engine='block' "
            "(distributed decomposition)")
    if config.kernel == "precomputed" and config.engine != "block":
        raise ValueError(
            "kernel='precomputed' on the mesh is implemented for "
            "engine='block' (Gram symmetry makes its fold a local column "
            "gather and the (q, q) block a q^2-sized psum — "
            "parallel/dist_block.py); the per-pair mesh engine would "
            "move a full (n,) Gram row per pair update — use "
            "engine='block' or backend='single'")
    if warm_start is not None:
        raise NotImplementedError(
            "warm_start on the mesh (the one-psum warm rebuild, "
            "warm_rebuild_mesh) is not ported (ROADMAP queue A item 10b); "
            "warm starts run on one device (backend='single')")
    if alpha_init is not None or f_init is not None \
            or config.selection == "nu":
        raise NotImplementedError(
            "warm starts (alpha_init / f_init) and selection='nu' on the "
            "mesh are not ported (ROADMAP queue A item 10b); the model "
            "families run on one device (backend='single')")
    _refuse_unported(config)
    config.check_ported()
    if config.reconstruct_every:
        raise NotImplementedError(
            "reconstruct_every on the mesh (its legs warm-start the mesh "
            "solve) is not ported (ROADMAP queue A item 10b); run the legs "
            "on one device (backend='single')")
    t_entry = time.perf_counter()
    x = np.asarray(x, np.float32)
    warn_if_bf16_degrades(x, config)
    if mesh is None:
        mesh = make_data_mesh(num_devices)
    for dev in {d for d, _ in mesh.groups}:
        resolve_device(dev)  # raises without CUDA; sets the float32 policy

    y_np = np.asarray(y, np.int32)
    n, d = x.shape
    kp = KernelParams(config.kernel, config.resolve_gamma(d), config.degree,
                      config.coef0)
    n_dev = mesh.size
    # Explicit knobs only: the autos are off until an H100 measurement
    # decides them.
    lws = config.local_working_sets
    use_shardlocal = (lws is not None and lws >= 2
                      and not config.budget_mode)
    if use_shardlocal and checkpoint_path and (config.checkpoint_every > 0
                                               or resume):
        raise NotImplementedError(
            "checkpoints of the shard-local mesh runner "
            "(local_working_sets >= 2) are not ported (ROADMAP queue A "
            "item 10b); the global runner checkpoints")
    use_ring = n_dev > 1 and bool(config.ring_exchange)

    n_pad = pad_rows(n, n_dev)
    n_loc = n_pad // n_dev
    y_p = np.ones((n_pad,), np.float32)
    y_p[:n] = y_np
    valid_p = np.zeros((n_pad,), bool)
    valid_p[:n] = True
    store_dtype, extra = storage_dtype(x, config, kp.gamma)
    dtype = torch.bfloat16 if store_dtype == "bfloat16" else torch.float32
    y_sh = shard_padded_rows(mesh, y_p)
    valid_sh = shard_padded_rows(mesh, valid_p)
    if kp.kind == "precomputed":
        if n != d:
            raise ValueError(
                f"kernel='precomputed' needs the square (n, n) Gram "
                f"matrix as x; got {x.shape}")
        # Both axes padded: rows shard over the ranks, and the symmetric
        # column gathers index columns by the same padded global ids
        # (padded rows and columns are zero and masked out by `valid`).
        x_cols = np.zeros((n, n_pad), np.float32)
        x_cols[:, :n] = x
        x_sh = shard_padded_rows(mesh, x_cols, dtype=dtype)
        # The diagonal through the storage rounding of the shards, so
        # eta mixes equal precisions as on one device.
        diag = torch.as_tensor(np.ascontiguousarray(np.diagonal(x)))
        diag_p = np.zeros((n_pad,), np.float32)
        diag_p[:n] = diag.to(dtype).float().numpy()
        k_diag = shard_padded_rows(mesh, diag_p)
        x_sq = [torch.zeros_like(kd) for kd in k_diag]
    else:
        x_sh = shard_padded_rows(mesh, x, dtype=dtype)
        # x_sq from the STORED (possibly rounded) rows, as on a single
        # device.
        x_sq = [squared_norms(xr) for xr in x_sh]
        k_diag = [kernel_diag(s, kp) for s in x_sq]

    def rep(value, dt):
        return replicate_array(mesh, np.asarray(value, dt))

    start = chunks.start_state(y_np, config, checkpoint_path, resume)
    a_start, f_start, err_start = start.padded(n_pad)
    state = MeshBlockState(
        alpha=shard_padded_rows(mesh, a_start),
        f=shard_padded_rows(mesh, f_start),
        b_hi=rep(start.b_hi, np.float32), b_lo=rep(start.b_lo, np.float32),
        pairs=rep(start.pairs, np.int32), rounds=rep(start.rounds, np.int32),
        f_err=(None if err_start is None
               else shard_padded_rows(mesh, err_start)))
    ckpt = PeriodicCheckpointer(checkpoint_path, config, start.pairs)
    observe = chunks.observed(config, callback, ckpt)

    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    # Block height clamped so each shard can produce q/2 candidates.
    q = max(2, min(config.working_set_size, 2 * n_loc))
    q -= q % 2
    inner = config.inner_iters or 2 * q
    common = dict(selection=config.selection, compensated=config.compensated,
                  pair_batch=int(config.pair_batch), ring_exchange=use_ring)
    bound = chunks.round_bound(config, observe, inner)

    def plain_runner():
        # The default dispatch, and the shard-local engine's endgame
        # demotion. The ring exchange rides along (bit-identical).
        return make_block_chunk_runner(
            mesh, kp, config.c_bounds(), eps_run, float(config.tau), q,
            inner, bound, **common)

    r_sync = int(config.sync_rounds)
    if use_shardlocal:
        # The endgame demotion reads the gap at chunk boundaries, so
        # shard-local chunks are always bounded (an observed solve's
        # chunk is its round bound in whole sync windows).
        win = (max(1, bound // r_sync) if observe
               else _SHARDLOCAL_WINDOWS_PER_CHUNK)
        runner = make_block_shardlocal_chunk_runner(
            mesh, kp, config.c_bounds(), eps_run, float(config.tau), q,
            inner, win * r_sync, r_sync, **common)
    else:
        runner = plain_runner()

    max_iter = int(config.max_iter)
    # The endgame demotion: the concurrent shard-local chains are a
    # bulk-phase accelerator. Once the global gap stops halving across a
    # chunk's worth of local rounds, or is within 10 epsilon of done, the
    # host swaps in the exact global-working-set runner for the tail. The
    # test runs on the last chunk's observation, before the next chunk.
    live = {"shardlocal": use_shardlocal, "runner": runner, "obs": None,
            "gap_ref": None, "demoted_at": None, "syncs": 0}
    stall_rounds = _SHARDLOCAL_WINDOWS_PER_CHUNK * r_sync

    def run_chunk(st):
        if live["shardlocal"] and live["obs"] is not None:
            it, b_hi, b_lo = live["obs"]
            gap = b_lo - b_hi
            rounds_now = int(st.rounds[0])
            ref = live["gap_ref"]
            if ref is None or gap <= 0.5 * ref[0]:
                live["gap_ref"] = ref = (gap, rounds_now)  # halved
            stalled = rounds_now - ref[1] >= stall_rounds
            if gap <= 10.0 * float(config.epsilon) or stalled:
                live["runner"] = plain_runner()
                live["shardlocal"] = False
                live["demoted_at"] = {"pairs": it, "rounds": rounds_now,
                                      "gap": gap, "stalled": bool(stalled)}
        was_local = live["shardlocal"]
        r0 = int(st.rounds[0]) if was_local else 0
        st = live["runner"](x_sh, y_sh, x_sq, k_diag, valid_sh, st, max_iter)
        if was_local:
            live["syncs"] += (int(st.rounds[0]) - r0) // r_sync
        return st

    def read(st):
        (it,), (b_hi, b_lo) = read_obs((st.pairs[0],), (st.b_hi[0],
                                                        st.b_lo[0]))
        live["obs"] = (it, b_hi, b_lo)
        return it, b_hi, b_lo

    def payload(st):
        err = None if st.f_err is None else unshard(st.f_err)[:n]
        return (unshard(st.alpha)[:n], unshard(st.f)[:n], err,
                int(st.rounds[0]))

    with precision_ctx(config):
        out = chunks.run_chunks(
            run_chunk, state, read, config=config, eps_run=eps_run,
            callback=callback, ckpt=ckpt, start_iter=start.pairs,
            sync=mesh.synchronize, payload=payload,
            tensors=lambda st: (st.f, st.alpha), backend=f"mesh p={n_dev}",
            t_entry=t_entry)
    t_fin = time.perf_counter()
    state = out.state
    it, b_hi, b_lo = out.it, out.b_hi, out.b_lo
    converged = not (b_lo > b_hi + 2.0 * eps_run)
    rounds_now = int(state.rounds[0])
    syncs, demoted_at = live["syncs"], live["demoted_at"]
    alpha = unshard(state.alpha)[:n]
    f_parts = (state.f if state.f_err is None
               else [f - e for f, e in zip(state.f, state.f_err)])
    f_final = unshard(f_parts)[:n]
    if not converged:
        b_hi, b_lo, converged = refresh_extrema_host(
            f_final, alpha, y_np, config.c_bounds(), config.epsilon,
            rule=config.selection)
    stats = {
        "num_devices": n_dev,
        "mesh_devices": mesh.describe(),
        "rows_padded": n_pad - n,
        "f": f_final,
        "outer_rounds": rounds_now,
        "device": str(mesh.devices[0]),
        "n_pad": n_pad,
        "chunks": out.chunks,
        "phase_seconds": out.phase_seconds,
        **extra,
    }
    if use_shardlocal:
        stats["shardlocal_demoted"] = demoted_at is not None
        stats["shardlocal_syncs"] = syncs
        if demoted_at is not None:
            stats["shardlocal_demotion"] = demoted_at
    if use_ring:
        stats["ring_exchange"] = True
    out.phase_seconds["finalize"] = time.perf_counter() - t_fin
    return SolveResult(
        alpha=alpha, b=float((b_lo + b_hi) / 2.0), b_hi=b_hi, b_lo=b_lo,
        iterations=it, converged=converged,
        train_seconds=out.train_seconds, stats=stats)
