"""High-level training API: data in, SVMModel out (counterpart of
dpsvm_tpu/train.py): the single-device, mesh and host backends."""

from __future__ import annotations

import numpy as np

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.solve import solve


def resolve_backend(backend: str, config: SVMConfig, device=None,
                    num_devices=None, mesh=None, warm: bool = False) -> str:
    """"single", "mesh", "reference" or "native" for a `backend`
    request. "auto" takes the mesh when one is given, when the job spans
    several processes (parallel/mesh.py initialize_multihost), or when
    no `device` is named and more than one card is visible (or asked
    for), as the JAX package's auto does: for train() (`warm` False) only where the
    engine is "xla" or "block"; for the model families' warm-started
    solves (`warm` True) whatever the engine. Out-of-core requests take
    the mesh too (its tile stream, solver/ooc.py solve_ooc_mesh), except
    where they ask for the block cache, the shrunken stream or an active
    set, which are single-device (the JAX package's single_only_ooc). An
    explicit "mesh" stands: solve_mesh refuses what the mesh does not
    run. The host backends are the NumPy oracle and the native
    sequential engine."""
    if backend == "auto":
        import torch

        from dpsvm_tpu_torch.parallel.mesh import process_count

        multi = process_count() > 1 or (
            device is None
            and (num_devices or torch.cuda.device_count()) > 1)
        engine_ok = warm or config.engine in ("xla", "block")
        single_only_ooc = config.ooc and (
            config.ooc_cache_lines > 0 or bool(config.ooc_shrink)
            or config.active_set_size > 0)
        backend = ("mesh" if (multi or mesh is not None) and engine_ok
                   and not single_only_ooc else "single")
    if backend not in ("single", "mesh", "reference", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def host_device(backend: str, device=None, mesh=None):
    """The device a model family computes its start gradient on: the
    mesh's first device when the solve runs on a given mesh, else
    `device` resolved (None: the CUDA card)."""
    if backend == "mesh" and mesh is not None:
        return mesh.devices[0]
    from dpsvm_tpu_torch.device import resolve_device

    return resolve_device(device)


def solve_on(backend: str, x, y, config: SVMConfig, device=None,
             num_devices=None, mesh=None, alpha_init=None, f_init=None,
             callback=None, checkpoint_path=None, resume: bool = False,
             pad_to=None) -> SolveResult:
    """Run the solve on a resolved device backend ("single" or "mesh").
    `pad_to` reaches the single device only (the mesh sizes its own
    shards; it never changes results)."""
    if backend not in ("single", "mesh"):
        raise ValueError(
            f"backend={backend!r} is a host C-SVC engine; the warm-started "
            "model families run on 'single' or 'mesh'")
    if backend == "mesh":
        from dpsvm_tpu_torch.parallel.dist_smo import solve_mesh

        return solve_mesh(x, y, config, num_devices=num_devices, mesh=mesh,
                          callback=callback, checkpoint_path=checkpoint_path,
                          resume=resume, alpha_init=alpha_init,
                          f_init=f_init)
    return solve(x, y, config, device=device, callback=callback,
                 checkpoint_path=checkpoint_path, resume=resume,
                 alpha_init=alpha_init, f_init=f_init, pad_to=pad_to)


def _solve_host(backend: str, x, y, config: SVMConfig, callback,
                checkpoint_path, resume) -> SolveResult:
    """The host backends: fixed engines (mvp selection) that run to
    completion in one call, with no checkpoints. A callback gets one
    final record."""
    if config.engine != "xla" or config.selection != "mvp":
        raise ValueError(
            f"backend={backend!r} is a fixed host engine (MVP selection); "
            "it cannot honor engine/selection overrides — drop them or "
            "pick another backend")
    if checkpoint_path or resume:
        raise ValueError(
            f"backend={backend!r} does not support checkpoint/resume; "
            "use the 'single' or 'mesh' backend for long runs")
    from types import SimpleNamespace

    from dpsvm_tpu_torch.solver.reference import smo_native, smo_reference

    fn = smo_reference if backend == "reference" else smo_native
    result = fn(x, y, config)
    if callback is not None:
        # The namespace mirrors the per-pair state's fields.
        callback(result.iterations, result.b_hi, result.b_lo,
                 SimpleNamespace(alpha=result.alpha, f=result.stats["f"],
                                 b_hi=result.b_hi, b_lo=result.b_lo,
                                 it=result.iterations, hits=0))
    return result


def train(x, y, config: SVMConfig = SVMConfig(), backend: str = "auto",
          device=None, num_devices=None, mesh=None, callback=None,
          checkpoint_path=None, resume: bool = False,
          pad_to=None) -> tuple[SVMModel, SolveResult]:
    """Train binary C-SVC with the engine config.engine names. Labels
    must be in {-1, +1}.

    backend "single" runs on `device` (None: the CUDA card; the tests
    pass "cpu"). backend "mesh" shards the rows over `mesh`
    (parallel/mesh.py Mesh; None: the first `num_devices` visible cards)
    and runs the mesh block engines. backend "auto" (the default, as in
    the JAX package) takes the mesh only where the mesh runs the request
    (resolve_backend); on a one-card host it is the single device.
    backend "reference" (NumPy) and "native" (native/seqsmo.cpp) run the
    sequential mvp SMO on the host: engine="xla" and selection="mvp"
    only, no checkpoints.

    `callback`, `checkpoint_path`, `resume` and `pad_to` follow
    solver/solve.py solve's contract; on the host backends the callback
    gets one final record."""
    backend = resolve_backend(backend, config, device, num_devices, mesh)
    x = np.asarray(x, np.float32)  # a float32 memmap stays a lazy view
    y = np.asarray(y, np.int32)
    labels = set(np.unique(y).tolist())
    if labels != {-1, 1}:
        raise ValueError(
            f"labels must contain both classes -1 and +1, got {sorted(labels)}")
    if config.kernel == "precomputed":
        raise ValueError(
            "kernel='precomputed' models carry SV indices, not feature "
            "rows — the reference-format model file cannot represent "
            "them. Solve directly (dpsvm_tpu_torch.solver.solve.solve) or "
            "use the sklearn facade (dpsvm_tpu_torch.estimators.SVC)")
    if backend in ("reference", "native"):
        result = _solve_host(backend, x, y, config, callback,
                             checkpoint_path, resume)
    else:
        result = solve_on(backend, x, y, config, device, num_devices, mesh,
                          callback=callback, checkpoint_path=checkpoint_path,
                          resume=resume, pad_to=pad_to)
    kp = KernelParams(config.kernel, config.resolve_gamma(x.shape[1]),
                      config.degree, config.coef0)
    return SVMModel.from_dense(x, y, result.alpha, result.b, kp), result
