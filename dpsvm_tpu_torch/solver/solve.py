"""Single-device solve (counterpart of dpsvm_tpu/solver/smo.py solve /
_solve_impl): the block engines and the per-pair engines, observed chunk
by chunk (solver/chunks.py), checkpointed and resumed
(utils/checkpoint.py), in float64 reconstruction legs
(solver/reconstruct.py), and with X in bfloat16 where the bf16_gram
gate allows it."""

from __future__ import annotations

import functools
import time
import warnings

import numpy as np
import torch

from dpsvm_tpu_torch.config import SVMConfig
from dpsvm_tpu_torch.device import (precision_ctx, resolve_device,
                                    synchronize)
from dpsvm_tpu_torch.obs.trace import span
from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                         resident_gram, resolve_bf16_gram,
                                         squared_norms,
                                         warn_if_bf16_degrades)
from dpsvm_tpu_torch.ops.select import refresh_extrema_host
from dpsvm_tpu_torch.solver import block, chunks
from dpsvm_tpu_torch.solver import smo
from dpsvm_tpu_torch.solver.block import BlockState
from dpsvm_tpu_torch.solver.result import SolveResult
from dpsvm_tpu_torch.solver.smo import eff_f, read_obs
from dpsvm_tpu_torch.utils.checkpoint import PeriodicCheckpointer

# budget_mode runs the stopping test at this epsilon: b_lo > b_hi + 2 eps
# then never closes, so the loop runs to exactly max_iter pairs; finite
# so b_hi + 2 eps stays inf-free.
_BUDGET_EPS = -1e30

# Auto resident Gram (gram_resident=None, engine="xla"): the (n, n)
# float32 Gram may take this share of the card's memory
# (torch.cuda.get_device_properties().total_memory), and is not worth
# building below _GRAM_MIN_N rows. The CPU has no budget: auto stays off.
_GRAM_BUDGET_FRACTION = 0.70
_GRAM_MIN_N = 8192

# engine="pallas" pads rows to whole (64, 128) blocks of the JAX kernel's
# grid, so both packages solve the same padded problem.
_PALLAS_ROWS = 64 * 128


def block_height(config: SVMConfig, n: int) -> tuple:
    """(q, inner): the working-set height clamped to the data and kept
    even (balanced up/low halves; a multiple of 4 under selection="nu",
    for its per-class quarters), and the per-round pair budget
    (inner_iters, or 2q when 0)."""
    gran = 4 if config.selection == "nu" else 2
    q = max(gran, min(config.working_set_size, n))
    q -= q % gran
    return q, config.inner_iters or 2 * q


def choose_engine(config: SVMConfig, n: int, dev: torch.device,
                  gram: bool = False, gate=None) -> dict:
    """Which block engine runs, as the JAX package's solve picks it
    (solver/smo.py): pipeline_rounds first, then fused_round, then
    fused_fold. An explicit knob always wins. A None (auto)
    pipeline_rounds or fused_round asks `gate(knob, default)` (the
    solve's block.autotune_gate_resolver: the device profile's measured
    decision, default off), in the JAX package's order and only where
    that knob could run, so the provenance records exactly the gates
    consulted; gate=None takes every default. fused_fold=None stays off:
    no probe measures it (the JAX package's default is the TPU's). The fused
    engines, and the pipelined engine's one-pass selection (on CUDA
    only, as the JAX package takes it on the TPU only), need q/2 <=
    n_pad/128 with n_pad = n rounded up to 1024; where that fails the
    plain engine runs. active_set_size > 0 runs the active-set engine
    (run_chunk_block_active), ahead of every knob. Under selection="nu"
    the plain round runs whatever the knobs say, as in the JAX package:
    the fused and pipelined
    engines select two-sided mvp candidates, which would pair across the
    nu duals' classes. A precomputed Gram (kernel="precomputed", or the
    resident Gram: `gram`) has no features to stream, so the fused
    engines and the one-pass selection step down to the plain round;
    the pipelined round runs on it with its plain selection. Returns the
    flags under the JAX package's stats names and n_pad."""
    n_pad_fused = -(-n // 1024) * 1024
    active = config.active_set_size > 0
    shape_ok = (config.selection != "nu" and not active
                and config.kernel != "precomputed" and not gram
                and min(config.working_set_size, n_pad_fused)
                <= n_pad_fused // 64)
    if gate is None:
        def gate(_knob, default):
            return default
    pipelined = (config.selection != "nu" and not active
                 and (config.pipeline_rounds
                      if config.pipeline_rounds is not None
                      else (not config.fused_round
                            and gate("pipeline_rounds", False))))
    pipe_select = pipelined and dev.type == "cuda" and shape_ok
    fused_round = (not pipelined and shape_ok
                   and (config.fused_round if config.fused_round is not None
                        else gate("fused_round", False)))
    fused_fold = (not pipelined and not fused_round
                  and bool(config.fused_fold) and shape_ok)
    pad = fused_fold or fused_round or pipe_select
    return {"pipelined": bool(pipelined), "pipe_select": bool(pipe_select),
            "fused_round": bool(fused_round), "fused_fold": bool(fused_fold),
            "pad": pad, "n_pad": n_pad_fused if pad else n}


def active_set_height(config: SVMConfig, q: int, rows: int) -> int:
    """The active set's size m: active_set_size clamped to [q, rows] on
    the selection's class granularity (2, or 4 under the nu rule), as
    the JAX package clamps it (`rows` is n on one device, gran * n_loc
    on the mesh). 0 when the engine is off."""
    if not config.active_set_size:
        return 0
    gran = 4 if config.selection == "nu" else 2
    m = max(q, min(config.active_set_size, rows))
    return m - m % gran


def warn_active_set() -> None:
    """The JAX package's warning on active_set_size, without its TPU
    figures: the engine never beat the plain block engine in any regime
    measured on the TPU, and the H100 has no measurement deciding it."""
    warnings.warn(
        "active_set_size (shrinking) never beat the plain block engine in "
        "any regime measured on the TPU (the JAX package's "
        "BENCH_COVTYPE_SWEEP.md), and no measurement on this device says "
        "otherwise yet — prefer active_set_size=0 unless you have "
        "measured a win on your workload", stacklevel=4)


def gram_budget_bytes(dev: torch.device) -> int:
    """The bytes an auto resident Gram may take on `dev`: a share of the
    card's total memory on CUDA, 0 elsewhere."""
    if dev.type != "cuda":
        return 0
    total = torch.cuda.get_device_properties(dev).total_memory
    return int(_GRAM_BUDGET_FRACTION * total)


def resolve_gram(config: SVMConfig, n: int, dev: torch.device) -> bool:
    """Whether this solve runs on the resident Gram (the JAX package's
    _resolve_gram): never on engine="pallas" or a precomputed kernel
    (it is its own Gram); True / False as set (on engine="xla" and
    "block"); auto on engine="xla" when n >= 8192 and the Gram fits the
    budget. `n` is the row count the budget is judged at (solve's
    max(n, pad_to))."""
    if config.kernel == "precomputed" or config.engine == "pallas":
        return False
    if config.gram_resident is not None:
        return bool(config.gram_resident)
    return (config.engine == "xla" and n >= _GRAM_MIN_N
            and 4 * n * n <= gram_budget_bytes(dev))


def storage_dtype(x, config: SVMConfig, gamma: float) -> tuple:
    """(X's storage dtype, stats entries): config.dtype, or "bfloat16"
    where config.bf16_gram's gate (ops/kernels.py resolve_bf16_gram)
    accepts. The gate's decision goes to stats["bf16_gram"]; a refusal
    stays float32 and warns, as in the JAX package."""
    if not config.bf16_gram:
        return config.dtype, {}
    active, _, entry = resolve_bf16_gram(x, config, gamma)
    if not active:
        warnings.warn(entry["note"], stacklevel=3)
    return ("bfloat16" if active else "float32"), {"bf16_gram": entry}


def _host_fingerprint(a) -> tuple:
    """The content guard of the cross-solve memos (the JAX package's
    _host_fingerprint): the buffer address and a 256-point strided
    sample of raw values. The memos key on object identity, which cannot
    see an in-place rewrite (`x *= s`); whole-array and regional
    rewrites hit sampled points. Probabilistic by design: a full hash of
    X would cost more than the transfer it guards."""
    arr = np.asarray(a)
    try:
        addr = arr.ctypes.data
    except (AttributeError, TypeError):
        addr = None
    if arr.size == 0:
        return (addr, arr.shape, b"")
    idx = np.linspace(0, arr.size - 1, num=min(256, arr.size),
                      dtype=np.int64)
    return (addr, arr.shape, arr.flat[idx].tobytes())


def _memo_insert(memo: dict, key, x_host, payload: tuple) -> None:
    """Install a size-1 memo entry, (weakref, token, *payload,
    fingerprint), whose weakref finalizer evicts it when the host array
    dies, and only while the key still maps to this entry (the token):
    an older array's death must not evict a newer entry. The finalizer
    holds the token, not the entry, so no reference cycle keeps an
    evicted device Gram alive."""
    import weakref

    memo.clear()  # size-1: never two entries
    token = object()

    def _evict(_r, _memo=memo, _key=key, _token=token):
        ent = _memo.get(_key)
        if ent is not None and ent[1] is _token:
            _memo.pop(_key, None)

    try:
        ref = weakref.ref(x_host, _evict)
    except TypeError:
        return  # not weakref-able: no memo
    memo[key] = (ref, token, *payload, _host_fingerprint(x_host))


def _memo_get(memo: dict, key, x_host):
    """The payload memoized for `x_host` under `key`, or None: a hit
    needs the same object and an unchanged fingerprint."""
    ent = memo.get(key)
    if (ent is not None and ent[0]() is x_host
            and ent[-1] == _host_fingerprint(x_host)):
        return ent[2:-1]
    return None


def _dev_key(dev: torch.device) -> tuple:
    return (dev.type, dev.index)


# Size-1 memo of (X on the device, its squared norms), keyed by the
# padded shape, the storage dtype and the device, and held for the same
# host array (identity, weakref, fingerprint). One-vs-rest multiclass
# solves k problems on one X, and reconstruction legs solve one X again
# per leg: each pays the upload and the norm pass once. Counted in
# MEMO_STATS.
_XDEV_MEMO: dict = {}
# Size-1 memo of (resident Gram, kernel diagonal), keyed as _XDEV_MEMO
# plus the kernel and the matmul precision: a Gram of 60000 rows is 14.4
# GB, so a miss empties the memo before it builds.
_GRAM_MEMO: dict = {}
MEMO_STATS = {"x_uploads": 0, "x_hits": 0, "gram_builds": 0,
              "gram_hits": 0}


def _pad_host(x, n_pad: int) -> np.ndarray:
    n, d = x.shape
    if n_pad == n:
        return x
    x_p = np.zeros((n_pad, d), np.float32)
    x_p[:n] = x
    return x_p


def _tdtype(dtype: str):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def device_x_cached(x, n_pad: int, dtype: str, dev: torch.device) -> tuple:
    """(x_dev, x_sq) of a feature-kernel solve: X padded to n_pad rows
    (zero features), stored in `dtype`, and its squared norms from the
    STORED (possibly rounded) rows; memoized across solves on the same
    host array (_XDEV_MEMO). A miss's padding, copy and cast are the
    span ``solver/upload``; the norms lie outside it."""
    key = ((n_pad, x.shape[1]), dtype, _dev_key(dev))
    hit = _memo_get(_XDEV_MEMO, key, x)
    if hit is not None:
        MEMO_STATS["x_hits"] += 1
        return hit
    MEMO_STATS["x_uploads"] += 1
    with span("solver/upload", device=dev):
        x_dev = torch.as_tensor(_pad_host(x, n_pad), device=dev).to(
            _tdtype(dtype))
    x_sq = squared_norms(x_dev)
    _memo_insert(_XDEV_MEMO, key, x, (x_dev, x_sq))
    return x_dev, x_sq


def resident_gram_cached(x, n_pad: int, dtype: str, kp: KernelParams,
                         config: SVMConfig, dev: torch.device) -> tuple:
    """(gram, k_diag) of a resident-Gram solve: the (n_pad, n_pad)
    float32 kernel matrix of X stored in `dtype`, and the diagonal from
    the features; memoized across solves on the same host array
    (_GRAM_MEMO). A miss empties the memo first, so two Grams never
    live in it at once, and waits for the build before the solve
    allocates."""
    key = (kp, (n_pad, x.shape[1]), dtype, _dev_key(dev),
           config.resolve_precision())
    hit = _memo_get(_GRAM_MEMO, key, x)
    if hit is not None:
        MEMO_STATS["gram_hits"] += 1
        return hit
    _GRAM_MEMO.clear()
    MEMO_STATS["gram_builds"] += 1
    x_feat = torch.as_tensor(_pad_host(x, n_pad), device=dev).to(
        _tdtype(dtype))
    x_sq = squared_norms(x_feat)
    k_diag = kernel_diag(x_sq, kp)
    gram = resident_gram(x_feat, x_sq, kp)
    del x_feat
    synchronize(dev)
    _memo_insert(_GRAM_MEMO, key, x, (gram, k_diag))
    return gram, k_diag


def check_precomputed(x, n_pad: int) -> None:
    """The JAX package's precomputed-Gram rules, checked before any
    transfer: x is the square (n, n) Gram, and nothing pads it."""
    if x.shape[0] != x.shape[1]:
        raise ValueError(
            f"kernel='precomputed' needs the square (n, n) Gram "
            f"matrix as x; got {x.shape}")
    if n_pad != x.shape[0]:
        raise ValueError(
            "pad_to does not compose with kernel='precomputed' (the "
            "padded Gram rows/columns would need kernel values)")


def stage_x(x, n_pad: int, dtype: str, kp: KernelParams, use_gram: bool,
            config: SVMConfig, dev: torch.device) -> tuple:
    """(x_dev, x_sq, k_diag, kp) as the solve's rounds read them: the
    features and their norms; on the resident Gram, the Gram, a zero
    norm placeholder, the feature diagonal and kp "precomputed"; on a
    precomputed kernel, the caller's Gram, a zero placeholder (no O(n^2)
    norm pass) and the Gram's diagonal."""
    zeros = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    if use_gram:
        gram, k_diag = resident_gram_cached(x, n_pad, dtype, kp, config,
                                            dev)
        return gram, zeros, k_diag, KernelParams("precomputed")
    if kp.kind == "precomputed":
        x_dev = torch.as_tensor(x, device=dev).to(_tdtype(dtype))
        return x_dev, zeros, torch.diagonal(x_dev).float(), kp
    x_dev, x_sq = device_x_cached(x, n_pad, dtype, dev)
    return x_dev, x_sq, kernel_diag(x_sq, kp), kp


def _stage(y_np, n: int, n_pad: int, dev, masked: bool):
    """y (float32) and `valid` on the device, padded to n_pad rows
    (padded rows: y = 1, valid False; valid is None unless `masked`,
    which padding implies)."""
    y_p = y_np.astype(np.float32)
    valid = None
    if n_pad != n:
        y_p = np.ones((n_pad,), np.float32)
        y_p[:n] = y_np
    if masked or n_pad != n:
        valid = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        valid[:n] = True
    return torch.as_tensor(y_p, device=dev), valid


def _on(dev, a, dtype=torch.float32):
    """A host array or scalar copied to `dev` (None stays None)."""
    return None if a is None else torch.tensor(a, dtype=dtype, device=dev)


def _finish(alpha_dev, f_dev, n: int, y_np, config: SVMConfig,
            eps_run: float, b_hi: float, b_lo: float,
            refresh: bool) -> tuple:
    """(alpha, f, b_hi, b_lo, converged) of a finished loop, trimmed to
    n. `converged` is the host test at the run's epsilon; where it fails
    and `refresh` holds, the extrema are recomputed from the final state
    at the real epsilon."""
    converged = not (b_lo > b_hi + 2.0 * eps_run)
    alpha = alpha_dev[:n].cpu().numpy()
    f_final = f_dev[:n].cpu().numpy()
    if refresh and not converged:
        b_hi, b_lo, converged = refresh_extrema_host(
            f_final, alpha, y_np, config.c_bounds(), config.epsilon,
            rule=config.selection)
    return alpha, f_final, b_hi, b_lo, converged


def solve(x, y, config: SVMConfig, device=None, callback=None,
          checkpoint_path=None, resume: bool = False, alpha_init=None,
          f_init=None, pad_to=None, warm_start=None) -> SolveResult:
    """Train binary C-SVC on one device with the engine config.engine
    names: "block" (and its fused variants), or the per-pair engines
    "xla" (with the row cache, the resident Gram and micro-batching) and
    "pallas" (kernel B6).

    `device=None` means the CUDA card (raises without one); pass
    device="cpu" for the plain PyTorch path. X is stored in
    config.dtype (bfloat16 also where config.bf16_gram's gate accepts:
    stats["bf16_gram"] holds its decision, and a refusal warns); the
    solver state (alpha, f) is float32. Engines that pad the rows mask
    the padding out of every selection; alpha and f come back trimmed
    to n.

    `callback(iteration, b_hi, b_lo, state)` is called at every chunk
    boundary (solver/chunks.py); a truthy return stops the solve there
    and forces a checkpoint. An optional `callback.on_start(start_iter)`
    is called once. With `checkpoint_path` and config.checkpoint_every >
    0 the state is saved every checkpoint_every pairs (rounded up to a
    chunk); `resume=True` restarts from the newest loadable generation
    of the file when one exists (written by either package). A solve
    that nothing observes runs as one chunk.

    `alpha_init` / `f_init` (n,) override the C-SVC start point (alpha =
    0, f = -y): the general dual min 1/2 a^T Q a + p^T a with
    Q_ij = y_i y_j K_ij starts from f = y * (Q alpha_init + p). The
    model families use it (models/svr.py, nusvm.py, oneclass.py). A
    resumed checkpoint takes precedence. Padded rows start at alpha 0
    and f -y.

    config.reconstruct_every > 0 runs the solve in float64
    reconstruction legs (solver/reconstruct.py solve_in_legs). `pad_to`
    sizes the resident-Gram budget at max(n, pad_to) rows; it never
    changes results (no shape-keyed compile to bucket for, so nothing is
    padded), and a precomputed kernel refuses pad_to > n as the JAX
    package does.

    kernel="precomputed": x is the square (n, n) Gram (checked before
    any transfer); its diagonal is the kernel diagonal and the block
    round's K(W, W) is a column gather of the gathered rows.
    gram_resident=True runs the block or xla engine on the (n, n) Gram
    of X, built once (memoized across solves on the same host X, as is
    X's upload: _XDEV_MEMO, _GRAM_MEMO).

    `warm_start` (solver/warmstart.py WarmStart) seeds the solve from a
    previous model or alpha vector: repaired into this config's box and
    equality constraint, its gradient rebuilt in one streamed pass over
    X, then passed on as alpha_init / f_init (not both). A seed that
    repairs to zeros runs the cold path bit for bit; stats["warm_start"]
    reports the repair. config.ooc keeps X on the host and streams it
    (solver/ooc.py solve_ooc; `x` may be an np.memmap)."""
    if warm_start is not None:
        if alpha_init is not None or f_init is not None:
            raise ValueError(
                "pass either warm_start or alpha_init/f_init, not both")
        from dpsvm_tpu_torch.solver.warmstart import prepare_warm_start

        a0, f0, wstats = prepare_warm_start(x, y, config, warm_start,
                                            device=device)
        res = solve(x, y, config, device=device, callback=callback,
                    checkpoint_path=checkpoint_path, resume=resume,
                    alpha_init=a0, f_init=f0, pad_to=pad_to)
        res.stats["warm_start"] = wstats
        return res
    if config.selection == "nu" and alpha_init is None:
        # The nu rule pairs within one class; from the C-SVC zero start no
        # class has both an I_up and an I_low member, so the gap would
        # read closed at once and return a garbage model as converged.
        raise ValueError(
            "selection='nu' is internal to the nu duals — call "
            "train_nusvc/train_nusvr (models/nusvm.py) instead")
    config.check_ported()
    if config.ooc:
        from dpsvm_tpu_torch.solver.ooc import solve_ooc

        # solve_ooc runs its own fault retry; the demotion wraps it.
        return smo._solve_with_degradation(
            config, checkpoint_path, resume,
            lambda cfg, res: solve_ooc(
                x, y, cfg, callback=callback, device=device,
                checkpoint_path=checkpoint_path, resume=res,
                alpha_init=alpha_init, f_init=f_init, pad_to=pad_to))
    if config.reconstruct_every:
        from dpsvm_tpu_torch.solver.reconstruct import solve_in_legs

        return solve_in_legs(solve, x, y, config, callback=callback,
                             checkpoint_path=checkpoint_path, resume=resume,
                             alpha_init=alpha_init, f_init=f_init,
                             device=device, pad_to=pad_to)

    def run(cfg, res):
        def attempt(cfg_k, res_k, k):
            return _solve_impl(
                x, y, cfg_k, device,
                smo._retry_callback(callback, cfg_k, checkpoint_path, k),
                checkpoint_path, res_k, alpha_init, f_init, pad_to)

        return smo.run_with_fault_retry(cfg, checkpoint_path, res, attempt)

    return smo._solve_with_degradation(config, checkpoint_path, resume, run)


def _solve_impl(x, y, config: SVMConfig, device, callback, checkpoint_path,
                resume, alpha_init, f_init, pad_to) -> SolveResult:
    """One attempt of solve(): stage, run the chunk loop, assemble."""
    t_entry = time.perf_counter()
    x = np.asarray(x, np.float32)
    if config.kernel == "precomputed":
        check_precomputed(x, max(x.shape[0], int(pad_to or 0)))
    warn_if_bf16_degrades(x, config)
    dev = resolve_device(device)
    y_np = np.asarray(y, np.int32)
    n, d = x.shape
    gamma = config.resolve_gamma(d)
    kp = KernelParams(config.kernel, gamma, config.degree, config.coef0)
    store_dtype, extra = storage_dtype(x, config, gamma)
    eps_run = _BUDGET_EPS if config.budget_mode else float(config.epsilon)
    start = chunks.start_state(y_np, config, checkpoint_path, resume,
                               alpha_init, f_init)
    ckpt = PeriodicCheckpointer(checkpoint_path, config, start.pairs)
    observe = chunks.observed(config, callback, ckpt)
    loop = functools.partial(
        chunks.run_chunks, config=config, eps_run=eps_run,
        callback=callback, ckpt=ckpt, start_iter=start.pairs,
        sync=lambda: synchronize(dev), backend="single-device",
        t_entry=t_entry)
    args = (x, y_np, kp, config, dev, store_dtype, eps_run, start, observe,
            loop)
    with precision_ctx(config):
        if config.engine == "block":
            res = _solve_block(*args)
        else:
            res = _solve_pair(*args, max(n, int(pad_to or 0)))
    res.stats.update(extra)
    return res


def _run_meta(x, n_pad: int, config: SVMConfig, observe: bool,
              **flags) -> dict:
    """The run log's manifest meta of a one-device solve (the JAX
    package's keys)."""
    return {"n": int(x.shape[0]), "d": int(x.shape[1]), "n_pad": int(n_pad),
            "engine": config.engine, "kernel": config.kernel,
            "selection": config.selection,
            **{k: bool(v) for k, v in flags.items()},
            "observed_chunks": bool(observe)}


def _solve_block(x, y_np, kp, config, dev, store_dtype, eps_run, start,
                 observe, loop) -> SolveResult:
    n = x.shape[0]
    use_gram = resolve_gram(config, n, dev)
    gate, autotune_embed = block.autotune_gate_resolver(dev)
    eng = choose_engine(config, n, dev, gram=use_gram, gate=gate)
    n_pad = eng["n_pad"]
    x_dev, x_sq, k_diag, kp = stage_x(x, n_pad, store_dtype, kp, use_gram,
                                      config, dev)
    y_dev, valid = _stage(y_np, n, n_pad, dev, eng["pad"])
    q, inner = block_height(config, n_pad)
    alpha0, f0, err0 = (_on(dev, a) for a in start.padded(n_pad))
    state = BlockState(alpha0, f0, _on(dev, start.b_hi),
                       _on(dev, start.b_lo),
                       _on(dev, start.pairs, torch.int32),
                       _on(dev, start.rounds, torch.int32), err0)
    bound = chunks.round_bound(config, observe, inner)
    args = (x_dev, y_dev, x_sq, k_diag)
    rest = (int(config.max_iter), kp, config.c_bounds(), eps_run,
            float(config.tau), q, inner, config.selection,
            int(config.pair_batch))
    m_act = active_set_height(config, q, n_pad)
    if m_act:
        warn_active_set()

        def run_chunk(s):
            return block.run_chunk_block_active(
                *args, valid, s, *rest, m=m_act,
                k_rounds=int(config.reconcile_rounds), max_rounds=bound)
    elif eng["pipelined"]:
        def run_chunk(s):
            return block.run_chunk_block_pipelined(
                *args, valid, s, *rest, pallas_select=eng["pipe_select"],
                max_rounds=bound)
    else:
        runner = (block.run_chunk_block_fusedround if eng["fused_round"]
                  else block.run_chunk_block_fused if eng["fused_fold"]
                  else None)
        if runner is None:
            def run_chunk(s):
                return block.run_chunk_block(*args, s, *rest,
                                             max_rounds=bound)
        else:
            def run_chunk(s):
                return runner(*args, valid, s, *rest, max_rounds=bound)

    def read(s):
        (it,), (bh, bl) = read_obs((s.pairs,), (s.b_hi, s.b_lo))
        return it, bh, bl

    def payload(s):
        err = None if s.f_err is None else s.f_err[:n].cpu().numpy()
        return (s.alpha[:n].cpu().numpy(), s.f[:n].cpu().numpy(), err,
                int(s.rounds))

    obs = chunks.open_run_obs("solve", config, {**_run_meta(
        x, n_pad, config, observe, gram_resident=use_gram,
        **{k: eng[k] for k in ("pipelined", "fused_fold", "fused_round")}),
        **autotune_embed()}, dev)
    out = loop(run_chunk, state, read, payload=payload,
               tensors=lambda s: ((s.f,), (s.alpha,)), obs=obs)
    t_fin = time.perf_counter()
    state = out.state
    # Budget exits report the stopping rule at the REAL epsilon on the
    # final state (the carried extrema are one fold behind).
    alpha, f_final, b_hi, b_lo, converged = _finish(
        state.alpha, eff_f(state), n, y_np, config, eps_run, out.b_hi,
        out.b_lo, refresh=True)
    out.phase_seconds["finalize"] = time.perf_counter() - t_fin
    res = SolveResult(
        alpha=alpha,
        b=float((b_lo + b_hi) / 2.0),
        b_hi=b_hi,
        b_lo=b_lo,
        iterations=out.it,
        converged=converged,
        train_seconds=out.train_seconds,
        dispatches=out.chunks,
        stats={"f": f_final, "outer_rounds": int(state.rounds),
               "device": str(dev), "n_pad": n_pad, "chunks": out.chunks,
               "phase_seconds": out.phase_seconds,
               **{k: eng[k] for k in ("pipelined", "fused_fold",
                                      "fused_round")},
               **({"active_set_size": m_act} if m_act else {}),
               **autotune_embed()},
    )
    chunks.finish_run_obs(obs, res, out.chunks)
    return res


def _solve_pair(x, y_np, kp, config, dev, store_dtype, eps_run, start,
                observe, loop, n_budget: int) -> SolveResult:
    """The per-pair branch of the JAX package's _solve_impl."""
    n = x.shape[0]
    use_pallas = config.engine == "pallas"
    use_gram = resolve_gram(config, n_budget, dev)
    n_pad = -(-n // _PALLAS_ROWS) * _PALLAS_ROWS if use_pallas else n
    # On the resident Gram (or a precomputed kernel) each pair's kernel
    # rows are row views of the (n, n) matrix.
    x_dev, x_sq, k_diag, kp = stage_x(x, n_pad, store_dtype, kp, use_gram,
                                      config, dev)
    y_dev, valid = _stage(y_np, n, n_pad, dev, use_pallas)
    cache_lines = min(config.cache_lines, n_pad)
    use_micro = config.pair_batch > 1
    # The resident Gram supersedes the cache; micro has none.
    use_cache = cache_lines > 0 and not use_gram and not use_micro
    alpha0, f0, err0 = (_on(dev, a) for a in start.padded(n_pad))
    state = smo.init_pair_state(y_dev, cache_lines if use_cache else 0)
    scalar = functools.partial(torch.tensor, device=dev)
    state = state._replace(alpha=alpha0, f=f0, f_err=err0,
                           b_hi=scalar(np.float32(start.b_hi)),
                           b_lo=scalar(np.float32(start.b_lo)),
                           it=scalar(start.pairs, dtype=torch.int64))
    start_iter = start.pairs
    c = config.c_bounds()
    tau = float(config.tau)
    # The pair count the host last read (each runner reads it between
    # its batches, the chunk loop at each chunk's end): it cuts a batch
    # to the trips the chunk has left.
    seen = {"it": start_iter}
    tally = {"trips": 0, "reads": 0}

    def run_chunk(s):
        end = chunks.pair_end(config, observe, seen["it"])
        kw = dict(it_host=seen["it"], tally=tally)
        if use_pallas:
            return smo.run_chunk_pallas(x_dev, y_dev, x_sq, valid, s, end,
                                        kp, c, eps_run, tau, **kw)
        if use_micro:
            return smo.run_chunk_micro(x_dev, y_dev, x_sq, k_diag, valid, s,
                                       end, kp, c, eps_run, tau,
                                       config.pair_batch, **kw)
        return smo.run_chunk(x_dev, y_dev, x_sq, k_diag, valid, s, end, kp,
                             c, eps_run, tau, config.selection, **kw)

    def read(s):
        (it,), (bh, bl) = read_obs((s.it,), (s.b_hi, s.b_lo))
        seen["it"] = it
        tally["reads"] += 1
        return it, bh, bl

    def payload(s):
        err = None if s.f_err is None else s.f_err[:n].cpu().numpy()
        return s.alpha[:n].cpu().numpy(), s.f[:n].cpu().numpy(), err, None

    obs = chunks.open_run_obs("solve", config, _run_meta(
        x, n_pad, config, observe, gram_resident=use_gram), dev)
    out = loop(run_chunk, state, read, payload=payload,
               tensors=lambda s: ((s.f,), (s.alpha,)), obs=obs)
    t_fin = time.perf_counter()
    state = out.state
    alpha, f_final, b_hi, b_lo, converged = _finish(
        state.alpha, eff_f(state), n, y_np, config, eps_run, out.b_hi,
        out.b_lo, refresh=config.budget_mode)
    # Lookups of THIS run (a resumed run counts from its restore point).
    lookups = 2 * (out.it - start_iter) if use_cache else 0
    hits = evictions = 0
    if use_cache:
        # Every miss fills a line and a line leaves "empty" at most once,
        # so evictions = misses - lines filled from empty.
        (hits, filled), _ = read_obs((state.hits,
                                      (state.cache.keys >= 0).sum()))
        evictions = max(0, lookups - hits - filled)
    out.phase_seconds["finalize"] = time.perf_counter() - t_fin
    res = SolveResult(
        alpha=alpha,
        b=float((b_lo + b_hi) / 2.0),
        b_hi=b_hi,
        b_lo=b_lo,
        iterations=out.it,
        converged=converged,
        train_seconds=out.train_seconds,
        dispatches=out.chunks,
        stats={"f": f_final, "device": str(dev), "n_pad": n_pad,
               "gram_resident": use_gram, "cache_hits": hits,
               "cache_lookups": lookups,
               "cache_hit_rate": hits / lookups if lookups else 0.0,
               "cache_evictions": evictions, "chunks": out.chunks,
               "trips_queued": tally["trips"], "host_reads": tally["reads"],
               "phase_seconds": out.phase_seconds},
    )
    chunks.finish_run_obs(obs, res, out.chunks, **(
        {"cache_hits": hits, "cache_lookups": lookups,
         "cache_hit_rate": round(res.stats["cache_hit_rate"], 6),
         "cache_evictions": evictions} if use_cache else {}))
    return res
