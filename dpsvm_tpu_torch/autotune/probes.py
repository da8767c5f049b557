"""The autotune probe registry: one seeded micro-probe per gated knob
(counterpart of dpsvm_tpu/autotune/probes.py).

======================  =======================  =======================
probe                   A variant                B variant
======================  =======================  =======================
``pipeline``            plain block round        pipelined round
``pipeline_mesh``       plain mesh round         pipelined mesh round
``shardlocal``          global mesh working set  P shard-local chains
``ring``                all_gather exchange      B7 ring exchange
``fused_round``         fused-fold engine        one-pass round
``ooc_shrink``          full-stream ooc solve    shrunken-stream solve
``bf16_gram``           float32 X storage        bfloat16 X storage
``serve_buckets``       padded top bucket        right-sized bucket
``serve_quant``         float32 union GEMM       int8 union GEMM
======================  =======================  =======================

Each probe is a short FIXED-SHAPE A/B run from seeded synthetic data,
at the JAX package's shapes. The block probes time whole chunks through
the shared measurement core (autotune/probe.py: salted starts,
differenced chunk lengths, best of N) and drive the port's own chunk
runners (solver/block.py), so on the card they launch kernels B1-B5
exactly as a solve does. ``ooc_shrink`` times whole out-of-core solves.
Results are mirrored into an ``autotune`` run log as ``probe`` records
and assembled into a
:class:`~dpsvm_tpu_torch.autotune.profile.DeviceProfile` whose
``decisions`` feed solver/block.py's gate resolution.

One pass of a probe on this host-bound shape can read a ratio several
times another pass's, so ``run_probes(passes=N)`` runs the whole list N
times and a verdict is True only when every pass finds that B pays
(:func:`agree`); the record keeps every pass's ratio and their spread.

THE HONESTY RULE: a verdict can only be True when the probe is
AUTHORITATIVE, which here means it ran on a CUDA card. On the CPU every
kernel wrapper runs its plain PyTorch version (a structure check, not a
cost measurement of anything the card runs), so every CPU probe records
its ratio with ``authoritative: false`` and the verdict pinned False:
the committed CPU profile's decisions are those of no profile at all.

The mesh probes run on logical CPU shards on the CPU (the JAX package's
CPU harness runs them on virtual devices). On CUDA they need two
physical cards: logical shards of one card are no evidence for several
(their collectives are copies inside one memory), so with fewer they
are recorded as skipped and their knobs stay out of ``decisions``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from dpsvm_tpu_torch.autotune.probe import differenced_rounds, timed_loop

#: probe name -> the SVMConfig knob its verdict resolves (None =
#: informational only: recorded in the profile, never a gate input).
PROBE_KNOBS = {
    "pipeline": "pipeline_rounds",
    # The mesh pipelined engine is measured SEPARATELY: its overlap is
    # the exchange racing the replicated chain, while the single-device
    # variant merely reorders kernels.
    "pipeline_mesh": "pipeline_rounds_mesh",
    "shardlocal": "local_working_sets",
    "ring": "ring_exchange",
    "fused_round": "fused_round",
    # Whether skipping stream tiles cuts a round enough to pay for the
    # periodic full-stream reconstruction is a host-to-device link
    # property, so it is measured, not assumed.
    "ooc_shrink": "ooc_shrink",
    "bf16_gram": None,  # the per-problem perturbation gate governs
    # An authoritative pays verdict arms the serving engine's
    # between-legs bucket auto-apply when ServeConfig.buckets=None.
    "serve_buckets": "serve_buckets",
    # Informational: the int8 storage gate is the per-model calibrated
    # perturbation guard (serve.resolve_union_storage), never a
    # device-wide speed verdict.
    "serve_quant": None,
}

#: logical shards of the mesh probes on the CPU harness.
CPU_SHARDS = 4

#: the skip reason of the mesh probes on fewer than two cards.
ONE_CARD_REASON = (
    "needs >= 2 CUDA cards: logical shards of one card are no evidence "
    "for several (ROADMAP item 6)")


@dataclasses.dataclass
class ProbeContext:
    """Shared knobs of one probe pass. ``smoke`` shrinks every shape to
    the test-feasible minimum; ``timer`` is injectable so the
    determinism tests drive the pass with a fake clock (None: the host
    clock, CUDA events in timed_loop on the card)."""

    seed: int = 0
    smoke: bool = False
    timer: object = None
    device: object = "cuda"
    obs: Optional[object] = None  # a RunLog (or None)
    # Fixed probe shapes (covtype-like d; rows a multiple of 1024 so the
    # fused padding contract q/2 <= n_pad/128 holds).
    n: int = 4096
    d: int = 54
    q: int = 64
    reps: int = 6
    tries: int = 3

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.smoke:
            self.n, self.d, self.q = 1024, 16, 16
            self.reps, self.tries = 2, 2
        if self.n % 1024 or self.q // 2 > self.n // 128:
            raise ValueError(
                f"probe shapes must satisfy the fused padding contract "
                f"(n % 1024 == 0, q/2 <= n/128): n={self.n} q={self.q}")

    @property
    def inner(self) -> int:
        return 2 * self.q

    def on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def shapes(self) -> dict:
        return {"n": self.n, "d": self.d, "q": self.q,
                "inner": self.inner, "reps": self.reps}


_CPU_NOTE = ("CPU harness: every kernel wrapper runs its plain PyTorch "
             "version; structure check, verdict pinned False")
_CPU_MESH_NOTE = ("CPU harness mesh: logical CPU shards, plain PyTorch "
                  "collectives; structure check, verdict pinned False")
_MAX_ITER = 10 ** 9


def _dataset(ctx: ProbeContext, offset: int):
    """Seeded covtype-like synthetic rows (+/-1 labels), the JAX
    package's generator (data/synth.py make_covtype_like)."""
    from dpsvm_tpu_torch.data.synth import make_covtype_like

    return make_covtype_like(ctx.n, ctx.d, seed=ctx.seed + offset)


def _cfg(ctx: ProbeContext):
    from dpsvm_tpu_torch.config import SVMConfig

    return SVMConfig(c=32.0, gamma=0.03125, epsilon=1e-3, engine="block",
                     working_set_size=ctx.q)


def _budget_eps() -> float:
    from dpsvm_tpu_torch.solver.solve import _BUDGET_EPS

    return _BUDGET_EPS


def _single_operands(ctx: ProbeContext, offset: int,
                     dtype=torch.float32):
    """Device operands and the zero-start BlockState of the one-device
    chunk runners (rows already probe-shaped, so no padding)."""
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                             squared_norms)
    from dpsvm_tpu_torch.solver.block import BlockState

    dev = ctx.device
    x, y = _dataset(ctx, offset)
    cfg = _cfg(ctx)
    kp = KernelParams("rbf", cfg.resolve_gamma(ctx.d))
    xd = torch.as_tensor(np.asarray(x, np.float32), device=dev).to(dtype)
    yd = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    x_sq = squared_norms(xd)
    k_diag = kernel_diag(x_sq, kp)
    valid = torch.ones(ctx.n, dtype=torch.bool, device=dev)
    base = BlockState(
        alpha=torch.zeros(ctx.n, dtype=torch.float32, device=dev), f=-yd,
        b_hi=torch.tensor(-1e9, dtype=torch.float32, device=dev),
        b_lo=torch.tensor(1e9, dtype=torch.float32, device=dev),
        pairs=torch.tensor(0, dtype=torch.int32, device=dev),
        rounds=torch.tensor(0, dtype=torch.int32, device=dev))
    common = (_MAX_ITER, kp, cfg.c_bounds(), _budget_eps(), float(cfg.tau),
              ctx.q, ctx.inner)
    return xd, yd, x_sq, k_diag, valid, base, common


def _ab_record(probe: str, ctx: ProbeContext, a_label: str,
               b_label: str, a_seconds: float, b_seconds: float,
               authoritative: bool, note: Optional[str] = None,
               threshold: float = None) -> dict:
    """One schema'd probe record; the verdict rule lives here so every
    probe shares it: authoritative AND B at or under `threshold` x A."""
    from dpsvm_tpu_torch.autotune.profile import PAYS_THRESHOLD

    thr = PAYS_THRESHOLD if threshold is None else threshold
    # None (not inf / 0.0) unless BOTH sides measured above the clock's
    # resolution: the differenced timers clamp at 0.0, so a zero on
    # either side is jitter, never a reading that may flip a gate on.
    ratio = (b_seconds / a_seconds
             if a_seconds > 0 and b_seconds > 0 else None)
    rec = {
        "probe": probe,
        "knob": PROBE_KNOBS[probe],
        "shapes": ctx.shapes(),
        "seed": ctx.seed,
        "a": a_label,
        "b": b_label,
        # 9 digits: the per-rep and per-pair probes read down to
        # nanoseconds, and a committed profile must stay reconcilable
        # from its own a/b fields.
        "a_seconds": round(a_seconds, 9),
        "b_seconds": round(b_seconds, 9),
        "ratio": round(ratio, 4) if ratio is not None else None,
        "threshold": thr,
        "authoritative": bool(authoritative),
        "verdict": bool(authoritative and ratio is not None
                        and ratio <= thr),
    }
    if note:
        rec["note"] = note
    return rec


def _skip_record(probe: str, ctx: ProbeContext, reason: str) -> dict:
    return {"probe": probe, "knob": PROBE_KNOBS[probe],
            "shapes": ctx.shapes(), "seed": ctx.seed, "skipped": reason,
            "authoritative": False, "verdict": False}


def _differenced(ctx: ProbeContext, make, base, salt_base: int) -> tuple:
    return differenced_rounds(make, base, ctx.reps, salt_base=salt_base,
                              tries=ctx.tries, timer=ctx.timer)


# ----------------------------------------------------- one-device A/Bs

def probe_pipeline(ctx: ProbeContext) -> dict:
    """Plain vs pipelined block round (the pipeline_rounds gate). On the
    card the pipelined side selects with kernel B3 (the one-pass
    candidate selection a pipelined solve takes there)."""
    from dpsvm_tpu_torch.solver.block import (run_chunk_block,
                                              run_chunk_block_pipelined)

    xd, yd, x_sq, k_diag, valid, base, common = _single_operands(ctx, 11)
    cuda = ctx.on_cuda()

    def make_plain(rpc):
        return lambda st: run_chunk_block(xd, yd, x_sq, k_diag, st, *common,
                                          max_rounds=rpc)

    def make_pipe(rpc):
        return lambda st: run_chunk_block_pipelined(
            xd, yd, x_sq, k_diag, valid, st, *common, pallas_select=cuda,
            max_rounds=rpc)

    ta, _, _ = _differenced(ctx, make_plain, base, 1)
    tb, _, _ = _differenced(ctx, make_pipe, base, 2)
    return _ab_record("pipeline", ctx, "plain_round", "pipelined_round",
                      ta, tb, authoritative=cuda,
                      note=None if cuda else _CPU_NOTE)


def probe_fused_round(ctx: ProbeContext) -> dict:
    """Fused-fold engine (B1 + B2 a round) vs the one-pass round (B4 +
    B1 + B5 a round): the fused_round gate."""
    from dpsvm_tpu_torch.solver.block import (run_chunk_block_fused,
                                              run_chunk_block_fusedround)

    xd, yd, x_sq, k_diag, valid, base, common = _single_operands(ctx, 12)
    cuda = ctx.on_cuda()

    def make(runner):
        def _make(rpc):
            return lambda st: runner(xd, yd, x_sq, k_diag, valid, st,
                                     *common, max_rounds=rpc)
        return _make

    ta, _, _ = _differenced(ctx, make(run_chunk_block_fused), base, 3)
    tb, _, _ = _differenced(ctx, make(run_chunk_block_fusedround), base, 4)
    return _ab_record("fused_round", ctx, "fused_fold", "one_pass_round",
                      ta, tb, authoritative=cuda,
                      note=None if cuda else _CPU_NOTE)


def probe_ooc_shrink(ctx: ProbeContext) -> dict:
    """Full vs shrunken out-of-core stream, as whole solves (the
    ooc_shrink gate).

    Both sides solve one seeded problem with X on the host through
    solver/ooc.py solve_ooc, in 8 tiles: A with ooc_shrink=False, B with
    ooc_shrink=True. Whether shrinking pays depends on what a solve does
    with it (how many tiles its cycles skip, how many more rounds it
    takes, when it demotes to the full stream), so the probe times the
    solves themselves: a stream round with an assumed live set would
    leave the extra rounds and the demotion out. The problem is the
    chip_smoke.py [ooc] headline's configuration (make_mnist_like; c 10,
    gamma 0.125, epsilon 0.01) at the probe's n, d and q. Each side
    solves `tries` times on the clock (synchronized), best of `tries`,
    so the first solve's one-time costs (a kernel build where this probe
    runs alone) fall out. The record carries each side's rounds, pairs
    and tiles streamed and skipped, and the rounds its solves ran in all
    (B1 launches once a round on the card)."""
    from dpsvm_tpu_torch.config import SVMConfig
    from dpsvm_tpu_torch.data.synth import make_mnist_like
    from dpsvm_tpu_torch.solver.ooc import solve_ooc

    import time

    dev = ctx.device
    clock = ctx.timer or time.perf_counter
    x, y = make_mnist_like(ctx.n, ctx.d, seed=ctx.seed + 18)
    tiles = 8
    tile = ctx.n // tiles
    base = SVMConfig(c=10.0, gamma=0.125, epsilon=0.01, engine="block",
                     working_set_size=ctx.q, ooc=True, ooc_tile_rows=tile)

    def run_variant(shrink):
        cfg = base.replace(ooc_shrink=shrink)
        rounds_run = 0
        best = res = None
        for _ in range(ctx.tries):
            t0 = clock()
            res = solve_ooc(x, y, cfg, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = clock() - t0
            rounds_run += int(res.stats["outer_rounds"])
            best = t if best is None or t < best else best
        st = res.stats
        return best, {"rounds": int(st["outer_rounds"]),
                      "pairs": int(res.iterations),
                      "converged": bool(res.converged),
                      "tiles_streamed": int(st["tiles_streamed"]),
                      "tiles_skipped": int(st.get("tiles_skipped", 0)),
                      "solves": ctx.tries, "rounds_run": rounds_run}

    ta, sa = run_variant(False)
    tb, sb = run_variant(True)
    cuda = ctx.on_cuda()
    rec = _ab_record(
        "ooc_shrink", ctx, "full_stream_solve", "shrunken_stream_solve",
        ta, tb, authoritative=cuda,
        note="whole ooc solves, full against shrunken stream; verdict "
             "True arms the ooc_shrink auto gate" if cuda else
             "CPU harness: a tile upload is a memcpy, not the host link; "
             "structure check, verdict pinned False")
    rec["shapes"] = {**ctx.shapes(), "tiles": tiles, "tile_rows": tile}
    rec["solves"] = {"a": sa, "b": sb}
    return rec


def probe_bf16_gram(ctx: ProbeContext) -> dict:
    """float32 vs bfloat16 X storage through the plain block chunk (the
    storage config.bf16_gram picks when its perturbation bound accepts).
    Informational: the per-problem quality gate still governs; this
    measures whether the halved fold and Gram reads show on this
    device at all."""
    from dpsvm_tpu_torch.solver.block import run_chunk_block

    times = {}
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        xd, yd, x_sq, k_diag, _, base, common = _single_operands(
            ctx, 13, dtype=dt)

        def make(rpc, xd=xd, yd=yd, x_sq=x_sq, k_diag=k_diag,
                 common=common):
            return lambda st: run_chunk_block(xd, yd, x_sq, k_diag, st,
                                              *common, max_rounds=rpc)

        times[name], _, _ = _differenced(
            ctx, make, base, 5 if name == "float32" else 6)
    return _ab_record(
        "bf16_gram", ctx, "float32_x", "bfloat16_x", times["float32"],
        times["bfloat16"], authoritative=ctx.on_cuda(),
        note="informational: config.bf16_gram stays behind the "
             "per-problem perturbation bound either way")


# ------------------------------------------------------------ mesh A/Bs

def _probe_mesh(ctx: ProbeContext):
    """The mesh the mesh probes run on, or None: logical CPU shards on
    the CPU, the physical cards on CUDA (None with fewer than two)."""
    from dpsvm_tpu_torch.parallel.mesh import Mesh, make_data_mesh

    if not ctx.on_cuda():
        return Mesh([ctx.device] * CPU_SHARDS)
    if torch.cuda.device_count() < 2:
        return None
    return make_data_mesh()


def _mesh_operands(ctx: ProbeContext, mesh, offset: int):
    from dpsvm_tpu_torch.ops.kernels import (KernelParams, kernel_diag,
                                             squared_norms)
    from dpsvm_tpu_torch.parallel.dist_block import MeshBlockState
    from dpsvm_tpu_torch.parallel.mesh import (pad_rows, replicate_array,
                                               shard_padded_rows)

    x, y = _dataset(ctx, offset)
    cfg = _cfg(ctx)
    kp = KernelParams("rbf", cfg.resolve_gamma(ctx.d))
    n_pad = pad_rows(ctx.n, mesh.size)
    y_p = np.ones((n_pad,), np.float32)
    y_p[:ctx.n] = y
    valid = np.zeros((n_pad,), bool)
    valid[:ctx.n] = True
    xd = shard_padded_rows(mesh, np.asarray(x, np.float32))
    yd = shard_padded_rows(mesh, y_p)
    x_sq = [squared_norms(t) for t in xd]
    k_diag = [kernel_diag(s, kp) for s in x_sq]
    vd = shard_padded_rows(mesh, valid)
    base = MeshBlockState(
        alpha=shard_padded_rows(mesh, np.zeros((n_pad,), np.float32)),
        f=shard_padded_rows(mesh, -y_p),
        b_hi=replicate_array(mesh, np.float32(-1e9)),
        b_lo=replicate_array(mesh, np.float32(1e9)),
        pairs=replicate_array(mesh, np.int32(0)),
        rounds=replicate_array(mesh, np.int32(0)))
    args = (mesh, kp, cfg.c_bounds(), _budget_eps(), float(cfg.tau), ctx.q,
            ctx.inner)
    return (xd, yd, x_sq, k_diag, vd), base, args


def _wrap(runner, operands):
    return lambda st: runner(*operands, st, _MAX_ITER)


def probe_shardlocal(ctx: ProbeContext, sync_rounds: int = 2) -> dict:
    """Global vs shard-local mesh working sets (the local_working_sets
    gate). The decisive number is pairs/s (P concurrent chains execute
    MORE pairs a round), so the ratio is seconds per EXECUTED pair.
    sync_rounds divides both differenced chunk lengths (reps and 2 reps
    are even), or the two lengths would round to one window count."""
    from dpsvm_tpu_torch.parallel.dist_block import (
        make_block_chunk_runner, make_block_shardlocal_chunk_runner)

    mesh = _probe_mesh(ctx)
    if mesh is None:
        return _skip_record("shardlocal", ctx, ONE_CARD_REASON)
    ops, base, args = _mesh_operands(ctx, mesh, 14)
    cuda = ctx.on_cuda()

    def make_global(rpc):
        return _wrap(make_block_chunk_runner(*args, rpc), ops)

    def make_local(rpc):
        rpc = -(-rpc // sync_rounds) * sync_rounds
        return _wrap(make_block_shardlocal_chunk_runner(
            *args, rpc, sync_rounds), ops)

    ta, _, pa = _differenced(ctx, make_global, base, 7)
    tb, _, pb = _differenced(ctx, make_local, base, 8)
    rec = _ab_record(
        "shardlocal", ctx, "global_working_set", f"shardlocal_p{mesh.size}",
        ta / max(pa, 1), tb / max(pb, 1), authoritative=cuda,
        note=None if cuda else _CPU_MESH_NOTE)
    rec["unit"] = "seconds_per_pair"
    rec["n_devices"] = mesh.size
    rec["sync_rounds"] = sync_rounds
    rec["pairs"] = {"a": int(pa), "b": int(pb)}
    return rec


def probe_pipeline_mesh(ctx: ProbeContext) -> dict:
    """Global vs PIPELINED mesh block runner (the mesh's own
    pipeline_rounds gate, knob ``pipeline_rounds_mesh``)."""
    from dpsvm_tpu_torch.parallel.dist_block import (
        make_block_chunk_runner, make_block_pipelined_chunk_runner)

    mesh = _probe_mesh(ctx)
    if mesh is None:
        return _skip_record("pipeline_mesh", ctx, ONE_CARD_REASON)
    ops, base, args = _mesh_operands(ctx, mesh, 17)
    cuda = ctx.on_cuda()

    def make(factory):
        return lambda rpc: _wrap(factory(*args, rpc), ops)

    ta, _, _ = _differenced(ctx, make(make_block_chunk_runner), base, 11)
    tb, _, _ = _differenced(ctx, make(make_block_pipelined_chunk_runner),
                            base, 12)
    rec = _ab_record(
        "pipeline_mesh", ctx, "plain_mesh_round", "pipelined_mesh_round",
        ta, tb, authoritative=cuda, note=None if cuda else _CPU_MESH_NOTE)
    rec["n_devices"] = mesh.size
    return rec


def probe_ring(ctx: ProbeContext) -> dict:
    """all_gather vs kernel B7's ring exchange on the global mesh runner
    (the ring_exchange gate)."""
    from dpsvm_tpu_torch.parallel.dist_block import make_block_chunk_runner

    mesh = _probe_mesh(ctx)
    if mesh is None:
        return _skip_record("ring", ctx, ONE_CARD_REASON)
    ops, base, args = _mesh_operands(ctx, mesh, 15)
    cuda = ctx.on_cuda()

    def make(ring):
        return lambda rpc: _wrap(
            make_block_chunk_runner(*args, rpc, ring_exchange=ring), ops)

    ta, _, _ = _differenced(ctx, make(False), base, 9)
    tb, _, _ = _differenced(ctx, make(True), base, 10)
    rec = _ab_record(
        "ring", ctx, "all_gather", "ring_b7", ta, tb, authoritative=cuda,
        note=None if cuda else _CPU_MESH_NOTE)
    rec["n_devices"] = mesh.size
    return rec


# ------------------------------------------------------- serving probes

def _dispatch_f32(qb, sv, coef):
    """The bucket executor's compute shape: (bucket, d) x (d, S) dots and
    the coef contraction (the decision fold without the kernel
    transform: the same roofline)."""
    from dpsvm_tpu_torch.ops.kernels import mm_f32

    dec = mm_f32(qb, sv.t()) @ coef
    return qb + 1e-20 * dec[0], sv, coef


def probe_serve_buckets(ctx: ProbeContext) -> dict:
    """Padded top-bucket dispatch vs a right-sized bucket: does dispatch
    cost scale with the bucket on this device, or is it floored by the
    launch? When right-sizing pays (ratio well under 1), the engine's
    occupancy-driven ``suggest_buckets`` advice is worth applying. An
    authoritative pays verdict arms the serving engine's between-legs
    bucket auto-apply when ``ServeConfig.buckets=None``; an explicit
    ladder always wins."""
    dev = ctx.device
    rng = np.random.default_rng(ctx.seed + 16)
    s_rows = 256 if ctx.smoke else 1024  # SV-union rows
    big, small = (64, 16) if ctx.smoke else (256, 64)
    sv = torch.as_tensor(rng.normal(size=(s_rows, ctx.d)), device=dev,
                         dtype=torch.float32)
    coef = torch.as_tensor(rng.normal(size=(s_rows,)), device=dev,
                           dtype=torch.float32)
    reps = 256 if ctx.smoke else 2048
    times = {}
    for bucket in (big, small):
        qb = torch.as_tensor(rng.normal(size=(bucket, ctx.d)), device=dev,
                             dtype=torch.float32)
        times[bucket] = timed_loop(_dispatch_f32, qb, sv, coef, reps=reps,
                                   timer=ctx.timer)
    rec = _ab_record(
        "serve_buckets", ctx, f"bucket_{big}", f"bucket_{small}",
        times[big], times[small], authoritative=ctx.on_cuda(),
        threshold=float(small) / big + 0.25,
        note="verdict True means dispatch cost tracks the bucket "
             "(occupancy-driven bucket suggestions pay): arms the "
             "engine's between-legs auto-apply for buckets=None; an "
             "explicit ServeConfig.buckets always wins")
    # This record describes ITS measurement, not the solver-probe shapes.
    rec["shapes"] = {"d": ctx.d, "sv_rows": s_rows, "bucket_a": big,
                     "bucket_b": small, "reps": reps}
    return rec


def probe_serve_quant(ctx: ProbeContext) -> dict:
    """float32 vs int8 union storage at the serve bucket's compute
    shape: per-row query quantization, the int8 x int8 -> int32 GEMM
    (ops/kernels.py mm_i8_i32), the float32 dequantization and the coef
    contraction, against the float32 dispatch GEMM. Informational only
    (knob None): whether int8 is FAST is a device property, whether it
    is SAFE a per-model one, which the calibrated perturbation guard
    (serve.resolve_union_storage) adjudicates."""
    from dpsvm_tpu_torch.ops.kernels import mm_i8_i32, quantize_rows_int8

    dev = ctx.device
    rng = np.random.default_rng(ctx.seed + 17)
    s_rows = 256 if ctx.smoke else 1024
    bucket = 64 if ctx.smoke else 256
    reps = 256 if ctx.smoke else 2048
    sv_f = rng.normal(size=(s_rows, ctx.d)).astype(np.float32)
    sv_q_np, sv_scale_np = quantize_rows_int8(sv_f)
    sv = torch.as_tensor(sv_f, device=dev)
    sv_q = torch.as_tensor(sv_q_np, device=dev)
    sv_scale = torch.as_tensor(sv_scale_np, device=dev)
    coef = torch.as_tensor(rng.normal(size=(s_rows,)), device=dev,
                           dtype=torch.float32)
    qb = torch.as_tensor(rng.normal(size=(bucket, ctx.d)), device=dev,
                         dtype=torch.float32)

    def dispatch_int8(qb, sv_q, sv_scale, coef):
        t = qb.abs().amax(dim=1) / 127.0
        t = torch.where(t > 0, t, torch.ones_like(t))
        q_q = torch.clamp(torch.round(qb / t[:, None]), -127, 127
                          ).to(torch.int8)
        k = mm_i8_i32(q_q, sv_q).float() * (t[:, None] * sv_scale[None, :])
        dec = k @ coef
        return qb + 1e-20 * dec[0], sv_q, sv_scale, coef

    t_f32 = timed_loop(_dispatch_f32, qb, sv, coef, reps=reps,
                       timer=ctx.timer)
    t_int8 = timed_loop(dispatch_int8, qb, sv_q, sv_scale, coef,
                        reps=reps, timer=ctx.timer)
    cuda = ctx.on_cuda()
    rec = _ab_record(
        "serve_quant", ctx, "union_f32", "union_int8", t_f32, t_int8,
        authoritative=cuda,
        note="informational: int8 union GEMM vs f32 at the serve bucket "
             "shape; storage is adjudicated per-model by the calibrated "
             "perturbation guard, never by this record"
             + ("" if cuda else "; CPU harness: int8 dot as an int32 "
                                "product, verdict pinned False"))
    rec["shapes"] = {"d": ctx.d, "sv_rows": s_rows, "bucket": bucket,
                     "reps": reps}
    return rec


def _print_record(name: str, rec: dict, p: int, passes: int) -> None:
    if rec.get("skipped"):
        line = f"skipped ({rec['skipped']})"
    else:
        rr = rec["ratio"]
        line = (f"{rec['a']} {rec['a_seconds']:.6f}s vs "
                f"{rec['b']} {rec['b_seconds']:.6f}s: ratio "
                f"{f'{rr:.3f}' if rr is not None else '-'} "
                f"(threshold {rec['threshold']}, "
                f"authoritative={rec['authoritative']}) "
                f"-> verdict {rec['verdict']}")
    tag = f" (pass {p + 1} of {passes})" if passes > 1 else ""
    print(f"[autotune] {name}{tag}: {line}", file=sys.stderr, flush=True)


#: registry order = execution order (cheap one-device probes first).
PROBES = {
    "pipeline": probe_pipeline,
    "bf16_gram": probe_bf16_gram,
    "fused_round": probe_fused_round,
    "ooc_shrink": probe_ooc_shrink,
    "shardlocal": probe_shardlocal,
    "pipeline_mesh": probe_pipeline_mesh,
    "ring": probe_ring,
    "serve_buckets": probe_serve_buckets,
    "serve_quant": probe_serve_quant,
}


def agree(recs: list) -> dict:
    """One record for several passes of one probe. The verdict needs
    every pass to find that B pays; the record is the pass least
    favourable to B (its seconds and ratio, so the ratio stays
    reconcilable from a_seconds and b_seconds), with every pass's ratio
    (``ratios``) and how far they spread (``spread``: largest less
    smallest; None where a pass read no ratio). One pass, or a skipped
    probe, is returned as it is."""
    first = recs[0]
    if len(recs) == 1 or first.get("skipped"):
        return first
    ratios = [r["ratio"] for r in recs]
    rec = dict(max(recs, key=lambda r: (float("inf") if r["ratio"] is None
                                        else r["ratio"])))
    rec["passes"] = len(recs)
    rec["ratios"] = ratios
    rec["spread"] = (None if None in ratios
                     else round(max(ratios) - min(ratios), 4))
    rec["verdict"] = all(r["verdict"] for r in recs)
    return rec


def run_probes(knobs=None, seed: int = 0, smoke: bool = False,
               timer=None, obs_config=None, verbose: bool = True,
               device=None, passes: int = 1):
    """Run the registry (or the `knobs` subset of probe names) on
    `device` (None: the CUDA card) `passes` times, each pass the whole
    list in order, and assemble a DeviceProfile whose every record is
    :func:`agree` of its passes. With obs enabled every probe mirrors
    its record into an ``autotune`` run log as a ``probe`` record."""
    from dpsvm_tpu_torch.autotune.profile import DeviceProfile, stamp
    from dpsvm_tpu_torch.device import resolve_device
    from dpsvm_tpu_torch.obs import obs_enabled
    from dpsvm_tpu_torch.obs.runlog import RunLog

    dev = resolve_device(device)
    ctx = ProbeContext(seed=seed, smoke=smoke, timer=timer, device=dev)
    names = list(PROBES) if knobs is None else list(knobs)
    unknown = [k for k in names if k not in PROBES]
    if unknown:
        raise ValueError(f"unknown probes {unknown}; "
                         f"registry has {list(PROBES)}")
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    ident = stamp(dev)
    rl = None
    if obs_config is not None and obs_enabled(obs_config):
        rl = RunLog.open("autotune", obs_config=obs_config,
                         meta={"probes": names, "seed": seed,
                               "smoke": bool(smoke), "passes": passes,
                               **ctx.shapes()})
    runs = {name: [] for name in names}
    probes, decisions = {}, {}
    try:
        for p in range(passes):
            for name in names:
                rec = PROBES[name](ctx)
                runs[name].append(rec)
                if verbose:
                    _print_record(name, rec, p, passes)
        for name in names:
            rec = probes[name] = agree(runs[name])
            if PROBE_KNOBS[name] is not None and not rec.get("skipped"):
                # A SKIPPED probe leaves its knob OUT of the decisions
                # (the gate keeps its default): recording False would
                # pass for a measured verdict.
                decisions[PROBE_KNOBS[name]] = bool(rec["verdict"])
            if rl is not None:
                rl.record("probe", **rec)
            if verbose and passes > 1 and not rec.get("skipped"):
                print(f"[autotune] {name}: ratios {rec['ratios']} spread "
                      f"{rec['spread']} -> verdict {rec['verdict']}",
                      file=sys.stderr, flush=True)
    finally:
        if rl is not None:
            rl.finish(decisions=decisions)
    return DeviceProfile(seed=seed, probes=probes, decisions=decisions,
                         **ident)
