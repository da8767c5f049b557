"""The manifest of hot entrypoints the structural linter runs and budgets
(counterpart of dpsvm_tpu/analysis/manifest.py: the same 25 entries, the
same canonical shapes).

Each entry is a builder ``(device) -> [Unit, ...]`` that makes its inputs
from a seeded NumPy generator on `device` (the CPU for the lint, the
card for ``chip_smoke.py`` [lint]) and returns the units of one logical
step, each calling the port's own function:

  block_chunk_*           solver/block.py run_chunk_block* at
                          max_rounds=1, then the observation pull
  fleet_chunk             solver/fleet.py fleet_trip
  mesh_chunk, pipelined_chunk, shardlocal_chunk, *_ring
                          parallel/dist_block.py make_block_*_chunk_runner
                          at one round (one sync window), then the pull
  ooc_fold_tile[_shrink]  ops/ooc.py ooc_fold_tile
  ooc_mesh_fold           dist_block.py ooc_mesh_fold and ooc_mesh_select
  warm_f_rebuild          ooc_fold_tile at the warm block width and
                          solver/warmstart.py warm_rebuild_mesh
  compacted_decision      models/multiclass.py _compacted_decision
  serve_*                 serve.py StagedUnion (dense_partial,
                          int8_partial, mesh_decision); serve_mesh_group
                          through serving/engine_core.py UnionGroup
  mesh_predict            predict.py decision_function_mesh

The observation pull (solver/smo.py read_obs of pairs, b_hi, b_lo) is
its own unit, as the JAX package's ``pack_obs``: a chunk costs the
runner plus one read, so ``dispatches`` pins 2.

The mesh entries run on ``Mesh([device] * 8)``, eight logical shards of
one device (the JAX package's eight forced host devices). The builders'
own uploads are not recorded: a unit records only its call.

Variants keep the JAX entries' mutation forms: block_chunk_fusedround
(extra_pass: one more kernel-row pass over X folded into f),
ooc_fold_tile_shrink (masked: one call folding every tile of a resident
X under a live mask), ooc_mesh_fold (extra_psum: one psum a stream
step). Their facts must DRIFT against the committed budgets.
"""

from __future__ import annotations

import numpy as np
import torch

from dpsvm_tpu_torch.analysis.extract import Unit

# Canonical shapes: the JAX package's manifest's.
DEVICE_COUNT = 8
N, D, Q, INNER = 4096, 24, 64, 128
R_SYNC = 4
C_BOUNDS = (5.0, 5.0)
EPS, TAU = 1e-3, 1e-12
GAMMA = 0.1
S_UNION, K_MODELS, M_PAD, NB = 256, 10, 64, 64
K_COALESCED = 16
T_TILE = 512
#: The pair budget of every solver entry: never reached in one step.
MAX_ITER = 10 ** 8


def _kp():
    from dpsvm_tpu_torch.ops.kernels import KernelParams

    return KernelParams("rbf", GAMMA)


def _dev(device) -> torch.device:
    return torch.device(device)


def _rng(entry: str) -> np.random.Generator:
    """The entry's generator: seeded by its name, so entries do not share
    draws and adding one moves no other entry's inputs."""
    return np.random.default_rng(sum(entry.encode()) * 7919)


def _problem(rng, n: int):
    """(x (n, D) float32, y (n,) +-1 float32): two shifted Gaussian
    classes."""
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    x = (rng.standard_normal((n, D)) * 0.5
         + 0.25 * y[:, None]).astype(np.float32)
    return x, y


def _on(dev, a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _scalar(dev, v, dtype=torch.float32):
    return torch.full((), v, dtype=dtype, device=dev)


# ---------------------------------------------------------------------
# single-device block chunks
# ---------------------------------------------------------------------

def _block_inputs(entry: str, dev, dtype=torch.float32):
    from dpsvm_tpu_torch.ops.kernels import kernel_diag, squared_norms
    from dpsvm_tpu_torch.solver.block import BlockState

    x, y = _problem(_rng(entry), N)
    x_d = _on(dev, x, dtype)
    y_d = _on(dev, y)
    x_sq = squared_norms(x_d)
    k_diag = kernel_diag(x_sq, _kp())
    valid = torch.ones(N, dtype=torch.bool, device=dev)
    state = BlockState(torch.zeros(N, device=dev), -y_d.clone(),
                       _scalar(dev, -1.0), _scalar(dev, 1.0),
                       _scalar(dev, 0, torch.int32),
                       _scalar(dev, 0, torch.int32))
    return (x_d, y_d, x_sq, k_diag, valid), state


def _rest():
    return (MAX_ITER, _kp(), C_BOUNDS, EPS, TAU, Q, INNER)


def _obs_unit(box: dict) -> Unit:
    """The observation pull a chunk driver makes after the runner: ONE
    read of (pairs, b_hi, b_lo) (solver/smo.py read_obs)."""
    from dpsvm_tpu_torch.solver.smo import read_obs

    def scalars():
        st = box["state"]
        first = (lambda v: v[0]) if isinstance(st.pairs, list) else (
            lambda v: v)
        return first(st.pairs), first(st.b_hi), first(st.b_lo)

    def run():
        pairs, b_hi, b_lo = scalars()
        return read_obs((pairs,), (b_hi, b_lo))

    return Unit("pull_obs", run, args=scalars)


def _chunk_units(runner, inputs, state, extra=()) -> list:
    """The chunk unit (runner on `inputs` and `state`, then each of
    `extra` applied to its result) and the observation pull of its
    result."""
    box = {}

    def run():
        st = runner(*inputs, state)
        for fn in extra:
            st = fn(st)
        box["state"] = st
        return st

    return [Unit("chunk", run, state=lambda: state,
                 args=lambda: (inputs, state)),
            _obs_unit(box)]


def block_chunk_single(device="cpu"):
    """The plain block round (run_chunk_block): select, gather, Gram, B1,
    fold; one host read for the loop condition."""
    from dpsvm_tpu_torch.solver.block import run_chunk_block

    (x, y, x_sq, k_diag, _), state = _block_inputs(
        "block_chunk_single", _dev(device))

    def runner(x, y, x_sq, k_diag, st):
        return run_chunk_block(x, y, x_sq, k_diag, st, *_rest(),
                               max_rounds=1)

    return _chunk_units(runner, (x, y, x_sq, k_diag), state)


def block_chunk_bf16gram(device="cpu"):
    """The plain round on bfloat16 X (config.bf16_gram / dtype): the
    convert counts pin the intended quantization points."""
    from dpsvm_tpu_torch.solver.block import run_chunk_block

    (x, y, x_sq, k_diag, _), state = _block_inputs(
        "block_chunk_bf16gram", _dev(device), torch.bfloat16)

    def runner(x, y, x_sq, k_diag, st):
        return run_chunk_block(x, y, x_sq, k_diag, st, *_rest(),
                               max_rounds=1)

    return _chunk_units(runner, (x, y, x_sq, k_diag), state)


def block_chunk_fused(device="cpu"):
    """The fused-fold round (run_chunk_block_fused): B1 and B2."""
    from dpsvm_tpu_torch.solver.block import run_chunk_block_fused

    inputs, state = _block_inputs("block_chunk_fused", _dev(device))

    def runner(x, y, x_sq, k_diag, valid, st):
        return run_chunk_block_fused(x, y, x_sq, k_diag, valid, st,
                                     *_rest(), max_rounds=1)

    return _chunk_units(runner, inputs, state)


def block_chunk_fusedround(device="cpu", extra_pass: bool = False):
    """The one-pass fused round (run_chunk_block_fusedround): B4, B1, B5.

    ``extra_pass=True`` is the mutated form: the same chunk plus one
    more kernel-row pass over X folded into f, exactly the extra pass the
    one-pass contract forbids; its dots, ops and memory must drift."""
    from dpsvm_tpu_torch.ops.kernels import kernel_rows
    from dpsvm_tpu_torch.solver.block import run_chunk_block_fusedround

    inputs, state = _block_inputs("block_chunk_fusedround", _dev(device))
    x, _, x_sq = inputs[:3]

    def runner(x, y, x_sq, k_diag, valid, st):
        return run_chunk_block_fusedround(x, y, x_sq, k_diag, valid, st,
                                          *_rest(), max_rounds=1)

    def extra(st):
        rows = kernel_rows(x, x_sq, x[:Q], x_sq[:Q], _kp())
        return st._replace(f=st.f + st.alpha[:Q] @ rows)

    return _chunk_units(runner, inputs, state,
                        extra=(extra,) if extra_pass else ())


def block_chunk_pipelined(device="cpu"):
    """The pipelined round (run_chunk_block_pipelined) with the one-pass
    candidate kernel selecting (pallas_select): B3 and B1."""
    from dpsvm_tpu_torch.solver.block import run_chunk_block_pipelined

    inputs, state = _block_inputs("block_chunk_pipelined", _dev(device))

    def runner(x, y, x_sq, k_diag, valid, st):
        return run_chunk_block_pipelined(x, y, x_sq, k_diag, valid, st,
                                         *_rest(), pallas_select=True,
                                         max_rounds=1)

    return _chunk_units(runner, inputs, state)


def block_chunk_active(device="cpu"):
    """One active-set cycle (run_chunk_block_active, m = 2 Q, two inner
    rounds): one read a cycle and one an inner round."""
    from dpsvm_tpu_torch.solver.block import run_chunk_block_active

    (x, y, x_sq, k_diag, _), state = _block_inputs(
        "block_chunk_active", _dev(device))

    def runner(x, y, x_sq, k_diag, st):
        return run_chunk_block_active(x, y, x_sq, k_diag, None, st,
                                      *_rest(), m=2 * Q, k_rounds=2,
                                      max_rounds=1)

    return _chunk_units(runner, (x, y, x_sq, k_diag), state)


def fleet_chunk(device="cpu"):
    """One trip of the OvO / OvR fleet (solver/fleet.py fleet_trip): every
    problem of the (K, n) stack takes one pair update, no host read."""
    from dpsvm_tpu_torch.ops.kernels import squared_norms
    from dpsvm_tpu_torch.solver.fleet import FleetState, fleet_trip

    dev = _dev(device)
    rng = _rng("fleet_chunk")
    k, n = K_MODELS, 512
    x, _ = _problem(rng, n)
    y = np.where(rng.random((k, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    x_d, y_d = _on(dev, x), _on(dev, y)
    x_sq = squared_norms(x_d)
    valid = torch.ones((k, n), dtype=torch.bool, device=dev)
    cb = torch.full((k, 2), C_BOUNDS[0], device=dev)
    st = FleetState(torch.zeros((k, n), device=dev), -y_d.clone(),
                    torch.full((k,), -1.0, device=dev),
                    torch.full((k,), 1.0, device=dev),
                    torch.zeros(k, dtype=torch.int32, device=dev),
                    _scalar(dev, 0, torch.int32))
    args = (x_d, y_d, x_sq, valid, cb, st)
    return [Unit("chunk", lambda: fleet_trip(*args, MAX_ITER, _kp(), EPS,
                                             TAU),
                 state=lambda: st, args=lambda: args)]


# ---------------------------------------------------------------------
# mesh chunks
# ---------------------------------------------------------------------

def _mesh(dev):
    from dpsvm_tpu_torch.parallel.mesh import Mesh

    return Mesh([dev] * DEVICE_COUNT)


def _mesh_inputs(entry: str, dev):
    """Per-rank shards of one (N, D) problem, and the start state."""
    from dpsvm_tpu_torch.ops.kernels import kernel_diag, squared_norms
    from dpsvm_tpu_torch.parallel.dist_block import MeshBlockState

    x, y = _problem(_rng(entry), N)
    n_loc = N // DEVICE_COUNT
    cut = [slice(r * n_loc, (r + 1) * n_loc) for r in range(DEVICE_COUNT)]
    x_sh = [_on(dev, x[s]) for s in cut]
    y_sh = [_on(dev, y[s]) for s in cut]
    x_sq = [squared_norms(xr) for xr in x_sh]
    k_diag = [kernel_diag(sq, _kp()) for sq in x_sq]
    valid = [torch.ones(n_loc, dtype=torch.bool, device=dev) for _ in cut]
    state = MeshBlockState(
        [torch.zeros(n_loc, device=dev) for _ in cut],
        [-yr.clone() for yr in y_sh], [_scalar(dev, -1.0)],
        [_scalar(dev, 1.0)], [_scalar(dev, 0, torch.int32)],
        [_scalar(dev, 0, torch.int32)])
    return (x_sh, y_sh, x_sq, k_diag, valid), state


def _mesh_chunk(entry: str, device, factory, **kw):
    dev = _dev(device)
    inputs, state = _mesh_inputs(entry, dev)
    run = factory(_mesh(dev), _kp(), C_BOUNDS, EPS, TAU, Q, INNER, **kw)

    def runner(*a):
        return run(*a, MAX_ITER)

    return _chunk_units(runner, inputs, state)


def mesh_chunk(device="cpu"):
    """The global mesh round: one candidate all_gather (values and ids in
    one exchange) and one working-set psum ((q, d) rows and (q, 5)
    scalars in one exchange), B1 once a device."""
    from dpsvm_tpu_torch.parallel.dist_block import make_block_chunk_runner

    return _mesh_chunk("mesh_chunk", device, make_block_chunk_runner,
                       rounds_per_chunk=1)


def mesh_chunk_ring(device="cpu"):
    """The global round with the candidate ring (B7): no collective."""
    from dpsvm_tpu_torch.parallel.dist_block import make_block_chunk_runner

    return _mesh_chunk("mesh_chunk_ring", device, make_block_chunk_runner,
                       rounds_per_chunk=1, ring_exchange=True)


def pipelined_chunk(device="cpu"):
    """The pipelined mesh round: the seed prefetch and the next one (a
    gather and a psum each) and the (q, 2) handoff psum."""
    from dpsvm_tpu_torch.parallel.dist_block import (
        make_block_pipelined_chunk_runner)

    return _mesh_chunk("pipelined_chunk", device,
                       make_block_pipelined_chunk_runner,
                       rounds_per_chunk=1)


def shardlocal_chunk(device="cpu"):
    """One shard-local sync window of R_SYNC rounds: one touched-rows
    all_gather and one (2,) pmax a window."""
    from dpsvm_tpu_torch.parallel.dist_block import (
        make_block_shardlocal_chunk_runner)

    return _mesh_chunk("shardlocal_chunk", device,
                       make_block_shardlocal_chunk_runner,
                       rounds_per_chunk=R_SYNC, sync_rounds=R_SYNC)


def shardlocal_chunk_ring(device="cpu"):
    """The shard-local window with the ring fold (B8): the (2,) pmax is
    its one collective."""
    from dpsvm_tpu_torch.parallel.dist_block import (
        make_block_shardlocal_chunk_runner)

    return _mesh_chunk("shardlocal_chunk_ring", device,
                       make_block_shardlocal_chunk_runner,
                       rounds_per_chunk=R_SYNC, sync_rounds=R_SYNC,
                       ring_exchange=True)


# ---------------------------------------------------------------------
# out of core and warm starts
# ---------------------------------------------------------------------

def _fold_tile_units(entry: str, device, n_total: int, q: int,
                     want_dots: bool) -> list:
    from dpsvm_tpu_torch.ops.kernels import squared_norms
    from dpsvm_tpu_torch.ops.ooc import ooc_fold_tile

    dev = _dev(device)
    rng = _rng(entry)
    t = min(T_TILE, n_total)  # a tile never exceeds the data
    xt, yt = _problem(rng, t)
    qx, _ = _problem(rng, q)
    x_d, qx_d = _on(dev, xt), _on(dev, qx)
    args = (x_d, squared_norms(x_d), -_on(dev, yt), None, qx_d,
            squared_norms(qx_d),
            _on(dev, rng.standard_normal(q).astype(np.float32)))
    return [Unit("fold_tile",
                 lambda: ooc_fold_tile(*args, _kp(), want_dots=want_dots),
                 state=lambda: (args[2],), args=lambda: args)]


def ooc_fold_tile(device="cpu", n_total: int = N):
    """One streamed tile's fold (ops/ooc.py ooc_fold_tile, want_dots for
    the block cache). ``n_total`` reaches only the tile clamp: the facts
    are a function of (T_TILE, D, Q), which the n-doubling test pins."""
    return _fold_tile_units("ooc_fold_tile", device, n_total, Q, True)


def ooc_fold_tile_shrink(device="cpu", n_total: int = N,
                         masked: bool = False):
    """The shrunken stream's per-live-tile fold (want_dots=False): a
    skipped tile is a call that never happens.

    ``masked=True`` is the rejected alternative: one call folding every
    tile of a device-resident (n_total, D) X under a live-tile mask. Its
    argument bytes are n-sized, so its facts must drift."""
    if not masked:
        return _fold_tile_units("ooc_fold_tile_shrink", device, n_total, Q,
                                False)
    from dpsvm_tpu_torch.ops.kernels import squared_norms
    from dpsvm_tpu_torch.ops.ooc import fold_tile_body

    dev = _dev(device)
    rng = _rng("ooc_fold_tile_shrink")
    t = min(T_TILE, n_total)
    x, y = _problem(rng, n_total)
    qx, _ = _problem(rng, Q)
    x_d, qx_d = _on(dev, x), _on(dev, qx)
    tiles = n_total // t
    args = (x_d, squared_norms(x_d), -_on(dev, y), qx_d,
            squared_norms(qx_d),
            _on(dev, rng.standard_normal(Q).astype(np.float32)),
            torch.ones(tiles, dtype=torch.bool, device=dev))

    def masked_fold(x_full, xsq_full, f_full, qx, qsq, coef, live):
        f_full = f_full.clone()
        for i in range(tiles):
            s = slice(i * t, (i + 1) * t)
            f_n, _, _ = fold_tile_body(x_full[s], xsq_full[s], f_full[s],
                                       None, qx, qsq, coef, _kp())
            f_full[s] = torch.where(live[i], f_n, f_full[s])
        return f_full

    return [Unit("fold_tile", lambda: masked_fold(*args),
                 state=lambda: (args[2],), args=lambda: args)]


def ooc_mesh_fold(device="cpu", extra_psum: bool = False):
    """The mesh stream's two programs (parallel/dist_block.py):

    * ``fold`` -- one stream step's fold, each shard its own tile, in
      place, with no exchange (``extra_psum=True`` adds one psum a step:
      the mutation the budget must catch);
    * ``select`` -- the round's selection: the candidate all_gather and
      ONE (q, 5) psum of the working set's scalars."""
    from dpsvm_tpu_torch.ops.kernels import squared_norms
    from dpsvm_tpu_torch.parallel import dist_block as db

    dev = _dev(device)
    mesh = _mesh(dev)
    (x_sh, y_sh, x_sq, k_diag, valid), st = _mesh_inputs("ooc_mesh_fold",
                                                         dev)
    rng = _rng("ooc_mesh_fold")
    n_loc = N // DEVICE_COUNT
    tile = min(T_TILE, n_loc)
    qx, _ = _problem(rng, Q)
    qx_d = _on(dev, qx)
    per_group = ([qx_d], [squared_norms(qx_d)],
                 [_on(dev, rng.standard_normal(Q).astype(np.float32))])
    tiles = [(xr[:tile], tile) for xr in x_sh]
    f = st.f

    def fold():
        db.ooc_mesh_fold(mesh, tiles, 0, tile, x_sq, f, None, *per_group,
                         _kp())
        if extra_psum:
            # The stray per-step collective the fold's budget forbids.
            mesh.psum([fr[:tile].sum() for fr in f])

    def select():
        return db.ooc_mesh_select(mesh, f, None, st.alpha, y_sh, x_sq,
                                  k_diag, valid, C_BOUNDS, Q)

    return [Unit("fold", fold, state=lambda: f,
                 args=lambda: (tiles, x_sq, f, per_group)),
            Unit("select", select,
                 args=lambda: (f, st.alpha, y_sh, x_sq, k_diag, valid))]


def warm_f_rebuild(device="cpu", n_total: int = N):
    """The warm start's gradient rebuild (solver/warmstart.py):

    * ``fold_tile`` -- the streamed form's per-tile fold at the seed
      block width Q_BLOCK (ooc_fold_tile, want_dots=False);
    * ``mesh`` -- warm_rebuild_mesh on Mesh([device] * 8) for one seed
      block: one psum of the packed (Q_BLOCK, d + 2) [rows | norms |
      coefs], then each shard's local fold."""
    from dpsvm_tpu_torch.solver.warmstart import Q_BLOCK, warm_rebuild_mesh

    dev = _dev(device)
    units = _fold_tile_units("warm_f_rebuild", device, n_total, Q_BLOCK,
                             False)
    rng = _rng("warm_f_rebuild")
    x, y = _problem(rng, N)
    alpha = np.zeros(N, np.float32)
    alpha[rng.choice(N, Q_BLOCK, replace=False)] = 1.0
    mesh = _mesh(dev)
    units.append(Unit("mesh", lambda: warm_rebuild_mesh(x, y, alpha, _kp(),
                                                         mesh)))
    return units


# ---------------------------------------------------------------------
# inference and serving
# ---------------------------------------------------------------------

def _ensemble(entry: str, k: int):
    """A CompactedEnsemble of k submodels over an (S_UNION, D) union (its
    last row the zero pad row), M_PAD SV slots each."""
    from dpsvm_tpu_torch.models.multiclass import CompactedEnsemble

    rng = _rng(entry)
    sv = rng.standard_normal((S_UNION, D)).astype(np.float32)
    sv[-1] = 0.0
    idx = rng.integers(0, S_UNION - 1, (k, M_PAD)).astype(np.int32)
    coef_pad = rng.standard_normal((k, M_PAD)).astype(np.float32)
    coef = np.zeros((S_UNION, k), np.float32)
    for j in range(k):
        np.add.at(coef[:, j], idx[j], coef_pad[j])
    return CompactedEnsemble(
        sv_union=sv, coef=coef,
        b=rng.standard_normal(k).astype(np.float32), idx=idx,
        coef_pad=coef_pad, counts=np.full(k, M_PAD, np.int32),
        kernel=_kp())


def _queries(entry: str) -> np.ndarray:
    return _rng(entry + "/q").standard_normal((NB, D)).astype(np.float32)


def compacted_decision(device="cpu"):
    """The compacted multiclass decision of one query block: ONE (nb, S)
    kernel product against the union, each submodel's values gathered
    and contracted."""
    from dpsvm_tpu_torch.models.multiclass import _compacted_decision

    dev = _dev(device)
    ens = _ensemble("compacted_decision", K_MODELS)
    ens.device_arrays(dev)  # uploaded once a device, before traffic
    q = _queries("compacted_decision")
    return [Unit("batch",
                 lambda: _compacted_decision(ens, q, 8192, dev),
                 args=lambda: ens.device_arrays(dev))]


def _staged(entry: str, dev, storage: str, k: int, shards: int = 1):
    """A StagedUnion as PredictServer stages it (the server's stream on
    the card), warmed once at bucket NB."""
    from dpsvm_tpu_torch.parallel.mesh import Mesh
    from dpsvm_tpu_torch.serve import StagedUnion, new_stream

    ens = _ensemble(entry, k)
    union = StagedUnion(ens.sv_union, ens.coef, ens.b, _kp(), storage,
                        Mesh([dev] * shards), new_stream(dev))
    q = _queries(entry)
    union.launch(q).wait()
    return union, q


def _bucket_units(entry: str, device, storage: str, k: int,
                  shards: int = 1) -> list:
    union, q = _staged(entry, _dev(device), storage, k, shards)
    return [Unit("batch", lambda: union.launch(q).wait(),
                 args=lambda: union.shards)]


def serve_bucket(device="cpu"):
    """PredictServer's bucket on a float32 union: one dense (nb, S)
    kernel product and the (S, K) contraction."""
    return _bucket_units("serve_bucket", device, "f32", K_MODELS)


def serve_bucket_bf16(device="cpu"):
    """The bucket on a bfloat16 union: the queries round through the
    storage dtype once."""
    return _bucket_units("serve_bucket_bf16", device, "bf16", K_MODELS)


def serve_bucket_int8(device="cpu"):
    """The bucket on an int8 union: queries quantized once, one int8 x
    int8 -> int32 product, one dequantizing re-widen."""
    return _bucket_units("serve_bucket_int8", device, "int8", K_MODELS)


def serve_coalesced_bucket(device="cpu"):
    """The float32 bucket at the stacked K_COALESCED columns of several
    models sharing one union: still ONE kernel product."""
    return _bucket_units("serve_coalesced_bucket", device, "f32",
                         K_COALESCED)


def serve_mesh_bucket(device="cpu"):
    """The union row-sharded over eight shards: partial columns combined
    by ONE psum (serve.py mesh_decision)."""
    return _bucket_units("serve_mesh_bucket", device, "f32", K_MODELS,
                         DEVICE_COUNT)


def serve_mesh_bucket_int8(device="cpu"):
    """The sharded int8 union: quantization adds converts, never a
    collective."""
    return _bucket_units("serve_mesh_bucket_int8", device, "int8", K_MODELS,
                         DEVICE_COUNT)


class _Member:
    """A registered model as a union group reads it (its compacted
    ensemble and column count); hashed by identity, as LoadedModel."""

    def __init__(self, ens, k: int):
        self.ens = ens
        self.k = k


def serve_mesh_group(device="cpu"):
    """The serving engine's sharded union group (serving/engine_core.py
    UnionGroup.dispatch) at the coalesced K_COALESCED columns of three
    members: one psum a dispatch, however many models ride it."""
    import types

    from dpsvm_tpu_torch.parallel.mesh import Mesh
    from dpsvm_tpu_torch.serve import new_stream
    from dpsvm_tpu_torch.serving.engine_core import UnionGroup

    dev = _dev(device)
    ens = _ensemble("serve_mesh_group", K_COALESCED)
    members = []
    for lo, hi in ((0, 10), (10, 15), (15, 16)):
        part = types.SimpleNamespace(
            sv_union=ens.sv_union, coef=ens.coef[:, lo:hi], b=ens.b[lo:hi],
            kernel=ens.kernel)
        members.append(_Member(part, hi - lo))
    group = UnionGroup("serve_mesh_group", members, (NB,),
                       Mesh([dev] * DEVICE_COUNT), new_stream(dev), "f32")
    q = _queries("serve_mesh_group")
    group.dispatch(q, NB).wait()
    return [Unit("batch", lambda: group.dispatch(q, NB).wait(),
                 args=lambda: group._union.shards)]


def mesh_predict(device="cpu"):
    """decision_function_mesh on eight shards of the SVs: per-shard
    kernel rows and ONE psum of the partial sums a query block."""
    from dpsvm_tpu_torch.models.svm_model import SVMModel
    from dpsvm_tpu_torch.predict import decision_function_mesh

    dev = _dev(device)
    rng = _rng("mesh_predict")
    sv = rng.standard_normal((S_UNION, D)).astype(np.float32)
    model = SVMModel(sv_x=sv, sv_alpha=rng.random(S_UNION).astype(
        np.float32), sv_y=np.where(rng.random(S_UNION) < 0.5, 1, -1).astype(
        np.float32), b=0.125, kernel=_kp())
    mesh = _mesh(dev)
    q = _queries("mesh_predict")
    decision_function_mesh(model, q, mesh=mesh)  # stages the shards once
    return [Unit("batch", lambda: decision_function_mesh(model, q,
                                                         mesh=mesh),
                 args=lambda: model._mesh_prepared[1])]


MANIFEST = {
    "block_chunk_single": block_chunk_single,
    "block_chunk_fusedround": block_chunk_fusedround,
    "block_chunk_fused": block_chunk_fused,
    "block_chunk_pipelined": block_chunk_pipelined,
    "block_chunk_active": block_chunk_active,
    "fleet_chunk": fleet_chunk,
    "mesh_chunk": mesh_chunk,
    "pipelined_chunk": pipelined_chunk,
    "shardlocal_chunk": shardlocal_chunk,
    "mesh_chunk_ring": mesh_chunk_ring,
    "shardlocal_chunk_ring": shardlocal_chunk_ring,
    "block_chunk_bf16gram": block_chunk_bf16gram,
    "ooc_fold_tile": ooc_fold_tile,
    "ooc_fold_tile_shrink": ooc_fold_tile_shrink,
    "ooc_mesh_fold": ooc_mesh_fold,
    "warm_f_rebuild": warm_f_rebuild,
    "compacted_decision": compacted_decision,
    "serve_bucket": serve_bucket,
    "serve_bucket_bf16": serve_bucket_bf16,
    "serve_bucket_int8": serve_bucket_int8,
    "serve_coalesced_bucket": serve_coalesced_bucket,
    "serve_mesh_bucket": serve_mesh_bucket,
    "serve_mesh_bucket_int8": serve_mesh_bucket_int8,
    "serve_mesh_group": serve_mesh_group,
    "mesh_predict": mesh_predict,
}
