"""Out-of-core training in the port (config.ooc, solver/ooc.py) against
the port's in-core block engine and against the JAX package's
dpsvm_tpu/solver/ooc.py, on the CPU at the JAX tests' fixture sizes
(n <= 1024, d <= 24).

Contracts held here:
* bit for bit: the ooc trajectory and the in-core one (plain, padded
  tail, compensated, memmap-backed X: same pairs, extrema, alpha and f
  bits); a cache-off resume and the uninterrupted run (with and without
  the shrunken stream); the host reader, shrink_view and the cache's
  probe / refresh against the JAX package's;
* within tolerance: a tile's fold against the JAX package's fold_tile_body
  (rtol 1e-6), whole solves against the JAX package's ooc solve (the
  port's contract: dual rel 1e-4, SV count 2%, b 5e-3), checkpoints
  resumed across the packages in both directions with and without the
  shrink keys (the same contract);
* config validation raises JAX's exception types.
"""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops import ooc as jooc_ops
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.ops.select import shrink_view as jshrink_view
from dpsvm_tpu.solver import cache as jcache
from dpsvm_tpu.solver import ooc as jooc
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu.utils import checkpoint as jck
from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops import ooc as ooc_ops
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.ops.select import shrink_view
from dpsvm_tpu_torch.solver import cache as tcache
from dpsvm_tpu_torch.solver import ooc as tooc
from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint_state

KW = dict(c=1.0, epsilon=1e-2, engine="block", working_set_size=64,
          max_iter=50_000)
CFG = SVMConfig(**KW)
OOC = CFG.replace(ooc=True, ooc_tile_rows=256)
DUAL_RTOL, SV_TOL, B_TOL = 1e-4, 0.02, 5e-3


@pytest.fixture(scope="module")
def data():
    return make_blobs_binary(n=1024, d=24, seed=11, sep=1.5)


@pytest.fixture(scope="module")
def incore(data):
    return solve(*data, CFG, device="cpu")


def cpu_solve(x, y, cfg, **kw):
    return solve(x, y, cfg, device="cpu", **kw)


def _assert_bitwise(a, b):
    assert a.iterations == b.iterations
    assert a.converged == b.converged
    assert a.b_hi == b.b_hi and a.b_lo == b.b_lo
    np.testing.assert_array_equal(a.alpha, b.alpha)
    np.testing.assert_array_equal(a.stats["f"], b.stats["f"])


def _dual(res, y):
    """The C-SVC dual objective from the final gradient: with f = K(a y)
    - y, 1/2 a^T Q a - sum a = 1/2 sum a y (f + y) - sum a."""
    a = np.asarray(res.alpha, np.float64)
    y64 = np.asarray(y, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return 0.5 * float(np.sum(a * y64 * (f + y64))) - float(a.sum())


def _assert_contract(port, ref, y):
    """The port's whole-solve contract against a reference solve."""
    assert port.converged and ref.converged
    dp, dr = _dual(port, y), _dual(ref, y)
    assert abs(dp - dr) <= DUAL_RTOL * abs(dr)
    assert abs(port.n_sv - ref.n_sv) <= max(1, SV_TOL * ref.n_sv)
    assert abs(port.b - ref.b) <= B_TOL


def _memmap(tmp_path, x):
    path = tmp_path / "x.dat"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    return np.memmap(path, dtype=np.float32, mode="r", shape=x.shape)


# ------------------------------------------------- ooc == in-core, bits

@pytest.mark.parametrize("case", ["plain", "padded_tail", "compensated",
                                  "memmap"])
def test_ooc_bitwise_to_incore(data, incore, tmp_path, case):
    """The ooc round is the in-core round's algebra on the same n rows:
    selection, subproblem and every tile's fold columns are the in-core
    engine's bits (tiles of 256 rows: a multiple of 16)."""
    x, y = data
    cfg, ref = CFG, incore
    if case == "padded_tail":
        x, y = x[:1000], y[:1000]  # 1000 = 3 x 256 + 232
        ref = cpu_solve(x, y, cfg)
    elif case == "compensated":
        cfg = CFG.replace(compensated=True)
        ref = cpu_solve(x, y, cfg)
    elif case == "memmap":
        x = _memmap(tmp_path, x)
    res = cpu_solve(x, y, cfg.replace(ooc=True, ooc_tile_rows=256))
    _assert_bitwise(ref, res)
    st = res.stats
    tiles = -(-len(y) // 256)
    # Every stream round moves every real row once (float32 uploads).
    assert st["ooc"] and st["tiles_streamed"] == tiles * st["outer_rounds"]
    assert st["tile_bytes_h2d"] == 4 * x.shape[1] * len(y) * st[
        "outer_rounds"]
    assert st["outer_rounds"] > 1 and st["device"] == "cpu"


def test_ooc_matches_jax_within_contract(data):
    x, y = data
    jres = jax_solve(x, y, JaxConfig(**KW, ooc=True, ooc_tile_rows=256))
    res = cpu_solve(x, y, OOC)
    _assert_contract(res, jres, y)
    assert jres.stats["ooc"] and res.stats["ooc"]


# ---------------------------------------------------- the pieces, bits

@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("want_dots", [False, True])
def test_fold_tile_matches_jax(compensated, want_dots):
    """ops/ooc.py fold_tile_body against the JAX package's on the same
    tile: the slice and residual within rtol 1e-6 (matmul order differs
    between the packages, ROADMAP C.3), the dot rows within 1e-6."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    xt = rng.normal(size=(96, 20)).astype(np.float32)
    qx = rng.normal(size=(16, 20)).astype(np.float32)
    f = rng.normal(size=96).astype(np.float32)
    err = (rng.normal(size=96) * 1e-7).astype(np.float32)
    coef = rng.normal(size=16).astype(np.float32)
    xsq = np.einsum("ij,ij->i", xt, xt).astype(np.float32)
    qsq = np.einsum("ij,ij->i", qx, qx).astype(np.float32)
    import torch

    got = ooc_ops.fold_tile_body(
        torch.from_numpy(xt), torch.from_numpy(xsq), torch.from_numpy(f),
        torch.from_numpy(err) if compensated else None,
        torch.from_numpy(qx), torch.from_numpy(qsq), torch.from_numpy(coef),
        KernelParams("rbf", 0.05), want_dots=want_dots,
        compensated=compensated)
    want = jooc_ops.fold_tile_body(
        jnp.asarray(xt), jnp.asarray(xsq), jnp.asarray(f),
        jnp.asarray(err) if compensated else None, jnp.asarray(qx),
        jnp.asarray(qsq), jnp.asarray(coef), JaxKP("rbf", 0.05),
        want_dots=want_dots, compensated=compensated)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    assert (got[1] is None) == (want[1] is None) == (not compensated)
    if compensated:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)
    assert (got[2] is None) == (want[2] is None) == (not want_dots)
    if want_dots:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("s,t", [(0, 64), (64, 64), (96, 64), (100, 8)])
def test_tile_host_is_jaxs(tmp_path, s, t):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(100, 5)).astype(np.float32)
    for src in (x, _memmap(tmp_path, x)):
        got = tooc._tile_host(src, s, t, 100, 5)
        np.testing.assert_array_equal(got, jooc._tile_host(src, s, t, 100, 5))
        assert got.shape == (t, 5) and got.dtype == np.float32


def test_shrink_view_is_jaxs():
    rng = np.random.default_rng(2)
    for trial in range(20):
        n = int(rng.integers(10, 300))
        n_pad = n + int(rng.integers(0, 40))
        m = int(rng.integers(1, 64))
        w = rng.integers(0, n_pad, size=m)
        ok = rng.random(m) < 0.7
        tile = int(rng.integers(1, 64))
        a, lt = shrink_view(w, ok, n, n_pad, tile)
        ja, jlt = jshrink_view(w, ok, n, n_pad, tile)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(lt, jlt)


def test_cache_probe_and_refresh_are_jaxs():
    """A seeded sequence of whole-working-set refreshes: the lines, keys,
    ticks, hit and eviction counts are the JAX package's bit for bit
    (the same LRU order and tie rules)."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(5)
    lines, q, n = 8, 4, 16
    port = tcache.init_host_cache(lines, n, torch.device("cpu"))
    jax = jcache.init_cache(lines, n)
    for stamp in range(1, 40):
        w = rng.choice(12, size=q, replace=False).astype(np.int32)
        ok = rng.random(q) < 0.8
        rows = rng.normal(size=(q, n)).astype(np.float32)
        hit, slot = tcache.probe_rows(port.keys, w, ok)
        jhit, jslot = jcache.probe_rows(jnp.asarray(port.keys),
                                        jnp.asarray(w), jnp.asarray(ok))
        np.testing.assert_array_equal(hit, np.asarray(jhit))
        np.testing.assert_array_equal(slot[hit], np.asarray(jslot)[hit])
        nh, ne = tcache.refresh_rows(port, w, ok, torch.from_numpy(rows),
                                     stamp)
        jax, jnh, jne = jcache.refresh_rows(jax, jnp.asarray(w),
                                            jnp.asarray(ok),
                                            jnp.asarray(rows),
                                            jnp.int32(stamp))
        assert (nh, ne) == (int(jnh), int(jne))
        np.testing.assert_array_equal(port.keys, np.asarray(jax.keys))
        np.testing.assert_array_equal(port.ticks, np.asarray(jax.ticks))
        np.testing.assert_array_equal(port.data.numpy(),
                                      np.asarray(jax.data))


def test_stream_walks_tiles_in_order_on_the_cpu(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(70, 3)).astype(np.float32)
    import torch

    st = tooc.TileStream(_memmap(tmp_path, x), 70, 3, 32, torch.device("cpu"),
                         "bfloat16")
    seen = [(i, rows) for i, xt, rows in st.walk([2, 0])]
    assert seen == [(2, 6), (0, 32)]
    assert st.bytes == (6 + 32) * 3 * 4
    i, xt, rows = next(iter(st.walk([1])))
    assert xt.dtype == torch.bfloat16
    assert torch.equal(xt, torch.from_numpy(x[32:64]).to(torch.bfloat16))


# ------------------------------------------------- cache, budget, shrink

def test_ooc_block_cache_all_hit_rounds(data, incore):
    x, y = data
    res = cpu_solve(x, y, OOC.replace(ooc_cache_lines=1024))
    nostream = cpu_solve(x, y, OOC)
    st = res.stats
    assert st["cached_rounds"] > 0 and st["cache_hits"] > 0
    assert st["cache_hit_rate"] > 0.5
    assert st["tiles_streamed"] < nostream.stats["tiles_streamed"]
    assert res.converged
    np.testing.assert_allclose(res.alpha, incore.alpha, atol=2e-4)
    assert abs(res.b - incore.b) < 5e-3


def test_ooc_cache_eviction_pressure(data):
    x, y = data
    res = cpu_solve(x, y, OOC.replace(ooc_cache_lines=64))
    assert res.stats["cache_evictions"] > 0
    assert res.stats["cache_lookups"] >= res.stats["cache_hits"]
    assert res.converged


def test_ooc_budget_exit(data):
    """budget_mode runs exactly max_iter pairs; a plain budget exit
    reports the stopping rule at the real epsilon on the final state
    (refresh_extrema_host)."""
    x, y = data
    res = cpu_solve(x, y, OOC.replace(budget_mode=True, max_iter=500))
    assert res.iterations == 500
    cut = cpu_solve(x, y, OOC.replace(max_iter=300))
    assert cut.iterations >= 300 and not cut.converged
    assert cut.b_lo > cut.b_hi + 2 * OOC.epsilon


def test_ooc_shrink_converges_same_criterion(data, incore):
    x, y = data
    res = cpu_solve(x, y, OOC.replace(ooc_tile_rows=128, active_set_size=256))
    assert res.converged
    assert res.b_lo <= res.b_hi + 2.0 * CFG.epsilon + 1e-6
    st = res.stats
    assert st["ooc_shrink"] is True and st["shrink_m"] == 256
    assert st["shrink_cycles"] >= 1 and st["shrink_reconstructions"] >= 1
    assert st["tiles_skipped"] > 0 and st["tile_bytes_skipped"] > 0
    assert st["shrink_tiles_in_cycle"] > 0
    assert abs(res.b - incore.b) < 0.05
    assert abs(res.n_sv - incore.n_sv) <= max(8, incore.n_sv // 10)
    auto = cpu_solve(x, y, OOC.replace(ooc_tile_rows=128, ooc_shrink=True))
    assert auto.converged and auto.stats["shrink_m"] == max(4 * 64,
                                                            1024 // 8)
    off = cpu_solve(x, y, OOC)  # ooc_shrink=None: the gate is off
    assert off.stats["ooc_shrink"] is False


# ---------------------------------------------------- checkpoint, resume

def test_ooc_resume_bitwise(data, incore, tmp_path):
    x, y = data
    p = str(tmp_path / "ooc.ck.npz")
    cfg = OOC.replace(checkpoint_every=1_000_000)  # only the abort saves
    part = cpu_solve(x, y, cfg, callback=lambda it, *_: it >= 300,
                     checkpoint_path=p)
    assert not part.converged and part.iterations < incore.iterations
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert res.stats["resumed_from"] == part.iterations
    assert res.stats["cache_cold_restart"] is False
    _assert_bitwise(incore, res)


def test_ooc_resume_memmap_padded_tail_compensated(data, tmp_path):
    """Both hard cases at once, against the port's own uninterrupted
    run: a memmap X with a zero-padded tail tile, compensated (the raw
    f and f_err lanes carry)."""
    x, y = data
    x, y = x[:1000], y[:1000]
    ocfg = OOC.replace(compensated=True, checkpoint_every=1_000_000)
    ro = _memmap(tmp_path, x)
    full = cpu_solve(ro, y, ocfg)
    p = str(tmp_path / "ooc.ck.npz")
    part = cpu_solve(ro, y, ocfg, callback=lambda it, *_: it >= 300,
                     checkpoint_path=p)
    assert not part.converged
    st = load_checkpoint_state(p)
    assert st.format_version == 2 and st.f_err is not None and st.rounds > 0
    assert st.shrink_gap is None  # not shrinking: no shrink keys
    res = cpu_solve(ro, y, ocfg, checkpoint_path=p, resume=True)
    _assert_bitwise(full, res)


class _Killed(Exception):
    pass


def _kill_at(rounds: int):
    """A callback that dies mid-solve (a killed process: no abort
    checkpoint), after `rounds` rounds."""
    calls = [0]

    def cb(*_):
        calls[0] += 1
        if calls[0] >= rounds:
            raise _Killed()
    return cb


def test_ooc_shrink_resume_bitwise(data, tmp_path):
    """Killed mid shrinking solve, resumed from the periodic checkpoint
    (saved at cycle boundaries with the demotion latch, the last cycle
    gap and the stall streak): bitwise the uninterrupted shrinking
    run."""
    x, y = data
    cfg = OOC.replace(ooc_tile_rows=128, active_set_size=256,
                      checkpoint_every=128)
    full = cpu_solve(x, y, cfg)
    assert full.stats["shrink_cycles"] >= 1
    assert full.stats["tiles_skipped"] > 0
    p = str(tmp_path / "shrink.npz")
    with pytest.raises(_Killed):
        cpu_solve(x, y, cfg, checkpoint_path=p,
                  callback=_kill_at(full.stats["outer_rounds"] // 2))
    st = load_checkpoint_state(p)
    assert st.shrink_gap is not None or st.shrink_demoted
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert res.stats["resumed_from"] > 0
    _assert_bitwise(full, res)


def test_ooc_cache_restarts_cold_on_resume(data, tmp_path):
    x, y = data
    p = str(tmp_path / "ooc.ck.npz")
    cfg = OOC.replace(ooc_cache_lines=1024, checkpoint_every=1_000_000)
    cpu_solve(x, y, cfg, callback=lambda it, *_: it >= 300,
              checkpoint_path=p)
    res = cpu_solve(x, y, cfg, checkpoint_path=p, resume=True)
    assert res.converged
    assert res.stats["cache_cold_restart"] is True


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("shrink", [False, True])
def test_ooc_checkpoints_cross_the_packages(data, tmp_path, writer, shrink):
    """An ooc file written mid-solve by one package resumes in the other
    and lands within the contract of the reader's uninterrupted run;
    the shrink keys, when written, are read by both."""
    x, y = data
    kw = dict(KW, ooc=True, ooc_tile_rows=128, checkpoint_every=1_000_000)
    if shrink:
        kw.update(active_set_size=256)
    p = str(tmp_path / f"{writer}.npz")
    stop = lambda it, *_: it >= 300  # noqa: E731
    if writer == "port":
        cpu_solve(x, y, SVMConfig(**kw), callback=stop, checkpoint_path=p)
        res = jax_solve(x, y, JaxConfig(**kw), checkpoint_path=p,
                        resume=True)
        ref = jax_solve(x, y, JaxConfig(**kw))
    else:
        jax_solve(x, y, JaxConfig(**kw), callback=stop, checkpoint_path=p)
        res = cpu_solve(x, y, SVMConfig(**kw), checkpoint_path=p,
                        resume=True)
        ref = cpu_solve(x, y, SVMConfig(**kw))
    for st in (load_checkpoint_state(p), jck.load_checkpoint_state(p)):
        assert st.iteration >= 300 and st.rounds > 0
        assert (st.shrink_gap is not None or st.shrink_demoted) == shrink
    assert res.stats["resumed_from"] >= 300
    _assert_contract(res, ref, y)


# ------------------------------------------------------------- the edges

OOC_CONFIGS = [
    dict(ooc=True, engine="xla"),
    dict(ooc=True, engine="block", kernel="precomputed"),
    dict(ooc=True, engine="block", gram_resident=True),
    dict(ooc=True, engine="block", active_set_size=256, ooc_shrink=False),
    dict(engine="block", ooc_shrink=True),
    dict(ooc=True, engine="block", pipeline_rounds=True),
    dict(ooc=True, engine="block", fused_fold=True),
    dict(ooc=True, engine="block", fused_round=True),
    dict(ooc=True, engine="block", bf16_gram=True),
    dict(ooc=True, engine="block", working_set_size=128,
         ooc_cache_lines=64),
    dict(engine="block", ooc_cache_lines=256),
    dict(ooc=True, engine="block", local_working_sets=2),
    dict(ooc=True, engine="block", reconstruct_every=100),
    dict(ooc=True, engine="block", selection="nu"),
    dict(ooc=True, engine="block", ooc_tile_rows=4),
    dict(ooc=True, engine="block", active_set_size=256),
    dict(ooc=True, engine="block", ooc_cache_lines=256, ooc_shrink=True),
]


@pytest.mark.parametrize("kw", OOC_CONFIGS)
def test_ooc_config_validation_matches_jax(kw):
    """Each combination raises the JAX package's exception type, or is
    accepted by both; an accepted ooc config runs in the port."""
    def outcome(cls):
        try:
            cls(**kw)
        except Exception as e:  # noqa: BLE001 - the type is the result
            return type(e).__name__
        return None

    want = outcome(JaxConfig)
    assert outcome(SVMConfig) == want
    if want is None:
        SVMConfig(**kw).check_ported()


def test_mesh_refuses_ooc_and_auto_keeps_it_on_one_device(data):
    """Once a refusal (item 10b): the mesh now runs the ooc stream, bit
    for bit the one-device stream here, and auto keeps only the cache and
    the shrunken stream on one device (the JAX package's
    single_only_ooc)."""
    from dpsvm_tpu_torch import Mesh, solve_mesh, train
    from dpsvm_tpu_torch.train import resolve_backend

    x, y = data
    mesh = Mesh(["cpu"] * 2)
    _assert_bitwise(cpu_solve(x, y, OOC), solve_mesh(x, y, OOC, mesh=mesh))
    for cfg in (OOC.replace(ooc_cache_lines=256),
                OOC.replace(ooc_shrink=True)):
        assert resolve_backend("auto", cfg, mesh=mesh) == "single"
    assert resolve_backend("auto", OOC, mesh=mesh) == "mesh"
    assert resolve_backend("auto", CFG, mesh=mesh) == "mesh"
    _, res = train(x, y, OOC, backend="mesh", mesh=mesh)
    assert res.stats["ooc_mesh"]
    model, res = train(x[:512], y[:512], OOC, device="cpu")
    assert res.stats["ooc"] and model.sv_x.shape[0] == res.n_sv
