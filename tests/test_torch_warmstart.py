"""Warm starts and the cascade in the port (solver/warmstart.py,
solver/cascade.py, estimators.svc_c_sweep(warm=True)) against the JAX
package's, on the CPU at the JAX tests' fixture sizes.

Contracts held here:
* bit for bit: a seed that repairs to zeros (warm_start=None included)
  runs the cold path (single device, ooc, the fleet's zero carry);
  repair_seed is the JAX package's on the same adversarial seeds
  (hypothesis); the seedless cascade is the cold solve;
* within tolerance: warm_f_rebuild against the float64
  gram_matvec_f64 (atol 5e-5, the JAX test's) and against the JAX
  package's warm_f_rebuild (atol 1e-5: two float32 sums in different
  orders); warm solves and the cascade
  against the JAX package's (the port's whole-solve contract: dual rel
  1e-4, SV count 2%, b 5e-3); the warm C sweep against the cold one
  and against JAX's (label agreement);
* the rebuild is ONE shared fold: every device fold goes through
  ops/ooc.py ooc_fold_tile (want_dots=False) under solver/ooc.py's
  TileStream, and no second Gram pass exists.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.solver import warmstart as jws
from dpsvm_tpu.solver.smo import solve as jax_solve
from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver.warmstart import (WarmStart, prepare_warm_start,
                                              repair_seed, seed_from_model,
                                              warm_f_rebuild)

KW = dict(c=1.5, epsilon=1e-3, max_iter=50_000)
CFG = SVMConfig(**KW)
BLOCK = CFG.replace(engine="block", working_set_size=64)
DUAL_RTOL, SV_TOL, B_TOL = 1e-4, 0.02, 5e-3


def _kp(cfg, d):
    return KernelParams(cfg.kernel, cfg.resolve_gamma(d), cfg.degree,
                        cfg.coef0)


def cpu_solve(x, y, cfg, **kw):
    return solve(x, y, cfg, device="cpu", **kw)


def _assert_bitwise(a, b):
    assert a.iterations == b.iterations
    assert a.converged == b.converged
    assert a.b_hi == b.b_hi and a.b_lo == b.b_lo
    np.testing.assert_array_equal(a.alpha, b.alpha)
    np.testing.assert_array_equal(a.stats["f"], b.stats["f"])


def _dual(res, y):
    a = np.asarray(res.alpha, np.float64)
    y64 = np.asarray(y, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return 0.5 * float(np.sum(a * y64 * (f + y64))) - float(a.sum())


def _assert_contract(port, ref, y):
    assert port.converged and ref.converged
    dp, dr = _dual(port, y), _dual(ref, y)
    assert abs(dp - dr) <= DUAL_RTOL * abs(dr)
    assert abs(port.n_sv - ref.n_sv) <= max(1, SV_TOL * ref.n_sv)
    assert abs(port.b - ref.b) <= B_TOL


@pytest.fixture(scope="module")
def data():
    return make_blobs_binary(n=256, d=8, seed=3, sep=0.9)


# --------------------------------------------- zero-seed routing, bits

@pytest.mark.parametrize("engine", ["xla", "block", "ooc"])
def test_zero_seed_bitwise(data, engine):
    x, y = data
    cfg = {"xla": CFG, "block": BLOCK,
           "ooc": BLOCK.replace(ooc=True, ooc_tile_rows=64)}[engine]
    cold = cpu_solve(x, y, cfg)
    warm = cpu_solve(x, y, cfg, warm_start=WarmStart(alpha=np.zeros(len(y))))
    _assert_bitwise(cold, warm)
    assert warm.stats["warm_start"]["zero_seed"] is True
    one_sided = WarmStart(alpha=np.where(np.asarray(y) > 0, 0.5, 0.0))
    _assert_bitwise(cold, cpu_solve(x, y, cfg, warm_start=one_sided))


def test_zero_seed_bitwise_fleet(data):
    """The fleet's per-problem carry: the zero carry (alpha 0, f -y) is
    the cold start, bit for bit."""
    from dpsvm_tpu_torch.solver.fleet import FleetProblem, solve_fleet

    x, y = data
    cold = solve_fleet(x, [FleetProblem(y=y)], CFG, device="cpu")[0]
    warm = solve_fleet(x, [FleetProblem(
        y=y, alpha_init=np.zeros(len(y), np.float32),
        f_init=(-np.asarray(y)).astype(np.float32))], CFG, device="cpu")[0]
    assert cold.iterations == warm.iterations
    np.testing.assert_array_equal(cold.alpha, warm.alpha)
    np.testing.assert_array_equal(cold.stats["f"], warm.stats["f"])


def test_seed_rows_out_of_range_and_not_both(data):
    x, y = data
    bad = WarmStart(alpha=np.ones(4), rows=np.array([0, 1, 2, len(y)]))
    for fn in (cpu_solve, lambda *a, **k: jax_solve(*a, **k)):
        cfg = CFG if fn is cpu_solve else JaxConfig(**KW)
        ws = bad if fn is cpu_solve else jws.WarmStart(alpha=bad.alpha,
                                                      rows=bad.rows)
        with pytest.raises(ValueError, match="out of range"):
            fn(x, y, cfg, warm_start=ws)
    with pytest.raises(ValueError, match="not both"):
        cpu_solve(x, y, CFG, warm_start=WarmStart(alpha=np.zeros(len(y))),
                  alpha_init=np.zeros(len(y), np.float32),
                  f_init=np.zeros(len(y), np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        WarmStart(alpha=np.ones(3), rows=np.arange(4)).dense(10)


# ------------------------------------------------- the repair, bits

def _check_feasible(a, y, c_bounds):
    c_pos, c_neg = c_bounds
    box = np.where(np.asarray(y, np.float64) > 0, c_pos, c_neg)
    assert np.all(a >= 0.0) and np.all(a <= box + 1e-12)
    assert abs(float(np.dot(a, np.asarray(y, np.float64)))) < 1e-9


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(2, 200),
       lo=st.floats(-3.0, 0.5), hi=st.floats(0.5, 5.0),
       c_pos=st.floats(0.05, 4.0), c_neg=st.floats(0.05, 4.0),
       density=st.floats(0.0, 1.0))
def test_repair_seed_is_jaxs(seed, n, lo, hi, c_pos, c_neg, density):
    """Out-of-box, negative, sparse and unbalanced seeds in random
    (asymmetric) boxes: the port's repair is the JAX package's bit for
    bit (alpha and every stat), and feasible."""
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    alpha = rng.uniform(lo, hi, size=n) * (rng.random(n) < density)
    a, st_ = repair_seed(alpha, y, (c_pos, c_neg))
    ja, jst = jws.repair_seed(alpha, y, (c_pos, c_neg))
    np.testing.assert_array_equal(a, ja)
    assert st_ == jst
    if not st_["zero_seed"]:
        _check_feasible(a, y, (c_pos, c_neg))
        a2, _ = repair_seed(a, y, (c_pos, c_neg))
        np.testing.assert_allclose(a2, a, rtol=0, atol=1e-12)


def test_repair_c_shrink_across_generations(data):
    """A C=4 solution carried into C=0.25: the clip unbalances the
    sides, the repair restores the equality, and the solver takes the
    carry end to end."""
    x, y = data
    big = cpu_solve(x, y, BLOCK.replace(c=4.0))
    shrunk = SVMConfig(c=0.25)
    a, st_ = repair_seed(np.asarray(big.alpha, np.float64), y,
                         shrunk.c_bounds())
    _check_feasible(a, y, shrunk.c_bounds())
    assert st_["clipped"] > 0 and not st_["zero_seed"]
    res = cpu_solve(x, y, BLOCK.replace(c=0.25),
                    warm_start=WarmStart(alpha=np.asarray(big.alpha)))
    assert res.converged
    a_out = np.asarray(res.alpha, np.float64)
    assert np.all(a_out >= 0.0) and np.all(a_out <= 0.25 + 1e-6)
    assert abs(float(np.dot(a_out, np.asarray(y, np.float64)))) < 1e-4
    jres = jax_solve(x, y, JaxConfig(**dict(KW, c=0.25), engine="block",
                                     working_set_size=64),
                     warm_start=jws.WarmStart(alpha=np.asarray(big.alpha)))
    _assert_contract(res, jres, y)


def test_one_sided_seed_prepares_to_the_cold_start():
    y = np.array([1, 1, -1, -1], np.int32)
    a0, f0, st_ = prepare_warm_start(
        np.zeros((4, 2), np.float32), y, SVMConfig(c=1.0),
        WarmStart(alpha=np.array([1.0, 0.5, 0.0, 0.0])), device="cpu")
    assert a0 is None and f0 is None and st_["zero_seed"]
    # On a mesh too (the mesh rebuild never runs for a zero seed).
    from dpsvm_tpu_torch import Mesh

    for seed in (None, WarmStart(alpha=np.array([1.0, 0.5, 0.0, 0.0]))):
        a0, f0, st_ = prepare_warm_start(
            np.zeros((4, 2), np.float32), y, SVMConfig(c=1.0), seed,
            mesh=Mesh(["cpu"] * 2))
        assert a0 is None and f0 is None and st_["zero_seed"]


# ------------------------------------- the ONE streamed gradient fold

def test_warm_rebuild_matches_f64_and_jax_and_shares_fold(monkeypatch):
    import dpsvm_tpu_torch.ops.ooc as ooc_mod
    from dpsvm_tpu_torch.solver import ooc as tooc
    from dpsvm_tpu_torch.solver.reconstruct import gram_matvec_f64

    x, y = make_blobs_binary(n=300, d=12, seed=5, sep=0.8)
    res = cpu_solve(x, y, BLOCK)
    a, _ = repair_seed(np.asarray(res.alpha, np.float64), y, CFG.c_bounds())
    kp = _kp(CFG, 12)

    folds, walks = [], []
    fold, walk = ooc_mod.ooc_fold_tile, tooc.TileStream.walk

    def spy_fold(*args, **kw):
        folds.append(kw)
        return fold(*args, **kw)

    def spy_walk(self, order):
        walks.append(list(order))
        return walk(self, walks[-1])

    monkeypatch.setattr(ooc_mod, "ooc_fold_tile", spy_fold)
    monkeypatch.setattr(tooc.TileStream, "walk", spy_walk)
    f = warm_f_rebuild(x, y, a, kp, device="cpu", tile_rows=128)
    assert walks == [[0, 1, 2]]  # one pass over the three tiles
    assert len(folds) == 3 and all(k["want_dots"] is False for k in folds)

    coef = a * np.asarray(y, np.float64)
    f_ref = gram_matvec_f64(x, coef, kp) - np.asarray(y, np.float64)
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=5e-5)
    jf = jws.warm_f_rebuild(x, y, a, JaxKP("rbf", kp.gamma), tile_rows=128)
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-5)
    # The all-zero seed streams nothing and is -y.
    walks.clear()
    np.testing.assert_array_equal(
        warm_f_rebuild(x, y, np.zeros(300), kp, device="cpu"),
        -np.asarray(y, np.float32))
    assert walks == []


# ------------------------------------------- warm vs cold, the increment

def test_warm_increment_vs_cold_and_jax():
    """The learning loop's increment: concat(prev SVs, fresh rows) seeded
    by seed_from_model reaches the cold solve's model in fewer pairs, and
    the JAX package's warm solve within the contract."""
    rng = np.random.default_rng(11)
    d, n0, n1 = 24, 192, 96
    centers = rng.normal(size=(2, d)) * 0.6

    def draw(n):
        lab = rng.integers(0, 2, size=n)
        xs = (centers[lab] + rng.normal(size=(n, d))).astype(np.float32)
        return xs, np.where(lab > 0, 1, -1).astype(np.int32)

    x0, y0 = draw(n0)
    xf, yf = draw(n1)
    kp = _kp(BLOCK, d)
    base = cpu_solve(x0, y0, BLOCK)
    m0 = SVMModel.from_dense(x0, y0, base.alpha, base.b, kp)
    x_inc = np.concatenate([np.asarray(m0.sv_x, np.float32), xf])
    y_inc = np.concatenate([np.asarray(m0.sv_y, np.int32), yf])
    cold = cpu_solve(x_inc, y_inc, BLOCK)
    warm = cpu_solve(x_inc, y_inc, BLOCK, warm_start=seed_from_model(m0))
    assert warm.converged and cold.converged
    assert warm.iterations < cold.iterations
    assert warm.stats["warm_start"]["seed_rows"] > 0
    _assert_contract(warm, cold, y_inc)
    jcfg = JaxConfig(**KW, engine="block", working_set_size=64)
    jwarm = jax_solve(x_inc, y_inc, jcfg, warm_start=jws.WarmStart(
        alpha=np.asarray(m0.sv_alpha, np.float64),
        rows=np.arange(m0.sv_alpha.shape[0])))
    _assert_contract(warm, jwarm, y_inc)
    ooc = cpu_solve(x_inc, y_inc, BLOCK.replace(ooc=True, ooc_tile_rows=64),
                    warm_start=seed_from_model(m0))
    _assert_contract(ooc, cold, y_inc)
    assert ooc.stats["ooc"] and ooc.stats["warm_start"]["seed_rows"] > 0


# --------------------------------------------------------- the cascade

def test_cascade_partition_is_jaxs():
    from dpsvm_tpu.solver.cascade import cascade_partition as jpart
    from dpsvm_tpu_torch.solver.cascade import cascade_partition

    for n, b in [(1000, 256), (256, 256), (257, 256), (5, 64), (1, 1)]:
        blocks = cascade_partition(n, b)
        assert sorted(np.concatenate(blocks).tolist()) == list(range(n))
        sizes = {len(blk) for blk in blocks}
        assert max(sizes) - min(sizes) <= 1
        for got, want in zip(blocks, jpart(n, b), strict=True):
            np.testing.assert_array_equal(got, want)
    for bad in [(0, 4), (4, 0)]:
        with pytest.raises(ValueError):
            cascade_partition(*bad)


def test_cascade_solve_agrees_with_flat_and_jax():
    from dpsvm_tpu.solver.cascade import cascade_solve as jcascade
    from dpsvm_tpu_torch.predict import predict
    from dpsvm_tpu_torch.solver.cascade import cascade_solve

    x, y = make_blobs_binary(n=400, d=10, seed=13, sep=0.8)
    kp = _kp(BLOCK, 10)
    flat = cpu_solve(x, y, BLOCK)
    res, st_ = cascade_solve(x, y, BLOCK, block_rows=128, device="cpu")
    assert res.converged and len(st_["blocks"]) == 4
    assert res.stats["cascade"] is st_
    assert st_["total_iterations"] == st_["final_iterations"] + sum(
        b["iterations"] for b in st_["blocks"])
    mf = SVMModel.from_dense(x, y, flat.alpha, flat.b, kp)
    mc = SVMModel.from_dense(x, y, res.alpha, res.b, kp)
    xt, _ = make_blobs_binary(n=200, d=10, seed=14, sep=0.8)
    assert np.mean(predict(mf, xt, device="cpu")
                   == predict(mc, xt, device="cpu")) >= 0.97
    _assert_contract(res, flat, y)
    jres, jst = jcascade(x, y, JaxConfig(**KW, engine="block",
                                         working_set_size=64),
                         block_rows=128)
    _assert_contract(res, jres, y)
    assert [b["rows"] for b in st_["blocks"]] == [
        b["rows"] for b in jst["blocks"]]


def test_cascade_degenerates_to_the_cold_solve(data):
    from dpsvm_tpu_torch.solver.cascade import cascade_solve

    x, y = data
    res, st_ = cascade_solve(x, y, BLOCK, block_rows=4096, device="cpu")
    assert st_["blocks"] == []
    _assert_bitwise(cpu_solve(x, y, BLOCK), res)


# ------------------------------------------------- the warm C sweep

def test_svc_c_sweep_warm_walk_matches_cold_and_jax():
    from dpsvm_tpu import estimators as jest
    from dpsvm_tpu_torch import estimators as test_

    x, y = make_blobs_binary(n=160, d=8, seed=17, sep=0.8)
    cs = [2.0, 0.5, 1.0]  # unsorted: results come back in Cs order
    kw = dict(gamma=0.2, tol=1e-3, backend="single")
    cold = test_.svc_c_sweep(x, y, cs, device="cpu", **kw)
    warm = test_.svc_c_sweep(x, y, cs, warm=True, device="cpu", **kw)
    jwarm = jest.svc_c_sweep(x, y, cs, warm=True, **kw)
    assert [e.C for e in warm] == cs
    for ec, ew, ej in zip(cold, warm, jwarm):
        assert ew.fit_result_.converged
        assert np.mean(ec.predict(x) == ew.predict(x)) >= 0.95
        assert np.mean(ej.predict(x) == ew.predict(x)) >= 0.95
        assert abs(ew.fit_result_.n_sv - ej.fit_result_.n_sv) <= max(
            2, 0.02 * ej.fit_result_.n_sv)
    # Ascending C: every C after the smallest starts from a seed.
    seeded = [e.fit_result_.stats.get("warm_start") for e in warm]
    assert seeded[1] is None and seeded[0] and seeded[2]
    with pytest.raises(ValueError, match="fleet executor"):
        test_.svc_c_sweep(x, y, cs, engine="pallas", device="cpu", **kw)


def test_mesh_refuses_warm_start_naming_10b(data):
    """Warm starts on the mesh, which the port once refused (the JAX
    package's tests/test_warmstart.py:63): the mesh rebuild
    (warm_rebuild_mesh, one masked sum a seed block) is held to the
    float64 gradient (atol 5e-5) and to the JAX package's single-chip
    warm_f_rebuild (atol 1e-5), not to its mesh rebuild bit for bit; a
    warm mesh solve meets the whole-solve contract against the JAX
    package's warm mesh solve and takes fewer pairs than the cold one;
    an all-zero seed runs the cold mesh path bit for bit."""
    from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
    from dpsvm_tpu_torch import Mesh, solve_mesh
    from dpsvm_tpu_torch.solver.reconstruct import gram_matvec_f64
    from dpsvm_tpu_torch.solver.warmstart import warm_rebuild_mesh

    x, y = data
    d = x.shape[1]
    base = cpu_solve(x, y, BLOCK)
    a, _ = repair_seed(0.9 * np.asarray(base.alpha, np.float64), y,
                       BLOCK.c_bounds())
    kp = _kp(BLOCK, d)
    for p_dev in (2, 4):
        f = warm_rebuild_mesh(x, y, a, kp, Mesh(["cpu"] * p_dev),
                              q_block=64)
        f_ref = gram_matvec_f64(x, a * y, kp) - np.asarray(y, np.float64)
        np.testing.assert_allclose(f, f_ref, rtol=0, atol=5e-5)
        jf = jws.warm_f_rebuild(x, y, a, JaxKP("rbf", kp.gamma))
        np.testing.assert_allclose(f, jf, rtol=0, atol=1e-5)
    mesh = Mesh(["cpu"] * 2)
    seed = WarmStart(alpha=0.9 * np.asarray(base.alpha))
    warm = solve_mesh(x, y, BLOCK, mesh=mesh, warm_start=seed)
    jwarm = jax_solve_mesh(x, y, JaxConfig(**KW, engine="block",
                                           working_set_size=64),
                           num_devices=2,
                           warm_start=jws.WarmStart(alpha=seed.alpha))
    _assert_contract(warm, jwarm, y)
    cold = solve_mesh(x, y, BLOCK, mesh=mesh)
    assert warm.iterations < cold.iterations
    assert warm.stats["warm_start"]["seed_nnz"] > 0
    zero = solve_mesh(x, y, BLOCK, mesh=mesh,
                      warm_start=WarmStart(alpha=np.zeros(len(y))))
    _assert_bitwise(zero, cold)