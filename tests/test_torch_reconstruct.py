"""Float64 reconstruction legs of the port (config.reconstruct_every,
solver/reconstruct.py) against the JAX package's, on the stress problem
of tests/test_reconstruct.py (its _stress() and STRESS, repeated here):
the legs converge on xla / mvp, xla / second_order and block /
second_order with the true gap certified within 2 eps, gram_matvec_f64
against the JAX package's for every kernel, the SVR reduction's linear
term, checkpoint and resume with legs, and the upfront regime gate."""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.solver import reconstruct as jrec
from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.models import train_svr
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.ops.select import extrema_np
from dpsvm_tpu_torch.solver import reconstruct as trec


def _stress(n=400, d=12, seed=7):
    """Overlapping blobs at extreme C (tests/test_reconstruct.py)."""
    return make_blobs_binary(n=n, d=d, seed=seed, sep=0.6)


STRESS_KW = dict(c=5000.0, gamma=0.05, epsilon=1e-3, max_iter=400_000)
STRESS = SVMConfig(**STRESS_KW)


def _true_f(x, y, alpha, cfg):
    kp = KernelParams(cfg.kernel, cfg.resolve_gamma(x.shape[1]),
                      cfg.degree, cfg.coef0)
    y64 = np.asarray(y, np.float64)
    return trec.gram_matvec_f64(x, np.asarray(alpha, np.float64) * y64,
                                kp, cfg.dtype) - y64


# The JAX test runs 50000-pair legs everywhere; a block leg of the port's
# CPU form takes ~0.4 ms a pair here, so the block case runs 10000-pair
# legs (its stalled block legs then hand the tail to the per-pair engine
# after 20000 pairs, as the JAX package's do at this leg length).
@pytest.mark.parametrize("engine,selection,every", [
    ("xla", "mvp", 50_000), ("xla", "second_order", 50_000),
    ("block", "second_order", 10_000)])
def test_reconstruct_legs_converge_extreme_c(engine, selection, every):
    x, y = _stress()
    kw = dict(STRESS_KW, engine=engine, selection=selection,
              compensated=True, reconstruct_every=every)
    cfg = SVMConfig(**kw)
    res = solve(x, y, cfg, device="cpu")
    assert res.converged
    assert res.stats["reconstructions"] >= 1
    assert res.stats["true_gap"] <= 2 * cfg.epsilon + 1e-9
    # Certify independently: the reported extrema match an exact float64
    # reconstruction of the returned alpha.
    f64 = _true_f(x, y, res.alpha, cfg)
    bh, bl = extrema_np(f64, res.alpha, y, cfg.c_bounds())
    assert bl - bh <= 2 * cfg.epsilon + 1e-6
    assert res.b == pytest.approx((bh + bl) / 2.0, abs=1e-4)
    if engine == "block":
        assert res.stats["hybrid_switch_pairs"] is not None
    # The JAX package's certified solve of the same problem decides the
    # same rows alike.
    from dpsvm_tpu.solver.smo import solve as jsolve

    jres = jsolve(x, y, JaxConfig(**kw))
    assert jres.converged
    dec = f64 + y - res.b
    jdec = _true_f(x, y, jres.alpha, cfg) + y - jres.b
    assert np.mean(np.sign(dec) == np.sign(jdec)) >= 0.99
    assert res.b == pytest.approx(jres.b, abs=0.05)


@pytest.mark.parametrize("kind,degree,coef0", [
    ("rbf", 3, 0.0), ("linear", 3, 0.0), ("poly", 2, 1.0),
    ("sigmoid", 3, 0.5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matvec_f64_matches_jax(kind, degree, coef0, dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(96, 5)).astype(np.float32)
    coef = rng.normal(size=96)
    coef[rng.random(96) < 0.4] = 0.0
    got = trec.gram_matvec_f64(x, coef, KernelParams(kind, 0.3, degree,
                                                     coef0), dtype)
    want = jrec.gram_matvec_f64(x, coef, JaxKP(kind, 0.3, degree, coef0),
                                dtype)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    q = rng.normal(size=(17, 5))
    got_q = trec.gram_matvec_f64(x, coef, KernelParams(kind, 0.3, degree,
                                                       coef0), dtype,
                                 queries=q)
    want_q = jrec.gram_matvec_f64(x, coef, JaxKP(kind, 0.3, degree, coef0),
                                  dtype, queries=q)
    np.testing.assert_allclose(got_q, want_q, rtol=1e-12, atol=0)


def test_gram_matvec_f64_precomputed_refuses():
    with pytest.raises(ValueError, match="precomputed"):
        trec.gram_matvec_f64(np.eye(4, dtype=np.float32), np.ones(4),
                             KernelParams("precomputed"),
                             queries=np.ones((2, 4)))


def test_linear_term_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(30, 4)).astype(np.float32)
    y64 = np.where(rng.random(30) < 0.5, 1.0, -1.0)
    a0 = np.abs(rng.normal(size=30)).astype(np.float32)
    f0 = rng.normal(size=30).astype(np.float32)
    args = (x, y64, a0, f0)
    np.testing.assert_allclose(
        trec._linear_term(*args, KernelParams("rbf", 0.2), "float32"),
        jrec._linear_term(*args, JaxKP("rbf", 0.2), "float32"),
        rtol=1e-12)
    np.testing.assert_array_equal(
        trec._linear_term(x, y64, None, None, KernelParams("rbf", 0.2),
                          "float32"), -y64)


def test_reconstruct_svr_linear_term():
    """The SVR reduction supplies f_init != -y; the legs must recover its
    linear term instead of assuming the C-SVC one."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(240, 6)).astype(np.float32)
    z = (np.sin(x[:, 0]) + 0.1 * rng.normal(size=240)).astype(np.float32)
    cfg = SVMConfig(c=10.0, gamma=0.5, epsilon=1e-3, max_iter=200_000)
    m0, r0 = train_svr(x, z, cfg, svr_epsilon=0.1, device="cpu")
    m1, r1 = train_svr(x, z, cfg.replace(compensated=True,
                                         reconstruct_every=30_000),
                       svr_epsilon=0.1, device="cpu")
    assert r0.converged and r1.converged
    assert r1.stats["reconstructions"] >= 1
    np.testing.assert_allclose(m1.predict(x, device="cpu"),
                               m0.predict(x, device="cpu"), atol=5e-3)


def test_reconstruct_checkpoint_resume(tmp_path):
    """Leg checkpoints restart from certified (reconstructed) state; the
    port's leg file resumes in the JAX package too."""
    from dpsvm_tpu.solver.smo import solve as jsolve

    x, y = _stress(n=320)
    ck = str(tmp_path / "legs.npz")
    kw = dict(STRESS_KW, compensated=True, reconstruct_every=40_000,
              checkpoint_every=1)
    cfg = SVMConfig(**kw)
    res = solve(x, y, cfg, device="cpu", checkpoint_path=ck)
    assert res.converged
    res2 = solve(x, y, cfg, device="cpu", checkpoint_path=ck, resume=True)
    assert res2.converged
    assert res2.iterations - res.iterations < cfg.reconstruct_every
    np.testing.assert_allclose(res2.alpha, res.alpha, atol=2e-2)
    jres = jsolve(x, y, JaxConfig(**kw), checkpoint_path=ck, resume=True)
    assert jres.converged
    assert jres.iterations - res.iterations < cfg.reconstruct_every


def test_legs_callback_is_cumulative_and_aborts(tmp_path):
    x, y = _stress(n=320)
    cfg = STRESS.replace(compensated=True, reconstruct_every=4_096,
                         chunk_iters=1024)
    seen = []
    res = solve(x, y, cfg, device="cpu",
                callback=lambda it, *_: seen.append(it) or it >= 5000)
    assert seen == sorted(seen) and seen[-1] >= 5000
    assert res.iterations == seen[-1] and res.stats["legs"] >= 2


@pytest.mark.parametrize("c,n,d,budget", [
    (2048.0, 50_000, 54, 4 * 50_000 ** 2),
    (2048.0, 50_000, 54, 4 * 50_000 ** 2 - 1),
    (10.0, 500_000, 54, 10 ** 13), (2048.0, 4_000, 2, 10 ** 13),
])
def test_upfront_gate_matches_jax(c, n, d, budget):
    kw = dict(c=c, engine="block", reconstruct_every=1000)
    assert trec.block_tail_doomed(SVMConfig(**kw), n, d,
                                  gram_budget_bytes=budget) == \
        jrec.block_tail_doomed(JaxConfig(**kw), n, d,
                               gram_budget_bytes=budget)


def test_upfront_gate_on_the_cpu_is_off():
    """The CPU has no resident-Gram budget, so the gate never fires."""
    cfg = SVMConfig(c=1e6, engine="block", reconstruct_every=1000)
    assert not trec.block_tail_doomed(cfg, 50_000, 2, device="cpu")


def test_mesh_refuses_legs():
    """Reconstruction legs around the mesh solve, which the port once
    refused: certified (the float64 gap within 2 eps, the legs counted)
    and at the single device's legs' optimum, on the 64-row stress."""
    from dpsvm_tpu_torch import Mesh, solve_mesh

    x, y = _stress(n=64)
    cfg = STRESS.replace(engine="block", compensated=True,
                         reconstruct_every=1000)
    rm = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2))
    r1 = solve(x, y, cfg, device="cpu")
    assert rm.converged and r1.converged
    assert rm.stats["true_gap"] <= 2 * cfg.epsilon
    assert rm.stats["legs"] >= 1
    assert abs(rm.b - r1.b) <= 5e-3 * max(1.0, abs(r1.b))
    assert abs(rm.n_sv - r1.n_sv) <= max(1, 0.02 * r1.n_sv)
