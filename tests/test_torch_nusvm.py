"""The port's nu-SVC and nu-SVR trainers (dpsvm_tpu_torch/models/nusvm.py)
against the JAX package's on the same seeded inputs, on the block engine
and on engine="xla": dual objective within rel 1e-4, SV count within 2%,
b / r / rho / tube width within 5e-3; the warm start's gradient within
rtol 1e-6; the refusals and the fallback warning with JAX's text."""

import warnings

import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models import nusvm as jnusvm
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.ops.kernels import blocked_kernel_matvec as jax_matvec
from dpsvm_tpu_torch import SVMConfig, train_nusvc, train_nusvr
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.models import nusvm as tnusvm
from dpsvm_tpu_torch.ops.kernels import KernelParams, blocked_kernel_matvec

ENGINES = [dict(engine="block", working_set_size=32), dict(engine="xla")]
ENGINE_IDS = ["block", "xla"]


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_binary(n=160, d=6, seed=3, sep=1.2)


@pytest.fixture(scope="module")
def regression():
    x, _ = make_blobs_binary(n=100, d=4, seed=8, sep=0.5)
    z = (np.sin(1.5 * x[:, 0]) + 0.3 * x[:, 1]).astype(np.float32)
    return x, z


def _objective(res, y, p=None):
    """1/2 a^T Q a + p^T a from (alpha, f = y * (Q a + p))."""
    a = res.alpha.astype(np.float64)
    qa_p = y * res.stats["f"].astype(np.float64)
    p = np.zeros_like(a) if p is None else np.asarray(p, np.float64)
    return float(0.5 * a @ (qa_p - p) + p @ a)


@pytest.mark.parametrize("kw", ENGINES, ids=ENGINE_IDS)
def test_nusvc_matches_jax(blobs, kw):
    x, y = blobs
    cfg = dict(gamma=0.2, **kw)
    mt, rt = train_nusvc(x, y, nu=0.3, config=SVMConfig(**cfg), device="cpu")
    mj, rj = jnusvm.train_nusvc(x, y, nu=0.3, config=JaxConfig(**cfg),
                                backend="single")
    assert rt.converged and rj.converged
    # The solver's objective: the returned (alpha, f) are rescaled by
    # 1/r, so the objective they give is the solver's over r^2.
    obj_t, obj_j = (_objective(r, y) * r.stats["nu_r"] ** 2
                    for r in (rt, rj))
    assert abs(obj_t - obj_j) <= 1e-4 * abs(obj_j)
    assert abs(rt.n_sv - rj.n_sv) <= max(1, 0.02 * rj.n_sv)
    for key in ("nu_r", "nu_rho"):
        assert abs(rt.stats[key] - rj.stats[key]) <= 5e-3
    assert abs(mt.b - mj.b) <= 5e-3 and abs(rt.b - mj.b) <= 5e-3
    # The model is the rescaled dense solution, as in the JAX package.
    np.testing.assert_array_equal(mt.sv_alpha, rt.alpha[rt.alpha > 0])
    assert mt.n_sv == rt.n_sv
    # nu bounds the SV fraction from below.
    assert rt.n_sv >= 0.3 * len(y) - 1


@pytest.mark.parametrize("kw", ENGINES, ids=ENGINE_IDS)
def test_nusvr_matches_jax(regression, kw):
    x, z = regression
    cfg = dict(c=1.0, gamma=0.3, **kw)
    mt, rt = train_nusvr(x, z, nu=0.4, config=SVMConfig(**cfg),
                         device="cpu")
    mj, rj = jnusvm.train_nusvr(x, z, nu=0.4, config=JaxConfig(**cfg),
                                backend="single")
    assert rt.converged and rj.converged
    y2 = np.concatenate([np.ones(len(z)), -np.ones(len(z))])
    p = np.concatenate([-z, z])
    assert abs(_objective(rt, y2, p) - _objective(rj, y2, p)) <= \
        1e-4 * abs(_objective(rj, y2, p))
    assert abs(mt.n_sv - mj.n_sv) <= max(1, 0.02 * mj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3
    assert abs(rt.stats["nu_tube_eps"] - rj.stats["nu_tube_eps"]) <= 5e-3
    # sum(a) - sum(a*) = 0 is kept; sum(a + a*) = C n nu.
    a = rt.alpha.astype(np.float64)
    n = len(z)
    assert abs(a[:n].sum() - a[n:].sum()) <= 1e-4 * n
    assert abs(a.sum() - 1.0 * n * 0.4) <= 1e-3 * n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rbf", "linear", "poly"])
def test_warm_start_gradient_matches_jax(blobs, kind, dtype):
    """blocked_kernel_matvec, the nu-SVC / one-class start gradient, on
    the stored (bf16-rounded under bfloat16) rows, in blocks smaller than
    n: within rtol 1e-6 of the JAX package's for rbf; for linear and
    poly, whose sums cancel, within 1e-6 of the sum of |K| |coef| (the
    two packages' float32 matmuls sum in different orders)."""
    x, y = blobs
    alpha0 = np.zeros(len(y), np.float32)
    for idx in (np.nonzero(y > 0)[0], np.nonzero(y < 0)[0]):
        alpha0[idx] = tnusvm._capped_fill(len(idx), 30.5, 1.0)
    coef = alpha0 * y
    kp = dict(kind=kind, gamma=0.2, degree=2, coef0=1.0)
    ft = blocked_kernel_matvec(x, coef, KernelParams(**kp), dtype,
                               block=64, device="cpu")
    fj = jax_matvec(x, coef, JaxKP(**kp), dtype, block=64)
    assert ft.dtype == np.float32 and ft.shape == (len(y),)
    if kind == "rbf":
        np.testing.assert_allclose(ft, fj, rtol=1e-6, atol=1e-6)
    else:
        xs = torch.as_tensor(x).to(getattr(torch, dtype)).double().numpy()
        k_abs = np.abs(xs @ xs.T)
        if kind == "poly":
            k_abs = (0.2 * k_abs + 1.0) ** 2
        assert np.all(np.abs(ft - fj)
                      <= 1e-6 * (k_abs @ np.abs(coef)) + 1e-6)
    assert not np.any(blocked_kernel_matvec(x, 0 * coef, KernelParams(**kp),
                                            device="cpu"))


def test_capped_fill_and_rho_r_are_jaxs():
    for count, total, cap in ((10, 3.5, 1.0), (7, 0.0, 2.0), (5, 9.0, 1.0),
                              (4, 2.25, 0.5)):
        np.testing.assert_array_equal(tnusvm._capped_fill(count, total, cap),
                                      jnusvm._capped_fill(count, total, cap))
    rng = np.random.default_rng(2)
    y = np.where(rng.random(50) < 0.5, 1.0, -1.0)
    f = rng.normal(size=50)
    for alpha in (rng.choice([0.0, 1.0, 0.4], size=50),
                  rng.choice([0.0, 1.0], size=50)):
        assert tnusvm._rho_r(f, alpha, y, 1.0) == \
            jnusvm._rho_r(f, alpha, y, 1.0)


@pytest.mark.parametrize("nu,match", [(0.99, "infeasible"),
                                      (0.0, r"\(0, 1\]"), (1.5, r"\(0, 1\]")])
def test_nusvc_refusals_raise_like_jax(blobs, nu, match):
    x, y = blobs
    with pytest.raises(ValueError, match=match) as ej:
        jnusvm.train_nusvc(x, y, nu=nu, backend="single")
    with pytest.raises(ValueError, match=match) as et:
        train_nusvc(x, y, nu=nu, device="cpu")
    assert str(et.value) == str(ej.value)


def test_nusvc_infeasible_on_unbalanced_classes():
    x, y = make_blobs_binary(n=100, d=3, seed=1)
    y = np.where(np.arange(100) < 10, 1, -1).astype(np.int32)
    for nu in (0.21, 0.5):
        with pytest.raises(ValueError, match="infeasible"):
            jnusvm.train_nusvc(x, y, nu=nu, backend="single")
        with pytest.raises(ValueError, match="infeasible"):
            train_nusvc(x, y, nu=nu, device="cpu")
    with pytest.raises(ValueError, match="both classes"):
        train_nusvc(x, np.ones(100, np.int32), nu=0.1, device="cpu")


@pytest.mark.parametrize("trainer", ["nusvc", "nusvr"])
def test_pallas_and_precomputed_refused_like_jax(blobs, trainer):
    x, y = blobs
    z = y.astype(np.float32)
    for kw in (dict(engine="pallas"), dict(kernel="precomputed")):
        jcfg, tcfg = JaxConfig(**kw), SVMConfig(**kw)
        if trainer == "nusvc":
            calls = (lambda: jnusvm.train_nusvc(x, y, 0.2, jcfg,
                                                backend="single"),
                     lambda: train_nusvc(x, y, 0.2, tcfg, device="cpu"))
        else:
            calls = (lambda: jnusvm.train_nusvr(x, z, 0.2, config=jcfg,
                                                backend="single"),
                     lambda: train_nusvr(x, z, 0.2, config=tcfg,
                                         device="cpu"))
        msgs = []
        for call in calls:
            with pytest.raises(ValueError) as e:
                call()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _captured(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in rec
            if "falls back" in str(w.message)]


@pytest.mark.parametrize("kw", [
    dict(engine="block", fused_round=True),
    dict(engine="block", fused_fold=True, pair_batch=2),
    dict(engine="block", ring_exchange=True, local_working_sets=4),
    dict(engine="block", ooc=True),
    dict(engine="xla", pair_batch=4),
    dict(engine="block")])
def test_fallback_warning_has_jaxs_text(kw):
    msgs = [_captured(lambda: mod._warn_nu_fallbacks(cfg, "train_nusvc"))
            for mod, cfg in ((jnusvm, JaxConfig(**kw)),
                             (tnusvm, SVMConfig(**kw)))]
    assert msgs[0] == msgs[1]
    assert len(msgs[1]) == (0 if kw == dict(engine="block") else 1)


def test_fused_round_request_runs_the_plain_round_and_warns(blobs):
    """The trainer names the fallback and the solve runs the plain
    round (a fused engine would pair mvp candidates across classes)."""
    x, y = blobs
    cfg = SVMConfig(gamma=0.2, engine="block", working_set_size=16,
                    fused_round=True)
    with pytest.warns(UserWarning, match="fused_round"):
        _, res = train_nusvc(x, y, nu=0.3, config=cfg, device="cpu")
    assert res.converged
    assert not (res.stats["fused_round"] or res.stats["fused_fold"]
                or res.stats["pipelined"])
    assert res.stats["n_pad"] == len(y)


def test_compensated_rho_reads_the_effective_gradient(blobs):
    """With the Kahan carry the returned f is f - err, so r and rho
    agree with the uncompensated run to the tolerance."""
    x, y = blobs
    base = dict(gamma=0.2, engine="block", working_set_size=32)
    _, r0 = train_nusvc(x, y, nu=0.3, config=SVMConfig(**base),
                        device="cpu")
    _, r1 = train_nusvc(x, y, nu=0.3,
                        config=SVMConfig(**base, compensated=True),
                        device="cpu")
    assert abs(r0.stats["nu_r"] - r1.stats["nu_r"]) <= 5e-3
    assert abs(r0.b - r1.b) <= 5e-3


def test_mesh_refuses_nu_naming_the_roadmap_item(blobs):
    """The nu duals on the mesh, which the port once refused (the JAX
    package's tests/test_nusvm.py:73-140): warm starts and the nu rule
    run there, and train_nusvc on Mesh(["cpu"] * 2), block and per-pair,
    meets the whole-solve contract against the JAX package's mesh run;
    backend="auto" with a mesh given takes it, as the JAX package's auto
    takes the mesh for the families."""
    from dpsvm_tpu_torch import Mesh, solve_mesh

    x, y = blobs
    alpha0 = np.full(len(y), 0.1, np.float32)
    mesh = Mesh(["cpu"] * 2)
    cfg = SVMConfig(engine="block", working_set_size=16)
    for kw in (dict(alpha_init=alpha0), dict(f_init=-y.astype(np.float32))):
        assert solve_mesh(x, y, cfg, mesh=mesh, **kw).stats[
            "mesh_devices"] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="internal to the nu duals"):
        solve_mesh(x, y, cfg.replace(selection="nu"), mesh=mesh)
    for engine in ("block", "xla"):
        c = cfg.replace(engine=engine)
        mj, rj = jnusvm.train_nusvc(x, y, nu=0.3, config=JaxConfig(
            engine=engine, working_set_size=16), backend="mesh",
            num_devices=2)
        mt, rt = train_nusvc(x, y, nu=0.3, config=c, backend="mesh",
                             mesh=mesh)
        assert rt.converged and rj.converged
        assert rt.stats["mesh_devices"] == ["cpu", "cpu"]
        assert abs(mt.n_sv - mj.n_sv) <= max(2, 0.02 * mj.n_sv)
        assert abs(mt.b - mj.b) <= 5e-3
        assert abs(rt.stats["nu_r"] - rj.stats["nu_r"]) <= 5e-3
    _, res = train_nusvc(x, y, nu=0.3, config=cfg, device="cpu",
                         mesh=mesh)
    assert res.converged and res.stats["mesh_devices"] == ["cpu", "cpu"]


def test_trainers_default_to_the_card(blobs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = blobs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_nusvc(x, y, nu=0.3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_nusvr(x, y.astype(np.float32), nu=0.3)
