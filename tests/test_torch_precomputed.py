"""Precomputed kernels in the port (kernel="precomputed", LibSVM -t 4;
gram_resident=True on the block engine; the cross-solve memos) against
the JAX package on the same seeded Gram: whole solves within the
contract (dual rel 1e-4, SV count 2%, |db| 5e-3), the refusals with
JAX's exception types and key phrases, PrecomputedSVCModel files read by
both packages, the mesh's symmetric column gathers, and the memos' reuse
(counted) and device keys."""

import numpy as np
import pytest
import torch

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models.precomputed import PrecomputedSVCModel as JaxPre
from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
from dpsvm_tpu.solver.reconstruct import gram_matvec_f64 as jax_matvec
from dpsvm_tpu.solver.smo import solve as jsolve
from dpsvm_tpu.train import train as jax_train
from dpsvm_tpu_torch import Mesh, SVMConfig, solve, solve_mesh, train
from dpsvm_tpu_torch.convert import precomputed_model_from_reference
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.models.multiclass import train_multiclass
from dpsvm_tpu_torch.models.precomputed import PrecomputedSVCModel
from dpsvm_tpu_torch.ops.kernels import KernelParams
from dpsvm_tpu_torch.solver import solve as tsolve
from dpsvm_tpu_torch.solver.block import gram_block
from dpsvm_tpu_torch.solver.reconstruct import gram_matvec_f64

GAMMA = 0.2


def _gram(x, gamma=GAMMA):
    x64 = x.astype(np.float64)
    sq = (x64 ** 2).sum(1)
    return np.exp(-gamma * np.maximum(
        sq[:, None] + sq[None, :] - 2.0 * x64 @ x64.T, 0.0)).astype(
            np.float32)


@pytest.fixture(scope="module")
def blobs():
    x, y = make_blobs_binary(n=160, d=6, seed=3, sep=1.2)
    return x, y, _gram(x)


def _dual(res, y):
    a = res.alpha.astype(np.float64)
    yf = y.astype(np.float64)
    return float(a.sum() - 0.5 * np.sum(a * yf * (res.stats["f"] + yf)))


def _contract(rt, rj, y):
    assert rt.converged and rj.converged
    dj = _dual(rj, y)
    assert abs(_dual(rt, y) - dj) <= 1e-4 * abs(dj)
    assert abs(rt.n_sv - rj.n_sv) <= max(1, 0.02 * rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3


ENGINES = [dict(engine="block", working_set_size=32),
           dict(engine="block", working_set_size=32, pipeline_rounds=True),
           dict(engine="xla")]


@pytest.mark.parametrize("kw", ENGINES, ids=["block", "pipelined", "xla"])
def test_precomputed_solve_matches_jax(blobs, kw):
    x, y, g = blobs
    cfg = dict(c=2.0, kernel="precomputed", **kw)
    rt = solve(g, y, SVMConfig(**cfg), device="cpu")
    rj = jsolve(g, y, JaxConfig(**cfg))
    _contract(rt, rj, y)
    # The fused engines step down to the plain round on a Gram.
    assert not (rt.stats.get("fused_fold") or rt.stats.get("fused_round"))


def test_fused_knobs_step_down_on_a_gram(blobs):
    x, y, g = blobs
    base = SVMConfig(c=2.0, kernel="precomputed", engine="block",
                     working_set_size=16)
    plain = solve(g, y, base, device="cpu")
    fused = solve(g, y, base.replace(fused_fold=True), device="cpu")
    assert not fused.stats["fused_fold"]
    np.testing.assert_array_equal(fused.alpha, plain.alpha)


def test_gram_block_is_a_column_gather(blobs):
    _, _, g = blobs
    gt = torch.as_tensor(g)
    w = torch.tensor([5, 3, 99, 3, 0])
    kb = gram_block(gt[w], None, w, KernelParams("precomputed"))
    np.testing.assert_array_equal(kb.numpy(), g[np.ix_(w.numpy(),
                                                       w.numpy())])


def test_precomputed_matches_the_feature_solve(blobs):
    """The Gram of the rbf kernel trains the rbf problem."""
    x, y, g = blobs
    kw = dict(c=2.0, engine="block", working_set_size=32)
    rp = solve(g, y, SVMConfig(kernel="precomputed", **kw), device="cpu")
    rf = solve(x, y, SVMConfig(gamma=GAMMA, **kw), device="cpu")
    _contract(rp, rf, y)


REFUSALS = [
    ("non-square", lambda g, y, m: m[1](g[:, :50], y, m[0](
        kernel="precomputed")), ValueError, "square (n, n) Gram"),
    ("pad_to", lambda g, y, m: m[1](g, y, m[0](kernel="precomputed"),
                                    pad_to=1024),
     ValueError, "pad_to does not compose with kernel='precomputed'"),
    ("pallas", lambda g, y, m: m[0](kernel="precomputed", engine="pallas"),
     ValueError, "not implemented for the fused pallas per-pair engine"),
    ("cache", lambda g, y, m: m[0](kernel="precomputed", cache_lines=8),
     ValueError, "nothing to cache"),
    ("train", lambda g, y, m: m[2](g, y, m[0](kernel="precomputed")),
     ValueError, "models carry SV indices, not feature rows"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_refusals_match_jax(blobs, case):
    _, y, g = blobs
    _, call, exc, phrase = case
    port = (SVMConfig, lambda *a, **k: solve(*a, device="cpu", **k),
            lambda *a: train(*a, device="cpu"))
    jax = (JaxConfig, jsolve, lambda *a: jax_train(*a, backend="single"))
    with pytest.raises(exc) as et:
        call(g, y, port)
    with pytest.raises(exc) as ej:
        call(g, y, jax)
    assert phrase in str(et.value) and phrase in str(ej.value)


def test_model_files_cross_packages(blobs, tmp_path):
    x, y, g = blobs
    res = solve(g, y, SVMConfig(c=2.0, kernel="precomputed"), device="cpu")
    port = PrecomputedSVCModel.from_solution(y, res.alpha, res.b)
    jax = JaxPre.from_solution(y, res.alpha, res.b)
    q = g[:40]
    np.testing.assert_allclose(port.decision_function(q, device="cpu"),
                               jax.decision_function(q), rtol=1e-12,
                               atol=1e-12)
    port.save(str(tmp_path / "p.npz"))
    jax.save(str(tmp_path / "j.npz"))
    from_port = JaxPre.load(str(tmp_path / "p.npz"))
    from_jax = PrecomputedSVCModel.load(str(tmp_path / "j.npz"))
    for a, b in ((from_port, port), (from_jax, jax)):
        np.testing.assert_array_equal(a.sv_idx, b.sv_idx)
        np.testing.assert_array_equal(a.coef, b.coef)
        # Both packages write b as float32.
        assert (a.b, a.n_train) == (float(np.float32(b.b)), b.n_train)
    np.testing.assert_array_equal(from_jax.predict(q, device="cpu"),
                                  jax.predict(q))
    conv = precomputed_model_from_reference(jax)
    np.testing.assert_array_equal(conv.sv_idx, jax.sv_idx)
    np.testing.assert_allclose(conv.decision_function(q, device="cpu"),
                               jax.decision_function(q), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="width"):
        port.decision_function(g[:, :10], device="cpu")
    with pytest.raises(ValueError, match=".npz"):
        port.save(str(tmp_path / "p.txt"))


def test_gram_resident_block_matches_jax(blobs):
    x, y, _ = blobs
    cfg = dict(c=2.0, gamma=GAMMA, engine="block", working_set_size=32,
               gram_resident=True)
    rt = solve(x, y, SVMConfig(**cfg), device="cpu")
    rj = jsolve(x, y, JaxConfig(**cfg))
    _contract(rt, rj, y)
    plain = solve(x, y, SVMConfig(**{**cfg, "gram_resident": None}),
                  device="cpu")
    _contract(rt, plain, y)


def test_mesh_precomputed_matches_jax(blobs):
    """The mesh's symmetric round: K(W, W) from the owned rows' W columns
    and the fold from the local column gather."""
    _, y, g = blobs
    kw = dict(c=2.0, kernel="precomputed", engine="block",
              working_set_size=32)
    rm = solve_mesh(g, y, SVMConfig(**kw), mesh=Mesh(["cpu"] * 2))
    rj = jax_solve_mesh(g, y, JaxConfig(**kw), num_devices=2)
    _contract(rm, rj, y)
    one = solve(g, y, SVMConfig(**kw), device="cpu")
    _contract(rm, one, y)
    with pytest.raises(ValueError, match="engine='block'"):
        solve_mesh(g, y, SVMConfig(kernel="precomputed"),
                   mesh=Mesh(["cpu"] * 2))


def test_gram_matvec_f64_on_a_gram_matches_jax(blobs):
    _, y, g = blobs
    coef = np.where(np.arange(len(y)) % 3 == 0, 0.5 * y, 0.0)
    kp = KernelParams("precomputed")
    for dtype in ("float32", "bfloat16"):
        np.testing.assert_allclose(
            gram_matvec_f64(g, coef, kp, dtype),
            jax_matvec(g, coef, kp, dtype), rtol=1e-12, atol=1e-12)


def test_memo_uploads_x_once_across_ovr_solves():
    """One-vs-rest trains k problems on one host X: the upload (and on
    the resident Gram, the build) is paid once; an in-place rewrite of X
    rebuilds."""
    x, _ = make_blobs_binary(n=90, d=4, seed=1, sep=1.0)
    y3 = np.arange(90) % 3
    stats = tsolve.MEMO_STATS
    before = dict(stats)
    train_multiclass(x, y3, SVMConfig(gamma=0.3, engine="block",
                                      working_set_size=16),
                     strategy="ovr", device="cpu")
    assert stats["x_uploads"] - before["x_uploads"] == 1
    assert stats["x_hits"] - before["x_hits"] == 2
    before = dict(stats)
    cfg = SVMConfig(gamma=0.3, engine="xla", gram_resident=True)
    train_multiclass(x, y3, cfg, strategy="ovr", use_fleet=False,
                     device="cpu")
    assert stats["gram_builds"] - before["gram_builds"] == 1
    assert stats["gram_hits"] - before["gram_hits"] == 2
    x *= 2.0  # the same object, rewritten in place
    before = dict(stats)
    train_multiclass(x, y3, cfg, strategy="ovr", use_fleet=False,
                     device="cpu")
    assert stats["gram_builds"] - before["gram_builds"] == 1


def test_memo_keys_the_device():
    """A CPU entry never serves another device, and the size-1 memo
    holds one entry."""
    x = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    cpu = torch.device("cpu")
    meta = torch.device("meta")
    a, _ = tsolve.device_x_cached(x, 20, "float32", cpu)
    b, _ = tsolve.device_x_cached(x, 20, "float32", meta)
    assert a.device == cpu and b.device == meta
    assert len(tsolve._XDEV_MEMO) == 1
    uploads = tsolve.MEMO_STATS["x_uploads"]
    c, _ = tsolve.device_x_cached(x, 20, "float32", cpu)
    assert c.device == cpu
    assert tsolve.MEMO_STATS["x_uploads"] == uploads + 1
    d, _ = tsolve.device_x_cached(x, 20, "bfloat16", cpu)
    assert d.dtype == torch.bfloat16
    del x, a, c  # (a CPU upload shares the host buffer)
    assert not tsolve._XDEV_MEMO  # the entry dies with its host array
