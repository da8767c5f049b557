"""The port's epsilon-SVR and one-class trainers (dpsvm_tpu_torch/models/
svr.py, oneclass.py) against the JAX package's on the same seeded inputs,
on the block engine and engine="xla" (one-class also on the fused round,
which pads n to 1024 from a warm start): dual objective within rel 1e-4,
SV count within 2%, b / rho within 5e-3. Model files cross between the
packages both ways, and each package's CLI writes models with
-t nu-svc|eps-svr|nu-svr|one-class that the other's test reads and
decides the same on."""

import numpy as np
import pytest

from dpsvm_tpu import cli as jax_cli
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models.oneclass import OneClassModel as JaxOneClass
from dpsvm_tpu.models.oneclass import train_oneclass as jax_oneclass
from dpsvm_tpu.models.svr import SVRModel as JaxSVR
from dpsvm_tpu.models.svr import train_svr as jax_svr
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu_torch import (OneClassModel, SVMConfig, SVRModel, cli,
                             train_oneclass, train_svr)
from dpsvm_tpu_torch.convert import (oneclass_model_from_reference,
                                     svr_model_from_reference)
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops.kernels import KernelParams

ENGINES = [dict(engine="block", working_set_size=32), dict(engine="xla")]
ENGINE_IDS = ["block", "xla"]


@pytest.fixture(scope="module")
def regression():
    x, _ = make_blobs_binary(n=150, d=4, seed=8, sep=0.5)
    z = (np.sin(1.5 * x[:, 0]) + 0.3 * x[:, 1]).astype(np.float32)
    return x, z


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_binary(n=200, d=5, seed=4, sep=1.5)


def _objective(alpha, f, y, p):
    """1/2 a^T Q a + p^T a from (alpha, f = y * (Q a + p))."""
    a = np.asarray(alpha, np.float64)
    qa_p = y * np.asarray(f, np.float64)
    return float(0.5 * a @ (qa_p - p) + p @ a)


@pytest.mark.parametrize("kw", ENGINES, ids=ENGINE_IDS)
def test_svr_matches_jax(regression, kw):
    x, z = regression
    cfg = dict(c=2.0, gamma=0.3, **kw)
    mt, rt = train_svr(x, z, SVMConfig(**cfg), svr_epsilon=0.1,
                       device="cpu")
    mj, rj = jax_svr(x, z, JaxConfig(**cfg), svr_epsilon=0.1,
                     backend="single")
    assert rt.converged and rj.converged
    y2 = np.concatenate([np.ones(len(z)), -np.ones(len(z))])
    p = np.concatenate([0.1 - z, 0.1 + z])
    ot = _objective(rt.alpha, rt.stats["f"], y2, p)
    oj = _objective(rj.alpha, rj.stats["f"], y2, p)
    assert abs(ot - oj) <= 1e-4 * abs(oj)
    assert abs(mt.n_sv - mj.n_sv) <= max(1, 0.02 * mj.n_sv)
    assert abs(mt.b - mj.b) <= 5e-3
    n = len(z)
    a = rt.alpha.astype(np.float64)
    assert abs(a[:n].sum() - a[n:].sum()) <= 1e-4 * 2.0 * n
    pt = mt.predict(x, device="cpu")
    pj = np.asarray(mj.predict(x))
    assert np.max(np.abs(pt - pj)) < 1e-2


def test_svr_ignores_class_weights_and_checks_inputs(regression):
    x, z = regression
    cfg = SVMConfig(c=2.0, gamma=0.3, engine="block", working_set_size=32)
    m0, _ = train_svr(x, z, cfg, device="cpu")
    m1, _ = train_svr(x, z, cfg.replace(weight_pos=3.0, weight_neg=0.5),
                      device="cpu")
    np.testing.assert_array_equal(m0.coef, m1.coef)
    with pytest.raises(ValueError, match="targets must be shape"):
        train_svr(x, z[:-1], cfg, device="cpu")
    with pytest.raises(ValueError, match="svr_epsilon"):
        train_svr(x, z, cfg, svr_epsilon=-0.1, device="cpu")


@pytest.mark.parametrize("kw", ENGINES + [
    dict(engine="block", working_set_size=16, fused_round=True)],
    ids=ENGINE_IDS + ["fused_round"])
def test_oneclass_matches_jax(blobs, kw):
    """Against the JAX package's plain block engine (its own fused round
    on the CPU runs Pallas in interpret mode)."""
    x, _ = blobs
    cfg = dict(gamma=0.3, **kw)
    jkw = {k: v for k, v in cfg.items() if k != "fused_round"}
    mt, rt = train_oneclass(x, nu=0.2, config=SVMConfig(**cfg),
                            device="cpu")
    mj, rj = jax_oneclass(x, nu=0.2, config=JaxConfig(**jkw),
                          backend="single")
    assert rt.converged and rj.converged
    assert rt.stats.get("fused_round", False) == bool(kw.get("fused_round"))
    if kw.get("fused_round"):
        assert rt.stats["n_pad"] == 1024
    ones = np.ones(len(x))
    zero = np.zeros(len(x))
    ot = _objective(rt.alpha, rt.stats["f"], ones, zero)
    oj = _objective(rj.alpha, rj.stats["f"], ones, zero)
    assert abs(ot - oj) <= 1e-4 * abs(oj)
    assert abs(mt.n_sv - mj.n_sv) <= max(1, 0.02 * mj.n_sv)
    assert abs(mt.rho - mj.rho) <= 5e-3
    assert abs(rt.alpha.astype(np.float64).sum() - 0.2 * len(x)) <= 1e-4 * \
        len(x)
    inlier = float(np.mean(mt.predict(x, device="cpu") > 0))
    assert inlier >= 1 - 0.2 - 0.05


def test_oneclass_refusals(blobs):
    x, _ = blobs
    for nu in (0.0, 1.01):
        with pytest.raises(ValueError, match=r"\(0, 1\]"):
            train_oneclass(x, nu=nu, device="cpu")
    with pytest.raises(ValueError, match="precomputed") as et:
        train_oneclass(x, config=SVMConfig(kernel="precomputed"),
                       device="cpu")
    with pytest.raises(ValueError, match="precomputed") as ej:
        jax_oneclass(x, config=JaxConfig(kernel="precomputed"),
                     backend="single")
    assert str(et.value) == str(ej.value)


def _svr_pair():
    rng = np.random.default_rng(1)
    sv = rng.normal(size=(7, 3)).astype(np.float32)
    coef = rng.normal(size=7).astype(np.float32)
    return (SVRModel(sv, coef, 0.25, KernelParams("rbf", 0.5)),
            JaxSVR(sv, coef, 0.25, JaxKP("rbf", 0.5)))


def _oneclass_pair():
    rng = np.random.default_rng(2)
    sv = rng.normal(size=(6, 3)).astype(np.float32)
    coef = rng.random(6).astype(np.float32)
    return (OneClassModel(sv, coef, 0.4, KernelParams("poly", 0.2, 2, 1.0)),
            JaxOneClass(sv, coef, 0.4, JaxKP("poly", 0.2, 2, 1.0)))


@pytest.mark.parametrize("kind", ["svr", "oneclass"])
def test_npz_files_cross_both_ways(tmp_path, kind):
    tm, jm = _svr_pair() if kind == "svr" else _oneclass_pair()
    t_cls, j_cls = (SVRModel, JaxSVR) if kind == "svr" else \
        (OneClassModel, JaxOneClass)
    q = np.random.default_rng(3).normal(size=(20, 3)).astype(np.float32)
    tm.save(str(tmp_path / "t.npz"))
    jm.save(str(tmp_path / "j.npz"))
    from_t = j_cls.load(str(tmp_path / "t.npz"))
    from_j = t_cls.load(str(tmp_path / "j.npz"))
    for a, b in ((from_t, tm), (from_j, jm)):
        np.testing.assert_array_equal(a.sv_x, b.sv_x)
        np.testing.assert_array_equal(a.coef, b.coef)
        assert a.kernel.kind == b.kernel.kind
    pred = "predict" if kind == "svr" else "decision_function"
    dt = getattr(from_j, pred)(q, device="cpu")
    dj = np.asarray(getattr(from_t, pred)(q))
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    # The JAX model carried across in memory decides the same.
    conv = (svr_model_from_reference if kind == "svr"
            else oneclass_model_from_reference)(jm)
    np.testing.assert_allclose(getattr(conv, pred)(q, device="cpu"), dt,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match=".npz"):
        tm.save(str(tmp_path / "t.txt"))
    other = OneClassModel if kind == "svr" else SVRModel
    with pytest.raises(ValueError, match="not a"):
        other.load(str(tmp_path / "t.npz"))


def _csv(path, x, y, fmt):
    with open(path, "w") as fh:
        for xi, yi in zip(x, y):
            fh.write(fmt(yi) + "," + ",".join(repr(float(v)) for v in xi)
                     + "\n")


@pytest.mark.parametrize("svm_type", ["nu-svc", "eps-svr", "nu-svr",
                                      "one-class"])
def test_cli_models_cross_between_the_packages(tmp_path, capsys, svm_type):
    """Train with each package's CLI on the same CSV; each package's test
    reads the other's model and prints the same figure as for its own."""
    x, y = make_blobs_binary(n=80, d=3, seed=6, sep=1.5)
    if svm_type in ("eps-svr", "nu-svr"):
        target = np.sin(x[:, 0]).astype(np.float32)
        _csv(tmp_path / "d.csv", x, target, lambda v: repr(float(v)))
    else:
        _csv(tmp_path / "d.csv", x, y, lambda v: str(int(v)))
    common = ["-f", str(tmp_path / "d.csv"), "-t", svm_type, "--nu", "0.3",
              "-c", "2", "-g", "0.5", "--engine", "block",
              "--working-set-size", "64"]
    paths = {}
    for name, main, extra in (("jax", jax_cli.main, ["--quiet"]),
                              ("port", cli.main, ["--device", "cpu"])):
        paths[name] = str(tmp_path / f"{name}.npz")
        assert main(["train", *common, "-m", paths[name], *extra]) == 0
    capsys.readouterr()
    lines = {}
    for tester, main, extra in (("jax", jax_cli.main, []),
                                ("port", cli.main, ["--device", "cpu"])):
        for writer in ("jax", "port"):
            assert main(["test", "-f", str(tmp_path / "d.csv"), "-m",
                         paths[writer], *extra]) == 0
            out = capsys.readouterr().out
            lines[tester, writer] = [ln for ln in out.splitlines()
                                     if ln.startswith("test ")]
    for writer in ("jax", "port"):
        assert lines["jax", writer] == lines["port", writer]
        assert lines["port", writer]


def test_cli_refusals(tmp_path, capsys):
    x, y = make_blobs_binary(n=40, d=3, seed=6)
    _csv(tmp_path / "d.csv", x, y, lambda v: str(int(v)))
    base = ["train", "-f", str(tmp_path / "d.csv"), "-m",
            str(tmp_path / "m.npz"), "--device", "cpu"]
    assert cli.main(base + ["-t", "nu-svc", "--selection",
                            "second_order"]) == 2
    assert "per-class nu selection" in capsys.readouterr().err
    assert cli.main(base + ["-t", "nu-svr", "--engine", "pallas"]) == 2
    assert "--engine pallas" in capsys.readouterr().err
    _csv(tmp_path / "m3.csv", x, np.arange(40) % 3, lambda v: str(int(v)))
    assert cli.main(["train", "-f", str(tmp_path / "m3.csv"), "-m",
                     str(tmp_path / "m.npz"), "-t", "nu-svc", "--device",
                     "cpu"]) == 2
    # A multiclass file trains plain C-SVC submodels, as in the JAX CLI.
    assert "does not compose with -t nu-svc" in capsys.readouterr().err
