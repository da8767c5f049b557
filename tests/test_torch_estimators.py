"""The port's sklearn facade (dpsvm_tpu_torch/estimators.py) against the
JAX package's on the same seeded data: each estimator's predictions
within the whole-solve contract (labels agree, regression values within
5e-3), get_params keys (JAX's, plus the port's ``device``), the
precomputed SVC, svc_c_sweep through the fleet (and warm=True, the
ascending-C walk), and the fallback base classes with scikit-learn
hidden."""

import importlib.util
import sys

import numpy as np
import pytest

import dpsvm_tpu.estimators as jest
import dpsvm_tpu_torch.estimators as port_est
from dpsvm_tpu_torch.data.synth import make_blobs_binary


@pytest.fixture(scope="module")
def data():
    """Binary blobs, three balanced classes (so every OvO split and every
    fold has one shape, and the JAX side compiles once), a smooth
    regression target."""
    xb, yb = make_blobs_binary(n=90, d=5, seed=2, sep=1.0)
    rng = np.random.default_rng(4)
    ym = np.arange(90) % 3
    xm = (rng.normal(0.0, 1.2, (3, 5))[ym]
          + rng.normal(size=(90, 5))).astype(np.float32)
    z = (np.sin(xb[:, 0]) + 0.3 * xb[:, 1]).astype(np.float32)
    return xb, yb, xm, ym, z


CLASSES = ["SVC", "NuSVC", "SVR", "NuSVR", "OneClassSVM"]

CASES = [
    ("SVC", dict(C=2.0, gamma=0.2), "binary"),
    ("SVC", dict(C=2.0, gamma=0.1, strategy="ovo"), "multi"),
    ("SVC", dict(C=2.0, gamma=0.1, engine="block", working_set_size=16,
                 class_weight="balanced"), "binary"),
    ("NuSVC", dict(nu=0.3, gamma=0.2), "binary"),
    ("NuSVC", dict(nu=0.3, gamma=0.1), "multi"),
    ("SVR", dict(C=1.0, gamma=0.2, epsilon=0.1), "reg"),
    ("NuSVR", dict(nu=0.4, gamma=0.2), "reg"),
    ("OneClassSVM", dict(nu=0.2, gamma=0.2, engine="block",
                         working_set_size=16), "oneclass"),
]


@pytest.mark.parametrize("name,kw,kind", CASES,
                         ids=[f"{c[0]}-{c[2]}-{i}"
                              for i, c in enumerate(CASES)])
def test_estimators_match_jax(data, name, kw, kind):
    xb, yb, xm, ym, z = data
    x, target = {"binary": (xb, yb), "multi": (xm, ym), "reg": (xb, z),
                 "oneclass": (xb, None)}[kind]
    kw = dict(kw, tol=1e-4)
    et = getattr(port_est, name)(device="cpu", **kw).fit(x, target)
    ej = getattr(jest, name)(**kw).fit(x, target)
    pt, pj = et.predict(x), ej.predict(x)
    if kind == "reg":
        np.testing.assert_allclose(pt, pj, rtol=0, atol=5e-3)
        assert abs(et.score(x, target) - ej.score(x, target)) <= 1e-3
    elif kind == "oneclass":
        # The free SVs sit on the boundary (|g| <= tol): held by value,
        # and by sign off it.
        dt, dj = et.decision_function(x), ej.decision_function(x)
        np.testing.assert_allclose(dt, dj, rtol=0, atol=5e-3)
        off = np.abs(dj) > 1e-3
        np.testing.assert_array_equal(pt[off], pj[off])
        assert abs(et.offset_ - ej.offset_) <= 5e-3
    else:
        assert np.mean(pt == pj) >= 0.98
        if True:
            np.testing.assert_array_equal(et.classes_, ej.classes_)
            assert abs(et.score(x, target) - ej.score(x, target)) <= 0.02
    if kind == "binary" and name == "SVC":
        np.testing.assert_array_equal(et.n_support_.sum(),
                                      et.fit_result_.n_sv)


def test_probability_matches_jax(data):
    xb, yb, xm, ym, _ = data
    for x, y in ((xb, yb), (xm, ym)):
        kw = dict(C=2.0, gamma=0.1, probability=True, engine="block",
                  working_set_size=16, tol=1e-4)
        pt = port_est.SVC(device="cpu", **kw).fit(x, y).predict_proba(x)
        pj = jest.SVC(**kw).fit(x, y).predict_proba(x)
        np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=0, atol=1e-12)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=0.02)
    assert not hasattr(port_est.SVC(device="cpu").fit(xb, yb), "predict_proba")


@pytest.mark.parametrize("name", CLASSES)
def test_get_params_are_jaxs_and_device(name):
    port = getattr(port_est, name)().get_params()
    jax = getattr(jest, name)().get_params()
    assert set(port) == set(jax) | {"device"}
    assert port["device"] is None
    assert {k: port[k] for k in jax} == jax


def test_precomputed_svc_matches_jax(data):
    xb, yb, *_ = data
    x64 = xb.astype(np.float64)
    sq = (x64 ** 2).sum(1)
    g = np.exp(-0.2 * np.maximum(sq[:, None] + sq[None] - 2 * x64 @ x64.T,
                                 0.0)).astype(np.float32)
    kw = dict(C=2.0, kernel="precomputed", tol=1e-4)
    et = port_est.SVC(device="cpu", **kw).fit(g, yb)
    ej = jest.SVC(**kw).fit(g, yb)
    np.testing.assert_allclose(et.decision_function(g),
                               ej.decision_function(g), atol=5e-3)
    assert abs(len(et.support_) - len(ej.support_)) <= max(
        1, 0.02 * len(ej.support_))
    with pytest.raises(ValueError, match="features|columns"):
        et.decision_function(g[:, :10])
    for bad in (dict(probability=True), dict(backend="mesh")):
        with pytest.raises(ValueError):
            port_est.SVC(device="cpu", **kw, **bad).fit(g, yb)


def test_svc_c_sweep_matches_jax(data):
    xb, yb, *_ = data
    cs = [0.5, 2.0, 8.0]
    kw = dict(gamma=0.2, tol=1e-4, backend="single")
    port = port_est.svc_c_sweep(xb, yb, cs, device="cpu", **kw)
    jax = jest.svc_c_sweep(xb, yb, cs, **kw)
    for a, b in zip(port, jax):
        assert a.C == b.C and a.fit_result_.converged
        assert abs(a.fit_result_.n_sv - b.fit_result_.n_sv) <= max(
            1, 0.02 * b.fit_result_.n_sv)
        assert abs(a.fit_result_.b - b.fit_result_.b) <= 5e-3
        assert np.mean(a.predict(xb) == b.predict(xb)) >= 0.98
    fleet = port[0].fit_result_.stats["fleet"]
    assert fleet["size"] == 3 and fleet["bucket"] == 4
    # warm=True (item 8, ported): the ascending-C walk reaches the same
    # models as the fleet's cold sweep.
    warm = port_est.svc_c_sweep(xb, yb, cs, warm=True, device="cpu", **kw)
    for a, b in zip(warm, jax):
        assert a.C == b.C and a.fit_result_.converged
        assert abs(a.fit_result_.n_sv - b.fit_result_.n_sv) <= max(
            1, 0.02 * b.fit_result_.n_sv)
        assert np.mean(a.predict(xb) == b.predict(xb)) >= 0.98
    with pytest.raises(ValueError, match="fleet executor"):
        port_est.svc_c_sweep(xb, yb, cs, engine="block", device="cpu", **kw)


def test_fallback_without_sklearn(data, monkeypatch):
    """With scikit-learn hidden the module imports plain base classes:
    get_params / set_params as the JAX fallback's, a clone rebuilt from
    get_params, and fit / predict / score that run."""
    xb, yb, xm, ym, z = data
    for key in [k for k in sys.modules if k == "sklearn"
                or k.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, key, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    spec = importlib.util.spec_from_file_location(
        "estimators_without_sklearn", port_est.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.BaseEstimator.__module__ == "estimators_without_sklearn"
    est = mod.SVC(C=2.0, gamma=0.2, device="cpu")
    params = est.get_params()
    assert params["C"] == 2.0 and params["device"] == "cpu"
    twin = type(est)(**params)
    assert twin.get_params() == params
    assert est.set_params(C=3.0) is est and est.C == 3.0
    assert est.fit(xb, yb).score(xb, yb) > 0.7
    assert mod.SVC(gamma=0.1, device="cpu").fit(xm, ym).predict(
        xm).shape == ym.shape
    assert mod.SVR(gamma=0.2, device="cpu").fit(xb, z).score(xb, z) > 0.5
