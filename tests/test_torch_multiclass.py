"""The port's multiclass reductions (dpsvm_tpu_torch/models/multiclass.py)
against the JAX package's on the same seeded 4-class data: OvR and OvO,
sequential and through the fleet. The JAX models, converted with
convert.py, decide in the port within rtol 1e-5 of JAX's own decision
matrix; the port's training meets the whole-solve contract per submodel
(dual rel 1e-4, SV count 2%, |db| 5e-3); ovo_vote_fold is bitwise;
bundles load across the packages; compact_models holds JAX's SV union
bit for bit."""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models import multiclass as jmc
from dpsvm_tpu_torch import SVMConfig
from dpsvm_tpu_torch.convert import multiclass_from_reference
from dpsvm_tpu_torch.data.synth import make_mnist_multiclass
from dpsvm_tpu_torch.models import multiclass as tmc
from dpsvm_tpu_torch.models.svm_model import SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams

CASES = [("ovr", False), ("ovo", False), ("ovr", True), ("ovo", True)]
IDS = ["ovr-seq", "ovo-seq", "ovr-fleet", "ovo-fleet"]


@pytest.fixture(scope="module")
def data():
    x, y = make_mnist_multiclass(n=200, d=16, seed=1, n_classes=4)
    return x[:160], y[:160], x[160:]


def _cfg(fleet):
    kw = dict(c=2.0, gamma=0.1, epsilon=1e-4)
    return kw if fleet else dict(kw, engine="block", working_set_size=16)


@pytest.fixture(scope="module")
def trained(data):
    x, y, _ = data
    out = {}
    for strategy, fleet in CASES:
        kw = _cfg(fleet)
        out[strategy, fleet] = (
            tmc.train_multiclass(x, y, SVMConfig(**kw), strategy=strategy,
                                 use_fleet=fleet, device="cpu"),
            jmc.train_multiclass(x, y, JaxConfig(**kw), strategy=strategy,
                                 use_fleet=fleet, backend="single"))
    return out


def _dual(res, y):
    a = res.alpha.astype(np.float64)
    yf = y.astype(np.float64)
    return float(a.sum() - 0.5 * np.sum(a * yf * (res.stats["f"] + yf)))


def _labels(y, classes, strategy):
    """Each submodel's +-1 labels over its own rows, in model order."""
    if strategy == "ovr":
        return [np.where(y == c, 1, -1) for c in classes]
    out = []
    for a in range(len(classes)):
        for b in range(a + 1, len(classes)):
            sub = y[(y == classes[a]) | (y == classes[b])]
            out.append(np.where(sub == classes[a], 1, -1))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_training_meets_the_contract(data, trained, case):
    _, y, _ = data
    (mt, rt), (mj, rj) = trained[case]
    np.testing.assert_array_equal(mt.classes, mj.classes)
    assert mt.strategy == mj.strategy and len(rt) == len(rj)
    for a, b, yk in zip(rt, rj, _labels(y, mt.classes, case[0])):
        assert a.converged and b.converged
        dj = _dual(b, yk)
        assert abs(_dual(a, yk) - dj) <= 1e-4 * abs(dj)
        assert abs(a.n_sv - b.n_sv) <= max(1, 0.02 * b.n_sv)
        assert abs(a.b - b.b) <= 5e-3
    if case[1]:
        assert all("fleet" in r.stats for r in rt)
    else:
        assert all("fleet" not in r.stats for r in rt)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_converted_models_decide_like_jax(data, trained, case):
    x, _, xq = data
    _, (mj, _) = trained[case]
    mt = multiclass_from_reference(mj)
    want = jmc.decision_matrix(mj, xq)
    for path in ("compacted", "stacked", "per_model"):
        got = tmc.decision_matrix(mt, xq, path=path, device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tmc.predict_multiclass(mt, xq, device="cpu"),
        jmc.predict_multiclass(mj, xq))


def test_vote_fold_is_jaxs_bitwise():
    rng = np.random.default_rng(0)
    dec = rng.choice([-1.5, -0.0, 0.0, 0.25, 2.0], size=(50, 10))
    np.testing.assert_array_equal(tmc.ovo_vote_fold(dec, 5),
                                  jmc.ovo_vote_fold(dec, 5))


def test_vote_matrix_is_the_fold_of_the_decisions(data, trained):
    _, _, xq = data
    (mt, _), _ = trained["ovo", False]
    np.testing.assert_array_equal(
        tmc.vote_matrix(mt, xq, device="cpu"),
        tmc.ovo_vote_fold(tmc.decision_matrix(mt, xq, device="cpu"),
                          len(mt.classes)))
    (mr, _), _ = trained["ovr", False]
    np.testing.assert_array_equal(tmc.vote_matrix(mr, xq, device="cpu"),
                                  tmc.decision_matrix(mr, xq, device="cpu"))


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_bundles_load_across_packages(data, trained, tmp_path, case):
    _, _, xq = data
    (mt, _), (mj, _) = trained[case]
    mt.save(str(tmp_path / "p.npz"))
    mj.save(str(tmp_path / "j.npz"))
    port_in_jax = jmc.MulticlassSVM.load(str(tmp_path / "p.npz"))
    jax_in_port = tmc.MulticlassSVM.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(
        jmc.predict_multiclass(port_in_jax, xq),
        tmc.predict_multiclass(mt, xq, device="cpu"))
    np.testing.assert_array_equal(
        tmc.predict_multiclass(jax_in_port, xq, device="cpu"),
        jmc.predict_multiclass(mj, xq))
    for name in ("sv_union", "coef", "coef_pad", "idx", "counts", "b"):
        np.testing.assert_array_equal(getattr(jax_in_port.compacted, name),
                                      getattr(mj.compacted, name))


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_compact_models_is_jaxs(data, trained, case):
    x, _, _ = data
    _, (mj, _) = trained[case]
    mt = multiclass_from_reference(mj)
    for x_train in (x, None):
        a = tmc.compact_models(mt.models, x_train=x_train)
        b = jmc.compact_models(mj.models, x_train=x_train)
        assert a.n_union == b.n_union and a.m_pad == b.m_pad
        for name in ("sv_union", "coef", "coef_pad", "idx", "counts", "b"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_precision_auto_takes_float64_for_risky_columns():
    """A submodel whose float32 evaluation is noise by
    decision_risk_columns is evaluated exactly on the host."""
    from dpsvm_tpu_torch.predict import decision_function

    rng = np.random.default_rng(1)
    kp = KernelParams("rbf", 0.5)
    calm = SVMModel(rng.normal(size=(8, 3)).astype(np.float32),
                    np.full(8, 0.5, np.float32), np.array([1, -1] * 4),
                    0.1, kp)
    wild = SVMModel(rng.normal(size=(400, 3)).astype(np.float32),
                    np.full(400, 3e5, np.float32),
                    np.array([1, -1] * 200), 0.2, kp)
    m = tmc.MulticlassSVM(np.array([0, 1]), [calm, wild], "ovr")
    q = rng.normal(size=(30, 3)).astype(np.float32)
    dec = tmc.decision_matrix(m, q, device="cpu")
    np.testing.assert_array_equal(
        dec[:, 1], decision_function(wild, q, precision="float64",
                                     device="cpu"))
    f32 = tmc.decision_matrix(m, q, precision="float32", device="cpu")
    np.testing.assert_array_equal(dec[:, 0], f32[:, 0])


def test_fleet_routing_and_refusals_are_jaxs(data):
    x, y, _ = data
    for kw in (dict(), dict(engine="block"), dict(fleet_size=1),
               dict(budget_mode=True), dict(compensated=True)):
        assert tmc._fleet_eligible(SVMConfig(**kw), "single", None, None) \
            == jmc._fleet_eligible(JaxConfig(**kw), "single", None, None)
    assert not tmc._fleet_eligible(SVMConfig(), "mesh", None, None)
    with pytest.raises(ValueError, match="use_fleet=True"):
        tmc.train_multiclass(x, y, SVMConfig(engine="block"),
                             use_fleet=True, device="cpu")
    with pytest.raises(ValueError, match="binary C-SVC only"):
        tmc.train_multiclass(x, y, SVMConfig(kernel="precomputed"),
                             device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        tmc.train_multiclass(x, y, SVMConfig(engine="block"),
                             strategy="dag", device="cpu")
    # Two classes collapse to one OvO model, as in JAX.
    two = y < 2
    m, res = tmc.train_multiclass(x[two], y[two], SVMConfig(gamma=0.1),
                                  strategy="ovr", device="cpu")
    assert m.strategy == "ovo" and len(m.models) == len(res) == 1
