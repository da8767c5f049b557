"""The host backends against the JAX package's: smo_reference (NumPy) and
smo_native (native/seqsmo.cpp, the port's own copy built into
build/torch_native/), duality_gap, and train(backend="reference" |
"native") with its refusals. Mirrors tests/test_native_seq.py.

Both packages' host engines are the same NumPy operations and the same
C++ compiled with the same flags, so the results are held bit for bit."""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.solver import reference as jref
from dpsvm_tpu_torch import SVMConfig, train
from dpsvm_tpu_torch.models import train_svr
from dpsvm_tpu_torch.solver import reference as tref
from dpsvm_tpu_torch.utils import native

CASES = [
    dict(c=1.0, gamma=0.1),
    dict(c=10.0, gamma=0.05, weight_pos=2.0, weight_neg=0.5),
    dict(c=1.0, gamma=0.05, kernel="linear"),
    dict(c=1.0, gamma=0.05, kernel="poly", degree=2, coef0=1.0),
    dict(c=1.0, gamma=0.05, kernel="sigmoid", coef0=0.5),
]


def _same_result(a, b):
    np.testing.assert_array_equal(a.alpha, b.alpha)
    np.testing.assert_array_equal(a.stats["f"], b.stats["f"])
    assert (a.b, a.b_hi, a.b_lo) == (b.b, b.b_hi, b.b_lo)
    assert (a.iterations, a.converged) == (b.iterations, b.converged)


@pytest.mark.parametrize("kw", CASES)
def test_smo_reference_bitwise_jax(blobs_small, kw):
    x, y = blobs_small
    kw = dict(epsilon=1e-3, max_iter=20_000, **kw)
    _same_result(tref.smo_reference(x, y, SVMConfig(**kw)),
                 jref.smo_reference(x, y, JaxConfig(**kw)))


def test_smo_reference_on_demand_rows_bitwise_jax(blobs_small):
    """Above full_gram_limit the rows are evaluated per pair."""
    x, y = blobs_small
    kw = dict(c=1.0, gamma=0.1, max_iter=400)
    _same_result(tref.smo_reference(x, y, SVMConfig(**kw),
                                    full_gram_limit=10),
                 jref.smo_reference(x, y, JaxConfig(**kw),
                                    full_gram_limit=10))


@pytest.mark.parametrize("kw", CASES)
def test_smo_native_bitwise_jax(blobs_small, kw):
    x, y = blobs_small
    kw = dict(epsilon=1e-3, max_iter=50_000, **kw)
    t = tref.smo_native(x, y, SVMConfig(**kw))
    j = jref.smo_native(x, y, JaxConfig(**kw))
    _same_result(t, j)
    assert t.converged and t.stats["engine"] == "native-seqsmo"


def test_native_decision_bitwise_jax(blobs_small):
    from dpsvm_tpu.utils.native import get_seqsmo as jget

    x, y = blobs_small
    coef = np.random.default_rng(0).normal(size=40).astype(np.float32)
    args = (x[:40], coef, 0.25, x[40:90])
    np.testing.assert_array_equal(
        native.get_seqsmo().decision(*args, gamma=0.1, kernel="rbf"),
        jget().decision(*args, gamma=0.1, kernel="rbf"))


def test_duality_gap_matches_jax(blobs_small):
    x, y = blobs_small
    res = tref.smo_reference(x, y, SVMConfig(c=1.0, gamma=0.1))
    args = (res.alpha, y, res.stats["f"], 1.0, res.b)
    assert tref.duality_gap(*args) == jref.duality_gap(*args)


@pytest.mark.parametrize("backend", ["reference", "native"])
def test_train_host_backend_model_matches_jax(blobs_small, backend):
    from dpsvm_tpu.train import train as jtrain

    x, y = blobs_small
    kw = dict(c=1.0, gamma=0.1, epsilon=1e-3, max_iter=100_000)
    records = []
    model, res = train(x, y, SVMConfig(**kw), backend=backend,
                       callback=lambda *a: records.append(a))
    jmodel, jres = jtrain(x, y, JaxConfig(**kw), backend=backend)
    _same_result(res, jres)
    np.testing.assert_array_equal(model.sv_x, jmodel.sv_x)
    np.testing.assert_array_equal(model.dual_coef, jmodel.dual_coef)
    # One final record, as in the JAX package.
    assert len(records) == 1
    it, bh, bl, st = records[0]
    assert (it, bh, bl) == (res.iterations, res.b_hi, res.b_lo)
    np.testing.assert_array_equal(st.alpha, res.alpha)


@pytest.mark.parametrize("backend", ["reference", "native"])
@pytest.mark.parametrize("kw,match", [
    (dict(selection="second_order"), "fixed host engine"),
    (dict(engine="block"), "fixed host engine"),
    (dict(engine="pallas"), "fixed host engine"),
])
def test_host_backend_refusals_match_jax(blobs_small, backend, kw, match):
    from dpsvm_tpu.train import train as jtrain

    x, y = blobs_small
    with pytest.raises(ValueError, match=match):
        jtrain(x, y, JaxConfig(**kw), backend=backend)
    with pytest.raises(ValueError, match=match):
        train(x, y, SVMConfig(**kw), backend=backend)


@pytest.mark.parametrize("backend", ["reference", "native"])
def test_host_backends_refuse_checkpoints(blobs_small, backend, tmp_path):
    from dpsvm_tpu.train import train as jtrain

    x, y = blobs_small
    p = str(tmp_path / "ck.npz")
    for fn, cfg in ((jtrain, JaxConfig()), (train, SVMConfig())):
        with pytest.raises(ValueError, match="checkpoint/resume"):
            fn(x, y, cfg, backend=backend, checkpoint_path=p)
        with pytest.raises(ValueError, match="checkpoint/resume"):
            fn(x, y, cfg, backend=backend, resume=True)


def test_model_families_refuse_host_backends(blobs_small):
    x, y = blobs_small
    with pytest.raises(ValueError, match="host C-SVC engine"):
        train_svr(x, y.astype(np.float32), SVMConfig(), backend="native")


def test_native_engine_missing_raises(blobs_small, monkeypatch):
    x, y = blobs_small
    monkeypatch.setattr(native, "get_seqsmo", lambda: None)
    with pytest.raises(RuntimeError, match="backend='reference'"):
        tref.smo_native(x, y, SVMConfig())
