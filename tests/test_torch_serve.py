"""The port's PredictServer (dpsvm_tpu_torch/serve.py) against the JAX
package's on the same models and the same seeded numpy queries: f32,
bf16 and int8 unions, the float64 routing, an empty union, an oversized
request, enqueue / flush tickets, the bucket ladder, the sweep and the
exported families; the mesh on 2 and 4 logical CPU shards, bitwise the
single shard for the linear small-integer case.

Tolerances: f32 and bf16 decisions rtol 1e-5, atol 1e-5 (the float32
sums run in another order); float64 columns rtol 1e-12; labels equal."""

import numpy as np
import pytest

from dpsvm_tpu.config import ServeConfig as JaxServeConfig
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models import multiclass as jmc
from dpsvm_tpu.models.svm_model import SVMModel as JaxModel
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu import serve as jserve
from dpsvm_tpu_torch import serve as tserve
from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.convert import (model_from_reference,
                                     multiclass_from_reference)

RTOL = ATOL = 1e-5
CFG = JaxConfig(c=5.0, gamma=0.25, epsilon=1e-3, chunk_iters=256)


@pytest.fixture(scope="module")
def three_class():
    rng = np.random.default_rng(31)
    xs, ys = [], []
    for k in range(3):
        c = np.zeros(5, np.float32)
        c[k] = 2.5
        xs.append(rng.normal(size=(70, 5)).astype(np.float32) * 0.7 + c)
        ys.append(np.full(70, k))
    x, y = np.concatenate(xs), np.concatenate(ys)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


@pytest.fixture(scope="module")
def models(three_class):
    """{strategy: (JAX model, port model)}: the JAX model carried over
    by convert.py, so both servers hold the same union."""
    x, y = three_class
    out = {}
    for strategy in ("ovr", "ovo"):
        m, _ = jmc.train_multiclass(x, y, CFG, strategy=strategy)
        out[strategy] = (m, multiclass_from_reference(m))
    return out


def _queries(n, d, seed=5):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32) + 0.8


def _pair(jm, tm, **kw):
    return (jserve.PredictServer(jm, JaxServeConfig(**kw)),
            tserve.PredictServer(tm, ServeConfig(**kw), device="cpu"))


def _binary(n_sv=40, d=6, coef_scale=1.0, seed=0, kind="rbf"):
    rng = np.random.default_rng(seed)
    return JaxModel(
        sv_x=rng.normal(size=(n_sv, d)).astype(np.float32),
        sv_alpha=(rng.random(n_sv).astype(np.float32) + 0.01) * coef_scale,
        sv_y=np.where(rng.random(n_sv) < 0.5, 1, -1).astype(np.int32),
        b=0.05, kernel=JaxKP(kind, 0.3))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("strategy", ["ovr", "ovo"])
def test_decisions_match_jax(models, strategy, storage):
    jm, tm = models[strategy]
    js, ts = _pair(jm, tm, buckets=(16, 64), union_storage=storage)
    assert ts.union_storage == js.union_storage == storage
    q = _queries(50, 5)
    np.testing.assert_allclose(ts.decision(q), js.decision(q), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ts.predict(q), js.predict(q))
    assert ts.stats["bucket_counts"] == js.stats["bucket_counts"]
    assert ts.stats["padded_rows"] == js.stats["padded_rows"]


def test_f64_routing_matches_jax():
    """A model whose decision_risk crosses AUTO_F64_RISK is served from
    the host float64 path in both packages; float64 queries reach it
    unquantized, through decision() and through the queue."""
    big = _binary(n_sv=600, d=8, coef_scale=6e5, seed=2)
    js, ts = _pair(big, model_from_reference(big), buckets=(32,),
                   warm_start=False)
    assert ts.stats["f64_columns"] == js.stats["f64_columns"] == 1
    q64 = (np.random.default_rng(3).normal(size=(16, 8))
           * (1 + 1e-9)).astype(np.float64)
    np.testing.assert_allclose(ts.decision(q64), js.decision(q64),
                               rtol=1e-12)
    tt, tj = ts.enqueue(q64), js.enqueue(q64)
    np.testing.assert_allclose(ts.flush()[tt], js.flush()[tj], rtol=1e-12)
    _, t32 = _pair(big, model_from_reference(big), buckets=(32,),
                   precision="float32", warm_start=False)
    assert t32.stats["f64_columns"] == 0


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_forced_precision_columns(models, precision):
    jm, tm = models["ovr"]
    js, ts = _pair(jm, tm, buckets=(16,), precision=precision)
    assert len(ts.f64_cols) == len(js.f64_cols)
    q = _queries(20, 5)
    rtol = 1e-12 if precision == "float64" else RTOL
    np.testing.assert_allclose(ts.decision(q), js.decision(q), rtol=rtol,
                               atol=0 if precision == "float64" else ATOL)


def test_empty_union_decides_minus_b():
    kp = JaxKP("rbf", 0.25)
    subs = [JaxModel(sv_x=np.zeros((0, 4), np.float32),
                     sv_alpha=np.zeros((0,), np.float32),
                     sv_y=np.zeros((0,), np.int32), b=b0, kernel=kp)
            for b0 in (0.5, -0.25)]
    jm = jmc.MulticlassSVM(classes=np.arange(2), models=subs,
                           strategy="ovr")
    js, ts = _pair(jm, multiclass_from_reference(jm), buckets=(16,))
    q = np.zeros((3, 4), np.float32)
    np.testing.assert_array_equal(ts.decision(q), js.decision(q))
    assert ts.union_storage == "f32"


def test_oversized_request_loops_the_top_bucket(models):
    jm, tm = models["ovo"]
    js, ts = _pair(jm, tm, buckets=(16, 32))
    q = _queries(100, 5, seed=8)
    np.testing.assert_allclose(ts.decision(q), js.decision(q), rtol=RTOL,
                               atol=ATOL)
    assert ts.stats["bucket_counts"] == js.stats["bucket_counts"] \
        == {16: 1, 32: 3}


def test_enqueue_flush_tickets_match_jax(models):
    jm, tm = models["ovr"]
    js, ts = _pair(jm, tm, buckets=(16, 64), max_pending=64)
    rng = np.random.default_rng(11)
    reqs = [rng.normal(size=(n, 5)).astype(np.float32)
            for n in (3, 9, 40, 30, 1)]  # 40 + 30 crosses max_pending
    for r in reqs:
        assert ts.enqueue(r) == js.enqueue(r)
    assert ts.stats["dispatches"] == js.stats["dispatches"] > 0
    got, want = ts.flush(), js.flush()
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for t in want:
        np.testing.assert_allclose(got[t], want[t], rtol=RTOL, atol=ATOL)
    assert ts.flush() == {} and js.flush() == {}


def test_binary_model_labels_match_jax():
    m = _binary(n_sv=60, d=6, seed=7)
    js, ts = _pair(m, model_from_reference(m), buckets=(64,))
    q = _queries(70, 6)
    np.testing.assert_array_equal(ts.predict(q), js.predict(q))
    assert ts.strategy == js.strategy == "binary"


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_linear_small_integers_bitwise(n_dev):
    """Linear kernel, small-integer SVs, alphas and queries: every sum
    is exact in float32, so the union sharded over n_dev logical CPU
    shards decides bitwise as one shard, and as JAX's mesh."""
    rng = np.random.default_rng(0)
    n, d = 40, 12
    x = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    alpha = rng.integers(0, 4, size=n).astype(np.float32)
    jm = JaxModel.from_dense(x, y, alpha, b=3.0, kernel=JaxKP("linear"))
    tm = model_from_reference(jm)
    q = rng.integers(-4, 5, size=(17, d)).astype(np.float32)
    one = tserve.PredictServer(tm, ServeConfig(buckets=(32,)),
                               device="cpu")
    js, ts = _pair(jm, tm, buckets=(32,), num_devices=n_dev)
    assert ts.mesh.size == n_dev
    np.testing.assert_array_equal(ts.decision(q), one.decision(q))
    np.testing.assert_array_equal(ts.decision(q), js.decision(q))


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_rbf_matches_jax_mesh(models, n_dev, storage):
    jm, tm = models["ovo"]
    js, ts = _pair(jm, tm, buckets=(64,), num_devices=n_dev,
                   union_storage=storage)
    q = _queries(40, 5, seed=9)
    np.testing.assert_allclose(ts.decision(q), js.decision(q), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ts.predict(q), js.predict(q))


def test_bucket_resolution_and_cap_match_jax(models):
    # Both packages resolve buckets=None through a device profile; with
    # none installed each gives the default ladder and the same record
    # (tests/test_torch_autotune.py holds them equal under a profile).
    from dpsvm_tpu.autotune import use_profile as jax_use_profile
    from dpsvm_tpu_torch.autotune import use_profile

    kind = "NVIDIA H100 80GB HBM3"
    with use_profile(None), jax_use_profile(None):
        for buckets in (None, (16, 64)):
            assert tserve.resolve_buckets(ServeConfig(buckets=buckets),
                                          device_kind=kind) == \
                jserve.resolve_buckets(JaxServeConfig(buckets=buckets),
                                       device_kind=kind)
    for s_rows in (1, 100, 65537, 1 << 20, 1 << 29):
        assert tserve.effective_buckets((16, 64, 4096), s_rows) == \
            jserve.effective_buckets((16, 64, 4096), s_rows)
    jm, tm = models["ovr"]
    js, ts = _pair(jm, tm, buckets=(16, 32))
    assert sorted(ts.stats["warm_seconds"]) == [16, 32]
    assert set(ts.snapshot()) == set(js.snapshot())
    assert ts.snapshot()["compiles"] == 0


def test_offered_load_sweep_matches_jax_shape(models):
    jm, tm = models["ovr"]
    js, ts = _pair(jm, tm, buckets=(16, 64))
    rj = jserve.offered_load_sweep(js, [1, 4, 16], 24, group=6)
    rt = tserve.offered_load_sweep(ts, [1, 4, 16], 24, group=6)
    assert set(rt) == set(rj)
    for key in ("requests", "rows", "dispatches", "padded_rows"):
        assert rt[key] == rj[key]
    assert set(rt["bucket_latency"]) == set(rj["bucket_latency"])
    assert set(rt["request_latency"]) == {"p50", "p95", "p99"}


def _families(text):
    return sorted(ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE"))


def test_openmetrics_families_match_jax(models):
    jm, tm = models["ovo"]
    js, ts = _pair(jm, tm, buckets=(16,))
    q = _queries(10, 5)
    for srv in (js, ts):
        srv.decision(q)
        srv.request_seconds.observe(0.001)
    assert _families(ts.render_openmetrics()) == \
        _families(js.render_openmetrics())
    assert "serve_compiles_total{model=\"ovo-3\"} 0" in \
        ts.render_openmetrics()
    assert ts.render_openmetrics().endswith("# EOF\n")


def test_metrics_endpoint_serves_and_closes(models):
    import urllib.request

    _, tm = models["ovr"]
    ts = tserve.PredictServer(tm, ServeConfig(buckets=(16,),
                                              metrics_port=0),
                              device="cpu")
    try:
        with urllib.request.urlopen(ts.exporter.url, timeout=10) as r:
            body = r.read().decode()
        assert "serve_requests_total" in body and body.endswith("# EOF\n")
    finally:
        ts.close()


def test_wrong_width_and_unservable_refused(models):
    _, tm = models["ovr"]
    ts = tserve.PredictServer(tm, ServeConfig(buckets=(16,)),
                              device="cpu")
    with pytest.raises(ValueError, match=r"\(n, 5\)"):
        ts.decision(np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match=r"\(n, 5\)"):
        ts.enqueue(np.zeros((3,), np.float32))
    with pytest.raises(TypeError, match="cannot serve"):
        tserve.PredictServer(object(), device="cpu")
