"""The port's int8 serving path against the JAX package's: the int8
helpers of ops/kernels.py bitwise, the union staging bitwise, the
storage guard (same effective storage, risks and notes for every
feature kernel family), the per-row query quantization and the int8
executor's integer dots bitwise, int8 decisions within the f32
tolerance of JAX's int8 server, and mixed-storage groups on the v2
engine across a hot swap."""

import types
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dpsvm_tpu.config import ServeConfig as JaxServeConfig
from dpsvm_tpu.models.svm_model import SVMModel as JaxModel
from dpsvm_tpu.ops import kernels as jk
from dpsvm_tpu import serve as jserve
from dpsvm_tpu_torch import serve as tserve
from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.convert import model_from_reference
from dpsvm_tpu_torch.ops import kernels as tk
from dpsvm_tpu_torch.serving import ServingEngine

KINDS = {
    "linear": ("linear", 1.0, 3, 0.0),
    "rbf": ("rbf", 0.3, 3, 0.0),
    "poly": ("poly", 0.2, 3, 1.0),
    "sigmoid": ("sigmoid", 0.1, 0, 0.25),
}


def _kp(pkg, kind):
    k, g, deg, c0 = KINDS[kind]
    cls = jk.KernelParams if pkg == "jax" else tk.KernelParams
    return cls(k, g, deg, c0)


def _binary(kind, n_sv=60, d=6, coef_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return JaxModel(
        sv_x=rng.normal(size=(n_sv, d)).astype(np.float32),
        sv_alpha=(rng.random(n_sv).astype(np.float32) + 0.01) * coef_scale,
        sv_y=np.where(rng.random(n_sv) < 0.5, 1, -1).astype(np.int32),
        b=0.05, kernel=_kp("jax", kind))


def _rows(seed=11, n=40, d=7):
    rng = np.random.default_rng(seed)
    sv = rng.normal(size=(n, d)).astype(np.float32) * \
        rng.gamma(1.0, 5.0, size=(n, 1)).astype(np.float32)
    sv[3] = 0.0  # an all-zero row: scale 1.0, not 0/0
    return sv


def test_int8_helpers_bitwise():
    sv = _rows()
    q_t, s_t = tk.quantize_rows_int8(sv)
    q_j, s_j = jk.quantize_rows_int8(sv)
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(s_t, s_j)
    assert q_t.dtype == np.int8 and s_t.dtype == np.float32
    np.testing.assert_array_equal(tk.dequantize_rows_int8(q_t, s_t),
                                  jk.dequantize_rows_int8(q_j, s_j))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_perturbation_samplers_bitwise(kind):
    x = np.random.default_rng(2).normal(size=(300, 8)).astype(np.float32)
    for storage in ("f32", "bf16", "int8"):
        assert tk.storage_perturbation(x, _kp("torch", kind), storage) == \
            jk.storage_perturbation(x, _kp("jax", kind), storage)
    with pytest.raises(ValueError, match="unknown union storage"):
        tk.storage_perturbation(x, _kp("torch", kind), "fp8")
    with pytest.raises(ValueError, match="precomputed"):
        tk.int8_kernel_perturbation(x, tk.KernelParams("precomputed"))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_stage_union_host_bitwise(storage):
    sv = _rows()
    store, scale, sq = tserve.stage_union_host(sv, storage)
    j_store, j_scale, j_sq = jserve.stage_union_host(sv, storage)
    np.testing.assert_array_equal(store.float().numpy(),
                                  np.asarray(j_store, np.float32))
    assert str(store.dtype) == {"f32": "torch.float32",
                                "bf16": "torch.bfloat16",
                                "int8": "torch.int8"}[storage]
    np.testing.assert_array_equal(sq, j_sq)
    if storage == "int8":
        np.testing.assert_array_equal(scale, j_scale)
    else:
        assert scale is None and j_scale is None
    for s_rows, d in ((40, 7), (40, 54), (0, 3)):
        assert tserve.union_nbytes(storage, s_rows, d) == \
            jserve.union_nbytes(storage, s_rows, d)


def test_query_quantization_and_integer_dots_bitwise():
    """JAX's executor algebra on the host: t = max|q| / 127 (1 for a
    zero row), round half to even, clip to +-127; the int32 dots of the
    port's mm_i8_i32 equal jnp.dot(..., preferred_element_type=int32)."""
    rng = np.random.default_rng(4)
    q = (rng.normal(size=(33, 13)) * rng.gamma(1.0, 3.0, size=(33, 1))
         ).astype(np.float32)
    q[5] = 0.0
    q[7, :4] = [0.5, 1.5, -2.5, 127.0]  # ties to even after the scale
    qf = jnp.asarray(q)
    t = jnp.max(jnp.abs(qf), axis=1) / 127.0
    t = jnp.where(t > 0, t, 1.0)
    q_q = jnp.clip(jnp.round(qf / t[:, None]), -127, 127).astype(jnp.int8)
    got_q, got_t = tserve.quantize_queries_int8(torch.from_numpy(q))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(q_q))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(t))
    sv_q, _ = jk.quantize_rows_int8(_rows(n=29, d=13))
    want = jnp.dot(q_q, jnp.asarray(sv_q).T,
                   preferred_element_type=jnp.int32)
    got = tk.mm_i8_i32(got_q, torch.from_numpy(sv_q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mm_i8_i32_refuses_other_operands():
    a = torch.zeros((4, 8), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tk.mm_i8_i32(a.float(), a)
    with pytest.raises(ValueError, match="inner"):
        tk.mm_i8_i32(a, torch.zeros((3, 7), dtype=torch.int8))


@pytest.mark.parametrize("requested", ["bf16", "int8", "auto"])
@pytest.mark.parametrize("scale", [0.05, 100.0])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_storage_guard_matches_jax(kind, scale, requested):
    """Per family, a moderate and a risky model: the same effective
    storage, risks and note (the warning too) in both packages."""
    m = _binary(kind, n_sv=200, d=6, coef_scale=scale, seed=3)
    tm = model_from_reference(m)
    ens_j = jserve.compact_models([m])
    ens_t = tserve.compact_models([tm])
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        st_j, e_j = jserve.resolve_union_storage(ens_j, m.kernel,
                                                 requested)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        st_t, e_t = tserve.resolve_union_storage(ens_t, tm.kernel,
                                                 requested)
    assert st_t == st_j
    assert e_t == e_j
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]


def test_guard_no_feature_rows_and_unknown():
    pre = types.SimpleNamespace(sv_union=np.ones((5, 4), np.float32),
                                coef=np.ones((5, 1), np.float32))
    for kp, ens in ((tk.KernelParams("precomputed"), pre),
                    (tk.KernelParams("rbf", 0.5), types.SimpleNamespace(
                        sv_union=np.zeros((0, 4), np.float32),
                        coef=np.zeros((0, 1), np.float32)))):
        st, entry = tserve.resolve_union_storage(ens, kp, "int8")
        jst, jentry = jserve.resolve_union_storage(ens, kp, "int8")
        assert st == jst == "f32" and entry == jentry
    with pytest.raises(ValueError, match="unknown union storage"):
        tserve.resolve_union_storage(pre, tk.KernelParams("rbf"), "fp4")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_int8_server_decisions_match_jax(kind):
    m = _binary(kind, coef_scale=0.05, seed=3)
    cfg = dict(buckets=(32,), union_storage="int8")
    js = jserve.PredictServer(m, JaxServeConfig(**cfg))
    ts = tserve.PredictServer(model_from_reference(m), ServeConfig(**cfg),
                              device="cpu")
    assert ts.union_storage == js.union_storage == "int8"
    q = np.random.default_rng(5).normal(size=(48, 6)).astype(np.float32)
    np.testing.assert_allclose(ts.decision(q), js.decision(q), rtol=1e-5,
                               atol=1e-5)


def test_engine_mixed_storage_groups_and_hot_swap():
    good = model_from_reference(_binary("rbf", n_sv=60, d=5,
                                        coef_scale=0.05, seed=1))
    risky = model_from_reference(_binary("rbf", n_sv=500, d=5,
                                         coef_scale=100.0, seed=9))
    eng = ServingEngine(ServeConfig(buckets=(16, 64), union_storage="int8"),
                        device="cpu")
    try:
        eng.register("good", good)
        with pytest.warns(UserWarning, match="REFUSED"):
            eng.register("risky", risky)
        snap = eng.snapshot()
        assert snap["union_storage"]["good"] == "int8"
        assert snap["union_storage"]["risky"] in ("bf16", "f32")
        assert snap["quantized_unions"] == 1
        assert len({g.union_storage for g in eng._groups.values()}) == 2
        q = np.random.default_rng(2).normal(size=(30, 5)).astype(np.float32)
        one = tserve.PredictServer(good, ServeConfig(buckets=(16, 64),
                                                     union_storage="int8"),
                                   device="cpu")
        np.testing.assert_allclose(eng.decision(q, model="good"),
                                   one.decision(q), rtol=1e-5, atol=1e-5)
        with pytest.warns(UserWarning, match="REFUSED"):
            eng.swap("good", risky)
        assert eng.snapshot()["union_storage"]["good"] != "int8"
        assert eng.hot_swaps.value == 1
    finally:
        eng.close()
