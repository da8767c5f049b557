"""Serving on the CUDA card (marked `cuda`; they skip elsewhere): the
int8 GEMM wrapper at ragged shapes, the per-row query quantization, the
servers' f32 / bf16 / int8 unions against the same servers on the CPU,
the engine's dispatch path (its own stream, no device-wide
synchronize, the watchdog) and the union on logical shards. Imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py
"""

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch.autotune import use_profile
from dpsvm_tpu_torch import PredictServer, ServeConfig, SVMModel
from dpsvm_tpu_torch.ops.kernels import KernelParams, mm_i8_i32
from dpsvm_tpu_torch.serve import quantize_queries_int8
from dpsvm_tpu_torch.serving import ServingEngine
from dpsvm_tpu_torch.testing import faults

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the serving path's stream, "
                    "pinned buffers and int8 GEMM are CUDA only")
    # Written against the auto gates' defaults: no device profile
    # resolves a None knob here (autotune/profile.py).
    with use_profile(None):
        yield torch.device("cuda")


def _model(d=54, n_sv=300, seed=0, coef_scale=0.05):
    rng = np.random.default_rng(seed)
    return SVMModel(
        rng.normal(size=(n_sv, d)).astype(np.float32),
        (rng.random(n_sv).astype(np.float32) + 0.01) * coef_scale,
        np.where(rng.random(n_sv) < 0.5, 1, -1).astype(np.int32), 0.05,
        KernelParams("rbf", 0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 17, 300])
@pytest.mark.parametrize("d", [1, 54, 784])
@pytest.mark.parametrize("s", [1, 7, 1001])
def test_int8_gemm_bitwise_its_plain_version(cuda, n, d, s):
    g = torch.Generator().manual_seed(n * 10007 + d * 31 + s)
    a = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (s, d), generator=g, dtype=torch.int8)
    got = mm_i8_i32(a.to(cuda), b.to(cuda))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, s)
    assert torch.equal(got.cpu(), mm_i8_i32(a, b))


@pytest.mark.cuda
def test_query_quantization_bitwise_the_cpu(cuda):
    rng = np.random.default_rng(4)
    q = (rng.normal(size=(257, 54)) * rng.gamma(1.0, 3.0, size=(257, 1))
         ).astype(np.float32)
    q[3] = 0.0
    got = quantize_queries_int8(torch.from_numpy(q).to(cuda))
    want = quantize_queries_int8(torch.from_numpy(q))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("d", [54, 784])
def test_server_on_the_card_matches_the_cpu(cuda, storage, d):
    m = _model(d=d, seed=d)
    cfg = ServeConfig(buckets=(16, 64, 256), union_storage=storage)
    gpu = PredictServer(m, cfg)
    cpu = PredictServer(m, cfg, device="cpu")
    assert gpu.union_storage == cpu.union_storage == storage
    q = np.random.default_rng(1).normal(size=(700, d)).astype(np.float32)
    np.testing.assert_allclose(gpu.decision(q), cpu.decision(q), **TOL)
    assert gpu.stats["bucket_counts"] == cpu.stats["bucket_counts"]
    t1, t2 = gpu.enqueue(q[:5]), gpu.enqueue(q[5:300])
    done = gpu.flush()
    np.testing.assert_allclose(np.concatenate([done[t1], done[t2]]),
                               cpu.decision(q[:300]), **TOL)


@pytest.mark.cuda
def test_engine_dispatch_never_synchronizes_the_device(cuda, monkeypatch):
    """The engine runs on its own stream and waits on events only:
    a device-wide synchronize on the dispatch path would raise here."""
    m = _model()
    eng = ServingEngine(ServeConfig(buckets=(16, 64)))
    try:
        eng.register("m", m)
        assert eng.stream is not None
        assert eng.stream != torch.cuda.default_stream(eng.device)

        def refuse(*a, **k):
            raise AssertionError("device-wide synchronize on the "
                                 "dispatch path")

        monkeypatch.setattr(torch.cuda, "synchronize", refuse)
        rng = np.random.default_rng(2)
        tickets = [eng.submit(rng.normal(size=(int(n), 54)).astype(
            np.float32)) for n in rng.integers(1, 200, 40)]
        done = eng.drain()
        monkeypatch.undo()
        assert sorted(done) == tickets
        assert all(r.verdict == "ok" for r in done.values())
        cpu = ServingEngine(ServeConfig(buckets=(16, 64)), device="cpu")
        cpu.register("m", m)
        q = rng.normal(size=(90, 54)).astype(np.float32)
        np.testing.assert_allclose(eng.decision(q), cpu.decision(q), **TOL)
        cpu.close()
    finally:
        eng.close()


@pytest.mark.cuda
def test_watchdog_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(faults, "STALL_SECONDS", 2.0)
    eng = ServingEngine(ServeConfig(buckets=(16,), dispatch_timeout_ms=250))
    try:
        eng.register("m", _model())
        q = np.random.default_rng(3).normal(size=(12, 54)).astype(np.float32)
        ref = eng.decision(q)
        with faults.install(faults.FaultPlan.parse("serve_stall@1")) as p:
            t = eng.submit(q)
            done = eng.drain()
        assert p.fired["serve_stall"] == 1
        assert done[t].verdict == "failed" and eng.watchdog_trips.value == 1
        np.testing.assert_array_equal(eng.decision(q), ref)
    finally:
        eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_logical_shards_of_the_card(cuda, storage):
    m = _model(seed=5)
    q = np.random.default_rng(6).normal(size=(100, 54)).astype(np.float32)
    one = PredictServer(m, ServeConfig(buckets=(64,),
                                       union_storage=storage))
    four = PredictServer(m, ServeConfig(buckets=(64,), num_devices=4,
                                        union_storage=storage),
                         device="cuda:0")
    assert four.mesh.size == 4
    np.testing.assert_allclose(four.decision(q), one.decision(q), **TOL)
