"""Mesh solver state against the JAX package: checkpoints of the
shard-local runner (local_working_sets >= 2) written by either package
and resumed by the other, and float64 reconstruction legs around the
mesh solve (tests/test_reconstruct.py:137, the JAX package's mesh legs
against its single chip).

Contracts: a resumed solve converges and meets the whole-solve contract
(dual rel 1e-4, SV count 2%, |db| 5e-3) against the other package's
uninterrupted run; the legs certify the float64 gap and land at the
single device's legs' optimum (alpha within 2e-2, b within 1e-3, the
JAX test's)."""

import warnings

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.data.synth import make_blobs_binary
from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
from dpsvm_tpu_torch import Mesh, SVMConfig, solve, solve_mesh
from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint_state

KW = dict(c=5.0, gamma=0.1, epsilon=1e-3, max_iter=200_000, engine="block",
          working_set_size=16, local_working_sets=2, sync_rounds=2,
          chunk_iters=64, checkpoint_every=1)


@pytest.fixture(scope="module")
def blobs():
    return make_blobs_binary(n=301, d=10, seed=3, sep=1.2)


def _dual(res, y):
    a = np.asarray(res.alpha, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


def _contract(rt, rj, y):
    assert rt.converged and rj.converged
    assert abs(_dual(rt, y) - _dual(rj, y)) <= 1e-4 * abs(_dual(rj, y))
    assert abs(rt.n_sv - rj.n_sv) <= max(1, 0.02 * rj.n_sv)
    assert abs(rt.b - rj.b) <= 5e-3


def _stop_after(chunks: int):
    seen = []

    def cb(*_):
        seen.append(1)
        return len(seen) >= chunks

    return cb


def _port(x, y, **kw):
    return solve_mesh(x, y, SVMConfig(**KW), mesh=Mesh(["cpu"] * 2), **kw)


def _jax(x, y, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jax_solve_mesh(x, y, JaxConfig(**KW), num_devices=2, **kw)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shardlocal_checkpoint_resumes_across_packages(blobs, tmp_path,
                                                       writer):
    """A shard-local solve stopped at its second chunk (a file every
    chunk) by one package resumes in the other to the optimum of the
    resuming package's uninterrupted run."""
    x, y = blobs
    p = str(tmp_path / "s.npz")
    write, read = (_port, _jax) if writer == "port" else (_jax, _port)
    part = write(x, y, checkpoint_path=p, callback=_stop_after(2))
    assert not part.converged
    assert load_checkpoint_state(p).iteration == part.iterations
    res = read(x, y, checkpoint_path=p, resume=True)
    assert res.iterations > part.iterations
    full = read(x, y)
    _contract(res, full, y)
    if writer == "jax":
        assert res.stats["shardlocal_demoted"]


def test_mesh_legs_match_single_device_and_jax():
    """Legs on the mesh (the block engine; the per-pair one is slow at
    this C on the CPU): certified, at the single device's legs' optimum
    (the JAX test's tolerances) and within the contract of the JAX
    package's mesh legs."""
    x, y = make_blobs_binary(n=96, d=12, seed=7, sep=0.6)
    kw = dict(c=5000.0, gamma=0.05, epsilon=1e-3, max_iter=400_000,
              engine="block", working_set_size=16, compensated=True,
              reconstruct_every=4000)
    rm = solve_mesh(x, y, SVMConfig(**kw), mesh=Mesh(["cpu"] * 2))
    r1 = solve(x, y, SVMConfig(**kw), device="cpu")
    rj = jax_solve_mesh(x, y, JaxConfig(**kw), num_devices=2)
    assert rm.converged and r1.converged and rj.converged
    assert rm.stats["true_gap"] <= 2 * kw["epsilon"]
    np.testing.assert_allclose(rm.alpha, r1.alpha, atol=2e-2)
    assert rm.b == pytest.approx(r1.b, abs=1e-3)
    assert rm.b == pytest.approx(rj.b, abs=5e-3)
    assert abs(rm.n_sv - rj.n_sv) <= max(1, 0.02 * rj.n_sv)
