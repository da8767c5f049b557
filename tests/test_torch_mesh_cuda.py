"""The mesh engines on logical shards of the CUDA card (marked `cuda`;
they skip elsewhere): each new runner launches its kernels as its loop
derives them (B1 once a round or inner round, computed once for the
shards of one card; B2 once a shard and round on the fused fold; B7
once a prefetch under the pipelined ring; no kernel on the per-pair
engine), and meets the CPU's solve within the whole-solve contract;
decision_function_mesh on the card agrees with decision_function;
`cli smoke` passes. Imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py
"""

import warnings

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch import Mesh, SVMConfig, cli, decision_function, train
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops import fold_select as fs
from dpsvm_tpu_torch.ops import ring
from dpsvm_tpu_torch.ops.subproblem import solve_subproblem
from dpsvm_tpu_torch.parallel.dist_smo import solve_mesh
from dpsvm_tpu_torch.predict import decision_function_mesh

BASE = dict(c=5.0, gamma=0.1, epsilon=1e-3, max_iter=200_000,
            engine="block", working_set_size=32)
KERNELS = {"B1": solve_subproblem, "B2": fs.fold_select,
           "B3": fs.select_rows, "B7": ring.ring_gather,
           "B8": ring.ring_fold_window}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels B1, B2 and B7 and "
                    "the logical shards of one card are CUDA only")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def data():
    return make_blobs_binary(n=4000, d=24, seed=11, sep=1.2)


def _counted(fn):
    for k in KERNELS.values():
        k.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = fn()
    return res, {name: k.launches for name, k in KERNELS.items()}


def _dual(res, y):
    a = np.asarray(res.alpha, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return float(a.sum() - 0.5 * np.sum(a * y * (f + y)))


CASES = {
    "pipelined ring": dict(pipeline_rounds=True, ring_exchange=True),
    # q/2 <= n_loc/128: four shards of 4000 rows pad to n_loc 1024.
    "fused": dict(fused_fold=True, working_set_size=16),
    "active": dict(active_set_size=512),
    "xla": dict(engine="xla"),
    "nu": dict(),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_mesh_runner_launches_and_matches_the_cpu(cuda, data, name):
    x, y = data
    kw = {**BASE, **CASES[name]}
    mesh = Mesh([cuda] * 4)
    if name == "nu":
        from dpsvm_tpu_torch import train_nusvc

        (_, res), counts = _counted(lambda: train_nusvc(
            x, y, nu=0.2, config=SVMConfig(**kw), backend="mesh",
            mesh=mesh))
        _, ref = train_nusvc(x, y, nu=0.2, config=SVMConfig(**kw),
                             backend="mesh", mesh=Mesh(["cpu"] * 4))
    else:
        res, counts = _counted(lambda: solve_mesh(
            x, y, SVMConfig(**kw), mesh=mesh))
        ref = solve_mesh(x, y, SVMConfig(**kw), mesh=Mesh(["cpu"] * 4))
    # The loop stops on the float32 test of the gap, `converged` is the
    # float64 one on the same extrema (as in the JAX package): a gap
    # within float32 rounding of 2 eps may read not converged.
    for r in (res, ref):
        assert r.converged or r.b_lo - r.b_hi <= 2 * kw["epsilon"] + 1e-6
    if name == "nu":
        # The nu-SVC result is rescaled by 1/r: held as
        # tests/test_torch_nusvm.py holds it (r and b within 5e-3).
        assert abs(res.stats["nu_r"] - ref.stats["nu_r"]) <= 5e-3
        assert abs(res.b - ref.b) <= 5e-3
    else:
        assert abs(_dual(res, y) - _dual(ref, y)) <= 1e-4 * abs(
            _dual(ref, y))
    assert abs(res.n_sv - ref.n_sv) <= max(2, 0.02 * ref.n_sv)
    rounds = res.stats.get("outer_rounds", 0)
    want = dict.fromkeys(KERNELS, 0)
    if name != "xla":
        want["B1"] = rounds
    if name == "fused":
        want["B2"] = 4 * rounds
    if name == "pipelined ring":
        want["B7"] = rounds + res.stats["chunks"]
    assert counts == want, (counts, want, rounds)


@pytest.mark.cuda
def test_decision_function_mesh_on_the_card(cuda, data):
    x, y = data
    model, _ = train(x, y, SVMConfig(**BASE), device=cuda)
    got = decision_function_mesh(model, x, mesh=Mesh([cuda] * 4), block=1000)
    np.testing.assert_allclose(got, decision_function(model, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cli_smoke_on_the_card(cuda, capsys):
    assert cli.main(["smoke", "--num-devices", "4"]) == 0
    out = capsys.readouterr().out
    assert "platform=cuda" in out and "psum OK" in out
    assert "matvec OK" in out
