"""The out-of-core mesh stream in the port (solver/ooc.py solve_ooc_mesh,
parallel/dist_block.py ooc_mesh_*) against the port's one-device stream
and against the JAX package's dpsvm_tpu/solver/ooc.py solve_ooc_mesh, on
the CPU at the JAX tests' shape (make_blobs_binary(n=1024, d=24,
seed=11, sep=1.0), working_set_size=64, 256-row tiles, two devices: the
JAX package on its forced host devices, the port on Mesh(["cpu"] * 2)).

Contracts held here:
* bit for bit: the mesh stream and the one-device stream (plain,
  compensated, padded tail over three shards, memmap X, warm start); a
  stopped and resumed mesh run and the uninterrupted one; a one-device
  file resumed on the mesh;
* within tolerance: whole solves against the JAX package's mesh stream
  (dual rel 1e-4, SV count 2%, b 5e-3); checkpoints written by either
  package's mesh stream and resumed by the other's (the same contract);
* the block cache and the shrunken stream refused on the mesh with the
  JAX package's ValueError and words; train(backend="auto") choosing
  what the JAX package's single_only_ooc chooses.
"""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.parallel.dist_smo import solve_mesh as jax_solve_mesh
from dpsvm_tpu_torch import Mesh, SVMConfig, solve_mesh
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.parallel.dist_block import ooc_mesh_select
from dpsvm_tpu_torch.solver import block
from dpsvm_tpu_torch.solver.ooc import (MeshTileStream, TileStream,
                                        solve_ooc, solve_ooc_mesh)
from dpsvm_tpu_torch.utils.checkpoint import load_checkpoint_state

KW = dict(c=2.0, epsilon=1e-3, engine="block", working_set_size=64,
          max_iter=50_000, ooc=True, ooc_tile_rows=256)
OOC = SVMConfig(**KW)
DUAL_RTOL, SV_TOL, B_TOL = 1e-4, 0.02, 5e-3


@pytest.fixture(scope="module")
def data():
    return make_blobs_binary(n=1024, d=24, seed=11, sep=1.0)


@pytest.fixture(scope="module")
def one_device(data):
    return solve_ooc(*data, OOC, device="cpu")


def mesh2():
    return Mesh(["cpu"] * 2)


def _assert_bitwise(a, b):
    assert a.iterations == b.iterations
    assert a.converged == b.converged
    assert a.b_hi == b.b_hi and a.b_lo == b.b_lo
    np.testing.assert_array_equal(a.alpha, b.alpha)
    np.testing.assert_array_equal(a.stats["f"], b.stats["f"])


def _dual(res, y):
    a = np.asarray(res.alpha, np.float64)
    y64 = np.asarray(y, np.float64)
    f = np.asarray(res.stats["f"], np.float64)
    return 0.5 * float(np.sum(a * y64 * (f + y64))) - float(a.sum())


def _assert_contract(port, ref, y):
    assert port.converged and ref.converged
    dp, dr = _dual(port, y), _dual(ref, y)
    assert abs(dp - dr) <= DUAL_RTOL * abs(dr)
    assert abs(port.n_sv - ref.n_sv) <= max(1, SV_TOL * ref.n_sv)
    assert abs(port.b - ref.b) <= B_TOL


def _memmap(tmp_path, x):
    path = tmp_path / "x.dat"
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=x.shape)
    mm[:] = x
    mm.flush()
    return np.memmap(path, dtype=np.float32, mode="r", shape=x.shape)


# ------------------------------------- mesh stream == one-device stream

@pytest.mark.parametrize("case", ["plain", "compensated", "padded_tail",
                                  "memmap"])
def test_mesh_stream_bitwise_to_one_device(data, one_device, tmp_path,
                                           case):
    """Each shard's tile is the one-device stream's tile r tiles_loc + j,
    folded on its real rows; selection and the (q, 5) masked sum are
    exact: the trajectory is the one-device stream's bit for bit."""
    x, y = data
    cfg, ref, mesh = OOC, one_device, mesh2()
    if case == "compensated":
        cfg = OOC.replace(compensated=True)
        ref = solve_ooc(x, y, cfg, device="cpu")
    elif case == "padded_tail":
        # 1000 rows over three shards: n_loc 512, n_pad 1536, a partial
        # tile on shard 1 and an empty shard 2.
        x, y, mesh = x[:1000], y[:1000], Mesh(["cpu"] * 3)
        ref = solve_ooc(x, y, cfg, device="cpu")
    elif case == "memmap":
        x = _memmap(tmp_path, x)
    res = solve_mesh(x, y, cfg, mesh=mesh)
    _assert_bitwise(ref, res)
    st = res.stats
    assert st["ooc"] and st["ooc_mesh"] and st["ooc_devices"] == mesh.size
    assert st["mesh_devices"] == ["cpu"] * mesh.size
    assert st["tiles_streamed"] == ref.stats["tiles_streamed"]
    assert st["tile_bytes_h2d"] == ref.stats["tile_bytes_h2d"]
    assert st["outer_rounds"] == ref.stats["outer_rounds"] > 1
    assert st["n_pad"] == mesh.size * 512


def test_mesh_stream_meets_jax_mesh_contract(data):
    x, y = data
    jres = jax_solve_mesh(x, y, JaxConfig(**KW), num_devices=2)
    res = solve_mesh(x, y, OOC, mesh=mesh2())
    _assert_contract(res, jres, y)
    assert jres.stats["ooc_mesh"] and res.stats["ooc_mesh"]
    assert res.stats["ooc_tiles"] == 4 == jres.stats["ooc_devices"] * 2


def test_mesh_select_is_select_block(data):
    """ooc_mesh_select's working set and extrema are select_block's over
    the whole vector, and its (q, 5) scalars the owners' values."""
    import torch

    x, y = data
    rng = np.random.default_rng(3)
    f = torch.as_tensor(rng.normal(size=1024).astype(np.float32))
    alpha = torch.as_tensor(np.where(rng.random(1024) < 0.3, 1.0,
                                     0.0).astype(np.float32))
    yt = torch.as_tensor(y.astype(np.float32))
    xsq = torch.as_tensor(rng.random(1024).astype(np.float32))
    kd = torch.ones(1024)
    mesh = mesh2()
    cut = lambda v: [v[:512], v[512:]]  # noqa: E731
    valid = cut(torch.ones(1024, dtype=torch.bool))
    sel, owners = ooc_mesh_select(mesh, cut(f), None, cut(alpha), cut(yt),
                                  cut(xsq), cut(kd), valid, (2.0, 2.0), 64)
    w, ok, bh, bl = block.select_block(f, alpha, yt, (2.0, 2.0), 64)
    mw, mok, mbh, mbl, scal = sel[0]
    assert torch.equal(mw, w) and torch.equal(mok, ok)
    assert float(mbh) == float(bh) and float(mbl) == float(bl)
    live = ok.numpy()
    for col, v in enumerate((xsq, kd, alpha, yt, f)):
        np.testing.assert_array_equal(scal[:, col].numpy()[live],
                                      v[w].numpy()[live])


def test_mesh_tile_stream_walks_the_one_device_tiles(data):
    """Step j of shard r is the one-device stream's tile r tiles_loc + j;
    bytes count the real float32 rows, the empty shards nothing."""
    x, y = data
    x = x[:1000]
    one = TileStream(x, 1000, 24, 256, __import__("torch").device("cpu"))
    tiles = {i: xt.clone() for i, xt, _ in one.walk(range(4))}
    ms = MeshTileStream(x, 1000, 24, 256, 512, Mesh(["cpu"] * 3))
    seen = 0
    for j, step in ms.walk(range(2)):
        for r, (xt, rows) in enumerate(step):
            i = r * 2 + j
            if i >= 4:
                assert xt is None and rows == 0
                continue
            assert rows == one.rows(i)
            assert np.array_equal(xt.numpy(), tiles[i].numpy())
            seen += 1
    assert seen == 4 and ms.bytes == one.bytes == 1000 * 24 * 4


# ----------------------------------------------------------- the refusals

@pytest.mark.parametrize("kw,words", [
    (dict(ooc_cache_lines=256), "ooc_cache_lines"),
    (dict(ooc_shrink=True), "shrunken"),
    (dict(active_set_size=256), "shrunken"),
])
def test_mesh_refuses_cache_and_shrink_like_jax(data, kw, words):
    x, y = data
    with pytest.raises(ValueError, match=words) as jerr:
        jax_solve_mesh(x, y, JaxConfig(**KW, **kw), num_devices=2)
    with pytest.raises(ValueError, match=words) as terr:
        solve_mesh(x, y, OOC.replace(**kw), mesh=mesh2())
    assert str(terr.value) == str(jerr.value)


def test_auto_backend_follows_single_only_ooc(data):
    """train(backend="auto") on a given mesh takes the mesh stream for
    plain ooc and keeps the cache, the shrunken stream and an active set
    on one device, as the JAX package's single_only_ooc does."""
    from dpsvm_tpu_torch import train
    from dpsvm_tpu_torch.train import resolve_backend

    x, y = data
    mesh = mesh2()
    assert resolve_backend("auto", OOC, mesh=mesh) == "mesh"
    for kw in (dict(ooc_cache_lines=256), dict(ooc_shrink=True),
               dict(active_set_size=256)):
        assert resolve_backend("auto", OOC.replace(**kw), mesh=mesh) \
            == "single"
    model, res = train(x[:512], y[:512], OOC, mesh=mesh)
    assert res.stats["ooc_mesh"] and model.sv_x.shape[0] == res.n_sv
    _, single = train(x[:512], y[:512], OOC.replace(ooc_cache_lines=256),
                      mesh=mesh, device="cpu")
    assert "ooc_mesh" not in single.stats and single.stats["ooc"]


# -------------------------------------------------- warm starts and state

def test_mesh_stream_warm_start_is_the_one_device_one(data):
    from dpsvm_tpu_torch.solver.warmstart import WarmStart

    x, y = data
    seed = WarmStart(alpha=np.where(np.arange(1024) % 7 == 0, 0.5,
                                    0.0).astype(np.float32))
    ref = solve_ooc(x, y, OOC, device="cpu", warm_start=seed)
    res = solve_ooc_mesh(x, y, OOC, mesh=mesh2(), warm_start=seed)
    _assert_bitwise(ref, res)
    assert res.stats["warm_start"] == ref.stats["warm_start"]


@pytest.mark.parametrize("writer", ["mesh", "one_device"])
def test_mesh_resume_is_bitwise(data, one_device, tmp_path, writer):
    """A mesh run stopped at a round boundary and resumed (from its own
    file, or from the one-device stream's) is the uninterrupted run bit
    for bit."""
    x, y = data
    cfg = OOC.replace(checkpoint_every=1_000_000)
    p = str(tmp_path / "ck.npz")
    stop = lambda it, *_: it >= 400  # noqa: E731
    if writer == "mesh":
        solve_mesh(x, y, cfg, mesh=mesh2(), callback=stop,
                   checkpoint_path=p)
    else:
        solve_ooc(x, y, cfg, device="cpu", callback=stop, checkpoint_path=p)
    assert load_checkpoint_state(p).iteration >= 400
    res = solve_mesh(x, y, cfg, mesh=mesh2(), checkpoint_path=p,
                     resume=True)
    assert res.stats["resumed_from"] >= 400
    _assert_bitwise(one_device, res)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mesh_checkpoints_cross_the_packages(data, tmp_path, writer):
    """A mesh-stream file written by either package resumes in the
    other's mesh stream, within the contract of the reader's
    uninterrupted run."""
    x, y = data
    kw = dict(KW, checkpoint_every=1_000_000)
    p = str(tmp_path / f"{writer}.npz")
    stop = lambda it, *_: it >= 400  # noqa: E731
    if writer == "port":
        solve_mesh(x, y, SVMConfig(**kw), mesh=mesh2(), callback=stop,
                   checkpoint_path=p)
        res = jax_solve_mesh(x, y, JaxConfig(**kw), num_devices=2,
                             checkpoint_path=p, resume=True)
        ref = jax_solve_mesh(x, y, JaxConfig(**kw), num_devices=2)
    else:
        jax_solve_mesh(x, y, JaxConfig(**kw), num_devices=2, callback=stop,
                       checkpoint_path=p)
        res = solve_mesh(x, y, SVMConfig(**kw), mesh=mesh2(),
                         checkpoint_path=p, resume=True)
        ref = solve_mesh(x, y, SVMConfig(**kw), mesh=mesh2())
    assert res.stats["resumed_from"] >= 400
    _assert_contract(res, ref, y)
