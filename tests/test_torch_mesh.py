"""The port's data mesh and mesh selection (dpsvm_tpu_torch/parallel/)
against the JAX package on its forced host devices: pad_rows over a grid,
the collectives of a logical mesh, and, from the same mid-solve state with
ties, the replicated selection (_global_top, _select_block_mesh) and the
working-set recovery (_gather_ws), all bitwise.

The JAX functions run under shard_map on the first P host devices
(tests/conftest.py forces 8), the port's on Mesh(["cpu"] * P): P logical
shards of the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dpsvm_tpu.parallel import dist_block as jdb
from dpsvm_tpu.parallel import mesh as jmesh
from dpsvm_tpu.parallel.dist_smo import _global_ids as j_global_ids
from dpsvm_tpu_torch import convert
from dpsvm_tpu_torch.parallel import dist_block as tdb
from dpsvm_tpu_torch.parallel import mesh as tmesh
from dpsvm_tpu_torch.parallel.mesh import Mesh

SHARD = P(jmesh.DATA_AXIS)
REP = P()


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 300, 301, 1200, 60000, 60001])
def test_pad_rows_equals_jax(n, num_shards):
    for multiple in (8, 1024):
        got = tmesh.pad_rows(n, num_shards, multiple)
        assert got == jmesh.pad_rows(n, num_shards, multiple)
        assert got >= n and got % num_shards == 0
        assert (got // num_shards) % multiple == 0
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS


def test_mesh_groups_and_description():
    m = Mesh(["cpu"] * 4)
    assert m.size == 4 and m.describe() == ["cpu"] * 4
    assert m.groups == ((torch.device("cpu"), (0, 1, 2, 3)),)
    assert m.group_of == (0, 0, 0, 0)
    two = Mesh([torch.device("cpu"), torch.device("meta"), "cpu"])
    assert [ranks for _, ranks in two.groups] == [(0, 2), (1,)]
    assert two.group_of == (0, 1, 0)
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])
    # "cuda" is the current card: one device with "cuda:0", not two.
    named = Mesh(["cuda", "cuda:0", "cuda:1"])
    assert named.describe() == ["cuda:0", "cuda:0", "cuda:1"]
    assert named.group_of == (0, 0, 1)


@pytest.mark.parametrize("p_dev", [2, 4])
def test_collectives_of_a_logical_mesh(p_dev):
    """all_gather stacks in rank order; psum adds in rank order; pmax is
    the elementwise maximum; each gives one result per distinct device."""
    rng = np.random.default_rng(p_dev)
    parts_np = rng.standard_normal((p_dev, 3, 5)).astype(np.float32)
    parts = [torch.tensor(a) for a in parts_np]
    m = Mesh(["cpu"] * p_dev)
    (g,), (s,), (mx,) = m.all_gather(parts), m.psum(parts), m.pmax(parts)
    np.testing.assert_array_equal(g.numpy(), parts_np)
    acc = parts_np[0]
    for a in parts_np[1:]:
        acc = acc + a
    np.testing.assert_array_equal(s.numpy(), acc)
    np.testing.assert_array_equal(mx.numpy(), parts_np.max(axis=0))


def test_make_data_mesh_never_repeats_a_device(monkeypatch):
    """No visible card: raise, as every entry point of the port does; an
    explicit device list is cut to num_devices and refuses a longer ask,
    as the JAX package's make_data_mesh."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_data_mesh()
    with pytest.raises(ValueError, match="requested 3 devices, only 2"):
        tmesh.make_data_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="requested 99 devices"):
        jmesh.make_data_mesh(99)
    assert tmesh.make_data_mesh(1, devices=["cpu", "cpu"]).size == 1


def test_shard_padded_rows_and_replicate():
    m = Mesh(["cpu"] * 4)
    a = np.arange(26, dtype=np.float32).reshape(13, 2)
    parts = tmesh.shard_padded_rows(m, a)
    assert [tuple(p.shape) for p in parts] == [(8, 2)] * 4
    whole = tmesh.unshard(parts)
    np.testing.assert_array_equal(whole[:13], a)
    assert not whole[13:].any()
    bf = tmesh.shard_padded_rows(m, a, dtype=torch.bfloat16)
    assert bf[0].dtype == torch.bfloat16
    (r,) = tmesh.replicate_array(m, a)
    np.testing.assert_array_equal(r.numpy(), a)


def test_shard_state_round_trip():
    m = Mesh(["cpu"] * 4)
    rng = np.random.default_rng(0)
    alpha, f, err = (rng.standard_normal(32).astype(np.float32)
                     for _ in range(3))
    a_sh, f_sh, e_sh = convert.shard_state(jnp.asarray(alpha), f, err, m)
    assert len(a_sh) == 4 and a_sh[2].shape == (8,)
    np.testing.assert_array_equal(a_sh[1].numpy(), alpha[8:16])
    back = convert.unshard_state(a_sh, f_sh, e_sh)
    for got, want in zip(back, (alpha, f, err)):
        np.testing.assert_array_equal(got, want)
    assert convert.shard_state(alpha, f, None, m)[2] is None
    assert convert.unshard_state(a_sh, f_sh)[2] is None
    with pytest.raises(ValueError, match="do not divide"):
        convert.shard_state(alpha[:30], f[:30], None, m)


# ---- selection and recovery from one mid-solve state ------------------


@functools.lru_cache(maxsize=None)
def _state(p_dev, ties, seed=0, n=296, d=10, c=1.0):
    """A padded mid-solve state: (x, y, alpha, f, valid) numpy, n_pad
    rows. `ties` quantizes f so many candidates share a score."""
    from dpsvm_tpu.data.synth import make_blobs_binary
    from dpsvm_tpu.ops.kernels import KernelParams, kernel_matrix

    x, y = make_blobs_binary(n=n, d=d, seed=3, sep=1.2)
    rng = np.random.default_rng(seed)
    alpha = np.clip(rng.normal(0.4, 0.5, n), 0, c).astype(np.float32)
    k = np.asarray(kernel_matrix(x, x, KernelParams("rbf", 0.2)))
    f = ((alpha * y) @ k - y).astype(np.float32)
    if ties:
        f = (np.round(f * 4) / 4).astype(np.float32)
    n_pad = tmesh.pad_rows(n, p_dev)
    pad = n_pad - n
    valid = np.arange(n_pad) < n
    return (np.pad(x, ((0, pad), (0, 0))),
            np.pad(y.astype(np.float32), (0, pad), constant_values=1.0),
            np.pad(alpha, (0, pad)),
            np.pad(f, (0, pad), constant_values=-1.0), valid)


def _shards(mesh, *arrays):
    n_loc = arrays[0].shape[0] // mesh.size
    return [[torch.tensor(a[r * n_loc:(r + 1) * n_loc]) for r in
             range(mesh.size)] for a in arrays]


def _jax_sharded(fn, p_dev, in_specs, out_specs, *args):
    mapped = jax.jit(jmesh.mesh_shard_map(
        fn, jmesh.make_data_mesh(p_dev), in_specs, out_specs, check=False))
    return [np.asarray(o) for o in mapped(*map(jnp.asarray, args))]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("p_dev,q,rule", [
    (2, 16, "mvp"), (4, 16, "mvp"), (4, 64, "second_order"), (8, 32, "mvp")])
def test_select_block_mesh_is_jaxs(p_dev, q, rule, ties):
    """(w, slot_ok, b_hi, b_lo) from the same state, ties included: the
    same ids in the same slots, the same live mask, the same bits."""
    c = (1.0, 1.0)
    x, y, alpha, f, valid = _state(p_dev, ties)
    jw, jok, jbh, jbl = _jax_sharded(
        lambda f_, a_, y_, v_: jdb._select_block_mesh(f_, a_, y_, v_, c, q,
                                                      rule=rule),
        p_dev, (SHARD,) * 4, (REP,) * 4, f, alpha, y, valid)
    mesh = Mesh(["cpu"] * p_dev)
    f_s, a_s, y_s, v_s = _shards(mesh, f, alpha, y, valid)
    (tw, tok, tbh, tbl), = tdb._select_block_mesh(mesh, f_s, a_s, y_s, v_s,
                                                  c, q, rule=rule)
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tok.numpy(), jok)
    assert np.float32(tbh).tobytes() == np.float32(jbh).tobytes()
    assert np.float32(tbl).tobytes() == np.float32(jbl).tobytes()
    assert tok.any() and len(set(tw[tok].tolist())) == int(tok.sum())


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("p_dev", [2, 4])
def test_global_top_is_jaxs(p_dev, ties):
    """The replicated top-h per score row: ids, live mask and values,
    with a short side (an all -inf tail) in the mix."""
    h = 8
    x, y, alpha, f, valid = _state(p_dev, ties, seed=1)
    n_pad = len(y)
    n_loc = n_pad // p_dev
    scores = np.stack([np.where(valid & (alpha < 0.2), -f, -np.inf),
                       np.where(valid & (np.arange(n_pad) % 97 == 5), f, -np.inf)]
                      ).astype(np.float32)  # (2, n_pad); the second is short

    def jfn(s_loc):
        return jdb._global_top(s_loc, j_global_ids(n_loc), h)

    jg, jok, jv = _jax_sharded(jfn, p_dev, (P(None, jmesh.DATA_AXIS),),
                               (REP,) * 3, scores)
    mesh = Mesh(["cpu"] * p_dev)
    vs, gs = [], []
    for r in range(p_dev):
        s_loc = torch.tensor(scores[:, r * n_loc:(r + 1) * n_loc])
        v, i = tdb._top_h(s_loc, h)
        vs.append(v)
        gs.append(tdb._global_ids(r, n_loc, "cpu")[i])
    (tg, tok, tv), = tdb._global_top(mesh, vs, gs, h)
    np.testing.assert_array_equal(tg.numpy(), jg)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  jv.view(np.int32))
    assert not tok[1].all() and tok[0].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p_dev", [2, 4])
def test_gather_ws_is_jaxs(p_dev, dtype):
    """The working set's rows and per-row scalars recovered from the
    shards: (qx, scal) replicated, (l, own) per shard, all bitwise."""
    c, q = (1.0, 1.0), 16
    x, y, alpha, f, valid = _state(p_dev, ties=False, seed=2)
    n_loc = len(y) // p_dev
    x_sq = (x * x).sum(axis=1).astype(np.float32)
    kd = np.ones_like(x_sq)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    mesh = Mesh(["cpu"] * p_dev)
    f_s, a_s, y_s, v_s, xsq_s, kd_s = _shards(mesh, f, alpha, y, valid, x_sq,
                                              kd)
    x_s = [t.to(tdt) for t in _shards(mesh, x)[0]]
    (w, ok, _, _), = tdb._select_block_mesh(mesh, f_s, a_s, y_s, v_s, c, q)
    # One dead slot, so the masked sum has rows nobody owns.
    ok = ok.clone()
    ok[3] = False

    def jfn(x_loc, xsq_l, kd_l, a_l, y_l, f_l, w_, ok_):
        scal_loc = jnp.stack([xsq_l, kd_l, a_l, y_l, f_l], axis=1)
        return jdb._gather_ws(x_loc.astype(jdt), scal_loc, w_, ok_, n_loc)

    jqx, jscal, jl, jown = _jax_sharded(
        jfn, p_dev, (SHARD,) * 6 + (REP, REP), (REP, REP, SHARD, SHARD),
        x, x_sq, kd, alpha, y, f, w.numpy().astype(np.int32), ok.numpy())
    cols = [(xsq_s[r], kd_s[r], a_s[r], y_s[r], f_s[r])
            for r in range(p_dev)]
    (tqx,), (tscal,), owners = tdb._gather_ws(mesh, x_s, cols, [(w, ok)])
    np.testing.assert_array_equal(tqx.numpy(), jqx)
    np.testing.assert_array_equal(tscal.numpy(), jscal)
    np.testing.assert_array_equal(
        np.concatenate([o[0].numpy() for o in owners]), jl)
    np.testing.assert_array_equal(
        np.concatenate([o[1].numpy() for o in owners]), jown)
    assert int(sum(o[1].sum() for o in owners)) == int(ok.sum())


def test_nu_rule_is_refused_on_the_mesh():
    """The nu rule on the mesh, which the port once refused: from the
    same state, ties included, _select_block_mesh(rule="nu") gives the
    JAX package's per-class quarters and stopping pair bit for bit."""
    c = (1.0, 1.0)
    for p_dev, q in ((2, 16), (4, 32)):
        x, y, alpha, f, valid = _state(p_dev, True)
        jw, jok, jbh, jbl = _jax_sharded(
            lambda f_, a_, y_, v_: jdb._select_block_mesh(
                f_, a_, y_, v_, c, q, rule="nu"),
            p_dev, (SHARD,) * 4, (REP,) * 4, f, alpha, y, valid)
        mesh = Mesh(["cpu"] * p_dev)
        f_s, a_s, y_s, v_s = _shards(mesh, f, alpha, y, valid)
        (tw, tok, tbh, tbl), = tdb._select_block_mesh(
            mesh, f_s, a_s, y_s, v_s, c, q, rule="nu")
        np.testing.assert_array_equal(tw.numpy(), jw)
        np.testing.assert_array_equal(tok.numpy(), jok)
        assert np.float32(tbh).tobytes() == np.float32(jbh).tobytes()
        assert np.float32(tbl).tobytes() == np.float32(jbl).tobytes()
        # Each half pairs within one class.
        yw, ok = y[tw.numpy()], tok.numpy()
        assert (yw[:q // 2][ok[:q // 2]] > 0).all()
        assert (yw[q // 2:][ok[q // 2:]] < 0).all()
