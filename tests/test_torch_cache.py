"""The per-pair engines' row cache (solver/cache.py) against the JAX
package's on the same index sequences: keys, ticks and hit counts bit
for bit, rows within rtol 1e-6 (the dot products sum in another order);
a fuzz against a host LRU model; the double-miss and same-index edges;
a masked lookup changes nothing. Each JAX and model case runs on every
form of the cache: the device form (keys and ticks are tensors; the
ids, the pair count and the trip's gate are 0-d tensors; its fill is
kernel cache_fill's plain version here); the sharded device form of the
mesh per-pair runner (init_mesh_cache, lookup_pair_mesh /
lookup_one_mesh: P = 1, 2 and 4 row shards of X, each rank's columns of
the lines, the query rows given as rows, held line by line against the
columns of JAX's; at P = 4 the ranks are split over two groups of keys
and ticks, as on two devices); and the host-keyed form
(lookup_pair_sharded / lookup_one_sharded, keys and ticks NumPy arrays,
here with one shard)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpsvm_tpu.solver import cache as jcache
from dpsvm_tpu_torch.solver import cache as tcache

N, D = 40, 6
_jpair = jax.jit(jcache.lookup_pair)
_jone = jax.jit(jcache.lookup_one)
FORMS = ("device", "host", "sharded1", "sharded2", "sharded4")
# The device forms: the trip's gate is a tensor there.
DEVICE_FORMS = ("device", "sharded1", "sharded2", "sharded4")


@pytest.fixture(scope="module")
def xs():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


_ON = torch.tensor(True)


def _i(v):
    return torch.tensor(v, dtype=torch.int64)


def _mesh_like(p: int):
    """A Mesh's layout of p CPU ranks: at p = 4 two groups of two ranks
    (the keys and ticks of two devices), else one group."""
    groups = 2 if p == 4 else 1
    per = p // groups
    return types.SimpleNamespace(
        devices=(torch.device("cpu"),) * p,
        groups=tuple((torch.device("cpu"), tuple(range(g * per,
                                                       (g + 1) * per)))
                     for g in range(groups)),
        group_of=tuple(r // per for r in range(p)))


def _init(form, lines):
    if form == "device":
        return tcache.init_cache(lines, N, "cpu")
    if form.startswith("sharded"):
        p = int(form[len("sharded"):])
        return tcache.init_mesh_cache(lines, N // p, _mesh_like(p))
    hc = tcache.init_host_cache(lines, N, "cpu")
    hc.data = [hc.data]  # one shard, as the mesh runner lays its lines out
    return hc


def _host(tc) -> bool:
    return isinstance(tc.keys, np.ndarray)


def _mesh(tc) -> bool:
    return isinstance(tc, tcache.MeshCacheState)


def _data(tc):
    """The (L, n) lines: a mesh cache's ranks' columns side by side."""
    if _mesh(tc):
        return torch.cat([st[:-1] for st in tc.stores], dim=1)
    return tc.data[0] if _host(tc) else tc.data


def _keys(tc):
    """The keys (and ticks) as lists; a mesh cache's groups must agree."""
    if _mesh(tc):
        for k, t in zip(tc.keys[1:], tc.ticks[1:]):
            assert torch.equal(k, tc.keys[0]) and torch.equal(t,
                                                              tc.ticks[0])
        return tc.keys[0].tolist(), tc.ticks[0].tolist()
    return tc.keys.tolist(), tc.ticks.tolist()


def _shards(tc, x):
    """X's row shards of a mesh cache (the whole X once otherwise)."""
    p = len(tc.stores) if _mesh(tc) else 1
    xt = torch.as_tensor(x)
    return list(xt.split(xt.shape[0] // p))


def _groups(tc, v, dtype=torch.int64):
    """A replicated value per group of a mesh cache."""
    return [v if torch.is_tensor(v) else torch.tensor(v, dtype=dtype)
            for _ in tc.keys]


def _tpair(tc, x, i_hi, i_lo, it, active=_ON):
    """The port's lookup_pair in the cache's form: device-tensor
    arguments, or host ints through lookup_pair_sharded. Returns
    (row_hi, row_lo, hits as an int)."""
    xt = torch.as_tensor(x)
    if _host(tc):
        r_hi, r_lo, hits = tcache.lookup_pair_sharded(
            tc, [xt], i_hi, i_lo, [xt[i_hi]], [xt[i_lo]], it)
        return r_hi[0], r_lo[0], hits
    if _mesh(tc):
        xs = _shards(tc, x)
        r_hi, r_lo, hits = tcache.lookup_pair_mesh(
            tc, xs, _groups(tc, i_hi), _groups(tc, i_lo),
            [xt[i_hi]] * len(xs), [xt[i_lo]] * len(xs),
            _groups(tc, it, torch.int32), _groups(tc, active))
        assert all(torch.equal(h, hits[0]) for h in hits)
        return torch.cat(r_hi), torch.cat(r_lo), int(hits[0])
    rows, hits = tcache.lookup_pair(tc, xt, _i(i_hi), _i(i_lo), _i(it),
                                    active)
    assert hits.dim() == 0 and rows.shape == (2, x.shape[0])
    return rows[0], rows[1], int(hits)


def _tone(tc, x, i, stamp, active=_ON):
    xt = torch.as_tensor(x)
    if _host(tc):
        rows, hit = tcache.lookup_one_sharded(tc, [xt], i, [xt[i]], stamp)
        return rows[0], hit
    if _mesh(tc):
        xs = _shards(tc, x)
        rows, hits = tcache.lookup_one_mesh(
            tc, xs, _groups(tc, i), [xt[i]] * len(xs),
            _groups(tc, stamp, torch.int32), _groups(tc, active))
        assert all(h.dim() == 0 and h.dtype == torch.bool for h in hits)
        assert all(bool(h) == bool(hits[0]) for h in hits)
        return torch.cat(rows), bool(hits[0])
    row, hit = tcache.lookup_one(tc, xt, _i(i), _i(stamp), active)
    assert hit.dim() == 0 and hit.dtype == torch.bool
    return row, bool(hit)


def _pair(jc, tc, x, i_hi, i_lo, it):
    xj = jnp.asarray(x)
    rj_hi, rj_lo, jc, jhits = _jpair(
        jc, xj, jnp.int32(i_hi), jnp.int32(i_lo), xj[i_hi], xj[i_lo],
        jnp.int32(it))
    return (rj_hi, rj_lo, jc, int(jhits)), _tpair(tc, x, i_hi, i_lo, it)


def _snapshot(tc):
    if _mesh(tc):
        return [t.clone() for t in (*tc.stores, *tc.keys, *tc.ticks)]
    return [tc.store.clone(), tc.keys.clone(), tc.ticks.clone()]


def _assert_state(jc, tc):
    keys, ticks = ((tc.keys, tc.ticks) if _host(tc)
                   else (tc.keys[0].numpy(), tc.ticks[0].numpy())
                   if _mesh(tc) else (tc.keys.numpy(), tc.ticks.numpy()))
    assert isinstance(keys, np.ndarray)
    np.testing.assert_array_equal(keys, np.asarray(jc.keys))
    np.testing.assert_array_equal(ticks, np.asarray(jc.ticks))
    assert keys.dtype == np.int32 and ticks.dtype == np.int32
    _keys(tc)  # every group of a mesh cache holds the same keys, ticks
    np.testing.assert_allclose(_data(tc).numpy(), np.asarray(jc.data),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lines", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_pair_matches_jax(xs, lines, seed, form):
    rng = np.random.default_rng(seed)
    jc = jcache.init_cache(lines, N)
    tc = _init(form, lines)
    _assert_state(jc, tc)
    cases = set()
    for it in range(50):
        # A narrow index range revisits rows, so hits happen.
        i_hi, i_lo = (int(v) for v in rng.integers(0, 10, 2))
        keys = _keys(tc)[0]
        case = (i_hi in keys, i_lo in keys)
        (jh, jl, jc, jn), (th, tl, tn) = _pair(jc, tc, xs, i_hi, i_lo, it)
        cases.add(case)
        assert tn == jn
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                                   atol=1e-6)
        _assert_state(jc, tc)
    # Every hit/miss case of the branch kernel cache_fill replaces (with
    # fewer lines a double hit is rare on ten ids).
    if lines >= 4:
        assert cases == {(False, False), (False, True), (True, False),
                         (True, True)}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("lines", [1, 3, 8])
def test_lookup_one_matches_jax(xs, lines, form):
    """The second-order rule's stamps: 2 it + 1 for hi, 2 it + 2 for lo."""
    rng = np.random.default_rng(lines)
    jc = jcache.init_cache(lines, N)
    tc = _init(form, lines)
    xj = jnp.asarray(xs)
    for it in range(40):
        for k, i in enumerate(int(v) for v in rng.integers(0, 8, 2)):
            stamp = 2 * it + 1 + k
            rj, jc, jhit = _jone(jc, xj, jnp.int32(i), xj[i],
                                 jnp.int32(stamp))
            rt, thit = _tone(tc, xs, i, stamp)
            assert thit == bool(jhit)
            np.testing.assert_allclose(rt.numpy(), np.asarray(rj),
                                       rtol=1e-6, atol=1e-6)
            _assert_state(jc, tc)


class _ModelLRU:
    """Host LRU model (after tests/test_cache.py): keys and ticks."""

    def __init__(self, lines):
        self.keys = [-1] * lines
        self.ticks = [t - lines for t in range(lines)]

    def slot_of(self, k):
        return self.keys.index(k) if k in self.keys else None

    def lru(self, exclude=()):
        order = sorted(range(len(self.keys)), key=lambda s: self.ticks[s])
        return [s for s in order if s not in exclude][0]


@pytest.mark.parametrize("form", FORMS)
def test_lookup_pair_fuzz_against_host_model(xs, form):
    """Both probes and both victim choices read the pre-update state, the
    lo victim excludes the hi slot, lo wins a same-slot conflict; every
    cached line holds the dot row of its key."""
    rng = np.random.default_rng(7)
    lines = 5
    tc = _init(form, lines)
    model = _ModelLRU(lines)
    for it in range(200):
        i_hi, i_lo = (int(v) for v in rng.integers(0, 12, 2))
        h_hi, h_lo = model.slot_of(i_hi), model.slot_of(i_lo)
        s_hi = h_hi if h_hi is not None else model.lru()
        s_lo = h_lo if h_lo is not None else model.lru(exclude={s_hi})
        model.keys[s_hi] = i_hi
        model.keys[s_lo] = i_lo
        model.ticks[s_hi] = 2 * it + 1
        model.ticks[s_lo] = 2 * it + 2
        r_hi, r_lo, hits = _tpair(tc, xs, i_hi, i_lo, it)
        assert hits == (h_hi is not None) + (h_lo is not None)
        assert _keys(tc) == (model.keys, model.ticks)
        np.testing.assert_allclose(r_hi.numpy(), xs @ xs[i_hi], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r_lo.numpy(), xs @ xs[i_lo], rtol=1e-5,
                                   atol=1e-5)
        for s, k in enumerate(model.keys):
            if k >= 0:
                np.testing.assert_allclose(_data(tc)[s].numpy(), xs @ xs[k],
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", FORMS)
def test_double_miss_fills_two_distinct_lines(xs, form):
    tc = _init(form, 4)
    _, _, hits = _tpair(tc, xs, 5, 9, 0)
    assert hits == 0
    assert _keys(tc) == ([5, 9, -1, -1], [1, 2, -2, -1])


@pytest.mark.parametrize("form", FORMS)
def test_same_index_pair(xs, form):
    """i_hi == i_lo: a double miss caches the row in two lines (as JAX
    does); the next lookup of the pair hits both on the first."""
    jc = jcache.init_cache(3, N)
    tc = _init(form, 3)
    for it, hits in ((0, 0), (1, 2)):
        (jh, jl, jc, jn), (th, tl, tn) = _pair(jc, tc, xs, 4, 4, it)
        assert tn == jn == hits
        _assert_state(jc, tc)
        np.testing.assert_array_equal(th.numpy(), tl.numpy())
    assert _keys(tc) == ([4, 4, -1], [4, 2, -1])


@pytest.mark.parametrize("form", FORMS)
def test_lo_hit_on_the_hi_victim_line_keeps_the_lo_row(xs, form):
    """A hi miss whose LRU victim is the line lo hits: lo's write wins,
    the line keeps lo's row and the hi row comes back uncached."""
    jc = jcache.init_cache(2, N)
    tc = _init(form, 2)
    for it, (i_hi, i_lo) in enumerate(((1, 2), (2, 3), (7, 2))):
        (jh, jl, jc, jn), (th, tl, tn) = _pair(jc, tc, xs, i_hi, i_lo, it)
        assert tn == jn
        _assert_state(jc, tc)
        np.testing.assert_allclose(th.numpy(), xs @ xs[i_hi], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), xs @ xs[i_lo], rtol=1e-5,
                                   atol=1e-5)
    assert _keys(tc) == ([3, 2], [4, 6])


@pytest.mark.parametrize("form", DEVICE_FORMS)
@pytest.mark.parametrize("lines", [1, 2, 5])
def test_masked_lookup_changes_nothing(xs, lines, form):
    """A trip queued after the per-pair loop's stop: its lookups leave
    the lines (the spare too), keys and ticks bit for bit, count no hit,
    and compute no row."""
    rng = np.random.default_rng(lines)
    tc = _init(form, lines)
    off = torch.tensor(False)
    for it in range(30):
        i_hi, i_lo, i = (int(v) for v in rng.integers(0, 8, 3))
        before = _snapshot(tc)
        _, _, hits = _tpair(tc, xs, i_hi, i_lo, it, off)
        _, hit = _tone(tc, xs, i, 2 * it + 1, off)
        assert hits == 0 and not hit
        for a, b in zip(before, _snapshot(tc)):
            assert torch.equal(a, b)
        _tpair(tc, xs, i_hi, i_lo, it)  # then an active one moves on


@pytest.mark.parametrize("flags,dest", [
    ([1, 1, 0], [1, 4]), ([0, 1, 0], [1, 4]), ([0, 1, 1], [5, 0]),
    ([1], [3])])
def test_cache_fill_query_form_is_the_id_form(xs, flags, dest):
    """cache_fill's query form (the rows themselves: the mesh's) writes
    the id form's lines bit for bit on the same rows, and checks its
    rows' shape and dtype."""
    from dpsvm_tpu_torch.ops.cache_fill import cache_fill

    x = torch.as_tensor(xs)
    ids = torch.tensor([7, 31][:len(dest)], dtype=torch.int64)
    args = (torch.tensor(dest, dtype=torch.int64),
            torch.tensor(flags, dtype=torch.bool))
    store0 = torch.as_tensor(np.random.default_rng(3).normal(
        size=(6, N)).astype(np.float32))
    by_id, by_row = store0.clone(), store0.clone()
    cache_fill(x, by_id, ids, *args)
    cache_fill(x, by_row, None, *args, q=x[ids])
    assert torch.equal(by_id, by_row)
    assert not torch.equal(by_id, store0)
    with pytest.raises(ValueError, match="q must be"):
        cache_fill(x, by_row, None, *args, q=x[ids].double())
    with pytest.raises(ValueError, match="ids must be"):
        cache_fill(x, by_row, None, *args)
