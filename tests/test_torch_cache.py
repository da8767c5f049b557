"""The per-pair engines' row cache (solver/cache.py) against the JAX
package's on the same index sequences: keys, ticks and hit counts bit
for bit, rows within rtol 1e-6 (the dot products sum in another order);
a fuzz against a host LRU model; the double-miss and same-index edges;
a masked lookup changes nothing. Each JAX and model case runs on both
forms of the cache: the device form (keys and ticks are tensors; the
ids, the pair count and the trip's gate are 0-d tensors; its fill is
kernel cache_fill's plain version here), and the host-keyed form the
mesh per-pair runner uses (lookup_pair_sharded / lookup_one_sharded,
keys and ticks NumPy arrays, here with one shard)."""

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
FORMS = ("device", "host")


@pytest.fixture(scope="module")
def xs():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


_ON = torch.tensor(True)


def _i(v):
    return torch.tensor(v, dtype=torch.int64)


def _init(form, lines):
    if form == "device":
        return tcache.init_cache(lines, N, "cpu")
    hc = tcache.init_host_cache(lines, N, "cpu")
    hc.data = [hc.data]  # one shard, as the mesh runner lays its lines out
    return hc


def _host(tc) -> bool:
    return isinstance(tc.keys, np.ndarray)


def _data(tc):
    return tc.data[0] if _host(tc) else tc.data


def _tpair(tc, x, i_hi, i_lo, it, active=_ON):
    """The port's lookup_pair in the cache's form: device-tensor
    arguments, or host ints through lookup_pair_sharded. Returns
    (row_hi, row_lo, hits as an int)."""
    xt = torch.as_tensor(x)
    if _host(tc):
        r_hi, r_lo, hits = tcache.lookup_pair_sharded(
            tc, [xt], i_hi, i_lo, [xt[i_hi]], [xt[i_lo]], it)
        return r_hi[0], r_lo[0], hits
    rows, hits = tcache.lookup_pair(tc, xt, _i(i_hi), _i(i_lo), _i(it),
                                    active)
    assert hits.dim() == 0 and rows.shape == (2, x.shape[0])
    return rows[0], rows[1], int(hits)


def _tone(tc, x, i, stamp, active=_ON):
    xt = torch.as_tensor(x)
    if _host(tc):
        rows, hit = tcache.lookup_one_sharded(tc, [xt], i, [xt[i]], stamp)
        return rows[0], hit
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
    return (tc.store.clone(), tc.keys.clone(), tc.ticks.clone())


def _assert_state(jc, tc):
    keys, ticks = ((tc.keys, tc.ticks) if _host(tc)
                   else (tc.keys.numpy(), tc.ticks.numpy()))
    assert isinstance(tc.keys, np.ndarray if _host(tc) else torch.Tensor)
    np.testing.assert_array_equal(keys, np.asarray(jc.keys))
    np.testing.assert_array_equal(ticks, np.asarray(jc.ticks))
    assert keys.dtype == np.int32 and ticks.dtype == np.int32
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
        case = (bool((tc.keys == i_hi).any()), bool((tc.keys == i_lo).any()))
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
        assert tc.keys.tolist() == model.keys
        assert tc.ticks.tolist() == model.ticks
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
    assert tc.keys.tolist() == [5, 9, -1, -1]
    assert tc.ticks.tolist() == [1, 2, -2, -1]


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
    assert tc.keys.tolist() == [4, 4, -1]
    assert tc.ticks.tolist() == [4, 2, -1]


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
    assert tc.keys.tolist() == [3, 2] and tc.ticks.tolist() == [4, 6]


@pytest.mark.parametrize("lines", [1, 2, 5])
def test_masked_lookup_changes_nothing(xs, lines):
    """A trip queued after the per-pair loop's stop: its lookups leave
    the lines (the spare too), keys and ticks bit for bit, count no hit,
    and compute no row."""
    rng = np.random.default_rng(lines)
    tc = _init("device", lines)
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
