"""The per-pair engines' row cache (solver/cache.py) against the JAX
package's on the same index sequences: keys, ticks and hit counts bit
for bit, rows within rtol 1e-6 (the dot products sum in another order);
a fuzz against a host LRU model; the double-miss and same-index edges."""

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


@pytest.fixture(scope="module")
def xs():
    return np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)


def _pair(jc, tc, x, i_hi, i_lo, it):
    xj = jnp.asarray(x)
    rj_hi, rj_lo, jc, jhits = _jpair(
        jc, xj, jnp.int32(i_hi), jnp.int32(i_lo), xj[i_hi], xj[i_lo],
        jnp.int32(it))
    rt_hi, rt_lo, thits = tcache.lookup_pair(tc, torch.as_tensor(x), i_hi,
                                             i_lo, it)
    return (rj_hi, rj_lo, jc, int(jhits)), (rt_hi, rt_lo, thits)


def _assert_state(jc, tc):
    np.testing.assert_array_equal(tc.keys, np.asarray(jc.keys))
    np.testing.assert_array_equal(tc.ticks, np.asarray(jc.ticks))
    assert tc.keys.dtype == np.int32 and tc.ticks.dtype == np.int32
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lines", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_lookup_pair_matches_jax(xs, lines, seed):
    rng = np.random.default_rng(seed)
    jc = jcache.init_cache(lines, N)
    tc = tcache.init_cache(lines, N, "cpu")
    _assert_state(jc, tc)
    for it in range(50):
        # A narrow index range revisits rows, so hits happen.
        i_hi, i_lo = (int(v) for v in rng.integers(0, 10, 2))
        (jh, jl, jc, jn), (th, tl, tn) = _pair(jc, tc, xs, i_hi, i_lo, it)
        assert tn == jn
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6,
                                   atol=1e-6)
        _assert_state(jc, tc)


@pytest.mark.parametrize("lines", [1, 3, 8])
def test_lookup_one_matches_jax(xs, lines):
    """The second-order rule's stamps: 2 it + 1 for hi, 2 it + 2 for lo."""
    rng = np.random.default_rng(lines)
    jc = jcache.init_cache(lines, N)
    tc = tcache.init_cache(lines, N, "cpu")
    xj, xt = jnp.asarray(xs), torch.as_tensor(xs)
    for it in range(40):
        for k, i in enumerate(int(v) for v in rng.integers(0, 8, 2)):
            stamp = 2 * it + 1 + k
            rj, jc, jhit = _jone(jc, xj, jnp.int32(i), xj[i],
                                             jnp.int32(stamp))
            rt, thit = tcache.lookup_one(tc, xt, i, stamp)
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


def test_lookup_pair_fuzz_against_host_model(xs):
    """Both probes and both victim choices read the pre-update state, the
    lo victim excludes the hi slot, lo wins a same-slot conflict; every
    cached line holds the dot row of its key."""
    rng = np.random.default_rng(7)
    lines = 5
    tc = tcache.init_cache(lines, N, "cpu")
    model = _ModelLRU(lines)
    xt = torch.as_tensor(xs)
    for it in range(200):
        i_hi, i_lo = (int(v) for v in rng.integers(0, 12, 2))
        h_hi, h_lo = model.slot_of(i_hi), model.slot_of(i_lo)
        s_hi = h_hi if h_hi is not None else model.lru()
        s_lo = h_lo if h_lo is not None else model.lru(exclude={s_hi})
        model.keys[s_hi] = i_hi
        model.keys[s_lo] = i_lo
        model.ticks[s_hi] = 2 * it + 1
        model.ticks[s_lo] = 2 * it + 2
        r_hi, r_lo, hits = tcache.lookup_pair(tc, xt, i_hi, i_lo, it)
        assert hits == (h_hi is not None) + (h_lo is not None)
        assert tc.keys.tolist() == model.keys
        assert tc.ticks.tolist() == model.ticks
        np.testing.assert_allclose(r_hi.numpy(), xs @ xs[i_hi], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r_lo.numpy(), xs @ xs[i_lo], rtol=1e-5,
                                   atol=1e-5)
        for s, k in enumerate(model.keys):
            if k >= 0:
                np.testing.assert_allclose(tc.data[s].numpy(), xs @ xs[k],
                                           rtol=1e-5, atol=1e-5)


def test_double_miss_fills_two_distinct_lines(xs):
    tc = tcache.init_cache(4, N, "cpu")
    _, _, hits = tcache.lookup_pair(tc, torch.as_tensor(xs), 5, 9, 0)
    assert hits == 0
    assert tc.keys.tolist() == [5, 9, -1, -1]
    assert tc.ticks.tolist() == [1, 2, -2, -1]


def test_same_index_pair(xs):
    """i_hi == i_lo: a double miss caches the row in two lines (as JAX
    does); the next lookup of the pair hits both on the first."""
    jc = jcache.init_cache(3, N)
    tc = tcache.init_cache(3, N, "cpu")
    for it, hits in ((0, 0), (1, 2)):
        (jh, jl, jc, jn), (th, tl, tn) = _pair(jc, tc, xs, 4, 4, it)
        assert tn == jn == hits
        _assert_state(jc, tc)
        np.testing.assert_array_equal(th.numpy(), tl.numpy())
    assert tc.keys.tolist() == [4, 4, -1]
    assert tc.ticks.tolist() == [4, 2, -1]


def test_lo_hit_on_the_hi_victim_line_keeps_the_lo_row(xs):
    """A hi miss whose LRU victim is the line lo hits: lo's write wins,
    the line keeps lo's row and the hi row comes back uncached."""
    jc = jcache.init_cache(2, N)
    tc = tcache.init_cache(2, N, "cpu")
    for it, (i_hi, i_lo) in enumerate(((1, 2), (2, 3), (7, 2))):
        (jh, jl, jc, jn), (th, tl, tn) = _pair(jc, tc, xs, i_hi, i_lo, it)
        assert tn == jn
        _assert_state(jc, tc)
        np.testing.assert_allclose(th.numpy(), xs @ xs[i_hi], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), xs @ xs[i_lo], rtol=1e-5,
                                   atol=1e-5)
    assert tc.keys.tolist() == [3, 2] and tc.ticks.tolist() == [4, 6]
