"""The counting functions on hand-worked shapes."""

import pytest

from benchmark.lib import counts


def test_kernel_rows_of_a_mnist_round():
    # 2 q n d: the 24.1 GFLOP of one round's kernel rows at 60000 x 784.
    n, d, q = 60000, 784, 256
    assert 2 * q * n * d == 24_084_480_000
    assert counts.round_flops(n, d, q) == 24_084_480_000 + 30_720_000 + \
        102_760_448


def test_mnist8m_round_is_compute_bound():
    n, d, q = 960000, 784, 256
    flops = counts.round_flops(n, d, q)
    assert flops == 385_351_680_000 + 2 * q * n + 2 * q * q * d
    bound = counts.round_bound_s(n, d, q)
    assert bound == pytest.approx(flops / 67e12)
    assert counts.round_bytes(n, d, q) / 3.35e12 < bound
    assert bound == pytest.approx(5.760e-3, rel=1e-3)

