"""The port's copies of the data helpers give the JAX package's arrays
bit for bit (generators) and read the same CSV files."""

import numpy as np
import pytest

from dpsvm_tpu.data import loader as jloader
from dpsvm_tpu.data import synth as jsynth
from dpsvm_tpu_torch.data import loader as tloader
from dpsvm_tpu_torch.data import synth as tsynth


@pytest.mark.parametrize("kw", [dict(n=300, d=10, seed=3, sep=1.2),
                                dict(n=57, d=4, seed=0)])
def test_make_blobs_binary_bitwise(kw):
    for t, j in zip(tsynth.make_blobs_binary(**kw),
                    jsynth.make_blobs_binary(**kw)):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("kw", [dict(n=500, d=784, seed=7, noise=0.1),
                                dict(n=200, d=32, seed=1, label_flip=0.1)])
def test_make_mnist_like_bitwise(kw):
    for t, j in zip(tsynth.make_mnist_like(**kw), jsynth.make_mnist_like(**kw)):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_csv_written_by_either_package_reads_the_same(tmp_path):
    x, y = tsynth.make_blobs_binary(n=40, d=6, seed=5)
    p_t, p_j = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    tloader.save_csv(p_t, x, y)
    jloader.save_csv(p_j, x, y)
    assert open(p_t).read() == open(p_j).read()
    xt, yt = tloader.load_csv(p_j, num_rows=30, num_features=5)
    xj, yj = jloader.load_csv(p_t, num_rows=30, num_features=5)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    assert xt.shape == (30, 5) and yt.dtype == np.int32
    with pytest.raises(ValueError, match="rows"):
        tloader.load_csv(p_t, num_rows=41)
    with pytest.raises(ValueError, match="features"):
        tloader.load_csv(p_t, num_features=7)
