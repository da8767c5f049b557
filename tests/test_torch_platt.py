"""Platt calibration in the port (dpsvm_tpu_torch/models/platt.py, its
own copy of the JAX module's NumPy) against dpsvm_tpu/models/platt.py:
fit_platt and fit_platt_cv give JAX's (A, B) on the same inputs to 1e-6,
and the probability helpers give JAX's values bit for bit."""

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models import platt as jplatt
from dpsvm_tpu_torch import SVMConfig
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.models import platt as tplatt


@pytest.mark.parametrize("seed", range(4))
def test_fit_platt_is_jaxs(seed):
    rng = np.random.default_rng(seed)
    n = 200
    y = np.where(rng.random(n) < 0.3 + 0.1 * seed, 1, -1)
    dec = y * rng.gamma(2.0, 0.5, n) + rng.normal(0.0, 0.8, n)
    got, want = tplatt.fit_platt(dec, y), jplatt.fit_platt(dec, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0] > 0  # p rises with the decision


def test_fit_platt_refuses_one_class():
    for mod in (tplatt, jplatt):
        with pytest.raises(ValueError, match="both classes"):
            mod.fit_platt(np.ones(5), np.ones(5))


def test_probability_helpers_are_jaxs_bitwise():
    rng = np.random.default_rng(7)
    dec = rng.normal(0.0, 3.0, (40, 4))
    dec[0, 0] = 1e6  # the clip
    ab = rng.normal(0.0, 2.0, (4, 2))
    np.testing.assert_array_equal(
        tplatt.platt_probability(dec[:, 0], *ab[0]),
        jplatt.platt_probability(dec[:, 0], *ab[0]))
    np.testing.assert_array_equal(tplatt.platt_probability_matrix(dec, ab),
                                  jplatt.platt_probability_matrix(dec, ab))
    with pytest.raises(ValueError, match="expected"):
        tplatt.platt_probability_matrix(dec, ab[:3])


def test_fit_platt_cv_is_jaxs():
    """The folds refit on the host reference backend (the same NumPy SMO
    in both packages), so the held-out decisions, and with them (A, B),
    agree to 1e-6."""
    x, y = make_blobs_binary(n=120, d=4, seed=5, sep=1.0)
    kw = dict(c=1.0, gamma=0.3, epsilon=1e-3)
    got = tplatt.fit_platt_cv(x, y, SVMConfig(**kw), backend="reference",
                              k=3, device="cpu")
    want = jplatt.fit_platt_cv(x, y, JaxConfig(**kw), backend="reference",
                               k=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The default trainer on the device path lands near them.
    dev = tplatt.fit_platt_cv(x, y, SVMConfig(**kw), k=3, device="cpu")
    np.testing.assert_allclose(dev, want, rtol=0, atol=1e-2)
