"""decision_function_mesh (dpsvm_tpu_torch/predict.py) against the
single-device decision_function and the JAX package's
decision_function_mesh: support vectors row-sharded over
Mesh(["cpu"] * P), partial sums combined (tests/test_predict_mesh.py
mirrored). Within rtol / atol 1e-5 of the single device (ROADMAP C.24)
and 1e-4 of the JAX package's, the JAX test's."""

import numpy as np
import pytest

from dpsvm_tpu.models.svm_model import SVMModel as JaxModel
from dpsvm_tpu.predict import decision_function_mesh as jax_dec_mesh
from dpsvm_tpu_torch import Mesh, SVMConfig, decision_function, train
from dpsvm_tpu_torch.predict import decision_function_mesh


@pytest.fixture(scope="module")
def trained(blobs_small):
    x, y = blobs_small
    model, _ = train(x, y, SVMConfig(c=1.0, gamma=0.1, cache_lines=16),
                     device="cpu")
    return model, x


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_mesh_decision_matches_single(trained, n_dev):
    model, x = trained
    single = decision_function(model, x, device="cpu")
    got = decision_function_mesh(model, x, mesh=Mesh(["cpu"] * n_dev))
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-5)
    jm = JaxModel(sv_x=model.sv_x, sv_alpha=model.sv_alpha,
                  sv_y=model.sv_y, b=model.b, kernel=model.kernel)
    np.testing.assert_allclose(got, jax_dec_mesh(jm, x, num_devices=n_dev),
                               rtol=1e-4, atol=1e-4)


def test_mesh_decision_blocked_and_cached(trained):
    """Query blocks of 64 rows; the sharded support vectors are prepared
    once per mesh and reused (a second call uploads nothing new)."""
    model, x = trained
    mesh = Mesh(["cpu"] * 4)
    got = decision_function_mesh(model, x, mesh=mesh, block=64)
    np.testing.assert_allclose(got, decision_function(model, x,
                                                      device="cpu"),
                               rtol=1e-5, atol=1e-5)
    prepared = model._mesh_prepared
    assert prepared[0] == mesh.devices and len(prepared[1][0]) == 4
    again = decision_function_mesh(model, x, mesh=mesh)
    assert model._mesh_prepared is prepared
    np.testing.assert_allclose(again, got, rtol=1e-6, atol=1e-6)
    decision_function_mesh(model, x[:5], mesh=Mesh(["cpu"] * 2))
    assert model._mesh_prepared[0] == Mesh(["cpu"] * 2).devices


def test_mesh_decision_empty(trained):
    model, _ = trained
    out = decision_function_mesh(model, np.zeros((0, model.num_features)),
                                 mesh=Mesh(["cpu"] * 2))
    assert out.shape == (0,)
