"""The port's SVMConfig against the JAX package's: field names, defaults,
validation, and the knobs the port refuses until their engines land."""

import dataclasses

import numpy as np
import pytest

from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu_torch import SVMConfig, solve

PORT_FIELDS = [f.name for f in dataclasses.fields(SVMConfig)]


@pytest.mark.parametrize("name", PORT_FIELDS)
def test_field_name_and_default_match_jax(name):
    jax_fields = {f.name: f for f in dataclasses.fields(JaxConfig)}
    assert name in jax_fields, f"{name} is not a dpsvm_tpu SVMConfig field"
    mine, theirs = getattr(SVMConfig(), name), getattr(JaxConfig(), name)
    if dataclasses.is_dataclass(mine):  # obs: each package's ObsConfig
        mine, theirs = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    assert mine == theirs


def test_every_jax_field_is_carried():
    """A checkpoint carries its config as JSON: each package must take
    every field of the other's."""
    assert {f.name for f in dataclasses.fields(JaxConfig)} == set(PORT_FIELDS)


def test_block_path_fields_present():
    needed = {"c", "gamma", "epsilon", "max_iter", "kernel", "degree",
              "coef0", "weight_pos", "weight_neg", "selection", "engine",
              "working_set_size", "inner_iters", "pair_batch",
              "compensated", "budget_mode", "tau", "dtype", "cache_lines"}
    assert needed <= set(PORT_FIELDS)


@pytest.mark.parametrize("kw", [
    dict(c=10.0, weight_pos=2.0, weight_neg=0.5),
    dict(c=3.0),
])
def test_c_bounds_and_gamma_match_jax(kw):
    assert SVMConfig(**kw).c_bounds() == JaxConfig(**kw).c_bounds()
    for d in (1, 7, 784):
        assert SVMConfig(**kw).resolve_gamma(d) == JaxConfig(**kw).resolve_gamma(d)
        assert SVMConfig(gamma=0.125).resolve_gamma(d) == 0.125
    assert SVMConfig(**kw).replace(c=2.0).c == 2.0


@pytest.mark.parametrize("kw", [
    dict(c=0.0), dict(epsilon=-1.0), dict(kernel="cubic"),
    dict(dtype="float16"), dict(selection="wss3"), dict(engine="gpu"),
    dict(working_set_size=1), dict(pair_batch=3), dict(weight_neg=0.0),
    dict(inner_iters=-1),
])
def test_invalid_values_raise_like_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        SVMConfig(**kw)


_OBS = {"enabled": True, "trace_dir": None, "runlog_dir": None}
# The ooc cases that stood here run since ooc was ported, the active-set
# cases since the active-set engine was (both moved to LIFTED); their
# places hold the same knobs with the JAX-only obs field, which still
# refuses whatever else the config holds.
UNPORTED = [
    dict(reconcile_rounds=4, selection="second_order", obs=_OBS),
    dict(selection="second_order", active_set_size=64, obs=_OBS),
    dict(pair_batch=2, reconcile_rounds=2, obs=_OBS),
    dict(fused_fold=True, active_set_size=64, obs=_OBS),
    dict(active_set_size=64, obs=_OBS),
    dict(obs=_OBS),
]

# Knobs whose engines this port now has: check_ported passes them, and a
# tiny solve (x a Gram where the kernel is precomputed) converges.
LIFTED = [
    dict(engine="xla", kernel="precomputed"),
    dict(fused_fold=True, kernel="precomputed"),
    dict(pipeline_rounds=True, gram_resident=True),
    dict(gram_resident=True), dict(gram_resident=True, compensated=True),
    dict(kernel="precomputed"), dict(engine="xla", fleet_size=4),
    dict(ooc=True, selection="second_order"), dict(pair_batch=2, ooc=True),
    dict(ooc=True, ooc_tile_rows=16, active_set_size=16),
    dict(reconcile_rounds=4, selection="second_order"),
    dict(selection="second_order", active_set_size=16),
    dict(pair_batch=2, reconcile_rounds=2, active_set_size=16),
    dict(fused_fold=True, active_set_size=16),
    dict(active_set_size=16),
]


@pytest.mark.parametrize("kw", LIFTED)
def test_lifted_knobs_pass_and_solve(kw):
    cfg = SVMConfig(**{"engine": "block", "working_set_size": 8,
                       "gamma": 0.5, **kw})
    cfg.check_ported()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = np.where(x[:, 0] > 0, 1, -1).astype(np.int32)
    if cfg.kernel == "precomputed":
        sq = (x.astype(np.float64) ** 2).sum(1)
        x = np.exp(-0.5 * np.maximum(
            sq[:, None] + sq[None, :] - 2.0 * x.astype(np.float64) @ x.T,
            0.0)).astype(np.float32)
    assert solve(x, y, cfg, device="cpu").converged


@pytest.mark.parametrize("kw", UNPORTED)
def test_unported_knobs_raise(kw):
    cfg = SVMConfig(**{"engine": "block", **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.check_ported()
    x = np.zeros((4, 2), np.float32)
    y = np.array([1, -1, 1, -1], np.int32)
    with pytest.raises(NotImplementedError):
        solve(x, y, cfg, device="cpu")


def test_ported_block_config_passes():
    SVMConfig(engine="block", selection="second_order", compensated=True,
              budget_mode=True, dtype="bfloat16", fused_fold=False,
              pipeline_rounds=False).check_ported()


@pytest.mark.parametrize("kw", [dict(fused_fold=True),
                                dict(fused_round=True),
                                dict(pipeline_rounds=True)])
def test_fused_round_knobs_are_ported(kw):
    SVMConfig(engine="block", **kw).check_ported()


@pytest.mark.parametrize("kw", [
    dict(), dict(engine="xla", selection="second_order"),
    dict(engine="pallas"), dict(engine="pallas", cache_lines=256),
    dict(engine="xla", pair_batch=2), dict(engine="xla", pair_batch=4),
    dict(engine="xla", pair_batch=8, gram_resident=True),
    dict(engine="xla", gram_resident=True, compensated=True),
    dict(engine="xla", gram_resident=False, cache_lines=512),
    dict(engine="xla", cache_lines=64, selection="second_order"),
])
def test_per_pair_knobs_are_ported(kw):
    """The per-pair engines and their knobs pass check_ported (and the
    JAX package's validation)."""
    JaxConfig(**kw)
    SVMConfig(**kw).check_ported()


PAIR_CLASHES = [
    (dict(engine="pallas", selection="second_order"), "mvp"),
    (dict(engine="pallas", compensated=True), "compensated"),
    (dict(engine="pallas", gram_resident=True), "gram_resident"),
    (dict(engine="pallas", pair_batch=2), "pallas"),
    (dict(engine="xla", pair_batch=4, selection="second_order"), "mvp"),
    (dict(engine="block", pair_batch=8), "block subproblem"),
    (dict(engine="xla", kernel="precomputed", cache_lines=8),
     "nothing to cache"),
    (dict(engine="pallas", kernel="precomputed"), "pallas"),
    (dict(engine="xla", kernel="precomputed", gram_resident=True),
     "already IS a resident Gram"),
    (dict(engine="block", kernel="precomputed", active_set_size=64),
     "active-set"),
]


@pytest.mark.parametrize("kw,match", PAIR_CLASHES)
def test_per_pair_validation_matches_jax(kw, match):
    with pytest.raises(ValueError, match=match):
        JaxConfig(**kw)
    with pytest.raises(ValueError, match=match):
        SVMConfig(**kw)


@pytest.mark.parametrize("pair_batch", [2, 4])
@pytest.mark.parametrize("kw", [dict(), dict(fused_fold=True),
                                dict(pipeline_rounds=True)])
def test_block_pair_batch_is_ported_and_runs(pair_batch, kw):
    """pair_batch 2/4 on the block engines passes check_ported and
    trains (the refusal it replaces named ROADMAP item 5b)."""
    from dpsvm_tpu.data.synth import make_blobs_binary

    cfg = SVMConfig(engine="block", pair_batch=pair_batch, c=2.0, gamma=0.2,
                    working_set_size=16, **kw)
    JaxConfig(engine="block", pair_batch=pair_batch, **kw)
    cfg.check_ported()
    x, y = make_blobs_binary(n=120, d=6, seed=1, sep=1.5)
    res = solve(x, y, cfg, device="cpu")
    assert res.converged and res.iterations > 0


MESH_KNOBS = [
    dict(local_working_sets=1), dict(local_working_sets=2),
    dict(local_working_sets=4, sync_rounds=3, compensated=True),
    dict(ring_exchange=True), dict(ring_exchange=False),
    dict(ring_exchange=True, local_working_sets=2, sync_rounds=2),
    dict(ring_exchange=True, pipeline_rounds=True),
]


@pytest.mark.parametrize("kw", MESH_KNOBS)
def test_mesh_knobs_construct_like_jax(kw):
    JaxConfig(engine="block", **kw)
    SVMConfig(engine="block", **kw).check_ported()


MESH_CLASHES = [
    (dict(engine="xla", local_working_sets=2), "block-engine"),
    (dict(local_working_sets=2, budget_mode=True), "budget_mode"),
    (dict(local_working_sets=2, active_set_size=64), "active_set_size"),
    (dict(local_working_sets=2, pipeline_rounds=True), "pipeline_rounds"),
    (dict(local_working_sets=2, kernel="precomputed"), "feature kernels"),
    (dict(local_working_sets=0), "local_working_sets"),
    (dict(sync_rounds=0), "sync_rounds"),
    (dict(sync_rounds=4), "local_working_sets >= 2"),
    (dict(sync_rounds=4, local_working_sets=1), "local_working_sets >= 2"),
    (dict(engine="xla", ring_exchange=True), "block-engine"),
    (dict(ring_exchange=True, kernel="precomputed"), "feature kernels"),
    (dict(ring_exchange=True, ooc=True), "ooc"),
    (dict(ring_exchange=True, active_set_size=64), "active_set_size"),
    (dict(ring_exchange=True, fused_fold=True), "fused_fold"),
]


@pytest.mark.parametrize("kw,match", MESH_CLASHES)
def test_mesh_knob_validation_matches_jax(kw, match):
    kw = {"engine": "block", **kw}
    with pytest.raises(ValueError, match=match):
        JaxConfig(**kw)
    with pytest.raises(ValueError, match=match):
        SVMConfig(**kw)


@pytest.mark.parametrize("kw,item", [
    # The active-set engine runs, on one device and on the mesh (item
    # None).
    (dict(engine="block", active_set_size=64), None),
    # ooc runs on one device since item 8; on the mesh it names 10b.
    (dict(engine="block", ooc=True), "item 10b"),
])
def test_still_refused_knobs_name_their_roadmap_item(kw, item):
    from dpsvm_tpu_torch import Mesh, solve_mesh

    cfg = SVMConfig(**kw, working_set_size=8, gamma=0.5)
    cfg.check_ported()  # one device runs both
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = np.where(x[:, 0] > 0, 1, -1).astype(np.int32)
    if item is None:
        res = solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2))
        # m clamped to 2 n_loc: 40 rows pad to two shards of 24.
        assert res.converged and res.stats["active_set_size"] == 48
        return
    with pytest.raises(NotImplementedError, match=item):
        solve_mesh(x, y, cfg, mesh=Mesh(["cpu"] * 2))


JAX_ONLY = [
    # The active-set engines are ported: accepted, item None.
    (dict(reconcile_rounds=4), None),
    # The ooc fields are ported (item 8): accepted, item None.
    (dict(ooc=True, ooc_tile_rows=1024, engine="block"), None),
    (dict(ooc=True, ooc_cache_lines=256, engine="block"), None),
    (dict(ooc=True, ooc_shrink=True, engine="block"), None),
    (dict(obs={"enabled": True, "trace_dir": None, "runlog_dir": None}),
     "item 11"),
]


@pytest.mark.parametrize("kw,item", JAX_ONLY)
def test_jax_only_fields_refuse_naming_their_item(kw, item):
    """Fields the port carries only so configs load: any value but the
    default is refused with the ROADMAP item that ports them. The ooc
    fields (item 8) and reconcile_rounds (the active-set engines), ported
    since, pass both checks."""
    cfg = SVMConfig(**kw)
    JaxConfig(**kw)  # a valid JAX config
    if item is None:
        cfg.check_jax_only()
        cfg.check_ported()
        return
    with pytest.raises(NotImplementedError, match=item):
        cfg.check_jax_only()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.check_ported()


def test_jax_only_fields_at_defaults_pass():
    SVMConfig(retry_faults=0, verbose=True, check_numerics=True,
              chunk_iters=64, checkpoint_every=8, checkpoint_keep=3,
              matmul_precision="high").check_ported()


@pytest.mark.parametrize("kw", [
    dict(fleet_size=3), dict(fleet_size=128), dict(reconcile_rounds=0),
    dict(reconstruct_every=-1), dict(reconstruct_every=10, budget_mode=True),
    dict(bf16_gram=True, dtype="bfloat16"),
    dict(bf16_gram=True, kernel="precomputed"), dict(ooc_shrink=True),
    dict(ooc_tile_rows=4), dict(ooc_cache_lines=-1),
    dict(ooc_cache_lines=256), dict(matmul_precision="fast"),
    dict(retry_faults=-1), dict(checkpoint_keep=0),
    dict(checkpoint_keep=150), dict(chunk_iters=0),
    dict(engine="xla", active_set_size=64),
    dict(ooc=True, engine="xla"), dict(ooc=True, engine="block",
                                       reconstruct_every=100),
])
def test_state_knob_validation_matches_jax(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        SVMConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(compensated=True), dict(reconstruct_every=10_000),
    dict(compensated=True, matmul_precision="default"),
    dict(matmul_precision="high"), dict(matmul_precision="highest"),
])
def test_precision_resolution_matches_jax(kw):
    assert SVMConfig(**kw).resolve_precision() == \
        JaxConfig(**kw).resolve_precision()


@pytest.mark.parametrize("case", ["accepted", "refused"])
def test_bf16_gram_gate_and_stats_match_jax(case):
    """bf16_gram=True is ported: the solve runs the gate (ops/kernels.py
    resolve_bf16_gram), stores X in bfloat16 where it accepts, stays
    float32 and warns where it refuses, and reports the decision in
    stats["bf16_gram"], as the JAX package's solve does."""
    import warnings

    from dpsvm_tpu.solver.smo import solve as jsolve
    from dpsvm_tpu_torch.data.synth import (make_blobs_binary,
                                            make_covtype_like)

    if case == "accepted":
        x, y = make_blobs_binary(n=300, d=10, seed=3, sep=1.2)
        kw = dict(c=1.0, gamma=0.1, engine="block", working_set_size=16)
    else:
        x, y = make_covtype_like(2000, seed=0)
        kw = dict(c=1000.0, gamma=0.1, engine="block", max_iter=64)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        res = solve(x, y, SVMConfig(bf16_gram=True, **kw), device="cpu")
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jres = jsolve(x, y, JaxConfig(bf16_gram=True, **kw))
    assert res.stats["bf16_gram"] == jres.stats["bf16_gram"]
    assert res.stats["bf16_gram"]["active"] == (case == "accepted")
    refusals = [str(w.message) for w in tw if "REFUSED" in str(w.message)]
    assert refusals == [str(w.message) for w in jw
                        if "REFUSED" in str(w.message)]
    assert len(refusals) == (case == "refused")
    # The stored X: bfloat16 where accepted, float32 where refused.
    stored = SVMConfig(dtype="bfloat16" if case == "accepted" else
                       "float32", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        same = solve(x, y, stored, device="cpu")
    np.testing.assert_array_equal(res.alpha, same.alpha)
    assert res.iterations == same.iterations


# ------------------------------------------------------------ ServeConfig

def _serve_fields():
    from dpsvm_tpu.config import ServeConfig as JaxServeConfig
    from dpsvm_tpu_torch.config import ServeConfig

    return (ServeConfig, JaxServeConfig,
            {f.name: f for f in dataclasses.fields(JaxServeConfig)})


def test_serve_config_fields_and_defaults_match_jax():
    ServeConfig, JaxServeConfig, jf = _serve_fields()
    tf = {f.name: f for f in dataclasses.fields(ServeConfig)}
    assert list(tf) == list(jf)
    for name in tf:
        if name != "obs":
            assert getattr(ServeConfig(), name) == \
                getattr(JaxServeConfig(), name), name
    assert ServeConfig().effective_union_storage() == "f32"
    assert ServeConfig(dtype="bfloat16").effective_union_storage() == "bf16"
    assert ServeConfig(listen="0.0.0.0:8080").listen_addr() == \
        ("0.0.0.0", 8080)


# Values each field is drawn from: its default, valid values and
# values one of the two packages' checks refuses.
_SERVE_DRAWS = {
    "buckets": [None, (16, 64), (), (3,), (64, 16), (16, 16), (1,),
                (16, 4096, 8192)],
    "dtype": ["float32", "bfloat16", "float16"],
    "union_storage": [None, "f32", "bf16", "int8", "auto", "fp8"],
    "precision": ["auto", "float32", "float64", "half"],
    "num_devices": [1, 2, 0],
    "warm_start": [True, False],
    "max_pending": [65536, 4096, 100, 16],
    "metrics_port": [None, 0, 9100, 70000, -1],
    "metrics_host": ["127.0.0.1", ""],
    "slo_ms": [50.0, 0.0, 1.0],
    "deadline_ms": [None, 10.0, 0.0, -1.0],
    "dispatch_timeout_ms": [None, 100.0, 0.0],
    "journal_path": [None, "j.json", ""],
    "listen": [None, "127.0.0.1:0", "host:99999", "nohostport", ":80"],
    "replicas": [1, 2, 0],
    "device_floor_us_per_row": [None, 1.5, 0.0],
    "admission_max_rows": [None, 8, 0, 1 << 20],
    "admission_retry_ms": [50.0, 0.0],
    "conn_read_timeout_ms": [30000.0, 0.0],
    "conn_write_timeout_ms": [10000.0, -1.0],
    "max_frame_bytes": [64 * 1024 * 1024, 4096, 100],
}


@pytest.mark.parametrize("seed", range(8))
def test_serve_config_random_combinations_raise_like_jax(seed):
    """Random field combinations: the same exception type in both
    packages, or none."""
    ServeConfig, JaxServeConfig, _ = _serve_fields()
    rng = np.random.default_rng(seed)
    for _ in range(250):
        kw = {}
        for name, values in _SERVE_DRAWS.items():
            if rng.random() < 0.3:
                kw[name] = values[rng.integers(len(values))]
        out = []
        for cls in (ServeConfig, JaxServeConfig):
            try:
                cls(**kw)
                out.append(None)
            except Exception as e:  # noqa: BLE001 - the type is compared
                out.append(type(e))
        assert out[0] is out[1], (kw, out)


def test_serve_config_obs_refused_naming_item_11():
    from dpsvm_tpu_torch.config import ObsConfig, ServeConfig
    from dpsvm_tpu_torch.serve import PredictServer
    from dpsvm_tpu_torch.serving import ReplicaFleet, ServingEngine

    cfg = ServeConfig(obs=ObsConfig(enabled=True))
    with pytest.raises(NotImplementedError, match="item 11"):
        cfg.check_ported()
    for make in (lambda: ServingEngine(cfg, device="cpu"),
                 lambda: ReplicaFleet(cfg, device="cpu"),
                 lambda: PredictServer(None, cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="item 11"):
            make()
    ServeConfig().check_ported()
