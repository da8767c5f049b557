"""The port's v2 serving engine (dpsvm_tpu_torch/serving) against the
JAX package's on the same models and queries: the registry and its
versions, hot swap (from an admin thread under load too), EDF forming,
expiry, coalescing, the journal replayed across the packages, model
bundles served across the packages, the serve_dispatch and serve_stall
seams, the scheduler's accounting under concurrent submits, and the
OpenMetrics families JAX exports.

Tolerances: decisions rtol 1e-5, atol 1e-5 against JAX's engine;
labels, verdicts and versions equal."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from dpsvm_tpu.config import ServeConfig as JaxServeConfig
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models import multiclass as jmc
from dpsvm_tpu.models.svm_model import SVMModel as JaxModel
from dpsvm_tpu.ops.kernels import KernelParams as JaxKP
from dpsvm_tpu.serving import ServingEngine as JaxEngine
from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.convert import (model_from_reference,
                                     multiclass_from_reference)
from dpsvm_tpu_torch.models.multiclass import MulticlassSVM
from dpsvm_tpu_torch.serving import (ModelLoadError, ModelRegistry,
                                     ServingEngine, load_model_file)
from dpsvm_tpu_torch.serving.scheduler import Scheduler
from dpsvm_tpu_torch.testing import faults

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = JaxConfig(c=5.0, gamma=0.25, epsilon=1e-3, chunk_iters=256)


@pytest.fixture(scope="module")
def two_versions():
    """(JAX v1, JAX v2, port v1, port v2, x): one problem at two Cs,
    so the versions have different unions (a retrain swap)."""
    rng = np.random.default_rng(31)
    xs, ys = [], []
    for k in range(3):
        c = np.zeros(5, np.float32)
        c[k] = 2.5
        xs.append(rng.normal(size=(70, 5)).astype(np.float32) * 0.7 + c)
        ys.append(np.full(70, k))
    x, y = np.concatenate(xs), np.concatenate(ys)
    m1, _ = jmc.train_multiclass(x, y, CFG, strategy="ovr")
    m2, _ = jmc.train_multiclass(x, y, CFG.replace(c=1.5), strategy="ovr")
    return (m1, m2, multiclass_from_reference(m1),
            multiclass_from_reference(m2), np.asarray(x, np.float32))


@pytest.fixture()
def files(two_versions, tmp_path):
    """v1 saved by the JAX package, v2 by the port."""
    m1, _, _, t2, _ = two_versions
    p1, p2 = str(tmp_path / "v1_jax.npz"), str(tmp_path / "v2_port.npz")
    m1.save(p1)
    t2.save(p2)
    return p1, p2


def _engine(**kw):
    kw.setdefault("buckets", (16, 64))
    return ServingEngine(ServeConfig(**kw), device="cpu")


def _jax_engine(**kw):
    kw.setdefault("buckets", (16, 64))
    return JaxEngine(JaxServeConfig(**kw))


def test_engine_parity_with_jax_engine(two_versions):
    m1, _, t1, _, x = two_versions
    eng, jeng = _engine(), _jax_engine()
    try:
        eng.register("m", t1)
        jeng.register("m", m1)
        q = x[:50]
        np.testing.assert_allclose(eng.decision(q), jeng.decision(q), **TOL)
        np.testing.assert_array_equal(eng.predict(q), jeng.predict(q))
        assert eng._dispatches == jeng._dispatches
        assert set(eng.snapshot()) == set(jeng.snapshot())
        assert eng.snapshot()["compiles"] == 0
    finally:
        eng.close()
        jeng.close()


def test_registry_versions_and_routing(files, two_versions):
    p1, p2 = files
    _, m2, _, _, x = two_versions
    eng = _engine()
    e1 = eng.register("m", p1)
    assert (e1.version, e1.source) == (1, p1)
    assert eng.swap("m", p2).version == 2
    jeng = _jax_engine()
    jeng.register("m", m2)
    np.testing.assert_allclose(eng.decision(x[:20]), jeng.decision(x[:20]),
                               **TOL)
    assert eng.hot_swaps.value == 1
    with pytest.raises(KeyError, match="no model"):
        eng.swap("typo", p1)
    eng.register("second", p1)
    with pytest.raises(KeyError, match="name required"):
        eng.registry.get(None)
    eng.close()
    jeng.close()


def test_hot_swap_under_sustained_submits(files, two_versions):
    """Requests keep arriving across the swap: none lost or failed,
    every pre-swap request answered by v1 and every later one by v2,
    each within tolerance of JAX's engine on that version."""
    p1, p2 = files
    m1, m2, _, _, x = two_versions
    refs = {}
    for v, m in ((1, m1), (2, m2)):
        j = _jax_engine()
        j.register("m", m)
        refs[v] = j.decision(x)
        j.close()
    eng = _engine()
    eng.register("m", p1)
    tickets = {}
    for i in range(20):
        if i == 10:
            eng.swap("m", p2)
        tickets[eng.submit(x[i * 4:(i + 1) * 4])] = (1 if i < 10 else 2, i)
        if i % 3 == 0:
            eng.pump()
    done = eng.drain()
    assert sorted(done) == sorted(tickets)
    for t, (v, i) in tickets.items():
        assert done[t].verdict == "ok" and done[t].version == v
        np.testing.assert_allclose(done[t].decision,
                                   refs[v][i * 4:(i + 1) * 4], **TOL)
    eng.close()


def test_hot_swap_from_an_admin_thread_loses_nothing(files, two_versions):
    p1, p2 = files
    x = two_versions[-1]
    eng = _engine()
    eng.register("m", p1)
    swapped = threading.Event()

    def admin():
        for _ in range(3):
            eng.swap("m", p2)
            eng.swap("m", p1)
        swapped.set()

    th = threading.Thread(target=admin, name="dpsvm-test-admin")
    th.start()
    tickets, versions = [], []
    deadline = time.monotonic() + 30.0
    while (not swapped.is_set() or len(tickets) < 50) \
            and time.monotonic() < deadline:
        tickets.append(eng.submit(x[:5]))
        for res in eng.results().values():
            versions.append(res.version)
        eng.pump()
    th.join(timeout=30.0)
    assert not th.is_alive()
    done = eng.drain()
    versions += [r.version for r in done.values()]
    assert len(versions) == len(tickets)
    assert all(r.verdict == "ok" for r in done.values())
    assert eng.registry.get("m").version == 7
    assert eng.hot_swaps.value == 6
    eng.close()


def test_corrupted_files_leave_the_live_version(files, two_versions,
                                                tmp_path):
    p1, p2 = files
    x = two_versions[-1]
    eng = _engine()
    eng.register("m", p1)
    ref = eng.decision(x[:20])
    raw = open(p1, "rb").read()
    bad = []
    for name, data in (("trunc.npz", raw[:len(raw) // 2]),
                       ("junk.npz", b"not a zip at all")):
        bad.append(str(tmp_path / name))
        open(bad[-1], "wb").write(data)
    bad.append(str(tmp_path / "partial.npz"))
    np.savez(bad[-1], model_type="multiclass", strategy="ovr",
             classes=np.arange(3), n_models=3)
    for path in bad:
        with pytest.raises(ModelLoadError):
            eng.swap("m", path)
    with faults.install(faults.FaultPlan.parse("swap_corrupt")) as plan:
        with pytest.raises(ModelLoadError):
            eng.swap("m", p2)
    assert plan.fired["swap_corrupt"] == 1
    assert eng.registry.get("m").version == 1
    np.testing.assert_array_equal(eng.decision(x[:20]), ref)
    assert eng.hot_swaps.value == 0
    svr = str(tmp_path / "svr.npz")
    np.savez(svr, model_type="svr")
    with pytest.raises(ModelLoadError, match="svr"):
        load_model_file(svr)
    eng.close()


def test_registry_prepare_failure_is_atomic(files):
    p1, p2 = files
    fail = [False]

    def prepare(entry):
        if fail[0]:
            fail[0] = False
            raise RuntimeError("synthetic staging failure")

    reg = ModelRegistry(prepare=prepare)
    reg.register("m", p1)
    fail[0] = True
    with pytest.raises(RuntimeError):
        reg.register("m", p2)
    assert reg.get("m").version == 1
    assert reg.register("m", p2).version == 2


def test_expired_and_late_verdicts(two_versions, monkeypatch):
    _, _, t1, _, x = two_versions
    eng = _engine()
    eng.register("m", t1)
    t = eng.submit(x[:4], deadline_ms=1e-4)
    time.sleep(0.005)
    done = eng.drain()
    assert done[t].verdict == "expired" and done[t].decision is None
    assert eng.expired.value == eng.deadline_misses.value == 1
    ref = eng.decision(x[:4])
    t = eng.submit(x[:4], deadline_ms=50.0)
    orig = eng._dispatcher._materialize

    def slow(item, _orig=orig):
        time.sleep(0.08)
        return _orig(item)

    monkeypatch.setattr(eng._dispatcher, "_materialize", slow)
    done = eng.drain()
    assert done[t].verdict == "late"
    np.testing.assert_array_equal(done[t].decision, ref)
    assert eng.deadline_misses.value == 2 and eng.expired.value == 1
    eng.close()


def test_edf_forming_and_backpressure(two_versions):
    _, _, t1, _, x = two_versions
    eng = _engine(buckets=(16,), max_pending=32)
    eng.register("m", t1)
    loose = [eng.submit(x[i * 8:(i + 1) * 8], deadline_ms=10_000.0)
             for i in range(2)]
    tight = eng.submit(x[16:24], deadline_ms=500.0)  # arrives last
    eng.pump()
    eng.pump()
    done = eng.results()
    assert tight in done and not all(t in done for t in loose)
    eng.drain()
    for _ in range(12):  # 96 rows through max_pending 32
        eng.submit(x[:8])
        assert eng.scheduler.queue_rows < 32 + 8
    eng.drain()
    eng.close()


def test_coalescing_matches_jax(two_versions):
    m1, m2, t1, t2, x = two_versions
    eng, jeng = _engine(), _jax_engine()
    for e, (a, b) in ((eng, (t1, t2)), (jeng, (m1, m2))):
        e.register("a", a)
        e.register("a2", a)  # the same union bytes: one group
        e.register("b", b)
    out = {}
    for e in (eng, jeng):
        d0 = e._dispatches
        ts = [e.submit(x[:10], model="a"), e.submit(x[10:30], model="a2"),
              e.submit(x[:8], model="b")]
        done = e.drain()
        out[e is eng] = ([done[t].decision for t in ts],
                         e._dispatches - d0, e.coalesced.value)
    (dt, nt, ct), (dj, nj, cj) = out[True], out[False]
    assert (nt, ct) == (nj, cj) == (2, 1)
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(a, b, **TOL)
    eng.close()
    jeng.close()


def test_oversized_binary_f64_and_empty_match_jax():
    rng = np.random.default_rng(2)
    big = JaxModel(
        sv_x=rng.normal(size=(600, 8)).astype(np.float32),
        sv_alpha=(rng.random(600).astype(np.float32) + 0.01) * 6e5,
        sv_y=np.where(rng.random(600) < 0.5, 1, -1).astype(np.int32),
        b=0.05, kernel=JaxKP("rbf", 0.3))
    small = JaxModel(
        sv_x=rng.normal(size=(50, 8)).astype(np.float32),
        sv_alpha=rng.random(50).astype(np.float32) + 0.01,
        sv_y=np.where(rng.random(50) < 0.5, 1, -1).astype(np.int32),
        b=0.05, kernel=JaxKP("rbf", 0.3))
    kp = JaxKP("rbf", 0.25)
    empty = jmc.MulticlassSVM(classes=np.arange(2), strategy="ovr", models=[
        JaxModel(sv_x=np.zeros((0, 8), np.float32),
                 sv_alpha=np.zeros((0,), np.float32),
                 sv_y=np.zeros((0,), np.int32), b=b0, kernel=kp)
        for b0 in (0.5, -0.25)])
    eng, jeng = _engine(buckets=(16,)), _jax_engine(buckets=(16,))
    eng.register("big", model_from_reference(big))
    eng.register("small", model_from_reference(small))
    eng.register("empty", multiclass_from_reference(empty))
    for name, m in (("big", big), ("small", small), ("empty", empty)):
        jeng.register(name, m)
    assert eng.registry.get("big").f64_cols.size == 1
    q64 = (rng.normal(size=(40, 8)) * (1 + 1e-9)).astype(np.float64)
    np.testing.assert_allclose(eng.decision(q64, "big"),
                               jeng.decision(q64, "big"), rtol=1e-12)
    np.testing.assert_allclose(eng.decision(q64, "small"),
                               jeng.decision(q64, "small"), **TOL)
    np.testing.assert_array_equal(eng.decision(q64, "empty"),
                                  jeng.decision(q64, "empty"))
    np.testing.assert_array_equal(eng.predict(q64, "small"),
                                  jeng.predict(q64, "small"))
    with pytest.raises(ValueError, match="must be"):
        eng.submit(np.zeros((4, 3), np.float32), "small")
    eng.close()
    jeng.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_replays_across_packages(files, two_versions, tmp_path,
                                         writer):
    """An engine of one package writes the journal and dies; an engine
    of the other replays it: the same names and versions, decisions
    within tolerance; an unregister shrinks it for both."""
    p1, p2 = files
    x = two_versions[-1]
    jp = str(tmp_path / "registry.journal")
    first = (_jax_engine if writer == "jax" else _engine)(journal_path=jp)
    first.register("m", p1)
    first.swap("m", p2)
    first.register("aux", p1)
    pre = {n: first.decision(x[:16], model=n) for n in ("m", "aux")}
    del first  # a crash: close() never runs
    assert json.load(open(jp))["format_version"] == 1
    second = (_engine if writer == "jax" else _jax_engine)(journal_path=jp)
    assert sorted(second._rehydrated) == ["aux", "m"]
    assert second.registry.get("m").version == 2
    assert second.registry.get("aux").version == 1
    for n in ("m", "aux"):
        np.testing.assert_allclose(second.decision(x[:16], model=n),
                                   pre[n], **TOL)
    second.unregister("aux")
    second.close()
    third = (_jax_engine if writer == "jax" else _engine)(journal_path=jp)
    assert third.registry.names() == ["m"]
    third.close()


def test_journal_skips_objects_and_refuses_a_torn_file(two_versions,
                                                       tmp_path):
    t1 = two_versions[2]
    jp = str(tmp_path / "registry.journal")
    eng = _engine(journal_path=jp)
    eng.register("obj", t1)
    eng.close()
    assert json.load(open(jp))["models"] == {}
    with open(jp, "w") as fh:
        fh.write('{"format_version": 1, "models": {tor')
    with pytest.raises(ValueError, match="journal"):
        _engine(journal_path=jp)


def test_bundles_serve_in_both_engines(files, two_versions):
    p1, p2 = files  # p1 written by JAX, p2 by the port
    eng, jeng = _engine(), _jax_engine()
    x = two_versions[-1]
    for p in (p1, p2):
        eng.register("m", p) if "m" not in eng.registry else eng.swap("m", p)
        jeng.register("m", p) if "m" not in jeng.registry \
            else jeng.swap("m", p)
        np.testing.assert_allclose(eng.decision(x[:30]),
                                   jeng.decision(x[:30]), **TOL)
        np.testing.assert_array_equal(eng.predict(x[:30]),
                                      jeng.predict(x[:30]))
    assert isinstance(load_model_file(p1), MulticlassSVM)
    eng.close()
    jeng.close()


def test_dispatch_seam_fails_the_batch_and_serving_goes_on(two_versions):
    t1, x = two_versions[2], two_versions[-1]
    eng = _engine()
    eng.register("m", t1)
    ref = eng.decision(x[:12])
    with faults.install(faults.FaultPlan.parse("serve_dispatch@1")) as plan:
        ticket = eng.submit(x[:12])
        done = eng.drain()
    assert plan.fired["serve_dispatch"] == 1
    res = done[ticket]
    assert res.verdict == "failed" and res.decision is None
    assert res.labels() is None
    assert eng.snapshot()["per_model"]["m"]["dispatch_failures"] == 1
    np.testing.assert_array_equal(eng.decision(x[:12]), ref)
    big = np.repeat(x[:20], 10, axis=0)  # 200 rows: 4 top-bucket segments
    with faults.install(faults.FaultPlan.parse("serve_dispatch@2")) as plan:
        ticket = eng.submit(big)
        done = eng.drain()
    assert done[ticket].verdict == "failed"
    assert plan.arrivals["serve_dispatch"] == 2  # the dead chain stopped
    assert eng.dispatch_failures.value == 2
    eng.close()


def test_watchdog_bounds_a_stalled_batch(two_versions, monkeypatch):
    monkeypatch.setattr(faults, "STALL_SECONDS", 3.0)
    t1, x = two_versions[2], two_versions[-1]
    eng = _engine(dispatch_timeout_ms=150.0)
    eng.register("m", t1)
    ref = eng.decision(x[:12])
    with faults.install(faults.FaultPlan.parse("serve_stall@1")) as plan:
        ticket = eng.submit(x[:12])
        t0 = time.perf_counter()
        done = eng.drain()
        bounded = time.perf_counter() - t0
    assert plan.fired["serve_stall"] == 1
    assert done[ticket].verdict == "failed" and bounded < 2.0
    assert eng.watchdog_trips.value == 1
    np.testing.assert_array_equal(eng.decision(x[:12]), ref)
    eng.close()


class _Entry:
    """A stand-in LoadedModel for scheduler tests (identity semantics)."""

    def __init__(self, name):
        self.name = name

    def group_key(self, dtype):
        return ("g", dtype)


def test_scheduler_concurrent_submit_accounting():
    sched = Scheduler()
    entries = [_Entry(f"m{i}") for i in range(4)]
    per, start = 200, threading.Barrier(4)

    def admit(entry, tid):
        start.wait()
        for i in range(per):
            sched.submit(entry, np.zeros((3, 2), np.float32), now=0.0,
                         deadline_s=None, ticket=tid * per + i, dtype="f32")

    threads = [threading.Thread(target=admit, args=(e, t),
                                name=f"dpsvm-test-admit-{t}")
               for t, e in enumerate(entries)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30.0)
    n = 4 * per
    assert sched.queue_depth == n and sched.queue_rows == 3 * n
    batch, expired = sched.form(("g", "f32"), now=0.0, max_rows=10 ** 9)
    assert expired == [] and sorted(r.seq for r in batch) == \
        list(range(1, n + 1))
    assert sched.queue_rows == 0 and sched.pending_entries() == set()


def _families(text):
    return sorted(ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE"))


def test_openmetrics_families_match_jax(two_versions):
    m1, m2, t1, t2, x = two_versions
    eng, jeng = _engine(metrics_port=0), _jax_engine()
    for e, (a, b) in ((eng, (t1, t2)), (jeng, (m1, m2))):
        e.register("a", a)
        e.register("b", b)
        e.submit(x[:12], model="a")
        e.submit(x[:12], model="b", deadline_ms=1e-4)
        time.sleep(0.002)
        e.drain()
        e.swap("a", b)
    assert _families(eng.render_openmetrics()) == \
        _families(jeng.render_openmetrics())
    with urllib.request.urlopen(eng.exporter.url, timeout=10) as resp:
        text = resp.read().decode()
    assert text.endswith("# EOF\n")
    for line in ('serving_requests_total{model="a"} 1',
                 'serving_deadline_misses_total{model="b"} 1',
                 'serving_hot_swaps_total{model="a"} 1',
                 'serving_model_version{model="a"} 2',
                 'serving_compiles_total 0'):
        assert line in text
    eng.close()
    jeng.close()


def test_mesh_engine_matches_one_shard(two_versions):
    t1, x = two_versions[2], two_versions[-1]
    one, mesh = _engine(), _engine(num_devices=2)
    one.register("m", t1)
    mesh.register("m", t1)
    assert mesh.snapshot()["union_mesh_devices"] == 2
    assert next(iter(mesh._groups.values())).mesh_devices == 2
    np.testing.assert_allclose(mesh.decision(x[:40]), one.decision(x[:40]),
                               **TOL)
    one.close()
    mesh.close()
