"""The port's replica fleet (dpsvm_tpu_torch/serving/replicas.py) behind
its front door: lockstep registration over one shared journal (which a
JAX engine replays to the same versions), per-replica drain refusals, a
swap and a rolling restart under sustained wire load with zero lost
frames, and the fleet's metric families (the same as JAX's fleet). The
load runs under the device-floor emulation, so the replicas serve turns
the way a device-bound fleet would."""

import threading
import time

import numpy as np
import pytest

from dpsvm_tpu.config import ServeConfig as JaxServeConfig
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models.multiclass import train_multiclass
from dpsvm_tpu.serving import ReplicaFleet as JaxFleet
from dpsvm_tpu.serving import ServeServer as JaxServer
from dpsvm_tpu.serving import ServingEngine as JaxEngine
from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.serving import (ReplicaFleet, ServeClient, ServeServer,
                                     ServingEngine)

D = 5


@pytest.fixture(scope="module")
def two_files(tmp_path_factory):
    """v1 / v2 bundles trained on different halves (distinct unions)."""
    tmp = tmp_path_factory.mktemp("replica_models")
    rng = np.random.default_rng(23)
    xs, ys = [], []
    for k in range(3):
        c = np.zeros(D, np.float32)
        c[k] = 2.5
        xs.append(rng.normal(size=(48, D)).astype(np.float32) * 0.7 + c)
        ys.append(np.full(48, k))
    x, y = np.concatenate(xs), np.concatenate(ys)
    cfg = JaxConfig(c=5.0, gamma=0.25, epsilon=1e-3, chunk_iters=256)
    m1, _ = train_multiclass(x[::2], y[::2], cfg, strategy="ovr")
    m2, _ = train_multiclass(x[1::2], y[1::2], cfg, strategy="ovr")
    p1, p2 = str(tmp / "m_v1.npz"), str(tmp / "m_v2.npz")
    m1.save(p1)
    m2.save(p2)
    return p1, p2, np.asarray(x, np.float32)


def _fleet(tmp_path, replicas=2, **kw):
    kw.setdefault("buckets", (16, 64))
    kw.setdefault("journal_path", str(tmp_path / "registry.journal"))
    fleet = ReplicaFleet(ServeConfig(listen="127.0.0.1:0",
                                     replicas=replicas, **kw),
                         device="cpu")
    return fleet, ServeServer(fleet)


def _no_net_threads(deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith("dpsvm-net")]
        if not left:
            return []
        time.sleep(0.02)
    return left


def test_lockstep_registration_and_shared_journal(two_files, tmp_path):
    p1, p2, x = two_files
    fleet, srv = _fleet(tmp_path)
    try:
        assert fleet.register("m", p1).version == 1
        assert fleet.swap("m", p2).version == 2
        assert [e.registry.get("m").version for e in fleet.engines] == [2, 2]
        for engine in (ServingEngine, None):  # port, then JAX
            cold = (ServingEngine(ServeConfig(
                buckets=(16, 64), journal_path=str(
                    tmp_path / "registry.journal")), device="cpu")
                if engine else JaxEngine(JaxServeConfig(
                    buckets=(16, 64), journal_path=str(
                        tmp_path / "registry.journal"))))
            try:
                assert cold._rehydrated == ["m"]
                assert cold.registry.get("m").version == 2
                np.testing.assert_allclose(
                    cold.decision(x[:8], "m"),
                    fleet.engines[1].decision(x[:8], "m"),
                    rtol=1e-5, atol=1e-5)
            finally:
                cold.close()
    finally:
        srv.close()
        fleet.close()
    assert _no_net_threads() == []


def test_drain_replica_refusals(two_files, tmp_path):
    p1, _, _ = two_files
    fleet, srv = _fleet(tmp_path)
    try:
        fleet.register("m", p1)
        with pytest.raises(ValueError, match="out of range"):
            srv.drain_replica(9)
        assert srv.drain_replica(0)["parked"] is True
        with pytest.raises(RuntimeError, match="last live replica"):
            srv.drain_replica(1)
        srv.resume_replica(0)
        assert srv.drain_replica(1)["parked"] is True
        srv.resume_replica(1)
        with ServeClient(srv.host, srv.port) as cli:
            assert cli.request(np.zeros((2, D), np.float32),
                               model="m").verdict == "served"
    finally:
        srv.close()
        fleet.close()
    assert _no_net_threads() == []


def _load(srv, n_clients, stop, records, errors):
    """Closed-loop wire clients until `stop`, each recording (t_started,
    verdict, version): every request ends in one verdict or one
    exception (the client half of the lost-frame ledger)."""

    def _loop(idx):
        rng = np.random.default_rng(900 + idx)
        try:
            with ServeClient(srv.host, srv.port, seed=idx) as cli:
                while not stop.is_set():
                    rows = rng.random((int(rng.integers(4, 17)), D),
                                      dtype=np.float32)
                    t0 = time.monotonic()
                    v = cli.request(rows, model="m")
                    records[idx].append((t0, v.verdict, v.version))
        except Exception as e:  # noqa: BLE001 - ledgered, asserted == []
            errors.append((idx, repr(e)))

    threads = [threading.Thread(target=_loop, args=(i,),
                                name=f"dpsvm-test-client-{i}")
               for i in range(n_clients)]
    for t in threads:
        t.start()
    return threads


def test_swap_and_rolling_restart_under_load(two_files, tmp_path):
    """Under sustained wire load: a fleet swap (requests started after
    it returned answer from v2 on either replica), then a rolling
    restart of replica 0 (drained, rebuilt from the journal, resumed).
    No client exception, every request served, the server's served
    count equals the clients', and the restarted replica serves
    again."""
    p1, p2, x = two_files
    fleet, srv = _fleet(tmp_path, device_floor_us_per_row=150.0)
    stop = threading.Event()
    records, errors = [[] for _ in range(3)], []
    try:
        fleet.register("m", p1)
        threads = _load(srv, 3, stop, records, errors)
        time.sleep(0.3)
        assert fleet.swap("m", p2).version == 2
        t_swapped = time.monotonic()
        time.sleep(0.3)
        old = fleet.engines[0]
        fresh = fleet.restart_replica(0, timeout_s=60.0)
        at_restart = srv.replica_snapshot()[0]["verdicts"]["served"]
        assert fresh is fleet.engines[0] and fresh is not old
        assert fresh._rehydrated == ["m"]
        assert fresh.registry.get("m").version == 2
        time.sleep(0.6)
        stop.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert errors == []
        flat = [r for rec in records for r in rec]
        assert flat and all(v == "served" for _, v, _ in flat)
        assert {ver for _, _, ver in flat} == {1, 2}
        assert all(ver == 2 for t0, _, ver in flat if t0 > t_swapped)
        assert srv.replica_snapshot()[0]["verdicts"]["served"] > at_restart
        snap = srv.drain()
        assert snap["verdicts"]["served"] == len(flat)
        assert snap["frames_accepted"] == sum(snap["verdicts"].values())
        for eng in fleet.engines:
            np.testing.assert_array_equal(
                eng.decision(x[:8], "m"),
                fleet.engines[0].decision(x[:8], "m"))
    finally:
        stop.set()
        srv.close()
        fleet.close()
    assert _no_net_threads() == []


def _families(text):
    return sorted(ln.split()[2] for ln in text.splitlines()
                  if ln.startswith("# TYPE"))


def test_fleet_metrics_match_jax_families(two_files, tmp_path):
    p1, _, _ = two_files
    texts = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            fleet, srv = _fleet(tmp_path)
        else:
            fleet = JaxFleet(JaxServeConfig(
                buckets=(16, 64), listen="127.0.0.1:0", replicas=2,
                journal_path=str(tmp_path / "jax.journal")))
            srv = JaxServer(fleet)
        try:
            fleet.register("m", p1)
            with ServeClient(srv.host, srv.port) as cli:
                for _ in range(3):
                    assert cli.request(np.ones((2, D), np.float32),
                                       model="m").verdict == "served"
            texts[pkg] = fleet.render_openmetrics()
            routing = srv.replica_snapshot()
            assert [s["replica"] for s in routing] == [0, 1]
            assert sum(s["verdicts"]["served"] for s in routing) == 3
            assert fleet.snapshot()["replicas"] == 2
        finally:
            srv.close()
            fleet.close()
    assert _families(texts["port"]) == _families(texts["jax"])
    assert "serving_fleet_replicas 2" in texts["port"]
    assert 'rep="1"' in texts["port"]
    assert _no_net_threads() == []
