"""The port's network front door (dpsvm_tpu_torch/serving/{wire,server,
client}.py) against the JAX package's: the same frames pack to identical
bytes in both; a JAX client against a port server and a port client
against a JAX server get the same verdict codes, equal labels and
decisions within rtol 1e-5 / atol 1e-5 of the serving engine's; admission
rejects with retry_after_ms; a protocol error costs only its own
connection; a drain ends with GOODBYE; `cli serve --listen`. Sockets bind
127.0.0.1 port 0; every join and socket has a bound."""

import socket
import struct
import threading
import time
import types

import numpy as np
import pytest

from dpsvm_tpu.config import ServeConfig as JaxServeConfig
from dpsvm_tpu.config import SVMConfig as JaxConfig
from dpsvm_tpu.models.multiclass import train_multiclass
from dpsvm_tpu.serving import ServeClient as JaxClient
from dpsvm_tpu.serving import ServeServer as JaxServer
from dpsvm_tpu.serving import ServingEngine as JaxEngine
from dpsvm_tpu.serving import wire as jwire
from dpsvm_tpu_torch import cli as tcli
from dpsvm_tpu_torch.config import ServeConfig
from dpsvm_tpu_torch.convert import multiclass_from_reference
from dpsvm_tpu_torch.serving import ServeClient, ServeServer, ServingEngine
from dpsvm_tpu_torch.serving import wire
from dpsvm_tpu_torch.serving.client import ConnectError, ServerDraining

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(17)
    xs, ys = [], []
    for k in range(3):
        c = np.zeros(5, np.float32)
        c[k] = 2.5
        xs.append(rng.normal(size=(45, 5)).astype(np.float32) * 0.7 + c)
        ys.append(np.full(45, k))
    x, y = np.concatenate(xs), np.concatenate(ys)
    m, _ = train_multiclass(x, y, JaxConfig(c=5.0, gamma=0.25,
                                            epsilon=1e-3, chunk_iters=256),
                            strategy="ovr")
    return m, multiclass_from_reference(m), np.asarray(x, np.float32)


def _port(**kw):
    kw.setdefault("buckets", (16, 64))
    eng = ServingEngine(ServeConfig(**kw), device="cpu")
    return eng, ServeServer(eng)


def _jax(**kw):
    kw.setdefault("buckets", (16, 64))
    eng = JaxEngine(JaxServeConfig(**kw))
    return eng, JaxServer(eng)


def _no_net_threads(deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith("dpsvm-net")]
        if not left:
            return []
        time.sleep(0.02)
    return left


def test_frames_are_byte_identical():
    for name in ("MAGIC", "VERSION", "VERDICTS", "T_REQUEST", "T_VERDICT",
                 "T_ERROR", "T_GOODBYE", "T_HELLO", "HEADER_BYTES",
                 "FLAG_WANT_DECISION", "PAYLOAD_NONE", "PAYLOAD_LABELS",
                 "PAYLOAD_DECISION"):
        assert getattr(wire, name) == getattr(jwire, name), name
    rows = np.arange(12, dtype=np.float32).reshape(3, 4) / 7
    dec = np.linspace(-2, 2, 6, dtype=np.float32).reshape(2, 3)
    cases = [
        ("pack_request", (42, rows, "mnist", 125.5), dict(
            want_decision=True)),
        ("pack_request", (1, rows, None, None), {}),
        ("pack_verdict", (9, "late"), dict(
            model="m", version=3, latency_ms=12.25,
            labels=np.array([1, -1, 7], np.int32))),
        ("pack_verdict", (8, "served"), dict(decision=dec)),
        ("pack_verdict", (7, "rejected"), dict(retry_after_ms=80,
                                               message="queue full")),
        ("pack_verdict", (6, "expired"), {}),
        ("pack_verdict", (5, "failed"), dict(message="é" * 3)),
        ("pack_error", (3, "bad magic"), {}),
        ("pack_goodbye", ("server draining",), {}),
        ("pack_hello", (), {}),
    ]
    for fn, args, kw in cases:
        got = getattr(wire, fn)(*args, **kw)
        assert got == getattr(jwire, fn)(*args, **kw), (fn, args)
    frame = wire.pack_verdict(8, "served", decision=dec)
    v = jwire.parse_verdict(frame[wire.HEADER_BYTES:])
    np.testing.assert_array_equal(v.decision, dec)
    req = wire.parse_request(jwire.pack_request(2, rows, "m", 5.0)[
        wire.HEADER_BYTES:])
    assert (req.req_id, req.model, req.budget_ms) == (2, "m", 5.0)
    np.testing.assert_array_equal(req.rows, rows)


def test_header_refusals():
    with pytest.raises(wire.WireError, match="magic"):
        wire.parse_header(b"XX\x01\x01\x00\x00\x00\x00", 1 << 20)
    with pytest.raises(wire.WireError, match="version"):
        wire.parse_header(b"DS\x09\x01\x00\x00\x00\x00", 1 << 20)
    with pytest.raises(wire.WireError, match="exceeds"):
        wire.parse_header(struct.pack("!2sBBI", b"DS", 1, wire.T_REQUEST,
                                      1 << 31), 1 << 20)
    good = wire.pack_request(1, np.zeros((2, 3), np.float32), "m", None)
    with pytest.raises(wire.WireError, match="carries"):
        wire.parse_request(good[wire.HEADER_BYTES:-4])


def _requests(x):
    """(kwargs, rows) a client sends: labels, decisions, an unknown
    model, a wrong width, an already-spent budget."""
    return [
        (dict(model="m"), x[:4]),
        (dict(model="m", want_decision=True), x[4:40]),
        (dict(model="nope"), x[:2]),
        (dict(model="m"), np.zeros((2, 3), np.float32)),
        (dict(model="m", deadline_ms=0.0), x[:2]),
        (dict(model=None), x[40:45]),
    ]


@pytest.mark.parametrize("pairing", ["jax_client-port_server",
                                     "port_client-jax_server"])
def test_cross_package_client_and_server(tiny, pairing):
    jm, tm, x = tiny
    codes = {}
    for which in ("port", "jax"):
        if which == "port":
            eng, srv = _port()
            eng.register("m", tm)
        else:
            eng, srv = _jax()
            eng.register("m", jm)
        client_cls = JaxClient if (which == "port") == (
            pairing == "jax_client-port_server") else ServeClient
        try:
            out = []
            with client_cls(srv.host, srv.port, seed=1) as cli:
                for kw, rows in _requests(x):
                    v = cli.request(rows, **kw)
                    out.append(v)
            ref_dec = eng.decision(x[4:40], "m")
            ref_lab = eng.predict(x[:4], "m")
            ref_lab5 = eng.predict(x[40:45])
        finally:
            srv.close()
            eng.close()
        codes[which] = [v.verdict for v in out]
        if (which == "port") == (pairing == "jax_client-port_server"):
            cross = out
            np.testing.assert_array_equal(cross[0].labels, ref_lab)
            np.testing.assert_allclose(cross[1].decision, ref_dec, **TOL)
            np.testing.assert_array_equal(cross[5].labels, ref_lab5)
        else:
            same = out
    assert codes["port"] == codes["jax"] == [
        "served", "served", "failed", "failed", "expired", "served"]
    np.testing.assert_array_equal(cross[0].labels, same[0].labels)
    np.testing.assert_array_equal(cross[5].labels, same[5].labels)
    np.testing.assert_allclose(cross[1].decision, same[1].decision, **TOL)
    assert _no_net_threads() == []


def test_admission_rejects_with_retry_hint(tiny):
    _, tm, x = tiny
    eng, srv = _port(admission_max_rows=8)
    real_pump = eng.pump
    try:
        eng.register("m", tm)
        eng.pump = lambda: 0  # hold the engine: its queue cannot drain
        first = {}

        def _first():
            with JaxClient(srv.host, srv.port, seed=1) as c:
                first["v"] = c.request(np.zeros((8, 5), np.float32),
                                       model="m")

        th = threading.Thread(target=_first, name="dpsvm-test-first")
        th.start()
        deadline = time.monotonic() + 10
        while eng.scheduler.queue_rows < 8 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.scheduler.queue_rows == 8
        with ServeClient(srv.host, srv.port, seed=2,
                         reject_retries=0) as cli:
            v = cli.request(np.zeros((2, 5), np.float32), model="m")
        assert v.verdict == "rejected" and v.retry_after_ms > 0
        assert "admission" in v.message
        eng.pump = real_pump
        th.join(timeout=60)
        assert not th.is_alive() and first["v"].verdict == "served"
        assert srv.net_snapshot()["verdicts"]["rejected"] == 1
    finally:
        eng.pump = real_pump
        srv.close()
        eng.close()


def test_protocol_error_costs_only_its_connection(tiny):
    _, tm, x = tiny
    eng, srv = _port()
    try:
        eng.register("m", tm)
        with ServeClient(srv.host, srv.port, seed=5) as good:
            assert good.request(x[:2], model="m").verdict == "served"
            sock = socket.create_connection((srv.host, srv.port),
                                            timeout=10)
            head = wire.recv_exact(sock, wire.HEADER_BYTES)
            ftype, length = wire.parse_header(head, 1 << 20)
            assert ftype == wire.T_HELLO
            wire.recv_exact(sock, length)
            sock.sendall(b"XXgarbage-frame!")
            head = wire.recv_exact(sock, wire.HEADER_BYTES)
            ftype, length = wire.parse_header(head, 1 << 20)
            assert ftype == wire.T_ERROR
            _, msg = wire.parse_error(wire.recv_exact(sock, length))
            assert "magic" in msg
            assert sock.recv(1) == b""  # closed after the ERROR frame
            sock.close()
            # the other connection and the engine never noticed
            assert good.request(x[2:4], model="m").verdict == "served"
        deadline = time.monotonic() + 10
        while srv.net_snapshot()["open_connections"] \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        snap = srv.net_snapshot()
        assert snap["protocol_errors"] == 1
        assert snap["frames_accepted"] == sum(snap["verdicts"].values()) == 2
    finally:
        srv.close()
        eng.close()
    assert _no_net_threads() == []


def test_drain_ends_with_goodbye(tiny):
    _, tm, x = tiny
    eng, srv = _port()
    try:
        eng.register("m", tm)
        cli = JaxClient(srv.host, srv.port, seed=3, connect_retries=0,
                        timeout_s=10.0)
        assert cli.request(x[:3], model="m").verdict == "served"
        snap = srv.drain()
        assert snap["goodbyes_sent"] == 1
        assert snap["frames_accepted"] == sum(snap["verdicts"].values())
        with pytest.raises(Exception) as info:
            cli.request(x[:3], model="m")
        assert type(info.value).__name__ in ("ServerDraining",
                                             "ConnectionDropped")
        cli.close()
        with pytest.raises(ConnectError):
            ServeClient(srv.host, srv.port, connect_retries=0,
                        timeout_s=2.0).request(x[:1], model="m")
        assert srv.drain()["frames_accepted"] == snap["frames_accepted"]
    finally:
        srv.close()
        eng.close()
    assert _no_net_threads() == []


def test_drain_goodbye_reaches_an_idle_port_client(tiny):
    """An idle connection of the port's client reads the GOODBYE the
    drain sends and raises ServerDraining (safe to retry elsewhere)."""
    jm, _, x = tiny
    eng, srv = _jax()
    try:
        eng.register("m", jm)
        cli = ServeClient(srv.host, srv.port, seed=4, timeout_s=10.0)
        cli.connect()
        th = threading.Thread(target=srv.drain, name="dpsvm-test-drain")
        th.start()
        with pytest.raises(ServerDraining):
            cli._read_verdict(1)
        th.join(timeout=60)
        assert not th.is_alive()
        cli.close()
    finally:
        srv.close()
        eng.close()


def test_cli_serve_listen_roundtrip(tiny, tmp_path):
    jm, tm, x = tiny
    mp = str(tmp_path / "m.npz")
    jm.save(mp)  # a JAX bundle, served by the port's CLI loop
    engine = ServingEngine(ServeConfig(buckets=(16, 64),
                                       listen="127.0.0.1:0"), device="cpu")
    engine.register("m", mp)
    stop, rc = threading.Event(), {}
    th = threading.Thread(target=lambda: rc.update(rc=tcli._serve_listen(
        types.SimpleNamespace(quiet=True), engine, stop_event=stop)),
        name="dpsvm-test-listen")
    th.start()
    deadline = time.monotonic() + 10
    while engine._front is None and time.monotonic() < deadline:
        time.sleep(0.01)
    srv = engine._front
    with JaxClient(srv.host, srv.port) as cli:
        labels = cli.predict(x[:6], model="m")
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive() and rc["rc"] == 0 and engine._closed
    from dpsvm_tpu_torch.models.multiclass import predict_multiclass
    np.testing.assert_array_equal(labels,
                                  predict_multiclass(tm, x[:6],
                                                     device="cpu"))
    assert _no_net_threads() == []


def test_cli_listen_bad_spec(capsys):
    rc = tcli.main(["serve", "--listen", "nohostport", "--registry",
                    "m=/dev/null", "--device", "cpu"])
    assert rc == 2 and "listen" in capsys.readouterr().err


def test_net_families_on_metrics_and_snapshot(tiny):
    _, tm, x = tiny
    eng, srv = _port()
    try:
        eng.register("m", tm)
        with ServeClient(srv.host, srv.port) as cli:
            cli.request(x[:2], model="m")
        text = eng.render_openmetrics()
        for fam in ("serving_net_connections_opened",
                    "serving_net_frames_accepted", "serving_net_verdicts",
                    "serving_replica_queue_rows"):
            assert f"# TYPE {fam}" in text
        assert 'serving_net_verdicts_total{verdict="served"} 1' in text
        assert eng.snapshot()["net"]["frames_accepted"] == 1
    finally:
        srv.close()
        eng.close()
