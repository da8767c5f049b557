"""The port's spans on the training path (dpsvm_tpu_torch/obs/trace.py):
off, ``span()`` is the shared null span and costs no clock read, no
allocation and no event; under any running ``torch.profiler`` the spans
of ``train()`` (``train``, ``solver/upload``, ``model/assemble``, the
block round's four stages and its host read) are live, counted in the
process's span table and written into the profiler's trace as user
annotations, nested inside ``train``; the alphas are bitwise the
unprofiled ones; the device spans' unresolved event pairs are bounded,
with the drops counted. The card's test (marked ``cuda``) reads the
device times. This file imports neither jax nor the JAX package:
    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dpsvm_tpu_torch import SVMConfig, train
from dpsvm_tpu_torch.autotune import use_profile
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.obs import trace

STAGES = ("block/select", "block/gather", "block/subproblem", "block/fold")
# Six rounds on the CPU: the profiler's trace of the plain B1's Python
# loop stays near 10 MB.
CFG = SVMConfig(c=4.0, gamma=0.1, engine="block", working_set_size=16)


@pytest.fixture
def blobs():
    return make_blobs_binary(n=120, d=4, seed=3, sep=2.0)


@pytest.fixture(autouse=True)
def _clean_table(monkeypatch):
    for var in ("DPSVM_OBS", "DPSVM_OBS_DIR", "DPSVM_TRACE_DIR"):
        monkeypatch.delenv(var, raising=False)
    trace.reset_span_totals()
    yield
    trace.reset_span_totals()


def _fresh(x):
    """A new host array of the same rows: the solver's memo of X's
    upload misses, so the job pays (and spans) its upload."""
    return np.array(x, copy=True)


def test_off_span_is_the_null_span_with_no_clock_or_allocation(
        monkeypatch):
    assert trace.span("a") is trace._NULL_SPAN
    assert trace.span("b", device=torch.device("cpu")) is trace._NULL_SPAN
    assert trace.span("c", device=torch.device("cuda")) is trace._NULL_SPAN

    def no_clock():
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(trace.time, "perf_counter", no_clock)
    with trace.span("d", device=torch.device("cuda")):
        pass
    dev = torch.device("cuda")
    calls = [dev] * 1000

    def growth(fn):
        """The peak of traced memory over 1000 calls above its start: a
        call that allocates, even transiently, raises it."""
        tracemalloc.reset_peak()
        start = tracemalloc.get_traced_memory()[0]
        for d in calls:
            fn("e", device=d)
        return tracemalloc.get_traced_memory()[1] - start

    def noop(name, device=None):
        return None

    tracemalloc.start()
    try:
        growth(trace.span), growth(noop)  # warm every cache on the path
        assert growth(trace.span) == growth(noop)
    finally:
        tracemalloc.stop()
    assert trace.span_totals() == {}


def test_off_train_leaves_the_table_empty(blobs):
    x, y = blobs
    train(_fresh(x), y, CFG, device="cpu")
    assert trace.span_totals() == {}


def test_profiled_train_spans_bitwise_alphas_and_trace(blobs, tmp_path):
    x, y = blobs
    _, res0 = train(_fresh(x), y, CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, res = train(_fresh(x), y, CFG, device="cpu")
    np.testing.assert_array_equal(res.alpha, res0.alpha)
    assert res.b == res0.b and res.iterations == res0.iterations
    rounds = res.stats["outer_rounds"]
    assert rounds > 1
    tab = trace.span_totals()
    for name in ("train", "solver/upload", "model/assemble"):
        assert tab[name]["count"] == 1, name
    for name in STAGES:
        assert tab[name]["count"] == rounds, name
    # The loop condition is read before each round and once more at the
    # end of each chunk.
    assert tab["block/read"]["count"] == rounds + res.stats["chunks"]
    assert all(v["device_s"] is None and v["dropped"] == 0
               for v in tab.values())
    assert tab["train"]["host_s"] >= (tab["solver/chunk"]["host_s"]
                                      + tab["solver/upload"]["host_s"]
                                      + tab["model/assemble"]["host_s"])

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("ph") == "X"]
    by_name = {}
    for e in ann:
        by_name.setdefault(e["name"], []).append(e)
    (job,) = by_name["train"]
    lo, hi = job["ts"], job["ts"] + job["dur"]
    for name in STAGES + ("solver/upload", "model/assemble", "block/read"):
        assert len(by_name[name]) == tab[name]["count"], name
        assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                   for e in by_name[name]), name


class _FakeEvent:
    """A CUDA timing event's surface: done, or pending until waited on;
    1 ms apart from any other."""

    def __init__(self, done: bool):
        self.done = done
        self.waits = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True

    def elapsed_time(self, end):
        return 1.0


def test_pending_event_pairs_are_bounded_and_drops_counted(monkeypatch):
    made = []

    def fake_event(stream):
        made.append(_FakeEvent(done=False))
        return made[-1]

    monkeypatch.setattr(trace, "_timing_event", fake_event)
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda d: None)
    monkeypatch.setattr(trace, "_MAX_PENDING", 4)
    monkeypatch.setattr(trace, "_DRAIN_AT", 2)
    dev = torch.device("cuda")
    with trace.TraceSession() as sess:
        for _ in range(7):
            with trace.span("block/fold", device=dev):
                pass
        with trace.span("block/read"):
            pass
    assert len(made) == 14 and len(sess.events) == 8
    tab = trace.span_totals()
    assert tab["block/fold"]["count"] == 7
    assert tab["block/fold"]["dropped"] == 3
    assert tab["block/fold"]["device_s"] == pytest.approx(4e-3)
    assert tab["block/read"]["device_s"] is None
    assert not trace._PENDING


def test_completed_event_pairs_resolve_without_waiting(monkeypatch):
    made = []

    def fake_event(stream):
        made.append(_FakeEvent(done=True))
        return made[-1]

    monkeypatch.setattr(trace, "_timing_event", fake_event)
    monkeypatch.setattr(trace.torch.cuda, "current_stream", lambda d: None)
    monkeypatch.setattr(trace, "_MAX_PENDING", 4)
    monkeypatch.setattr(trace, "_DRAIN_AT", 2)
    with trace.TraceSession():
        for _ in range(7):
            with trace.span("solver/upload", device=torch.device("cuda")):
                pass
    assert len(trace._PENDING) == 1  # drained at the 3rd, 5th, 7th span
    assert all(ev.waits == 0 for ev in made)
    tab = trace.span_totals()["solver/upload"]
    assert tab["count"] == 7 and tab["dropped"] == 0
    assert tab["device_s"] == pytest.approx(7e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: device spans time CUDA events")
    with use_profile(None):
        yield torch.device("cuda")


@pytest.mark.cuda
def test_device_times_of_a_profiled_job(cuda):
    x, y = make_blobs_binary(n=20000, d=64, seed=5, sep=1.0)
    cfg = SVMConfig(c=4.0, gamma=0.05, engine="block", working_set_size=64)
    train(_fresh(x), y, cfg)  # the kernels' builds and loads
    trace.reset_span_totals()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _, res = train(_fresh(x), y, cfg)
    tab = trace.span_totals()
    assert tab["solver/upload"]["device_s"] > 0
    assert tab["train"]["device_s"] is None
    stages = [tab[name]["device_s"] for name in STAGES]
    assert all(s > 0 for s in stages)
    assert sum(stages) <= res.train_seconds
    assert all(v["dropped"] == 0 for v in tab.values())
