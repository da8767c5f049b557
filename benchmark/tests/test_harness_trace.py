"""The reduction of a profiled slice: merged device intervals, the idle
gaps named by the innermost host op, the Chrome trace's events."""

import pytest

from benchmark.lib import trace


def test_merge_overlap_gaps():
    busy = trace.merge([(3, 4), (0, 1), (0.5, 2), (6, 7)])
    assert busy == [[0, 2], [3, 4], [6, 7]]
    assert trace.overlap(busy, [[1, 6.5]]) == pytest.approx(2.5)
    assert trace.gaps(busy, (0, 8)) == [(2, 3), (4, 6), (7, 8)]


def test_reduce_counts_overlap_once_and_names_gaps():
    device = [(0.0, 1.0, "gemm"), (0.5, 1.5, "gemm"),
              (2.0, 2.5, "Memcpy HtoD (Pageable -> Device)"),
              (3.5, 4.0, "exp")]
    host = [(0.0, 4.0, "bench/train"), (1.5, 3.5, "aten::item"),
            (1.6, 1.9, "cudaStreamSynchronize")]
    out = trace.reduce(device, host, (0.0, 4.0))
    assert out["window_s"] == 4.0
    assert out["busy_s"] == pytest.approx(1.5 + 0.5 + 0.5)
    assert out["kernel_s"] == pytest.approx(1.5 + 0.5)
    assert out["device_ops"][0] == ["gemm", 2.0]
    # Gaps: (1.5, 2.0) midpoint 1.75 in the sync; (2.5, 3.5) in the item.
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"cudaStreamSynchronize": 0.5, "aten::item": 1.0})


def test_summarize_chrome_events():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SPAN,
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 1e6},
        {"ph": "X", "cat": "gpu_user_annotation", "name": trace.SPAN,
         "pid": 0, "tid": 7, "ts": 0.0, "dur": 1e6},
        {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
         "ts": 1e5, "dur": 2e5, "args": {"stream": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 1e6},
        {"ph": "X", "cat": "cpu_op", "name": "other thread", "pid": 1,
         "tid": 2, "ts": 0.0, "dur": 1e6},
    ]
    out = trace.summarize_events(ev)
    assert out["window_s"] == pytest.approx(1.0)
    assert out["busy_s"] == pytest.approx(0.2)
    assert dict(out["idle_gaps"]) == pytest.approx({"aten::mm": 0.8})


def test_summarize_without_the_span_fails():
    with pytest.raises(RuntimeError):
        trace.summarize_events([])


def test_innermost_survives_many_siblings():
    # 10000 short ops that ended before the point, inside one span.
    host = [(0.0, 100.0, "bench/train")] + [
        (i * 0.001, i * 0.001 + 0.0005, "aten::add") for i in range(10000)]
    host.append((50.0, 60.0, "aten::item"))
    assert trace.innermost(host, [20.0, 55.0, 99.0, 200.0]) == [
        "bench/train", "aten::item", "bench/train", "(no host op)"]
