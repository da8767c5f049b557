"""A profiled slice of the window, reduced to what the per-layer metrics
read: the device's busy time, its kernels' busy time, the heaviest
device operations and the idle gaps by what the host was doing.

The slice is one ``torch.profiler`` session (CPU and CUDA activity)
around a user annotation, ``bench/slice``; the annotation's interval is
the window. The session's Chrome trace is read back from a temporary
file, which is removed. Device intervals (kernels, copies, memsets) are merged
before they are measured, so overlapping work on two streams counts
once. Only traced runs open a slice.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time

SPAN = "bench/slice"
TOP = 10


def merge(intervals) -> list:
    """The union of [start, end) intervals as a sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Total length of the intersection of two disjoint sorted lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            tot += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def gaps(busy, window) -> list:
    """The idle [start, end) intervals of the window between the merged
    busy intervals."""
    ws, we = window
    out = []
    cur = ws
    for s, e in busy:
        if e <= ws or s >= we:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < we:
        out.append((cur, we))
    return out


def innermost(host, points) -> list:
    """For each of the ascending `points`, the name of the innermost host
    interval that covers it ("(no host op)" where none does). The host
    ops of one thread nest, so one sweep with a stack of the open ones
    finds them all."""
    host = sorted(host)
    stack, out, k = [], [], 0
    for t in points:
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host op)")
    return out


def span(name: str, on: bool):
    """A host span of the benchmark's own (``bench/<layer call>``) around
    a call into the program, recorded only while a slice is open."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def reduce(device, host, window) -> dict:
    """Reduce one slice. `device`: (start, end, name) of every device
    activity; `host`: (start, end, name) of the host operations on the
    thread that drove the card; `window`: (start, end). Times in seconds
    on one clock. Returns window_s, busy_s (all activity, merged),
    kernel_s (kernels alone, merged), device_ops and idle_gaps (at most
    TOP [name, seconds] pairs each)."""
    ws, we = window
    win = [[ws, we]]
    inside = [(max(s, ws), min(e, we), n) for s, e, n in device
              if e > ws and s < we]
    busy = merge((s, e) for s, e, _ in inside)
    kernels = merge((s, e) for s, e, n in inside if not _is_copy(n))
    by_name = collections.defaultdict(float)
    for s, e, n in inside:
        by_name[n] += e - s
    idle = gaps(busy, window)
    names = innermost([h for h in host if h[1] > ws and h[0] < we],
                      [0.5 * (s + e) for s, e in idle])
    by_host = collections.defaultdict(float)
    for (s, e), name in zip(idle, names):
        by_host[name] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    slow = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": we - ws,
        "busy_s": overlap(busy, win),
        "kernel_s": overlap(kernels, win),
        "device_ops": [[n[:120], v] for n, v in top],
        "idle_gaps": [[n[:120], v] for n, v in slow],
    }


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Slice:
    """``with Slice() as sl:`` profiles the block; ``sl.summary`` then
    holds reduce()'s dict; ``sl.t0`` is the host clock at the window's
    start (the profiler's own start before it)."""

    def __init__(self):
        self.summary = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._torch = torch
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._sync()
        self._span = record_function(SPAN)
        self._span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def _sync(self):
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()

    def __exit__(self, *exc):
        self._sync()
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof)
        return False


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(prof) -> dict:
    """reduce() over a finished torch.profiler session, read from its
    Chrome trace (written to a temporary file of TMPDIR and removed):
    the window is the SPAN annotation, the host ops those of the thread
    that opened it, the device activity its kernels, copies and
    memsets."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return summarize_events(events)


def summarize_events(events) -> dict:
    device, host, window, tid = [], [], None, None
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    for e in spans:
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                           e.get("name", "")))
        elif cat == "user_annotation" and e.get("name") == SPAN:
            window = (e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
            tid = (e.get("pid"), e.get("tid"))
    if window is None:
        raise RuntimeError(f"the profile holds no {SPAN} annotation")
    for e in spans:
        cat = e.get("cat", "")
        if (cat not in DEVICE_CATS and not cat.startswith("gpu_")
                and (e.get("pid"), e.get("tid")) == tid
                and e.get("name") != SPAN):
            host.append((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6,
                         e.get("name", "")))
    return reduce(device, host, window)
