"""OpenMetrics text export of the serving instruments (counterpart of
dpsvm_tpu/obs/export.py, stdlib only).

* Rendering helpers (:func:`metric`, :func:`render`) produce OpenMetrics
  1.0 text (``# TYPE``/``# HELP`` headers, label sets, summary
  quantiles, the ``# EOF`` terminator) from plain values and the
  obs/metrics instruments. Quantiles are ``Histogram.percentiles()``,
  the call ``snapshot()`` reports, so a scrape and a snapshot agree.
* :class:`MetricsExporter` serves ``GET /metrics`` from a render
  callback on a daemon ``http.server`` thread; ``port=0`` binds an
  ephemeral port (``exporter.port``). The callback only READS host
  state: a scrape never adds a device dispatch.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def metric(name: str, mtype: str, help_text: str, samples) -> str:
    """One metric family. `samples` is [(suffix, labels, value), ...]
    with suffix "" for the bare sample, "_total"/"_count"/"_sum" for
    the typed ones (OpenMetrics counters MUST expose `_total`)."""
    lines = [f"# TYPE {name} {mtype}",
             f"# HELP {name} {_escape(help_text)}"]
    for suffix, labels, value in samples:
        lines.append(f"{name}{suffix}{_labels(labels)} {_num(value)}")
    return "\n".join(lines)


def counter(name: str, help_text: str, value,
            labels: Optional[dict] = None) -> str:
    return metric(name, "counter", help_text,
                  [("_total", labels, value)])


def gauge(name: str, help_text: str, samples) -> str:
    """`samples`: [(labels, value), ...]."""
    return metric(name, "gauge", help_text,
                  [("", lb, v) for lb, v in samples])


def summary_samples(hist, qs=(50, 95, 99),
                    labels: Optional[dict] = None) -> list:
    """Summary-sample tuples for one obs/metrics Histogram:
    recent-window quantiles (exactly ``hist.percentiles(qs)`` — the
    snapshot() definition) plus lifetime `_count`/`_sum`. Compose
    several instruments (label-distinguished) into ONE family via
    :func:`metric` — OpenMetrics allows each family to appear once."""
    samples = []
    pct = hist.percentiles(qs)
    for q in qs:
        if f"p{q}" in pct:
            lb = dict(labels or {})
            lb["quantile"] = f"{q / 100:g}"
            samples.append(("", lb, pct[f"p{q}"]))
    samples.append(("_count", labels, hist.count))
    samples.append(("_sum", labels, round(getattr(hist, "total", 0.0),
                                          6)))
    return samples


def summary(name: str, help_text: str, hist, qs=(50, 95, 99),
            labels: Optional[dict] = None) -> str:
    """A summary family from one Histogram (see summary_samples)."""
    return metric(name, "summary", help_text,
                  summary_samples(hist, qs, labels))


def render(families) -> str:
    """Families (already-rendered blocks) -> one OpenMetrics exposition
    ending in the mandatory `# EOF`."""
    return "\n".join(list(families) + ["# EOF", ""])


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (stdlib API name)
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = self.server.render_fn().encode("utf-8")
        except Exception as e:  # a scrape must answer, never hang
            self.send_error(500, explain=str(e)[:200])
            return
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # scrapes are not stderr news
        pass


class MetricsExporter:
    """Daemon-threaded /metrics endpoint over a render callback.

    ``port=0`` binds an ephemeral port; read the real one from
    ``self.port``. ``close()`` is idempotent and joins the thread, so a
    server shutdown never leaks the socket."""

    def __init__(self, render_fn: Callable[[], str], port: int = 0,
                 host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.render_fn = render_fn
        self.host = host
        self.port = int(self._httpd.server_address[1])
        # State the close path reads is fully initialized BEFORE the
        # serving thread starts — nothing observes a half-built
        # exporter.
        self._closed = False
        self._close_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"dpsvm-metrics-{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        # Serialized: a concurrent close() returns only once the socket
        # is unbound and the thread joined.
        with self._close_lock:
            if self._closed:
                return
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5.0)
            self._closed = True
