"""Prometheus text exposition + the optional `/metrics` endpoint.

`render_prometheus` maps the tracer's metric registry 1:1 onto the
text exposition format (version 0.0.4): counters and gauges keep their
registry names (sanitized, `jepsen_tpu_` prefixed) so a scraped value
always matches the same key in the final metrics.json — no renaming
layer to drift. Histograms are summary-stat + log2 magnitude buckets
in the registry; each magnitude bucket `b` (values in [2^b, 2^(b+1)))
becomes the cumulative `_bucket{le="2^(b+1)"}` series, closed by
`+Inf`/`_sum`/`_count` as the format requires.

`MetricsServer` is a stdlib `http.server` on a daemon thread serving
`/metrics` (exposition) and `/healthz` (the health.json snapshot
dict) — gated by `JEPSEN_TPU_METRICS_PORT` (unset = off; `0` binds an
ephemeral port, printed, for tests and parallel CI). It reads the
CURRENT tracer at scrape time, so a long-lived process that rotates
tracers per sweep serves whichever is live.

Counterpart of `jepsen_tpu/obs/prom.py`: the same exposition, byte for
byte, from the port's tracer.
"""

from __future__ import annotations

import json
import logging
import re
import threading

from .. import gates, trace
from . import events
from .health import health_snapshot

log = logging.getLogger(__name__)

PREFIX = "jepsen_tpu_"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _name(metric: str) -> str:
    return PREFIX + _NAME_RE.sub("_", metric)


def render_prometheus(tracer=None) -> str:
    """The full exposition page for a tracer's metrics dict."""
    tr = tracer if tracer is not None else trace.get_current()
    md = tr.metrics_dict() if getattr(tr, "enabled", False) else {}
    lines: list[str] = []
    for k, v in md.get("counters", {}).items():
        n = _name(k)
        lines += [f"# TYPE {n} counter", f"{n} {v}"]
    for k, v in md.get("gauges", {}).items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue    # unset gauges don't render a bogus 0
        n = _name(k)
        lines += [f"# TYPE {n} gauge", f"{n} {v}"]
    for k, h in md.get("histograms", {}).items():
        n = _name(k)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for b, cnt in sorted((int(kb), vb) for kb, vb in
                             h.get("log2_buckets", {}).items()):
            cum += cnt
            lines.append(f'{n}_bucket{{le="{2.0 ** (b + 1)!r}"}} {cum}')
        lines.append(f'{n}_bucket{{le="+Inf"}} {h["count"]}')
        lines.append(f"{n}_sum {h['sum']}")
        lines.append(f"{n}_count {h['count']}")
    de = md.get("dropped_events")
    if de is not None:
        n = _name("dropped_events")
        lines += [f"# TYPE {n} gauge", f"{n} {de}"]
    return "\n".join(lines) + "\n"


def metrics_port() -> int | None:
    """The JEPSEN_TPU_METRICS_PORT gate: unset = off; 0 = ephemeral."""
    v = gates.get("JEPSEN_TPU_METRICS_PORT")
    return v if v is not None and v >= 0 else None


class MetricsServer:
    """The scrape endpoint: `/metrics` (Prometheus text exposition of
    the current tracer) and `/healthz` (the live health snapshot as
    JSON). ThreadingHTTPServer on a daemon thread — scrapes never
    block the sweep, and the process never waits on the server to
    exit. `health_fn` defaults to an uptime-less snapshot; the sweep
    wires its sampler's so `/healthz` and health.json agree."""

    def __init__(self, port: int, host: str = "0.0.0.0",
                 tracer_fn=trace.get_current, health_fn=None):
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer
        self._tracer_fn = tracer_fn
        self._health_fn = health_fn if health_fn is not None \
            else (lambda: health_snapshot(tracer_fn()))
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):     # noqa: N802 (http.server API)
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = render_prometheus(
                            outer._tracer_fn()).encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    elif self.path.split("?")[0] in ("/healthz",
                                                     "/health"):
                        body = json.dumps(outer._health_fn()).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception:
                    log.debug("scrape handler failed", exc_info=True)
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass    # scrapes must not spam the sweep's log

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="obs-metrics",
            daemon=True)
        self._thread.start()
        events.emit("metrics_serve", port=self.port)
        log.info("obs metrics endpoint on :%d (/metrics, /healthz)",
                 self.port)

    def stop(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except Exception:
            log.debug("metrics server stop failed", exc_info=True)
        self._thread.join(timeout=5)


def maybe_start_metrics_server(tracer_fn=trace.get_current,
                               health_fn=None) -> MetricsServer | None:
    """Start the endpoint when JEPSEN_TPU_METRICS_PORT enables it;
    None (and zero work) otherwise. A port that cannot bind (taken,
    privileged) degrades to a warning — observability must never sink
    the sweep."""
    port = metrics_port()
    if port is None:
        return None
    try:
        return MetricsServer(port, tracer_fn=tracer_fn,
                             health_fn=health_fn)
    except OSError as e:
        log.warning("metrics endpoint failed to bind port %d: %s",
                    port, e)
        return None
