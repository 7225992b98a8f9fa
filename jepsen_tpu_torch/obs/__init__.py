"""Telemetry over the sweep tracer.

Counterpart of `jepsen_tpu/obs/__init__.py`, in stdlib-only pieces:

  * `events` — the flight recorder: an append-only
    `<store>/events.jsonl` of typed lifecycle events (sweep start,
    resume and end, quarantine with its cause, OOM split, watchdog
    fire, analytics and costdb flushes, health samples, the metrics
    endpoint coming up), each line flushed as it lands, so a
    post-mortem on a killed sweep has a causal record even when
    trace.json was never written;
  * `health` — a sampler thread (`JEPSEN_TPU_HEALTH_INTERVAL_S`,
    default off) that atomically writes `<store>/health.json` every N
    seconds: progress, robustness counters, throughput and ETA, the
    residency gauges, and a heartbeat;
  * `prom` — the Prometheus text exposition of the tracer's metrics and
    an optional endpoint (`JEPSEN_TPU_METRICS_PORT`) serving `/metrics`
    and `/healthz` (the health snapshot);
  * `attribution` — the critical-path report over the sweep's timeline
    (`analyze-store --report`: `<store>/report.json` + `report.md`);
  * `search` — the kernel search-telemetry ledger
    (`JEPSEN_TPU_KERNEL_STATS`: `<store>/analytics.jsonl`);
  * `device` — the device cost observatory (`JEPSEN_TPU_COSTDB`): each
    bucket dispatch's closure work counted from its shapes, joined with
    its CUDA-event device time, the residency gauges, and
    `<store>/costdb.jsonl`, which the planner trains on; `--report`
    gains its device roofline section from the same records.

The reference's trajectory gate (`bench_report`) and live smoke
(`smoke`) belong to the benchmark, not ported yet. Everything is gated
off by default.
"""

from __future__ import annotations

from . import attribution, device, events, search
from .events import EVENT_KINDS, emit, install_events, load_events, reset_events
from .health import HealthSampler, health_snapshot, maybe_start_health_sampler
from .prom import MetricsServer, maybe_start_metrics_server, render_prometheus

__all__ = [
    "EVENT_KINDS", "HealthSampler", "MetricsServer", "attribution",
    "device", "emit", "events", "health_snapshot", "install_events",
    "load_events", "maybe_start_health_sampler",
    "maybe_start_metrics_server", "render_prometheus", "reset_events",
    "search",
]
