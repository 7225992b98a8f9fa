"""Telemetry over the sweep tracer.

Counterpart of the part of `jepsen_tpu/obs/__init__.py` the port's
`analyze-store` uses:

  * `events` — the flight recorder: an append-only
    `<store>/events.jsonl` of typed lifecycle events (sweep start,
    resume and end, quarantine with its cause, OOM split, watchdog
    fire, analytics flush), each line flushed as it lands, so a
    post-mortem on a killed sweep has a causal record even when
    trace.json was never written;
  * `attribution` — the critical-path report over the sweep's timeline
    (`analyze-store --report`: `<store>/report.json` + `report.md`);
  * `search` — the kernel search-telemetry ledger
    (`JEPSEN_TPU_KERNEL_STATS`: `<store>/analytics.jsonl`).

The reference's health sampler, metrics endpoint and device cost
observatory are not ported yet. Stdlib only.
"""

from __future__ import annotations

from . import attribution, events, search
from .events import EVENT_KINDS, emit, install_events, load_events, reset_events

__all__ = [
    "EVENT_KINDS", "attribution", "emit", "events", "install_events",
    "load_events", "reset_events", "search",
]
