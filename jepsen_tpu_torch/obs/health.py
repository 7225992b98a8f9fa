"""Live health snapshots: `<store>/health.json`, atomically, every N s.

The snapshot answers the three operator questions about a RUNNING
sweep — how far along (runs verdicted / total, buckets dispatched vs
resolved, inflight depth), how healthy (the supervisor's quarantine/
OOM/watchdog counters), how fast (throughput + ETA) — plus a
monotonic heartbeat so a wedged sweep is distinguishable from a slow
one: a fresh heartbeat over stale progress means the process is alive
but stuck; a stale heartbeat means it is gone.

Writes go temp-file → `os.replace`, so a concurrent reader (or a
scrape of `/healthz`, which serves the same dict) never sees a torn
file. Gated by `JEPSEN_TPU_HEALTH_INTERVAL_S` (default off): with the
gate unset a sweep pays one `gates.get` and nothing else.

Counterpart of `jepsen_tpu/obs/health.py`: the same snapshot, keys and
nulls. Its `device` section reads the residency gauges the port's cost
observatory publishes (`parallel.residency`): loaded CUDA kernel
libraries, modeled bytes in flight, the caching allocator's bytes in
use; `donated_bytes` stays null, since the port donates no buffer.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path

from .. import gates, trace
from . import events

log = logging.getLogger(__name__)

HEALTH_NAME = "health.json"


def health_interval_s() -> float | None:
    """The JEPSEN_TPU_HEALTH_INTERVAL_S gate (seconds; unset/<=0 =
    off, the default — live telemetry is opt-in)."""
    v = gates.get("JEPSEN_TPU_HEALTH_INTERVAL_S")
    return v if v is not None and v > 0 else None


def health_snapshot(tracer=None, *, seq: int = 0,
                    started_mono: float | None = None,
                    extra: dict | None = None) -> dict:
    """The one snapshot shape health.json and `/healthz` both serve,
    derived entirely from the current tracer's metrics (plus the
    sampler's own heartbeat bookkeeping). Works against the NullTracer
    too — every field the metrics can't answer is null, never absent.
    `extra` merges owner-specific top-level sections into the snapshot
    (the serve daemon's `"serve"` section rides this seam); the core
    keys always win on a collision."""
    tr = tracer if tracer is not None else trace.get_current()
    md = tr.metrics_dict() if getattr(tr, "enabled", False) else {}
    c = md.get("counters", {})
    g = md.get("gauges", {})
    now = time.monotonic()
    done = c.get("runs_verdicted", 0)
    total = g.get("runs_total")
    elapsed = (now - started_mono) if started_mono is not None else None
    rate = (done / elapsed) if elapsed and elapsed > 0 else None
    eta = None
    if rate and isinstance(total, (int, float)) and total > done:
        eta = (total - done) / rate
    return {
        **(extra or {}),
        "v": 1,
        "run": getattr(tr, "run", None),
        # the liveness signal: seq strictly increases per write and
        # monotonic/wall give the reader both clocks — progress can
        # stall while the heartbeat stays fresh (wedged, not dead)
        "heartbeat": {"seq": seq,
                      "monotonic": round(now, 6),
                      "wall": round(time.time(), 6)},
        "progress": {
            "runs_total": total,
            "runs_verdicted": done,
            "buckets_dispatched": c.get("buckets_dispatched", 0),
            "buckets_resolved": c.get("buckets_resolved", 0),
            "inflight_depth": g.get("inflight_depth"),
        },
        "robustness": {k: c.get(k, 0)
                       for k in ("quarantined", "oom_retries",
                                 "bucket_splits", "watchdog_timeouts")},
        # the residency gauges (obs/device.py, gated by
        # JEPSEN_TPU_COSTDB): loaded CUDA kernel libraries, modeled
        # device bytes in flight, the caching allocator's bytes in use
        # on a card, and donated bytes (none in the port) — null (not
        # absent) when the observatory never published
        "device": {
            "resident_executables": g.get("resident_executables"),
            "hbm_modeled_bytes": g.get("hbm_modeled_bytes"),
            "hbm_device_bytes": g.get("hbm_device_bytes"),
            "donated_bytes": c.get("donated_bytes"),
        },
        "throughput": {
            "elapsed_secs": round(elapsed, 3) if elapsed is not None
            else None,
            "runs_per_sec": round(rate, 4) if rate is not None else None,
            "eta_secs": round(eta, 1) if eta is not None else None,
        },
    }


def write_health(path, snap: dict) -> Path | None:
    """Atomic snapshot write (trace.atomic_write_text: temp in the
    same directory, then `os.replace`) — a reader sees the previous
    complete file or the new complete file, never bytes of both.
    Best-effort (None on failure): observability must never sink the
    sweep."""
    try:
        return trace.atomic_write_text(path, json.dumps(snap, indent=2))
    except OSError:
        log.debug("health snapshot write failed for %s", path,
                  exc_info=True)
        return None


class HealthSampler:
    """The background sampler: a daemon thread that writes
    `<dir>/health.json` every `interval` seconds until stopped, plus
    one final snapshot at stop so the file always reflects the sweep's
    end state. `tracer_fn` is read at each tick (not captured), so a
    `fresh_run` swap mid-flight is picked up automatically."""

    def __init__(self, store_base, interval: float,
                 tracer_fn=trace.get_current, extra_fn=None):
        self.path = Path(store_base) / HEALTH_NAME
        self.interval = float(interval)
        self._tracer_fn = tracer_fn
        # owner-specific snapshot section (the serve daemon's "serve"
        # dict), read at each tick like the tracer; None = core only
        self._extra_fn = extra_fn
        self._seq = 0
        self._t0 = time.monotonic()
        # serializes the tick thread against /healthz handler threads
        # (both call write_snapshot): seq stays strictly increasing
        # and two writers can't interleave on the shared temp path
        self._wlock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="obs-health", daemon=True)

    def start(self) -> "HealthSampler":
        events.emit("health_sample", seq=0,
                    interval_s=self.interval, path=str(self.path))
        self.write_snapshot()
        self._thread.start()
        return self

    def write_snapshot(self) -> dict:
        with self._wlock:
            self._seq += 1
            extra = None
            if self._extra_fn is not None:
                try:
                    extra = self._extra_fn()
                except Exception:
                    log.debug("health extra section failed",
                              exc_info=True)
            snap = health_snapshot(self._tracer_fn(), seq=self._seq,
                                   started_mono=self._t0, extra=extra)
            write_health(self.path, snap)
        return snap

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.write_snapshot()
            except Exception:
                # never let a bad tick kill the sampler thread
                log.debug("health sample tick failed", exc_info=True)

    def stop(self) -> None:
        """Stop the thread and write the final snapshot."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=max(5.0, 2 * self.interval))
        try:
            snap = self.write_snapshot()
            events.emit("health_sample", seq=snap["heartbeat"]["seq"],
                        final=True)
        except Exception:
            log.debug("final health snapshot failed", exc_info=True)


def maybe_start_health_sampler(store_base,
                               tracer_fn=trace.get_current,
                               extra_fn=None) -> HealthSampler | None:
    """Start the sampler when JEPSEN_TPU_HEALTH_INTERVAL_S enables it;
    None (and zero work) otherwise — the sweep's one-line integration
    point."""
    interval = health_interval_s()
    if interval is None:
        return None
    return HealthSampler(store_base, interval, tracer_fn=tracer_fn,
                         extra_fn=extra_fn).start()
