"""Sweep-wide tracing and metrics, stdlib only.

Counterpart of `jepsen_tpu/trace.py` (the tracer, the metrics registry,
the Chrome export and the interval helpers the attribution report
walks):

  * `span("pack", bucket=i)`: nestable wall-clock spans recorded into a
    thread-safe per-sweep `Tracer`, one Chrome-trace track per thread
    (the pack-h2d thread records on its own);
  * a metrics registry: counters (`buckets_dispatched`, `h2d_bytes`,
    `pad_waste_cells`, ...), gauges (`inflight_depth`, `runs_total`)
    and histograms (per-phase durations land in `phase.<name>`);
  * device windows on a synthetic "device" track (`device_complete`):
    each bucket's dispatch → its CUDA event seen complete, spilling to
    "device-2", ... while windows overlap;
  * Chrome trace-event JSON export (`trace.json`, loadable in Perfetto)
    and a `metrics.json` summary, both written atomically;
  * `profile_session`: a `torch.profiler` capture of a region behind
    `JEPSEN_TPU_JAX_PROFILE=1`, the counterpart of the reference's
    `jax_profile_session`.

  * the worker trace fabric of the pooled ingest: each spawned encode
    worker records its spans into its own tracer and spools them to
    `<store>/trace-<pid>.jsonl` (`ensure_worker_tracer`,
    `flush_worker_spool`), and `merge_traces` folds every spool of the
    sweep into `trace.json` as that worker's own pid track;
  * the mesh sweep's per-shard exports (`export_shard_trace`:
    `<store>/trace-shard<k>.json`) and the coordinator's cross-shard
    merge (`merge_shard_traces`).

`JEPSEN_TPU_TRACE=0` swaps in the `NullTracer`: no file is written and
a disabled span costs one call.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import uuid
from pathlib import Path

from . import gates

log = logging.getLogger(__name__)

#: The declared metric-name registry (the reference's names the port
#: records, and the race counters of `Linearizable`, which only the
#: port has). The metrics surface is keyed by
#: string, so a typo silently forks a series; lint rule JT-TRACE-002
#: checks every `counter("...")`/`gauge`/`histogram` literal in the
#: package against this set (and that the KIND matches), so a new
#: metric must be declared here before it can ship.
DECLARED_METRICS: dict[str, frozenset] = {
    "counters": frozenset({
        "bucket_splits", "buckets_dispatched", "buckets_resolved",
        "cache_hits", "cache_misses", "cost_records",
        "donated_bytes", "fleet_failovers", "fleet_fences",
        "fleet_replayed_verdicts", "fleet_spills", "h2d_bytes",
        "kernel.cyclic_histories", "kernel.stats_records",
        "native_fallback", "oom_retries", "pad_waste_cells",
        "planner.cold_starts", "planner.decisions",
        "planner.fallbacks", "planner.pred_checked",
        "quarantined", "race_device_agree", "race_device_disagree",
        "race_device_error", "runs_verdicted",
        "serve_backpressure", "serve_folds", "serve_replays",
        "serve_requests", "serve_verdicts", "shm_bytes",
        "shm_stale_reclaimed", "sidecar_upgrades", "split.native",
        "split.python", "warm_copy_bytes", "watchdog_timeouts",
        "worker_spans",
    }),
    "gauges": frozenset({"fleet_daemons_live",
                         "fleet_epoch", "hbm_device_bytes",
                         "hbm_modeled_bytes", "inflight_depth",
                         "planner.pred_err_permille",
                         "reorder_depth", "resident_executables",
                         "runs_total", "serve_pending",
                         "serve_tenants"}),
    "histograms": frozenset({"bucket_cells",
                             "fleet_failover_ms",
                             "kernel.backtracks",
                             "kernel.closure_rounds", "kernel.edges",
                             "kernel.margin", "kernel.scc_max",
                             "serve_fold_histories",
                             "serve_latency_ms"}),
}

#: Sanctioned dynamic-name families: an f-string metric name must
#: start with one of these (`phase.<key>`, `device.<kernel>`,
#: `native_fallback.<component>`, `worker.<stage>` — the per-task
#: stage-seconds digests ingest relays from pool workers;
#: `planner.<lever>` — per-lever modeled-decision counters;
#: `race_won_<side>` — which side of `Linearizable`'s race answered).
METRIC_PREFIXES = ("phase.", "device.", "native_fallback.", "worker.",
                   "serve.", "planner.", "fleet.", "race_won_")

#: Synthetic tid for the device track (real thread idents are pthread
#: addresses, nowhere near this; named tracks count down from here).
DEVICE_TID = 2 ** 31 - 1

_MLOCK = threading.Lock()   # shared metric read-modify-write lock


def atomic_write_text(path, text: str) -> Path:
    """Temp-file + `os.replace` persistence for trace.json/metrics.json:
    a crash mid-flush leaves the previous complete file (or none),
    never a truncated JSON."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f".{p.name}.{os.getpid()}.tmp")
    try:
        tmp.write_text(text)
        os.replace(tmp, p)
    except BaseException:
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        raise
    return p


def enabled() -> bool:
    """The JEPSEN_TPU_TRACE gate (default on)."""
    return gates.get("JEPSEN_TPU_TRACE")


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with _MLOCK:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Summary-stat histogram: count/sum/min/max plus powers-of-two
    magnitude buckets."""

    __slots__ = ("count", "total", "min", "max", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.buckets: dict[int, int] = {}   # floor(log2(v)) -> count

    def observe(self, v: float) -> None:
        with _MLOCK:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            b = math.floor(math.log2(v)) if v > 0 else 0
            self.buckets[b] = self.buckets.get(b, 0) + 1

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max,
                "mean": (self.total / self.count) if self.count else None,
                "log2_buckets": {str(k): v for k, v in
                                 sorted(self.buckets.items())}}


class _NullMetric:
    """Counter/gauge/histogram stand-in on the disabled path."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


_NULL_METRIC = _NullMetric()


# ---------------------------------------------------------------------------
# Span context managers
# ---------------------------------------------------------------------------

class _SpanCM:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer._complete(self._name, self._t0, time.perf_counter(),
                               self._cat, self._args)
        return False


class _NullCM:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCM()


# ---------------------------------------------------------------------------
# Tracers
# ---------------------------------------------------------------------------

class NullTracer:
    """The JEPSEN_TPU_TRACE=0 tracer: every operation is a no-op, except
    `phase`, which still returns the measured duration."""

    enabled = False
    run = None
    scope = "run"
    trace_id = None
    spool_dir = None
    pid = None

    def span(self, name: str, **args):
        return _NULL_CM

    def phase(self, key: str, t0: float) -> float:
        return time.perf_counter() - t0

    def device_complete(self, name, t0, t1=None, **args):
        pass

    def add_span(self, name, t0, t1, track=None, clock="perf", **args):
        pass

    def instant(self, name, track=None, **args):
        pass

    def counter(self, name: str):
        return _NULL_METRIC

    def gauge(self, name: str):
        return _NULL_METRIC

    def histogram(self, name: str):
        return _NULL_METRIC

    def phase_totals(self) -> dict:
        return {}

    def export(self, path) -> None:
        return None

    def export_metrics(self, path) -> None:
        return None


class Tracer:
    """A per-sweep trace + metrics recorder. Thread-safe: spans from any
    thread land on that thread's own track (an event append is one
    GIL-atomic list.append; metric updates take the shared lock)."""

    enabled = True

    def __init__(self, run: str | None = None,
                 max_events: int | None = None, scope: str = "run"):
        self.run = run
        # "sweep": the tracer spans many runs (analyze-store), and only
        # its owner exports it, once, at the end
        self.scope = scope
        # the RECORDING process's pid: the export stamps events with it
        self.pid = os.getpid()
        # sweep-unique id: worker spools record it, and merge_traces
        # folds only spools carrying THIS id (a stale spool of an
        # earlier sweep in the same store never contaminates)
        self.trace_id = uuid.uuid4().hex[:16]
        # where pool workers spool their spans (trace-<pid>.jsonl);
        # None = workers don't spool. The sweep owner (analyze-store)
        # points it at the store.
        self.spool_dir = None
        # bounded event buffer: overflow is counted (dropped_events in
        # metrics.json), never silent; phase totals and metrics keep
        # accumulating past the cap
        if max_events is None:
            max_events = gates.get("JEPSEN_TPU_TRACE_MAX_EVENTS")
        self._max_events = max_events
        self._dropped = 0
        self._origin = time.perf_counter()
        # CLOCK_MONOTONIC -> perf_counter offset, for external spans
        # measured with time.monotonic
        self._mono_off = time.perf_counter() - time.monotonic()
        self._events: list[dict] = []
        self._threads: dict[int, str] = {}
        self._tracks: dict[str, int] = {"device": DEVICE_TID}
        # per named-track lane ends (µs): concurrently-open windows (two
        # buckets in flight) spill to "name-2", "name-3"…, so no tid
        # carries partially overlapping X events
        self._lanes: dict[str, list[float]] = {}
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self._phase_totals: dict[str, float] = {}

    # -- recording --------------------------------------------------------

    def span(self, name: str, *, cat: str = "span", **args):
        """A nestable wall-clock span: `with tracer.span("pack",
        bucket=i): ...` records one complete ("X") event on the calling
        thread's track."""
        return _SpanCM(self, name, cat, args or None)

    def _room(self) -> bool:
        if len(self._events) >= self._max_events:
            self._dropped += 1
            return False
        return True

    def _complete(self, name: str, t0: float, t1: float, cat: str,
                  args) -> None:
        if not self._room():
            return
        tid = threading.get_ident()
        if tid not in self._threads:
            self._threads[tid] = threading.current_thread().name
        self._events.append({
            "name": name, "cat": cat, "ph": "X", "tid": tid,
            "ts": (t0 - self._origin) * 1e6,
            "dur": max(0.0, (t1 - t0) * 1e6),
            **({"args": args} if args else {})})

    def phase(self, key: str, t0: float) -> float:
        """Record a completed phase span started at perf_counter() time
        `t0`, accumulate its per-phase total + histogram, and return
        the duration."""
        t1 = time.perf_counter()
        dt = t1 - t0
        self._complete(key, t0, t1, "phase", None)
        with _MLOCK:
            self._phase_totals[key] = self._phase_totals.get(key, 0.0) + dt
        self.histogram(f"phase.{key}").observe(dt)
        return dt

    def device_complete(self, name: str, t0: float,
                        t1: float | None = None, **args) -> None:
        """A device-track event: one dispatch's window from its enqueue
        to the host seeing it complete (t0/t1 in perf_counter time; t1
        defaults to now)."""
        if t0 is None:
            return
        t1 = time.perf_counter() if t1 is None else t1
        if self._room():
            ts = (t0 - self._origin) * 1e6
            dur = max(0.0, (t1 - t0) * 1e6)
            self._events.append({
                "name": name, "cat": "device", "ph": "X",
                "tid": self._laned_tid("device", ts, ts + dur),
                "ts": ts, "dur": dur,
                **({"args": args} if args else {})})
        self.histogram(f"device.{name}").observe(t1 - t0)

    def add_span(self, name: str, t0: float, t1: float,
                 track: str | None = None, clock: str = "perf",
                 **args) -> None:
        """Record an externally measured span (`clock="monotonic"`
        converts time.monotonic stamps)."""
        if clock == "monotonic":
            t0 += self._mono_off
            t1 += self._mono_off
        if track is None:
            self._complete(name, t0, t1, "span", args or None)
            return
        if not self._room():
            return
        ts = (t0 - self._origin) * 1e6
        dur = max(0.0, (t1 - t0) * 1e6)
        self._events.append({
            "name": name, "cat": "span", "ph": "X",
            "tid": self._laned_tid(track, ts, ts + dur),
            "ts": ts, "dur": dur,
            **({"args": args} if args else {})})

    def instant(self, name: str, track: str | None = None,
                **args) -> None:
        """A zero-duration mark ("i" event): fault-path punctuation
        (watchdog fired, fault injected). Lands on the calling thread's
        track, or a named track when given."""
        if not self._room():
            return
        tid = threading.get_ident()
        if track is not None:
            tid = self._track_tid(track)
        elif tid not in self._threads:
            self._threads[tid] = threading.current_thread().name
        self._events.append({
            "name": name, "cat": "instant", "ph": "i", "s": "t",
            "tid": tid,
            "ts": (time.perf_counter() - self._origin) * 1e6,
            **({"args": args} if args else {})})

    def _track_tid(self, name: str) -> int:
        with _MLOCK:
            tid = self._tracks.get(name)
            if tid is None:
                tid = DEVICE_TID - len(self._tracks)
                self._tracks[name] = tid
            return tid

    def _laned_tid(self, base: str, ts_us: float, end_us: float) -> int:
        """The tid for a window on named track `base`, spilling
        overlapping windows to numbered sibling lanes."""
        with _MLOCK:
            lanes = self._lanes.setdefault(base, [])
            for i, lane_end in enumerate(lanes):
                if lane_end <= ts_us:
                    lanes[i] = end_us
                    break
            else:
                i = len(lanes)
                lanes.append(end_us)
        return self._track_tid(base if i == 0 else f"{base}-{i + 1}")

    # -- metrics ----------------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with _MLOCK:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with _MLOCK:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with _MLOCK:
                h = self._hists.setdefault(name, Histogram())
        return h

    def phase_totals(self) -> dict[str, float]:
        """Accumulated seconds per phase key."""
        with _MLOCK:
            return dict(self._phase_totals)

    # -- export -----------------------------------------------------------

    def origin_mono(self) -> float:
        """This tracer's ts=0 in CLOCK_MONOTONIC seconds: the point
        worker spools (recorded with time.monotonic, system-wide on
        Linux) align to."""
        return self._origin - self._mono_off

    def chrome_events(self) -> list[dict]:
        """The Chrome trace-event list: one metadata-named track per
        recording thread plus the synthetic device/named tracks; the
        timed events follow, sorted by ts. Events carry the recording
        process's pid."""
        pid = self.pid
        ev: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": self.run or "jepsen-tpu"}}]
        for tid, tname in sorted(self._threads.items()):
            ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
        for tname, tid in sorted(self._tracks.items()):
            ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
        ev.extend({**e, "pid": e.get("pid", pid)}
                  for e in sorted(list(self._events),
                                  key=lambda e: e["ts"]))
        return ev

    def export(self, path) -> Path:
        """Write Chrome trace-event JSON to `path`; returns the path."""
        return atomic_write_text(
            path, json.dumps({"traceEvents": self.chrome_events(),
                              "displayTimeUnit": "ms"}))

    def metrics_dict(self) -> dict:
        with _MLOCK:
            return {
                "counters": {k: c.value for k, c in
                             sorted(self._counters.items())},
                "gauges": {k: g.value for k, g in
                           sorted(self._gauges.items())},
                "histograms": {k: h.summary() for k, h in
                               sorted(self._hists.items())},
                "phase_totals_secs": {k: round(v, 6) for k, v in
                                      sorted(self._phase_totals.items())},
                "dropped_events": self._dropped,
            }

    def export_metrics(self, path) -> Path:
        return atomic_write_text(
            path, json.dumps(self.metrics_dict(), indent=2))


# ---------------------------------------------------------------------------
# The current tracer
# ---------------------------------------------------------------------------

_NULL = NullTracer()
_current: Tracer | NullTracer | None = None


def get_current() -> Tracer | NullTracer:
    """The process's current tracer, lazily built from the env gate."""
    t = _current
    if t is None:
        return _init()
    return t


def _init() -> Tracer | NullTracer:
    global _current
    _current = Tracer() if enabled() else _NULL
    return _current


def set_current(t: Tracer | NullTracer | None):
    """Install `t` as the current tracer (None = re-init lazily)."""
    global _current
    _current = t
    return _current


def reset() -> None:
    """Drop the current tracer; the next use re-reads the env gate."""
    set_current(None)


def fresh_run(run: str | None = None,
              scope: str = "run") -> Tracer | NullTracer:
    """Install a FRESH tracer (honoring the env gate), so a sweep's
    trace.json covers exactly that sweep."""
    return set_current(Tracer(run=run, scope=scope)
                       if enabled() else _NULL)


def span(name: str, **args):
    """`with trace.span("pack", bucket=i): ...` on the current tracer;
    the disabled path returns the shared no-op context manager."""
    t = _current
    if t is None:
        t = _init()
    if not t.enabled:
        return _NULL_CM
    return t.span(name, **args)


def counter(name: str):
    return get_current().counter(name)


def gauge(name: str):
    return get_current().gauge(name)


def histogram(name: str):
    return get_current().histogram(name)


# ---------------------------------------------------------------------------
# Interval arithmetic, shared with the attribution report
# ---------------------------------------------------------------------------

def merge_intervals(spans):
    """Sorted union of (start, end) pairs."""
    out: list = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_seconds(spans_a, spans_b) -> float:
    """Total seconds where some span in `a` intersects some span in
    `b` (both lists of (start, end) pairs); each side is merged first
    so double-counting can't inflate the number."""
    if not spans_a or not spans_b:
        return 0.0
    total, bi = 0.0, 0
    b = merge_intervals(spans_b)
    for s, e in merge_intervals(spans_a):
        while bi < len(b) and b[bi][1] <= s:
            bi += 1
        j = bi
        while j < len(b) and b[j][0] < e:
            total += max(0.0, min(e, b[j][1]) - max(s, b[j][0]))
            j += 1
    return total


# ---------------------------------------------------------------------------
# The cross-process trace fabric: per-worker span spools + merge
# ---------------------------------------------------------------------------
#
# Pool workers are separate (spawned) processes. The parent hands each
# one a small context (`worker_ctx`: trace id + spool dir + a monotonic
# send stamp); the worker installs its own Tracer
# (`ensure_worker_tracer`), records spans normally, and
# `flush_worker_spool` (called per encode task) appends them to
# `<spool_dir>/trace-<pid>.jsonl` — one JSON line per event, flushed as
# written, torn tails skipped on load — and returns a compact digest
# the parent folds into its own metrics. Timestamps are raw
# CLOCK_MONOTONIC seconds: monotonic is system-wide on Linux, so
# `merge_traces` aligns them against the parent tracer's
# `origin_mono()` with no cross-clock arithmetic.

#: Worker spool naming: this module is the only place the convention
#: exists.
SPOOL_PREFIX = "trace-"
SPOOL_VERSION = 1


def worker_trace_enabled() -> bool:
    """The JEPSEN_TPU_WORKER_TRACE gate (default on; moot when
    JEPSEN_TPU_TRACE=0 — no tracer, no spools)."""
    return gates.get("JEPSEN_TPU_WORKER_TRACE")


def spool_path(spool_dir, pid: int) -> Path:
    return Path(spool_dir) / f"{SPOOL_PREFIX}{pid}.jsonl"


def iter_spools(spool_dir):
    """The worker spool files under a directory, sorted."""
    return sorted(Path(spool_dir).glob(f"{SPOOL_PREFIX}*.jsonl"))


def clean_spools(spool_dir) -> int:
    """Remove stale worker spools (sweep start: spools are per-sweep
    derived artifacts keyed by trace id; old ones only cost merge
    filtering and disk). Returns the count removed."""
    n = 0
    try:
        for p in iter_spools(spool_dir):
            try:
                p.unlink()
                n += 1
            except OSError:
                pass
    except OSError:
        pass
    return n


def worker_ctx() -> dict | None:
    """The context the parent hands each pool worker, or None when
    workers should not spool (tracing off, worker tracing gated off,
    or no spool dir registered on the current tracer) — None costs
    the worker nothing (`ensure_worker_tracer` returns immediately)."""
    t = get_current()
    if not t.enabled or t.spool_dir is None \
            or not worker_trace_enabled():
        return None
    return {"trace_id": t.trace_id, "dir": str(t.spool_dir),
            "t_send": time.monotonic()}


#: Worker-process spool state: {"f": file|None, "trace_id": str,
#: "thr": set of tids whose names were already spooled, "tracer": T}.
_wspool: dict | None = None


def ensure_worker_tracer(tctx: dict | None) -> None:
    """Install this worker process's spooling tracer (idempotent per
    trace id). Called at the top of every pooled encode task; a None
    context (or tracing disabled in the inherited env) is a no-op, so
    the JEPSEN_TPU_TRACE=0 path creates no tracer and no file."""
    global _wspool
    if not tctx or not enabled():
        # not spooling: in a POOL WORKER, park the NullTracer so the
        # per-task spans don't accumulate in an enabled tracer's
        # buffer nobody ever flushes or exports (up to _max_events
        # retained per worker over a long sweep, pure waste). Only in
        # a real child process — an in-process caller (tests, the
        # serial path) must keep its own current tracer.
        if _wspool is None:
            import multiprocessing as mp
            if mp.parent_process() is not None:
                set_current(_NULL)
        return
    ws = _wspool
    if ws is not None and ws["trace_id"] == tctx["trace_id"]:
        set_current(ws["tracer"])
        return
    close_worker_spool()
    tr = Tracer(run=f"ingest-worker-{os.getpid()}", scope="worker")
    f = None
    try:
        p = spool_path(tctx["dir"], os.getpid())
        f = open(p, "w")
        f.write(json.dumps({
            "k": "meta", "v": SPOOL_VERSION, "pid": os.getpid(),
            "trace_id": tctx["trace_id"], "proc": "ingest-worker",
            # the clock handshake: t_recv - t_send bounds the spawn/
            # queue latency; on a shared CLOCK_MONOTONIC (Linux) the
            # alignment error is zero and this is pure diagnostics
            "t_send": tctx.get("t_send"),
            "t_recv": time.monotonic()}) + "\n")
        f.flush()
    except OSError:
        log.debug("worker spool open failed", exc_info=True)
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        f = None   # spans still feed the einfo digest
    _wspool = {"f": f, "trace_id": tctx["trace_id"], "thr": set(),
               "tracer": tr}
    set_current(tr)


def flush_worker_spool() -> dict | None:
    """Spool every event recorded since the last flush (one JSON line
    each, flushed — the torn-tail discipline) and return the compact
    digest the parent aggregates: span count + per-name stage seconds.
    The flushed events are dropped from the in-memory buffer, so a
    long sweep's worker holds one task's events, not the sweep's."""
    ws = _wspool
    if ws is None:
        return None
    tr: Tracer = ws["tracer"]
    evs = list(tr._events)
    tr._events.clear()
    om = tr.origin_mono()
    stage: dict[str, float] = {}
    lines: list[dict] = []
    for tid, name in list(tr._threads.items()):
        if tid not in ws["thr"]:
            ws["thr"].add(tid)
            lines.append({"k": "thr", "tid": tid, "name": name})
    for name, tid in list(tr._tracks.items()):
        if tid not in ws["thr"]:
            ws["thr"].add(tid)
            lines.append({"k": "thr", "tid": tid, "name": name})
    spans = 0
    for e in evs:
        t0 = om + e["ts"] / 1e6
        rec = {"k": "ev", "name": e["name"], "cat": e["cat"],
               "ph": e["ph"], "tid": e["tid"], "t0": round(t0, 6)}
        if e["ph"] == "X":
            spans += 1
            rec["t1"] = round(t0 + e["dur"] / 1e6, 6)
            stage[e["name"]] = stage.get(e["name"], 0.0) \
                + e["dur"] / 1e6
        if e.get("args"):
            rec["args"] = e["args"]
        lines.append(rec)
    if ws["f"] is not None and lines:
        try:
            ws["f"].write("".join(json.dumps(ln) + "\n"
                                  for ln in lines))
            ws["f"].flush()
        except OSError:
            log.debug("worker spool append failed", exc_info=True)
    return {"spans": spans,
            "stage_secs": {k: round(v, 6) for k, v in stage.items()}}


def close_worker_spool() -> None:
    """Drop the worker spool state (tests, or a worker re-seeded for a
    different sweep)."""
    global _wspool
    ws = _wspool
    _wspool = None
    if ws is not None and ws["f"] is not None:
        try:
            ws["f"].close()
        except OSError:
            pass


def load_spool(path):
    """One spool file -> (meta | None, {tid: name}, [event dicts]).
    Unparseable or incomplete lines — the crash-torn tail — are
    skipped, mirroring VerdictJournal.load; a spool whose meta line
    never landed returns meta None (the merge then ignores it)."""
    meta = None
    threads: dict[int, str] = {}
    events: list[dict] = []
    try:
        lines = Path(path).read_text().splitlines()
    except OSError:
        return None, threads, events
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if not isinstance(rec, dict):
            continue
        k = rec.get("k")
        if k == "meta" and meta is None:
            if "pid" in rec and "trace_id" in rec:
                meta = rec
        elif k == "thr":
            try:
                threads[int(rec["tid"])] = str(rec["name"])
            except (KeyError, TypeError, ValueError):
                continue
        elif k == "ev":
            if "name" in rec and "t0" in rec \
                    and isinstance(rec["t0"], (int, float)):
                events.append(rec)
    return meta, threads, events


def merge_traces(tracer, spool_dir=None) -> list[dict]:
    """The merged Chrome trace-event list: the parent tracer's own
    events plus every worker spool under `spool_dir` (default: the
    tracer's registered spool_dir) whose trace id matches — each
    worker becomes its own REAL-pid process track with process/thread
    name metadata, and its monotonic timestamps align to the parent's
    timeline via `origin_mono()` (clamped at 0: a span that somehow
    predates the parent origin must not produce a negative ts Chrome
    renders at the epoch). Metadata events lead, timed events follow
    sorted by ts — the same golden shape as a single-process export."""
    if not getattr(tracer, "enabled", False):
        return []
    evs = tracer.chrome_events()
    d = spool_dir if spool_dir is not None \
        else getattr(tracer, "spool_dir", None)
    if d is None:
        return evs
    meta_evs = [e for e in evs if e["ph"] == "M"]
    x_evs = [e for e in evs if e["ph"] != "M"]
    om = tracer.origin_mono()
    try:
        spools = iter_spools(d)
    except OSError:
        spools = []
    for p in spools:
        meta, threads, wevents = load_spool(p)
        if meta is None or meta.get("trace_id") != tracer.trace_id:
            continue
        try:
            pid = int(meta["pid"])
        except (TypeError, ValueError):
            continue
        meta_evs.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"{meta.get('proc', 'worker')} {pid}"}})
        for tid, name in sorted(threads.items()):
            meta_evs.append({"name": "thread_name", "ph": "M",
                             "pid": pid, "tid": tid,
                             "args": {"name": name}})
        for w in wevents:
            ts = max(0.0, (float(w["t0"]) - om) * 1e6)
            e = {"name": w["name"], "cat": w.get("cat", "span"),
                 "ph": w.get("ph", "X"), "pid": pid,
                 "tid": w.get("tid", 0), "ts": ts}
            if e["ph"] == "X":
                t1 = float(w.get("t1", w["t0"]))
                e["dur"] = max(0.0, (t1 - float(w["t0"])) * 1e6)
            else:
                e["s"] = "t"
            if w.get("args"):
                e["args"] = w["args"]
            x_evs.append(e)
    x_evs.sort(key=lambda e: e["ts"])
    return meta_evs + x_evs


# ---------------------------------------------------------------------------
# The mesh sweep's cross-shard trace merge (analyze-store --mesh).
#
# Shards sweep one store at once from several processes (or hosts),
# which cannot share a spool directory's lifecycle and whose pids may
# collide. Each shard exports its own merged Chrome event list (parent
# and its workers) as `<store>/trace-shard<k>.json`, stamped with the
# tracer's CLOCK_MONOTONIC origin; the coordinator folds the shard files
# into one trace.json, shifting each shard's timestamps to the earliest
# origin and remapping pids into per-shard strides so that tracks never
# collide. On one machine monotonic is system-wide and the merged
# timeline is exact; across hosts the residual error is their clocks'
# skew, which the per-shard shares (each on its own timeline) never see.
# ---------------------------------------------------------------------------

#: Per-shard merged-trace artifact naming (`.json`, not a `.jsonl` spool).
SHARD_TRACE_PREFIX = "trace-shard"

#: pid stride separating shard tracks in the merged trace: real pids
#: stay readable modulo the stride, and two hosts' equal pids cannot
#: fold into one track.
_SHARD_PID_STRIDE = 1 << 24


def shard_trace_path(store_base, shard: int) -> Path:
    return Path(store_base) / f"{SHARD_TRACE_PREFIX}{shard}.json"


def shard_spool_dir(store_base, shard: int) -> Path:
    """The worker-spool subdirectory of ONE mesh shard. Spools are
    keyed by pid and two hosts' workers can share one, so each shard
    spools into (and cleans, at its own sweep start) a directory of its
    own; the coordinator removes them after a fully covered merge."""
    return Path(store_base) / f"spool-shard{shard}"


def export_shard_trace(tracer, store_base, shard: int, n_shards: int,
                       events: list | None = None) -> Path:
    """Write one shard's merged Chrome events (its own spans and its
    worker spools) as `trace-shard<k>.json`, with the shard geometry
    and the tracer's monotonic origin for the cross-shard merge."""
    if events is None:
        events = merge_traces(tracer, store_base)
    return atomic_write_text(
        shard_trace_path(store_base, shard),
        json.dumps({"traceEvents": events, "displayTimeUnit": "ms",
                    "shard": shard, "shards": n_shards,
                    "origin_mono": tracer.origin_mono()}))


def load_shard_trace(path) -> dict | None:
    """One shard trace file as a dict, or None when it is missing or
    does not parse (a lost shard's file never landed)."""
    try:
        v = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return None
    return v if isinstance(v, dict) and "traceEvents" in v else None


def merge_shard_traces(store_base, shards):
    """Fold every present `trace-shard<k>.json` under `store_base` into
    one Chrome event list. Returns (merged events, {shard: that shard's
    own unshifted events}); the second feeds the report's per-shard
    stage shares, each computed on its shard's own timeline. Every
    process track of shard k is renamed `shard<k>:<name>`."""
    per_shard: dict[int, list] = {}
    loads = []
    for k in shards:
        d = load_shard_trace(shard_trace_path(store_base, k))
        if d is None:
            continue
        per_shard[k] = d["traceEvents"]
        loads.append((k, d))
    if not loads:
        return [], per_shard
    origins = [d["origin_mono"] for _k, d in loads
               if isinstance(d.get("origin_mono"), (int, float))]
    o0 = min(origins) if origins else 0.0
    meta_evs: list[dict] = []
    x_evs: list[dict] = []
    for k, d in loads:
        om = d.get("origin_mono")
        shift_us = (om - o0) * 1e6 \
            if isinstance(om, (int, float)) else 0.0
        for e in d["traceEvents"]:
            if not isinstance(e, dict):
                continue
            e = dict(e)
            try:
                e["pid"] = k * _SHARD_PID_STRIDE + int(e.get("pid", 0))
            except (TypeError, ValueError):
                e["pid"] = k * _SHARD_PID_STRIDE
            if e.get("ph") == "M":
                if e.get("name") == "process_name":
                    args = dict(e.get("args") or {})
                    args["name"] = f"shard{k}:{args.get('name', '')}"
                    e["args"] = args
                meta_evs.append(e)
            else:
                e["ts"] = float(e.get("ts", 0.0)) + shift_us
                x_evs.append(e)
    x_evs.sort(key=lambda e: e["ts"])
    return meta_evs + x_evs, per_shard


# ---------------------------------------------------------------------------
# Optional torch.profiler capture (JEPSEN_TPU_JAX_PROFILE=1)
# ---------------------------------------------------------------------------

def profile_enabled() -> bool:
    """The JEPSEN_TPU_JAX_PROFILE gate (default off): the same gate the
    reference's profiler session reads."""
    return gates.get("JEPSEN_TPU_JAX_PROFILE")


class profile_session:
    """Wrap a region in a `torch.profiler` capture (CPU and, where there
    is a card, CUDA activities) when JEPSEN_TPU_JAX_PROFILE=1, exporting
    a Chrome trace to `<out_dir>/trace.json`; otherwise a no-op that
    never imports the profiler. A profiler that fails to start or stop
    degrades to a warning: observability never sinks the run."""

    def __init__(self, out_dir):
        self.out_dir = Path(out_dir)
        self.path: Path | None = None
        self._prof = None

    def __enter__(self):
        if profile_enabled():
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                self.out_dir.mkdir(parents=True, exist_ok=True)
                self._prof = profile(activities=acts)
                self._prof.__enter__()
                log.info("torch.profiler capture -> %s", self.out_dir)
            except Exception:
                self._prof = None
                log.warning("torch.profiler capture failed to start",
                            exc_info=True)
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            try:
                self._prof.__exit__(None, None, None)
                p = self.out_dir / "trace.json"
                self._prof.export_chrome_trace(str(p))
                self.path = p
            except Exception:
                log.warning("torch.profiler capture failed to stop",
                            exc_info=True)
            self._prof = None
        return False
