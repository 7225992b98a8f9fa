"""The device cost observatory: each bucket dispatch's work, counted from
its shapes, joined with its device time, feeding a persistent costdb.

Counterpart of `jepsen_tpu/obs/device.py`, behind the same gate
(`JEPSEN_TPU_COSTDB`, default off: no file, no event, one gate read a
dispatch). In three parts:

  * **capture** — `observe()` opens one record per (kernel flags +
    formulation + bucket geometry) key the first time a dispatch of it
    is enqueued. The reference reads XLA's `cost_analysis()`; torch
    has none, so the port counts the `closure_square` work a dispatch
    launched (`_closure_work`: each active round 2·B·T_pad³ int8
    operations and 4·B·T_pad² + B bytes, each skipped round its bytes,
    from the rounds the bucket's closures ran) and stores the mean per
    dispatch as `cost` (`analysis: "shapes"`). `memory` is measured
    around the key's first dispatch on the card: its input and output
    bytes and the caching allocator's peak above what was allocated
    before it (`torch.cuda.max_memory_allocated`, whose peak is reset
    there); null on the CPU.
  * **join** — `begin_dispatch`/`close_dispatch` bracket each bucket
    dispatch and accumulate its window into the key's record. On the
    card the window is two CUDA events on the compute stream: one
    recorded after the stream waits for the bucket's copy, the other
    the dispatch's end event, read by `elapsed_time` once the host has
    seen it complete (no synchronise is added) — the device's own time
    for the dispatch, however many buckets are in flight. On the CPU it
    is the host window from enqueue to resolve, tagged `"estimated"`.
    (The tracer's "bucket" window stays the reference's, enqueue to the
    host seeing the event, so trace.json keeps its parity; with two
    buckets in flight that window over-counts the device's busy time
    and this one does not.) Pending windows are keyed by the dispatch
    object itself, not by the id of its flags tensor, whose id a freed
    tensor can hand to another bucket in flight. The same bracket
    publishes the residency gauges (`parallel.residency`). A dispatch
    over a mesh has one event pair a device of it (`open_mesh_window`),
    each read on its own device — `elapsed_time` never spans two cards —
    and its window is the longest of them; its record's key carries the
    reference's single-device flag (a mesh key never has `use_pallas`).
  * **persist** — `flush()` appends one JSON line per record to
    `<store>/costdb.jsonl` (`store.append_costdb`); `merge_records`
    folds the records of several shards into one deduplicated set.

`formulation` names the route the squaring took: `"cuda-int8"` for the
hand kernel (`csrc/closure_square.cu`, u8 tensor-core products) on the
card, `"closure_square_ref"` for its plain version on the CPU, and a
caller's own squaring (`square=`) by its function's name.

The line schema and the key layout are the reference's, so
`merge_records`, the planner's `_mode_key` and
`attribution.device_section` read either package's records. Only the
costdb file write is best-effort: a CUDA error met while reading an
event, the allocator's stats or a round count is raised (what
`supervisor.must_end_sweep` names ends the sweep), never hidden in a
debug log; other failures degrade to one. Verdicts are byte-identical
with the gate on or off.

Module-level imports are stdlib-only (gates, trace); torch is touched
only inside functions, where the dispatch layer has loaded it already.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time

from .. import gates, trace

log = logging.getLogger(__name__)

#: Layout of the dispatch cost key, the reference's: (classify,
#: realtime, process_order, fused, use_pallas, use_int8, donate,
#: n_keys, max_pos, n_txns). In the port `use_pallas` and `use_int8`
#: both say "the hand kernel ran" and `donate` is always False.
_KEY_FIELDS = ("classify", "realtime", "process_order", "fused",
               "use_pallas", "use_int8", "donate", "n_keys",
               "max_pos", "n_txns")

_LOCK = threading.Lock()

#: (key_parts, B) -> mutable record dict.
_records: dict[tuple, dict] = {}

#: (key_parts, B) -> [summed flops, summed bytes] of the closed
#: dispatches, whose mean per dispatch is the record's `cost`.
_work: dict[tuple, list] = {}

#: dispatch object -> (record key, modeled bytes, start CUDA event or
#: None) for dispatches in flight.
_pending: dict = {}

_inflight_bytes = 0
_last_mem_poll = 0.0
#: The CUDA device the allocator's stats are polled on (None: no
#: dispatch on a card this sweep).
_poll_device = None


def enabled() -> bool:
    """The JEPSEN_TPU_COSTDB gate (default off)."""
    return gates.get("JEPSEN_TPU_COSTDB")


def residency_interval_s() -> float:
    """The JEPSEN_TPU_RESIDENCY_INTERVAL_S gate: minimum seconds
    between `torch.cuda.memory_stats()` polls (<=0 disables the poll)."""
    v = gates.get("JEPSEN_TPU_RESIDENCY_INTERVAL_S")
    return float(v) if v is not None else 0.0


def reset() -> None:
    """Drop every record and pending window (sweep start, tests): the
    observatory is per-sweep state like the tracer."""
    global _inflight_bytes, _last_mem_poll, _poll_device
    with _LOCK:
        _records.clear()
        _work.clear()
        _pending.clear()
        _inflight_bytes = 0
        _last_mem_poll = 0.0
        _poll_device = None


@contextlib.contextmanager
def _guard(what: str):
    """Best-effort telemetry, except for what must end the sweep: a
    CUDA error (or a kernel or device failure) is raised, anything
    else becomes a debug log."""
    try:
        yield
    except Exception as e:
        from .. import supervisor as sv
        if sv.must_end_sweep(e):
            raise
        log.debug("costdb %s failed", what, exc_info=True)


def formulation(device, square=None) -> str:
    """The route a dispatch's squaring takes (module doc)."""
    if square is not None:
        return getattr(square, "__name__", type(square).__name__)
    return "cuda-int8" if device.type == "cuda" else "closure_square_ref"


def dispatch_cost_key(kw: dict, shape, with_stats: bool, device,
                      single_device: bool = True) -> tuple:
    """THE cost key of one bucket dispatch (`_KEY_FIELDS`), with the
    kernel-stats marker appended only when on, as the reference's. A
    mesh dispatch (`single_device` false) keys `use_pallas` false, as the
    reference's mesh dispatches never take its Pallas kernel."""
    hand = kw.get("square") is None and device.type == "cuda"
    return (kw.get("classify", True), kw.get("realtime", False),
            kw.get("process_order", False), kw.get("fused"),
            hand and single_device, hand, False,
            shape.n_keys, shape.max_pos, shape.n_txns) \
        + (("stats",) if with_stats else ())


def _device_kind(device) -> str:
    if device.type != "cuda":
        return device.type
    import torch
    return torch.cuda.get_device_name(device)


def observe(key_parts: tuple, batch: dict, device, form: str,
            B: int | None = None, nbytes: int | None = None) -> tuple:
    """Open the record of (key_parts, batch size) unless it exists;
    returns (its key, whether it was opened now). `B` and `nbytes`
    override the batch's own size and bytes (a mesh dispatch's batch is
    its first row)."""
    global _poll_device
    shape = batch["shape"]
    if B is None:
        B = int(batch["appends"].shape[0])
    key = (tuple(key_parts), B)
    with _LOCK:
        if key in _records:
            return key, False
    if device.type == "cuda":
        _poll_device = device
    rec = {
        "key_parts": tuple(key_parts),
        "kernel": {f: key_parts[i] for i, f in enumerate(_KEY_FIELDS[:4])},
        "formulation": form,
        "donated": False,
        "geometry": {"B": B, "n_txns": shape.n_txns,
                     "n_keys": shape.n_keys, "max_pos": shape.max_pos,
                     "n_appends": shape.n_appends,
                     "n_reads": shape.n_reads},
        "backend": device.type,
        "device_kind": _device_kind(device),
        "analysis": "shapes",
        "cost": None,
        "memory": None,
        "argument_bytes_actual": _input_bytes(batch) if nbytes is None
        else nbytes,
        "windows": {"dispatches": 0, "device_secs": 0.0,
                    "min_secs": None, "max_secs": None, "histories": 0},
    }
    with _LOCK:
        fresh = key not in _records
        if fresh:
            _records[key] = rec
            _work[key] = [0.0, 0.0]
    if fresh:
        trace.counter("cost_records").inc()
    return key, fresh


def _input_bytes(batch: dict) -> int:
    import torch
    return sum(int(v.nbytes) for v in batch.values()
               if isinstance(v, torch.Tensor))


class Window:
    """One dispatch's measurement opened before its check is enqueued
    (`open_window`): its record key, input bytes, the start CUDA event
    (None on the CPU) and, for a record's first dispatch on the card,
    the allocator's bytes before it."""

    __slots__ = ("key", "nbytes", "start", "mem0")

    def __init__(self, key, nbytes, start, mem0):
        self.key = key
        self.nbytes = nbytes
        self.start = start
        self.mem0 = mem0


def open_window(kw: dict, batch: dict, with_stats: bool, device,
                stream=None) -> Window | None:
    """Before a bucket's check is enqueued on `stream` (the compute
    stream, after its wait for the bucket's copy): observe its record
    and record the start event. None with the gate off."""
    if not enabled():
        return None
    with _guard("open"):
        key, fresh = observe(
            dispatch_cost_key(kw, batch["shape"], with_stats, device),
            batch, device, formulation(device, kw.get("square")))
        start = mem0 = None
        if device.type == "cuda":
            import torch
            if fresh:
                torch.cuda.reset_peak_memory_stats(device)
                mem0 = torch.cuda.memory_allocated(device)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        return Window(key, _input_bytes(batch), start, mem0)
    return None


def open_mesh_window(kw: dict, batches: list, with_stats: bool,
                     devices: list) -> Window | None:
    """`open_window` of a dispatch sharded over a mesh: `batches` are its
    rows', `devices` every device of the mesh once. The start event is
    one a device, recorded on each device's current stream (after the
    rows' waits for their copies), and the record is keyed as a mesh
    dispatch, its size the whole padded batch; the first device is the
    one `hbm_device_bytes` polls."""
    if not enabled():
        return None
    with _guard("open"):
        first = batches[0]
        nbytes = sum(_input_bytes(b) for b in batches)
        key, _fresh = observe(
            dispatch_cost_key(kw, first["shape"], with_stats, devices[0],
                              single_device=False),
            first, devices[0], formulation(devices[0], kw.get("square")),
            B=sum(int(b["appends"].shape[0]) for b in batches),
            nbytes=nbytes)
        start = None
        if devices[0].type == "cuda":
            import torch
            start = tuple(torch.cuda.Event(enable_timing=True)
                          for _ in devices)
            for ev, d in zip(start, devices):
                ev.record(torch.cuda.current_stream(d))
        return Window(key, nbytes, start, None)
    return None


def begin_dispatch(part, win: Window | None, tr=None) -> None:
    """After the check is enqueued: remember the window of dispatch
    `part` (its `done` event ends it), add its bytes to the in-flight
    gauge, note a first dispatch's memory, publish the gauges."""
    if win is None:
        return
    global _inflight_bytes
    with _guard("begin_dispatch"):
        out_bytes = int(part.flags.nbytes)
        if win.mem0 is not None:
            import torch
            dev = part.flags.device
            mem = {"argument_bytes": win.nbytes, "output_bytes": out_bytes,
                   "temp_bytes": max(0, torch.cuda.max_memory_allocated(dev)
                                     - win.mem0),
                   "alias_bytes": None, "generated_code_bytes": None}
            with _LOCK:
                rec = _records.get(win.key)
                if rec is not None and rec["memory"] is None:
                    rec["memory"] = mem
        nbytes = win.nbytes + out_bytes
        with _LOCK:
            _pending[part] = (win.key, nbytes, win.start)
            _inflight_bytes += nbytes
        _publish_gauges(tr)


def _closure_work(B: int, t_pad: int, rounds: list, launches: int
                  ) -> tuple[float, float]:
    """(operations, bytes) of a dispatch's `closure_square` launches:
    each active round (the closures' round counts) 2·B·T³ int8
    operations; every launch, active or skipped, reads and writes m and
    mT (4·B·T² bytes) and its active word (B)."""
    active = sum(rounds)
    return (2.0 * B * t_pad ** 3 * active,
            float(4 * B * t_pad * t_pad + B) * launches)


def close_dispatch(part, histories: int, tr=None) -> None:
    """Close dispatch `part`'s window once the host has seen its end
    event complete, fold it and its work into its record. O(1) no-op
    for a dispatch that was never begun (gate off, an edge batch)."""
    global _inflight_bytes
    with _LOCK:
        ent = _pending.pop(part, None)
        if ent is not None:
            _inflight_bytes = max(0, _inflight_bytes - ent[1])
    if ent is None:
        return
    key, _nbytes, start = ent
    with _guard("close_dispatch"):
        if isinstance(start, tuple):
            # one pair a device, each read on its own device
            secs = max(s.elapsed_time(d) for s, d in zip(start, part.done)) \
                / 1e3
        elif start is not None:
            secs = start.elapsed_time(part.done) / 1e3
        else:
            secs = max(0.0, time.perf_counter() - part.t_disp)
        from ..checker.elle import kernels as K
        rounds = K.read_rounds(part.rounds)
        launches = K.closure_steps(part.t_pad) * len(part.rounds)
        # a mesh dispatch's rows each square their own histories: the
        # work of each round counter is its row's (a dispatch without
        # rows is one row of the record's batch)
        flops, nbytes = _closure_work(getattr(part, "b_row", key[1]),
                                      part.t_pad, rounds, launches)
        with _LOCK:
            rec = _records.get(key)
            if rec is not None:
                w = rec["windows"]
                w["dispatches"] += 1
                w["device_secs"] += secs
                w["min_secs"] = secs if w["min_secs"] is None \
                    else min(w["min_secs"], secs)
                w["max_secs"] = secs if w["max_secs"] is None \
                    else max(w["max_secs"], secs)
                w["histories"] += int(histories)
                work = _work[key]
                work[0] += flops
                work[1] += nbytes
                rec["cost"] = {"flops": work[0] / w["dispatches"],
                               "bytes_accessed": work[1] / w["dispatches"],
                               "transcendentals": None}
        _publish_gauges(tr)


def discard_dispatch(part, tr=None) -> None:
    """Drop a pending window without recording it: the dispatch went to
    quarantine or the OOM backdown, whose own windows account for the
    device time."""
    global _inflight_bytes
    with _LOCK:
        ent = _pending.pop(part, None)
        if ent is not None:
            _inflight_bytes = max(0, _inflight_bytes - ent[1])
    if ent is not None:
        with _guard("discard_dispatch"):
            _publish_gauges(tr)


def _publish_gauges(tr=None) -> None:
    """Residency gauges into the metrics registry (→ /metrics,
    health.json), through `parallel.residency`."""
    from ..parallel import residency
    residency.publish_residency_gauges(
        tr if tr is not None else trace.get_current(),
        modeled_bytes=_inflight_bytes)


def maybe_poll_memory_stats(tr) -> None:
    """The caching allocator's bytes in use on the sweep's card
    (`torch.cuda.memory_stats()`'s `allocated_bytes.all.current`) into
    the `hbm_device_bytes` gauge, at most once per
    JEPSEN_TPU_RESIDENCY_INTERVAL_S; nothing on the CPU."""
    global _last_mem_poll
    interval = residency_interval_s()
    if interval <= 0 or _poll_device is None:
        return
    now = time.monotonic()
    if now - _last_mem_poll < interval and _last_mem_poll > 0:
        return
    _last_mem_poll = now
    with _guard("memory_stats poll"):
        import torch
        stats = torch.cuda.memory_stats(_poll_device)
        v = stats.get("allocated_bytes.all.current")
        if isinstance(v, int):
            tr.gauge("hbm_device_bytes").set(v)


# ---------------------------------------------------------------------------
# Records out: roofline derivation, flush, cross-shard merge.
# ---------------------------------------------------------------------------

def _finalize(rec: dict) -> dict:
    """One registry record → the published costdb line: achieved rates
    from the windows, roofline utilization against the device_kind-keyed
    peak table, and `provenance: measured` only for windows taken on a
    card."""
    from ..checker.elle import kernels as K
    out = {k: v for k, v in rec.items() if k != "key_parts"}
    out = {"v": 1, **out}
    w = rec["windows"]
    peak = K.device_peak(rec.get("device_kind"))
    out["peak"] = peak
    measured = w["dispatches"] > 0 and rec.get("backend") \
        not in ("cpu", "unknown")
    out["provenance"] = "measured" if measured else "estimated"
    cost = rec.get("cost") or {}
    achieved = {"flops_per_sec": None, "bytes_per_sec": None}
    roofline = {"flops_utilization": None, "bandwidth_utilization": None}
    if w["dispatches"] > 0 and w["device_secs"] > 0:
        per_sec = w["dispatches"] / w["device_secs"]
        if isinstance(cost.get("flops"), (int, float)):
            achieved["flops_per_sec"] = cost["flops"] * per_sec
            peak_ops = (peak["int8_tops"] if "int8" in
                        (rec.get("formulation") or "")
                        else peak["bf16_tflops"]) * 1e12
            roofline["flops_utilization"] = round(
                achieved["flops_per_sec"] / peak_ops, 6)
        if isinstance(cost.get("bytes_accessed"), (int, float)):
            achieved["bytes_per_sec"] = cost["bytes_accessed"] * per_sec
            roofline["bandwidth_utilization"] = round(
                achieved["bytes_per_sec"] / (peak["hbm_gbps"] * 1e9), 6)
    out["achieved"] = achieved
    out["roofline"] = roofline
    return out


def records() -> list[dict]:
    """Every record, finalized (achieved rates, roofline, provenance),
    in capture order."""
    with _LOCK:
        raw = [dict(r, windows=dict(r["windows"])) for r in
               _records.values()]
    return [_finalize(r) for r in raw]


def record_key(rec: dict) -> tuple:
    """The dedup identity of a finalized record: what two shards
    dispatching the same kernel flags over the same geometry share."""
    g = rec.get("geometry") or {}
    k = rec.get("kernel") or {}
    return (tuple(sorted(k.items())), rec.get("formulation"),
            bool(rec.get("donated")),
            tuple(sorted((n, g.get(n)) for n in
                         ("B", "n_txns", "n_keys", "max_pos",
                          "n_appends", "n_reads"))),
            rec.get("analysis"))


def merge_records(record_lists) -> list[dict]:
    """Fold finalized records from several sources (shards) into one
    deduplicated set: same key → one record with the window aggregates
    summed and the achieved and roofline numbers re-derived. A record
    whose twin carries a memory measurement adopts it."""
    merged: dict[tuple, dict] = {}
    order: list[tuple] = []
    for recs in record_lists:
        for rec in recs or []:
            if not isinstance(rec, dict):
                continue
            k = record_key(rec)
            cur = merged.get(k)
            if cur is None:
                merged[k] = dict(rec,
                                 windows=dict(rec.get("windows") or {}))
                order.append(k)
                continue
            w, wn = cur.get("windows") or {}, rec.get("windows") or {}
            w["dispatches"] = w.get("dispatches", 0) \
                + wn.get("dispatches", 0)
            w["device_secs"] = w.get("device_secs", 0.0) \
                + wn.get("device_secs", 0.0)
            w["histories"] = w.get("histories", 0) \
                + wn.get("histories", 0)
            for f, pick in (("min_secs", min), ("max_secs", max)):
                vals = [v for v in (w.get(f), wn.get(f))
                        if v is not None]
                w[f] = pick(vals) if vals else None
            cur["windows"] = w
            if cur.get("memory") is None and rec.get("memory"):
                cur["memory"] = rec["memory"]
            if "measured" in (cur.get("provenance"),
                              rec.get("provenance")):
                cur["provenance"] = "measured"
    out = []
    for k in order:
        rec = merged[k]
        raw = {kk: vv for kk, vv in rec.items()
               if kk not in ("v", "peak", "provenance", "achieved",
                             "roofline")}
        fin = _finalize(raw)
        # a merged-measured set stays measured even where re-derivation
        # (a CPU host finalizing a card's records) would demote it
        if rec.get("provenance") == "measured":
            fin["provenance"] = "measured"
        out.append(fin)
    return out


def flush(path) -> int:
    """Append every record to the costdb at `path` (one flushed JSON
    line each) and emit the flight-recorder mark. Returns the record
    count; 0 (and no file) when the gate is off or nothing was
    captured."""
    if not enabled():
        return 0
    recs = records()
    if not recs:
        return 0
    from ..store import append_costdb
    n = append_costdb(path, recs)
    if n:
        from . import events
        events.emit("costdb_flush", path=str(path), records=n)
    return n


def bandwidth_share(recs: list[dict]) -> dict | None:
    """The sweep-level achieved-bandwidth share: total bytes accessed
    over total device seconds, against the peak HBM bandwidth the
    records resolved. None when no record carries both a cost and
    windows."""
    bytes_total = 0.0
    secs_total = 0.0
    flops_total = 0.0
    peak_bw = None
    provenance = "estimated"
    for r in recs or []:
        w = r.get("windows") or {}
        cost = r.get("cost") or {}
        if not w.get("dispatches") or not isinstance(
                cost.get("bytes_accessed"), (int, float)):
            continue
        bytes_total += cost["bytes_accessed"] * w["dispatches"]
        if isinstance(cost.get("flops"), (int, float)):
            flops_total += cost["flops"] * w["dispatches"]
        secs_total += w.get("device_secs", 0.0)
        peak_bw = (r.get("peak") or {}).get("hbm_gbps", peak_bw)
        if r.get("provenance") == "measured":
            provenance = "measured"
    if secs_total <= 0 or peak_bw is None:
        return None
    return {
        "achieved_bw_share": round(
            bytes_total / secs_total / (peak_bw * 1e9), 6),
        "achieved_gbps": round(bytes_total / secs_total / 1e9, 3),
        "achieved_tflops": round(flops_total / secs_total / 1e12, 4),
        "device_secs": round(secs_total, 6),
        "peak_hbm_gbps": peak_bw,
        "provenance": provenance,
    }
