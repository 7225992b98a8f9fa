"""Critical-path attribution over a sweep's timeline.

Counterpart of `jepsen_tpu/obs/attribution.py`. The tracer answers
"what happened when"; this module answers "which stage bounds the
sweep, and what would the wall clock be if it were fixed?" It walks the
sweep's Chrome timeline (parent phases + device dispatch windows —
`trace.merge_traces`) and computes, per sweep:

  * the **serial bottleneck decomposition**: every instant of wall
    time charged to exactly one stage by pipeline priority (device >
    h2d > pack > encode > parse > feed > dispatch > collect > render
    > idle). Shares sum to 1.0 by construction. The un-prioritized
    per-stage busy unions are reported too;
  * **pipeline-stall accounting**: each gap between consecutive
    device windows classified by what the host was doing —
    ingest-starved (parse active), pack-bound (pack/h2d active), or
    other — aggregated and itemized per gap;
  * **what-if headroom**: the ideal wall clock under perfect overlap
    is the longest single stage's busy time.

`analyze-store --report` writes it as `<store>/report.json` +
`report.md`. Stdlib-only; events come in as plain dicts, so this runs
on an archived trace.json as well as a live tracer. With the cost
observatory on (`JEPSEN_TPU_COSTDB`, `obs.device`) the report gains its
device roofline section, and with the planner on (`JEPSEN_TPU_PLANNER`)
its planner section. A mesh sweep's coordinator adds `per_shard`, each
shard's own decomposition (`analyze_shards`).
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

from .. import trace

#: Stage priority for the serial decomposition, downstream first: an
#: instant where the device is busy is device-bound whatever the host
#: does under it; host stages order pack-side over ingest-side the
#: same way.
STAGE_PRIORITY = ("device", "h2d", "pack", "encode", "parse", "feed",
                  "dispatch", "collect", "render")

#: Parent phase spans that map 1:1 onto a stage.
_PHASE_STAGES = frozenset({"parse", "pack", "h2d", "feed", "dispatch",
                           "collect", "render"})

#: Cap on the per-gap stall itemization in report.json.
_MAX_GAPS = 50


# interval arithmetic: ONE implementation (trace.merge_intervals /
# trace.overlap_seconds)
_union = trace.merge_intervals
_overlap = trace.overlap_seconds


def _clip(iv: list, w0: float, w1: float) -> list:
    return [(max(s, w0), min(e, w1)) for s, e in iv
            if min(e, w1) > max(s, w0)]


def _total(iv: list) -> float:
    return sum(e - s for s, e in iv)


def stage_intervals(events: list, window_us=None):
    """Per-stage (start, end) second-interval unions from a merged
    Chrome event list, plus the worker pids seen. Stage mapping:

      * cat=="device"                          -> device
      * any X event from a worker process      -> encode (worker pids
        are identified by their process_name metadata containing
        "worker"; nested worker spans union away)
      * parent spans on an "ingest-pool*" track -> encode (the
        parent-side mirror of worker parse windows — union with the
        spool spans dedups them)
      * cat=="phase" spans named parse/pack/h2d/feed/dispatch/
        collect/render -> that stage

    Everything else (nested detail spans, instants, quarantine spans)
    is deliberately unmapped: it is either contained in a mapped span
    or not wall-clock-attributable. With `window_us=(a, b)` intervals
    are clipped to the window (bench rounds scope a sweep out of a
    whole-round tracer)."""
    worker_pids: set = set()
    tracknames: dict = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args") or {}
        if e.get("name") == "process_name" \
                and "worker" in str(args.get("name", "")):
            worker_pids.add(e.get("pid"))
        elif e.get("name") == "thread_name":
            tracknames[(e.get("pid"), e.get("tid"))] = \
                str(args.get("name", ""))
    iv: dict[str, list] = {s: [] for s in STAGE_PRIORITY}
    for e in events:
        if e.get("ph") != "X":
            continue
        t0 = e.get("ts", 0.0) / 1e6
        t1 = t0 + e.get("dur", 0.0) / 1e6
        cat = e.get("cat")
        if cat == "device":
            stage = "device"
        elif e.get("pid") in worker_pids:
            stage = "encode"
        elif tracknames.get((e.get("pid"), e.get("tid")),
                            "").startswith("ingest-pool"):
            stage = "encode"
        elif cat == "phase" and e.get("name") in _PHASE_STAGES:
            stage = e["name"]
        else:
            continue
        iv[stage].append((t0, t1))
    if window_us is not None:
        w0, w1 = window_us[0] / 1e6, window_us[1] / 1e6
        iv = {s: _clip(v, w0, w1) for s, v in iv.items()}
    return {s: _union(v) for s, v in iv.items()}, worker_pids


def _charge(unions: dict, w0: float, w1: float) -> dict:
    """The serial decomposition: walk the elementary segments of
    [w0, w1] and charge each to the highest-priority active stage;
    the remainder is idle. Sums to exactly w1 - w0."""
    bounds = {w0, w1}
    for iv in unions.values():
        for s, e in iv:
            if w0 < s < w1:
                bounds.add(s)
            if w0 < e < w1:
                bounds.add(e)
    cuts = sorted(bounds)
    starts = {s: [p[0] for p in iv] for s, iv in unions.items()}
    charged = {s: 0.0 for s in STAGE_PRIORITY}
    charged["idle"] = 0.0
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        for stage in STAGE_PRIORITY:
            i = bisect.bisect_right(starts[stage], mid) - 1
            if i >= 0 and unions[stage][i][1] > mid:
                charged[stage] += b - a
                break
        else:
            charged["idle"] += b - a
    return charged


def _stalls(unions: dict, w0: float, w1: float) -> dict:
    """Device-gap accounting: every gap between consecutive device
    windows (plus the lead-in from the window start to the first
    dispatch) classified by what the host was doing."""
    dev = unions.get("device", [])
    ingest = _union(unions.get("encode", []) + unions.get("parse", []))
    packing = _union(unions.get("pack", []) + unions.get("h2d", []))
    gaps = []
    prev = w0
    for i, (s, e) in enumerate(dev):
        if s > prev:
            gaps.append((i, prev, s))
        prev = max(prev, e)
    agg = {"ingest_starved_secs": 0.0, "pack_bound_secs": 0.0,
           "other_secs": 0.0}
    items = []
    for i, a, b in gaps:
        g = [(a, b)]
        ing = _overlap(g, ingest)
        pk = _overlap(g, packing)
        if ing >= pk and ing > 0:
            cause = "ingest_starved"
        elif pk > 0:
            cause = "pack_bound"
        else:
            cause = "other"
        agg[f"{cause}_secs"] += b - a
        if len(items) < _MAX_GAPS:
            items.append({"before_dispatch": i, "secs": round(b - a, 6),
                          "cause": cause})
    busy = _total(dev)
    return {
        "device_busy_secs": round(busy, 6),
        "device_idle_secs": round(max(0.0, (w1 - w0) - busy), 6),
        "dispatches": len(dev),
        "gaps": len(gaps),
        **{k: round(v, 6) for k, v in agg.items()},
        "gap_detail": items,
    }


def analyze(events: list, window_us=None, counters=None) -> dict:
    """The attribution report dict for a merged Chrome event list.
    Always returns shares summing to 1.0 (idle included); an empty or
    unmapped timeline reports wall 0 and no bound."""
    unions, worker_pids = stage_intervals(events, window_us=window_us)
    pts = [t for iv in unions.values() for p in iv for t in p]
    if window_us is not None:
        w0, w1 = window_us[0] / 1e6, window_us[1] / 1e6
    elif pts:
        w0, w1 = min(pts), max(pts)
    else:
        w0 = w1 = 0.0
    wall = max(0.0, w1 - w0)
    busy = {s: round(_total(iv), 6) for s, iv in unions.items()}
    if wall <= 0:
        return {"wall_secs": 0.0, "shares": {}, "busy_secs": busy,
                "charged_secs": {}, "stalls": {}, "bound": None,
                "ideal_wall_secs": 0.0, "headroom_secs": 0.0,
                "workers": len(worker_pids)}
    charged = _charge(unions, w0, w1)
    shares = {s: v / wall for s, v in charged.items()}
    # the bound is the single longest stage by PRESENCE (busy union):
    # under perfect pipelining everything else hides beneath it, so
    # its busy time is also the ideal wall clock
    bound = max((s for s in STAGE_PRIORITY), key=lambda s: busy[s])
    if busy[bound] <= 0:
        bound = None
    ideal = busy[bound] if bound else 0.0
    rep = {
        "wall_secs": round(wall, 6),
        "shares": {s: round(v, 4) for s, v in shares.items()},
        "busy_secs": busy,
        "charged_secs": {s: round(v, 6) for s, v in charged.items()},
        "stalls": _stalls(unions, w0, w1),
        "bound": bound,
        "ideal_wall_secs": round(ideal, 6),
        "headroom_secs": round(max(0.0, wall - ideal), 6),
        "workers": len(worker_pids),
    }
    if counters:
        rep["counters"] = dict(counters)
    return rep


def summary_line(rep: dict) -> str:
    """The one-sentence what-if: which stage binds the sweep and what
    a perfectly overlapped sweep would cost."""
    bound = rep.get("bound")
    if not bound:
        return "no attributable timeline"
    return (f"{bound}-bound: ideal wall = "
            f"{rep['ideal_wall_secs']:.3f}s at current per-stage "
            f"rates ({rep['headroom_secs']:.3f}s headroom over the "
            f"measured {rep['wall_secs']:.3f}s)")


def render_report_md(rep: dict) -> str:
    """The human-readable report.md."""
    lines = ["# Sweep attribution report", ""]
    lines.append(f"Wall clock: **{rep.get('wall_secs', 0.0):.3f} s** "
                 f"over {rep.get('workers', 0)} worker process(es); "
                 f"{summary_line(rep)}.")
    lines += ["", "## Serial bottleneck decomposition", "",
              "| stage | share | charged s | busy s |",
              "|---|---|---|---|"]
    shares = rep.get("shares", {})
    busy = rep.get("busy_secs", {})
    charged = rep.get("charged_secs", {})
    for s in (*STAGE_PRIORITY, "idle"):
        if s not in shares:
            continue
        lines.append(f"| {s} | {shares[s]:.1%} | "
                     f"{charged.get(s, 0.0):.3f} | "
                     f"{busy.get(s, 0.0):.3f} |")
    st = rep.get("stalls") or {}
    if st:
        lines += ["", "## Pipeline stalls (device gaps)", "",
                  f"- device busy {st.get('device_busy_secs', 0.0):.3f}"
                  f" s over {st.get('dispatches', 0)} dispatch "
                  f"window(s); idle "
                  f"{st.get('device_idle_secs', 0.0):.3f} s",
                  f"- ingest-starved "
                  f"{st.get('ingest_starved_secs', 0.0):.3f} s · "
                  f"pack-bound {st.get('pack_bound_secs', 0.0):.3f} s "
                  f"· other {st.get('other_secs', 0.0):.3f} s "
                  f"across {st.get('gaps', 0)} gap(s)"]
    per_shard = rep.get("per_shard") or {}
    if per_shard:
        lines += ["", "## Per-shard decomposition (mesh sweep)", "",
                  "| shard | wall s | bound | device | encode | idle |",
                  "|---|---|---|---|---|---|"]
        # numeric order: '10' after '2'
        for k in sorted(per_shard,
                        key=lambda s: (0, int(s)) if str(s).isdigit()
                        else (1, str(s))):
            sr = per_shard[k]
            ss = sr.get("shares", {})
            lines.append(
                f"| {k} | {sr.get('wall_secs', 0.0):.3f} | "
                f"{sr.get('bound') or '—'} | "
                f"{ss.get('device', 0.0):.1%} | "
                f"{ss.get('encode', 0.0):.1%} | "
                f"{ss.get('idle', 0.0):.1%} |")
    dev = rep.get("device") or {}
    if dev:
        lines += render_device_md(dev)
    search_sec = rep.get("search") or {}
    if search_sec:
        from . import search as search_mod
        lines += search_mod.render_search_md(search_sec)
    planner_sec = rep.get("planner") or {}
    if planner_sec:
        from .. import planner as planner_mod
        lines += planner_mod.render_planner_md(planner_sec)
    lines += ["", "## What-if", "", f"- {summary_line(rep)}"]
    if rep.get("counters"):
        keep = ("runs_verdicted", "buckets_dispatched", "cache_hits",
                "cache_misses", "worker_spans", "quarantined")
        rows = [(k, rep["counters"][k]) for k in keep
                if k in rep["counters"]]
        if rows:
            lines += ["", "## Counters", ""]
            lines += [f"- `{k}` = {v}" for k, v in rows]
    return "\n".join(lines) + "\n"


def device_section(records: list) -> dict | None:
    """The report's "device" section from a cost observatory's
    finalized records (already carrying achieved rates, roofline
    utilization and provenance, so this stays stdlib-only): one row per (executable, geometry) with measured
    windows, plus the sweep-level aggregate. None when no records
    were captured (gate off)."""
    rows = []
    provenance = "estimated"
    peak = None
    for r in records or []:
        if not isinstance(r, dict):
            continue
        w = r.get("windows") or {}
        g = r.get("geometry") or {}
        cost = r.get("cost") or {}
        ach = r.get("achieved") or {}
        roof = r.get("roofline") or {}
        peak = r.get("peak") or peak
        if r.get("provenance") == "measured":
            provenance = "measured"
        rows.append({
            "geometry": g,
            "formulation": r.get("formulation"),
            "analysis": r.get("analysis"),
            "flops": cost.get("flops"),
            "bytes_accessed": cost.get("bytes_accessed"),
            "dispatches": w.get("dispatches", 0),
            "device_secs": round(w.get("device_secs", 0.0), 6),
            "histories": w.get("histories", 0),
            "achieved_tflops": (
                round(ach["flops_per_sec"] / 1e12, 4)
                if isinstance(ach.get("flops_per_sec"), (int, float))
                else None),
            "achieved_gbps": (
                round(ach["bytes_per_sec"] / 1e9, 3)
                if isinstance(ach.get("bytes_per_sec"), (int, float))
                else None),
            "flops_utilization": roof.get("flops_utilization"),
            "bandwidth_utilization": roof.get("bandwidth_utilization"),
            "provenance": r.get("provenance"),
        })
    if not rows:
        return None
    return {"records": rows, "peak": peak, "provenance": provenance,
            "device_secs": round(sum(r["device_secs"] for r in rows),
                                 6)}


def render_device_md(dev: dict) -> list[str]:
    """The report.md roofline table for one device section."""
    peak = dev.get("peak") or {}
    lines = ["", "## Device roofline (cost observatory)", "",
             f"Peak: {peak.get('device_kind', '?')} "
             f"[{peak.get('source', '?')}] — "
             f"{peak.get('bf16_tflops', '?')} bf16 TFLOPS / "
             f"{peak.get('int8_tops', '?')} int8 TOPS / "
             f"{peak.get('hbm_gbps', '?')} GB/s HBM; provenance "
             f"**{dev.get('provenance')}**.", "",
             "| geometry | form | dispatches | device s | achieved "
             "TFLOP/s | achieved GB/s | flops util | bw util |",
             "|---|---|---|---|---|---|---|---|"]
    for r in dev.get("records", []):
        g = r.get("geometry") or {}
        geom = (f"B{g.get('B')}xT{g.get('n_txns')}"
                f"(K{g.get('n_keys')},P{g.get('max_pos')})")

        def pct(v):
            return f"{v:.2%}" if isinstance(v, (int, float)) else "—"

        def num(v):
            return f"{v:g}" if isinstance(v, (int, float)) else "—"

        lines.append(
            f"| {geom} | {r.get('formulation')} | "
            f"{r.get('dispatches')} | {r.get('device_secs'):.4f} | "
            f"{num(r.get('achieved_tflops'))} | "
            f"{num(r.get('achieved_gbps'))} | "
            f"{pct(r.get('flops_utilization'))} | "
            f"{pct(r.get('bandwidth_utilization'))} |")
    return lines


def analyze_shards(per_shard_events: dict) -> dict:
    """A mesh sweep's per-shard attribution: each shard's report over
    its own event list (its own timeline: clock alignment across shards
    never touches the shares), so each shard's shares sum to 1.0 as the
    merged report's do."""
    return {str(k): analyze(evs)
            for k, evs in sorted(per_shard_events.items())}


def write_report(store_base, events: list, metrics: dict | None = None,
                 window_us=None, per_shard_events: dict | None = None,
                 device_records: list | None = None,
                 search_records: list | None = None):
    """Write `<store>/report.json` + `report.md` (atomically — the
    journal discipline) and return their paths. With
    `per_shard_events` ({shard: event list}, a mesh coordinator's
    merge) it carries `per_shard`, each shard's own stage shares.
    With `device_records` (the cost observatory's finalized records,
    `obs.device`) it carries the `device` roofline section:
    per-(kernel flags, geometry) achieved-vs-peak operations and
    bandwidth from the dispatches' counted work joined with their
    device windows. With `search_records` (the kernel search-telemetry
    ledger, JEPSEN_TPU_KERNEL_STATS) it carries the `search` section:
    anomaly-rate and margin distributions plus the
    edge-density-vs-device-time join against the costdb. With the
    planner on (JEPSEN_TPU_PLANNER) it carries the `planner` section,
    read from the process's active plan and this sweep's counters."""
    base = Path(store_base)
    rep = analyze(events, window_us=window_us,
                  counters=(metrics or {}).get("counters"))
    rep = {"v": 1, **rep}
    if per_shard_events:
        rep["per_shard"] = analyze_shards(per_shard_events)
    if device_records:
        dev = device_section(device_records)
        if dev is not None:
            rep["device"] = dev
    if search_records:
        from . import search as search_mod
        sec = search_mod.search_section(search_records,
                                        cost_records=device_records)
        if sec is not None:
            rep["search"] = sec
    from .. import planner as planner_mod
    if planner_mod.enabled():
        # a cold sweep still reports its fallback tally
        rep["planner"] = planner_mod.planner_section(
            planner_mod.current_plan(), cost_records=device_records,
            metrics=metrics)
    jp = trace.atomic_write_text(base / "report.json",
                                 json.dumps(rep, indent=2))
    mp = trace.atomic_write_text(base / "report.md",
                                 render_report_md(rep))
    return jp, mp
