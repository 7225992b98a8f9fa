"""Kernel search telemetry: the per-store analytics ledger and its
report aggregation (`JEPSEN_TPU_KERNEL_STATS`).

Counterpart of `jepsen_tpu/obs/search.py`, copied whole. Behind the
gate, the checkers return a compact stats record per history (elle:
`kernels.STAT_FIELDS` — edge counts per relation, closure rounds vs
bound, SCC shape, the decision-boundary margin; the condensed path's
`condense.condensed_stats`; knossos: grid and frontier occupancy and
WGL counters), and this module is where those records land host-side:

  * `record()` accumulates one record per checked history for the
    current sweep (per-sweep module state, `reset()` at sweep start)
    and publishes the `kernel.*` metrics;
  * `flush()` journals the records to `<store>/analytics.jsonl`
    (`store.append_analytics`: one flushed JSON line each, torn tails
    skipped on load). `JEPSEN_TPU_KERNEL_STATS_SAMPLE=N` journals
    every Nth record; the aggregates still cover all of them;
  * `search_section()` aggregates the records into the report's
    "search" section — anomaly rate, closure-round and margin
    distributions, edge density.

With the gate off no record is ever created and no file written; the
kernels never read the gate themselves (`enabled()` is its one
reader), and verdicts are byte-identical either way — stats ride
BESIDE results, never inside them.
"""

from __future__ import annotations

import logging
import threading

from .. import gates, trace

log = logging.getLogger(__name__)

#: A cyclic history whose cycle only appeared after this many squaring
#: rounds is flagged `near_miss`: its cycle needs long dependency
#: paths, so few mutations separate it from a valid history — the
#: seed population for a near-miss mutation search. (Valid
#: histories order by `margin` directly; the flag marks the anomalous
#: side, where high margin means fragile.)
NEAR_MISS_MARGIN = 2

_LOCK = threading.Lock()
_records: list[dict] = []


def enabled() -> bool:
    """The JEPSEN_TPU_KERNEL_STATS gate (default off)."""
    return gates.get("JEPSEN_TPU_KERNEL_STATS")


def sample_every() -> int:
    """The JEPSEN_TPU_KERNEL_STATS_SAMPLE journaling stride (>=1)."""
    v = gates.get("JEPSEN_TPU_KERNEL_STATS_SAMPLE")
    return max(1, int(v) if v else 1)


def reset() -> None:
    """Drop every accumulated record (sweep start, tests) — per-sweep
    state like the tracer and the cost observatory."""
    with _LOCK:
        _records.clear()


def note_metrics(stats: dict, tr=None) -> None:
    """Publish one stats row's `kernel.*` metrics WITHOUT accumulating
    a ledger record — the path of a long-lived caller, for which
    accumulating per-verdict records forever would be an
    unbounded-memory bug."""
    try:
        tr = tr if tr is not None else trace.get_current()
        tr.counter("kernel.stats_records").inc()
        if stats.get("cycle_txns", 0) > 0:
            tr.counter("kernel.cyclic_histories").inc()
        rounds = stats.get("closure_rounds", -1)
        if isinstance(rounds, int) and rounds >= 0:
            tr.histogram("kernel.closure_rounds").observe(rounds)
        margin = stats.get("margin", -1)
        if isinstance(margin, int) and margin >= 0:
            tr.histogram("kernel.margin").observe(margin)
        if any(k in stats for k in ("ww_edges", "wr_edges",
                                    "rw_edges")):
            # guard like the other observes: a register/WGL record
            # carries no edge counts, and observing a fabricated 0
            # would pollute the distribution
            tr.histogram("kernel.edges").observe(
                sum(stats.get(k, 0) or 0 for k in
                    ("ww_edges", "wr_edges", "rw_edges")))
        if stats.get("scc_max"):
            tr.histogram("kernel.scc_max").observe(stats["scc_max"])
        if isinstance(stats.get("backtracks"), int):
            tr.histogram("kernel.backtracks").observe(
                stats["backtracks"])
    except Exception:   # observability never sinks a sweep
        log.debug("kernel-stats metrics publish failed", exc_info=True)


def record(run, checker: str, stats: dict | None,
           anomalies=None) -> None:
    """Accumulate one history's stats record for the current sweep and
    publish its metrics. `stats` None (a quarantined or stats-free
    history) is a no-op — the ledger only carries real telemetry.
    `anomalies` (the cycle dict / anomaly-name iterable the verdict
    rendered from) rides along so the ledger line pairs structure with
    outcome without re-reading results.json."""
    if stats is None:
        return
    try:
        rec = {"v": 1, "dir": str(run), "checker": str(checker),
               **stats}
        if anomalies:
            try:
                rec["anomalies"] = sorted(str(a) for a in anomalies)
            except TypeError:
                pass
        margin = rec.get("margin", -1)
        if rec.get("cycle_txns", 0) and isinstance(margin, int) \
                and margin >= NEAR_MISS_MARGIN:
            rec["near_miss"] = True
        with _LOCK:
            _records.append(rec)
        note_metrics(rec)
    except Exception:
        log.debug("kernel-stats record failed", exc_info=True)


def records() -> list[dict]:
    """Every accumulated record, in record order."""
    with _LOCK:
        return [dict(r) for r in _records]


def flush(path) -> int:
    """Journal the accumulated records to the analytics ledger at
    `path` (every `sample_every()`-th record; store.append_analytics —
    one flushed line each) and emit the flight-recorder mark. Returns
    the line count; 0 (and no file) when the gate is off or nothing
    was recorded."""
    if not enabled():
        return 0
    recs = records()
    if not recs:
        return 0
    k = sample_every()
    recs = recs[::k]
    from ..store import append_analytics
    n = append_analytics(path, recs)
    if n:
        from . import events
        events.emit("analytics_flush", path=str(path), records=n)
    return n


# ---------------------------------------------------------------------------
# Report aggregation — the "search" section.
# ---------------------------------------------------------------------------

def _dist(vals: list) -> dict | None:
    """min/mean/max + a small histogram over non-negative ints."""
    vals = [v for v in vals if isinstance(v, (int, float)) and v >= 0]
    if not vals:
        return None
    hist: dict[str, int] = {}
    for v in vals:
        hist[str(int(v))] = hist.get(str(int(v)), 0) + 1
    return {"count": len(vals), "min": min(vals), "max": max(vals),
            "mean": round(sum(vals) / len(vals), 4),
            "histogram": dict(sorted(hist.items(),
                                     key=lambda kv: int(kv[0])))}


def search_section(recs: list[dict],
                   cost_records: list[dict] | None = None
                   ) -> dict | None:
    """The report's "search" section: anomaly-rate and margin/round
    distributions over the ledger, edge density, and the per-geometry
    edge-density-vs-device-time join against the costdb (device
    seconds per history at each bucket pad, from `cost_records`, the
    cost observatory's records when JEPSEN_TPU_COSTDB is on).
    Register-sweep records
    (WGL counters, no graph margin) aggregate into their own
    `register` subsection so a register-only sweep still reports.
    None when no record exists at all (gate off)."""
    all_recs = [r for r in recs or [] if isinstance(r, dict)]
    recs = [r for r in all_recs if "margin" in r]
    reg = [r for r in all_recs if "margin" not in r]
    if not recs:
        if not reg:
            return None
        return {"histories": len(reg),
                "register": _register_section(reg)}
    cyclic = [r for r in recs if r.get("cycle_txns", 0)]
    valid = [r for r in recs if not r.get("cycle_txns", 0)]
    edges = [sum(r.get(k, 0) or 0 for k in
                 ("ww_edges", "wr_edges", "rw_edges", "rt_edges",
                  "proc_edges")) for r in recs]
    density = [e / max(r.get("n_txns", 1) or 1, 1)
               for e, r in zip(edges, recs)]
    sec = {
        "histories": len(recs),
        "anomalous": len(cyclic),
        "anomaly_rate": round(len(cyclic) / len(recs), 4),
        "near_miss": sum(1 for r in recs if r.get("near_miss")),
        "closure_rounds": _dist([r.get("closure_rounds", -1)
                                 for r in recs]),
        "margin": {
            "anomalous": _dist([r.get("margin", -1) for r in cyclic]),
            "valid": _dist([r.get("margin", -1) for r in valid]),
        },
        "edges_per_txn_mean": (round(sum(density) / len(density), 4)
                               if density else None),
        "scc_max": max((r.get("scc_max", 0) or 0 for r in recs),
                       default=0),
    }
    # the empirical complexity join: group ledger rows by bucket pad
    # and attach the costdb's measured device seconds per history at
    # the same geometry — edge density vs device time, per T_pad
    by_pad: dict[int, dict] = {}
    for r, e in zip(recs, edges):
        t = r.get("t_pad")
        if not isinstance(t, int):
            continue
        g = by_pad.setdefault(t, {"histories": 0, "edges": 0,
                                  "rounds": [], "device_secs": None,
                                  "cost_histories": 0})
        g["histories"] += 1
        g["edges"] += e
        rd = r.get("closure_rounds", -1)
        if isinstance(rd, int) and rd >= 0:
            g["rounds"].append(rd)
    for c in cost_records or []:
        if not isinstance(c, dict):
            continue
        t = (c.get("geometry") or {}).get("n_txns")
        w = c.get("windows") or {}
        if t in by_pad and w.get("histories"):
            g = by_pad[t]
            g["device_secs"] = (g["device_secs"] or 0.0) \
                + w.get("device_secs", 0.0)
            g["cost_histories"] += w["histories"]
    rows = []
    for t in sorted(by_pad):
        g = by_pad[t]
        secs_per = (g["device_secs"] / g["cost_histories"]
                    if g["device_secs"] and g["cost_histories"]
                    else None)
        rows.append({
            "t_pad": t, "histories": g["histories"],
            "edges_mean": round(g["edges"] / g["histories"], 2),
            "rounds_mean": (round(sum(g["rounds"]) / len(g["rounds"]),
                                  2) if g["rounds"] else None),
            "device_secs_per_history": (round(secs_per, 6)
                                        if secs_per else None)})
    sec["by_geometry"] = rows
    if reg:
        sec["histories"] = len(all_recs)
        sec["register"] = _register_section(reg)
    return sec


def _register_section(reg: list[dict]) -> dict:
    """Register-sweep aggregate: per-run WGL counters summed/maxed
    (the per-run records already aggregated their keys)."""
    out: dict = {"runs": len(reg),
                 "keys": sum(r.get("keys", 0) or 0 for r in reg)}
    for f, agg in (("configs", sum), ("backtracks", sum),
                   ("rounds", sum), ("frontier_peak", max),
                   ("max_depth", max)):
        vals = [r[f] for r in reg if isinstance(r.get(f), int)]
        if vals:
            out[f] = agg(vals)
    return out


def render_search_md(sec: dict) -> list[str]:
    """The report.md "Search" section for one aggregate."""
    lines = ["", "## Search telemetry (kernel stats)", ""]
    if "anomaly_rate" in sec:
        lines.append(
            f"{sec.get('histories', 0)} histories with kernel stats; "
            f"anomaly rate **{sec.get('anomaly_rate', 0):.2%}** "
            f"({sec.get('anomalous', 0)} anomalous, "
            f"{sec.get('near_miss', 0)} near-miss), largest SCC "
            f"{sec.get('scc_max', 0)} txns, "
            f"{sec.get('edges_per_txn_mean')} edges/txn mean.")
    else:
        lines.append(f"{sec.get('histories', 0)} histories with "
                     "kernel stats.")
    rg = sec.get("register") or {}
    if rg:
        lines.append(
            f"Register sweeps: {rg.get('runs', 0)} run(s), "
            f"{rg.get('keys', 0)} key subhistories, "
            f"{rg.get('configs', 0)} WGL configs explored, "
            f"{rg.get('backtracks', 0)} backtracks.")
    cr = sec.get("closure_rounds") or {}
    if cr:
        lines.append(f"Closure rounds: mean {cr.get('mean')} "
                     f"(min {cr.get('min')}, max {cr.get('max')}).")
    m = sec.get("margin") or {}
    for side in ("anomalous", "valid"):
        d = m.get(side)
        if d:
            lines.append(f"Margin ({side}): mean {d.get('mean')}, "
                         f"histogram {d.get('histogram')}.")
    rows = sec.get("by_geometry") or []
    if rows:
        lines += ["", "| T_pad | histories | edges mean | rounds mean "
                  "| device s/history |", "|---|---|---|---|---|"]
        for r in rows:
            def num(v):
                return f"{v:g}" if isinstance(v, (int, float)) else "—"
            lines.append(
                f"| {r['t_pad']} | {r['histories']} | "
                f"{num(r['edges_mean'])} | {num(r['rounds_mean'])} | "
                f"{num(r['device_secs_per_history'])} |")
    return lines
