"""Performance analysis: latency and throughput plots.

Counterpart of the reference's jepsen.checker.perf
(jepsen/src/jepsen/checker/perf.clj). Where the reference shells out to
gnuplot, this renders directly with matplotlib's Agg backend — no external
binary, and the same artifacts: ``latency-raw.png`` (point_graph,
perf.clj:485), ``latency-quantiles.png`` (quantiles_graph, perf.clj:514),
``rate.png`` (rate_graph, perf.clj:560), with nemesis activity shaded
behind the series (nemesis-regions perf.clj:242, nemesis-lines
perf.clj:272).

The pure data layer (buckets/quantiles, perf.clj:33-86) is exposed
separately so it can be golden-tested without touching a renderer.

The port's copy of `jepsen_tpu/checker/perf.py`; it imports the
standard library and the port's own modules only. matplotlib is
imported inside `fig_ax`, when a plot is drawn: where it is missing,
`check_safe` writes that checker's entry as `{"valid?": "unknown",
"error": ...}`, as the reference's does.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Sequence

from .. import util
from . import Checker

# Reference palette (perf.clj:59-63) and nemesis shading defaults
# (perf.clj:18-19).
TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}
DEFAULT_NEMESIS_COLOR = "#cccccc"
NEMESIS_ALPHA = 0.6
TYPES = ("ok", "info", "fail")


# ---------------------------------------------------------------------------
# Pure data layer
# ---------------------------------------------------------------------------

def bucket_scale(dt: float, b: float) -> float:
    """Time at the midpoint of bucket number b (perf.clj:21-25)."""
    return int(b) * dt + dt / 2


def bucket_time(dt: float, t: float) -> float:
    """Midpoint of the bucket t falls into (perf.clj:27-31)."""
    return bucket_scale(dt, t / dt)


def buckets(dt: float, tmax: float) -> list[float]:
    """Midpoints of every bucket up to tmax (perf.clj:33-40)."""
    out, b = [], 0
    while True:
        t = bucket_scale(dt, b)
        if t > tmax:
            return out
        out.append(t)
        b += 1


def bucket_points(dt: float, points: Iterable[Sequence[float]]) -> dict:
    """Group [time, v] points into a sorted {bucket-midpoint: [points]}
    map (perf.clj:42-49)."""
    out: dict[float, list] = {}
    for p in points:
        out.setdefault(bucket_time(dt, p[0]), []).append(p)
    return dict(sorted(out.items()))


def quantiles(qs: Sequence[float], points: Sequence[float]) -> dict:
    """Map each quantile in qs to its value over points, using the
    reference's floor(n*q) index rule (perf.clj:51-61)."""
    s = sorted(points)
    if not s:
        return {}
    n = len(s)
    return {q: s[min(n - 1, int(math.floor(n * q)))] for q in qs}


def latencies_to_quantiles(dt: float, qs: Sequence[float],
                           points: Iterable[Sequence[float]]) -> dict:
    """Bucket [time, latency] points by dt and emit
    {q: [(bucket-time, latency-at-q), ...]} (perf.clj:63-86)."""
    for q in qs:
        assert 0 <= q <= 1, q
    bucketed = [(t, quantiles(qs, [p[1] for p in ps]))
                for t, ps in bucket_points(dt, points).items()]
    return {q: [(t, qv[q]) for t, qv in bucketed] for q in qs}


def nanos_to_secs(t: float | None) -> float:
    return (t or 0) / 1e9


def nanos_to_ms(t: float | None) -> float:
    return (t or 0) / 1e6


def latency_point(op: dict) -> tuple[float, float]:
    """[time-in-seconds, latency-in-ms] for an op (perf.clj:143-148)."""
    return (nanos_to_secs(op.get("time")), nanos_to_ms(op.get("latency")))


def invokes_by_f(history: Sequence[dict]) -> dict:
    out: dict[Any, list] = {}
    for op in history:
        if op.get("type") == "invoke":
            out.setdefault(op.get("f"), []).append(op)
    return out


def invokes_by_f_type(history: Sequence[dict]) -> dict:
    """{f: {type: [invocations whose completion has that type]}}
    (perf.clj:98-118). The history must be latency-annotated."""
    out: dict[Any, dict] = {}
    for f, ops in invokes_by_f(history).items():
        by_type: dict[str, list] = {}
        for op in ops:
            ctype = (op.get("completion") or {}).get("type")
            if ctype in TYPES:
                by_type.setdefault(ctype, []).append(op)
        out[f] = by_type
    return out


def fs_order(fs: Iterable) -> list:
    """Deterministic plotting order for :f values (util/polysort)."""
    return sorted(fs, key=lambda f: (f is None, str(f)))


# ---------------------------------------------------------------------------
# Nemesis activity
# ---------------------------------------------------------------------------

def nemesis_activity(nemeses: Sequence[dict] | None,
                     history: Sequence[dict]) -> list[dict]:
    """Resolve nemesis spec maps ({"name","color","start","stop","fs"})
    against the history: attach their ops and paired activity intervals
    (perf.clj:204-242)."""
    nemeses = list(nemeses or [])
    nem_ops = [o for o in history if o.get("process") == "nemesis"]
    out = []
    claimed: set[int] = set()
    for n in nemeses:
        fs = set(n.get("fs") or ()) | set(n.get("start") or ()) \
            | set(n.get("stop") or ())
        ops = [o for o in nem_ops if not fs or o.get("f") in fs]
        claimed.update(id(o) for o in ops)
        intervals = util.nemesis_intervals(
            ops, {"start": n.get("start"), "stop": n.get("stop")})
        out.append({**n, "ops": ops, "intervals": intervals})
    # Unmatched nemesis ops render under a default band so fault activity
    # never silently disappears from a plot (nemesis-ops, perf.clj:204-216).
    rest = [o for o in nem_ops if id(o) not in claimed]
    if rest or not nemeses:
        out.append({"name": "nemesis", "ops": rest,
                    "intervals": util.nemesis_intervals(rest)})
    return out


def draw_nemeses(ax, history, nemeses, t_max: float) -> None:
    """Shade activity intervals and draw event lines, one horizontal band
    per nemesis from the top of the axes (perf.clj:242-296)."""
    acts = nemesis_activity(nemeses, history)
    height, padding = 0.0834, 0.00615
    for i, n in enumerate(acts):
        color = n.get("fill-color") or n.get("color") or DEFAULT_NEMESIS_COLOR
        bot = 1 - height * (i + 1)
        for a, b in n["intervals"]:
            t0 = nanos_to_secs(a.get("time"))
            t1 = nanos_to_secs(b.get("time")) if b else t_max
            ax.axvspan(t0, t1, ymin=bot + padding,
                       ymax=bot + height - padding, color=color,
                       alpha=n.get("transparency", NEMESIS_ALPHA), lw=0,
                       label=None)
        line_color = n.get("line-color") or n.get("color") \
            or DEFAULT_NEMESIS_COLOR
        for o in n["ops"]:
            ax.axvline(nanos_to_secs(o.get("time")), color=line_color,
                       lw=0.8, alpha=0.8)
        if n["ops"]:
            ax.plot([], [], color=color, lw=4, label=str(n.get("name")))


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------

def fig_ax(title: str, ylabel: str, logy: bool):
    # The OO API (Figure + Agg canvas), NOT pyplot: checkers render
    # concurrently (Compose.real_pmap, independent's bounded_pmap) and
    # pyplot's global figure registry is not thread-safe.
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure
    fig = Figure(figsize=(9, 4), dpi=100)
    FigureCanvasAgg(fig)
    ax = fig.add_subplot()
    ax.set_title(title)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel(ylabel)
    if logy:
        ax.set_yscale("log")
    return fig, ax


def finish(fig, ax, path) -> None:
    handles, labels = ax.get_legend_handles_labels()
    if handles:
        ax.legend(loc="upper left", bbox_to_anchor=(1.01, 1.0),
                  fontsize="small")
    fig.savefig(path, bbox_inches="tight")


def t_max(history) -> float:
    return max((nanos_to_secs(o.get("time")) for o in history), default=1.0)


def point_graph(test: dict, history: Sequence[dict], path,
                nemeses=None) -> bool:
    """latency-raw.png: every completed invocation as a point, colored by
    completion type (perf.clj:485-512). Returns False when there are no
    points (the reference throws ::no-points, checker returns anyway)."""
    lh = util.history_latencies(history)
    datasets = invokes_by_f_type(lh)
    markers = "osv^D*Pp"
    fig, ax = fig_ax(f"{test.get('name', '')} latency", "Latency (ms)", True)
    any_points = False
    for i, f in enumerate(fs_order(datasets)):
        for t in TYPES:
            ops = datasets[f].get(t)
            if not ops:
                continue
            pts = [latency_point(o) for o in ops]
            ax.scatter([p[0] for p in pts], [p[1] for p in pts], s=8,
                       color=TYPE_COLORS[t], marker=markers[i % len(markers)],
                       label=f"{util.name_of(f)} {t}")
            any_points = True
    draw_nemeses(ax, history, nemeses, t_max(history))
    finish(fig, ax, path)
    return any_points


def quantiles_graph(test: dict, history: Sequence[dict], path,
                    nemeses=None, dt: float = 30,
                    qs: Sequence[float] = (0.5, 0.95, 0.99, 1)) -> bool:
    """latency-quantiles.png: per-f latency quantiles over dt-second
    windows (perf.clj:514-556)."""
    lh = util.history_latencies(history)
    by_f = {f: latencies_to_quantiles(
        dt, qs, [latency_point(o) for o in ops if "latency" in o])
        for f, ops in invokes_by_f(lh).items()}
    palette = ["#FF1E90", "#FFA400", "#81BFFC", "#53DF83", "#909090"]
    q_colors = {q: palette[i % len(palette)]
                for i, q in enumerate(sorted(qs, reverse=True))}
    fig, ax = fig_ax(f"{test.get('name', '')} latency", "Latency (ms)", True)
    any_points = False
    markers = "osv^D*Pp"
    for i, f in enumerate(fs_order(by_f)):
        for q in qs:
            pts = by_f[f].get(q) or []
            if not pts:
                continue
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker=markers[i % len(markers)], ms=4,
                    color=q_colors[q], label=f"{util.name_of(f)} {q}")
            any_points = True
    draw_nemeses(ax, history, nemeses, t_max(history))
    finish(fig, ax, path)
    return any_points


def rates(history: Sequence[dict], dt: float = 10) -> dict:
    """{f: {type: {bucket-time: hz}}} over client completions
    (rate-graph! accumulation, perf.clj:560-586)."""
    out: dict[Any, dict] = {}
    for op in history:
        if op.get("type") == "invoke" or not isinstance(
                op.get("process"), int):
            continue
        if op.get("type") not in TYPES:
            continue
        b = bucket_time(dt, nanos_to_secs(op.get("time")))
        slot = out.setdefault(op.get("f"), {}).setdefault(op["type"], {})
        slot[b] = slot.get(b, 0.0) + 1.0 / dt
    return out


def rate_graph(test: dict, history: Sequence[dict], path,
               nemeses=None, dt: float = 10) -> bool:
    """rate.png: completion throughput (hz) by f and type
    (perf.clj:560-600)."""
    datasets = rates(history, dt)
    tmax = t_max(history)
    fig, ax = fig_ax(f"{test.get('name', '')} rate", "Throughput (hz)", False)
    markers = "osv^D*Pp"
    any_points = False
    for i, f in enumerate(fs_order(datasets)):
        for t in TYPES:
            m = datasets[f].get(t)
            if not m:
                continue
            xs = buckets(dt, tmax)
            ax.plot(xs, [m.get(x, 0.0) for x in xs],
                    marker=markers[i % len(markers)], ms=4,
                    color=TYPE_COLORS[t], label=f"{util.name_of(f)} {t}")
            any_points = True
    draw_nemeses(ax, history, nemeses, tmax)
    finish(fig, ax, path)
    return any_points


# ---------------------------------------------------------------------------
# Checkers
# ---------------------------------------------------------------------------

def store_path(test: dict, opts: dict, filename: str):
    """`filename` in the test's run dir, under `opts["subdirectory"]`
    (a name or a list of them: `independent.checker` nests each key's
    artifacts there), or None when the test has no store."""
    store = test.get("store")
    if store is None:
        return None
    sub = (opts or {}).get("subdirectory")
    parts = [sub] if isinstance(sub, str) else list(sub or [])
    return store.path(test, *[str(p) for p in parts], filename)


class LatencyGraph(Checker):
    """Renders latency-raw.png and latency-quantiles.png
    (checker.clj:797-808)."""

    def __init__(self, nemeses=None):
        self.nemeses = nemeses

    def check(self, test, history, opts):
        nemeses = self.nemeses or (test.get("plot") or {}).get("nemeses")
        p1 = store_path(test, opts, "latency-raw.png")
        p2 = store_path(test, opts, "latency-quantiles.png")
        if p1 is not None:
            point_graph(test, history, p1, nemeses)
            quantiles_graph(test, history, p2, nemeses)
        return {"valid?": True}


class RateGraph(Checker):
    """Renders rate.png (checker.clj:810-820)."""

    def __init__(self, nemeses=None):
        self.nemeses = nemeses

    def check(self, test, history, opts):
        nemeses = self.nemeses or (test.get("plot") or {}).get("nemeses")
        p = store_path(test, opts, "rate.png")
        if p is not None:
            rate_graph(test, history, p, nemeses)
        return {"valid?": True}


def latency_graph(nemeses=None) -> Checker:
    return LatencyGraph(nemeses)


def rate_graph_checker(nemeses=None) -> Checker:
    return RateGraph(nemeses)


def perf(opts: dict | None = None) -> Checker:
    """Composite latency + rate checker (checker.clj:822-829)."""
    from . import compose
    nemeses = (opts or {}).get("nemeses")
    return compose({"latency-graph": latency_graph(nemeses),
                    "rate-graph": rate_graph_checker(nemeses)})
