"""The cost-aware dispatch planner (JEPSEN_TPU_PLANNER, default off).

Counterpart of `jepsen_tpu/planner.py`. A sweep otherwise runs one
global configuration — one bucket pad multiple, one fused-or-two-pass
setting, a `T_pad²` admission proxy — although the costdb
(`obs.device`, `JEPSEN_TPU_COSTDB`) records device seconds per (kernel
flags, formulation, geometry) and the analytics ledger (`obs.search`,
`JEPSEN_TPU_KERNEL_STATS`) records each history's edge density and
closure rounds. This module fits a model of device seconds per history
against T_pad, closure rounds and edge density (a log-space ridge fit,
the complexity model of arxiv 1908.04509 with this card's own
coefficients) and steers four levers with it:

  * **bucket geometry** — `parallel.check_bucketed_async` asks
    `plan_buckets` which pad multiple (128/256/512) composes its
    buckets at the least predicted device seconds plus per-dispatch
    overhead; a bucket still pads to a multiple of 128 (the closure
    kernel's row tile), whichever multiple composed it;
  * **fused vs two-pass** — `parallel.check_bucketed` asks
    `fused_choice` which classify strategy the model prices cheaper,
    when the costdb has measured both;
  * **split tier** — `split_native`, whether a history is big enough
    for the native per-key splitter (no sweep of either package calls
    it: the register sweeps split in Python);
  * **admission pricing** — `admission_cost`, the model's prediction in
    `folding.fold_cost`'s cell unit (the serve daemon prices each
    admitted request with it).

THE INVARIANT: decisions never change verdicts, only placement. Every
lever routes between strategies already pinned as verdict-identical,
and the cold start — no costdb, an unseen device kind, a corrupt plan,
a degenerate model — gives the exact current heuristics
(`bucket_by_length` at multiple 128, the fused gate, `fold_cost`).

The fit persists as `<store>/plan.json` (`JEPSEN_TPU_PLANNER_PATH`
overrides), published by temp file and rename, so a warm sweep loads it
instead of refitting. Each decision counts on the tracer (`planner.*`
counters: decisions, fallbacks, per-lever counts, predicted-vs-measured
error) and lands in `analyze-store --report`'s "planner" section. The
plan's keys and numbers are the reference's, so either package reads
the other's plan.

Stdlib-only module imports (gates, trace): pricing a request needs no
torch.
"""

from __future__ import annotations

import json
import logging
import math
import threading

from . import gates, trace

log = logging.getLogger(__name__)

PLAN_VERSION = 1

#: Candidate bucket pad multiples `plan_buckets` races. 128 (the
#: closure kernel's row tile, the global default) is always first: the
#: fallback and the tie-break both land there, so an uninformative
#: model reproduces current behavior exactly.
GEOMETRY_CANDIDATES = (128, 256, 512)

#: The admission cost unit's reference T_pad: a history padding to 128
#: txns costs 128² cells under the model, exactly `fold_cost`'s floor,
#: so modeled and proxy costs share one scale and `budget_cells`
#: semantics are preserved.
_REF_TPAD = 128

#: Ridge regularizer for the log-space fit: keeps the tiny normal
#: system solvable on degenerate training sets (one geometry, one
#: mode) without changing a well-conditioned fit measurably.
_RIDGE = 1e-6

_LOCK = threading.Lock()
_active: "Planner | None" = None


def enabled() -> bool:
    """The JEPSEN_TPU_PLANNER gate (default off)."""
    return gates.get("JEPSEN_TPU_PLANNER")


# ---------------------------------------------------------------------------
# The model: costdb × analytics join, log-space ridge fit, prediction.
# ---------------------------------------------------------------------------

def _mode_key(rec: dict) -> str | None:
    """The model's stratification key for one costdb record: the
    kernel flags + formulation that pick an executable family. Two
    records with the same mode are the same cost curve sampled at
    different geometries."""
    k = rec.get("kernel")
    if not isinstance(k, dict):
        return None
    return "|".join((
        "classify" if k.get("classify", True) else "detect",
        "rt" if k.get("realtime") else "nort",
        "fused" if k.get("fused") else "twopass",
        str(rec.get("formulation") or "xla-bf16"),
    ))


def _analytics_by_tpad(search_records) -> dict[int, dict]:
    """Per-t_pad means of the analytics ledger's closure rounds and
    edge density (edges per txn) — the model's two non-geometric
    features. Register (WGL) records carry no t_pad and are skipped."""
    acc: dict[int, list] = {}
    for r in search_records or []:
        if not isinstance(r, dict):
            continue
        t = r.get("t_pad")
        if not isinstance(t, int) or t <= 0:
            continue
        n = max(int(r.get("n_txns") or 1), 1)
        edges = sum(int(r.get(f) or 0) for f in
                    ("ww_edges", "wr_edges", "rw_edges", "rt_edges",
                     "proc_edges"))
        rounds = r.get("closure_rounds")
        a = acc.setdefault(t, [0, 0.0, 0.0])
        a[0] += 1
        a[1] += float(rounds) if isinstance(rounds, (int, float)) else 1.0
        a[2] += edges / n
    return {t: {"rounds": a[1] / a[0],
                "edges_per_txn": a[2] / a[0],
                "histories": a[0]}
            for t, a in acc.items()}


def _features(t_pad: int, analytics: dict | None) -> list[float]:
    """The fit/predict feature row at one geometry: intercept, log
    T_pad, log1p closure rounds, log1p edge density — rounds/density
    taken from the NEAREST analytics t_pad bucket (the join is by
    geometry, and an unseen geometry borrows its closest neighbor's
    graph shape rather than inventing one)."""
    rounds, density = 1.0, 0.0
    if analytics:
        keys = [int(k) for k in analytics]
        near = min(keys, key=lambda k: abs(k - t_pad))
        row = analytics[near] if near in analytics \
            else analytics[str(near)]
        rounds = float(row.get("rounds", 1.0))
        density = float(row.get("edges_per_txn", 0.0))
    return [1.0, math.log(max(t_pad, 1)),
            math.log1p(max(rounds, 0.0)),
            math.log1p(max(density, 0.0))]


def _solve_ridge(rows: list[list[float]], ys: list[float]) -> list[float]:
    """Least squares with a ridge term, by Gaussian elimination on the
    normal equations — pure python, deterministic, fine at 4×4."""
    k = len(rows[0])
    ata = [[_RIDGE if i == j else 0.0 for j in range(k)]
           for i in range(k)]
    atb = [0.0] * k
    for x, y in zip(rows, ys):
        for i in range(k):
            atb[i] += x[i] * y
            for j in range(k):
                ata[i][j] += x[i] * x[j]
    # elimination with partial pivoting
    for col in range(k):
        piv = max(range(col, k), key=lambda r: abs(ata[r][col]))
        if abs(ata[piv][col]) < 1e-30:
            return [0.0] * k
        ata[col], ata[piv] = ata[piv], ata[col]
        atb[col], atb[piv] = atb[piv], atb[col]
        for r in range(k):
            if r == col:
                continue
            f = ata[r][col] / ata[col][col]
            atb[r] -= f * atb[col]
            for c in range(col, k):
                ata[r][c] -= f * ata[col][c]
    return [atb[i] / ata[i][i] for i in range(k)]


def training_points(cost_records, search_records) -> dict[str, list]:
    """The costdb × analytics join: per mode key, (t_pad, features,
    measured device seconds per history) for every costdb record that
    carries a real measured window. This is the `search_section`
    by-geometry join promoted to training data."""
    analytics = _analytics_by_tpad(search_records)
    by_mode: dict[str, list] = {}
    for rec in cost_records or []:
        if not isinstance(rec, dict):
            continue
        mode = _mode_key(rec)
        w = rec.get("windows") or {}
        g = rec.get("geometry") or {}
        t_pad = g.get("n_txns")
        hist = w.get("histories") or 0
        secs = w.get("device_secs") or 0.0
        if mode is None or not isinstance(t_pad, int) or t_pad <= 0 \
                or hist <= 0 or secs <= 0:
            continue
        y = secs / hist
        by_mode.setdefault(mode, []).append(
            (t_pad, _features(t_pad, analytics), y))
    return by_mode


def fit_plan(cost_records, search_records, *,
             device_kind: str | None = None,
             backend: str | None = None) -> dict | None:
    """Fit the plan from raw costdb/analytics records. None when the
    tables hold no usable measurement (the cold-start predicate) —
    never a degenerate all-zeros model."""
    by_mode = training_points(cost_records, search_records)
    if not by_mode:
        return None
    modes: dict[str, dict] = {}
    for mode, pts in sorted(by_mode.items()):
        coeffs = _solve_ridge([f for _t, f, _y in pts],
                              [math.log(max(y, 1e-12))
                               for _t, _f, y in pts])
        modes[mode] = {
            "coeffs": [round(c, 9) for c in coeffs],
            "points": len(pts),
            "t_pad_min": min(t for t, _f, _y in pts),
            "t_pad_max": max(t for t, _f, _y in pts),
        }
    overheads = []
    provenance = "estimated"
    for rec in cost_records or []:
        w = (rec or {}).get("windows") or {}
        if isinstance(w.get("min_secs"), (int, float)):
            overheads.append(float(w["min_secs"]))
        if isinstance(rec, dict) and rec.get("provenance") == "measured":
            provenance = "measured"
        if device_kind is None and isinstance(rec, dict) \
                and rec.get("device_kind"):
            device_kind = rec["device_kind"]
        if backend is None and isinstance(rec, dict) \
                and rec.get("backend"):
            backend = rec["backend"]
    analytics = _analytics_by_tpad(search_records)
    return {
        "v": PLAN_VERSION,
        "device_kind": device_kind or "unknown",
        "backend": backend or "unknown",
        "provenance": provenance,
        "trained_records": sum(len(p) for p in by_mode.values()),
        "modes": modes,
        "analytics": {str(t): {"rounds": round(r["rounds"], 4),
                               "edges_per_txn":
                                   round(r["edges_per_txn"], 4)}
                      for t, r in sorted(analytics.items())},
        # per-dispatch fixed overhead for the geometry race: the
        # fastest window ever measured approximates enqueue+launch
        "overhead_secs": round(min(overheads), 6) if overheads
        else 0.002,
        # histories smaller than this run the python splitter under
        # the planner; 0 (the default fit) keeps the native gate's
        # behavior — there is no split-cost table to fit yet
        "split_min_ops": 0,
    }


def _pick_mode(plan: dict, *, classify: bool = True,
               fused: bool | None = None) -> str | None:
    """The best-sampled mode key matching the requested strategy (the
    caller may not care about fused-ness: fused=None matches either)."""
    best, best_pts = None, -1
    for mode, row in (plan.get("modes") or {}).items():
        parts = mode.split("|")
        if classify != (parts[0] == "classify"):
            continue
        if fused is not None and (parts[2] == "fused") != fused:
            continue
        pts = int(row.get("points") or 0)
        if pts > best_pts:
            best, best_pts = mode, pts
    return best


def predict_secs(plan: dict, t_pad: int, *, mode: str | None = None,
                 classify: bool = True,
                 fused: bool | None = None) -> float | None:
    """Predicted device seconds per history at one padded geometry,
    or None when the plan holds no matching mode — the caller then
    falls back to the heuristic, it never guesses."""
    if not isinstance(plan, dict):
        return None
    if mode is None or mode not in (plan.get("modes") or {}):
        mode = _pick_mode(plan, classify=classify, fused=fused)
    row = (plan.get("modes") or {}).get(mode)
    if not row:
        return None
    coeffs = row.get("coeffs")
    if not isinstance(coeffs, list) or len(coeffs) != 4:
        return None
    x = _features(int(t_pad), plan.get("analytics") or {})
    ln = sum(c * f for c, f in zip(coeffs, x))
    # clamp the exponent: a wild extrapolation must stay a finite,
    # orderable number, not an inf that poisons the DRR arithmetic
    return math.exp(max(-25.0, min(ln, 5.0)))


# ---------------------------------------------------------------------------
# plan.json persistence — snapshot protocol (JT-DUR "dispatch plan").
# ---------------------------------------------------------------------------

def save_plan(path, plan: dict) -> bool:
    """Publish the fitted plan atomically (temp + os.replace via
    trace.atomic_write_text). Best-effort: a read-only store logs and
    returns False, never fails the sweep."""
    try:
        trace.atomic_write_text(path,
                                json.dumps(plan, indent=2) + "\n")
        return True
    except OSError:
        log.debug("plan save failed for %s", path, exc_info=True)
        return False


def load_plan(path) -> dict | None:
    """The persisted plan, or None for missing/corrupt/alien files —
    the AOT-cache degrade rule: a bad snapshot means a fresh cold
    start (heuristic fallback), never a failed sweep."""
    from pathlib import Path
    p = Path(path)
    if not p.is_file():
        return None
    try:
        plan = json.loads(p.read_text())
    except (OSError, ValueError):
        log.debug("plan load failed for %s (degrading to the "
                  "heuristic fallback)", p, exc_info=True)
        return None
    if not isinstance(plan, dict) or plan.get("v") != PLAN_VERSION \
            or not isinstance(plan.get("modes"), dict):
        log.debug("plan %s has alien shape; degrading to the "
                  "heuristic fallback", p)
        return None
    return plan


# ---------------------------------------------------------------------------
# The router.
# ---------------------------------------------------------------------------

class Planner:
    """One sweep's (or daemon's) routing brain: a fitted plan — or
    None, in which case EVERY decision is the deterministic heuristic
    fallback, counted as such. Decisions only ever choose placement
    among verdict-identical strategies (module docstring)."""

    def __init__(self, plan: dict | None, source: str):
        self.plan = plan
        #: "plan" (loaded snapshot), "fit" (fresh fit), "cold" (gate
        #: on, no model — pure fallback).
        self.source = source if plan is not None else "cold"

    @property
    def modeled(self) -> bool:
        return self.plan is not None

    # -- decision bookkeeping ---------------------------------------------

    def _decide(self, lever: str, fallback: bool) -> None:
        trace.counter("planner.decisions").inc()
        trace.counter(f"planner.{lever}").inc()
        if fallback:
            trace.counter("planner.fallbacks").inc()

    # -- lever: serve admission pricing -----------------------------------

    def admission_cost(self, n_txns: int, checker: str = "append") -> int:
        """One request's admission price in `fold_cost`'s cell unit:
        the model's predicted device seconds normalized so a T_pad=128
        history costs exactly 128² cells. DRR semantics survive by
        construction — any positive integer cost does. Fallback (and
        any degenerate prediction): `fold_cost` itself, bit-exact."""
        from .parallel import folding
        proxy = folding.fold_cost(int(n_txns or 1))
        if self.plan is None:
            self._decide("admission", fallback=True)
            return proxy
        t = max(int(n_txns or 1), 1)
        t_pad = max(_REF_TPAD,
                    ((t + _REF_TPAD - 1) // _REF_TPAD) * _REF_TPAD)
        pred = predict_secs(self.plan, t_pad, classify=True)
        unit = predict_secs(self.plan, _REF_TPAD, classify=True)
        if not pred or not unit or unit <= 0:
            self._decide("admission", fallback=True)
            return proxy
        self._decide("admission", fallback=False)
        return max(1, int(round(_REF_TPAD * _REF_TPAD * pred / unit)))

    # -- lever: bucket geometry -------------------------------------------

    def plan_buckets(self, encs, *, budget_cells: int,
                     dp: int = 1) -> list[list[int]]:
        """Bucket composition for one dispatch pipeline: race the
        candidate pad multiples on predicted total device seconds
        (per-history model cost + per-dispatch overhead) and keep the
        winner's buckets. Every candidate satisfies the same
        B_pad·T_pad² ≤ budget envelope, and composition only moves
        histories between dispatches — verdicts cannot change.
        Fallback: `bucket_by_length` at multiple 128, bit-exact. `dp`
        as bucket_by_length's (a mesh's padding headroom)."""
        from .parallel import bucket_by_length
        base = bucket_by_length(encs, budget_cells=budget_cells, dp=dp)
        if self.plan is None:
            self._decide("geometry", fallback=True)
            return base
        overhead = float(self.plan.get("overhead_secs") or 0.002)

        def predicted_total(buckets) -> float | None:
            total = 0.0
            for b in buckets:
                t_pad = max(_size_pad(encs, b), 1)
                per = predict_secs(self.plan, t_pad, classify=True)
                if per is None:
                    return None
                total += overhead + per * len(b)
            return total

        best, best_cost, fell_back = base, predicted_total(base), False
        if best_cost is None:
            self._decide("geometry", fallback=True)
            return base
        for m in GEOMETRY_CANDIDATES[1:]:
            cand = bucket_by_length(encs, multiple=m,
                                    budget_cells=budget_cells, dp=dp)
            cost = predicted_total(cand)
            if cost is not None and cost < best_cost:
                best, best_cost = cand, cost
        self._decide("geometry", fallback=fell_back)
        return best

    # -- lever: fused vs two-pass classify --------------------------------

    def fused_choice(self, default: bool, *, classify: bool = True,
                     t_pad: int = _REF_TPAD) -> bool:
        """The classify strategy the model prices cheaper at this
        geometry — only when the costdb has MEASURED both strategies
        (the verdicts are pinned identical either way); one-sided or
        absent evidence keeps the gate's default."""
        if not classify or self.plan is None:
            self._decide("fused", fallback=True)
            return default
        fused = predict_secs(self.plan, t_pad, classify=True,
                             fused=True)
        two = predict_secs(self.plan, t_pad, classify=True,
                           fused=False)
        has_both = (
            _pick_mode(self.plan, classify=True, fused=True) is not None
            and _pick_mode(self.plan, classify=True,
                           fused=False) is not None)
        if not has_both or fused is None or two is None:
            self._decide("fused", fallback=True)
            return default
        self._decide("fused", fallback=False)
        return fused <= two

    # -- lever: split tier (python vs native) -----------------------------

    def split_native(self, n_ops: int) -> bool:
        """Whether the native per-key splitter should run for a
        history of `n_ops` ops (the caller has already checked the
        gate — the planner can only DECLINE native, never force it on
        past the user's pin). The threshold rides the plan so an
        operator (or a future split-cost fit) can raise it; the
        fitted default 0 reproduces current behavior."""
        if self.plan is None:
            self._decide("split", fallback=True)
            return True
        thresh = int(self.plan.get("split_min_ops") or 0)
        self._decide("split", fallback=False)
        return int(n_ops) >= thresh

    # -- predicted-vs-measured accounting ---------------------------------

    def score_against(self, cost_records) -> dict | None:
        """Mean relative predicted-vs-measured error of this plan
        over freshly measured costdb records — the honesty loop: the
        report (and the `planner.pred_err_permille` gauge) always
        shows how wrong the model was THIS sweep."""
        if self.plan is None:
            return None
        errs = []
        for rec in cost_records or []:
            if not isinstance(rec, dict):
                continue
            w = rec.get("windows") or {}
            g = rec.get("geometry") or {}
            hist = w.get("histories") or 0
            secs = w.get("device_secs") or 0.0
            t_pad = g.get("n_txns")
            if hist <= 0 or secs <= 0 or not isinstance(t_pad, int):
                continue
            pred = predict_secs(self.plan, t_pad, mode=_mode_key(rec))
            if pred is None:
                continue
            measured = secs / hist
            errs.append(abs(pred - measured) / max(measured, 1e-12))
            trace.counter("planner.pred_checked").inc()
        if not errs:
            return None
        mean_err = sum(errs) / len(errs)
        trace.gauge("planner.pred_err_permille").set(
            int(round(mean_err * 1000)))
        return {"records": len(errs),
                "mean_rel_err": round(mean_err, 4),
                "max_rel_err": round(max(errs), 4)}


def _size_pad(encs, bucket: list[int], multiple: int = _REF_TPAD) -> int:
    """A bucket's dispatch T_pad: its max history size rounded to the
    kernel's row tile — the geometry `BatchShape.plan` will pad to,
    whatever multiple composed the bucket."""
    n = max(_enc_size(encs[i]) for i in bucket)
    return max(multiple,
               ((n + multiple - 1) // multiple) * multiple)


def _enc_size(e) -> int:
    n = getattr(e, "n", None)
    if n is None and isinstance(e, dict):
        n = e.get("n")
    return max(int(n or 1), 1)


# ---------------------------------------------------------------------------
# Lifecycle: one active planner per process, like the observatories.
# ---------------------------------------------------------------------------

def get() -> "Planner | None":
    """The active planner, or None when the gate is off (the dispatch
    layers' one-gate-read fast path). Gate on with nothing activated
    yet yields a cold planner: pure fallback until someone fits or
    loads a plan."""
    if not enabled():
        return None
    global _active
    with _LOCK:
        if _active is None:
            _active = Planner(None, "cold")
        return _active


def activate(store_base=None) -> "Planner | None":
    """Install the planner for a sweep/daemon: load the persisted
    plan.json if one exists (warm start), else run cold. No-op
    (returns None) when the gate is off."""
    global _active
    if not enabled():
        with _LOCK:
            _active = None
        return None
    plan = None
    with trace.span("planner.activate"):
        if store_base is not None \
                or gates.get("JEPSEN_TPU_PLANNER_PATH"):
            from .store import plan_path
            plan = load_plan(plan_path(store_base or "."))
    pl = Planner(plan, "plan")
    if plan is None:
        trace.counter("planner.cold_starts").inc()
    with _LOCK:
        _active = pl
    return pl


def deactivate() -> None:
    """Drop the active planner (sweep end, tests)."""
    global _active
    with _LOCK:
        _active = None


def current_plan() -> dict | None:
    """The active planner's fitted plan, or None (cold / gate off) —
    the report section's input."""
    with _LOCK:
        return _active.plan if _active is not None else None


def refresh(store_base, cost_records, search_records) -> dict | None:
    """Sweep-end refit: fit a fresh plan from this sweep's records
    (joined with whatever the store already held) and persist it, so
    the NEXT sweep and the daemon warm-start. Returns the plan, or
    None when there was nothing to fit; never raises."""
    if not enabled():
        return None
    try:
        from .store import plan_path
        with trace.span("planner.fit"):
            plan = fit_plan(cost_records, search_records)
        if plan is None:
            return None
        save_plan(plan_path(store_base), plan)
        with _LOCK:
            global _active
            _active = Planner(plan, "fit")
        return plan
    except Exception:
        log.debug("planner refresh failed", exc_info=True)
        return None


# ---------------------------------------------------------------------------
# Report section — the device/search sections' pattern.
# ---------------------------------------------------------------------------

def planner_section(plan: dict | None, cost_records=None,
                    metrics: dict | None = None) -> dict:
    """The report's "planner" section: model provenance, per-mode fit
    shape, decision/fallback counts from the sweep's metrics, and the
    predicted-vs-measured error over this sweep's fresh records."""
    counters = (metrics or {}).get("counters") or {}
    sec: dict = {
        "enabled": enabled(),
        "modeled": plan is not None,
        "decisions": int(counters.get("planner.decisions") or 0),
        "fallbacks": int(counters.get("planner.fallbacks") or 0),
        "levers": {lv: int(counters.get(f"planner.{lv}") or 0)
                   for lv in ("geometry", "fused", "split", "admission")
                   if counters.get(f"planner.{lv}")},
    }
    if plan is not None:
        sec["device_kind"] = plan.get("device_kind")
        sec["provenance"] = plan.get("provenance")
        sec["trained_records"] = plan.get("trained_records")
        sec["modes"] = {m: {"points": r.get("points"),
                            "t_pad_range": [r.get("t_pad_min"),
                                            r.get("t_pad_max")]}
                        for m, r in (plan.get("modes") or {}).items()}
        err = Planner(plan, "plan").score_against(cost_records)
        if err is not None:
            sec["predicted_vs_measured"] = err
    return sec


def render_planner_md(sec: dict) -> list[str]:
    """The report.md rendering of one planner section."""
    out = ["", "## Cost-aware planner", ""]
    if not sec.get("modeled"):
        out.append("cold start: no fitted model — every decision "
                   "took the deterministic heuristic fallback "
                   f"({sec.get('fallbacks', 0)} of "
                   f"{sec.get('decisions', 0)} decisions).")
        return out
    out.append(f"model: {sec.get('trained_records', 0)} training "
               f"record(s) on `{sec.get('device_kind')}` "
               f"({sec.get('provenance')}); "
               f"{sec.get('decisions', 0)} decision(s), "
               f"{sec.get('fallbacks', 0)} fallback(s)")
    pv = sec.get("predicted_vs_measured")
    if pv:
        out.append(f"predicted-vs-measured: mean "
                   f"{pv['mean_rel_err']:.1%} / max "
                   f"{pv['max_rel_err']:.1%} relative error over "
                   f"{pv['records']} record(s)")
    modes = sec.get("modes") or {}
    if modes:
        out += ["", "| mode | points | t_pad range |", "|---|---|---|"]
        for m, r in sorted(modes.items()):
            lo, hi = (r.get("t_pad_range") or [None, None])[:2]
            # mode keys embed literal pipes — escape for the table
            out.append(f"| `{m.replace('|', chr(92) + '|')}` | "
                       f"{r.get('points')} | {lo}–{hi} |")
    return out
