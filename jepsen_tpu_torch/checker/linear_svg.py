"""Render a linearizability failure to ``linear.svg``.

The port's copy of `jepsen_tpu/checker/linear_svg.py`, the counterpart
of knossos.linear.report (used by checker/linearizable at
jepsen/src/jepsen/checker.clj:209-213, which renders linear.svg for
invalid analyses): per-process swimlanes of the operations concurrent
with the failing op, the failing op highlighted, and the deepest
linearization path found (``final-paths``) listed with its model states.
Like the reference renderer, output is bounded — it "can't handle really
broad concurrencies" so lanes are capped.
"""

from __future__ import annotations

import html as _html
from typing import Sequence

from .. import history as h

LANE_H = 26
BAR_H = 18
PX_PER_OP = 28
LABEL_W = 70
MAX_LANES = 32

OK_COLOR = "#6DB6FE"
FAIL_COLOR = "#FEB5DA"
INFO_COLOR = "#FFAA26"
BAD_COLOR = "#FF1E90"


def _same_op(a: dict | None, b: dict | None) -> bool:
    """Identify the analysis' failing op within the raw history. The
    analyzer's 'index' comes from its own reduced history, so match on
    the stable identity fields instead."""
    if a is None or b is None:
        return False
    return (a.get("process") == b.get("process")
            and a.get("time") == b.get("time")
            and a.get("f") == b.get("f"))


def _window(history: Sequence[dict], bad_op: dict | None,
            radius: int = 40) -> tuple[list[tuple[dict, dict | None]], int]:
    """(invoke/complete pairs within `radius` positions of the failing
    op, position of the failing pair or -1)."""
    pairs = list(h.pairs(h.index(list(history))))
    bad_pos = next((i for i, (inv, comp) in enumerate(pairs)
                    if _same_op(inv, bad_op) or _same_op(comp, bad_op)),
                   -1)
    if bad_pos < 0:
        return pairs[:radius], -1
    lo = max(0, bad_pos - radius // 2)
    window = pairs[lo: bad_pos + radius // 2]
    return window, bad_pos - lo


def render_svg(analysis: dict, history: Sequence[dict]) -> str:
    """SVG document for a (usually invalid) wgl/linear analysis."""
    bad = analysis.get("op")
    pairs, bad_pos = _window(history, bad)
    procs = []
    for inv, _ in pairs:
        if inv.get("process") not in procs:
            procs.append(inv.get("process"))
    if len(procs) > MAX_LANES:
        keep = procs[:MAX_LANES]
        if 0 <= bad_pos < len(pairs):
            # The failing op's lane must survive truncation — it carries
            # the BAD_COLOR highlight the whole render exists for.
            bad_proc = pairs[bad_pos][0].get("process")
            if bad_proc in procs and bad_proc not in keep:
                keep[-1] = bad_proc
        procs = keep
    lane = {p: i for i, p in enumerate(procs)}
    idxs = [i.get("index", 0) for i, _ in pairs] + \
        [(c or i).get("index", 0) for i, c in pairs]
    lo, hi = (min(idxs), max(idxs)) if idxs else (0, 1)
    span = max(hi - lo, 1)
    width = LABEL_W + 24 * min(span, 400) + 120
    px = (width - LABEL_W - 100) / span

    elems = []
    for pos, (inv, comp) in enumerate(pairs):
        p = inv.get("process")
        if p not in lane:
            continue
        y = 30 + lane[p] * LANE_H
        x0 = LABEL_W + (inv.get("index", lo) - lo) * px
        x1 = LABEL_W + ((comp or inv).get("index", lo) - lo + 1) * px
        op = comp or inv
        color = {"ok": OK_COLOR, "fail": FAIL_COLOR}.get(
            op.get("type"), INFO_COLOR)
        if pos == bad_pos:
            color = BAD_COLOR
        label = f"{op.get('f')} {op.get('value')}"
        tooltip = _html.escape(repr(op))
        elems.append(
            f'<rect x="{x0:.1f}" y="{y}" width="{max(x1 - x0, 4):.1f}" '
            f'height="{BAR_H}" rx="3" fill="{color}">'
            f'<title>{tooltip}</title></rect>'
            f'<text x="{x0 + 3:.1f}" y="{y + 13}" font-size="10">'
            f'{_html.escape(str(label))[:24]}</text>')
    for p, i in lane.items():
        elems.append(
            f'<text x="4" y="{30 + i * LANE_H + 13}" font-size="11" '
            f'font-weight="bold">{_html.escape(str(p))}</text>')

    y = 30 + len(procs) * LANE_H + 24
    path = analysis.get("final-paths") or []
    elems.append(f'<text x="4" y="{y}" font-size="12" font-weight="bold">'
                 f'deepest linearization '
                 f'(depth {analysis.get("max-depth")}):</text>')
    for step in path[-12:]:
        y += 16
        op = step.get("op", {})
        elems.append(
            f'<text x="12" y="{y}" font-size="11">'
            f'{_html.escape(str(op.get("f")))} '
            f'{_html.escape(str(op.get("value")))} → model '
            f'{_html.escape(str(step.get("model")))}</text>')
    if bad is not None:
        y += 20
        elems.append(
            f'<text x="4" y="{y}" font-size="12" fill="{BAD_COLOR}" '
            f'font-weight="bold">cannot linearize: '
            f'{_html.escape(str(bad.get("f")))} '
            f'{_html.escape(str(bad.get("value")))}</text>')
    height = y + 24
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width:.0f}" '
            f'height="{height}" font-family="sans-serif">'
            f'<text x="4" y="16" font-size="13" font-weight="bold">'
            f'linearizability analysis</text>' + "".join(elems) + "</svg>")


def render_analysis(test: dict, analysis: dict,
                    history: Sequence[dict], opts: dict | None = None):
    """Write linear.svg into the store; returns the path or None."""
    from .perf import store_path
    p = store_path(test, opts or {}, "linear.svg")
    if p is None:
        return None
    p.write_text(render_svg(analysis, history))
    return p
