"""HTML timeline of operations, one swimlane per process.

The port's copy of `jepsen_tpu/checker/timeline.py`, the counterpart of
jepsen.checker.timeline
(jepsen/src/jepsen/checker/timeline.clj): pairs up invocations with their
completions (pairs, timeline.clj:33), renders each as an absolutely
positioned div colored by completion type (pair->div timeline.clj:97,
stylesheet timeline.clj:14-31), and writes ``timeline.html`` into the
store. Hovering shows duration, error, value, and the full op; anchors
``#i<index>`` allow deep-linking an op from a verdict.
"""

from __future__ import annotations

import html as _html
import json
from typing import Sequence

from .. import history as h
from . import Checker
from .perf import store_path, nanos_to_ms

COL_WIDTH = 100    # px (timeline.clj:12: col-width 100)
GUTTER = 106       # px between process columns (col-width + 6)
ROW_HEIGHT = 16    # px per op row

STYLESHEET = """
body { font-family: sans-serif; font-size: 12px; }
.ops { position: absolute; }
.op { position: absolute; padding: 2px; border-radius: 2px;
      box-shadow: 0 1px 3px rgba(0,0,0,0.12), 0 1px 2px rgba(0,0,0,0.24);
      overflow: hidden; }
.op.invoke { background: #eeeeee; }
.op.ok     { background: #6DB6FE; }
.op.info   { background: #FFAA26; }
.op.fail   { background: #FEB5DA; }
.op:target { box-shadow: 0 14px 28px rgba(0,0,0,0.25),
             0 10px 10px rgba(0,0,0,0.22); }
.process-label { position: absolute; top: 0; font-weight: bold; }
"""


def _render_value(v) -> str:
    try:
        return json.dumps(v, default=repr)
    except Exception:
        return repr(v)


def _title(start: dict, stop: dict | None) -> str:
    """Tooltip: duration, error, op dump (title, timeline.clj:76-85)."""
    parts = []
    if stop is not None and stop.get("time") is not None \
            and start.get("time") is not None:
        parts.append(f"Dur: {int(nanos_to_ms(stop['time'] - start['time']))} ms")
    op = stop or start
    if op.get("error") is not None:
        parts.append(f"Err: {_render_value(op.get('error'))}")
    parts.append(f"Op: {_render_value(op)}")
    return "\n".join(parts)


def _body(start: dict, stop: dict | None) -> str:
    """Visible text: process, f, value(s) (body, timeline.clj:87-95)."""
    op = stop or start
    txt = f"{start.get('process')} {op.get('f')}"
    if start.get("process") != "nemesis":
        txt += f" {_render_value(start.get('value'))}"
        if stop is not None and stop.get("value") != start.get("value"):
            txt += f" → {_render_value(stop.get('value'))}"
    return txt


def render_html(test: dict, history: Sequence[dict]) -> str:
    """Full timeline.html document (html, timeline.clj:159-179)."""
    history = h.index(list(history))
    procs = sorted({o.get("process") for o in history},
                   key=lambda p: (not isinstance(p, int),
                                  p if isinstance(p, int) else str(p)))
    col = {p: i for i, p in enumerate(procs)}
    divs = []
    for row, (start, stop) in enumerate(h.pairs(history)):
        op = stop or start
        typ = op.get("type", "info")
        left = col[start.get("process")] * GUTTER
        top = ROW_HEIGHT * (row + 1) + 4
        idx = op.get("index", row)
        divs.append(
            f'<a href="#i{idx}"><div class="op {_html.escape(str(typ))}"'
            f' id="i{idx}"'
            f' style="left:{left}px;top:{top}px;width:{COL_WIDTH}px;"'
            f' title="{_html.escape(_title(start, stop))}">'
            f'{_html.escape(_body(start, stop))}</div></a>')
    labels = "".join(
        f'<div class="process-label" style="left:{col[p] * GUTTER}px;">'
        f'{_html.escape(str(p))}</div>' for p in procs)
    name = _html.escape(str(test.get("name", "")))
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{name} timeline</title>"
        f"<style>{STYLESHEET}</style></head>"
        f"<body><h1>{name}</h1><div class='ops'>{labels}"
        + "".join(divs) + "</div></body></html>")


class Timeline(Checker):
    """Writes timeline.html into the store (html, timeline.clj:159)."""

    def check(self, test, history, opts):
        p = store_path(test, opts or {}, "timeline.html")
        if p is not None:
            p.write_text(render_html(test, history))
        return {"valid?": True}


def html() -> Checker:
    return Timeline()
