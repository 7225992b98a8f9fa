"""Clock-skew analysis and plot.

Counterpart of jepsen.checker.clock (jepsen/src/jepsen/checker/clock.clj):
any op carrying a ``clock-offsets`` map (node -> offset seconds, annotated
by the clock nemesis) contributes points; per-node step series are rendered
to ``clock-skew.png``.

The port's copy of `jepsen_tpu/checker/clock.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from typing import Sequence

from . import Checker
from .perf import draw_nemeses, fig_ax, finish, store_path, nanos_to_secs


def history_to_datasets(history: Sequence[dict]) -> dict:
    """{node: [(t-seconds, offset), ...]} from clock-offsets annotations,
    each series extended to the final history time (clock.clj:13-34)."""
    if not history:
        return {}
    final_t = max((nanos_to_secs(o.get("time")) for o in history),
                  default=0.0)
    series: dict = {}
    for op in history:
        offsets = op.get("clock-offsets")
        if not offsets:
            continue
        t = nanos_to_secs(op.get("time"))
        for node, offset in offsets.items():
            series.setdefault(node, []).append((t, offset))
    return {node: pts + [(final_t, pts[-1][1])]
            for node, pts in series.items()}


def short_node_names(nodes: Sequence[str]) -> list[str]:
    """Strip the longest common dotted suffix: n1.foo.com, n2.foo.com ->
    n1, n2 (clock.clj:36-45)."""
    if len(nodes) < 2:
        return list(nodes)
    split = [str(n).split(".") for n in nodes]
    k = 0
    min_len = min(len(s) for s in split)
    while k < min_len - 1 and len({tuple(s[len(s) - 1 - k:]) for s in split}) == 1:
        k += 1
    return [".".join(s[: len(s) - k]) for s in split]


def plot(test: dict, history: Sequence[dict], path,
         nemeses=None) -> bool:
    """Render clock-skew.png with nemesis activity overlaid; returns
    False when no op has offsets (clock.clj:47-75)."""
    datasets = history_to_datasets(history)
    if not datasets:
        return False
    nodes = sorted(datasets, key=str)
    names = short_node_names(nodes)
    fig, ax = fig_ax(f"{test.get('name', '')} clock skew", "Skew (s)", False)
    for node, name in zip(nodes, names):
        pts = datasets[node]
        ax.step([p[0] for p in pts], [p[1] for p in pts], where="post",
                label=name)
    final_t = max((nanos_to_secs(o.get("time")) for o in history),
                  default=1.0)
    draw_nemeses(ax, history, nemeses, final_t)
    finish(fig, ax, path)
    return True


class ClockPlot(Checker):
    """Checker wrapper (checker.clj:831-837)."""

    def check(self, test, history, opts):
        p = store_path(test, opts or {}, "clock-skew.png")
        if p is not None and history:
            plot(test, history, p,
                 (test.get("plot") or {}).get("nemeses"))
        return {"valid?": True}


def clock_plot() -> Checker:
    return ClockPlot()
