"""Generic cycle-detection workload: run any user-supplied dependency
analyzer over a history and fail on cycles.

Counterpart of jepsen.tests.cycle (jepsen/src/jepsen/tests/cycle.clj),
which wraps ``elle.core/check {:analyzer f}``. Here the analyzer is a
function ``history -> (edges, explain)`` where ``edges`` is an iterable
of (from-index, to-index, type) triples over indexed ops; cycles are
found by SCC over that graph (the same engine the Elle checkers use).

The port's copy of `jepsen_tpu/workloads/cycle.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from typing import Callable, Iterable

from .. import history as h
from ..checker import Checker
from ..checker.elle.graph import tarjan_scc


class CycleChecker(Checker):
    """Checker over a custom analyzer (cycle.clj:9-16)."""

    def __init__(self, analyzer: Callable):
        self.analyzer = analyzer

    def check(self, test, history, opts):
        history = h.index(list(history))
        out = self.analyzer(history)
        edges, explain = out if isinstance(out, tuple) else (out, None)
        n = len(history)
        adj: list[list[int]] = [[] for _ in range(n)]
        for e in edges:
            adj[e[0]].append(e[1])
        scc_ids = tarjan_scc(n, adj)
        comps: dict[int, list[int]] = {}
        for i, cid in enumerate(scc_ids):
            comps.setdefault(cid, []).append(i)
        sccs = [c for c in comps.values() if len(c) > 1]
        cycles = []
        for comp in sccs:
            comp = sorted(comp)
            cyc = {"ops": [history[i] for i in comp]}
            if explain is not None:
                cyc["explanation"] = explain(comp)
            cycles.append(cyc)
        return {"valid?": not cycles, "cycles": cycles,
                "scc-count": len(sccs)}


def checker(analyzer: Callable) -> Checker:
    return CycleChecker(analyzer)
