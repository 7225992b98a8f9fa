"""Causal-reverse workload: a strict-serializability anomaly where T1 < T2
in real time, but T2 is visible to a read without T1.

Counterpart of jepsen.tests.causal-reverse
(jepsen/src/jepsen/tests/causal_reverse.clj): blind single-value writes
run concurrently with whole-set reads. Replaying the history builds a
first-order write precedence graph — every write invocation records the
set of writes already acknowledged before it began (graph,
causal_reverse.clj:22-50). A read that contains w_i but misses some
acknowledged predecessor w_j < w_i is an error (errors,
causal_reverse.clj:52-75).

The port's copy of `jepsen_tpu/workloads/causal_reverse.py`; it imports
the standard library and the port's own modules only.
"""

from __future__ import annotations

from typing import Iterable

from .. import generator as gen, independent
from ..checker import Checker, compose


def precedence_graph(history: Iterable[dict]) -> dict:
    """{written-value: frozenset of values acknowledged before its invoke}
    (graph, causal_reverse.clj:22-50)."""
    completed: set = set()
    expected: dict = {}
    for op in history:
        if op.get("f") != "write":
            continue
        if op.get("type") == "invoke":
            expected[op.get("value")] = frozenset(completed)
        elif op.get("type") == "ok":
            completed.add(op.get("value"))
    return expected


def errors(history: Iterable[dict], expected: dict) -> list:
    """Reads whose visible writes imply missing predecessors
    (errors, causal_reverse.clj:52-75)."""
    errs = []
    for op in history:
        if op.get("type") != "ok" or op.get("f") != "read":
            continue
        seen = set(op.get("value") or ())
        our_expected: set = set()
        for v in seen:
            our_expected |= expected.get(v, frozenset())
        missing = our_expected - seen
        if missing:
            errs.append({**{k: v for k, v in op.items() if k != "value"},
                         "missing": sorted(missing, key=repr),
                         "expected-count": len(our_expected)})
    return errs


class CausalReverseChecker(Checker):
    def check(self, test, history, opts):
        expected = precedence_graph(history)
        errs = errors(history, expected)
        return {"valid?": not errs, "errors": errs}


def checker() -> Checker:
    return CausalReverseChecker()


def workload(nodes: list | None = None, per_key_limit: int = 500) -> dict:
    """Generator + checker package (workload, causal_reverse.clj:87-128):
    per key, a mix of whole-set reads and fresh-value writes, n workers
    per key."""
    n = len(nodes or ["n1", "n2", "n3", "n4", "n5"])

    def writes():
        i = 0
        while True:
            yield {"f": "write", "value": i}
            i += 1

    def key_gen(k):
        w = writes()
        return gen.limit(per_key_limit, gen.stagger(
            1 / 100, gen.mix([gen.repeat_gen({"f": "read"}),
                              lambda: next(w)])))

    from ..checker import perf_checker
    return {
        "checker": compose({
            "perf": perf_checker(),
            "sequential": independent.checker(checker()),
        }),
        "generator": independent.concurrent_generator(
            n, range(10_000), key_gen),
    }
