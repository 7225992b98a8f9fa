"""Comments workload: strict-serializability write-visibility order.

Counterpart of cockroachdb/src/jepsen/cockroach/comments.clj:1-160 —
the signature check for the anomaly where T1 completes before T2
begins, yet a reader sees T2's insert without T1's (serializable but
not strictly serializable; the "comments appear out of order" story).
Writers blind-insert unique ids for a key across several tables (so
rows land in different shard ranges); readers scan all tables in one
transaction. Replaying the history, every write that COMPLETED before
a visible write was INVOKED must also be visible.

The port's copy of `jepsen_tpu/workloads/comments.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools

from . import causal_reverse
from .. import generator as gen
from .. import independent
from ..checker import Checker

#: tables the ids are sharded over (comments.clj:30-40's table-count)
TABLE_COUNT = 10


class CommentsChecker(Checker):
    """comments.clj:88-141: expected[w] = writes completed before w's
    invocation; an ok read seeing w but missing some of expected[w]
    is a strict-serializability violation. Same precedence algebra as
    causal-reverse (causal_reverse.clj shares it too), so the graph
    and error scan come from that module; only the truncated error
    rendering is comments-specific."""

    def check(self, test, history, opts):
        expected = causal_reverse.precedence_graph(history)
        errors = causal_reverse.errors(history, expected)
        for e in errors:
            # comments ids are ints; the shared helper repr-sorts to
            # tolerate mixed types, which misorders e.g. [10, 2]
            e["missing"] = sorted(e["missing"])
        return {"valid?": not errors, "errors": errors[:16],
                "error-count": len(errors)}


def checker() -> Checker:
    return CommentsChecker()


def workload(opts: dict | None = None) -> dict:
    """comments.clj:144-160: independent per-key concurrent generator,
    blind writes drawing globally-unique ids (the id picks the table)
    mixed with full-scan reads."""
    opts = opts or {}
    nodes = opts.get("nodes") or ["n1", "n2", "n3", "n4", "n5"]
    counter = itertools.count()

    def w(test=None, ctx=None):
        return {"type": "invoke", "f": "write", "value": next(counter)}

    def r(test=None, ctx=None):
        return {"type": "invoke", "f": "read", "value": None}

    from ..checker import compose
    return {
        "generator": independent.concurrent_generator(
            len(nodes), range(10_000),
            lambda k: gen.stagger(
                0.01, gen.limit(200, gen.mix([r, w])))),
        "checker": independent.checker(compose({
            "comments": CommentsChecker()})),
    }
