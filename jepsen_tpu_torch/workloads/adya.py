"""Adya G2 workload: predicate-based anti-dependency cycles.

Counterpart of jepsen.tests.adya (jepsen/src/jepsen/tests/adya.clj): per
key, two transactions each read both tables by predicate and, seeing
nothing, insert into different tables — under serializability at most one
can commit. Values are ``[a_id, b_id]`` pairs where exactly one side is
set, lifted over independent keys (g2-gen adya.clj:12-59); the checker
counts successful inserts per key (g2-checker adya.clj:61-88).

The port's copy of `jepsen_tpu/workloads/adya.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools

from .. import generator as gen, independent
from ..checker import Checker


def g2_gen() -> gen.Generator:
    """Pairs of :insert ops per key: one with a-id, one with b-id, ids
    globally unique (g2-gen adya.clj:12-59)."""
    ids = itertools.count(1)

    def key_gen(k):
        return [
            gen.once(lambda: {"type": "invoke", "f": "insert",
                              "value": [None, next(ids)]}),
            gen.once(lambda: {"type": "invoke", "f": "insert",
                              "value": [next(ids), None]}),
        ]

    return independent.concurrent_generator(2, range(10_000), key_gen)


class G2Checker(Checker):
    """At most one successful insert per key (g2-checker adya.clj:61-88).

    Expects ops whose value is lifted [key, [a_id, b_id]]."""

    def check(self, test, history, opts):
        keys: dict = {}
        for op in history:
            if op.get("f") != "insert":
                continue
            v = op.get("value")
            if independent.is_tuple(v):
                k = v.key
            elif isinstance(v, (list, tuple)) and len(v) == 2:
                k = v[0]
            else:
                continue
            if op.get("type") == "ok":
                keys[k] = keys.get(k, 0) + 1
            else:
                keys.setdefault(k, 0)
        insert_count = sum(1 for c in keys.values() if c > 0)
        illegal = {k: c for k, c in sorted(keys.items(), key=lambda kv:
                                           repr(kv[0])) if c > 1}
        return {"valid?": not illegal,
                "key-count": len(keys),
                "legal-count": insert_count - len(illegal),
                "illegal-count": len(illegal),
                "illegal": illegal}


def g2_checker() -> Checker:
    return G2Checker()


def workload() -> dict:
    return {"checker": g2_checker(), "generator": g2_gen()}
