"""Dirty-reads workload: failed writers must stay invisible.

Counterpart of galera/src/jepsen/galera/dirty_reads.clj:1-120 and the
byte-identical percona twin (percona/src/jepsen/percona/dirty_reads.clj)
— both reference suites exist essentially FOR this check. Writers
compete to set every row of a table to a unique per-transaction value;
readers concurrently scan the whole table. Any read that observes a
value written by a *failed* transaction is a dirty read (ANSI P1 /
Adya G1a); a read whose rows disagree with each other additionally
witnesses a non-atomic write (fractured read).

The generator mirrors the reference's `(gen/mix [reads writes])` with
writes drawing unique values from an infinite counter
(dirty_reads.clj:96-103); the checker mirrors its failed-writes /
inconsistent-reads / filthy-reads classification
(dirty_reads.clj:75-94).

The port's copy of `jepsen_tpu/workloads/dirty_reads.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools

from .. import generator as gen
from ..checker import Checker


def generator():
    counter = itertools.count()

    def write(test=None, ctx=None):
        return {"type": "invoke", "f": "write", "value": next(counter)}

    def read(test=None, ctx=None):
        return {"type": "invoke", "f": "read", "value": None}

    return gen.clients(gen.mix([read, write]))


class DirtyReadsChecker(Checker):
    """Flags ok reads containing any failed write's value
    (dirty_reads.clj:75-94). `info` writes are indeterminate — they may
    have committed — so only definite `fail` values count as dirty."""

    def check(self, test, history, opts):
        failed_writes = {op.get("value") for op in history
                         if op.get("type") == "fail"
                         and op.get("f") == "write"}
        reads = [op for op in history
                 if op.get("type") == "ok" and op.get("f") == "read"
                 and isinstance(op.get("value"), (list, tuple))]
        inconsistent = [op for op in reads
                        if len(set(op["value"])) > 1]
        dirty = [op for op in reads
                 if failed_writes.intersection(op["value"])]
        return {"valid?": not dirty,
                "failed-write-count": len(failed_writes),
                "read-count": len(reads),
                "inconsistent-reads": inconsistent[:16],
                "inconsistent-count": len(inconsistent),
                "dirty-reads": dirty[:16],
                "dirty-count": len(dirty)}


def checker() -> Checker:
    return DirtyReadsChecker()


def workload(**opts) -> dict:
    # compose {:perf :dirty-reads} like the reference's test-
    # (dirty_reads.clj:113-117)
    from ..checker import compose, perf_checker
    return {"generator": generator(),
            "checker": compose({"dirty-reads": checker(),
                                "perf": perf_checker()})}
