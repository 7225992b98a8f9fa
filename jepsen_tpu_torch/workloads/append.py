"""List-append workload: Elle's bread and butter.

Counterpart of jepsen.tests.cycle.append
(jepsen/src/jepsen/tests/cycle/append.clj) + elle.list-append's generator:
transactions of [f k v] micro-ops over named lists, checked for
transactional anomalies by checker.elle.

Generator options (append.clj:41-55):
    key_count            distinct keys active at a time
    min_txn_length       min micro-ops per txn
    max_txn_length       max micro-ops per txn
    max_writes_per_key   appends before a key retires

The port's copy of `jepsen_tpu/workloads/append.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import random

from .. import generator as gen
from ..checker import elle


class AppendGen:
    """Stateful value factory (wrapped in a fn generator, so state
    mutation happens only when ops are actually consumed is NOT
    guaranteed — but key rotation/value uniqueness tolerate speculative
    calls: values may skip, never repeat)."""

    def __init__(self, key_count=3, min_txn_length=1, max_txn_length=2,
                 max_writes_per_key=32):
        self.key_count = key_count
        self.min_txn_length = min_txn_length
        self.max_txn_length = max_txn_length
        self.max_writes_per_key = max_writes_per_key
        self.next_key = key_count
        self.active = list(range(key_count))
        self.writes = {k: 0 for k in self.active}
        self.next_val = 0

    def txn(self) -> list:
        mops = []
        n = random.randint(self.min_txn_length, self.max_txn_length)
        for _ in range(n):
            k = random.choice(self.active)
            if random.random() < 0.5:
                self.writes[k] = self.writes.get(k, 0) + 1
                if self.writes[k] > self.max_writes_per_key:
                    self.active.remove(k)
                    k = self.next_key
                    self.next_key += 1
                    self.active.append(k)
                    self.writes[k] = 1
                self.next_val += 1
                mops.append(["append", k, self.next_val])
            else:
                mops.append(["r", k, None])
        return mops

    def __call__(self, test=None, ctx=None):
        return {"type": "invoke", "f": "txn", "value": self.txn()}


def generator(**opts):
    return gen.clients(AppendGen(**opts))


def checker(anomalies=("G1", "G2"), backend="auto", **kw):
    """The Elle list-append checker; `kw` reaches `AppendChecker`,
    among it the port's `device` (default cuda), `square` and
    `bucket_log`."""
    return elle.append_checker(anomalies=anomalies, backend=backend, **kw)


def test(**opts) -> dict:
    """Partial test map (append.clj:31-57). The checker's options,
    the port's `device` and `bucket_log` among them, go to `checker`;
    the rest to the generator."""
    checker_opts = {k: opts.pop(k) for k in
                    ("anomalies", "backend", "realtime", "process_order",
                     "device", "bucket_log")
                    if k in opts}
    return {"generator": generator(**opts),
            "checker": checker(**checker_opts)}
