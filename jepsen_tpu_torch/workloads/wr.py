"""rw-register workload: write/read txns over a pool of registers.

Mirrors jepsen.tests.cycle.wr (jepsen/src/jepsen/tests/cycle/wr.clj:9-14,
generator backed by elle.rw-register/gen): each op is a transaction of
[f k v] micro-ops, f in {"r","w"}; writes carry unique values (per-key
monotone counters), so the checker can recover writer identity exactly.

The port's copy of `jepsen_tpu/workloads/wr.py`; it imports the standard
library and the port's own modules only.
"""

from __future__ import annotations

import random

from .. import generator as gen
from ..checker.elle.wr import rw_register_checker


class WrGen:
    """Stateful value factory for rw-register txns; wrapped in a fn
    generator via gen.clients (same pattern as append.AppendGen:
    speculative calls may skip write values, never repeat them)."""

    def __init__(self, key_count: int = 5, min_txn_length: int = 1,
                 max_txn_length: int = 4, max_writes_per_key: int = 256,
                 seed: int | None = None):
        self.key_count = key_count
        self.min_len = min_txn_length
        self.max_len = max_txn_length
        self.max_writes = max_writes_per_key
        self.rng = random.Random(seed)
        self.counters: dict = {}
        self.active: list = list(range(key_count))
        self.next_key = key_count

    def _key(self):
        return self.rng.choice(self.active)

    def __call__(self, test=None, ctx=None):
        txn = []
        for _ in range(self.rng.randint(self.min_len, self.max_len)):
            k = self._key()
            if self.rng.random() < 0.5:
                txn.append(["r", k, None])
            else:
                nxt = self.counters.get(k, 0) + 1
                if nxt > self.max_writes:
                    # retire the key, open a fresh one
                    self.active[self.active.index(k)] = self.next_key
                    k = self.next_key
                    self.next_key += 1
                    nxt = 1
                self.counters[k] = nxt
                txn.append(["w", k, nxt])
        return {"type": "invoke", "f": "txn", "value": txn}


def generator(**opts):
    return gen.clients(WrGen(**opts))


def checker(anomalies=("G2", "G1a", "G1b", "internal"), backend="auto",
            **kw):
    """The rw-register checker; `kw` reaches `WrChecker`, among it the
    port's `device` (default cuda) and `square`."""
    return rw_register_checker(anomalies, backend, **kw)


def test(**opts) -> dict:
    gen_opts = {k: opts.pop(k) for k in
                ("key_count", "min_txn_length", "max_txn_length",
                 "max_writes_per_key", "seed") if k in opts}
    return {"name": "rw-register",
            "generator": generator(**gen_opts),
            "checker": checker(**opts)}
