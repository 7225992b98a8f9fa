"""Linearizable register workload.

Counterpart of jepsen.tests.linearizable-register
(jepsen/src/jepsen/tests/linearizable_register.clj:23-60): independent
CAS registers per key, a read/write/cas op mix, and a per-key
linearizability check against the CAS-register model.

With the device path (backend "tpu", and "auto") the per-key
subhistories batch into one dispatch of the dense configuration-grid
kernel (`checker.knossos.dense`) instead of a thread-pool of searches.

The port's copy of `jepsen_tpu/workloads/register.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import random

from .. import generator as gen
from .. import independent
from ..checker import linearizable, models


def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read", "value": None}


def w(test=None, ctx=None):
    return {"type": "invoke", "f": "write", "value": random.randint(0, 4)}


def cas(test=None, ctx=None):
    return {"type": "invoke", "f": "cas",
            "value": [random.randint(0, 4), random.randint(0, 4)]}


def rand_op(test=None, ctx=None):
    return random.choice((r, w, cas))(test, ctx)


def generator(threads_per_key: int = 2, key_count: int = 10,
              ops_per_key: int = 100, ops=None):
    """Concurrent per-key generators over a rotating key space
    (linearizable_register.clj:34-50). `ops` restricts the op mix
    (e.g. ``[r, w]`` for stores without CAS)."""
    op_gen = rand_op if ops is None else gen.mix(list(ops))
    return independent.concurrent_generator(
        threads_per_key, range(key_count),
        lambda k: gen.limit(ops_per_key, op_gen))


def checker(backend: str = "auto", algorithm: str = "competition",
            model=None, **kw):
    """Per-key linearizability; `kw` reaches `Linearizable`, among it
    the port's `device` (default cuda) and `dense_scan`."""
    return independent.checker(
        linearizable(model if model is not None else models.cas_register(),
                     algorithm=algorithm, backend=backend, **kw))


def test(threads_per_key: int = 2, key_count: int = 10,
         ops_per_key: int = 100, backend: str = "auto", **kw) -> dict:
    return {"generator": gen.clients(
                generator(threads_per_key, key_count, ops_per_key)),
            "checker": checker(backend=backend, **kw)}
