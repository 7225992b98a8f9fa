"""Queue workload: enqueue unique values, dequeue concurrently, drain
at the end; nothing may be lost (acknowledged enqueues) or invented.

Counterpart of the queue workloads in the rabbitmq/disque suites
(rabbitmq/src/jepsen/rabbitmq.clj, disque/src/jepsen/disque.clj) over
the total-queue checker (checker.clj:631-690). Ops:

    {"f": "enqueue", "value": v}
    {"f": "dequeue"}            -> ok value = v | fail "empty"
    {"f": "drain"}              -> ok value = [v, ...]

The port's copy of `jepsen_tpu/workloads/queue.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools

from .. import checker as jchecker
from .. import generator as gen


def generator(n: int | None = None):
    """The enqueue/dequeue mix ONLY — suites must run final_generator()
    AFTER their time limit, or an expiring clock cuts the drain and
    every in-flight element reads as lost (the reference puts the
    drain outside gen/time-limit for exactly this reason,
    disque.clj:275-296)."""
    counter = itertools.count()

    def enqueue(test=None, ctx=None):
        return {"type": "invoke", "f": "enqueue", "value": next(counter)}

    def dequeue(test=None, ctx=None):
        return {"type": "invoke", "f": "dequeue", "value": None}

    body = gen.mix([enqueue, dequeue])
    if n is not None:
        body = gen.limit(n, body)
    return gen.clients(body)


def final_generator():
    """Post-time-limit drain phase: every client drains until ok."""
    return gen.clients(gen.until_ok(gen.repeat_gen({"f": "drain"})))


def test(n: int | None = 500, **kw) -> dict:
    return {"generator": generator(n),
            "final_generator": final_generator(),
            "checker": jchecker.total_queue(),
            **kw}
