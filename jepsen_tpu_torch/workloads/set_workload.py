"""Set workload: add unique integers, read them all back at the end.

Pairs with checker.set_checker / checker.set_full (reference checkers
jepsen/src/jepsen/checker.clj:243-302,464-595). The generator adds
increasing integers from client threads, then a final read phase.

The port's copy of `jepsen_tpu/workloads/set_workload.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools

from .. import checker as jchecker
from .. import generator as gen


def generator(n: int | None = None):
    counter = itertools.count()

    def add(test=None, ctx=None):
        return {"type": "invoke", "f": "add", "value": next(counter)}

    adds = gen.clients(add if n is None else gen.limit(n, gen.repeat_gen(add)))
    final_read = gen.clients(gen.until_ok(gen.repeat_gen({"f": "read"})))
    return gen.phases(adds, final_read)


def test(n: int = 100, full: bool = False, **kw) -> dict:
    return {"generator": generator(n),
            "checker": jchecker.set_full(**kw) if full
            else jchecker.set_checker()}
