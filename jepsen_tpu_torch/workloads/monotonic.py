"""Monotonic workload: a counter that must never appear to go backwards.

Counterpart of the monotonic workloads in the cockroachdb and tidb
suites (cockroachdb/src/jepsen/cockroach/monotonic.clj,
tidb/src/tidb/monotonic.clj): clients increment a counter and read it;
reads paired with their real-time order must observe non-decreasing
values, and an `inc` must return a value strictly greater than any value
whose operation completed before the increment began.

The port's copy of `jepsen_tpu/workloads/monotonic.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

from .. import generator as gen
from ..checker import Checker


def r(test=None, ctx=None):
    return {"type": "invoke", "f": "read", "value": None}


def inc(test=None, ctx=None):
    return {"type": "invoke", "f": "inc", "value": None}


def generator():
    return gen.mix([r, inc])


class MonotonicChecker(Checker):
    """Replays completions in real-time order; any ok op whose observed
    value is smaller than a value already acknowledged before its invoke
    is a regression."""

    def check(self, test, history, opts):
        # prefix_max[j] = max value among the first j completions, in
        # completion order; floor for an op = prefix max over completions
        # whose index precedes the op's invoke (O(n log n) via bisect).
        import bisect
        comp_idx: list[int] = []
        prefix_max: list = []
        invoke_idx: dict = {}
        errors = []
        for i, op in enumerate(history):
            if op.get("type") == "invoke":
                invoke_idx[op.get("process")] = i
                continue
            if op.get("type") != "ok" or op.get("value") is None:
                continue
            inv = invoke_idx.get(op.get("process"), 0)
            j = bisect.bisect_left(comp_idx, inv)
            floor = prefix_max[j - 1] if j > 0 else None
            v = op["value"]
            if floor is not None:
                # An inc that began after `floor` was acknowledged must
                # return strictly more; a read may equal it.
                bad = v <= floor if op.get("f") == "inc" else v < floor
                if bad:
                    errors.append({"op": op, "expected-min": floor})
            comp_idx.append(i)
            prefix_max.append(v if not prefix_max
                              else max(prefix_max[-1], v))
        return {"valid?": not errors, "errors": errors[:16],
                "error-count": len(errors)}


def checker() -> Checker:
    return MonotonicChecker()


def workload(**opts) -> dict:
    return {"generator": generator(), "checker": checker()}
