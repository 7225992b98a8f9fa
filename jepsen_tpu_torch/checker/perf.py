"""The store-path and time helpers of `jepsen_tpu/checker/perf.py` that
the timeline and Elle artifacts use.

The plot checkers of that module (`LatencyGraph`, `RateGraph`, `perf`)
are not ported: they render with matplotlib.
"""

from __future__ import annotations


def nanos_to_secs(t: float | None) -> float:
    return (t or 0) / 1e9


def nanos_to_ms(t: float | None) -> float:
    return (t or 0) / 1e6


def store_path(test: dict, opts: dict, filename: str):
    """`filename` in the test's run dir, under `opts["subdirectory"]`
    (a name or a list of them: `independent.checker` nests each key's
    artifacts there), or None when the test has no store."""
    store = test.get("store")
    if store is None:
        return None
    sub = (opts or {}).get("subdirectory")
    parts = [sub] if isinstance(sub, str) else list(sub or [])
    return store.path(test, *[str(p) for p in parts], filename)
