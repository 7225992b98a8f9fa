"""Small shared utilities: the port's copy of `jepsen_tpu/util.py`.

`real_pmap` (one thread an element; `checker.Compose` runs its
sub-checkers through it, `control.on_nodes` its nodes), `bounded_pmap`
(a bounded pool; `independent.checker` fans per-key checks out through
it), `majority`/`minority` (the nemesis's grudges), the relative-time
plumbing the test runner stamps ops with (util.clj:290-330), the retry
and timeout helpers (util.clj:359), `longest_common_prefix`,
`pad_to_multiple`, `lazy_atom` and `named_locks` (util.clj:703-808),
`chunk_vec`, `name_of`, the interval-set rendering of the set checker,
the latency pairing and nemesis intervals under the plot checkers
(reference util.clj:548, 619-700), and `iso_to_epoch` (faunadb's
timestamp order, chronos's run times). Standard library only: the
ingest pool's workers import the checker package.
"""

from __future__ import annotations

import os
import re as _re
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def majority(n: int) -> int:
    """Smallest majority of n nodes: majority(5) == 3; majority(0) == 1."""
    return n // 2 + 1


def minority(n: int) -> int:
    """Largest strict minority: minority(5) == 2."""
    return max((n - 1) // 2, 0) if n > 0 else 0


def real_pmap(f: Callable[[T], R], coll: Sequence[T]) -> list[R]:
    """Map f over coll with one thread per element, preserving order.
    The first exception raised by any element propagates to the caller
    (all threads are still joined first)."""
    coll = list(coll)
    if not coll:
        return []
    if len(coll) == 1:
        return [f(coll[0])]
    with ThreadPoolExecutor(max_workers=len(coll)) as ex:
        return list(ex.map(f, coll))


def bounded_pmap(f: Callable[[T], R], coll: Sequence[T],
                 max_workers: int | None = None) -> list[R]:
    """Parallel map with a bounded pool (one worker a core unless
    `max_workers`), preserving order; the first exception propagates
    (reference independent.clj:472-492)."""
    coll = list(coll)
    if not coll:
        return []
    workers = min(len(coll), max_workers or (os.cpu_count() or 4))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(f, coll))


# ---------------------------------------------------------------------------
# Relative time: histories are timestamped in nanoseconds from test start.
# ---------------------------------------------------------------------------

_relative_origin = threading.local()


def linear_time_nanos() -> int:
    return _time.monotonic_ns()


class relative_time:
    """Context manager establishing t=0 for the current test run."""

    def __enter__(self):
        _relative_origin.t0 = _time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        _relative_origin.t0 = None
        return False


def relative_time_nanos() -> int:
    t0 = getattr(_relative_origin, "t0", None)
    if t0 is None:
        raise RuntimeError("relative_time_nanos called outside relative_time")
    return _time.monotonic_ns() - t0


def sleep_nanos(dt: int) -> None:
    if dt > 0:
        _time.sleep(dt / 1e9)


_ISO_FRAC = _re.compile(r"[.,](\d+)(?=$|[Z+\-])")


def iso_to_epoch(s: str) -> float:
    """ISO-8601 string -> epoch seconds, preserving FULL fractional
    precision. datetime.fromisoformat silently truncates fractions
    beyond 6 digits (`date -Ins` and Fauna @ts strings carry 9), which
    collapses nanosecond-distinct timestamps onto one microsecond —
    so the fraction is split off and re-added exactly. Comma fractions
    (valid ISO, emitted by `date` in some locales) are handled; naive
    strings are interpreted as LOCAL time, matching the naive producer
    (core.py's start-time)."""
    from datetime import datetime
    frac = 0.0
    m = _ISO_FRAC.search(s)
    if m:
        digits = m.group(1)
        frac = int(digits) / 10 ** len(digits)
        s = s[:m.start()] + s[m.end():]
    s = s.replace("Z", "+00:00")
    return datetime.fromisoformat(s).timestamp() + frac


class RetryFailed(Exception):
    pass


def with_retry(f: Callable[[], R], retries: int = 3, backoff: float = 0.0,
               exceptions: tuple = (Exception,), *,
               exponential: bool = False, fatal: tuple = ()) -> R:
    """Call f, retrying up to `retries` times on the given exceptions.

    With exponential=True each retry sleeps a jittered exponential
    backoff — ``backoff * 2**attempt * uniform(0.5, 1.5)`` (attempt
    counting from 0) — so a herd of workers retrying the same
    transient failure decorrelates instead of stampeding in lockstep.
    `fatal` exceptions never retry (e.g. a FileNotFoundError under an
    OSError retry: the thing is gone, not busy)."""
    import random
    attempt = 0
    while True:
        try:
            return f()
        except fatal:
            raise
        except exceptions:
            attempt += 1
            if attempt > retries:
                raise
            if backoff:
                delay = backoff
                if exponential:
                    delay = (backoff * 2 ** (attempt - 1)
                             * random.uniform(0.5, 1.5))
                _time.sleep(delay)


def timeout_call(seconds: float, f: Callable[[], R], default: Any = None) -> Any:
    """Run f in a worker thread; return `default` if it takes longer than
    `seconds`; exceptions from f propagate to the caller. (On timeout the
    thread is abandoned, mirroring the reference's util/timeout which
    interrupts; Python threads can't be killed, so callers should make f
    cooperative where it matters. The worker is DAEMONIC — an abandoned
    thread must never hold interpreter exit hostage — and named so a
    faulthandler dump attributes it.)"""
    result: list = []
    error: list = []

    def run():
        try:
            result.append(f())
        except BaseException as e:  # noqa: BLE001 - relayed to caller
            error.append(e)

    t = threading.Thread(target=run, daemon=True, name="timeout-call")
    t.start()
    t.join(seconds)
    if error:
        raise error[0]
    if t.is_alive():
        return default
    return result[0] if result else default


def integer_interval_set_str(xs: Iterable[int]) -> str:
    """Render a set of ints as compact intervals: '#{1..3 5 7..9}'
    (reference util.clj:548 — used in set results)."""
    xs = sorted(set(xs))
    if not xs:
        return "#{}"
    parts = []
    lo = hi = xs[0]
    for x in xs[1:]:
        if x == hi + 1:
            hi = x
        else:
            parts.append(f"{lo}" if lo == hi else f"{lo}..{hi}")
            lo = hi = x
    parts.append(f"{lo}" if lo == hi else f"{lo}..{hi}")
    return "#{" + " ".join(parts) + "}"


def longest_common_prefix(seqs: Sequence[Sequence]) -> list:
    """Longest common prefix of several sequences (reference util.clj:703;
    used by set-full's duplicate detection and version-order inference)."""
    if not seqs:
        return []
    shortest = min(seqs, key=len)
    for i, v in enumerate(shortest):
        for s in seqs:
            if s[i] != v:
                return list(shortest[:i])
    return list(shortest)


def pad_to_multiple(xs: Sequence[T], k: int) -> list[T]:
    """xs extended to a multiple of k by replicating its last element —
    the dp-sharding pad for ragged device batches (callers drop the
    replica results past len(xs))."""
    xs = list(xs)
    if k > 1 and xs and len(xs) % k:
        xs += [xs[-1]] * (-len(xs) % k)
    return xs


class LazyAtom:
    """A thread-safe mutable ref whose initial value is computed by
    `f()` on first use; reset bypasses initialization
    (util.clj:730-777). swap applies a function under the lock."""

    _FRESH = object()

    def __init__(self, f):
        self._f = f
        self._lock = threading.Lock()
        self._value = LazyAtom._FRESH

    def _init(self):
        if self._value is LazyAtom._FRESH:
            with self._lock:
                if self._value is LazyAtom._FRESH:
                    self._value = self._f()
        return self._value

    def deref(self):
        return self._init()

    def swap(self, f, *args):
        self._init()
        with self._lock:
            self._value = f(self._value, *args)
            return self._value

    def reset(self, v):
        with self._lock:
            self._value = v
            return v


def lazy_atom(f) -> LazyAtom:
    return LazyAtom(f)


def named_locks():
    """A dynamic pool of named locks (util.clj:779-808): call the
    returned function with any hashable name to get the canonical Lock
    for it — e.g. to serialize concurrent daemon restarts per node.
    Use as `with locks(node): ...`."""
    pool: dict = {}
    guard = threading.Lock()

    def lock_for(name):
        with guard:
            if name not in pool:
                pool[name] = threading.Lock()
            return pool[name]

    return lock_for


def chunk_vec(n: int, xs: Sequence[T]) -> list[list[T]]:
    """Split xs into chunks of at most n elements."""
    return [list(xs[i : i + n]) for i in range(0, len(xs), n)]


def name_of(x: Any) -> str:
    """Human-readable name for fs/processes in results."""
    return x if isinstance(x, str) else str(x)


def history_latencies(history: Sequence[dict]) -> list[dict]:
    """Return the history with every invocation annotated with

        "latency"     nanoseconds until its completion
        "completion"  the completing op itself (also latency-annotated)

    Invocations that never complete get neither key (reference
    util.clj:619-653)."""
    out: list[dict] = []
    invokes: dict = {}  # process -> index into out
    for op in history:
        if op.get("type") == "invoke":
            out.append(op)
            invokes[op.get("process")] = len(out) - 1
        elif op.get("process") in invokes:
            i = invokes.pop(op.get("process"))
            inv = out[i]
            lat = (op.get("time") or 0) - (inv.get("time") or 0)
            op = {**op, "latency": lat}
            out[i] = {**inv, "latency": lat, "completion": op}
            out.append(op)
        else:
            out.append(op)
    return out


# Nemesis f-names that begin/end a fault window, covering the combined
# nemesis packages' start-x/stop-x convention (nemesis/combined.clj) as
# well as the plain start/stop of nemesis.clj.
DEFAULT_NEMESIS_START_FS = frozenset(
    {"start", "start-partition", "start-kill", "start-pause",
     "kill", "pause"})
DEFAULT_NEMESIS_STOP_FS = frozenset(
    {"stop", "stop-partition", "stop-kill", "stop-pause",
     "resume", "heal", "start!", "stop!"})


def nemesis_intervals(history: Sequence[dict],
                      opts: dict | None = None
                      ) -> list[tuple[dict, dict | None]]:
    """Pair nemesis start/stop transitions into [start, stop] intervals.

    In runner histories nemesis ops come in invoke/complete pairs with
    the same :f, so ``s1 s2 e1 e2`` pairs the first with the third and
    the second with the fourth (reference util.clj:655-700); a
    transition recorded as a single op forms its own event. Every open
    start is closed by the next stop; unclosed starts yield (start,
    None). opts may carry "start"/"stop" f-name sets (defaults cover
    the combined-nemesis start-x/stop-x names)."""
    opts = opts or {}
    start_fs = set(opts.get("start") or DEFAULT_NEMESIS_START_FS)
    stop_fs = set(opts.get("stop") or DEFAULT_NEMESIS_STOP_FS)
    nem = [o for o in history if o.get("process") == "nemesis"]
    events: list[tuple[dict, dict]] = []
    i = 0
    while i < len(nem):
        a = nem[i]
        if i + 1 < len(nem) and nem[i + 1].get("f") == a.get("f"):
            events.append((a, nem[i + 1]))
            i += 2
        else:
            events.append((a, a))
            i += 1
    intervals: list[tuple[dict, dict | None]] = []
    starts: list[tuple[dict, dict]] = []
    for a, b in events:
        f = a.get("f")
        if f in start_fs:
            starts.append((a, b))
        elif f in stop_fs:
            for s1, s2 in starts:
                intervals.append((s1, a))
                if s1 is not s2 or a is not b:
                    intervals.append((s2, b))
            starts = []
    for s1, s2 in starts:
        intervals.append((s1, None))
        if s1 is not s2:
            intervals.append((s2, None))
    return intervals
