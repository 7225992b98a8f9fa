"""Checkers of the PyTorch port: the single-run checker stack.

The port's copy of `jepsen_tpu/checker/__init__.py`. The `Checker`
interface mirrors the Clojure reference's protocol
(jepsen/src/jepsen/checker.clj:49-69): `check(test, history, opts) ->
{"valid?": True | False | "unknown", ...}`. `compose` runs a map of
named checkers in parallel and merges validity with invalid < unknown <
valid precedence (checker.clj:20-47,90-102). The simple checkers
(`stats`, `unhandled_exceptions`, the set, queue, unique-id and counter
checkers) are host code, the reference's line for line;
`Linearizable` routes a fresh CAS register through the tiered device
path (`checker.knossos`), on `device`. Elle lives in `checker.elle`,
per-key checking in `independent`.

One departure from the reference: `check_safe` (and so `compose`)
re-raises what `supervisor.must_end_sweep` names — a kernel that cannot
be built or launched, a missing device, a CUDA error — instead of
writing it as an unknown verdict. The plot checkers (`latency_graph`,
`rate_graph`, `perf_checker`, `clock_plot`) and `timeline_checker` live
in submodules, as in the reference. The plots import matplotlib when
they draw: without it their entries are `{"valid?": "unknown"}`, as
the reference's are.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import Counter
from typing import Any, Callable

from .. import history as h
from ..util import integer_interval_set_str, real_pmap
from . import models as model

VALID_PRIORITIES = {True: 2, "unknown": 1, False: 0}


def merge_valid(valids: list) -> Any:
    """Merge validity values: false wins over unknown wins over true."""
    out: Any = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid? value")
        if VALID_PRIORITIES[v] < VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    def check(self, test: dict, history: list, opts: dict) -> dict | None:
        raise NotImplementedError


class FnChecker(Checker):
    """Wrap a function (test, history, opts) -> result as a Checker."""

    def __init__(self, f: Callable[[dict, list, dict], dict | None]):
        self.f = f

    def check(self, test, history, opts):
        return self.f(test, history, opts)


def check_safe(checker: Checker, test: dict, history: list,
               opts: dict | None = None) -> dict:
    """Like check, but returns exceptions as {"valid?": "unknown"}
    results (checker.clj:77-88) — except the failures no verdict may
    hide (`supervisor.must_end_sweep`: a kernel build or launch
    failure, a missing device, a CUDA error, an interrupt), which
    raise. Every check runs inside a trace span named after the checker
    class."""
    from .. import trace
    try:
        with trace.span(f"check:{type(checker).__name__}",
                        ops=len(history)):
            r = checker.check(test, history, opts or {})
        return r if r is not None else {"valid?": True}
    except Exception as e:
        from ..supervisor import must_end_sweep
        if must_end_sweep(e):
            raise
        return {"valid?": "unknown", "error": traceback.format_exc()}


class Noop(Checker):
    def check(self, test, history, opts):
        return None


def noop() -> Checker:
    return Noop()


class UnbridledOptimism(Checker):
    """Everything is awesome."""

    def check(self, test, history, opts):
        return {"valid?": True}


def unbridled_optimism() -> Checker:
    return UnbridledOptimism()


class Compose(Checker):
    def __init__(self, checker_map: dict[str, Checker]):
        self.checker_map = checker_map

    def check(self, test, history, opts):
        items = list(self.checker_map.items())
        results = real_pmap(
            lambda kv: (kv[0], check_safe(kv[1], test, history, opts)), items)
        out: dict = dict(results)
        out["valid?"] = merge_valid([r.get("valid?", True) for _, r in results])
        return out


def compose(checker_map: dict[str, Checker]) -> Checker:
    return Compose(checker_map)


class ConcurrencyLimit(Checker):
    """Bound concurrent executions of a memory-hungry checker
    (checker.clj:104-119)."""

    def __init__(self, limit: int, checker: Checker):
        self.sem = threading.Semaphore(limit)
        self.checker = checker

    def check(self, test, history, opts):
        with self.sem:
            return self.checker.check(test, history, opts)


def concurrency_limit(limit: int, checker: Checker) -> Checker:
    return ConcurrencyLimit(limit, checker)


class UnhandledExceptions(Checker):
    """Aggregate crashed (:info) ops carrying errors, by error class,
    in descending frequency (checker.clj:127-154)."""

    def check(self, test, history, opts):
        crashed = [o for o in history
                   if h.is_info(o) and (o.get("exception") or o.get("error"))]
        groups: dict[Any, list] = {}
        for o in crashed:
            exc = o.get("exception")
            cls = (exc.get("class") if isinstance(exc, dict)
                   else type(exc).__name__ if isinstance(exc, BaseException)
                   else str(o.get("error", exc)))
            groups.setdefault(cls, []).append(o)
        exes = sorted(groups.items(), key=lambda kv: len(kv[1]), reverse=True)
        if not exes:
            return {"valid?": True}
        return {"valid?": True,
                "exceptions": [{"class": cls, "count": len(ops),
                                "example": ops[0]} for cls, ops in exes]}


def unhandled_exceptions() -> Checker:
    return UnhandledExceptions()


def _stats_of(ops: list) -> dict:
    ok = sum(1 for o in ops if h.is_ok(o))
    fail = sum(1 for o in ops if h.is_fail(o))
    info = sum(1 for o in ops if h.is_info(o))
    return {"valid?": ok > 0, "count": ok + fail + info,
            "ok-count": ok, "fail-count": fail, "info-count": info}


class Stats(Checker):
    """Success/failure counts, overall and by :f. Valid only when every :f
    saw at least one :ok (checker.clj:169-186)."""

    def check(self, test, history, opts):
        hist = [o for o in history
                if not h.is_invoke(o) and o.get("process") != h.NEMESIS]
        by_f: dict = {}
        for o in hist:
            by_f.setdefault(o.get("f"), []).append(o)
        groups = {f: _stats_of(ops) for f, ops in sorted(
            by_f.items(), key=lambda kv: str(kv[0]))}
        out = _stats_of(hist)
        out["by-f"] = groups
        out["valid?"] = merge_valid([g["valid?"] for g in groups.values()])
        return out


def stats() -> Checker:
    return Stats()


class QueueChecker(Checker):
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded and only ok dequeues happened, then fold through the
    model (checker.clj:221-240). O(n); use an unordered queue model."""

    def __init__(self, m: model.Model):
        self.model = m

    def check(self, test, history, opts):
        state = self.model
        for o in history:
            f = o.get("f")
            take = (h.is_invoke(o) if f == "enqueue"
                    else h.is_ok(o) if f == "dequeue" else False)
            if not take:
                continue
            state = state.step(o)
            if model.is_inconsistent(state):
                return {"valid?": False, "error": state.msg}
        return {"valid?": True, "final-queue": repr(state)}


def queue(m: model.Model | None = None) -> Checker:
    return QueueChecker(m or model.unordered_queue())


class SetChecker(Checker):
    """:add ops followed by a final :read of the whole set
    (checker.clj:243-302): every acknowledged add must be present; nothing
    unexpected may appear."""

    def check(self, test, history, opts):
        attempts = {o.get("value") for o in history
                    if h.is_invoke(o) and o.get("f") == "add"}
        adds = {o.get("value") for o in history
                if h.is_ok(o) and o.get("f") == "add"}
        final_read = None
        for o in history:
            if h.is_ok(o) and o.get("f") == "read":
                final_read = o.get("value")
        if final_read is None:
            return {"valid?": "unknown", "error": "Set was never read"}
        final = {v for v in final_read} if not isinstance(final_read, (set, frozenset)) else set(final_read)
        ok = final & attempts
        unexpected = final - attempts
        lost = adds - final
        recovered = ok - adds
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "recovered-count": len(recovered),
            "unexpected-count": len(unexpected),
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
        }


def set_checker() -> Checker:
    return SetChecker()


class _SetFullElement:
    """Per-element timeline state for set-full (checker.clj:305-341)."""

    __slots__ = ("element", "known", "last_present", "last_absent")

    def __init__(self, element):
        self.element = element
        self.known = None          # completion op that proved existence
        self.last_present = None   # latest read invocation that observed it
        self.last_absent = None    # latest read invocation that missed it

    def add_ok(self, op):
        if self.known is None:
            self.known = op

    def read_present(self, iop, op):
        if self.known is None:
            self.known = op
        if self.last_present is None or \
                self.last_present["index"] < iop["index"]:
            self.last_present = iop

    def read_absent(self, iop, op):
        if self.last_absent is None or \
                self.last_absent["index"] < iop["index"]:
            self.last_absent = iop


def _idx(op, default=-1):
    return op["index"] if op is not None else default


def _set_full_element_results(e: _SetFullElement) -> dict:
    known_time = e.known.get("time") if e.known else None
    stable = bool(e.last_present is not None and
                  _idx(e.last_absent) < _idx(e.last_present))
    # An absent read concurrent with the add could have linearized before it;
    # require the miss to begin after the add was known complete
    # (checker.clj:368-383).
    lost = bool(e.known is not None and e.last_absent is not None and
                _idx(e.last_present) < _idx(e.last_absent) and
                _idx(e.known) < _idx(e.last_absent))
    stable_time = ((e.last_absent["time"] + 1 if e.last_absent else 0)
                   if stable else None)
    lost_time = ((e.last_present["time"] + 1 if e.last_present else 0)
                 if lost else None)
    stable_latency = (max(0, stable_time - known_time) // 1_000_000
                      if stable else None)
    lost_latency = (max(0, lost_time - known_time) // 1_000_000
                    if lost else None)
    return {"element": e.element,
            "outcome": ("stable" if stable else
                        "lost" if lost else "never-read"),
            "stable-latency": stable_latency,
            "lost-latency": lost_latency,
            "known": e.known,
            "last-absent": e.last_absent}


def frequency_distribution(points: list[float], xs: list) -> dict | None:
    xs = sorted(xs)
    if not xs:
        return None
    n = len(xs)
    return {p: xs[min(n - 1, int(n * p))] for p in points}


class SetFull(Checker):
    """Rigorous set analysis: per-element stable/lost/never-read outcomes
    with latency distributions (checker.clj:464-595). With
    linearizable=True, stale reads (nonzero stable latency) are invalid.

    As in the reference package, the duplicate filter reports elements
    appearing more than once in a single read (the Clojure reference's
    multiplicity < 1 test at checker.clj:571 can never fire)."""

    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, history, opts):
        elements: dict[Any, _SetFullElement] = {}
        reads: dict[Any, dict] = {}   # process -> read invocation
        dups: dict[Any, int] = {}     # element -> max multiplicity > 1
        for o in history:
            if not h.is_client_op(o):
                continue
            f, p = o.get("f"), o.get("process")
            if f == "add":
                v = o.get("value")
                if h.is_invoke(o):
                    elements.setdefault(v, _SetFullElement(v))
                elif h.is_ok(o) and v in elements:
                    elements[v].add_ok(o)
            elif f == "read":
                if h.is_invoke(o):
                    reads[p] = o
                elif h.is_fail(o):
                    reads.pop(p, None)
                elif h.is_ok(o):
                    iop = reads.pop(p, o)
                    vals = o.get("value") or []
                    for el, n in Counter(vals).items():
                        if n > 1:
                            dups[el] = max(dups.get(el, 0), n)
                    vset = set(vals)
                    for el, state in elements.items():
                        if el in vset:
                            state.read_present(iop, o)
                        else:
                            state.read_absent(iop, o)
        rs = [_set_full_element_results(e) for _, e in sorted(
            elements.items(), key=lambda kv: repr(kv[0]))]
        outcomes: dict[str, list] = {}
        for r in rs:
            outcomes.setdefault(r["outcome"], []).append(r)
        stable = outcomes.get("stable", [])
        lost = outcomes.get("lost", [])
        never_read = outcomes.get("never-read", [])
        stale = [r for r in stable if r["stable-latency"] > 0]
        stable_lat = [r["stable-latency"] for r in rs
                      if r["stable-latency"] is not None]
        lost_lat = [r["lost-latency"] for r in rs
                    if r["lost-latency"] is not None]
        valid: Any = (False if lost else
                      "unknown" if not stable else
                      False if self.linearizable and stale else
                      True)
        out = {
            "valid?": False if dups else valid,
            "attempt-count": len(rs),
            "stable-count": len(stable),
            "lost-count": len(lost),
            "lost": sorted((r["element"] for r in lost), key=repr),
            "never-read-count": len(never_read),
            "never-read": sorted((r["element"] for r in never_read), key=repr),
            "stale-count": len(stale),
            "stale": sorted((r["element"] for r in stale), key=repr),
            "worst-stale": sorted(stale, key=lambda r: r["stable-latency"],
                                  reverse=True)[:8],
            "duplicated-count": len(dups),
            "duplicated": dict(sorted(dups.items(), key=lambda kv: repr(kv[0]))),
        }
        points = [0, 0.5, 0.95, 0.99, 1]
        fd = frequency_distribution(points, stable_lat)
        if fd:
            out["stable-latencies"] = fd
        fd = frequency_distribution(points, lost_lat)
        if fd:
            out["lost-latencies"] = fd
        return out


def set_full(linearizable: bool = False) -> Checker:
    return SetFull(linearizable)


def expand_queue_drain_ops(history: list) -> list:
    """Expand ok :drain ops (value = list of elements) into dequeue
    invoke/ok pairs (checker.clj:598-628)."""
    out = []
    for o in history:
        if o.get("f") != "drain":
            out.append(o)
        elif h.is_invoke(o) or h.is_fail(o):
            continue
        elif h.is_ok(o):
            for el in o.get("value") or []:
                out.append({**o, "type": "invoke", "f": "dequeue", "value": None})
                out.append({**o, "type": "ok", "f": "dequeue", "value": el})
        else:
            raise ValueError(f"can't handle a crashed drain operation: {o!r}")
    return out


class TotalQueue(Checker):
    """What goes in must come out — multiset accounting over enqueues and
    dequeues, with drains expanded (checker.clj:631-690)."""

    def check(self, test, history, opts):
        hist = expand_queue_drain_ops(history)
        attempts = Counter(o.get("value") for o in hist
                           if h.is_invoke(o) and o.get("f") == "enqueue")
        enqueues = Counter(o.get("value") for o in hist
                           if h.is_ok(o) and o.get("f") == "enqueue")
        dequeues = Counter(o.get("value") for o in hist
                           if h.is_ok(o) and o.get("f") == "dequeue")
        ok = dequeues & attempts
        unexpected = Counter({v: n for v, n in dequeues.items()
                              if v not in attempts})
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": sum(attempts.values()),
            "acknowledged-count": sum(enqueues.values()),
            "ok-count": sum(ok.values()),
            "unexpected-count": sum(unexpected.values()),
            "duplicated-count": sum(duplicated.values()),
            "lost-count": sum(lost.values()),
            "recovered-count": sum(recovered.values()),
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
        }


def total_queue() -> Checker:
    return TotalQueue()


class UniqueIds(Checker):
    """A unique-id generator must emit distinct values
    (checker.clj:692-737)."""

    def check(self, test, history, opts):
        attempted = sum(1 for o in history
                        if h.is_invoke(o) and o.get("f") == "generate")
        acks = [o.get("value") for o in history
                if h.is_ok(o) and o.get("f") == "generate"]
        counts = Counter(acks)
        dups = {v: n for v, n in counts.items() if n > 1}
        rng = [min(acks), max(acks)] if acks else [None, None]
        worst = dict(sorted(dups.items(), key=lambda kv: kv[1],
                            reverse=True)[:48])
        return {"valid?": not dups,
                "attempted-count": attempted,
                "acknowledged-count": len(acks),
                "duplicated-count": len(dups),
                "duplicated": worst,
                "range": rng}


def unique_ids() -> Checker:
    return UniqueIds()


class CounterChecker(Checker):
    """A counter incremented by :add ops and observed by :read ops: each read
    must lie within [sum of ok increments + attempted decrements, sum of
    attempted increments + ok decrements] at its window (checker.clj:740-795).
    """

    def check(self, test, history, opts):
        # Apply completion values to invocations; drop definite failures.
        hist = h.remove_failures(h.complete(h.index(history)))
        lower = upper = 0
        pending_reads: dict = {}
        reads: list = []
        for o in hist:
            key = (o.get("type"), o.get("f"))
            p = o.get("process")
            v = o.get("value")
            if key == ("invoke", "read"):
                pending_reads[p] = [lower, v]
            elif key == ("ok", "read"):
                r = pending_reads.pop(p, [lower, v])
                reads.append([r[0], r[1], upper])
            elif key == ("invoke", "add"):
                if v >= 0:
                    upper += v
                else:
                    lower += v
            elif key == ("ok", "add"):
                if v >= 0:
                    lower += v
                else:
                    upper += v
        errors = [r for r in reads
                  if r[1] is None or not (r[0] <= r[1] <= r[2])]
        return {"valid?": not errors, "reads": reads, "errors": errors}


def counter() -> Checker:
    return CounterChecker()


class Linearizable(Checker):
    """Linearizability checker over a data-type model — the reference's
    `checker/linearizable` (jepsen/src/jepsen/checker.clj:188-219).

    `algorithm` mirrors knossos ("wgl" | "linear" | "competition"); every
    host route takes the WGL engine (the native one for a fresh CAS
    register or mutex, the Python one otherwise). `backend`
    (`devices.resolve_backend`): "tpu", and "auto", take the tiered
    device path on `device` (default cuda; the CPU only when asked) for
    a fresh CAS register; "cpu" the host engine; "race" runs both at
    once and takes the first to finish the whole batch. Every other
    model runs on the host engine. `frontier` is the bounded frontier's
    arena size (None: the JEPSEN_TPU_FRONTIER gate, default 512).
    `dense_scan` replaces the dense grid's scan (e.g. `dense.scan_dense_ref`
    in place of the `knossos_dense_scan` kernel)."""

    def __init__(self, m: model.Model | None = None,
                 algorithm: str = "competition", backend: str = "auto",
                 frontier: int | None = None, device=None, dense_scan=None):
        self.model = m if m is not None else model.cas_register()
        self.algorithm = algorithm
        self.backend = backend
        self.device = device
        if frontier is None:
            from .. import gates
            frontier = gates.get("JEPSEN_TPU_FRONTIER")
        self.frontier = frontier
        self.dense_scan = dense_scan

    def _cpu(self, history: list, search_stats: dict | None = None) -> dict:
        from . import knossos
        return knossos.analysis(self.model, history,
                                algorithm=self.algorithm,
                                search_stats=search_stats)

    def check(self, test, history, opts):
        res = self.check_batch(test, [history], opts)[0]
        if res.get("valid?") is False:
            self.render_failure(test, history, res, opts)
        return res

    def render_failure(self, test, history, res, opts) -> None:
        """Render linear.svg for an invalid analysis (checker.clj:209-213).
        Called from check(), and by independent.checker per failing key
        with that key's subdirectory opts."""
        if test.get("store") is None:
            return
        try:
            from . import linear_svg
            linear_svg.render_analysis(test, res, history, opts)
        except Exception:  # rendering must never mask the verdict
            import logging
            logging.getLogger(__name__).warning(
                "linear.svg render failed", exc_info=True)

    def check_batch(self, test, histories: list[list], opts,
                    tier_log: list | None = None,
                    stats_out: list | None = None) -> list[dict]:
        """Check many histories at once, the device tiers batched over
        all of them (`independent.checker`'s batch route).

        Device routing is tiered: (1) the dense configuration grid
        (`.knossos.dense`, exact verdicts) for histories inside its
        budgets (14 pending slots, 64 values); (2) histories past it go
        to the bounded sorted frontier (`.knossos.kernels`) unless its
        feasibility gate predicts overflow; (3) those, the frontier's
        ":frontier-overflow" unknowns and anything not register-shaped
        run on the CPU WGL oracle. Verdicts only ever degrade toward
        the oracle, never diverge from it. `tier_log` gets one dict per
        tier that ran (tier, histories, seconds). `stats_out`, when given,
        is extended with one search-telemetry dict per history (grid or
        frontier occupancy from the device tiers, the WGL counters from
        the oracle; None on the race backend, where neither engine's
        counters own the wall clock), or None where an engine reported
        nothing. An auto backend takes JEPSEN_TPU_BACKEND's race, as
        the reference's does (the CLI's `--backend` exports it)."""
        def cpu_all():
            out = []
            for hs in histories:
                sd: dict | None = {} if stats_out is not None else None
                out.append(self._cpu(hs, search_stats=sd))
                if stats_out is not None:
                    stats_out.append(sd or None)
            return out

        if not (type(self.model) is model.CASRegister
                and self.model.value is None):
            return cpu_all()
        from ..devices import resolve_backend
        backend = self.backend
        if backend == "auto":
            from .. import gates
            backend = gates.get("JEPSEN_TPU_BACKEND") or "auto"
        if backend == "race":
            if resolve_backend("auto") != "tpu":
                return cpu_all()
            if stats_out is not None:
                stats_out.extend(None for _ in histories)
            return self._race(histories)
        if resolve_backend(self.backend) != "tpu":
            return cpu_all()
        return self._device_batch(histories, tier_log, stats_out)

    #: race sides still running in background threads; joined by
    #: `settle_races`, and at interpreter exit, so teardown never kills
    #: a thread inside a device launch
    _race_threads: set = set()
    #: failures no verdict may hide (`supervisor.must_end_sweep`) that a
    #: losing device side raised after the CPU side had answered;
    #: `settle_races` raises the first
    _race_errors: list = []
    _race_atexit = [False]

    @classmethod
    def settle_races(cls, timeout: float | None = None) -> None:
        """Join every race side still running, then raise the first
        failure no verdict may hide that a losing device side met after
        the CPU side had answered. `core.analyze` calls this before it
        writes a verdict, and the CLI before an `analyze-store` exits."""
        for t in list(cls._race_threads):
            t.join(timeout)
        errs = list(cls._race_errors)
        cls._race_errors.clear()
        if errs:
            raise errs[0]

    def _race(self, histories: list[list]) -> list[dict]:
        """knossos.competition's racing rule across engines: the tiered
        device path and the CPU engine run at once, and whichever
        finishes the WHOLE batch first answers (their verdicts are equal
        by the parity contract, so the race decides only wall clock). The
        loser is not interrupted mid-flight: the CPU side stops at the
        next history boundary, a losing device side runs its course in
        the background (`_race_threads`). The winner counts in the
        tracer's `race_won_device` or `race_won_cpu`.

        A losing device side is still held to the answer: its verdicts
        are compared with the CPU side's (`race_device_agree`, or
        `race_device_disagree` and a logged error), and an exception it
        raises counts in `race_device_error` and is logged; one that
        must end the sweep waits in `_race_errors` for `settle_races`.

        Departure from the reference: a device-side exception that
        arrives before the CPU side has won is raised, not answered by
        the CPU side; a CPU side that wins first is a normal outcome. A
        CPU-side exception still waits for the device side, whose
        result (or exception) decides."""
        import logging
        import queue as _queue

        from .. import trace
        from ..supervisor import must_end_sweep

        tr = trace.get_current()
        cpu_res: list = [None] * len(histories)
        stop = threading.Event()
        lock = threading.Lock()
        #: the side that answers: the first to finish, bar a failed CPU
        answer: list = []
        #: ("cpu" | "device", result or exception), in finishing order
        finished: _queue.SimpleQueue = _queue.SimpleQueue()

        def claim(side: str) -> bool:
            """Take the answer for `side` unless the other side has."""
            with lock:
                if answer:
                    return False
                answer.append(side)
                return True

        def cpu_side():
            try:
                for i, hs in enumerate(histories):
                    if stop.is_set():
                        return
                    cpu_res[i] = self._cpu(hs)
                if claim("cpu"):
                    finished.put(("cpu", cpu_res))
            except Exception as e:   # the device side then decides
                finished.put(("cpu", e))
            finally:
                Linearizable._race_threads.discard(
                    threading.current_thread())

        def lost(out) -> None:
            """The device side ended after the CPU side had answered."""
            logger = logging.getLogger(__name__)
            if isinstance(out, BaseException):
                tr.counter("race_device_error").inc()
                logger.error("the race's losing device side failed",
                             exc_info=out)
                if must_end_sweep(out):
                    Linearizable._race_errors.append(out)
                return
            want = [r.get("valid?") for r in cpu_res]
            got = [r.get("valid?") for r in out]
            if got == want:
                tr.counter("race_device_agree").inc()
                return
            tr.counter("race_device_disagree").inc()
            logger.error(
                "the race's device side disagrees with the CPU side on "
                "%d of %d histories", sum(a != b for a, b in
                                          zip(got, want)), len(want))

        def dev_side():
            try:
                try:
                    out = self._device_batch(histories)
                except BaseException as e:   # raised from the caller
                    out = e
                if claim("device"):
                    finished.put(("device", out))
                else:
                    lost(out)
            finally:
                Linearizable._race_threads.discard(
                    threading.current_thread())

        if not Linearizable._race_atexit[0]:
            Linearizable._race_atexit[0] = True
            import atexit

            def _drain():
                try:
                    Linearizable.settle_races(timeout=120)
                except BaseException:
                    logging.getLogger(__name__).exception(
                        "a race's device side failed after its answer")
            atexit.register(_drain)
        sides = [threading.Thread(target=cpu_side, daemon=True,
                                  name="linearizable-race-cpu"),
                 threading.Thread(target=dev_side, daemon=True,
                                  name="linearizable-race-dev")]
        Linearizable._race_threads.update(sides)
        for t in sides:
            t.start()
        side, out = finished.get()
        if side == "cpu" and isinstance(out, Exception):
            side, out = finished.get()   # the device side decides
        stop.set()
        if isinstance(out, BaseException):
            raise out
        tr.counter(f"race_won_{side}").inc()
        return list(out)

    def _device_batch(self, histories: list[list],
                      tier_log: list | None = None,
                      stats_out: list | None = None) -> list[dict]:
        """The tiered device path (see check_batch); callers have
        already checked model eligibility."""
        from ..devices import resolve_device
        from .knossos import dense, kernels
        from .knossos import encode as kenc

        dev = resolve_device(self.device)
        dense_encs, dense_idx = [], []
        front_encs, front_idx = [], []
        cpu_idx = []
        # every simultaneously-open write or unknown-value read doubles
        # the frontier, every open cas or known-value read about half
        # doubles it: a history whose estimated closure can't fit the
        # arena goes straight to the oracle
        budget = 2 * (max(self.frontier, 1).bit_length() - 1)
        for i, hs in enumerate(histories):
            try:
                dense_encs.append(dense.encode_dense_history(hs))
                dense_idx.append(i)
            except kenc.EncodingError:
                try:
                    enc = kenc.encode_register_history(hs)
                    if enc.half_doublings_peak > budget:
                        cpu_idx.append(i)
                    else:
                        front_encs.append(enc)
                        front_idx.append(i)
                except kenc.EncodingError:
                    cpu_idx.append(i)
        results: list[dict | None] = [None] * len(histories)

        def note(tier: str, n: int, t0: float) -> None:
            if tier_log is not None and n:
                tier_log.append({"tier": tier, "histories": n,
                                 "seconds": time.perf_counter() - t0})

        with_stats = stats_out is not None
        stats: list = [None] * len(histories)
        t0 = time.perf_counter()
        if dense_encs:
            ds: list | None = [] if with_stats else None
            for j, (i, r) in enumerate(zip(
                    dense_idx, dense.check_encoded_dense_batch(
                        dense_encs, dev, scan=self.dense_scan,
                        stats_out=ds))):
                results[i] = r
                if ds is not None:
                    stats[i] = ds[j]
        note("tpu-dense", len(dense_encs), t0)
        t0 = time.perf_counter()
        if front_encs:
            fs: list | None = [] if with_stats else None
            for j, (i, r) in enumerate(zip(
                    front_idx, kernels.check_encoded_batch(
                        front_encs, frontier=self.frontier, device=dev,
                        stats_out=fs))):
                if r.get("valid?") == "unknown":
                    cpu_idx.append(i)  # overflow: exact answer from CPU
                else:
                    results[i] = r
                    if fs is not None:
                        stats[i] = fs[j]
        note("tpu-jit", len(front_encs), t0)
        t0 = time.perf_counter()
        for i in cpu_idx:
            sd: dict | None = {} if with_stats else None
            results[i] = self._cpu(histories[i], search_stats=sd)
            if with_stats:
                stats[i] = sd or None
        note("wgl", len(cpu_idx), t0)
        if with_stats:
            stats_out.extend(stats)
        return results  # type: ignore[return-value]


def linearizable(m: model.Model | None = None,
                 algorithm: str = "competition",
                 backend: str = "auto", **kw) -> Checker:
    return Linearizable(m, algorithm=algorithm, backend=backend, **kw)


# ---------------------------------------------------------------------------
# Plot/report checkers live in submodules (perf, clock, timeline) but are
# part of the reference's jepsen.checker namespace (checker.clj:797-837) —
# re-export the constructors here. Imported lazily to keep matplotlib off
# the fast path.
# ---------------------------------------------------------------------------

def _submodule(name: str):
    import importlib
    return importlib.import_module(f"{__name__}.{name}")


def latency_graph(nemeses=None) -> Checker:
    return _submodule("perf").latency_graph(nemeses)


def rate_graph(nemeses=None) -> Checker:
    return _submodule("perf").rate_graph_checker(nemeses)


def perf_checker(opts: dict | None = None) -> Checker:
    """Composite latency+rate plots (checker.clj:822-829). Named
    perf_checker because `checker.perf` is the helper submodule, as in the
    reference's jepsen.checker.perf namespace."""
    return _submodule("perf").perf(opts)


def clock_plot() -> Checker:
    return _submodule("clock").clock_plot()


def timeline_checker() -> Checker:
    """Timeline HTML checker; the submodule `checker.timeline` mirrors
    jepsen.checker.timeline (whose constructor is `html`)."""
    return _submodule("timeline").html()
