"""The pure generator DSL: an immutable algebra for scheduling operations.

Counterpart of the reference's jepsen.generator.pure
(jepsen/src/jepsen/generator/pure.clj) — the deprecated stateful generator
is intentionally not ported (pure.clj:23-34 explains why).

A generator is asked for operations with

    op(gen, test, ctx)  ->  None                 exhausted
                         |  (PENDING, gen')      nothing *yet*
                         |  (op_dict, gen')      an operation + next state

and told about events (invocations and completions) with

    update(gen, test, ctx, event) -> gen'

Plain Python values lift into generators (pure.clj:504-566):

  None        the empty generator
  dict        yields exactly one op shaped like itself, with type/process/
              time filled from context
  callable    called (with (test, ctx) if it accepts two args) to produce
              a generator; re-called when that generator is exhausted
  list/tuple  a sequence of generators, run one after the next

The context tracks logical time (nanos), which threads are free, and the
thread->process map (pure.clj:417-426). Thread ids are ints plus
"nemesis".

The port's copy of `jepsen_tpu/generator/__init__.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import inspect
import logging
import random
import weakref
from typing import Any, Callable, Iterable

log = logging.getLogger(__name__)

#: module-local alias: attribute lookups cost in the per-op hot path
_rand = random.random


class _Pending:
    __slots__ = ()

    def __repr__(self):
        return ":pending"


PENDING = _Pending()

NEMESIS = "nemesis"


def secs_to_nanos(s: float) -> int:
    return int(s * 1e9)


class Context:
    """Generator context: immutable; mutators return new contexts."""

    __slots__ = ("time", "free_threads", "workers")

    def __init__(self, time: int, free_threads: frozenset, workers: dict):
        self.time = time
        self.free_threads = free_threads
        self.workers = workers

    @staticmethod
    def for_test(test: dict) -> "Context":
        threads = frozenset(range(test.get("concurrency", 5))) | {NEMESIS}
        return Context(0, threads, {t: t for t in threads})

    def with_time(self, t: int) -> "Context":
        return Context(t, self.free_threads, self.workers)

    def busy(self, thread) -> "Context":
        return Context(self.time, self.free_threads - {thread}, self.workers)

    def free(self, thread) -> "Context":
        return Context(self.time, self.free_threads | {thread}, self.workers)

    def with_worker(self, thread, process) -> "Context":
        w = dict(self.workers)
        w[thread] = process
        return Context(self.time, self.free_threads, w)

    def restrict(self, pred: Callable[[Any], bool]) -> "Context":
        """Context containing only threads satisfying pred
        (on-threads-context, pure.clj:797-808)."""
        return Context(self.time,
                       frozenset(t for t in self.free_threads if pred(t)),
                       {t: p for t, p in self.workers.items() if pred(t)})

    # -- queries (pure.clj:440-487) ---------------------------------------

    def free_processes(self) -> list:
        return [self.workers[t] for t in self.free_threads]

    def some_free_process(self):
        for t in self.free_threads:
            return self.workers[t]
        return None

    def all_processes(self) -> list:
        return list(self.workers.values())

    def all_threads(self) -> list:
        return list(self.workers.keys())

    def process_to_thread(self, process):
        for t, p in self.workers.items():
            if p == process:
                return t
        return None

    def thread_to_process(self, thread):
        return self.workers.get(thread)

    def next_process(self, thread):
        """Process to replace a crashed one: p + (count of int processes)
        (pure.clj:478-486)."""
        if isinstance(thread, int):
            return self.workers[thread] + sum(
                1 for p in self.workers.values() if isinstance(p, int))
        return thread


def fill_in_op(op: dict, ctx: Context):
    """Fill :type/:process/:time from context; PENDING if no process free
    (pure.clj:489-502)."""
    p = ctx.some_free_process()
    if p is None:
        return PENDING
    out = dict(op)
    out.setdefault("time", ctx.time)
    out.setdefault("process", p)
    out.setdefault("type", "invoke")
    return out


class Generator:
    """Base class for combinators. Plain values need not subclass this —
    the `op`/`update` module functions lift them."""

    # empty slots so hot subclasses' __slots__ actually elide __dict__
    # (subclasses that don't declare slots still get one implicitly)
    __slots__ = ()

    def op(self, test: dict, ctx: Context):
        raise NotImplementedError

    def update(self, test: dict, ctx: Context, event: dict) -> "Generator":
        return self


_fn_arity = weakref.WeakKeyDictionary()


def _call_fn(f: Callable, test: dict, ctx: Context):
    """Call an fn generator with (test, ctx) or no args, whichever its
    signature wants. The arity is memoized per function object — this
    sits in the interpreter's per-op hot loop (pure.clj:66-70's
    >20k ops/sec figure), and inspect.signature costs more than the
    whole rest of an op step. Bound methods are keyed on their
    underlying __func__ (a fresh method object is created per
    attribute access, so keying on the method itself would never hit);
    the cache stores the arity of the CALL — `self` already bound —
    which is the same for every binding of one function."""
    key = getattr(f, "__func__", f)
    try:
        nargs = _fn_arity[key]
    except (KeyError, TypeError):   # TypeError: non-weakrefable callable
        try:
            sig = inspect.signature(f)
            nargs = len([p for p in sig.parameters.values()
                         if p.default is p.empty and
                         p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)])
        except (TypeError, ValueError):
            nargs = 0
        try:
            _fn_arity[key] = nargs
        except TypeError:
            pass
    return f(test, ctx) if nargs == 2 else f()


class Seq(Generator):
    """A sequence of generators, run one after the next — the lifted form
    of a list/tuple. Only the head's state evolves, so stepping is O(1)
    (the raw-list path would copy the tail on every op)."""

    __slots__ = ("head", "items", "idx")

    def __init__(self, head, items: tuple, idx: int):
        self.head = head      # current generator (items[idx-1]'s state)
        self.items = items    # shared, never mutated
        self.idx = idx        # next unstarted element

    @staticmethod
    def of(items) -> "Seq | None":
        items = tuple(items)
        if not items:
            return None
        return Seq(items[0], items, 1)

    def op(self, test, ctx):
        head, idx = self.head, self.idx
        while True:
            res = op(head, test, ctx)
            if res is not None:
                o, g2 = res
                if idx >= len(self.items):
                    # Tail exhausted: unwrap to the head's own state so
                    # chained Seqs don't nest one level per op
                    # (pure.clj:536-548's cons/gen' distinction).
                    return (o, g2)
                return (o, Seq(g2, self.items, idx))
            if idx >= len(self.items):
                return None
            head = self.items[idx]
            idx += 1

    def update(self, test, ctx, event):
        # Updates go to the first (current) generator only.
        return Seq(update(self.head, test, ctx, event), self.items, self.idx)


def op(gen, test: dict, ctx: Context):
    """Ask any generator-like value for its next operation."""
    if gen is None:
        return None
    if isinstance(gen, Generator):
        return gen.op(test, ctx)
    if isinstance(gen, dict):
        o = fill_in_op(gen, ctx)
        return (o, gen if o is PENDING else None)
    if isinstance(gen, (list, tuple)):
        return op(Seq.of(gen), test, ctx)
    if callable(gen):
        produced = _call_fn(gen, test, ctx)
        if produced is None:
            return None
        return op(Seq.of([produced, gen]), test, ctx)
    raise TypeError(f"not a generator: {gen!r}")


def update(gen, test: dict, ctx: Context, event: dict):
    """Tell any generator-like value about an event."""
    if gen is None or isinstance(gen, dict) or callable(gen):
        return gen
    if isinstance(gen, Generator):
        return gen.update(test, ctx, event)
    if isinstance(gen, (list, tuple)):
        seq = Seq.of(gen)
        return None if seq is None else seq.update(test, ctx, event)
    raise TypeError(f"not a generator: {gen!r}")


def soonest_op_vec(a, b):
    """Of two (op, ...) tuples, the one whose op occurs first; op maps
    before PENDING before None (pure.clj:818-836)."""
    if a is None:
        return b
    if b is None:
        return a
    if a[0] is PENDING:
        return b
    if b[0] is PENDING:
        return a
    return a if a[0].get("time", 0) <= b[0].get("time", 0) else b


# ---------------------------------------------------------------------------
# Combinators
# ---------------------------------------------------------------------------

class Validate(Generator):
    """Asserts the generator contract op-by-op (pure.clj:568-622)."""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        if not isinstance(res, tuple) or len(res) != 2:
            raise ValueError(
                f"generator op should return None or a pair: {res!r}")
        o, g2 = res
        if o is not PENDING:
            if not isinstance(o, dict):
                raise ValueError(f"op should be PENDING or a map: {o!r}")
            free = ctx.free_processes()
            if o.get("type") not in ("sleep", "log") and \
                    o.get("process") not in free:
                raise ValueError(
                    f"process {o.get('process')!r} is not free: {free!r}")
            if o.get("time") is None:
                raise ValueError(f"op missing :time: {o!r}")
        return (o, Validate(g2))

    def update(self, test, ctx, event):
        return Validate(update(self.gen, test, ctx, event))


class FriendlyExceptions(Generator):
    """Wraps op/update, re-raising with the generator attached
    (pure.clj:624-664)."""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        try:
            res = op(self.gen, test, ctx)
        except Exception as e:
            raise RuntimeError(
                f"generator threw during op: {self.gen!r}") from e
        if res is None:
            return None
        o, g2 = res
        return (o, FriendlyExceptions(g2))

    def update(self, test, ctx, event):
        try:
            return FriendlyExceptions(update(self.gen, test, ctx, event))
        except Exception as e:
            raise RuntimeError(
                f"generator threw during update: {self.gen!r}") from e


class Trace(Generator):
    """Logs every op/update (pure.clj:666-709)."""

    def __init__(self, k, gen):
        self.k = k
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        log.info("%s op -> %r", self.k, None if res is None else res[0])
        if res is None:
            return None
        o, g2 = res
        return (o, Trace(self.k, g2))

    def update(self, test, ctx, event):
        log.info("%s update <- %r", self.k, event)
        return Trace(self.k, update(self.gen, test, ctx, event))


class Map(Generator):
    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        return (o if o is PENDING else self.f(o), Map(self.f, g2))

    def update(self, test, ctx, event):
        return Map(self.f, update(self.gen, test, ctx, event))


def map_gen(f, gen):
    return Map(f, gen)


def f_map(fm: dict, gen):
    """Rewrite op :f according to the map fm (pure.clj:729-735)."""
    return Map(lambda o: {**o, "f": fm.get(o.get("f"), o.get("f"))}, gen)


class Filter(Generator):
    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        gen = self.gen
        while True:
            res = op(gen, test, ctx)
            if res is None:
                return None
            o, g2 = res
            if o is PENDING or self.f(o):
                return (o, Filter(self.f, g2))
            gen = g2

    def update(self, test, ctx, event):
        return Filter(self.f, update(self.gen, test, ctx, event))


def filter_gen(f, gen):
    return Filter(f, gen)


class IgnoreUpdates(Generator):
    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        return op(self.gen, test, ctx)

    def update(self, test, ctx, event):
        return self


class OnUpdate(Generator):
    """Custom update handler: f(this, test, ctx, event) -> gen
    (pure.clj:767-776)."""

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        return (o, OnUpdate(self.f, g2))

    def update(self, test, ctx, event):
        return self.f(self, test, ctx, event)


def on_update(f, gen):
    return OnUpdate(f, gen)


class OnThreads(Generator):
    """Restrict a generator to threads satisfying f (pure.clj:810-833)."""

    def __init__(self, f, gen):
        self.f = f
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx.restrict(self.f))
        if res is None:
            return None
        o, g2 = res
        return (o, OnThreads(self.f, g2))

    def update(self, test, ctx, event):
        # A crashed op's process was already remapped away from its
        # thread, so the lookup may yield None — the predicate still
        # decides (the reference's clients predicate accepts nil threads,
        # so crash completions reach client generators; pure.clj:819-822).
        thread = ctx.process_to_thread(event.get("process"))
        if self.f(thread):
            return OnThreads(
                self.f, update(self.gen, test, ctx.restrict(self.f), event))
        return self


on_threads = OnThreads
on = OnThreads


def clients(client_gen, nemesis_gen=None):
    """Restrict to client threads; or route clients/nemesis
    (pure.clj:989-1000)."""
    c = OnThreads(lambda t: t != NEMESIS, client_gen)
    if nemesis_gen is None:
        return c
    return any_gen(c, nemesis(nemesis_gen))


def nemesis(nemesis_gen):
    return OnThreads(lambda t: t == NEMESIS, nemesis_gen)


class Any(Generator):
    """Operations from whichever generator is soonest (pure.clj:838-858)."""

    def __init__(self, gens: list):
        self.gens = list(gens)

    def op(self, test, ctx):
        soonest = None
        for i, gen in enumerate(self.gens):
            res = op(gen, test, ctx)
            if res is not None:
                soonest = soonest_op_vec(soonest, (*res, i))
        if soonest is None:
            return None
        o, g2, i = soonest
        gens = list(self.gens)
        gens[i] = g2
        return (o, Any(gens))

    def update(self, test, ctx, event):
        return Any([update(g, test, ctx, event) for g in self.gens])


def any_gen(*gens):
    if not gens:
        return None
    if len(gens) == 1:
        return gens[0]
    return Any(list(gens))


class EachThread(Generator):
    """An independent copy of the generator per thread (pure.clj:861-909)."""

    def __init__(self, fresh_gen, gens: dict | None = None):
        self.fresh_gen = fresh_gen
        self.gens = gens or {}

    def _thread_ctx(self, ctx, thread):
        return Context(ctx.time, frozenset({thread}),
                       {thread: ctx.workers[thread]})

    def op(self, test, ctx):
        soonest = None
        for thread in ctx.free_threads:
            gen = self.gens.get(thread, self.fresh_gen)
            res = op(gen, test, self._thread_ctx(ctx, thread))
            if res is not None:
                soonest = soonest_op_vec(soonest, (*res, thread))
        if soonest is not None:
            o, g2, thread = soonest
            gens = dict(self.gens)
            gens[thread] = g2
            return (o, EachThread(self.fresh_gen, gens))
        if len(ctx.free_threads) != len(ctx.workers):
            return (PENDING, self)  # busy threads may still want ops
        return None  # every thread exhausted

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.get("process"))
        if thread is None:
            return self
        gen = self.gens.get(thread, self.fresh_gen)
        tctx = Context(ctx.time,
                       ctx.free_threads & frozenset({thread}),
                       {thread: ctx.workers[thread]})
        gens = dict(self.gens)
        gens[thread] = update(gen, test, tctx, event)
        return EachThread(self.fresh_gen, gens)


def each_thread(gen):
    return EachThread(gen)


class Reserve(Generator):
    """Dedicate thread ranges to generators (pure.clj:911-987)."""

    def __init__(self, ranges: list[frozenset], gens: list):
        # gens has len(ranges)+1 entries; last is the default generator.
        self.ranges = ranges
        self.all_ranges = frozenset().union(*ranges) if ranges else frozenset()
        self.gens = list(gens)

    def op(self, test, ctx):
        soonest = None
        for i, threads in enumerate(self.ranges):
            res = op(self.gens[i], test, ctx.restrict(threads.__contains__))
            if res is not None:
                soonest = soonest_op_vec(soonest, (*res, i))
        res = op(self.gens[-1], test,
                 ctx.restrict(lambda t: t not in self.all_ranges))
        if res is not None:
            soonest = soonest_op_vec(soonest, (*res, len(self.ranges)))
        if soonest is None:
            return None
        o, g2, i = soonest
        gens = list(self.gens)
        gens[i] = g2
        return (o, Reserve(self.ranges, gens))

    def update(self, test, ctx, event):
        thread = ctx.process_to_thread(event.get("process"))
        i = len(self.ranges)
        for j, r in enumerate(self.ranges):
            if thread in r:
                i = j
                break
        gens = list(self.gens)
        gens[i] = update(gens[i], test, ctx, event)
        return Reserve(self.ranges, gens)


def reserve(*args):
    """reserve(5, write_gen, 10, cas_gen, default_gen)."""
    *pairs, default = args
    assert default is not None
    assert len(pairs) % 2 == 0
    ranges: list[frozenset] = []
    gens: list = []
    n = 0
    for i in range(0, len(pairs), 2):
        count, gen = pairs[i], pairs[i + 1]
        ranges.append(frozenset(range(n, n + count)))
        gens.append(gen)
        n += count
    gens.append(default)
    return Reserve(ranges, gens)


class Mix(Generator):
    """Uniform random mixture; ignores updates (pure.clj:1020-1046)."""

    __slots__ = ("gens", "i")

    def __init__(self, gens: list, i: int | None = None):
        self.gens = list(gens)
        self.i = int(_rand() * len(gens)) if i is None and gens else (i or 0)

    @classmethod
    def _share(cls, gens: list) -> "Mix":
        """A re-rolled Mix over an UNCHANGED gens list, skipping the
        defensive copy — the single alternate construction path for
        the per-op fast path below (keep in sync with __init__)."""
        nxt = cls.__new__(cls)
        nxt.gens = gens
        nxt.i = int(_rand() * len(gens))
        return nxt

    def op(self, test, ctx):
        if not self.gens:
            return None
        res = op(self.gens[self.i], test, ctx)
        if res is not None:
            o, g2 = res
            if g2 is self.gens[self.i]:
                # unchanged sub-generator (Repeat/dict/Limit-PENDING):
                # share the gens list and only re-roll the choice —
                # the per-op hot path of every mix-of-repeats workload
                return (o, Mix._share(self.gens))
            gens = list(self.gens)
            gens[self.i] = g2
            return (o, Mix(gens))
        gens = self.gens[: self.i] + self.gens[self.i + 1:]
        if not gens:
            return None
        return Mix(gens).op(test, ctx)


def mix(gens):
    gens = list(gens)
    return Mix(gens) if gens else None


class Limit(Generator):

    __slots__ = ("remaining", "gen")
    def __init__(self, remaining: int, gen):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining <= 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING and g2 is self.gen:
            return (o, self)    # no-op step: nothing changed
        n = self.remaining if o is PENDING else self.remaining - 1
        return (o, Limit(n, g2))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Limit(self.remaining, g2)


def limit(n, gen):
    return Limit(n, gen)


def once(gen):
    return Limit(1, gen)


def log_gen(msg):
    """A special op that logs a message (pure.clj:1069-1073)."""
    return {"type": "log", "value": msg}


class Repeat(Generator):
    """Re-yield the underlying generator's op without consuming it
    (pure.clj:1075-1102). remaining < 0 means forever."""

    __slots__ = ("remaining", "gen")

    def __init__(self, remaining: int, gen):
        self.remaining = remaining
        self.gen = gen

    def op(self, test, ctx):
        if self.remaining == 0:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, _ = res
        if self.remaining < 0 or o is PENDING:
            return (o, self)    # forever / no-op step: nothing changed
        return (o, Repeat(self.remaining - 1, self.gen))

    def update(self, test, ctx, event):
        g2 = update(self.gen, test, ctx, event)
        return self if g2 is self.gen else Repeat(self.remaining, g2)


def repeat_gen(gen, n: int = -1):
    return Repeat(n, gen)


class Cycle(Generator):
    """Endlessly restart `source` when it's exhausted — the semantics
    of the reference's `(cycle [...])` nemesis schedules
    (etcd.clj:174-178). Unlike Repeat (which re-yields the FIRST op
    forever, pure.clj:1075), Cycle consumes the whole sequence and
    starts over. `source` must be a pure generator value (lists of op
    maps/sleeps are), since each lap re-reads it."""

    def __init__(self, source, current=None):
        self.source = source
        self.current = current if current is not None else source

    def op(self, test, ctx):
        res = op(self.current, test, ctx)
        if res is None:
            res = op(self.source, test, ctx)   # start the next lap
            if res is None:
                return None                    # source yields nothing
        o, g2 = res
        return (o, Cycle(self.source, g2))

    def update(self, test, ctx, event):
        return Cycle(self.source, update(self.current, test, ctx, event))


def cycle(gen):
    return Cycle(gen)


class ProcessLimit(Generator):
    """Emit ops for at most n distinct processes (pure.clj:1104-1129)."""

    def __init__(self, n: int, procs: frozenset, gen):
        self.n = n
        self.procs = procs
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, ProcessLimit(self.n, self.procs, g2))
        procs = self.procs | frozenset(
            p for p in ctx.all_processes() if isinstance(p, int))
        if len(procs) > self.n:
            return None
        return (o, ProcessLimit(self.n, procs, g2))

    def update(self, test, ctx, event):
        return ProcessLimit(self.n, self.procs,
                            update(self.gen, test, ctx, event))


def process_limit(n, gen):
    return ProcessLimit(n, frozenset(), gen)


class TimeLimit(Generator):
    """Emit ops for dt seconds after the first op (pure.clj:1131-1155)."""

    def __init__(self, limit_nanos: int, cutoff: int | None, gen):
        self.limit = limit_nanos
        self.cutoff = cutoff
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, TimeLimit(self.limit, self.cutoff, g2))
        cutoff = self.cutoff if self.cutoff is not None \
            else o.get("time", 0) + self.limit
        if o.get("time", 0) >= cutoff:
            return None
        return (o, TimeLimit(self.limit, cutoff, g2))

    def update(self, test, ctx, event):
        return TimeLimit(self.limit, self.cutoff,
                         update(self.gen, test, ctx, event))


def time_limit(dt_secs: float, gen):
    return TimeLimit(secs_to_nanos(dt_secs), None, gen)


class Stagger(Generator):
    """Schedule ops at uniformly random intervals averaging dt
    (pure.clj:1157-1199). Applies to all ops, not per-thread."""

    def __init__(self, dt: int, next_time: int, gen):
        self.dt = dt
        self.next_time = next_time
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, self)
        nt = self.next_time + int(random.random() * self.dt)
        if self.next_time <= o.get("time", 0):
            return (o, Stagger(self.dt, nt, g2))
        return ({**o, "time": self.next_time}, Stagger(self.dt, nt, g2))

    def update(self, test, ctx, event):
        return Stagger(self.dt, self.next_time,
                       update(self.gen, test, ctx, event))


def stagger(dt_secs: float, gen):
    return Stagger(secs_to_nanos(2 * dt_secs), 0, gen)


class DelayTil(Generator):
    """Align invocation times to multiples of dt (pure.clj:1233-1262)."""

    def __init__(self, dt: int, anchor: int | None, gen):
        self.dt = dt
        self.anchor = anchor
        self.gen = gen

    def op(self, test, ctx):
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        if o is PENDING:
            return (o, DelayTil(self.dt, self.anchor, g2))
        t = o.get("time", 0)
        anchor = self.anchor if self.anchor is not None else t
        t = t + (self.dt - ((t - anchor) % self.dt)) % self.dt
        return ({**o, "time": t}, DelayTil(self.dt, anchor, g2))

    def update(self, test, ctx, event):
        return DelayTil(self.dt, self.anchor,
                        update(self.gen, test, ctx, event))


def delay_til(dt_secs: float, gen):
    return DelayTil(secs_to_nanos(dt_secs), None, gen)


def delay(dt_secs: float, gen):
    """Ops at least dt apart — reference aliases this to delay-til."""
    return delay_til(dt_secs, gen)


def sleep(dt_secs: float):
    """One special op making its process do nothing for dt seconds
    (pure.clj:1264-1268)."""
    return {"type": "sleep", "value": dt_secs}


class Synchronize(Generator):
    """Wait until all workers are free, then become gen
    (pure.clj:1270-1290)."""

    def __init__(self, gen):
        self.gen = gen

    def op(self, test, ctx):
        if len(ctx.free_threads) == len(ctx.workers):
            return op(self.gen, test, ctx)
        return (PENDING, self)

    def update(self, test, ctx, event):
        return Synchronize(update(self.gen, test, ctx, event))


def synchronize(gen):
    return Synchronize(gen)


def phases(*gens):
    """Each generator runs to completion, with a barrier between
    (pure.clj:1292-1297)."""
    return [Synchronize(g) for g in gens]


def then(a, b):
    """b, then (synchronize a). Argument order matches the reference for
    pipeline composition (pure.clj:1299-1308)."""
    return [b, Synchronize(a)]


class UntilOk(Generator):
    """Yield ops until one completes :ok (pure.clj:1310-1328)."""

    def __init__(self, gen, done: bool = False):
        self.gen = gen
        self.done = done

    def op(self, test, ctx):
        if self.done:
            return None
        res = op(self.gen, test, ctx)
        if res is None:
            return None
        o, g2 = res
        return (o, UntilOk(g2, False))

    def update(self, test, ctx, event):
        if event.get("type") == "ok":
            return UntilOk(self.gen, True)
        return UntilOk(update(self.gen, test, ctx, event), self.done)


def until_ok(gen):
    return UntilOk(gen)


class FlipFlop(Generator):
    """Alternate between generators; stop when one is exhausted
    (pure.clj:1330-1344)."""

    def __init__(self, gens: list, i: int = 0):
        self.gens = list(gens)
        self.i = i

    def op(self, test, ctx):
        res = op(self.gens[self.i], test, ctx)
        if res is None:
            return None
        o, g2 = res
        gens = list(self.gens)
        gens[self.i] = g2
        return (o, FlipFlop(gens, (self.i + 1) % len(gens)))


def flip_flop(a, b):
    return FlipFlop([a, b])
