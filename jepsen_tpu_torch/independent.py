"""Independent keys: op values lifted to `[k v]` tuples, the generators
that lift them, the per-key split of a history, and the checker that
checks each key alone.

The part of `jepsen_tpu/independent.py` (the reference's
jepsen.independent): `Tuple` and its helpers, `relift_history` (which
re-lifts values a JSON round trip turned into plain two-element lists),
the per-key split `subhistory` / `subhistories`, and
`checker(sub)` — every keyed suite's checker (etcd, consul, zookeeper,
mongodb) — and the generators that lift a single-key generator over
many keys: `sequential_generator` (one key at a time) and
`concurrent_generator` (thread groups each owning a key;
independent.clj:32-268). The native splitter is not ported.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Iterable

from . import generator as gen
from . import trace
from .checker import Checker, check_safe, merge_valid
from .util import bounded_pmap

log = logging.getLogger(__name__)


class Tuple(tuple):
    """A distinguished [key value] pair. A subclass so the checker can
    tell lifted values from ordinary two-element vectors."""

    __slots__ = ()

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]

    def __repr__(self):
        return f"[{self[0]!r} {self[1]!r}]"


def tuple_(k, v) -> Tuple:
    return Tuple(k, v)


def is_tuple(v: Any) -> bool:
    return isinstance(v, Tuple)


def key_of(v: Any):
    return v.key if is_tuple(v) else None


def value_of(v: Any):
    return v.value if is_tuple(v) else v


def relift_history(history: list) -> list:
    """Re-lift [k v] op values into Tuples after a serialization round
    trip that erased the type (history.jsonl / history.edn render a
    tuple as a plain two-element vector). Heuristic, applied only when
    unambiguous: every client op value that isn't None must be a
    two-element list AND at least one ok read's value must be one too
    (an unlifted register history has scalar read values, so it never
    matches; an unlifted cas-only history is ambiguous and stays
    unlifted)."""
    if any(is_tuple(o.get("value")) for o in history):
        return history
    client = [o for o in history if o.get("process") != "nemesis"]
    vals = [o.get("value") for o in client if o.get("value") is not None]
    if not vals or not all(isinstance(v, (list, tuple)) and len(v) == 2
                           for v in vals):
        return history
    if not any(o.get("type") == "ok" and o.get("f") == "read"
               and isinstance(o.get("value"), (list, tuple))
               for o in client):
        return history
    return [({**o, "value": Tuple(o["value"][0], o["value"][1])}
             if o.get("process") != "nemesis"
             and isinstance(o.get("value"), (list, tuple))
             and len(o["value"]) == 2 else o)
            for o in history]


def _wrap(k, res):
    """Wrap a sub-generator op result's value into a [k v] tuple.
    Only client invocations are lifted: interpreter pseudo-ops
    (sleep/log) carry scalar payloads the event loop consumes directly
    — a lifted sleep duration would crash the worker."""
    o, g2 = res
    if isinstance(o, dict) and o.get("type") in (None, "invoke"):
        o = {**o, "value": Tuple(k, o.get("value"))}
    return o, g2


def _unwrap_event(event: dict) -> dict:
    v = event.get("value")
    if is_tuple(v):
        return {**event, "value": v.value}
    return event


class SequentialGenerator(gen.Generator):
    """One key at a time: run gen_fn(k) to exhaustion, then the next key
    (independent.clj:32-66)."""

    def __init__(self, keys: Iterable, gen_fn: Callable,
                 _state=None):
        if _state is None:
            keys = list(keys)
            _state = (keys, 0, gen_fn(keys[0]) if keys else None)
        self.gen_fn = gen_fn
        self.keys, self.i, self.cur = _state

    def _with(self, i, cur):
        return SequentialGenerator(
            self.keys, self.gen_fn, _state=(self.keys, i, cur))

    def op(self, test, ctx):
        i, cur = self.i, self.cur
        while i < len(self.keys):
            if cur is None:
                cur = self.gen_fn(self.keys[i])
            res = gen.op(cur, test, ctx)
            if res is not None:
                o, g2 = _wrap(self.keys[i], res)
                return o, self._with(i, g2)
            i, cur = i + 1, None
        return None

    def update(self, test, ctx, event):
        if self.cur is None or self.i >= len(self.keys):
            return self
        v = event.get("value")
        if is_tuple(v) and v.key == self.keys[self.i]:
            return self._with(
                self.i,
                gen.update(self.cur, test, ctx, _unwrap_event(event)))
        return self


def sequential_generator(keys: Iterable, gen_fn: Callable):
    return SequentialGenerator(keys, gen_fn)


class ConcurrentGenerator(gen.Generator):
    """Thread groups of size n, each owning one key at a time
    (independent.clj:138-268, the pure PureConcurrentGenerator).

    Client threads are partitioned by `thread // n`; each group runs
    gen_fn(k) restricted to its own threads and claims the next
    unclaimed key when its current generator is exhausted. Requires
    integer client threads; the nemesis is untouched (wrap with
    gen.clients as usual)."""

    def __init__(self, n: int, keys: Iterable, gen_fn: Callable,
                 _state=None):
        self.n = n
        self.gen_fn = gen_fn
        if _state is None:
            _state = (list(keys), 0, {}, {})
        # groups: group-id -> (key, sub-generator); done groups absent
        # but recorded in exhausted so they don't re-claim.
        self.keys, self.next_key, self.groups, self.key_group = _state

    def _with(self, next_key, groups, key_group):
        return ConcurrentGenerator(
            self.n, self.keys, self.gen_fn,
            _state=(self.keys, next_key, groups, key_group))

    def _group_threads(self, ctx, g):
        lo, hi = g * self.n, (g + 1) * self.n
        return lambda t: isinstance(t, int) and lo <= t < hi

    def _probe(self, g, test, ctx):
        """Try to produce an op from group g against a private copy of
        the state; only the winning probe's state is kept, so key
        claims by losing probes simply re-happen next call (gen.op is
        pure). Returns (op, successor-ConcurrentGenerator) or None."""
        groups = dict(self.groups)
        key_group = dict(self.key_group)
        nk = self.next_key
        gctx = ctx.restrict(self._group_threads(ctx, g))
        entry = groups.get(g)
        while True:
            if entry is None:
                if nk >= len(self.keys):
                    return None
                k = self.keys[nk]
                nk += 1
                entry = (k, self.gen_fn(k))
                key_group[k] = g
            k, sub = entry
            res = gen.op(sub, test, gctx)
            if res is None:
                entry = None
                continue
            o, g2 = _wrap(k, res)
            groups[g] = (k, g2)
            return o, self._with(nk, groups, key_group)

    def op(self, test, ctx):
        soonest = None
        gids = sorted({t // self.n for t in ctx.free_threads
                      if isinstance(t, int)})
        for g in gids:
            cand = self._probe(g, test, ctx)
            if cand is not None:
                soonest = gen.soonest_op_vec(soonest, (*cand, g))
        if soonest is None:
            return None
        o, succ, _ = soonest
        return o, succ

    def update(self, test, ctx, event):
        v = event.get("value")
        if not is_tuple(v):
            return self
        g = self.key_group.get(v.key)
        if g is None or g not in self.groups:
            return self
        k, sub = self.groups[g]
        if k != v.key:
            return self
        gctx = ctx.restrict(self._group_threads(ctx, g))
        groups = dict(self.groups)
        groups[g] = (k, gen.update(sub, test, gctx,
                                   _unwrap_event(event)))
        return self._with(self.next_key, groups, self.key_group)


def concurrent_generator(n: int, keys: Iterable, gen_fn: Callable):
    return ConcurrentGenerator(n, keys, gen_fn)


# ---------------------------------------------------------------------------
# Checker
# ---------------------------------------------------------------------------

def history_keys(history: list) -> list:
    """All keys appearing in lifted op values, in first-seen order."""
    seen = []
    ss = set()
    for o in history:
        v = o.get("value")
        if is_tuple(v) and v.key not in ss:
            ss.add(v.key)
            seen.append(v.key)
    return seen


def subhistory(k, history: list) -> list:
    """The history restricted to key k: lifted ops for k unwrapped;
    un-lifted ops (nemesis &c) retained."""
    out = []
    for o in history:
        v = o.get("value")
        if is_tuple(v):
            if v.key == k:
                out.append({**o, "value": v.value})
        else:
            out.append(o)
    return out


def native_split_enabled() -> bool:
    """One home for the JEPSEN_TPU_NATIVE_SPLIT gate (default on) so
    the register sweep and the bench's reporting can't drift apart:
    `=0` pins the pure-Python relift+subhistories splitter."""
    from . import gates

    return gates.get("JEPSEN_TPU_NATIVE_SPLIT")


def _subhistories_from_ids(history: list, key_ids, keys: list) -> dict:
    """subhistories() driven by a precomputed per-op key-id array (the
    native splitter's output): identical per-key lists, but the per-op
    lift heuristics, Tuple construction and relift dict copies are
    gone — only the one unavoidable value-unwrap copy per lifted op
    remains. `key_ids[i]` is the key id of history[i]'s lifted value
    (-1 un-lifted); `keys` maps ids to key values in first-seen order."""
    subs: dict = {}
    unlifted: list = []
    get = subs.get
    for o, kid in zip(history, key_ids):
        if kid >= 0:
            k = keys[kid]
            lst = get(k)
            if lst is None:
                lst = subs[k] = list(unlifted)
            d = o.copy()
            d["value"] = o["value"][1]
            lst.append(d)
        else:
            unlifted.append(o)
            for lst in subs.values():
                lst.append(o)
    return subs


def subhistories_path(history: list, path, stats: dict | None = None) -> dict:
    """`subhistories(relift_history(history))` for a history loaded
    from `path` (a history.jsonl), accelerated by the native per-key
    splitter (csrc/hist_encode.cc's jt_ks_* pass) when it applies —
    the register-sweep splitter moved out of the per-op Python loop.
    Falls back to the pure-Python pipeline whenever the native side
    declines the file, the JEPSEN_TPU_NATIVE_SPLIT gate is off, or the
    id array doesn't align with `history` (e.g. the caller loaded a
    different/edited file). `stats`, when given, counts which path
    ACTUALLY ran per call ("native"/"python") so reporters can't
    mistake availability for use."""
    use_native = native_split_enabled()
    if use_native:
        # the cost-aware planner may DECLINE native for histories
        # below its fitted threshold (it can never force native on
        # past the user's gate pin); both splitters produce identical
        # per-key lists, so the tier choice moves only time
        from . import planner as _planner
        pl = _planner.get()
        if pl is not None and not pl.split_native(len(history)):
            use_native = False
    if use_native:
        from . import native_lib
        got = native_lib.split_key_ids(path)
        if got is not None:
            keys, key_ids = got
            if len(key_ids) == len(history):
                if stats is not None:
                    stats["native"] = stats.get("native", 0) + 1
                trace.counter("split.native").inc()
                return _subhistories_from_ids(history, key_ids.tolist(),
                                              keys)
            # benign: the caller loaded an edited/different file than
            # the one on disk — a documented fallback, not a broken lib
            native_lib.count_fallback("split_key_ids")
    if stats is not None:
        stats["python"] = stats.get("python", 0) + 1
    trace.counter("split.python").inc()
    return subhistories(relift_history(history))


def subhistories(history: list) -> dict:
    """Every key's subhistory in ONE pass — identical per-key lists to
    subhistory(k, ...) but O(ops + keys·unlifted) instead of the
    per-key scan's O(keys·ops). Keys appear in first-seen order;
    un-lifted ops land in every key's list, including keys first seen
    later (their list starts with the un-lifted prefix so far, exactly
    as the per-key filter has it)."""
    subs: dict = {}
    unlifted: list = []
    for o in history:
        v = o.get("value")
        if is_tuple(v):
            lst = subs.get(v.key)
            if lst is None:
                lst = subs[v.key] = list(unlifted)
            lst.append({**o, "value": v.value})
        else:
            unlifted.append(o)
            for lst in subs.values():
                lst.append(o)
    return subs


class IndependentChecker(Checker):
    """Check each key's subhistory with the sub-checker
    (independent.clj:451-502).

    If the sub-checker has `check_batch(test, histories, opts)`, every
    subhistory goes down in one batched device dispatch; otherwise the
    keys fan out over a bounded thread pool (`util.bounded_pmap`), as
    the reference's bounded-pmap does. Each key's results.edn and
    history.edn land under `independent/<key>/` in the run dir.

    When the batch raises, every key is re-checked alone through
    `check_safe` — except a failure no verdict may hide
    (`supervisor.must_end_sweep`: a kernel build or launch failure, a
    missing device, a CUDA error), which raises. The reference turns
    those into per-key checks too."""

    def __init__(self, sub: Checker):
        self.sub = sub

    @staticmethod
    def _sub_opts(opts: dict, k) -> dict:
        """Per-key opts: nest artifact output under independent/<key> so
        store-writing sub-checkers (timeline, linear.svg, elle/) don't
        clobber each other across keys (independent.clj:474-478)."""
        base = opts.get("subdirectory")
        base = ([base] if isinstance(base, str) else list(base or []))
        return {**opts, "subdirectory": base + ["independent", str(k)],
                "history-key": k}

    def _persist_key(self, test: dict, opts: dict, k, sub: list,
                     result: dict) -> None:
        """Write per-key results.edn + history.edn (independent.clj:480-488)."""
        store = test.get("store")
        if store is None:
            return
        from . import edn, history as h
        from .store import _results_to_edn
        sub_opts = self._sub_opts(opts, k)
        d = store.path(test, *sub_opts["subdirectory"], "results.edn")
        d.write_text(edn.dumps(_results_to_edn(result)) + "\n")
        d.parent.joinpath("history.edn").write_text(h.history_to_edn(sub))

    def check(self, test, history, opts):
        opts = opts or {}
        with trace.span("independent.split", ops=len(history)):
            by_key = subhistories(history)
        ks = list(by_key)
        subs = [by_key[k] for k in ks]
        if hasattr(self.sub, "check_batch"):
            # Batch checkers get the shared opts (one device dispatch, no
            # per-key namespacing) and so must not write store artifacts
            # themselves; per-key results/history are persisted below.
            try:
                with trace.span("independent.check_batch", keys=len(ks)):
                    results = self.sub.check_batch(test, subs, opts)
            except Exception as e:
                from .supervisor import must_end_sweep
                if must_end_sweep(e):
                    raise
                results = [check_safe(self.sub, test, s,
                                      self._sub_opts(opts, k))
                           for k, s in zip(ks, subs)]
        else:

            def _one(ks_):
                k, s = ks_
                with trace.span("independent.key", key=str(k)):
                    return check_safe(self.sub, test, s,
                                      self._sub_opts(opts, k))

            results = bounded_pmap(_one, list(zip(ks, subs)))
        # Batch-dispatched sub-checkers never see per-key opts, so any
        # per-failure artifact (e.g. linear.svg) is rendered here, where
        # the per-key subdirectory is known.
        render = getattr(self.sub, "render_failure", None)
        if render is not None:
            for k, s, r in zip(ks, subs, results):
                if r.get("valid?") is False:
                    try:
                        render(test, s, r, self._sub_opts(opts, k))
                    except Exception:
                        log.warning("failure render for key %r failed",
                                    k, exc_info=True)
        for k, s, r in zip(ks, subs, results):
            try:
                self._persist_key(test, opts, k, s, r)
            except Exception:
                log.warning("couldn't persist results for key %r",
                            k, exc_info=True)
        result_map = dict(zip(ks, results))
        failures = [k for k, r in result_map.items()
                    if r.get("valid?") is False]
        return {
            "valid?": merge_valid(
                [r.get("valid?", True) for r in results] or [True]),
            "results": result_map,
            "failures": failures,
        }


def checker(sub: Checker) -> Checker:
    return IndependentChecker(sub)
