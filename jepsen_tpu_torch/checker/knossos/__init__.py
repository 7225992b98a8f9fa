"""Linearizability checking — the Knossos-equivalent engine.

Counterpart of `jepsen_tpu/checker/knossos/__init__.py`. The CPU engines
live here: an iterative Wing-Gong-Lowe search with a
(linearized-set, model-state) memo cache over any `models.Model`
(`_wgl_python`, the oracle), and its C++ twin for a fresh CAS register
or mutex (`_wgl_native`, the port's own build of `csrc/wgl.cc`). The
device engines are `.dense` (the whole configuration grid, the
`knossos_dense_scan` kernel), `.kernels` (a bounded sorted frontier)
and `.packed` (the same frontier, one int32 a configuration).

History semantics follow knossos: a history is completed
(`history.complete`) so ok reads know their returned value; definite
failures are dropped (`history.remove_failures`); `:info` ops may or
may not have taken effect — their linearization point, if any, lies
anywhere after their invocation (a return at infinity; they are never
*required* to linearize).

Verdicts are the reference's dicts, byte for byte once rendered:
`{"valid?": True|False|"unknown", "op-count": N, "analyzer": "wgl", ...}`
with `configs` / `final-paths` cut to 10 entries (lean, empty, from the
native engine).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ... import history as h
from .. import models

MAX_REPORTED = 10  # knossos truncation


@dataclass
class Entry:
    """One call or return event in the WGL doubly-linked entry list."""

    kind: str               # "call" | "return"
    op: dict                # the (completed) invocation op
    op_id: int              # dense id of the operation
    info: bool = False      # indeterminate op (return at infinity)
    match: "Entry | None" = None   # call <-> return link
    prev: "Entry | None" = field(default=None, repr=False)
    next: "Entry | None" = field(default=None, repr=False)


def reduce_history(raw_history: list[dict]) -> list[dict]:
    """The preprocessing every linearizability path shares: client ops
    only, completed (ok reads know their value), definite failures
    dropped."""
    return h.remove_failures(h.complete(h.client_ops(raw_history)))


def prepare(raw_history: list[dict]) -> list[tuple[dict, bool]]:
    """Reduce a raw history to the operations the search linearizes:
    (completed-invocation, indeterminate?) in invocation order."""
    out: list[tuple[dict, bool]] = []
    for inv, comp in h.pairs(reduce_history(raw_history)):
        if not h.is_invoke(inv):
            continue
        out.append((inv, comp is None or h.is_info(comp)))
    return out


def _build_entries(hist: list[dict]) -> tuple[Entry, int, int]:
    """Build the entry list in real-time order from a reduced history:
    calls at invocation positions, returns at completion positions;
    indeterminate ops get no return entry (their return is at
    infinity). Returns (head, op-count, return-count)."""
    calls: dict[Any, Entry] = {}     # process -> open call entry
    head = Entry("head", {}, -1)
    tail = head
    op_id = 0

    def append(e: Entry) -> None:
        nonlocal tail
        e.prev, e.next = tail, None
        tail.next = e
        tail = e

    for o in hist:
        p = o.get("process")
        if h.is_invoke(o):
            e = Entry("call", o, op_id)
            op_id += 1
            calls[p] = e
            append(e)
        elif p in calls:
            call = calls.pop(p)
            if h.is_info(o):
                call.info = True       # return at infinity
            else:
                r = Entry("return", call.op, call.op_id, match=call)
                call.match = r
                append(r)
    # Any never-completed invocations are indeterminate too.
    for call in calls.values():
        call.info = True
    returns = 0
    e = head.next
    while e is not None:
        if e.kind == "return":
            returns += 1
        e = e.next
    return head, op_id, returns


@dataclass
class _Frame:
    entry: Entry
    state: Any


def _unlift(e: Entry) -> None:
    e.prev.next = e
    if e.next is not None:
        e.next.prev = e


def _lift(e: Entry) -> None:
    e.prev.next = e.next
    if e.next is not None:
        e.next.prev = e.prev


def wgl(model: models.Model, raw_history: list[dict],
        max_configs: int = 10_000_000) -> dict:
    """Wing-Gong-Lowe linearizability search with memoization.

    Walks the entry list looking for a call to linearize next; lifting a
    call applies it to the model and removes call+return; hitting a
    return whose call is unlinearized forces a backtrack. A cache of
    (linearized-bitmask, model-state) prunes re-exploration. Valid when
    no return entries remain; indeterminate ops may be left
    unlinearized. "unknown" when the config cache exceeds
    `max_configs`.

    A fresh CAS register or mutex goes to the C++ twin of this search
    (`_wgl_native`: same walk, same cache discipline, same verdicts,
    lean witnesses); every other model, and a history the native
    encoder declines, takes the Python engine."""
    if type(model) is models.CASRegister and model.value is None:
        res = _wgl_native(raw_history, max_configs, "cas")
        if res is not None:
            return res
    elif type(model) is models.Mutex and model.locked is False:
        res = _wgl_native(raw_history, max_configs, "mutex")
        if res is not None:
            return res
    return _wgl_python(model, raw_history, max_configs)


def _wgl_native(raw_history: list[dict], max_configs: int,
                model_kind: str = "cas") -> dict | None:
    """Run the native WGL (CAS register or mutex); None -> use the
    Python engine (an unencodable history or un-internable values). The
    library is the port's build of `csrc/wgl.cc`; a build that cannot
    happen raises KernelBuildError."""
    import ctypes

    import numpy as np

    from ... import _build
    from . import encode as kenc

    L = _build.load("wgl")
    try:
        if model_kind == "mutex":
            ev, model_id = kenc.encode_mutex_history(raw_history), 1
        else:
            # the C++ search has no slot limit, unlike the device
            # kernels: a far larger budget than their 24
            ev = kenc.encode_register_history(
                raw_history, max_slots=4096).events
            model_id = 0
    except (kenc.EncodingError, TypeError):
        return None
    ev = np.ascontiguousarray(ev, np.int32)
    out = (ctypes.c_int64 * 5)()
    L.jt_wgl_run(ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                 ev.shape[0], max_configs, model_id, out)
    verdict, n, depth, fail_op, _cache = out
    if n == 0:
        return {"valid?": True, "op-count": 0, "analyzer": "wgl"}
    if verdict == 1:
        return {"valid?": True, "op-count": int(n), "analyzer": "wgl",
                "max-depth": int(depth), "final-paths": []}
    if verdict == 2:
        return {"valid?": "unknown", "op-count": int(n),
                "analyzer": "wgl", "cause": ":config-cache-exhausted",
                "configs": []}
    op: Any = int(fail_op)
    if 0 <= fail_op:        # recover the op dict for the witness
        pairs = prepare(raw_history)
        if fail_op < len(pairs):
            op = pairs[int(fail_op)][0]
    return {"valid?": False, "op-count": int(n), "analyzer": "wgl",
            "op": op, "max-depth": int(depth),
            "final-paths": [], "configs": []}


def _wgl_python(model: models.Model, raw_history: list[dict],
                max_configs: int = 10_000_000) -> dict:
    """The pure-Python WGL engine (any model; the oracle)."""
    hist = reduce_history(raw_history)
    head, n, returns_left = _build_entries(hist)
    if n == 0:
        return {"valid?": True, "op-count": 0, "analyzer": "wgl"}

    state: Any = model
    linearized = 0
    cache: set[tuple[int, Any]] = {(0, state)}
    stack: list[_Frame] = []
    best_depth = 0

    def backtrack() -> Entry | None:
        nonlocal returns_left, linearized, state
        frame = stack.pop()
        e2 = frame.entry
        _unlift(e2)
        if e2.match is not None:
            _unlift(e2.match)
            returns_left += 1
        linearized &= ~(1 << e2.op_id)
        state = frame.state
        return e2.next

    entry = head.next
    while returns_left > 0:
        if entry is None:
            # Walked past every remaining entry without finding a return:
            # cannot happen while returns remain, but guard for safety.
            if not stack:
                break
            entry = backtrack()
            continue
        if entry.kind == "call":
            s2 = state.step(entry.op)
            key = (linearized | (1 << entry.op_id), s2)
            if not models.is_inconsistent(s2) and key not in cache:
                if len(cache) >= max_configs:
                    return {"valid?": "unknown", "op-count": n,
                            "analyzer": "wgl",
                            "cause": ":config-cache-exhausted",
                            "configs": [_config_map(state, linearized)]}
                cache.add(key)
                stack.append(_Frame(entry, state))
                _lift(entry)
                if entry.match is not None:
                    _lift(entry.match)
                    returns_left -= 1
                state = s2
                linearized |= 1 << entry.op_id
                best_depth = max(best_depth, bin(linearized).count("1"))
                entry = head.next
            else:
                entry = entry.next
        else:
            # A completed op we failed to linearize before its return.
            if not stack:
                return {"valid?": False, "op-count": n, "analyzer": "wgl",
                        "op": entry.op,
                        "max-depth": best_depth,
                        "final-paths": _final_paths(stack),
                        "configs": [_config_map(state, linearized)]}
            entry = backtrack()

    return {"valid?": True, "op-count": n, "analyzer": "wgl",
            "max-depth": best_depth,
            "final-paths": _final_paths(stack)}


def _config_map(state: Any, linearized: int) -> dict:
    return {"model": repr(state),
            "linearized-count": bin(linearized).count("1")}


def _final_paths(stack: list[_Frame]) -> list[dict]:
    path = [{"op": f.entry.op, "model": repr(f.state)} for f in stack]
    return path[-MAX_REPORTED:]


def analysis(model: models.Model, raw_history: list[dict],
             algorithm: str = "wgl", **kw: Any) -> dict:
    """Entry point matching knossos.{wgl,linear,competition}/analysis.
    On the CPU every algorithm name routes to the WGL engine (the
    `linear`-style configuration search is the device path, see
    `.dense` and `.kernels`)."""
    if algorithm not in ("wgl", "linear", "competition"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return wgl(model, raw_history, **kw)
