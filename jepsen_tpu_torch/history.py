"""The op model: the part of `jepsen_tpu/history.py` the port's encoders,
store loader and linearizability checker use.

An operation is a plain dict with "type" ("invoke" | "ok" | "fail" |
"info"), "process", "f", "value", "time" and "index"; a history is a
list of them in real-time order.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

from .edn import loads_all

Op = dict  # documentation alias

INVOKE, OK, FAIL, INFO = "invoke", "ok", "fail", "info"


def is_invoke(o: Op) -> bool:
    return o.get("type") == INVOKE


def is_ok(o: Op) -> bool:
    return o.get("type") == OK


def is_fail(o: Op) -> bool:
    return o.get("type") == FAIL


def is_info(o: Op) -> bool:
    return o.get("type") == INFO


def is_client_op(o: Op) -> bool:
    """Client ops have integer processes; the nemesis and other internal
    actors use named processes."""
    return isinstance(o.get("process"), int)


def index(history: list[Op]) -> list[Op]:
    """Return a history whose ops all carry an :index equal to their
    position. Ops that already have the right index are reused."""
    out = []
    for i, o in enumerate(history):
        if o.get("index") != i:
            o = {**o, "index": i}
        out.append(o)
    return out


def op_from_edn_map(m: dict) -> Op:
    """Convert a parsed EDN op map (Keyword keys) into a plain-string op."""
    o: Op = {}
    for k, v in m.items():
        o[str(k)] = v
    return o


def history_from_edn(text: str) -> list[Op]:
    """Parse a history.edn file (one op map per top-level form)."""
    return [op_from_edn_map(m) for m in loads_all(text)]


def pairs(history: Iterable[Op]) -> Iterator[tuple[Op, Op | None]]:
    """Yield (invocation, completion|None) pairs, in invocation order.

    A completion is the next op by the same process after its invocation.
    Invocations with no completion (still pending at history end) yield
    (invoke, None). Non-invoke ops without a prior invocation (e.g. nemesis
    :info ops) yield (op, None) as well.
    """
    pending: dict[Any, Op] = {}
    order: list[Op] = []
    completion: dict[int, Op] = {}
    for o in history:
        p = o.get("process")
        if is_invoke(o):
            pending[p] = o
            order.append(o)
        elif p in pending:
            completion[id(pending.pop(p))] = o
        else:
            order.append(o)
    for o in order:
        yield o, completion.get(id(o))


def complete(history: list[Op]) -> list[Op]:
    """Rewrite a history so (a) every invocation completed by an :ok op
    carries the completion's :value (reads know what they returned), and
    (b) every :info completion with a nil value inherits its invocation's
    value (an indeterminate write still says *what* it may have written) —
    knossos.history/complete's semantics."""
    out: list[Op] = [dict(o) for o in history]
    pending: dict[Any, Op] = {}  # process -> invocation (from out)
    for o in out:
        p = o.get("process")
        if is_invoke(o):
            pending[p] = o
        elif p in pending:
            inv = pending.pop(p)
            if is_ok(o):
                inv["value"] = o.get("value")
            elif is_info(o) and o.get("value") is None:
                o["value"] = inv.get("value")
    return out


def client_ops(history: Iterable[Op]) -> list[Op]:
    return [o for o in history if is_client_op(o)]


def remove_failures(history: list[Op]) -> list[Op]:
    """Drop invocations that definitely failed, plus their :fail completions.
    :info (indeterminate) ops are preserved — they may have happened."""
    failed: set[int] = set()
    for inv, comp in pairs(history):
        if comp is not None and is_fail(comp):
            failed.add(id(inv))
            failed.add(id(comp))
    return [o for o in history if id(o) not in failed and not is_fail(o)]
