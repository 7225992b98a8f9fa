"""The op model: the part of `jepsen_tpu/history.py` the port's encoder
and store loader use.

An operation is a plain dict with "type" ("invoke" | "ok" | "fail" |
"info"), "process", "f", "value", "time" and "index"; a history is a
list of them in real-time order.
"""

from __future__ import annotations

from .edn import loads_all

Op = dict  # documentation alias


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
