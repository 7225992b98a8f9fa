"""Independent keys: op values lifted to `[k v]` tuples, and the per-key
split of a history.

The checker-side part of `jepsen_tpu/independent.py` (the reference's
jepsen.independent): `Tuple` and its helpers, `relift_history` (which
re-lifts values a JSON round trip turned into plain two-element lists),
and the per-key split `subhistory` / `subhistories`. The generators,
the native splitter and the independent checker are not ported.
"""

from __future__ import annotations

from typing import Any


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
