"""Transaction micro-op (mop) helpers.

Counterpart of the reference's `txn/` subproject (txn/src/jepsen/txn.clj):
transactions are op :values of the form [[f k v] ...] where f is "append"
or "r" for list-append workloads, "w"/"r" for rw-register workloads.

The port's own copy of `jepsen_tpu/checker/elle/txn.py`: `encode.py`
builds on these to translate ragged mop lists into fixed-width integer
tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable


def mops(op: dict) -> list:
    """The micro-ops of a txn op (empty list for nil values)."""
    v = op.get("value")
    return v if isinstance(v, (list, tuple)) else []


def is_txn_op(op: dict) -> bool:
    """Does this op's value look like a transaction (a list of [f k v]
    micro-ops)?"""
    v = op.get("value")
    if not isinstance(v, (list, tuple)):
        return False
    return all(isinstance(m, (list, tuple)) and len(m) == 3 for m in v)


def bucket_txn_pairs(history: Iterable[dict]
                     ) -> tuple[list, list, list]:
    """Pair txn invocations with their completions in ONE pass and
    bucket them by fate: -> (committed [(inv, ok-comp)...],
    indeterminate [inv...], failed [inv...]), each in invocation
    order. The fused equivalent of h.pairs() + is_invoke/is_client_op/
    is_txn_op filtering — this touches every op of a history and sits
    on the analyze-store/north-star ingest critical path, so both elle
    encoders share it. Expects an indexed history (h.index) so the
    order-restoring sorts have keys."""
    committed: list = []
    indeterminate: list = []
    failed: list = []
    pending: dict = {}                          # process -> txn invoke
    for o in history:
        ty = o.get("type")
        p = o.get("process")
        if ty == "invoke":
            # a new invoke by p supersedes a still-open one (malformed
            # histories only) — the old invoke never completed, so it
            # stays visible as indeterminate, as h.pairs() has it
            stale = pending.pop(p, None)
            if stale is not None:
                indeterminate.append(stale)
            if isinstance(p, int) and is_txn_op(o):
                pending[p] = o
            continue
        inv = pending.pop(p, None)
        if inv is None:
            continue
        if ty == "ok":
            committed.append((inv, o))
        elif ty == "fail":
            failed.append(inv)
        elif ty == "info":                      # crashed
            indeterminate.append(inv)
        # any other completion type: malformed — the invocation is
        # consumed but bucketed nowhere, exactly as the h.pairs()
        # formulation had it
    indeterminate.extend(pending.values())      # open at history end
    # strict ["index"]: an unindexed history would otherwise sort into
    # silent completion-order row numbering — fail loudly instead
    _inv_idx = lambda o: o["index"]
    committed.sort(key=lambda pair: _inv_idx(pair[0]))
    indeterminate.sort(key=_inv_idx)
    failed.sort(key=_inv_idx)
    return committed, indeterminate, failed


def reduce_mops(f: Callable, init: Any, history: Iterable[dict]) -> Any:
    """Fold f(state, op, [mf, k, v]) over every micro-op of every op
    (txn.clj:5-17)."""
    state = init
    for op in history:
        for mop in mops(op):
            state = f(state, op, mop)
    return state


def ext_reads(txn: list) -> dict:
    """Keys to values for a txn's external reads: values observed that the
    txn did not itself write first (txn.clj:19-34). Only the first access
    to a key counts; later reads see the txn's own effects."""
    ext: dict = {}
    seen: set = set()
    for mf, k, v in txn:
        if mf == "r" and k not in seen:
            ext[k] = v
        seen.add(k)
    return ext


def ext_writes(txn: list) -> dict:
    """Keys to final written values for a txn's external writes
    (txn.clj:36-47). For append txns the 'write' is the last appended
    element."""
    ext: dict = {}
    for mf, k, v in txn:
        if mf != "r":
            ext[k] = v
    return ext


def writes_by_key(txn: list) -> dict:
    """Key -> list of values written/appended by this txn, in order."""
    out: dict = {}
    for mf, k, v in txn:
        if mf != "r":
            out.setdefault(k, []).append(v)
    return out
