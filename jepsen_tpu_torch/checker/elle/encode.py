"""History → tensor encoder for list-append analysis.

The port's own copy of `jepsen_tpu/checker/elle/encode.py` (the pure
Python encoder; the native `hist_encode.cc` path is not ported). It is
the replacement for the Clojure reference's `txn/` micro-op
parser (txn/src/jepsen/txn.clj) plus the version-order inference inside
Elle's list-append checker: the host-side "tokenizer" that digests ragged
mop lists once, detects every anomaly that needs raw list data
(G1a/G1b/internal/duplicates/incompatible-order/dirty-update), and emits
compact integer tensors from which the device kernels build ww/wr/rw
dependency edges and run cycle detection.

Key design fact (why the tensors are small): in list-append, every
successful read of key k returns a *prefix* of k's final append order. So
once version orders are inferred, a read is fully described by the
*length* of the list it saw (= the version position of its last element),
and an append by the *position* of its value. Edge construction then needs
only (txn, key, pos) triples — no ragged data on device.

Versions are 1-based; position 0 is the initial empty list. Position -1
marks appends never observed by any read (unordered; they generate no
edges).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ... import history as h
from . import txn as t

OK, INFO, FAIL = 0, 1, 2  # txn status codes

# Completion index base for indeterminate txns in realtime ordering: they
# never completed, so nothing can be realtime-after them. Each info row
# gets NEVER_COMPLETED + row so completion keys stay *distinct* (the
# device kernel's successor-by-min formulation and the CPU oracle's stable
# sort must agree on process order between two crashed txns). Base + row
# fits in int32 so values survive JAX's int64->int32 cast without x64.
NEVER_COMPLETED = np.int64(2**30)


def effective_complete_index(status: np.ndarray,
                             complete_index: np.ndarray) -> np.ndarray:
    """Completion keys for ordering: real index for committed txns, a
    distinct beyond-everything key for indeterminate ones."""
    rows = np.arange(len(status), dtype=np.int64)
    return np.where(status == INFO, NEVER_COMPLETED + rows, complete_index)


@dataclass
class EncodedHistory:
    """One history's worth of device-ready facts + host-detected anomalies."""

    n: int = 0                      # graph txns (committed + indeterminate)
    n_keys: int = 0
    max_pos: int = 0                # longest version chain over all keys
    # (txn_row, key, pos) triples; pos semantics per module docstring.
    appends: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.int32))
    # (txn_row, key, pos-of-last-element) triples for external reads.
    reads: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.int32))
    status: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))      # OK | INFO
    process: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    invoke_index: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    complete_index: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    op_index: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))      # witness mapping
    # Host-detected anomalies: name -> list of witness dicts.
    anomalies: dict = field(default_factory=dict)
    # key id -> original key, row -> completion op (for witnesses/debug)
    key_names: list = field(default_factory=list)
    txn_ops: list = field(default_factory=list)


def _note(anomalies: dict, name: str, witness: dict) -> None:
    anomalies.setdefault(name, []).append(witness)


def lean_anomalies(enc: EncodedHistory) -> dict:
    """Witnesses reduced to the environment-independent lean shape the
    native ingest (native/hist_encode.cc) emits — ints and key names
    only, no op dicts. Same anomaly names, counts, and order either
    way, so persisted batch-sweep artifacts don't depend on which
    encoder ran (the Python path's full witnesses embed op dicts the
    native path never materializes). Call BEFORE dropping txn_ops:
    rows are recovered from witness-op identity."""
    if not enc.anomalies:       # clean history: skip the row-map build
        return {}
    row_of = {id(op): r for r, op in enumerate(enc.txn_ops)}

    def row(w, k="op"):
        return row_of.get(id(w.get(k)), -1)

    out: dict = {}
    for name, wits in enc.anomalies.items():
        lw = []
        for w in wits:
            if name == "duplicate-appends":
                lw.append({"key": w["key"], "value": w["value"],
                           "row": row(w)})
            elif name == "internal":
                lw.append({"row": row(w), "key": w["mop"][1]})
            elif name == "duplicate-elements":
                lw.append({"key": w["key"], "row": row(w)})
            elif name == "incompatible-order":
                lw.append({"key": w["key"], "row": row(w, "b-op")})
            elif name in ("G1a", "dirty-update"):
                writer = w.get("writer") or {}
                lw.append({"key": w["key"], "value": w["value"],
                           "writer-index": writer.get("index", -1)})
            elif name == "G1b":
                lw.append({"key": w["key"], "row": row(w)})
            elif name == "phantom-read":
                lw.append({"key": w["key"], "value": w["value"]})
            else:  # unknown anomaly class: pass through untouched
                lw.append(w)
        out[name] = lw
    return out


def _check_internal(txn: list, op: dict, anomalies: dict) -> None:
    """Within-txn consistency: a read must reflect the txn's own prior
    reads and appends on that key (Elle's :internal anomaly)."""
    known: dict = {}     # key -> exact list the txn must now observe
    appended: dict = {}  # key -> own appends before the first read of key
    for mf, k, v in txn:
        if mf == "r":
            if v is None:
                continue
            v = list(v)
            if k in known:
                if v != known[k]:
                    _note(anomalies, "internal",
                          {"op": op, "mop": ["r", k, v],
                           "expected": known[k]})
            elif k in appended:
                suffix = appended[k]
                if v[len(v) - len(suffix):] != suffix:
                    _note(anomalies, "internal",
                          {"op": op, "mop": ["r", k, v],
                           "expected": ["..."] + suffix})
            known[k] = v
            appended.pop(k, None)
        else:
            if k in known:
                known[k] = known[k] + [v]
            else:
                appended.setdefault(k, []).append(v)


def _longest_prefix_order(reads: list[tuple], anomalies: dict, key: Any) -> list:
    """Infer the version order for one key from its observed read lists.
    All reads must be prefixes of the longest; mismatches flag
    :incompatible-order (we keep the longest list as best-effort order)."""
    longest: list = []
    longest_op = None
    for op, v in reads:
        if len(v) > len(longest):
            longest, longest_op = list(v), op
    for op, v in reads:
        if list(v) != longest[: len(v)]:
            _note(anomalies, "incompatible-order",
                  {"key": key, "a": longest, "b": list(v),
                   "a-op": longest_op, "b-op": op})
    return longest


def encode_history(history: list[dict]) -> EncodedHistory:
    """Digest a list-append history into an EncodedHistory."""
    history = h.index(history)
    enc = EncodedHistory()
    anomalies = enc.anomalies

    # --- pair invocations with completions; bucket txns by fate ----------
    # (fused single-pass pairing + filtering, shared with the wr
    # encoder — t.bucket_txn_pairs)
    committed, indeterminate, failed = t.bucket_txn_pairs(history)

    # --- key interning ----------------------------------------------------
    key_ids: dict = {}

    def kid(k: Any) -> int:
        i = key_ids.get(k)
        if i is None:
            i = len(key_ids)
            key_ids[k] = i
            enc.key_names.append(k)
        return i

    # --- graph txn rows: committed first, then indeterminate -------------
    rows: list[dict] = []   # row facts
    for inv, comp in committed:
        txn = t.mops(comp)
        rows.append({"txn": txn, "status": OK, "inv": inv,
                     "op": comp, "wbk": t.writes_by_key(txn)})
    for inv in indeterminate:
        txn = t.mops(inv)
        rows.append({"txn": txn, "status": INFO, "inv": inv,
                     "op": inv, "wbk": t.writes_by_key(txn)})
    enc.n = len(rows)

    # --- writer index: (key, value) -> row --------------------------------
    writer_of: dict = {}
    multi_append: set = set()
    for r_i, row in enumerate(rows):
        for k, vals in row["wbk"].items():
            for v in vals:
                if (k, v) in writer_of:
                    _note(anomalies, "duplicate-appends",
                          {"key": k, "value": v, "op": row["op"]})
                    multi_append.add((k, v))
                else:
                    writer_of[(k, v)] = r_i
    failed_writes: dict = {}
    for inv in failed:
        for k, vals in t.writes_by_key(t.mops(inv)).items():
            for v in vals:
                failed_writes[(k, v)] = inv

    # --- internal consistency + read collection --------------------------
    reads_by_key: dict = {}
    for row in rows:
        if row["status"] != OK:
            continue
        _check_internal(row["txn"], row["op"], anomalies)
        for mf, k, v in row["txn"]:
            if mf == "r" and v is not None:
                reads_by_key.setdefault(k, []).append((row["op"], v))
                # duplicate elements inside one read. The C-speed
                # set(vals) screen is exact for the non-dup case; a
                # suspected dup re-checks with (type, v) pairs so
                # Python's cross-type equality (1 == True == 1.0)
                # can't flag a legitimate [1, True] read. repr stays
                # the fallback for unhashables.
                vals = list(v)
                try:
                    dup = len(vals) != len(set(vals)) and \
                        len(vals) != len({(type(x), x) for x in vals})
                except TypeError:
                    dup = len(vals) != len(set(map(repr, vals)))
                if dup:
                    _note(anomalies, "duplicate-elements",
                          {"key": k, "value": vals, "op": row["op"]})

    # --- version orders ---------------------------------------------------
    version_pos: dict = {}       # (key, value) -> 1-based position
    version_chain: dict = {}     # key -> longest list
    for k, rds in reads_by_key.items():
        order = _longest_prefix_order(rds, anomalies, k)
        version_chain[k] = order
        for i, v in enumerate(order):
            version_pos[(k, v)] = i + 1
        enc.max_pos = max(enc.max_pos, len(order))

    # --- aborted / phantom / dirty observations --------------------------
    for k, order in version_chain.items():
        for i, v in enumerate(order):
            if (k, v) in writer_of:
                continue
            if (k, v) in failed_writes:
                _note(anomalies, "G1a",
                      {"key": k, "value": v, "writer": failed_writes[(k, v)]})
                if i + 1 < len(order):
                    # Committed appends built on top of an aborted write.
                    _note(anomalies, "dirty-update",
                          {"key": k, "value": v,
                           "writer": failed_writes[(k, v)]})
            else:
                _note(anomalies, "phantom-read",
                      {"key": k, "value": v})

    # --- G1b: external reads of intermediate versions ---------------------
    # A txn's non-final append to a key is an intermediate state; any other
    # txn's read ending there observed a state that "never existed".
    intermediate: set = set()
    for row_i, row in enumerate(rows):
        for k, vals in row["wbk"].items():
            for v in vals[:-1]:
                intermediate.add((k, v, row_i))

    # --- emit tensors -----------------------------------------------------
    appends: list[tuple] = []
    reads: list[tuple] = []
    for r_i, row in enumerate(rows):
        for k, vals in row["wbk"].items():
            for v in vals:
                pos = version_pos.get((k, v), -1)
                if (k, v) in multi_append:
                    pos = -1  # ambiguous writer: generates no edges
                appends.append((r_i, kid(k), pos))
        if row["status"] != OK:
            continue
        for k, v in t.ext_reads(row["txn"]).items():
            if v is None:
                continue
            vals = list(v)
            pos = len(vals)
            if vals:
                last = vals[-1]
                if version_pos.get((k, last)) != pos:
                    pos = -1  # incompatible read: no edges from it
                w = writer_of.get((k, last))
                if w is not None and (k, last, w) in intermediate \
                        and w != r_i:
                    _note(anomalies, "G1b",
                          {"key": k, "value": vals, "op": row["op"]})
            reads.append((r_i, kid(k), pos))

    enc.n_keys = len(key_ids)
    enc.appends = np.asarray(appends or np.zeros((0, 3)), np.int32).reshape(-1, 3)
    enc.reads = np.asarray(reads or np.zeros((0, 3)), np.int32).reshape(-1, 3)
    enc.status = np.asarray([r["status"] for r in rows], np.int32)
    enc.process = np.asarray(
        [r["inv"].get("process", -1) if isinstance(r["inv"].get("process"), int)
         else -1 for r in rows], np.int32)
    enc.invoke_index = np.asarray(
        [r["inv"].get("index", -1) for r in rows], np.int64)
    enc.complete_index = np.asarray(
        [r["op"].get("index", -1) for r in rows], np.int64)
    enc.op_index = enc.complete_index
    enc.txn_ops = [r["op"] for r in rows]
    return enc
