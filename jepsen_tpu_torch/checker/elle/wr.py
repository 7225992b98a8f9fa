"""Elle rw-register analysis: write/read register transactions.

The port's own copy of `jepsen_tpu/checker/elle/wr.py`: the encoder,
the verdict and the single-run `WrChecker` (the batch sweep applies
`WR_PROHIBITED`, its default prohibited set). Op values are
transactions of [f k v] micro-ops with f in {"r","w"}; writes are
assumed unique per key.

Unlike list-append, a register read reveals only the *latest* value, so
version orders are not observable directly; they are inferred per key as
a constraint graph over values from configurable sources:

  initial            None (unwritten) precedes every value
  wfr_keys           within a txn, writes follow reads: ext-read value
                     precedes values the same txn writes to that key
  sequential_keys    each key is sequentially consistent: one process's
                     successive ext-writes to a key are ordered
  linearizable_keys  each key is linearizable: realtime-ordered ext-writes
                     (w1's txn completed before w2's invoked) are ordered

A cyclic constraint graph is itself an anomaly ("cyclic-versions",
valid? false). From the (acyclic) version graph's transitive reduction we
derive dependency edges between txns:

  ww  writer(v1) -> writer(v2)        for v1 -> v2 adjacent versions
  wr  writer(v)  -> ext-reader of v   (exact: writes are unique)
  rw  ext-reader of v1 -> writer(v2)  for v1 -> v2 adjacent versions

Cycle search + classification then runs on the device over explicit
edge matrices (`kernels.check_edge_batch`, bucketed for many histories
by `kernels.check_edge_batch_bucketed`), or on the host oracle
(`graph.classify_cycles`) with backend "cpu". `kernels` and torch are
imported where used: the ingest pool's workers import this module.

Host-detected anomalies: internal (txn observes state inconsistent with
its own prior reads/writes), G1a (read of a failed txn's write), G1b
(read of an intermediate write), and cyclic-versions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from ... import history as h
from .. import Checker
from . import graph as g
from . import txn as t
from .encode import INFO, OK, NEVER_COMPLETED, _note, \
    effective_complete_index

# Sentinel for the initial (unwritten) register state in version graphs.
INIT = object()


@dataclass
class WrEncoded:
    """One rw-register history digested to txn rows + dependency edges."""

    n: int = 0
    edges: list = field(default_factory=list)    # (src, dst, g.WW|WR|RW)
    status: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    process: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    invoke_index: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    complete_index: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    anomalies: dict = field(default_factory=dict)
    txn_ops: list = field(default_factory=list)
    key_count: int = 0


def to_edge_dict(enc: WrEncoded) -> dict:
    """The packed-edge form kernels.check_edge_batch consumes."""
    return {"n": enc.n, "edges": enc.edges,
            "invoke_index": enc.invoke_index,
            "complete_index": enc.complete_index,
            "process": enc.process}


def ext_reads(txn: list) -> dict:
    """key -> value for reads that observe *external* state: the first
    read of a key at a point where the txn has not yet written it."""
    written: set = set()
    out: dict = {}
    for f, k, v in txn:
        if f == "w":
            written.add(k)
        elif k not in written and k not in out:
            out[k] = v
    return out


def ext_writes(txn: list) -> dict:
    """key -> value of the txn's last write to each key (the state it
    leaves behind)."""
    out: dict = {}
    for f, k, v in txn:
        if f == "w":
            out[k] = v
    return out


def _check_internal(txn: list, op: dict, anomalies: dict) -> None:
    """Register semantics: a read of k must return the txn's latest prior
    write/read of k, if any."""
    state: dict = {}
    for f, k, v in txn:
        if f == "w":
            state[k] = v
        else:
            if k in state and state[k] != v:
                _note(anomalies, "internal",
                      {"op": op, "mop": ["r", k, v], "expected": state[k]})
            state[k] = v


def _toposort(nodes: list, adj: dict) -> list | None:
    """Kahn topological order, or None if cyclic."""
    indeg = {u: 0 for u in nodes}
    for u in nodes:
        for v in adj.get(u, ()):
            indeg[v] += 1
    queue = [u for u in nodes if indeg[u] == 0]
    out = []
    while queue:
        u = queue.pop()
        out.append(u)
        for v in adj.get(u, ()):
            indeg[v] -= 1
            if indeg[v] == 0:
                queue.append(v)
    return out if len(out) == len(nodes) else None


def _transitive_reduction(nodes: list, adj: dict) -> dict:
    """Adjacent-version edges of a small DAG: drop u->v when another
    path u->..->v exists. O(V*E) DFS per node; per-key version graphs
    are small (one node per written value)."""
    reach: dict = {}

    def dfs(u):
        if u in reach:
            return reach[u]
        acc = set()
        reach[u] = acc  # placeholder breaks accidental cycles defensively
        for v in adj.get(u, ()):
            acc.add(v)
            acc |= dfs(v)
        reach[u] = acc
        return acc

    out: dict = {}
    for u in nodes:
        direct = set(adj.get(u, ()))
        redundant = set()
        for v in direct:
            for w in direct:
                if w != v and v in dfs(w):
                    redundant.add(v)
        out[u] = direct - redundant
    return out


def lean_wr_anomalies(enc: WrEncoded) -> dict:
    """Witnesses reduced to the environment-independent lean shape the
    native wr ingest (native/hist_encode.cc) emits — the rw-register
    sibling of encode.lean_anomalies, same contract: same names,
    counts, and order, no op dicts, so persisted wr-sweep artifacts
    don't depend on which encoder ran. Call BEFORE dropping txn_ops."""
    if not enc.anomalies:
        return {}
    row_of = {id(op): r for r, op in enumerate(enc.txn_ops)}

    def row(w):
        return row_of.get(id(w.get("op")), -1)

    out: dict = {}
    for name, wits in enc.anomalies.items():
        lw = []
        for w in wits:
            if name == "internal":
                lw.append({"row": row(w), "key": w["mop"][1]})
            elif name == "G1a":
                writer = w.get("writer") or {}
                lw.append({"key": w["key"], "value": w["value"],
                           "writer-index": writer.get("index", -1),
                           "row": row(w)})
            elif name in ("duplicate-writes", "phantom-read", "G1b"):
                lw.append({"key": w["key"], "value": w["value"],
                           "row": row(w)})
            elif name == "cyclic-versions":
                lw.append({"key": w["key"]})
            else:  # unknown anomaly class: pass through untouched
                lw.append(w)
        out[name] = lw
    return out


def encode_wr_history(history: list[dict], *, sequential_keys: bool = False,
                      linearizable_keys: bool = False,
                      wfr_keys: bool = False) -> WrEncoded:
    """Digest an rw-register history into txn rows + dependency edges."""
    history = h.index(history)
    enc = WrEncoded()
    anomalies = enc.anomalies

    # fused single-pass pairing + filtering (t.bucket_txn_pairs, the
    # same ingest-critical-path hot loop the append encoder uses)
    committed, indeterminate, failed = t.bucket_txn_pairs(history)

    rows: list[dict] = []
    for inv, comp in committed:
        rows.append({"txn": t.mops(comp), "status": OK, "inv": inv,
                     "op": comp})
    for inv in indeterminate:
        rows.append({"txn": t.mops(inv), "status": INFO, "inv": inv,
                     "op": inv})
    enc.n = len(rows)

    # --- writer index + per-txn intermediate writes ----------------------
    writer_of: dict = {}           # (k, v) -> row
    writers_by_key: dict = {}      # k -> {v: row}
    intermediate: set = set()      # (k, v, row): non-final write of row
    for r_i, row in enumerate(rows):
        per_key: dict = {}
        for f, k, v in row["txn"]:
            if f == "w":
                per_key.setdefault(k, []).append(v)
        for k, vals in per_key.items():
            for v in vals:
                if (k, v) in writer_of:
                    _note(anomalies, "duplicate-writes",
                          {"key": k, "value": v, "op": row["op"]})
                writer_of[(k, v)] = r_i
                writers_by_key.setdefault(k, {})[v] = r_i
            for v in vals[:-1]:
                intermediate.add((k, v, r_i))
    failed_writes: dict = {}
    for inv in failed:
        # every write of a failed txn is aborted state, including
        # intermediate (non-final) ones — reading any of them is G1a
        for f, k, v in t.mops(inv):
            if f == "w":
                failed_writes[(k, v)] = inv

    # --- internal + read collection --------------------------------------
    readers_by_key: dict = {}      # k -> {v: [row, ...]} external readers
    for r_i, row in enumerate(rows):
        if row["status"] != OK:
            continue
        _check_internal(row["txn"], row["op"], anomalies)
        for k, v in ext_reads(row["txn"]).items():
            readers_by_key.setdefault(k, {}).setdefault(v, []).append(r_i)
            if v is None:
                continue
            w = writer_of.get((k, v))
            if w is None:
                if (k, v) in failed_writes:
                    _note(anomalies, "G1a",
                          {"key": k, "value": v, "op": row["op"],
                           "writer": failed_writes[(k, v)]})
                else:
                    _note(anomalies, "phantom-read",
                          {"key": k, "value": v, "op": row["op"]})
            elif (k, v, w) in intermediate and w != r_i:
                _note(anomalies, "G1b",
                      {"key": k, "value": v, "op": row["op"]})

    # --- version graphs per key ------------------------------------------
    complete_idx = effective_complete_index(
        np.asarray([r["status"] for r in rows], np.int32),
        np.asarray([r["op"].get("index", -1) for r in rows], np.int64))
    keys: set = set(writers_by_key) | set(readers_by_key)
    enc.key_count = len(keys)
    version_adj: dict = {}         # key -> {value-node: set(successors)}

    def add_version_edge(k, v1, v2):
        if v1 == v2:
            return
        version_adj.setdefault(k, {}).setdefault(v1, set()).add(v2)

    for k, vals in writers_by_key.items():
        # initial: None precedes every written value
        for v in vals:
            add_version_edge(k, INIT, v)
    for r_i, row in enumerate(rows):
        if wfr_keys:
            er = ext_reads(row["txn"])
            for k, v in ext_writes(row["txn"]).items():
                if k in er and er[k] is not None:
                    add_version_edge(k, er[k], v)
    if sequential_keys:
        by_proc_key: dict = {}
        for r_i, row in enumerate(rows):
            p = row["inv"].get("process")
            for k, v in ext_writes(row["txn"]).items():
                by_proc_key.setdefault((p, k), []).append(
                    (int(complete_idx[r_i]), v))
        for (p, k), writes in by_proc_key.items():
            writes.sort()
            for (_, v1), (_, v2) in zip(writes, writes[1:]):
                add_version_edge(k, v1, v2)
    if linearizable_keys:
        by_key: dict = {}
        for r_i, row in enumerate(rows):
            inv_i = row["inv"].get("index", -1)
            for k, v in ext_writes(row["txn"]).items():
                by_key.setdefault(k, []).append(
                    (int(complete_idx[r_i]), inv_i, v))
        for k, writes in by_key.items():
            writes.sort()
            for i, (c1, _, v1) in enumerate(writes):
                if c1 >= NEVER_COMPLETED:
                    continue
                # every write invoked after v1's txn completed is
                # realtime-after it; transitive reduction compacts chains
                for c2, inv2, v2 in writes[i + 1:]:
                    if inv2 > c1:
                        add_version_edge(k, v1, v2)

    # --- dependency edges from version graphs ----------------------------
    edges: list = []
    for k in sorted(keys, key=repr):
        adj = version_adj.get(k, {})
        key_writers = writers_by_key.get(k, {})
        key_readers = readers_by_key.get(k, {})
        nodes = list({INIT} | set(key_writers) | set(adj))
        if _toposort(nodes, adj) is None:
            _note(anomalies, "cyclic-versions", {"key": k})
            continue
        red = _transitive_reduction(nodes, adj)
        for v1, succs in red.items():
            w1 = key_writers.get(v1) if v1 is not INIT else None
            rds = key_readers.get(v1 if v1 is not INIT else None, [])
            for v2 in succs:
                w2 = key_writers.get(v2)
                if w2 is None:
                    continue
                if w1 is not None and w1 != w2:
                    edges.append((w1, w2, g.WW))
                for rd in rds:
                    if rd != w2:
                        edges.append((rd, w2, g.RW))
        for v, rds in key_readers.items():
            if v is None:
                continue
            w = key_writers.get(v)
            if w is None:
                continue
            for rd in rds:
                if rd != w:
                    edges.append((w, rd, g.WR))
    enc.edges = sorted(set(edges))

    enc.status = np.asarray([r["status"] for r in rows], np.int32)
    enc.process = np.asarray(
        [r["inv"].get("process", -1)
         if isinstance(r["inv"].get("process"), int) else -1
         for r in rows], np.int32)
    enc.invoke_index = np.asarray(
        [r["inv"].get("index", -1) for r in rows], np.int64)
    enc.complete_index = complete_idx
    enc.txn_ops = [r["op"] for r in rows]
    return enc


def cycle_anomalies_cpu(enc: WrEncoded, realtime: bool = False,
                        process_order: bool = False) -> dict:
    edges = enc.edges + g.order_edges(
        enc.n, enc.process, enc.invoke_index, enc.complete_index,
        process_order=process_order, realtime=realtime)
    return g.classify_cycles(enc.n, edges)


def cycle_anomalies_tpu(enc: WrEncoded, realtime: bool = False,
                        process_order: bool = False, device=None,
                        square=None) -> dict:
    """The device path's anomaly flags for one history, on `device`
    (`kernels.check_edge_batch`); `square` replaces the squaring."""
    if enc.n == 0:
        return {}
    from . import kernels
    return kernels.check_edge_batch(
        [to_edge_dict(enc)], device, realtime=realtime,
        process_order=process_order, square=square)[0]


# Anomalies that always invalidate an rw-register history.
ALWAYS_INVALID = frozenset({
    "internal", "cyclic-versions", "dirty-update", "phantom-read",
    "duplicate-writes", "G0",
})

# Specifying an anomaly class prohibits the classes it implies
# (wr.clj:46: "G2 implies G-single and G1c. G1 implies G1a, G1b, and
# G1c. G1c implies G0.").
ANOMALY_EXPANSION = {
    "G0": {"G0"},
    "G1": {"G0", "G1a", "G1b", "G1c"},
    "G1a": {"G1a"},
    "G1b": {"G1b"},
    "G1c": {"G1c", "G0"},
    "G2": {"G2-item", "G-single", "G1c", "G0"},
    "G-single": {"G-single", "G1c", "G0"},
    "G2-item": {"G2-item"},
    "internal": {"internal"},
}


def render_wr_verdict(enc: WrEncoded, cycles: dict,
                      prohibited: frozenset) -> dict:
    """Combine host-detected and cycle anomalies into the rw-register
    verdict."""
    anomalies: dict = dict(enc.anomalies)
    for name, witness in cycles.items():
        if witness is True:
            anomalies[name] = True
        else:
            anomalies[name] = [{"cycle-txns": [
                enc.txn_ops[r] if 0 <= r < len(enc.txn_ops) else r
                for r in witness]}]
    bad = {a for a in anomalies
           if a in prohibited or a in ALWAYS_INVALID}
    if enc.n == 0:
        return {"valid?": "unknown",
                "anomaly-types": ["empty-transaction-graph"],
                "anomalies": {}, "txn-count": 0}
    return {"valid?": not bad,
            "anomaly-types": sorted(anomalies),
            "anomalies": anomalies,
            "txn-count": enc.n,
            "key-count": enc.key_count}


def expand_anomalies(wanted: Iterable[str]) -> frozenset:
    """The prohibited set for anomaly classes `wanted`: each class with
    those it implies (ANOMALY_EXPANSION)."""
    return frozenset().union(
        *(ANOMALY_EXPANSION.get(a, {a}) for a in wanted))


#: The reference WrChecker's default `prohibited` set (G2, G1a, G1b and
#: internal, expanded), which its analyze-store sweep applies to every
#: history.
WR_PROHIBITED = expand_anomalies(("G2", "G1a", "G1b", "internal"))


class WrChecker(Checker):
    """Checker for rw-register histories (wr.clj:16-56 equivalent).

    Options: anomalies to prohibit (default G2+G1a+G1b+internal, the
    reference default at wr.clj:47), backend ("auto" | "tpu": the
    device path, "cpu": the host oracle; `devices.resolve_backend`),
    version-order inference flags, realtime/process_order graph
    additions; and the port's `device` (default cuda) and `square` (e.g.
    `closure_square_ref` in place of the kernel)."""

    def __init__(self, anomalies: Iterable[str] = ("G2", "G1a", "G1b",
                                                   "internal"),
                 backend: str = "auto", sequential_keys: bool = False,
                 linearizable_keys: bool = False, wfr_keys: bool = False,
                 realtime: bool = False, process_order: bool = False,
                 device=None, square=None):
        self.prohibited = expand_anomalies(anomalies) if anomalies \
            else frozenset()
        self.backend = backend
        self.opts = dict(sequential_keys=sequential_keys,
                         linearizable_keys=linearizable_keys,
                         wfr_keys=wfr_keys)
        self.realtime = realtime
        self.process_order = process_order
        self.device = device
        self.square = square

    def check(self, test, history, opts):
        from ...devices import resolve_backend
        from . import artifacts
        backend = resolve_backend(self.backend)
        enc = encode_wr_history(history, **self.opts)
        kw = dict(realtime=self.realtime, process_order=self.process_order)
        divergent: dict = {}
        if backend == "tpu":
            cycles = cycle_anomalies_tpu(enc, device=self.device,
                                         square=self.square, **kw)
            if cycles:
                cycles, divergent = artifacts.device_host_refine(
                    cycles, lambda: cycle_anomalies_cpu(enc, **kw))
        else:
            cycles = cycle_anomalies_cpu(enc, **kw)
        verdict = render_wr_verdict(enc, cycles, self.prohibited)
        return artifacts.attach(verdict, divergent, test, opts)

    def render_failure(self, test, history, res, opts) -> None:
        """Per-key artifact hook for batched independent dispatch."""
        from . import artifacts
        artifacts.attach(res, res.get("device-host-divergence", {}),
                         test, opts)

    def check_batch(self, test, histories: list, opts) -> list[dict]:
        """Batched per-key dispatch: host version-order inference per
        history, then length-bucketed device cycle dispatches over the
        packed edge matrices (`kernels.check_edge_batch_bucketed`);
        flagged histories re-run the host oracle for witnesses."""
        from ...devices import resolve_backend
        from . import artifacts
        backend = resolve_backend(self.backend)
        encs = [encode_wr_history(h, **self.opts) for h in histories]
        kw = dict(realtime=self.realtime,
                  process_order=self.process_order)
        if backend != "tpu":
            return [render_wr_verdict(e, cycle_anomalies_cpu(e, **kw),
                                      self.prohibited) for e in encs]
        from . import kernels
        cycles_list = kernels.check_edge_batch_bucketed(
            [to_edge_dict(e) for e in encs], self.device,
            square=self.square, **kw)
        out = []
        for enc, cycles in zip(encs, cycles_list):
            divergent: dict = {}
            if cycles:
                cycles, divergent = artifacts.device_host_refine(
                    cycles,
                    lambda enc=enc: cycle_anomalies_cpu(enc, **kw))
            verdict = render_wr_verdict(enc, cycles, self.prohibited)
            if divergent:
                verdict["device-host-divergence"] = divergent
            out.append(verdict)
        return out


def rw_register_checker(anomalies: Iterable[str] = ("G2", "G1a", "G1b",
                                                    "internal"),
                        backend: str = "auto", **kw) -> Checker:
    return WrChecker(anomalies, backend, **kw)
