"""Dependency-graph construction and host cycle analysis.

The port's own copy of `jepsen_tpu/checker/elle/graph.py`. Builds
ww/wr/rw (and optional process/realtime) edges from an EncodedHistory,
then classifies cycles the way Elle does:

  G0        cycle of only ww edges
  G1c       cycle of ww∪wr edges containing at least one wr
  G-single  cycle with exactly one rw (anti-dependency) edge
  G2-item   cycle with two or more rw edges

This host implementation (hash joins + SCCs + per-edge BFS) is
algorithm-independent from the device path (dense scatter + transitive
closure by squaring), so the two serve as oracles for each other; it is
also what classifies an SCC too big for the device in the condensed
long-history path. Where the reference calls its C++ kernels (Tarjan,
batched reachability), this copy calls `scipy.sparse.csgraph`
(strongly connected components, breadth-first search): the same
partitions and the same reachability, with SCC ids arbitrary in both.
scipy is imported where it is called: the rw-register encoder imports
this module, and a pooled ingest worker should not pay for scipy.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from .encode import EncodedHistory, effective_complete_index

WW, WR, RW, PROC, RT = 0, 1, 2, 3, 4
EDGE_NAMES = {WW: "ww", WR: "wr", RW: "rw", PROC: "process", RT: "realtime"}


def build_edges(enc: EncodedHistory, process_order: bool = False,
                realtime: bool = False) -> list[tuple[int, int, int]]:
    """(src, dst, type) dependency edges between txn rows.

    ww: t1 appended version p, t2 appended p+1 (same key)
    wr: t1 appended version p, t2's external read observed p last
    rw: t1's external read ended at p, t2 appended p+1 (t1 "missed" t2)
    """
    edges: list[tuple[int, int, int]] = []
    writer: dict = {}  # (key, pos) -> row
    for r, k, p in enc.appends:
        if p > 0:
            writer[(int(k), int(p))] = int(r)
    for (k, p), r in writer.items():
        prev = writer.get((k, p - 1))
        if p > 1 and prev is not None and prev != r:
            edges.append((prev, r, WW))
    for r, k, p in enc.reads:
        r, k, p = int(r), int(k), int(p)
        if p < 0:
            continue  # incompatible read; no edge facts
        if p > 0:
            w = writer.get((k, p))
            if w is not None and w != r:
                edges.append((w, r, WR))
        nxt = writer.get((k, p + 1))
        if nxt is not None and nxt != r:
            edges.append((r, nxt, RW))
    # Indeterminate txns never completed: nothing is realtime-after them,
    # and they sort last (in row order) in their process's order.
    complete = effective_complete_index(enc.status, enc.complete_index)
    edges += order_edges(enc.n, enc.process, enc.invoke_index, complete,
                         process_order=process_order, realtime=realtime)
    return edges


def order_edges(n: int, process: np.ndarray, invoke_index: np.ndarray,
                effective_complete: np.ndarray, process_order: bool = False,
                realtime: bool = False) -> list[tuple[int, int, int]]:
    """Process-order / realtime edges from txn-row timing arrays.
    `effective_complete` must come from encode.effective_complete_index
    so indeterminate txns sort last with distinct keys, matching the
    device kernel's formulation."""
    edges: list[tuple[int, int, int]] = []
    if process_order:
        last_by_proc: dict = {}
        for row in np.argsort(effective_complete, kind="stable"):
            row = int(row)
            p = int(process[row])
            if p < 0:
                continue
            if p in last_by_proc:
                edges.append((last_by_proc[p], row, PROC))
            last_by_proc[p] = row
    if realtime:
        # t1 completed before t2 invoked. Already transitively closed, so
        # emit the full relation (oracle scale only; the device builds
        # this densely via a broadcast compare).
        for i in range(n):
            for j in range(n):
                if j != i and effective_complete[j] < invoke_index[i]:
                    edges.append((j, i, RT))
    return edges


def adjacency(n: int, edges: Iterable[tuple[int, int, int]],
              types: set[int] | None = None) -> list[list[int]]:
    adj: list[list[int]] = [[] for _ in range(n)]
    for s, d, ty in edges:
        if types is None or ty in types:
            adj[s].append(d)
    return adj


def csr_graph(n: int, src: np.ndarray, dst: np.ndarray):
    """An n-node directed graph from edge arrays, as the CSR matrix
    `scipy.sparse.csgraph` takes (parallel edges kept; they change no
    component and no reachability)."""
    import scipy.sparse as sp
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    order = np.argsort(src, kind="stable")
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=row_ptr[1:])
    return sp.csr_matrix((np.ones(len(dst), np.int8), dst[order], row_ptr),
                         shape=(n, n))


def _adj_graph(n: int, adj: list[list[int]]):
    src = np.repeat(np.arange(n, dtype=np.int64),
                    [len(a) for a in adj])
    dst = np.fromiter((d for a in adj for d in a), np.int64, len(src))
    return csr_graph(n, src, dst)


def tarjan_scc(n: int, adj: list[list[int]]) -> list[int]:
    """SCC id per node (ids arbitrary), from scipy's strong components
    (the reference's name for the same partition)."""
    if n == 0:
        return []
    from scipy.sparse import csgraph
    _, labels = csgraph.connected_components(
        _adj_graph(n, adj), directed=True, connection="strong")
    return labels.tolist()


def reach(n: int, adj: list[list[int]],
          queries: list[tuple[int, int]]) -> list[bool]:
    """Batch src->dst reachability: one breadth-first search per
    distinct source."""
    from scipy.sparse import csgraph
    g = _adj_graph(n, adj)
    seen: dict = {}
    out = []
    for s, d in queries:
        if s not in seen:
            hit = np.zeros(n, bool)
            hit[csgraph.breadth_first_order(
                g, s, directed=True, return_predecessors=False)] = True
            seen[s] = hit
        out.append(bool(seen[s][d]))
    return out


def _bfs_path(adj: list[list[int]], src: int, dst: int) -> list[int] | None:
    """Shortest path src..dst (inclusive) or None."""
    if src == dst:
        return [src]
    prev = {src: None}
    frontier = [src]
    while frontier:
        nxt = []
        for v in frontier:
            for w in adj[v]:
                if w not in prev:
                    prev[w] = v
                    if w == dst:
                        path = [w]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return path[::-1]
                    nxt.append(w)
        frontier = nxt
    return None


def classify_cycles(n: int, edges: list[tuple[int, int, int]],
                    want_witnesses: bool = True) -> dict:
    """Find which cycle anomalies exist. Returns
    {name: witness-cycle-node-list | True} for each anomaly present.
    Realtime/process edges, when present, participate like ww edges do in
    the "no-antidependency" classes (they strengthen cycles)."""
    out: dict = {}
    base = {WW, PROC, RT}
    ww_adj = adjacency(n, edges, base)
    wwr_adj = adjacency(n, edges, base | {WR})
    full_adj = adjacency(n, edges, None)

    # G0: nontrivial SCC in the write-order graph.
    scc = tarjan_scc(n, ww_adj)
    counts = np.bincount(np.asarray(scc, np.int64), minlength=0) \
        if n else np.zeros(0, np.int64)
    g0_scc = {i for i, c in enumerate(counts) if c > 1}
    if g0_scc:
        if want_witnesses:
            s, d = next((s, d) for s, d, ty in edges
                        if ty in base and scc[s] == scc[d] and s != d
                        and scc[s] in g0_scc)
            path = _bfs_path(ww_adj, d, s)
            out["G0"] = path + [d] if path else True
        else:
            out["G0"] = True

    # G1c: wr edge inside an SCC of the ww∪wr graph.
    scc2 = tarjan_scc(n, wwr_adj)
    for s, d, ty in edges:
        if ty == WR and scc2[s] == scc2[d]:
            if want_witnesses:
                path = _bfs_path(wwr_adj, d, s)
                out["G1c"] = (path + [d]) if path else True
            else:
                out["G1c"] = True
            break

    # G-single / G2-item: per rw edge, can we get back without / only-with
    # further rw edges? One wwr BFS per edge; full-graph BFS only on miss.
    rw_edges = [(s, d) for s, d, ty in edges if ty == RW]
    if not want_witnesses and len(rw_edges) >= 64:
        # Batch the probes when only flags are needed (the reference
        # takes its native BFS kernel at the same threshold, so the
        # flags land in the same order).
        back = reach(n, wwr_adj, [(d, s) for s, d in rw_edges])
        if any(back):
            out["G-single"] = True
        misses = [(d, s) for (s, d), hit in zip(rw_edges, back) if not hit]
        if misses and any(reach(n, full_adj, misses)):
            out["G2-item"] = True
        return out
    for s, d in rw_edges:
        path = _bfs_path(wwr_adj, d, s)
        if path is not None:
            if "G-single" not in out:
                out["G-single"] = path + [d] if want_witnesses else True
        elif "G2-item" not in out:
            path = _bfs_path(full_adj, d, s)
            if path is not None:
                out["G2-item"] = path + [d] if want_witnesses else True
        if "G-single" in out and "G2-item" in out:
            break
    return out
