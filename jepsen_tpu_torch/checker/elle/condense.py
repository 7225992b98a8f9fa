"""Host-condensed checking for very long histories (100k+ ops).

The port's own copy of `jepsen_tpu/checker/elle/condense.py`. The dense
[T,T] closure caps around ~32k txns per history (the device holds T²
cells per matrix). This module is the scale path behind it, built on
one graph fact:

    every dependency cycle lies inside one strongly-connected component
    of the FULL dependency graph, and so does every path between two
    members of an SCC (any intermediate node closes a cycle through the
    SCC and is therefore a member).

Hence each anomaly query is *exactly* answerable inside its SCC: the
offending edge plus its return path form a cycle, and the "not in
ww∪wr closure" side condition of G2-item also restricts losslessly,
because any ww∪wr return path between SCC members is SCC-internal.

Pipeline:
  1. vectorized numpy edge build (searchsorted writer lookup),
  2. strong components over CSR arrays with scipy (realtime order
     sparsified to O(T) via a completion-rank aux chain),
  3. valid histories (no nontrivial SCC — the common case) finish here
     with zero device work,
  4. anomalous histories ship their SCC subgraphs to the batched device
     classification (`kernels.check_edge_batch_bucketed`, whose
     closures square through `closure_square`), flags OR-ed across
     SCCs; an SCC past `DEVICE_SCC_LIMIT` rows classifies on the host.
"""

from __future__ import annotations

import time

import numpy as np
from scipy.sparse import csgraph

from .encode import EncodedHistory, effective_complete_index
from . import graph as G


def _append_lookup(enc: EncodedHistory):
    """Writer lookup (key, pos) -> txn row via sorted-id binary search.

    Returns a callable look(keys, positions) -> txn rows (or -1); only
    live appends (pos >= 1) participate, matching graph.build_edges."""
    a = np.asarray(enc.appends, np.int64).reshape(-1, 3)
    P2 = enc.max_pos + 2
    live = a[:, 2] >= 1
    ids = a[live, 1] * P2 + a[live, 2]
    txns = a[live, 0]
    order = np.argsort(ids)
    sids, stx = ids[order], txns[order]

    def look(keys: np.ndarray, positions: np.ndarray) -> np.ndarray:
        if len(sids) == 0 or len(keys) == 0:
            return np.full(len(keys), -1, np.int64)
        q = keys.astype(np.int64) * P2 + positions.astype(np.int64)
        i = np.minimum(np.searchsorted(sids, q), len(sids) - 1)
        return np.where(sids[i] == q, stx[i], -1)

    return look


def build_edges_arrays(enc: EncodedHistory, process_order: bool = False
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized (src, dst, cls) edge arrays — the numpy counterpart of
    graph.build_edges (same ww/wr/rw semantics), minus realtime (see
    rt_aux_edges)."""
    a = np.asarray(enc.appends, np.int64).reshape(-1, 3)
    r = np.asarray(enc.reads, np.int64).reshape(-1, 3)
    look = _append_lookup(enc)
    srcs, dsts, clss = [], [], []

    def emit(src, dst, cls):
        keep = (src >= 0) & (dst >= 0) & (src != dst)
        srcs.append(src[keep])
        dsts.append(dst[keep])
        clss.append(np.full(int(keep.sum()), cls, np.int32))

    m = a[:, 2] >= 2                      # ww: writer(pos-1) -> writer(pos)
    emit(look(a[m, 1], a[m, 2] - 1), a[m, 0], G.WW)
    m = r[:, 2] >= 1                      # wr: writer(pos) -> reader
    emit(look(r[m, 1], r[m, 2]), r[m, 0], G.WR)
    m = r[:, 2] >= 0                      # rw: reader -> writer(pos+1)
    emit(r[m, 0], look(r[m, 1], r[m, 2] + 1), G.RW)

    if process_order and enc.n:
        eff = effective_complete_index(enc.status, enc.complete_index)
        pr = np.asarray(enc.process, np.int64)
        rows = np.arange(enc.n, dtype=np.int64)[pr >= 0]
        order = rows[np.lexsort((eff[pr >= 0], pr[pr >= 0]))]
        if len(order) > 1:
            src, dst = order[:-1], order[1:]
            same = pr[src] == pr[dst]
            emit(src[same], dst[same], G.PROC)

    if not srcs:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.int32)
    return (np.concatenate(srcs), np.concatenate(dsts),
            np.concatenate(clss))


def aux_chain(eff: np.ndarray, inv: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """Completion-rank aux chain over (complete, invoke) index arrays:
    the O(n) sparsification of the realtime order.

    Aux node n+k means "after the k-th completion (in completion
    order)". Edges: txn j -> aux rank(j); aux_k -> aux_{k+1}; and
    aux_{k_i} -> txn i where k_i is the last completion rank strictly
    before i's invocation. Reachability j -> i through aux nodes is
    then exactly complete(j) < invoke(i). Returns (src, dst); callers
    add n aux node ids on top of their own node space."""
    n = len(eff)
    order = np.argsort(eff, kind="stable")
    sorted_eff = eff[order]
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    aux = n + np.arange(n, dtype=np.int64)

    srcs = [np.arange(n, dtype=np.int64), aux[:-1]]
    dsts = [aux[rank], aux[1:]]
    k = np.searchsorted(sorted_eff, inv) - 1   # last completion < invoke
    has = k >= 0
    srcs.append(aux[k[has]])
    dsts.append(np.arange(n, dtype=np.int64)[has])
    return np.concatenate(srcs), np.concatenate(dsts)


def rt_aux_edges(enc: EncodedHistory
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """aux_chain over a whole encoded history. Returns (src, dst,
    n_aux)."""
    n = enc.n
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
    eff = effective_complete_index(enc.status, enc.complete_index)
    inv = np.asarray(enc.invoke_index, np.int64)
    src, dst = aux_chain(eff, inv)
    return src, dst, n


def _scc_csr(n_nodes: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """SCC ids from edge arrays: scipy's strong components over the CSR
    graph (ids arbitrary; the partition is the reference's)."""
    _, labels = csgraph.connected_components(
        G.csr_graph(n_nodes, src, dst), directed=True, connection="strong")
    return labels.astype(np.int64)


def _tarjan_order(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                  labels: np.ndarray, wanted: np.ndarray) -> list[int]:
    """The SCC labels `wanted` in the order the reference numbers its
    SCCs. Its Tarjan search starts from nodes 0, 1, ... in turn, follows
    each node's edges in input order, and numbers an SCC when the SCC's
    first-discovered node finishes. The order matters where the flags of
    several SCCs are merged into one verdict: it is the order in which
    anomaly names enter the verdict's `anomalies` map. This walks the
    same depth-first search and stops once every wanted SCC is
    numbered."""
    order = np.argsort(src, kind="stable")
    col = dst[order].tolist()
    row_ptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n_nodes), out=row_ptr[1:])
    ptr = row_ptr.tolist()
    lab = labels.tolist()
    want = set(wanted.tolist())
    root_of: dict = {}
    out: list[int] = []
    seen = bytearray(n_nodes)
    for root in range(n_nodes):
        if seen[root]:
            continue
        seen[root] = 1
        root_of.setdefault(lab[root], root)
        stack, nxt = [root], [ptr[root]]
        while stack:
            v = stack[-1]
            i, end = nxt[-1], ptr[v + 1]
            while i < end and seen[col[i]]:
                i += 1
            if i < end:
                w = col[i]
                nxt[-1] = i + 1
                seen[w] = 1
                root_of.setdefault(lab[w], w)
                stack.append(w)
                nxt.append(ptr[w])
                continue
            stack.pop()
            nxt.pop()
            if lab[v] in want and root_of[lab[v]] == v:
                out.append(lab[v])
                if len(out) == len(want):
                    return out
    return out


def condense(enc: EncodedHistory, realtime: bool = False,
             process_order: bool = False) -> tuple[list[np.ndarray], tuple]:
    """Nontrivial SCCs (>= 2 txn rows each) of the full dependency
    graph, in the reference's order. Returns (member-row arrays, cached
    (src, dst, cls) edges)."""
    src, dst, cls = build_edges_arrays(enc, process_order=process_order)
    if realtime:
        rs, rd, _ = rt_aux_edges(enc)
        all_src = np.concatenate([src, rs])
        all_dst = np.concatenate([dst, rd])
        n_nodes = 2 * enc.n
    else:
        all_src, all_dst = src, dst
        n_nodes = enc.n
    if len(all_src) == 0 or enc.n == 0:
        return [], (src, dst, cls)
    labels = _scc_csr(n_nodes, all_src, all_dst)
    scc = labels[: enc.n]
    counts = np.bincount(scc)
    big = np.flatnonzero(counts >= 2)
    if len(big) > 1:
        big = _tarjan_order(n_nodes, all_src, all_dst, labels, big)
    members = [np.flatnonzero(scc == b) for b in big]
    return members, (src, dst, cls)


# An SCC bigger than this goes to the host classifier instead of the
# dense device kernel (whose [T,T] matrices are what the condensation
# exists to avoid at full history size).
DEVICE_SCC_LIMIT = 8_192


def _classify_scc_host(enc: EncodedHistory, rows: np.ndarray,
                       src, dst, cls, keep, local,
                       realtime: bool) -> dict:
    """Host classification of one oversized SCC: graph.classify_cycles
    over the subgraph, with the realtime order carried by a
    member-local completion-rank aux chain (exact rt reachability, no
    dense [m,m] relation)."""
    m = len(rows)
    edges = list(zip(local[src[keep]].tolist(), local[dst[keep]].tolist(),
                     cls[keep].tolist()))
    n_nodes = m
    if realtime:
        eff = effective_complete_index(enc.status, enc.complete_index)[rows]
        inv = np.asarray(enc.invoke_index, np.int64)[rows]
        asrc, adst = aux_chain(eff, inv)   # member-local rt chain
        edges += [(int(s), int(d), G.RT) for s, d in zip(asrc, adst)]
        n_nodes = 2 * m
    res = G.classify_cycles(n_nodes, edges, want_witnesses=False)
    return {name: True for name in res}


def condensed_stats(enc: EncodedHistory, members, src, dst, cls,
                    realtime: bool) -> dict:
    """The search-stats record of a condensed check — the long-history
    sibling of `kernels.stats_row`, with the reference's fields in its
    order. Edge and SCC facts are exact (distinct edges per class, the
    nontrivial SCCs' count and shape, and the realtime-edge count by
    one searchsorted over the completion ranks rather than the O(n²)
    dense relation); the closure-round and margin fields are -1: no
    dense closure ran on this path."""
    from . import kernels as K
    if len(src):
        distinct = np.unique(
            np.stack([src, dst, cls.astype(np.int64)], axis=1), axis=0)
        counts = np.bincount(distinct[:, 2], minlength=4)
    else:
        counts = np.zeros(4, np.int64)
    rt = 0
    if realtime and enc.n:
        eff = effective_complete_index(enc.status, enc.complete_index)
        inv = np.asarray(enc.invoke_index, np.int64)
        # |{(j, i): complete(j) < invoke(i)}| — a txn's own completion
        # never precedes its invocation, so self-pairs drop out free
        rt = int(np.searchsorted(np.sort(eff), inv, side="left").sum())
    sizes = np.asarray([len(m) for m in members], np.int64)
    has = len(sizes) > 0
    return {
        "ww_edges": int(counts[G.WW]), "wr_edges": int(counts[G.WR]),
        "rw_edges": int(counts[G.RW]), "rt_edges": rt,
        "proc_edges": int(counts[G.PROC]),
        "closure_rounds": -1,
        "cycle_round": 0 if has else -1,
        "scc_count": int(len(sizes)),
        "scc_max": int(sizes.max()) if has else 0,
        "scc_min": int(sizes.min()) if has else 0,
        "cycle_txns": int(sizes.sum()) if has else 0,
        "margin": -1,
        "n_txns": int(enc.n), "t_pad": int(enc.n),
        "closure_bound": K.closure_steps(max(enc.n, 1)),
        "pad_waste_cells": 0,
        "path": "condensed",
    }


def check_condensed(enc: EncodedHistory, device=None, *,
                    classify: bool = True, realtime: bool = False,
                    process_order: bool = False,
                    device_scc_limit: int = DEVICE_SCC_LIMIT,
                    square=None, bucket_log: list | None = None,
                    condense_log: list | None = None,
                    stats_out: list | None = None,
                    devices=None) -> dict:
    """Check ONE long history via SCC condensation on `device` (default
    cuda), or with several `devices` its SCC batches split over them (a
    1-D dp mesh, `kernels.check_edge_batch_bucketed`). Returns the same
    {anomaly: True} flag dict as the dense device path.

    Valid histories (no nontrivial SCC) cost one numpy edge build plus
    one strong-components pass — no device work at all. Anomalous ones
    ship each SCC subgraph to the batched device classification;
    restriction to the SCC is exact (module docstring). SCCs beyond
    `device_scc_limit` rows classify on the host instead (their dense
    [m,m] matrices are the very thing condensation avoids).

    `square` and `bucket_log` as in `kernels.check_edge_batch_bucketed`.
    `condense_log` gets one dict for the history: its txn count, the
    sizes of its nontrivial SCCs (`scc_sizes`, and `host_scc_sizes` for
    those classified on the host), the padded T of each device bucket
    (`t_pads`), their summed closure rounds, and the seconds of the
    condensation (edge build + SCCs) and of the classification.
    `stats_out`, when given, gets the history's `condensed_stats`
    record."""
    from ...devices import resolve_device
    from . import kernels as K

    dev = resolve_device(device if not devices else devices[0])
    t0 = time.perf_counter()
    members, (src, dst, cls) = condense(enc, realtime=realtime,
                                        process_order=process_order)
    rec = {"n": enc.n, "scc_sizes": [len(m) for m in members],
           "host_scc_sizes": [], "t_pads": [], "closure_rounds": 0,
           "condense_seconds": time.perf_counter() - t0,
           "classify_seconds": 0.0}
    if condense_log is not None:
        condense_log.append(rec)
    if stats_out is not None:
        stats_out.append(condensed_stats(enc, members, src, dst, cls,
                                         realtime))
    if not members:
        return {}
    if not classify:
        return {"cycle": True}

    t1 = time.perf_counter()
    eff = effective_complete_index(enc.status, enc.complete_index)
    # One global local-id map + one argsort groups every (same-SCC)
    # edge by SCC id — O(E log E) total, independent of SCC count.
    local = np.full(enc.n, -1, np.int64)
    scc_of = np.full(enc.n, -1, np.int64)
    for b, rows in enumerate(members):
        local[rows] = np.arange(len(rows))
        scc_of[rows] = b
    same_idx = np.flatnonzero((scc_of[src] >= 0) &
                              (scc_of[src] == scc_of[dst]))
    grp = scc_of[src[same_idx]]
    order = np.argsort(grp, kind="stable")
    by_grp = same_idx[order]
    bounds = np.searchsorted(grp[order], np.arange(len(members) + 1))

    flags: dict = {}
    per_scc = []
    for b, rows in enumerate(members):
        keep = by_grp[bounds[b]:bounds[b + 1]]
        if len(rows) > device_scc_limit:
            rec["host_scc_sizes"].append(len(rows))
            flags.update(_classify_scc_host(
                enc, rows, src, dst, cls, keep, local, realtime))
            continue
        # PROC edges ride along as WW-class on device (same role:
        # cycle-strengthening order edges).
        sub_cls = np.where(cls[keep] == G.PROC, G.WW, cls[keep])
        per_scc.append({
            "n": len(rows),
            "edges": np.stack([local[src[keep]], local[dst[keep]],
                               sub_cls.astype(np.int64)], axis=1),
            "invoke_index": np.asarray(enc.invoke_index)[rows],
            "complete_index": eff[rows],
            "process": np.asarray(enc.process)[rows],
        })
    if per_scc:
        # bucketed: many small SCCs padded to the largest one's T would
        # otherwise pack into a single over-budget [B,T,T]x3 dispatch.
        # fused=False: every SCC here is cyclic by construction, so the
        # fused path's any-cycle branch would always fire and its
        # unseeded full closure would just re-walk what the chained
        # warm starts get for free.
        blog: list = []
        for res in K.check_edge_batch_bucketed(
                per_scc, dev, devices=devices, classify=True,
                realtime=realtime,
                process_order=False, fused=False, square=square,
                bucket_log=blog):
            flags.update(res)
        rec["t_pads"] = [b["t_pad"] for b in blog]
        rec["closure_rounds"] = sum(sum(b["closure_rounds"]) for b in blog)
        if bucket_log is not None:
            bucket_log.extend(blog)
    rec["classify_seconds"] = time.perf_counter() - t1
    return flags
