"""Device kernels for Elle-style cycle detection, in PyTorch.

Counterpart of `jepsen_tpu/checker/elle/kernels.py`. Encoded histories
are packed into padded integer tensors; dependency edges are built with
dense scatters; cycle detection is a boolean transitive closure by
repeated squaring (`closure_square`, the hand kernel on cuda); anomaly
classes fall out of closure/edge intersections:

  G0        some ww edge (u,v) with v→u in closure(ww)
  G1c       some wr edge (u,v) with v→u in closure(ww|wr)
  G-single  some rw edge (u,v) with v→u in closure(ww|wr)
  G2-item   some rw edge (u,v) with v→u only in closure(ww|wr|rw)

The math is the reference's, batched over B where the reference vmaps,
with host control flow where it uses `lax.while_loop`/`lax.cond`: the
closure loop syncs once per round on "did anything change", and the
fused classifier branches on "is any history cyclic". Every function
takes tensors on one device and runs there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import closure_square as cs
from .encode import EncodedHistory, effective_complete_index

# Flag bit positions in the kernel's output word.
G0, G1C, G_SINGLE, G2_ITEM, CYCLE = 0, 1, 2, 3, 4
FLAG_NAMES = {G0: "G0", G1C: "G1c", G_SINGLE: "G-single", G2_ITEM: "G2-item"}

#: A squaring function: (m, mT) [B,T,T] bool, mT each history's
#: transpose -> (out, outT, changed): the round, its transpose and a [B]
#: bool "out differs from m" (see closure_square.closure_square).
Square = Callable[[torch.Tensor, torch.Tensor],
                  tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def pad_to(x: int, multiple: int) -> int:
    """Round x up to a positive multiple."""
    return max(multiple, ((x + multiple - 1) // multiple) * multiple)


@dataclass(frozen=True)
class BatchShape:
    """Static padding plan for a batch of encoded histories."""

    n_txns: int      # T: txn rows per history (padded)
    n_appends: int   # A: append triples per history
    n_reads: int     # R: read triples per history
    n_keys: int      # K: interned keys per history
    max_pos: int     # P: longest version chain

    @staticmethod
    def plan(encs: list[EncodedHistory], multiple: int = 128) -> "BatchShape":
        return BatchShape(
            n_txns=pad_to(max((e.n for e in encs), default=1), multiple),
            n_appends=pad_to(max((len(e.appends) for e in encs), default=1), 8),
            n_reads=pad_to(max((len(e.reads) for e in encs), default=1), 8),
            n_keys=pad_to(max((e.n_keys for e in encs), default=1), 8),
            max_pos=pad_to(max((e.max_pos for e in encs), default=1), 8),
        )


def pack_batch(encs: list[EncodedHistory],
               shape: BatchShape | None = None) -> dict:
    """Pack EncodedHistories into padded stacked numpy arrays (host-side).

    Padding convention: append/read triples beyond their count have
    txn = -1; txn rows beyond a history's n are dead (no triples reference
    them, and the kernel masks them out of realtime edges via n_txns)."""
    shape = shape or BatchShape.plan(encs)
    B = len(encs)
    appends = np.full((B, shape.n_appends, 3), -1, np.int32)
    reads = np.full((B, shape.n_reads, 3), -1, np.int32)
    invoke_idx = np.zeros((B, shape.n_txns), np.int64)
    complete_idx = np.zeros((B, shape.n_txns), np.int64)
    process = np.full((B, shape.n_txns), -1, np.int32)
    n_txns = np.zeros((B,), np.int32)
    for i, e in enumerate(encs):
        a = np.asarray(e.appends, np.int32)
        r = np.asarray(e.reads, np.int32)
        if len(a) > shape.n_appends or len(r) > shape.n_reads or \
                e.n > shape.n_txns:
            raise ValueError(f"history {i} exceeds batch shape {shape}")
        appends[i, : len(a)] = a
        reads[i, : len(r)] = r
        invoke_idx[i, : e.n] = e.invoke_index
        complete_idx[i, : e.n] = effective_complete_index(
            e.status, e.complete_index)
        process[i, : e.n] = e.process
        n_txns[i] = e.n
    return {"appends": appends, "reads": reads, "n_txns": n_txns,
            "invoke_index": invoke_idx, "complete_index": complete_idx,
            "process": process, "shape": shape}


#: Packed-batch fields and the dtype each has on the device.
DEVICE_FIELDS = {"appends": torch.int64, "reads": torch.int64,
                 "invoke_index": torch.int64, "complete_index": torch.int64,
                 "process": torch.int64, "n_txns": torch.int64}


def batch_to_device(packed: dict, device: torch.device) -> dict:
    """The host->device copy of a packed batch: every array field as a
    tensor on `device` (int64, the index type torch scatters take),
    `shape` carried along."""
    out = {k: torch.as_tensor(np.asarray(packed[k])).to(device=device,
                                                         dtype=dt)
           for k, dt in DEVICE_FIELDS.items()}
    out["shape"] = packed["shape"]
    return out


def closure_steps(n_txns: int) -> int:
    """Squaring rounds needed for a T-node graph: path lengths double each
    round; (A|I)^(2^s) covers all simple paths once 2^s >= T."""
    return max(1, int(np.ceil(np.log2(max(2, n_txns)))))


def _fill_edges(adj: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                live: torch.Tensor) -> None:
    """Set adj[b, src, dst] for every live (src, dst) pair of each batch
    row b ([B,N] index tensors). Pairs that are dead, self-loops or out
    of [0, T) are dropped — the reference's `mode="drop"` scatter."""
    B, T, _ = adj.shape
    live = live & (src >= 0) & (dst >= 0) & (src < T) & (dst < T) \
        & (src != dst)
    b = torch.arange(B, device=adj.device)[:, None]
    flat = (b * T + src) * T + dst
    # dead pairs all land on one extra cell past the matrices, dropped
    # below: a scatter with no host sync (a boolean mask would need one)
    flat = torch.where(live, flat, B * T * T)
    cells = torch.zeros(B * T * T + 1, dtype=torch.bool, device=adj.device)
    cells.index_fill_(0, flat.reshape(-1), True)
    adj |= cells[:-1].view(B, T, T)


def _edges_batched(appends: torch.Tensor, reads: torch.Tensor, n_keys: int,
                   max_pos: int, n_txns: int):
    """[B,T,T] boolean ww/wr/rw adjacencies from packed triples — the
    reference's `_edges_one`, batched over B instead of vmapped.

    appends: [B,A,3] (txn,key,pos), pos>=1 observed, -1 unobserved/dead.
    reads:   [B,R,3] (txn,key,pos-of-last), 0 empty read, -1 dead.
    """
    B = appends.shape[0]
    T = n_txns
    dev = appends.device
    P = max_pos
    a_txn, a_key, a_pos = appends.unbind(-1)
    r_txn, r_key, r_pos = reads.unbind(-1)
    a_live = (a_txn >= 0) & (a_pos >= 1)
    r_live = (r_txn >= 0) & (r_pos >= 0)
    rows = torch.arange(B, device=dev)[:, None]

    # Writer lookup table W[b, key, pos] -> txn row (or -1). The pos axis
    # is 1-based; slot 0 unused; slot P+1 is the trash slot dead triples
    # aim at, re-nulled afterwards. Out-of-range indices are dropped on
    # write and clamped on read, as the reference's scatter/gather do.
    W = torch.full((B, n_keys, P + 2), -1, dtype=torch.int64, device=dev)
    k_idx = torch.where(a_live, a_key, n_keys - 1)
    p_idx = torch.where(a_live, a_pos, P + 1)
    inb = (k_idx >= 0) & (k_idx < n_keys) & (p_idx >= 0) & (p_idx <= P + 1)
    W[rows.expand_as(a_txn)[inb], k_idx[inb], p_idx[inb]] = torch.where(
        a_live, a_txn, -1)[inb]
    W[:, :, P + 1] = -1

    def gather(k, p):
        return W[rows.expand_as(k), k.clamp(0, n_keys - 1),
                 p.clamp(0, P + 1)]

    # ww: writer of pos-1 -> writer of pos
    ww = torch.zeros((B, T, T), dtype=torch.bool, device=dev)
    prev_w = gather(k_idx, torch.clamp(p_idx - 1, min=0))
    _fill_edges(ww, prev_w, a_txn, a_live & (a_pos >= 2))

    # Power-of-two shortcut edges along each key's writer chain: W[k,p] ->
    # W[k,p+s] is implied by transitivity whenever every position p..p+s
    # is live, so every closure is unchanged while the graph diameter
    # drops from the chain length to ~log of it. A gap means no implied
    # path, hence the contiguity gate.
    C = torch.cumsum((W >= 0).to(torch.int64), dim=2)     # [B,K,P+2]
    s = 2
    while s <= P:
        src = W[:, :, 1:P + 1 - s]
        dst = W[:, :, 1 + s:P + 1]
        run = (C[:, :, 1 + s:P + 1] - C[:, :, 0:P - s]) == s + 1
        _fill_edges(ww, src.reshape(B, -1), dst.reshape(B, -1),
                    run.reshape(B, -1))
        s *= 2

    # wr: writer of pos -> reader (pos >= 1)
    rk = torch.where(r_live, r_key, n_keys - 1)
    rp = torch.where(r_live & (r_pos >= 1), r_pos, P + 1)
    wr = torch.zeros((B, T, T), dtype=torch.bool, device=dev)
    _fill_edges(wr, gather(rk, rp), r_txn, r_live & (r_pos >= 1))

    # rw: reader -> writer of pos+1
    rp1 = torch.where(r_live, torch.clamp(r_pos + 1, max=P + 1), P + 1)
    rw = torch.zeros((B, T, T), dtype=torch.bool, device=dev)
    _fill_edges(rw, r_txn, gather(rk, rp1), r_live)
    return ww, wr, rw


def _square(m: torch.Tensor, mT: torch.Tensor, square: Square | None):
    """ONE boolean matrix squaring with its transpose and changed flags:
    the hand kernel on cuda (its plain version on cpu) unless the caller
    names another squaring."""
    return (cs.closure_square if square is None else square)(m, mT)


def _closure_batched(m: torch.Tensor, steps: int,
                     square: Square | None = None,
                     rounds: list | None = None) -> torch.Tensor:
    """Transitive closure of [B,T,T] boolean adjacencies: `m | eye`
    squared to the batch-level fixpoint, at most `steps` rounds. Path
    lengths double each round, so convergence takes ~log2(diameter)
    rounds. The squaring returns the round's transpose (the next round's
    second operand; made once here, before the first round) and its
    per-history changed flags, so the loop reads back one bool per round
    and compares no matrices. `rounds`, when given, gets the number of
    squarings appended."""
    T = m.shape[-1]
    m = m | torch.eye(T, dtype=torch.bool, device=m.device)
    mT = m.transpose(1, 2).contiguous()
    i = 0
    changed = True
    while changed and i < steps:
        m, mT, flags = _square(m, mT, square)
        changed = bool(flags.any())
        i += 1
    if rounds is not None:
        rounds.append(i)
    return m


def _any(x: torch.Tensor) -> torch.Tensor:
    """Per-history any over the trailing [T,T] (or [T]) axes: [B] bool."""
    return x.flatten(1).any(1)


def _flags_from_closures(ww, wr, rw, c_ww, c_wwr, c_full, cycle,
                         nI) -> torch.Tensor:
    """Anomaly flag words from the three edge classes and their three
    (nested) closures — the one classification formula, shared by the
    fused and two-pass classify paths so their verdicts can't drift."""
    cT_wwr = c_wwr.transpose(1, 2)
    g0 = _any(ww & c_ww.transpose(1, 2) & nI)
    g1c = _any(wr & cT_wwr)
    g_single = _any(rw & cT_wwr)
    g2 = _any(rw & c_full.transpose(1, 2) & ~cT_wwr)
    cycle = cycle | g0 | g1c | g_single | g2
    return (g0.to(torch.int32) << G0) \
        | (g1c.to(torch.int32) << G1C) \
        | (g_single.to(torch.int32) << G_SINGLE) \
        | (g2.to(torch.int32) << G2_ITEM) \
        | (cycle.to(torch.int32) << CYCLE)


def classify_matrices_impl(ww, wr, rw, invoke_index, complete_index, process,
                           n_live, *, steps: int, classify: bool,
                           realtime: bool, process_order: bool,
                           fused: bool = True, square: Square | None = None,
                           rounds: list | None = None) -> torch.Tensor:
    """Closure + anomaly classification over [B,T,T] boolean edge
    matrices -> [B] int32 flag words. Process-order and realtime edges
    fold into the ww class, masked to each history's live rows."""
    T = ww.shape[-1]
    dev = ww.device
    nI = ~torch.eye(T, dtype=torch.bool, device=dev)
    live = torch.arange(T, device=dev)[None, :] < n_live[:, None]   # [B,T]
    live2 = live[:, :, None] & live[:, None, :]                     # [B,T,T]

    if process_order:
        # Consecutive txns of one process in completion order: link row i
        # to the same-process row with the smallest completion index
        # greater than i's.
        same = (process[:, :, None] == process[:, None, :]) \
            & (process[:, :, None] >= 0)
        later = complete_index[:, None, :] > complete_index[:, :, None]
        cand = same & later & live2
        big = torch.where(cand, complete_index[:, None, :],
                          torch.iinfo(complete_index.dtype).max)
        nxt = big.min(dim=2, keepdim=True).values
        ww = ww | (cand & (big == nxt))
    if realtime:
        # j completed before i invoked => j precedes i in real time.
        # Indeterminate txns carry NEVER_COMPLETED and emit no rt edges.
        rt = complete_index[:, :, None] < invoke_index[:, None, :]
        ww = ww | (rt & live2 & nI)

    def closure(m):
        return _closure_batched(m, steps, square, rounds)

    wwr = ww | wr
    full = wwr | rw
    if not classify:
        c_full = closure(full)
        cycle = _any(full & c_full.transpose(1, 2) & nI)
        return cycle.to(torch.int32) << CYCLE
    if fused:
        # Fused detect/classify: run the detect closure first and run
        # the classification closures only when some history in the
        # batch is cyclic (a host-side branch where the reference uses
        # lax.cond), reusing the full closure. Exact: every per-class
        # witness implies a cycle in the full graph, so an acyclic batch
        # classifies to zero flags.
        c_full = closure(full)
        cycle = _any(full & c_full.transpose(1, 2) & nI)
        if not bool(cycle.any()):
            return cycle.to(torch.int32) << CYCLE
        c_ww = closure(ww)
        c_wwr = closure(c_ww | wr)
        return _flags_from_closures(ww, wr, rw, c_ww, c_wwr, c_full, cycle,
                                    nI)
    # Two-pass chain of warm starts: closure(A|B) == closure(closure(A)|B),
    # so each wider closure is seeded with the previous one.
    c_ww = closure(ww)
    c_wwr = closure(c_ww | wr)
    c_full = closure(c_wwr | rw)
    cycle = _any(full & c_full.transpose(1, 2) & nI)
    return _flags_from_closures(ww, wr, rw, c_ww, c_wwr, c_full, cycle, nI)


def check_batched_impl(appends, reads, invoke_index, complete_index, process,
                       n_live, *, n_keys: int, max_pos: int, n_txns: int,
                       steps: int, classify: bool, realtime: bool,
                       process_order: bool, fused: bool = True,
                       square: Square | None = None,
                       rounds: list | None = None) -> torch.Tensor:
    """THE cycle-check kernel: packed [B,...] tensors -> [B] int32 flag
    words. `n_live` is the per-history real txn count ([B]); rows beyond
    it are excluded from realtime/process edges."""
    ww, wr, rw = _edges_batched(appends, reads, n_keys, max_pos, n_txns)
    return classify_matrices_impl(
        ww, wr, rw, invoke_index, complete_index, process, n_live,
        steps=steps, classify=classify, realtime=realtime,
        process_order=process_order, fused=fused, square=square,
        rounds=rounds)


def check_batch_device(batch: dict, *, classify: bool = True,
                       realtime: bool = False, process_order: bool = False,
                       fused: bool = True, square: Square | None = None,
                       rounds: list | None = None) -> torch.Tensor:
    """Single-device entry over a device-resident packed batch (from
    `batch_to_device`): [B] int32 flag words, on the batch's device.
    `square` replaces the squaring (e.g. with `closure_square_ref` to run
    the plain version on cuda); `rounds` collects each closure's
    squaring count."""
    shape: BatchShape = batch["shape"]
    return check_batched_impl(
        batch["appends"], batch["reads"], batch["invoke_index"],
        batch["complete_index"], batch["process"], batch["n_txns"],
        n_keys=shape.n_keys, max_pos=shape.max_pos, n_txns=shape.n_txns,
        steps=closure_steps(shape.n_txns), classify=classify,
        realtime=realtime, process_order=process_order, fused=fused,
        square=square, rounds=rounds)


def flags_to_names(word: int) -> dict:
    """Anomaly names for a flag word. In detect-only mode (classify=False)
    no classify bits exist, so a set CYCLE bit reports as a generic
    "cycle" anomaly rather than vanishing."""
    out = {name: True for bit, name in FLAG_NAMES.items()
           if word & (1 << bit)}
    if not out and word & (1 << CYCLE):
        out["cycle"] = True
    return out
