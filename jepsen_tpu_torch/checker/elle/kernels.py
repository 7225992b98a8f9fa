"""Device kernels for Elle-style cycle detection, in PyTorch.

Counterpart of `jepsen_tpu/checker/elle/kernels.py`. Encoded histories
are packed into padded integer tensors and their dependency edges built
with dense scatters; host-built edge lists (rw-register runs, the SCCs
of condensed long histories) are scattered into the same [B,T,T]
matrices (`check_edge_batch`). Cycle detection is a boolean
transitive closure by repeated squaring (`closure_square`, the hand
kernel on cuda); anomaly classes fall out of closure/edge
intersections:

  G0        some ww edge (u,v) with v→u in closure(ww)
  G1c       some wr edge (u,v) with v→u in closure(ww|wr)
  G-single  some rw edge (u,v) with v→u in closure(ww|wr)
  G2-item   some rw edge (u,v) with v→u only in closure(ww|wr|rw)

The math is the reference's, batched over B where the reference vmaps.
Its control flow stays on the device as the reference's
`lax.while_loop`/`lax.cond` does: a closure enqueues all
`closure_steps(T)` rounds, each conditional on a device word the
previous round sets when anything changed (`closure_square`'s
`active`), and the fused classifier's "is any history cyclic" is the
first word of the classification closures, their flags masked by it.
So a check enqueues its work and returns at once: the host reads
nothing back until the caller resolves the flags and the round counts
(`read_rounds`). Every function takes tensors on one device and runs
there, but for `mp`: the devices of one mesh row, over which each
closure round is split into column blocks (`_closure_batched`).

With `with_stats` (the kernel-stats path, `JEPSEN_TPU_KERNEL_STATS`,
decided by the caller: nothing here reads the gate) a check also
returns a [B, N_STATS] int32 matrix of search telemetry (`STAT_FIELDS`):
edge counts, the round each history's closure reached its fixpoint and
the first round a cycle showed, and the SCC shape of the full closure.
The closure then runs the same `closure_square` launches and updates
the per-history counters beside them on the device; the flags are the
same either way.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import closure_square as cs
from .encode import EncodedHistory, effective_complete_index

# Flag bit positions in the kernel's output word.
G0, G1C, G_SINGLE, G2_ITEM, CYCLE = 0, 1, 2, 3, 4
FLAG_NAMES = {G0: "G0", G1C: "G1c", G_SINGLE: "G-single", G2_ITEM: "G2-item"}

#: Per-history search-stat row layout ([B, N_STATS] int32), the
#: reference's:
#:
#:   ww/wr/rw_edges   distinct dependency edges per class, BEFORE the
#:                    power-of-two writer-chain shortcuts (so counts
#:                    match the CPU oracle's graph exactly);
#:   rt/proc_edges    realtime / process-order edges built from the
#:                    timing tensors;
#:   closure_rounds   squaring rounds the (widest) closure ran to its
#:                    fixpoint for THIS history;
#:   cycle_round      first round at which a cycle became visible
#:                    (0 = present in the raw edge set; -1 = acyclic);
#:   scc_count/max/min  nontrivial SCCs of the full closure, their
#:                    largest and smallest member counts (0 = none);
#:   cycle_txns       txn rows on any cycle;
#:   margin           cycle_round for a cyclic history, closure_rounds
#:                    for a valid one: rounds of closure work before
#:                    the decision.
STAT_FIELDS = ("ww_edges", "wr_edges", "rw_edges", "rt_edges",
               "proc_edges", "closure_rounds", "cycle_round",
               "scc_count", "scc_max", "scc_min", "cycle_txns",
               "margin")
N_STATS = len(STAT_FIELDS)


def stats_row(row, *, n_txns: int, t_pad: int) -> dict:
    """One stats row (ints) -> the per-history dict the analytics ledger
    records: the named fields plus the bucket's geometry (its pad, the
    static closure bound, the history's pad waste in closure cells)."""
    out = {f: int(v) for f, v in zip(STAT_FIELDS, row)}
    out["n_txns"] = int(n_txns)
    out["t_pad"] = int(t_pad)
    out["closure_bound"] = closure_steps(t_pad)
    out["pad_waste_cells"] = int(t_pad) ** 2 - int(n_txns) ** 2
    return out

#: A squaring function: (m, mT, active) — [B,T,T] bool, mT each
#: history's transpose, active the round's int32 word pair — -> (out,
#: outT, changed): the round, its transpose and a [B] bool "out differs
#: from m" (see closure_square.closure_square).
Square = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                  tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def fused_classify_enabled() -> bool:
    """The JEPSEN_TPU_FUSED_CLASSIFY gate (default on): classify
    dispatches run the fused detect/classify path, the classification
    closures conditional on the device on "some history is cyclic".
    `0` restores the detect-then-classify re-dispatch (two-pass)."""
    from ... import gates
    return gates.get("JEPSEN_TPU_FUSED_CLASSIFY")


#: Peak rates by `torch.cuda.get_device_name()`, lower-cased: dense
#: bf16 TFLOP/s, int8 TOP/s (the tensor cores'), HBM GB/s and capacity
#: GiB — the NVIDIA H100 SXM data sheet's row. Every consumer (a costdb
#: record, the report's device section) shows WHICH row it used
#: (`source`), so an assumed peak never reads as the card's own.
DEVICE_PEAKS: dict[str, dict] = {
    "nvidia h100 80gb hbm3": {"bf16_tflops": 989.0, "int8_tops": 1979.0,
                              "hbm_gbps": 3350.0, "hbm_gib": 80.0},
}

#: The row assumed for an unknown device kind (the CPU, another card).
_PEAK_FALLBACK = "NVIDIA H100 80GB HBM3"


def device_peak(device_kind: str | None = None) -> dict:
    """The peak-rate row for `device_kind` (default: the current CUDA
    device's name, "unknown" without one), plus `device_kind` (as given)
    and `source`: `"table"` for a known card, `"fallback (assumed
    NVIDIA H100 80GB HBM3)"` otherwise — consumers must surface that
    instead of publishing an assumed peak as measured."""
    if device_kind is None:
        try:
            device_kind = torch.cuda.get_device_name() \
                if torch.cuda.is_available() else "unknown"
        except Exception:
            device_kind = "unknown"
    row = DEVICE_PEAKS.get(str(device_kind).strip().lower())
    if row is not None:
        return {"device_kind": str(device_kind), "source": "table", **row}
    return {"device_kind": str(device_kind),
            "source": f"fallback (assumed {_PEAK_FALLBACK})",
            **DEVICE_PEAKS[_PEAK_FALLBACK.lower()]}


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


def dispatch_shape(enc) -> "BatchShape | None":
    """The BatchShape a v2 (dispatch-shaped) sidecar pre-padded this
    encoding to (`store.dispatch_pad_plan`), or None when it carries no
    dispatch views."""
    p = getattr(enc, "dispatch_pad", None)
    if not p or getattr(enc, "dispatch", None) is None:
        return None
    try:
        return BatchShape(n_txns=p["n_txns"], n_appends=p["n_appends"],
                          n_reads=p["n_reads"], n_keys=p["n_keys"],
                          max_pos=p["max_pos"])
    except KeyError:
        return None


#: The fields a views-packed batch carries one view per history of, and
#: the fill of their padding (pack_batch's convention).
VIEW_FILLS = {"appends": -1, "reads": -1, "invoke_index": 0,
              "complete_index": 0, "process": -1}


def pack_batch_views(encs: list, shape: BatchShape) -> dict | None:
    """Copy-free sibling of pack_batch: when EVERY encoding carries
    dispatch-shaped mmap views (the v2 sidecar's warm path), per-field
    LISTS of those views instead of freshly-copied stacked arrays —
    the h2d stage copies each view to the device as it lies in the
    mapped pages, pads a ragged one there (a history's own pad
    geometry may be smaller than the bucket's: `pad_to` is monotone,
    so never larger) and stacks them on the device. None when any
    encoding carries no views (cold encodings, the v1 cache) or claims
    a geometry beyond the bucket's: the caller falls back to
    pack_batch."""
    for e in encs:
        ds = dispatch_shape(e)
        if ds is None or ds.n_txns > shape.n_txns \
                or ds.n_appends > shape.n_appends \
                or ds.n_reads > shape.n_reads:
            return None
    out: dict = {f: [e.dispatch[f] for e in encs] for f in VIEW_FILLS}
    out["n_txns"] = np.asarray([e.n for e in encs], np.int32)
    out["shape"] = shape
    out["views"] = True
    return out


def views_to_device(packed: dict, device: torch.device) -> dict:
    """The host->device copy of a views-packed batch: each history's
    view copied as it lies (int32), padded on the device to the
    bucket's shape with the pack fill, stacked there and widened to
    the device dtype — the batch `batch_to_device` would give for the
    same histories."""
    shape: BatchShape = packed["shape"]
    targets = {"appends": (shape.n_appends, 3),
               "reads": (shape.n_reads, 3),
               "invoke_index": (shape.n_txns,),
               "complete_index": (shape.n_txns,),
               "process": (shape.n_txns,)}
    out = {}
    for k, fill in VIEW_FILLS.items():
        parts = []
        for v in packed[k]:
            with warnings.catch_warnings():
                # a read-only mapping: the tensor is only read, and
                # stack or the padding copies it
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(v)
            t = t.to(device)
            if tuple(v.shape) != targets[k]:
                full = torch.full(targets[k], fill, dtype=t.dtype,
                                  device=device)
                full[tuple(slice(0, s) for s in v.shape)] = t
                t = full
            parts.append(t)
        out[k] = torch.stack(parts).to(DEVICE_FIELDS[k])
    out["n_txns"] = torch.as_tensor(packed["n_txns"]).to(
        device=device, dtype=DEVICE_FIELDS["n_txns"])
    out["shape"] = shape
    return out


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
                   max_pos: int, n_txns: int, with_counts: bool = False):
    """[B,T,T] boolean ww/wr/rw adjacencies from packed triples — the
    reference's `_edges_one`, batched over B instead of vmapped.

    appends: [B,A,3] (txn,key,pos), pos>=1 observed, -1 unobserved/dead.
    reads:   [B,R,3] (txn,key,pos-of-last), 0 empty read, -1 dead.

    With `with_counts`, a fourth output: the [B,3] int32 distinct-edge
    counts, ww counted BEFORE the shortcut edges, as the reference's.
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
    # write (aimed at the trash slot too, so the scatter needs no
    # boolean mask and no host sync) and clamped on read, as the
    # reference's scatter/gather do.
    W = torch.full((B, n_keys, P + 2), -1, dtype=torch.int64, device=dev)
    k_idx = torch.where(a_live, a_key, n_keys - 1)
    p_idx = torch.where(a_live, a_pos, P + 1)
    inb = (k_idx >= 0) & (k_idx < n_keys) & (p_idx >= 0) & (p_idx <= P + 1)
    W[rows.expand_as(a_txn), torch.where(inb, k_idx, 0),
      torch.where(inb, p_idx, P + 1)] = torch.where(a_live & inb, a_txn, -1)
    W[:, :, P + 1] = -1

    def gather(k, p):
        return W[rows.expand_as(k), k.clamp(0, n_keys - 1),
                 p.clamp(0, P + 1)]

    # ww: writer of pos-1 -> writer of pos
    ww = torch.zeros((B, T, T), dtype=torch.bool, device=dev)
    prev_w = gather(k_idx, torch.clamp(p_idx - 1, min=0))
    _fill_edges(ww, prev_w, a_txn, a_live & (a_pos >= 2))
    ww_count = ww.flatten(1).sum(1) if with_counts else None

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
    if with_counts:
        counts = torch.stack([ww_count, wr.flatten(1).sum(1),
                              rw.flatten(1).sum(1)], 1).to(torch.int32)
        return ww, wr, rw, counts
    return ww, wr, rw


def _square(m: torch.Tensor, mT: torch.Tensor, active: torch.Tensor,
            square: Square | None):
    """ONE conditional boolean matrix squaring with its transpose and
    changed flags: the hand kernel on cuda (its plain version on cpu)
    unless the caller names another squaring."""
    return (cs.closure_square if square is None else square)(m, mT, active)


def _has_cycle(m: torch.Tensor, mT: torch.Tensor,
               nI: torch.Tensor) -> torch.Tensor:
    """[B] bool: does the (reflexive) matrix hold an off-diagonal
    mutually reachable pair?"""
    return _any(m & mT & nI)


def mp_parts(T: int, mp: int) -> int:
    """How many of `mp` devices a T-wide closure round gives a column
    block (`closure_square.column_blocks`): its launches a round."""
    return sum(1 for c0, c1 in cs.column_blocks(T, mp) if c0 < c1)


class _ColumnSplit:
    """The closure rounds of one mesh row of devices `mp` (the first is
    the row's own, where `m` lies): each device holds the whole matrix
    and squares its column block (`closure_square`'s `cols`); then
    every device copies the other blocks of the round from their
    devices (a strided copy, a peer copy between cards) and the round's
    active word is ORed across the row, so each has the next round's
    matrix and word. The copies are stream-ordered on the devices
    (torch waits on both devices' streams around a copy between them):
    nothing is read back, and a loop still enqueues every round."""

    def __init__(self, m: torch.Tensor, mT: torch.Tensor, act: torch.Tensor,
                 mp: list, square: Square | None):
        T = m.shape[-1]
        self.parts = [(torch.device(d), c) for d, c in
                      zip(mp, cs.column_blocks(T, len(mp))) if c[0] < c[1]]
        self.square = cs.closure_square if square is None else square
        self.first = m.device
        # per part: its matrix, its rows of the transpose, its words
        self.state = [[m.to(d), mT.to(d),
                       act if j == 0 and d == m.device
                       else act.to(d, copy=True)]
                      for j, (d, _c) in enumerate(self.parts)]

    def round(self, i: int):
        """Round i: (the whole next matrix on the first device, None,
        the [B] changed flags there)."""
        outs = [self.square(st[0], st[1], st[2][i:i + 2], cols=cols)
                for (_d, cols), st in zip(self.parts, self.state)]
        for o, _oT, _ch in outs:
            for (_d, (c0, c1)), (o2, _o2T, _ch2) in zip(self.parts, outs):
                if o2 is not o:
                    o[:, :, c0:c1].copy_(o2[:, :, c0:c1])
        word = torch.zeros(1, dtype=self.state[0][2].dtype,
                           device=self.first)
        changed = torch.zeros_like(outs[0][2], device=self.first)
        for st, (_o, _oT, ch) in zip(self.state, outs):
            word |= st[2][i + 1:i + 2].to(self.first)
            changed |= ch.to(self.first)
        for st, (o, oT, _ch) in zip(self.state, outs):
            st[2][i + 1:i + 2].copy_(word)
            st[0], st[1] = o, oT
        return self.state[0][0], None, changed


def _closure_batched(m: torch.Tensor, steps: int,
                     square: Square | None = None,
                     rounds: list | None = None,
                     active: torch.Tensor | None = None,
                     stats: list | None = None,
                     mp: list | None = None) -> torch.Tensor:
    """Transitive closure of [B,T,T] boolean adjacencies: `m | eye`
    squared to the batch-level fixpoint, at most `steps` rounds. Path
    lengths double each round, so convergence takes ~log2(diameter)
    rounds. All `steps` rounds are enqueued; round i runs only when word
    i of a device int32 vector is nonzero, and sets word i+1 when it
    changed some history, so the rounds after the fixpoint are skipped
    on the device (copies) with no host read — the reference's
    `lax.while_loop`. Word 0 is 1, or `active` (a device bool or int
    scalar: the closure runs only when it is nonzero). The squaring
    returns the round's transpose, the next round's second operand, made
    once here before the first round. `rounds`, when given, gets the
    closure's round count appended as a device int32 scalar (the
    leading nonzero words; `read_rounds` reads it).

    `stats`, when given (the reference's `_closure_batched_stats`), gets
    two [B] int32 device tensors appended: the round each history's own
    matrix last changed, and the first round at which it held a cycle
    (0: already in `m`; -1: never). They are updated on the device
    after each round from its changed flags and its transpose, with the
    same launches and no host read.

    `mp`, when given (the devices of a mesh row, `m`'s first), splits
    every round's columns over them (`_ColumnSplit`): the same rounds
    and words, `mp_parts` launches a round."""
    T = m.shape[-1]
    m = m | torch.eye(T, dtype=torch.bool, device=m.device)
    mT = m.transpose(1, 2).contiguous()
    act = torch.zeros(steps + 1, dtype=torch.int32, device=m.device)
    if active is None:
        act[0] = 1
    else:
        act[:1].copy_(active.reshape(1))
    split = _ColumnSplit(m, mT, act, mp, square) if mp else None
    if stats is not None:
        nI = ~torch.eye(T, dtype=torch.bool, device=m.device)
        hist_rounds = torch.zeros(m.shape[0], dtype=torch.int32,
                                  device=m.device)
        cyc = torch.where(_has_cycle(m, mT, nI), 0, -1).to(torch.int32)
    for i in range(steps):
        if split is not None:
            m, mT, changed = split.round(i)
        else:
            m, mT, changed = _square(m, mT, act[i:i + 2], square)
        if stats is not None:
            hist_rounds = torch.where(changed, i + 1, hist_rounds)
            cyc = torch.where(
                (cyc < 0) & _has_cycle(m, m.transpose(1, 2) if mT is None
                                       else mT, nI), i + 1, cyc)
    if rounds is not None:
        rounds.append((act[:steps] != 0).sum(dtype=torch.int32))
    if stats is not None:
        stats += [hist_rounds.to(torch.int32), cyc.to(torch.int32)]
    return m


def read_rounds(rounds: list) -> list[int]:
    """The round counts `_closure_batched` appended, read from the device
    at once: one int per closure that ran, a closure skipped whole by its
    first word (the fused path's classification of an acyclic batch)
    left out — the counts a host-driven loop would have made."""
    if not rounds:
        return []
    return [r for r in torch.stack(rounds).tolist() if r]


def _any(x: torch.Tensor) -> torch.Tensor:
    """Per-history any over the trailing [T,T] (or [T]) axes: [B] bool."""
    return x.flatten(1).any(1)


def _graph_stats(edge_counts, rt_cnt, proc_cnt, c_full, rounds,
                 cyc_round, nI) -> torch.Tensor:
    """The [B, N_STATS] int32 stat rows from the full closure: SCC shape
    by mutual reachability (i and j share an SCC iff each reaches the
    other; the closure is reflexive, so nI drops the diagonal), plus the
    edge counts and round telemetry gathered on the way. An SCC's
    representative is its least member, the first True of `mutual[i]`,
    so rows that are their own first True count the SCCs."""
    T = c_full.shape[-1]
    mutual = c_full & c_full.transpose(1, 2)               # [B,T,T]
    on_cycle = (mutual & nI).any(2)                        # [B,T]
    scc_size = mutual.sum(2, dtype=torch.int32)
    cycle_txns = on_cycle.sum(1, dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=c_full.device)
    scc_max = torch.where(on_cycle, scc_size, zero).amax(1)
    scc_min = torch.where(on_cycle, scc_size, zero + T + 1).amin(1)
    scc_min = torch.where(cycle_txns > 0, scc_min, zero)
    first = mutual.to(torch.uint8).argmax(2)
    rep = on_cycle & (first == torch.arange(T, device=c_full.device))
    scc_count = rep.sum(1, dtype=torch.int32)
    margin = torch.where(cyc_round >= 0, cyc_round, rounds)
    return torch.stack(
        [edge_counts[:, 0], edge_counts[:, 1], edge_counts[:, 2],
         rt_cnt, proc_cnt, rounds, cyc_round, scc_count, scc_max,
         scc_min, cycle_txns, margin], 1).to(torch.int32)


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
                           rounds: list | None = None,
                           with_stats: bool = False,
                           edge_counts: torch.Tensor | None = None,
                           mp: list | None = None):
    """Closure + anomaly classification over [B,T,T] boolean edge
    matrices -> [B] int32 flag words. Process-order and realtime edges
    fold into the ww class, masked to each history's live rows.

    With `with_stats`, returns `(flags, stats)` (see STAT_FIELDS): the
    widest closure that runs (the full closure in detect and fused mode,
    the last seeded one in the two-pass chain) supplies the round
    telemetry, and `edge_counts` ([B,3], from `_edges_batched`) the
    ww/wr/rw counts; None (host-built matrices, which hold no shortcut
    edges) counts the incoming matrices. `mp` splits every closure
    round over a mesh row's devices (`_closure_batched`)."""
    T = ww.shape[-1]
    dev = ww.device
    B = ww.shape[0]
    nI = ~torch.eye(T, dtype=torch.bool, device=dev)
    live = torch.arange(T, device=dev)[None, :] < n_live[:, None]   # [B,T]
    live2 = live[:, :, None] & live[:, None, :]                     # [B,T,T]
    if with_stats:
        if edge_counts is None:
            edge_counts = torch.stack(
                [ww.flatten(1).sum(1), wr.flatten(1).sum(1),
                 rw.flatten(1).sum(1)], 1).to(torch.int32)
        rt_cnt = torch.zeros(B, dtype=torch.int32, device=dev)
        proc_cnt = torch.zeros(B, dtype=torch.int32, device=dev)

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
        proc_add = cand & (big == nxt)
        if with_stats:
            proc_cnt = proc_add.flatten(1).sum(1).to(torch.int32)
        ww = ww | proc_add
    if realtime:
        # j completed before i invoked => j precedes i in real time.
        # Indeterminate txns carry NEVER_COMPLETED and emit no rt edges.
        rt = complete_index[:, :, None] < invoke_index[:, None, :]
        rt_add = rt & live2 & nI
        if with_stats:
            rt_cnt = rt_add.flatten(1).sum(1).to(torch.int32)
        ww = ww | rt_add

    def closure(m, active=None):
        return _closure_batched(m, steps, square, rounds, active, mp=mp)

    def widest(m):
        """The widest closure, with its round telemetry under stats."""
        tel: list | None = [] if with_stats else None
        return _closure_batched(m, steps, square, rounds, stats=tel,
                                mp=mp), tel

    def result(flags, c_full, tel):
        if not with_stats:
            return flags
        return flags, _graph_stats(edge_counts, rt_cnt, proc_cnt, c_full,
                                   tel[0], tel[1], nI)

    wwr = ww | wr
    full = wwr | rw
    if not classify:
        c_full, tel = widest(full)
        cycle = _any(full & c_full.transpose(1, 2) & nI)
        return result(cycle.to(torch.int32) << CYCLE, c_full, tel)
    if fused:
        # Fused detect/classify: run the detect closure first, and the
        # classification closures only when some history in the batch
        # is cyclic — a device-side condition, as the reference's
        # lax.cond: "any cycle" is their first active word, and the
        # flags are masked by it, reusing the full closure. Exact:
        # every per-class witness implies a cycle in the full graph, so
        # an acyclic batch classifies to zero flags.
        c_full, tel = widest(full)
        cycle = _any(full & c_full.transpose(1, 2) & nI)
        any_cycle = cycle.any()
        c_ww = closure(ww, any_cycle)
        c_wwr = closure(c_ww | wr, any_cycle)
        return result(torch.where(
            any_cycle,
            _flags_from_closures(ww, wr, rw, c_ww, c_wwr, c_full, cycle,
                                 nI),
            cycle.to(torch.int32) << CYCLE), c_full, tel)
    # Two-pass chain of warm starts: closure(A|B) == closure(closure(A)|B),
    # so each wider closure is seeded with the previous one.
    c_ww = closure(ww)
    c_wwr = closure(c_ww | wr)
    c_full, tel = widest(c_wwr | rw)
    cycle = _any(full & c_full.transpose(1, 2) & nI)
    return result(_flags_from_closures(ww, wr, rw, c_ww, c_wwr, c_full,
                                       cycle, nI), c_full, tel)


def check_batched_impl(appends, reads, invoke_index, complete_index, process,
                       n_live, *, n_keys: int, max_pos: int, n_txns: int,
                       steps: int, classify: bool, realtime: bool,
                       process_order: bool, fused: bool = True,
                       square: Square | None = None,
                       rounds: list | None = None,
                       with_stats: bool = False, mp: list | None = None):
    """THE cycle-check kernel: packed [B,...] tensors -> [B] int32 flag
    words (`(flags, stats)` with `with_stats`). `n_live` is the
    per-history real txn count ([B]); rows beyond it are excluded from
    realtime/process edges."""
    ww, wr, rw, *counts = _edges_batched(appends, reads, n_keys, max_pos,
                                         n_txns, with_counts=with_stats)
    return classify_matrices_impl(
        ww, wr, rw, invoke_index, complete_index, process, n_live,
        steps=steps, classify=classify, realtime=realtime,
        process_order=process_order, fused=fused, square=square,
        rounds=rounds, with_stats=with_stats,
        edge_counts=counts[0] if counts else None, mp=mp)


def check_batch_device(batch: dict, *, classify: bool = True,
                       realtime: bool = False, process_order: bool = False,
                       fused: bool = True, square: Square | None = None,
                       rounds: list | None = None,
                       with_stats: bool = False, mp: list | None = None):
    """Entry over a device-resident packed batch (from
    `batch_to_device`): [B] int32 flag words, on the batch's device,
    enqueued with no read of the device (`(flags, stats)`, the
    [B, N_STATS] matrix, with `with_stats`). `square` replaces the
    squaring (e.g. with `closure_square_ref` to run the plain version on
    cuda; with `mp` it takes `cols=` too); `rounds` collects each
    closure's device round counter (`read_rounds` reads them); `mp`, the
    devices of a mesh row (the batch's first), splits the closure rounds
    over them."""
    shape: BatchShape = batch["shape"]
    return check_batched_impl(
        batch["appends"], batch["reads"], batch["invoke_index"],
        batch["complete_index"], batch["process"], batch["n_txns"],
        n_keys=shape.n_keys, max_pos=shape.max_pos, n_txns=shape.n_txns,
        steps=closure_steps(shape.n_txns), classify=classify,
        realtime=realtime, process_order=process_order, fused=fused,
        square=square, rounds=rounds, with_stats=with_stats, mp=mp)


def classify_matrices_device(batch: dict, *, classify: bool = True,
                             realtime: bool = False,
                             process_order: bool = False,
                             fused: bool = True,
                             square: Square | None = None,
                             rounds: list | None = None,
                             with_stats: bool = False,
                             mp: list | None = None):
    """Entry over a device-resident packed edge batch (from
    `edge_batch_to_device`): [B] int32 flag words, on the batch's
    device. `square`, `rounds`, `with_stats` and `mp` as in
    `check_batch_device`."""
    return classify_matrices_impl(
        batch["ww"], batch["wr"], batch["rw"], batch["invoke_index"],
        batch["complete_index"], batch["process"], batch["n_txns"],
        steps=closure_steps(batch["T"]), classify=classify,
        realtime=realtime, process_order=process_order, fused=fused,
        square=square, rounds=rounds, with_stats=with_stats, mp=mp)


#: The edge classes an edge batch takes (graph.WW, graph.WR, graph.RW),
#: by the name of the matrix each fills. Realtime and process edges are
#: built on the device from the timing tensors instead.
EDGE_CLASSES = {"ww": 0, "wr": 1, "rw": 2}


def pack_edge_matrices(per_history: list[dict], multiple: int = 128,
                       t_pad: int | None = None) -> dict:
    """Pack host-built sparse edges for the device-side scatter.

    per_history: dicts with keys n (txn count), edges ((src, dst, cls)
    triples as a list or an [E,3] array, cls in {graph.WW, WR, RW}),
    invoke_index, complete_index, process (arrays of length n).

    Returns numpy arrays: per edge class, the [E,3] (history, src, dst)
    cells to set (self-loops dropped), the [B,T] timing arrays, the [B]
    txn counts and T, the padded txn count. The [B,T,T] matrices
    themselves are made on the device (`edge_batch_to_device`), so only
    the index lists cross to it. `t_pad` fixes T (a mesh row packed to
    its bucket's T). An edge of another class, or with an end outside
    [0, n), raises ValueError."""
    B = len(per_history)
    T = pad_to(max((h["n"] for h in per_history), default=1), multiple) \
        if t_pad is None else t_pad
    invoke_idx = np.zeros((B, T), np.int64)
    complete_idx = np.zeros((B, T), np.int64)
    process = np.full((B, T), -1, np.int32)
    n_live = np.zeros((B,), np.int32)
    cells: dict = {name: [] for name in EDGE_CLASSES}
    for i, hist in enumerate(per_history):
        n = hist["n"]
        e = np.asarray(hist["edges"], np.int32).reshape(-1, 3)
        s, d, c = e[:, 0], e[:, 1], e[:, 2]
        known = np.isin(c, list(EDGE_CLASSES.values()))
        if not known.all():
            raise ValueError(f"history {i}: edge class {int(c[~known][0])} "
                             "is not ww, wr or rw")
        if ((s < 0) | (s >= n) | (d < 0) | (d >= n)).any():
            raise ValueError(f"history {i}: an edge leaves its {n} txns")
        keep = s != d
        for name, cls in EDGE_CLASSES.items():
            m = keep & (c == cls)
            cells[name].append(np.stack(
                [np.full(int(m.sum()), i, np.int64), s[m], d[m]], axis=1))
        n_live[i] = n
        invoke_idx[i, :n] = hist["invoke_index"]
        complete_idx[i, :n] = hist["complete_index"]
        process[i, :n] = hist["process"]
    out = {name: np.concatenate(c) if c else np.zeros((0, 3), np.int64)
           for name, c in cells.items()}
    out.update(invoke_index=invoke_idx, complete_index=complete_idx,
               process=process, n_txns=n_live, T=T)
    return out


def edge_batch_to_device(packed: dict, device: torch.device) -> dict:
    """The host->device copy of a packed edge batch: the timing arrays
    as int64 tensors and, per edge class, a [B,T,T] bool matrix
    scattered on `device` from its cell list."""
    T = packed["T"]
    B = len(packed["n_txns"])
    out = {k: torch.as_tensor(np.asarray(packed[k])).to(device=device,
                                                         dtype=torch.int64)
           for k in ("invoke_index", "complete_index", "process",
                     "n_txns")}
    for name in EDGE_CLASSES:
        bsd = torch.as_tensor(packed[name]).to(device)
        flat = (bsd[:, 0] * T + bsd[:, 1]) * T + bsd[:, 2]
        m = torch.zeros(B * T * T, dtype=torch.bool, device=device)
        m.index_fill_(0, flat, True)
        out[name] = m.view(B, T, T)
    out["T"] = T
    return out


def check_edge_batch(per_history: list[dict], device=None, *,
                     devices=None,
                     realtime: bool = False, process_order: bool = False,
                     classify: bool = True, fused: bool | None = None,
                     square: Square | None = None,
                     stats_out: list | None = None) -> list[dict]:
    """Device cycle check over host-built edge lists: per-history
    {anomaly-name: True} dicts (the rw-register path, and the per-SCC
    classify stage of the condensed long-history path), on `device`
    (default cuda; see devices.resolve_device), or split over several
    `devices` (a 1-D dp mesh, a ragged batch padded by replicating its
    last entry). One dispatch (`parallel.check_once`), its wait bounded
    by the dispatch watchdog (WatchdogTimeout after two timeouts).
    `fused` defaults to the JEPSEN_TPU_FUSED_CLASSIFY gate, `square` as
    in `check_batch_device`. `stats_out`, when given, is extended with
    one `stats_row` dict per history (the check then also computes the
    stats matrix)."""
    return _check_once(per_history, device, devices, stats_out,
                       classify=classify, realtime=realtime,
                       process_order=process_order,
                       fused=fused_classify_enabled() if fused is None
                       else fused, square=square)


def check_encoded_batch(encs: list[EncodedHistory], device=None, *,
                        devices=None, realtime: bool = False,
                        process_order: bool = False, classify: bool = True,
                        square: Square | None = None,
                        stats_out: list | None = None) -> list[dict]:
    """`check_edge_batch` for encoded histories: one dispatch of all of
    them, the edges built on the device, the fused classify by its
    gate."""
    return _check_once(encs, device, devices, stats_out, classify=classify,
                       realtime=realtime, process_order=process_order,
                       fused=fused_classify_enabled(), square=square)


def _check_once(items: list, device, devices, stats_out: list | None,
                **kw) -> list[dict]:
    if not items:
        return []
    from ...devices import resolve_device
    from ...parallel import check_once
    words = check_once(items, list(devices) if devices
                       else [resolve_device(device)], kw=kw,
                       with_stats=stats_out is not None)
    if stats_out is not None:
        stats_out.extend(st for _w, st in words)
        words = [w for w, _st in words]
    return [flags_to_names(w) for w in words]


def check_edge_batch_bucketed(per_history: list[dict], device=None, *,
                              devices=None,
                              realtime: bool = False,
                              process_order: bool = False,
                              classify: bool = True,
                              budget_cells: int = 1 << 27,
                              fused: bool | None = None,
                              square: Square | None = None,
                              bucket_log: list | None = None,
                              stats_out: list | None = None
                              ) -> list[dict]:
    """check_edge_batch over length buckets (parallel.bucket_by_length:
    B·T_pad² cells per bucket under `budget_cells`, for each of the
    three edge matrices), results in input order, on `device` (default
    cuda). The buckets go through `parallel.check_bucketed_async`, one
    on the device at a time, unsupervised: a bucket's OOM, watchdog
    timeout or packing failure raises to the caller, which owns that
    policy (the wr sweep's `cli._wr_chunk_with_backdown`, the long run's
    quarantine). `bucket_log` as in `parallel.check_bucketed`;
    `stats_out`, when given, is extended with one `stats_row` dict per
    history, in input order, once every bucket has resolved. With
    several `devices` every bucket is split over them (a 1-D dp mesh,
    buckets planned with its padding headroom)."""
    if not per_history:
        return []
    from ...devices import resolve_device
    from ...parallel import Mesh, check_bucketed_async
    mesh = Mesh([[d] for d in devices]) \
        if devices is not None and len(devices) > 1 else None
    pv = check_bucketed_async(
        per_history, resolve_device(device if not devices else devices[0]),
        mesh=mesh, classify=classify,
        realtime=realtime, process_order=process_order,
        budget_cells=budget_cells, fused=fused, max_inflight=1,
        square=square, bucket_log=bucket_log, supervise=False,
        with_stats=stats_out is not None)
    out = pv.result()
    if stats_out is not None:
        stats_out.extend(pv.stats())
    return out


def flags_to_names(word: int) -> dict:
    """Anomaly names for a flag word. In detect-only mode (classify=False)
    no classify bits exist, so a set CYCLE bit reports as a generic
    "cycle" anomaly rather than vanishing."""
    out = {name: True for bit, name in FLAG_NAMES.items()
           if word & (1 << bit)}
    if not out and word & (1 << CYCLE):
        out["cycle"] = True
    return out

