"""The dense configuration grid: the knossos `linear` search of a batch
of CAS-register histories as bit algebra over every configuration.

Counterpart of `jepsen_tpu/checker/knossos/dense.py`. A configuration
is (register value, which pending slots it has applied); the grid holds
all of them at once, `valid[V, M]` with V interned values and M = 2^S
slot masks, so dedup is free and there is no frontier overflow: the
verdicts are exact, never "unknown". Two exact reductions keep it small:
indeterminate reads are dropped at encode time (they never filter and
never change the register), and the walk visits completions only — the
pending-slot register file at each completion is precomputed on the
host as a [C, S, 4] timeline.

The walk over C completion steps, each with up to S+2 expansion rounds,
is the hand kernel `knossos_dense_scan` (`csrc/knossos_dense.cu`, the
whole walk in one launch: one warp a history with the grid in registers
for grids of up to `WARP_MAX_WORDS` words, else one block a history with
the grid in shared memory; `plan_scan` picks) on a CUDA tensor, and its
plain PyTorch version `scan_dense_ref` on a CPU tensor.
Histories past the grid's budgets (more than 14 pending slots, more
than 64 values) raise EncodingError and go to the bounded frontier
(`.kernels`) or the CPU oracle.

`knossos_dense_scan.launches` counts kernel launches (never plain-version
calls); `knossos_dense_scan.events`, when set to a list, gets a (start,
end) CUDA event pair appended around each launch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .encode import CAS, READ, WRITE, EncodingError, _reduced_seq

#: The kernel's grid budget: S <= 14 slots (2^14 masks), V <= 64 values.
MAX_SLOTS, MAX_VALUES = 14, 64
#: The warp tier holds grids of up to this many 32-bit words (V rounded
#: up to a power of two, at least 8): 16 words a lane, the most its
#: instantiations hold in registers without spilling. Larger grids take
#: the block tier.
WARP_MAX_WORDS = 512
#: The block tier keeps up to this many of a thread's words' new values
#: in registers, the rest in shared memory past the grid.
BLOCK_MAX_REG_WORDS = 8
#: Histories (warps) a block of the warp tier.
WARP_HISTORIES_PER_BLOCK = 2
#: Threads a block may have.
MAX_THREADS = 1024

_F_CODES = {"read": READ, "write": WRITE, "cas": CAS}


@dataclass
class DenseEncoded:
    """Per-completion slot-register timeline for one history."""

    regs: np.ndarray       # [C, S, 4] int32: (f|-1, a1, a2, known)
    comp_slot: np.ndarray  # [C] int32: slot completing at each step
    n_steps: int
    n_slots: int
    n_values: int
    n_ops: int             # determinate+indeterminate ops linearized over


def encode_dense_history(raw_history: list[dict], max_slots: int = 14,
                         max_values: int = 64) -> DenseEncoded:
    """Compile one register history to the dense kernel's timeline."""
    hist = _reduced_seq(raw_history)   # dict-free reduce_history twin

    # Which invocations never complete determinately? (info ops, and
    # open calls at history end). Info *reads* are dropped entirely.
    opens: dict = {}
    determinate: set[int] = set()
    for i, (kind, p, f, v) in enumerate(hist):
        if kind == 0:
            opens[p] = i
        elif p in opens:
            j = opens.pop(p)
            if kind != 1:
                determinate.add(j)

    intern: dict = {None: 0}
    values: list = [None]

    vkind: dict[int, str] = {}

    def vid(v):
        # same list/tuple ambiguity rule as encode.vid: equating what
        # the model distinguishes is unencodable
        kind = ("list" if isinstance(v, list)
                else "tuple" if isinstance(v, tuple) else "scalar")
        if kind == "list":
            v = tuple(v)
        i = intern.get(v)
        fresh = i is None
        if fresh:
            i = len(values)
            intern[v] = i
            values.append(v)
        if kind != "scalar" and vkind.setdefault(i, kind) != kind:
            raise EncodingError(
                "value interned from both a list and an equal tuple")
        if fresh:
            if len(values) > max_values:
                raise EncodingError(
                    f"more than {max_values} distinct register values")
        return i

    S = max_slots
    regs = np.full((S, 4), -1, np.int32)
    regs[:, 1:] = 0
    slot_of: dict = {}
    free = list(range(S))  # kept sorted: lowest slot first, compact peak
    steps_regs: list[np.ndarray] = []
    steps_comp: list[int] = []
    n_ops = 0
    peak = 1

    for i, (kind, p, fname, v) in enumerate(hist):
        if kind == 0:
            f = _F_CODES.get(fname)
            if f is None:
                raise EncodingError(f"unencodable op f={fname!r}")
            if i not in determinate and f == READ:
                continue  # reduction 1: info reads constrain nothing
            if not free:
                raise EncodingError(
                    f"concurrency exceeds {S} pending slots")
            slot = free.pop(0)
            peak = max(peak, slot + 1)
            slot_of[p] = slot
            if f == CAS:
                if not (isinstance(v, (list, tuple)) and len(v) == 2):
                    raise EncodingError(f"cas value {v!r} is not [old new]")
                row = (f, vid(v[0]), vid(v[1]), 1)
            elif f == WRITE:
                row = (f, vid(v), 0, 1)
            else:
                known = 0 if v is None else 1
                row = (f, vid(v) if known else 0, 0, known)
            regs[slot] = row
            n_ops += 1
        elif p in slot_of:
            slot = slot_of.pop(p)
            if kind == 1:
                continue  # return at infinity: slot stays occupied
            steps_regs.append(regs.copy())
            steps_comp.append(slot)
            regs[slot] = (-1, 0, 0, 0)
            free.append(slot)
            free.sort()

    C = len(steps_regs)
    return DenseEncoded(
        regs=(np.stack(steps_regs)[:, :peak] if C
              else np.full((0, peak, 4), -1, np.int32)),
        comp_slot=np.asarray(steps_comp, np.int32),
        n_steps=C, n_slots=peak, n_values=len(values), n_ops=n_ops)


@dataclass(frozen=True)
class DenseBatchShape:
    n_steps: int
    n_slots: int
    n_values: int

    @staticmethod
    def plan(encs: list[DenseEncoded], multiple: int = 8,
             v_multiple: int = 8) -> "DenseBatchShape":
        c = max((e.n_steps for e in encs), default=1)
        c = max(multiple, -(-c // multiple) * multiple)
        v = max((e.n_values for e in encs), default=1)
        v = max(v_multiple, -(-v // v_multiple) * v_multiple)
        return DenseBatchShape(
            n_steps=c,
            n_slots=max((e.n_slots for e in encs), default=1),
            n_values=v)


def pack_dense_batch(encs: list[DenseEncoded],
                     shape: DenseBatchShape | None = None) -> dict:
    """Stack timelines into [B, C, S, 4] / [B, C]; pad steps with
    comp_slot = -1 (a no-op step: no expansion, no filter)."""
    shape = shape or DenseBatchShape.plan(encs)
    B = len(encs)
    regs = np.full((B, shape.n_steps, shape.n_slots, 4), -1, np.int32)
    regs[..., 1:] = 0
    comp = np.full((B, shape.n_steps), -1, np.int32)
    for i, e in enumerate(encs):
        if (e.n_steps > shape.n_steps or e.n_slots > shape.n_slots
                or e.n_values > shape.n_values):
            raise ValueError(f"history {i} exceeds batch shape {shape}")
        regs[i, : e.n_steps, : e.n_slots] = e.regs
        comp[i, : e.n_steps] = e.comp_slot
    return {"regs": regs, "comp": comp, "shape": shape}



def _mask_tables(S: int, device: torch.device):
    """[S, M] tables over masks m: has bit s, m ^ bit_s, m | bit_s."""
    m = torch.arange(1 << S, device=device)
    bit = (1 << torch.arange(S, device=device))[:, None]
    return (m & bit) != 0, m ^ bit, m | bit


def scan_dense_ref(regs: torch.Tensor, comp: torch.Tensor, n_values: int,
                   n_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the scan: regs [B,C,S,4] int32, comp [B,C]
    int32 -> (valid [B] bool, rounds [B] int32, the expansion rounds
    run). Batched over B; a loop over the C steps and S+2 rounds, each
    round gated per history by its own `changed & (round < S+2)` — what
    vmap of the reference's while_loop does — with no host sync in the
    loop on a card (on the CPU a step stops once no history is still
    active). A round loops over slots and accumulates add[B,V,M] rather
    than materialising all slots at once."""
    B, C, S, _ = regs.shape
    V, dev = n_values, regs.device
    on_cpu = dev.type == "cpu"
    has, flip, up = _mask_tables(S, dev)
    grid = torch.zeros((B, V, 1 << S), dtype=torch.bool, device=dev)
    grid[:, 0, 0] = True
    v_ids = torch.arange(V, device=dev)[None, :, None]         # [1,V,1]
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    for c in range(C):
        f, a1, a2, known = regs[:, c].unbind(-1)                # [B,S]
        cs = comp[:, c]
        is_r, is_w = f == READ, f == WRITE
        eq_a1 = v_ids == a1[:, None, :]                         # [B,V,S]
        # ok[b, u, s]: may a configuration with value u apply slot s?
        ok = torch.where(is_r[:, None], (known == 0)[:, None] | eq_a1,
                         torch.where((f == CAS)[:, None], eq_a1,
                                     is_w[:, None]))
        # where slot s sends its configurations: read keeps the value,
        # write goes to a1, cas to a2 (its sources are row a1 alone, so
        # the any over rows below is the reference's row a1)
        target = torch.where(is_w[:, None], eq_a1, v_ids == a2[:, None, :])
        active = cs >= 0
        rnd = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(S + 2):
            if on_cpu and not bool(active.any()):
                break        # no host sync on a card; here it costs nothing
            add = torch.zeros_like(grid)
            for s in range(S):
                # x[b, u, m] = grid[b, u, m ^ bit_s] for m with bit s
                x = grid.index_select(2, flip[s]) & has[s] \
                    & ok[:, :, s, None]
                moved = target[:, :, s, None] & x.any(1, keepdim=True)
                add |= torch.where(is_r[:, s, None, None], x, moved)
            now = grid | add
            changed = (now != grid).flatten(1).any(1)
            grid = torch.where(active[:, None, None], now, grid)
            rnd += active
            active &= changed & (rnd < S + 2)
        rounds += rnd
        # the completion deadline: grid'[v, m] = grid[v, m | bit_cs] for
        # m lacking cs; no slot cs < S empties the grid
        k = cs.clamp(0, S - 1)
        retired = grid.gather(2, up[k][:, None, :].expand_as(grid)) \
            & ~has[k][:, None, :] & (cs < S)[:, None, None]
        grid = torch.where((cs >= 0)[:, None, None], retired, grid)
    return grid.flatten(1).any(1), rounds


@dataclass(frozen=True)
class ScanPlan:
    """How `knossos_dense_scan` launches for one (S, V): the tier
    ("warp": one warp a history, the grid in registers; "block": one
    block a history, the grid in shared memory), threads a block,
    dynamic shared memory a block, and histories a block."""

    tier: str
    threads: int
    smem_bytes: int
    histories_per_block: int


def grid_words(n_slots: int, n_values: int) -> tuple[int, int]:
    """(words a row, words of the grid) of the [V, 2^S]-bit grid."""
    w = 1 << max(0, n_slots - 5)
    return w, n_values * w


def warp_values(n_values: int) -> int:
    """Rows the warp tier lays a grid of V values out as: V rounded up
    to a power of two, at least 8 (8 rows across a warp's lanes)."""
    return max(8, 1 << (n_values - 1).bit_length())


def plan_scan(n_slots: int, n_values: int, *,
              histories_per_block: int = WARP_HISTORIES_PER_BLOCK,
              warp_max_words: int = WARP_MAX_WORDS) -> ScanPlan:
    """The launch of `knossos_dense_scan` for S slots and V values: the
    warp tier while the grid, with V rounded up (`warp_values`), has at
    most `warp_max_words` words, else the block tier (threads enough
    for at most 32 words each; the grid and the rows' OR in shared
    memory, and past them the new values of a round's words beyond 8 a
    thread). The kernel refuses a warp-tier grid past 512 words."""
    w, words = grid_words(n_slots, n_values)
    if warp_values(n_values) * w <= min(warp_max_words, WARP_MAX_WORDS):
        return ScanPlan("warp", 32 * histories_per_block, 0,
                        histories_per_block)
    threads = min(MAX_THREADS, -(-words // 32) * 32)
    in_regs = threads * min(BLOCK_MAX_REG_WORDS,
                            1 << (-(-words // threads) - 1).bit_length())
    return ScanPlan("block", threads,
                    4 * (words + w + max(0, words - in_regs)), 1)


def _check_scan_args(regs: torch.Tensor, comp: torch.Tensor, n_values: int,
                     n_slots: int) -> None:
    for name, x in (("regs", regs), ("comp", comp)):
        if x.dtype != torch.int32:
            raise TypeError(f"knossos_dense_scan takes int32 tensors, got "
                            f"{name} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"knossos_dense_scan takes contiguous tensors "
                             f"({name} is not)")
    if regs.dim() != 4 or regs.shape[3] != 4 or regs.shape[2] != n_slots:
        raise ValueError(f"regs must be [B,C,{n_slots},4], got "
                         f"{tuple(regs.shape)}")
    if tuple(comp.shape) != tuple(regs.shape[:2]) \
            or comp.device != regs.device:
        raise ValueError(f"comp {tuple(comp.shape)} on {comp.device} does "
                         f"not match regs {tuple(regs.shape)} on "
                         f"{regs.device}")
    if not (1 <= n_slots <= MAX_SLOTS and 1 <= n_values <= MAX_VALUES):
        raise ValueError(f"the grid takes 1..{MAX_SLOTS} slots and "
                         f"1..{MAX_VALUES} values, got S={n_slots}, "
                         f"V={n_values}")


def knossos_dense_scan(regs: torch.Tensor, comp: torch.Tensor,
                       n_values: int, n_slots: int, plan: ScanPlan | None
                       = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense scan of a batch (regs [B,C,S,4] int32, comp [B,C]
    int32, contiguous, S <= 14, V <= 64): returns (valid [B] bool,
    rounds [B] int32) from the CUDA kernel for CUDA tensors, launched as
    `plan` says (default `plan_scan(S, V)`), from the plain version for
    CPU tensors. The two agree exactly on both outputs: the kernel's
    rounds are Jacobi rounds, as the plain version's and the
    reference's are."""
    _check_scan_args(regs, comp, n_values, n_slots)
    if regs.device.type == "cpu":
        return scan_dense_ref(regs, comp, n_values, n_slots)
    if regs.device.type != "cuda":
        raise ValueError(f"knossos_dense_scan runs on cuda or cpu, not "
                         f"{regs.device}")
    if regs.data_ptr() % 16:
        raise ValueError("knossos_dense_scan takes regs aligned to 16 bytes")
    B, C = comp.shape
    valid = torch.empty(B, dtype=torch.bool, device=regs.device)
    rounds = torch.empty(B, dtype=torch.int32, device=regs.device)
    if B == 0:
        return valid, rounds
    from ... import _build

    plan = plan or plan_scan(n_slots, n_values)
    lib = _build.load("knossos_dense")
    stream = torch.cuda.current_stream(regs.device)
    events = knossos_dense_scan.events
    if events is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    rc = lib.knossos_dense_launch(
        regs.data_ptr(), comp.data_ptr(), valid.data_ptr(),
        rounds.data_ptr(), B, C, n_slots, n_values,
        0 if plan.tier == "warp" else 1, plan.threads, regs.device.index,
        stream.cuda_stream)
    if rc != 0:
        msg = lib.knossos_dense_error_string(rc).decode()
        raise RuntimeError(f"knossos_dense_scan launch failed (B={B}, C={C},"
                           f" S={n_slots}, V={n_values}, {plan}): {msg}")
    knossos_dense_scan.launches += 1
    if events is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        events.append((start, end))
    return valid, rounds


knossos_dense_scan.launches = 0
knossos_dense_scan.events = None


def check_dense_device(regs: torch.Tensor, comp: torch.Tensor, *,
                       n_values: int, n_slots: int, scan=None
                       ) -> torch.Tensor:
    """Batched entry: regs [B,C,S,4], comp [B,C] -> valid [B] bool,
    through `scan` (default `knossos_dense_scan`: the hand kernel on a
    CUDA tensor, `scan_dense_ref` only on a CPU tensor)."""
    return (scan or knossos_dense_scan)(regs, comp, n_values, n_slots)[0]


def check_encoded_dense_batch(encs: list[DenseEncoded],
                              device: torch.device | str = "cuda",
                              scan=None) -> list[dict]:
    """Check dense-encoded histories on `device`; exact verdicts
    `{"valid?", "analyzer": "tpu-dense", "op-count"}` (the reference's
    analyzer name, a byte of the stored verdict).

    Histories are bucketed by pending-slot peak rounded up to even (one
    high-concurrency history must not double M = 2^S for the whole
    batch), one dispatch a bucket. `scan` replaces the scan (e.g.
    `scan_dense_ref` in place of the kernel); `bucket_log` gets one
    dict per bucket (histories, n_steps, n_slots, n_values, seconds)."""
    if not encs:
        return []
    buckets: dict[int, list[int]] = {}
    for i, e in enumerate(encs):
        buckets.setdefault(e.n_slots + (e.n_slots & 1), []).append(i)
    out: list[dict | None] = [None] * len(encs)
    for _slots, idxs in sorted(buckets.items()):
        batch = pack_dense_batch([encs[i] for i in idxs])
        shape: DenseBatchShape = batch["shape"]
        valid = check_dense_device(
            torch.from_numpy(batch["regs"]).to(device),
            torch.from_numpy(batch["comp"]).to(device),
            n_values=shape.n_values, n_slots=shape.n_slots,
            scan=scan).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = {"valid?": bool(valid[j]), "analyzer": "tpu-dense",
                      "op-count": encs[i].n_ops}
    return out  # type: ignore[return-value]
