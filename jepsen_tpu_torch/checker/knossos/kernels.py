"""The bounded sorted frontier: the knossos `linear` search for histories
past the dense grid's budgets.

Counterpart of `jepsen_tpu/checker/knossos/kernels.py`. A configuration
is two integers, (interned register state, bitmask of applied pending
slots); the frontier is a fixed arena of F of them per history, kept
sorted and deduplicated. At each completion event an expansion runs to
fixpoint — every occupied, unapplied slot applied to every live
configuration at once ([F, S] candidates), merged with the originals
and compacted by two stable sorts — and the completion then keeps only
the configurations that linearized the op. Indeterminate (:info) ops
hold a slot forever and never filter.

The reference's event walk is a `lax.scan` with a `lax.while_loop` of
up to S+2 rounds at each step, vmapped over histories. On a CUDA tensor
the whole walk is the hand kernel `knossos_frontier_scan`
(`csrc/knossos_frontier.cu`: one block a history, every event and round
in one launch, this frontier and its packed twin `.packed` alike). Its
plain PyTorch version, `_scan_history`, runs for a CPU tensor: the batch
dimension written out, a loop over events and, at a step where some
history completes, over rounds, each round gated per history by its own
`changed & (round < S+2)` exactly as vmap gates the while_loop (the loop
ends when no history is still changing, one host read a round). The
compaction returns the reference's arrays exactly, so the exit test,
which compares whole arrays, runs the same rounds in both.

Overflow (more live configurations than F) degrades the verdict to
"unknown" (`":frontier-overflow"`), never to a wrong answer; the
checker re-runs those histories on the CPU oracle. `check_encoded_batch`
routes a batch whose packed configurations fit an int32 to `.packed`,
except under stats: as in the reference, only this frontier carries the
search telemetry (per history the peak frontier width before
truncation, the expansion rounds and the candidate configurations
generated).

`knossos_frontier_scan.launches` counts kernel launches (never
plain-version calls); `knossos_frontier_scan.events`, when set to a
list, gets a (start, end) CUDA event pair appended around each launch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from ...util import pad_to_multiple
from .encode import (CAS, COMPLETE_EV, INVOKE_EV, READ, WRITE,
                     EncodedRegisterHistory, RegisterBatchShape,
                     pack_register_batch)

_BIG = 2**31 - 1

#: The composite sort keys hold a mask in 24 bits (the encoder's own
#: slot budget, `encode_register_history(max_slots=24)`) and a state
#: in 31.
MAX_SLOTS = 24
#: The packed configuration `state << S | mask` needs S < 31.
MAX_SLOTS_PACKED = 30
#: Shared memory a block may opt into on Hopper (227 KB).
MAX_SMEM = 232_448
#: A block's shared bytes past the arrays: the scan's 32 warp totals
#: and each warp's last key (8 bytes each), the slot table (4 x 32
#: int32) and the events' mbarrier (16 bytes). Past them the kernel
#: stages a history's events where they fit (its decision alone).
SMEM_TAIL = 32 * 8 + 32 * 8 + 4 * 32 * 4 + 16
#: Keys a thread of the shared tier's register walk wherever 1,024
#: threads hold the sort (the kernel's KEYS).
KEYS = 8
#: The most device memory the global tier's workspace takes: its blocks
#: (each one history at a time) are as many as fit, at least one.
WORKSPACE_BYTES = 1 << 30


def _step_register(state, f, a1, a2, known):
    """Vectorized CAS-register transition. Returns (ok, new_state).

    read: legal iff value unknown or equal to state; write: always
    legal; cas [old new]: legal iff state == old. A linearized cas
    always succeeds — a failed cas is a no-op, represented by *not*
    linearizing it."""
    is_w = f == WRITE
    is_c = f == CAS
    is_r = f == READ
    ok = torch.where(is_r, (known == 0) | (state == a1),
                     torch.where(is_c, state == a1, True))
    new = torch.where(is_w, a1, torch.where(is_c, a2, state))
    return ok, new


def _sorted_unique(states, masks, valid, F: int):
    """Sort (state, mask) pairs [B, N] with invalid entries last, mark
    first occurrences, compact the unique live ones into the first F
    slots. Returns (states, masks, valid [B, F], n_unique [B]) — the
    reference's arrays exactly: its two stable sorts, on (state, mask)
    and then on (dropped, state, mask), are one stable sort each here
    on a composite int64 key (states < 2^31 and masks < 2^24, both
    non-negative)."""
    k1 = torch.where(valid, states, _BIG)
    k2 = torch.where(valid, masks, _BIG)
    order = torch.sort((k1 << 32) | k2, dim=1, stable=True).indices
    k1, k2, s, m, v = (x.gather(1, order) for x in (k1, k2, states, masks,
                                                     valid))
    first = torch.ones_like(v)
    first[:, 1:] = (k1[:, 1:] != k1[:, :-1]) | (k2[:, 1:] != k2[:, :-1])
    keep = first & v
    n_unique = keep.sum(1)
    # canonical compaction: kept entries to the front in (state, mask)
    # order, a deterministic arrangement of the set, so the fixpoint's
    # equality exit is well defined
    order = torch.sort(((~keep).long() << 55) | (s << 24) | m, dim=1,
                       stable=True).indices
    s, m, keep = (x.gather(1, order) for x in (s, m, keep))
    return s[:, :F], m[:, :F], keep[:, :F], n_unique


def _expand_fixpoint(states, masks, valid, slot_f, slot_a1, slot_a2,
                     slot_known, enabled, F: int, S: int,
                     with_stats: bool = False):
    """Close each history's frontier under single-op linearization:
    rounds apply every occupied, unapplied slot to every configuration
    until the sorted frontier stops changing (or S+2 rounds), for the
    histories in `enabled` [B]. Returns (states, masks, valid,
    overflow [B]), and with `with_stats` also (peak, rounds, explored)
    [B]: the most unique configurations a round found, the rounds run,
    the candidates the rounds generated — each counted over the rounds
    the history itself ran, as vmap of the reference's loop counts."""
    bits = 1 << torch.arange(S, dtype=torch.int64, device=states.device)
    occupied = (slot_f >= 0)[:, None, :]                       # [B,1,S]
    B = states.shape[0]
    overflow = torch.zeros(B, dtype=torch.bool, device=states.device)
    rnd = torch.zeros(B, dtype=torch.int32, device=states.device)
    peak = torch.zeros_like(rnd)
    explored = torch.zeros_like(rnd)
    active = enabled.clone()
    while bool(active.any()):
        unapplied = (masks[:, :, None] & bits) == 0            # [B,F,S]
        ok, new_state = _step_register(
            states[:, :, None], slot_f[:, None, :], slot_a1[:, None, :],
            slot_a2[:, None, :], slot_known[:, None, :])
        can = valid[:, :, None] & occupied & unapplied & ok
        s, m, v, n = _sorted_unique(
            torch.cat([states, new_state.reshape(B, -1)], 1),
            torch.cat([masks, (masks[:, :, None] | bits).reshape(B, -1)], 1),
            torch.cat([valid, can.reshape(B, -1)], 1), F)
        changed = ~(((s == states) & (m == masks)).all(1)
                    & (v == valid).all(1))
        a = active[:, None]
        states = torch.where(a, s, states)
        masks = torch.where(a, m, masks)
        valid = torch.where(a, v, valid)
        overflow |= active & (n > F)
        if with_stats:
            peak = torch.where(active, torch.maximum(peak, n.to(peak.dtype)),
                               peak)
            explored += torch.where(active, can.flatten(1).sum(1), 0) \
                .to(explored.dtype)
        rnd += active
        active &= changed & (rnd < S + 2)
    if _expand_fixpoint.rounds is not None:
        _expand_fixpoint.rounds.append(rnd)
    if with_stats:
        return states, masks, valid, overflow, peak, rnd, explored
    return states, masks, valid, overflow


#: When set to a list, each expansion appends its rounds per history
#: ([B] int32, on the device; measurement only).
_expand_fixpoint.rounds = None


def _set_slot(regs: list, at, values: list) -> list:
    """Per history, the slot register file with the slot `at` ([B,S]
    one-hot, all False for no change) set to `values` ([B] each)."""
    return [torch.where(at, v[:, None], r) for r, v in zip(regs, values)]


def _scan_history(events, F: int, S: int, with_stats: bool = False):
    """Run the event walk for a batch (the plain version of
    `knossos_frontier_scan`). events: [B, E, 6] int32. Returns (valid?
    [B], overflow [B], rounds [B] int32, the expansion rounds run), and
    with `with_stats` also (peak frontier width, configurations
    generated) [B] int32, the peak starting at 1."""
    B, E, _ = events.shape
    dev = events.device
    ev = events.long()
    states = torch.zeros((B, F), dtype=torch.int64, device=dev)
    masks = torch.zeros((B, F), dtype=torch.int64, device=dev)
    valid = torch.zeros((B, F), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    regs = [torch.full((B, S), -1, dtype=torch.int64, device=dev)] + [
        torch.zeros((B, S), dtype=torch.int64, device=dev)
        for _ in range(3)]                      # slot f, a1, a2, known
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    # peak, rounds, explored
    stats = [torch.ones(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev)]
    slots = torch.arange(S, device=dev)
    kinds = events[:, :, 0].cpu()
    any_inv = (kinds == INVOKE_EV).any(0).tolist()
    any_comp = (kinds == COMPLETE_EV).any(0).tolist()
    for e in range(E):
        kind, slot, f, a1, a2, known = ev[:, e].unbind(-1)
        at = slots == slot[:, None]
        if any_inv[e]:
            regs = _set_slot(regs, at & (kind == INVOKE_EV)[:, None],
                             [f, a1, a2, known])
        if not any_comp[e]:
            continue      # no round runs and no filter fires this step
        is_comp = kind == COMPLETE_EV
        states, masks, valid, ovf, peak, rnd, explored = _expand_fixpoint(
            states, masks, valid, *regs, is_comp, F, S, with_stats=True)
        overflow |= ovf
        stats = [torch.maximum(stats[0], peak), stats[1] + rnd,
                 stats[2] + explored]
        # completion deadline: only configurations that linearized the
        # op survive; its slot bit retires and the slot frees
        c = is_comp[:, None]
        valid &= ~c | (((masks >> slot[:, None]) & 1) == 1)
        masks = torch.where(c, masks & ~(1 << slot[:, None]), masks)
        regs[0] = torch.where(at & c, -1, regs[0])
    out = (valid.any(1), overflow, stats[1])
    return out + (stats[0], stats[2]) if with_stats else out


@dataclass(frozen=True)
class FrontierPlan:
    """How `knossos_frontier_scan` launches for one (F, S, variant): the
    tier ("shared": the round's keys in registers, the frontier and the
    exchange buffer in a block's shared memory; "global": keys and
    frontier in a device-memory workspace), threads a block, the power
    of two at or above F·(S+1) (`padded`; the shared tier sorts
    threads·keys of them, at least 256), dynamic shared memory a block
    (past which the kernel may stage the events), workspace bytes a
    block (0 on the shared tier) and keys a thread (0 on the global
    tier)."""

    tier: str
    threads: int
    padded: int
    smem_bytes: int
    work_bytes: int
    keys: int = 0


def frontier_keys(padded: int) -> int:
    """Keys a thread of the register walk for a sort of `padded` keys:
    KEYS, or as many as 1,024 threads need (the kernel's keys_for)."""
    return max(KEYS, padded // 1024)


def _arrays(keys: int, F: int, packed: bool) -> int:
    """Shared bytes of the register walk's arrays: `keys` sort keys and
    the frontier, and packed a second F for the live copy, rounded up
    to 16."""
    n = (keys + 2 * F) * 4 if packed else (keys + F) * 8
    return -(-n // 16) * 16


def plan_frontier(F: int, S: int, packed: bool) -> FrontierPlan:
    """The launch of `knossos_frontier_scan` (the kernel computes the
    same): the shared tier iff the sorted keys and the frontier (4 bytes
    a key packed, with a second frontier for the live copy; 8 for two
    arrays; rounded up to 16 bytes) and SMEM_TAIL fit MAX_SMEM, with
    `frontier_keys` keys a thread and max(32, padded / keys) threads.
    Else the global tier: P/2 threads within 32..1024 over a workspace
    the wrapper allocates."""
    n = F * (S + 1)
    p = 1 << (n - 1).bit_length()
    esize = 4 if packed else 8
    k = frontier_keys(p)
    threads = max(32, p // k)
    arrays = _arrays(threads * k, F, packed)
    if arrays + SMEM_TAIL <= MAX_SMEM:
        return FrontierPlan("shared", threads, p, arrays + SMEM_TAIL, 0, k)
    return FrontierPlan("global", min(1024, max(32, p // 2)), p, SMEM_TAIL,
                        (p + F) * esize)


def _check_frontier_args(events: torch.Tensor, frontier: int, n_slots: int,
                         packed: bool, with_stats: bool) -> None:
    if events.dtype != torch.int32:
        raise TypeError(f"knossos_frontier_scan takes int32 events, got "
                        f"{events.dtype}")
    if not events.is_contiguous():
        raise ValueError("knossos_frontier_scan takes contiguous events")
    if events.dim() != 3 or events.shape[2] != 6:
        raise ValueError(f"events must be [B,E,6], got "
                         f"{tuple(events.shape)}")
    limit = MAX_SLOTS_PACKED if packed else MAX_SLOTS
    if not 1 <= n_slots <= limit:
        raise ValueError(f"the {'packed ' if packed else ''}frontier's "
                         f"keys take 1..{limit} slots, got {n_slots}")
    if frontier < 1:
        raise ValueError(f"the frontier holds at least one configuration, "
                         f"got {frontier}")
    if packed and with_stats:
        raise ValueError("the packed frontier carries no stats")


def knossos_frontier_scan(events: torch.Tensor, frontier: int,
                          n_slots: int, *, packed: bool,
                          with_stats: bool = False) -> tuple:
    """The bounded frontier's event walk for a batch (events [B,E,6]
    int32, contiguous; S <= 24 for two arrays, S <= 30 packed): returns
    (valid [B] bool, overflow [B] bool, rounds [B] int32), and with
    `with_stats` (two arrays only) also (peak, explored) [B] int32, from
    the CUDA kernel for a CUDA tensor (launched on the tensor's device
    and current stream, as `plan_frontier` plans it) and from the plain
    versions (`_scan_history`, `.packed._scan_history_packed`) for a
    CPU tensor. The two agree exactly on every output."""
    _check_frontier_args(events, frontier, n_slots, packed, with_stats)
    if events.device.type == "cpu":
        if packed:
            from .packed import _scan_history_packed
            return _scan_history_packed(events, frontier, n_slots)
        return _scan_history(events, frontier, n_slots, with_stats)
    if events.device.type != "cuda":
        raise ValueError(f"knossos_frontier_scan runs on cuda or cpu, not "
                         f"{events.device}")
    B, E, _ = events.shape
    dev = events.device
    valid = torch.empty(B, dtype=torch.bool, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    stats = tuple(torch.empty(B, dtype=torch.int32, device=dev)
                  for _ in range(2)) if with_stats else ()
    out = (valid, overflow, rounds) + stats
    if B == 0:
        return out
    from ... import _build

    plan = plan_frontier(frontier, n_slots, packed)
    grid, work = B, None
    if plan.tier == "global":
        grid = min(B, max(1, WORKSPACE_BYTES // plan.work_bytes))
        work = torch.empty(grid * plan.work_bytes, dtype=torch.uint8,
                           device=dev)
    lib = _build.load("knossos_frontier")
    stream = torch.cuda.current_stream(dev)
    events_out = knossos_frontier_scan.events
    if events_out is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    rc = lib.knossos_frontier_launch(
        events.data_ptr(), valid.data_ptr(), overflow.data_ptr(),
        rounds.data_ptr(),
        *([t.data_ptr() for t in stats] if stats else [None, None]),
        None if work is None else work.data_ptr(), B, E, frontier, n_slots,
        int(packed), grid, dev.index, stream.cuda_stream)
    if rc != 0:
        msg = lib.knossos_frontier_error_string(rc).decode()
        raise _build.KernelLaunchError(
            f"knossos_frontier_scan launch failed (B={B}, E={E}, "
            f"F={frontier}, S={n_slots}, packed={packed}, "
            f"stats={with_stats}, {plan}): {msg}")
    with _COUNT_LOCK:   # launches come from several host threads
        knossos_frontier_scan.launches += 1
    if events_out is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        events_out.append((start, end))
    return out


knossos_frontier_scan.launches = 0
knossos_frontier_scan.events = None
#: Guards the read-modify-write of `.launches`: `independent.checker`'s
#: fan-out and `checker.compose` launch from several threads.
_COUNT_LOCK = threading.Lock()


def check_batch_device(events: torch.Tensor, *, frontier: int = 512,
                       n_slots: int = 16, with_stats: bool = False):
    """Batched entry: events [B, E, 6] int32 -> (valid [B] bool,
    overflow [B] bool), plus (peak, rounds, explored) [B] int32 under
    `with_stats` (the reference's order), through
    `knossos_frontier_scan` (the hand kernel on a CUDA tensor,
    `_scan_history` on a CPU one)."""
    valid, overflow, rounds, *st = knossos_frontier_scan(
        events, frontier, n_slots, packed=False, with_stats=with_stats)
    if with_stats:
        return valid, overflow, st[0], rounds, st[1]
    return valid, overflow


def dp_slices(n: int, devices) -> list[tuple[torch.device, slice]]:
    """A batch of n rows split over `devices` (a 1-D dp mesh, n a
    multiple of their count): (device, its contiguous rows) each."""
    per = n // len(devices)
    return [(torch.device(d), slice(k * per, (k + 1) * per))
            for k, d in enumerate(devices)]


def check_encoded_batch(encs: list[EncodedRegisterHistory],
                        frontier: int = 512,
                        device: torch.device | str = "cuda",
                        packed: bool | None = None,
                        stats_out: list | None = None,
                        devices=None) -> list[dict]:
    """Check encoded register histories on `device`. Returns
    knossos-shaped verdicts: {"valid?": True|False, "analyzer":
    "tpu-jit", "op-count"}, or {"valid?": "unknown", ...,
    "cause": ":frontier-overflow"} (the reference's analyzer name and
    cause, bytes of the stored verdict).

    `packed=None` (auto) routes to the packed single-int32 frontier
    (`.packed`) whenever every history's interned values fit `state <<
    n_slots` in an int32. An explicit packed=True downgrades to this
    frontier if the batch doesn't fit: an aliased packing could return
    a confident wrong verdict. `stats_out`, when given, is extended with
    one dict per history (engine, frontier_peak, frontier, rounds,
    configs, overflow, n_slots — the reference's), and the batch takes
    this frontier, the only one that carries the telemetry.

    With several `devices` the batch is split over them (a 1-D dp mesh):
    padded to a multiple of their count by replicating its last
    history, packed once, each device scanning its contiguous rows; the
    replicas' verdicts are dropped."""
    if not encs:
        return []
    n = len(encs)
    devices = list(devices) if devices else [device]
    encs = pad_to_multiple(encs, len(devices))
    batch = pack_register_batch(encs)
    shape: RegisterBatchShape = batch["shape"]
    events = torch.from_numpy(batch["events"])

    from .packed import check_batch_device_packed, packable
    fits = all(packable(e.n_values, shape.n_slots) for e in encs)
    with_stats = stats_out is not None
    use_packed = (fits if packed is None else (packed and fits)) \
        and not with_stats
    parts = []
    for dev, rows in dp_slices(len(encs), devices):
        ev = events[rows].to(dev)
        if use_packed:
            parts.append(check_batch_device_packed(
                ev, frontier=frontier, n_slots=shape.n_slots))
        else:
            parts.append(check_batch_device(
                ev, frontier=frontier, n_slots=shape.n_slots,
                with_stats=with_stats))
    cols = [sum((x.tolist() for x in col), []) for col in zip(*parts)]
    valid, overflow, *st = cols
    out = []
    for i, e in enumerate(encs[:n]):
        if overflow[i]:
            out.append({"valid?": "unknown", "analyzer": "tpu-jit",
                        "cause": ":frontier-overflow"})
        else:
            out.append({"valid?": bool(valid[i]), "analyzer": "tpu-jit",
                        "op-count": int(
                            (e.events[:, 0] == INVOKE_EV).sum())})
        if with_stats:
            stats_out.append({
                "engine": "tpu-jit", "frontier_peak": int(st[0][i]),
                "frontier": int(frontier), "rounds": int(st[1][i]),
                "configs": int(st[2][i]), "overflow": bool(overflow[i]),
                "n_slots": int(shape.n_slots)})
    return out
