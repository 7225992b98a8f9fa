"""The packed-configuration frontier.

Counterpart of `jepsen_tpu/checker/knossos/packed.py`. When
`(n_values << n_slots) <= 2^31 - 1`, a configuration packs into one
int32, `state << S | mask`, with 2^31-1 as the "empty entry" sentinel:
compaction then sorts one array (dedup is an adjacent compare on the
packed key) and the fixpoint's exit test is one array compare.
Semantics are those of `.kernels` (expansion, completion filter,
overflow and verdict rules); `kernels.check_encoded_batch` routes here
when every history of the batch fits. On a CUDA tensor the walk is the
hand kernel `kernels.knossos_frontier_scan(packed=True)`; the plain
PyTorch version here, `_scan_history_packed`, runs for a CPU tensor.
"""

from __future__ import annotations

import torch

from .encode import COMPLETE_EV, INVOKE_EV
from .kernels import _BIG, _set_slot, _step_register


def packable(n_values: int, n_slots: int) -> bool:
    """Does state << S | mask stay below the _BIG sentinel?"""
    return n_slots < 31 and (n_values << n_slots) <= 2**31 - 1


def _sorted_unique_packed(cfgs, F: int):
    """Sort packed configs [B, N] (invalid == _BIG last), drop
    duplicates, return (cfgs[:, :F], n_unique [B])."""
    cfgs = torch.sort(cfgs, dim=1).values
    dup = torch.zeros_like(cfgs, dtype=torch.bool)
    dup[:, 1:] = cfgs[:, 1:] == cfgs[:, :-1]
    cfgs = torch.where(dup, _BIG, cfgs)
    n_unique = (cfgs != _BIG).sum(1)
    cfgs = torch.sort(cfgs, dim=1).values
    return cfgs[:, :F], n_unique


def _expand_fixpoint_packed(cfgs, slot_f, slot_a1, slot_a2, slot_known,
                            enabled, F: int, S: int):
    """Close each packed frontier under single-op linearization (the
    packed twin of kernels._expand_fixpoint), for the histories in
    `enabled` [B]. Returns (cfgs, overflow [B], rounds [B] int32)."""
    bits = 1 << torch.arange(S, dtype=torch.int32, device=cfgs.device)
    low = (1 << S) - 1
    occupied = (slot_f >= 0)[:, None, :]
    B = cfgs.shape[0]
    overflow = torch.zeros(B, dtype=torch.bool, device=cfgs.device)
    rnd = torch.zeros(B, dtype=torch.int32, device=cfgs.device)
    active = enabled.clone()
    while bool(active.any()):
        if _expand_fixpoint_packed.live is not None:
            _expand_fixpoint_packed.live.append(
                torch.where(active, (cfgs != _BIG).sum(1), -1))
        masks = cfgs & low
        ok, new_state = _step_register(
            (cfgs >> S)[:, :, None], slot_f[:, None, :],
            slot_a1[:, None, :], slot_a2[:, None, :],
            slot_known[:, None, :])
        can = (cfgs != _BIG)[:, :, None] & occupied \
            & ((masks[:, :, None] & bits) == 0) & ok
        cand = torch.where(can, (new_state << S) | (masks[:, :, None] | bits),
                           _BIG).reshape(B, -1)
        c, n = _sorted_unique_packed(torch.cat([cfgs, cand], 1), F)
        changed = (c != cfgs).any(1)
        cfgs = torch.where(active[:, None], c, cfgs)
        overflow |= active & (n > F)
        rnd += active
        active &= changed & (rnd < S + 2)
    if _expand_fixpoint_packed.rounds is not None:
        _expand_fixpoint_packed.rounds.append(rnd)
    return cfgs, overflow, rnd


#: When set to a list, each expansion appends its rounds per history
#: ([B] int32, on the device; measurement only).
_expand_fixpoint_packed.rounds = None
#: When set to a list, each round appends the live configurations it
#: expands per history ([B], -1 where the history's expansion has
#: stopped; on the device; measurement only).
_expand_fixpoint_packed.live = None


def _scan_history_packed(events, F: int, S: int):
    """Event walk for a batch over packed configs (the plain version of
    `knossos_frontier_scan(packed=True)`). events: [B, E, 6] int32.
    Returns (valid? [B], overflow [B], rounds [B] int32, the expansion
    rounds run)."""
    B, E, _ = events.shape
    dev = events.device
    cfgs = torch.full((B, F), _BIG, dtype=torch.int32, device=dev)
    cfgs[:, 0] = 0
    regs = [torch.full((B, S), -1, dtype=torch.int32, device=dev)] + [
        torch.zeros((B, S), dtype=torch.int32, device=dev)
        for _ in range(3)]                      # slot f, a1, a2, known
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    rounds = torch.zeros(B, dtype=torch.int32, device=dev)
    slots = torch.arange(S, device=dev)
    kinds = events[:, :, 0].cpu()
    any_inv = (kinds == INVOKE_EV).any(0).tolist()
    any_comp = (kinds == COMPLETE_EV).any(0).tolist()
    for e in range(E):
        kind, slot, f, a1, a2, known = events[:, e].unbind(-1)
        at = slots == slot[:, None]
        if any_inv[e]:
            regs = _set_slot(regs, at & (kind == INVOKE_EV)[:, None],
                             [f, a1, a2, known])
        if not any_comp[e]:
            continue      # no round runs and no filter fires this step
        is_comp = kind == COMPLETE_EV
        cfgs, ovf, rnd = _expand_fixpoint_packed(cfgs, *regs, is_comp, F, S)
        overflow |= ovf
        rounds += rnd
        # completion deadline. _BIG has every low bit set, so the
        # sentinel must be exempted explicitly before the bit test.
        sl = slot[:, None]
        keep = (cfgs != _BIG) & (((cfgs >> sl) & 1) == 1)
        filtered = torch.where(keep, cfgs & ~(1 << sl), _BIG)
        c = is_comp[:, None]
        cfgs = torch.where(c, filtered, cfgs)
        regs[0] = torch.where(at & c, -1, regs[0])
    return (cfgs != _BIG).any(1), overflow, rounds


def check_batch_device_packed(events: torch.Tensor, *, frontier: int = 512,
                              n_slots: int = 16):
    """Packed entry: events [B, E, 6] int32 -> (valid [B], overflow
    [B]), through `knossos_frontier_scan(packed=True)` (the hand kernel
    on a CUDA tensor, `_scan_history_packed` on a CPU one)."""
    from .kernels import knossos_frontier_scan
    return knossos_frontier_scan(events, frontier, n_slots,
                                 packed=True)[:2]
