"""The closure-squaring step, THE hot op of the Elle sweep: one round
`out[b,i,j] = OR_k (m[b,i,k] AND m[b,k,j])` over a [B,T,T] bool batch,
with the round's transpose and the fixpoint's per-history changed flag.

Replaces the Pallas TPU kernel `jepsen_tpu/checker/elle/pallas_square.py`
(`closure_square`, reached through `kernels._square`) together with the
reference's per-round `jnp.any(m2 != m)`. On a CUDA tensor
`closure_square` launches the hand-written Hopper kernel
`csrc/closure_square.cu` (built by `_build` at first use); on a CPU
tensor it computes the plain version, `closure_square_ref`. Any other
device, dtype or shape raises — a failed build or launch raises too,
and nothing switches to the plain version behind the caller's back.

The kernel reads the second operand K-major, from the rows of `mT`
(each history's transpose), and writes `outT` beside `out`, so a
closure loop transposes once and carries the pair from round to round.

`active`, when given, moves the closure loop's condition onto the
device (the reference's `lax.while_loop` condition): an int32 pair
whose first word says whether this round runs. When it is nonzero the
round squares, and the second word is set to 1 if any history changed
(the next round's word); when it is zero the round copies `m` and `mT`
to `out` and `outT`, leaves `changed` zero and the second word alone.
So a loop can enqueue every round without reading the device.

`cols`, when given, is a column range `(c0, c1)` (c0 a multiple of
`COL_TILE`, c1 one too or T): the round computes only the output
columns `out[:, :, c0:c1]` and their transpose `outT[:, c0:c1, :]`,
reading all of `m` and rows c0..c1 of `mT`, with `changed` and the
active word over those columns (`closure_square_cols_launch`). `out`
and `outT` are still [B,T,T]; outside the block their contents are
unspecified (zeros in the plain version). The devices of a dp×mp mesh
row each take one block (`column_blocks`) and exchange them, so a
model-parallel closure stays on the hand kernel; `(0, T)` is the full
round.

`closure_square.launches` counts kernel launches, inactive rounds
included (never plain-version calls), so a run can show that its
closures went through the kernel; the active ones are the closures'
round counts.
`closure_square.events`, when set to a list, gets a (start, end) CUDA
event pair appended around each launch, for timing a whole sweep.
"""

from __future__ import annotations

import threading

import torch

#: The kernel's row-tile edge; T must be a multiple of it.
TILE = 128
#: The kernel's output column tile (BN): a column range starts on it.
COL_TILE = 256


def column_blocks(T: int, parts: int) -> list[tuple[int, int]]:
    """The output columns of a T-wide round split over `parts`
    devices: `parts` ranges of whole column tiles, as even as the tiles
    allow, in order; a range is empty (c0 == c1) when there are fewer
    tiles than parts."""
    tiles = -(-T // COL_TILE)
    out = []
    for j in range(parts):
        t0, t1 = j * tiles // parts, (j + 1) * tiles // parts
        out.append((min(t0 * COL_TILE, T), min(t1 * COL_TILE, T)))
    return out


def closure_square_ref(m: torch.Tensor, mT: torch.Tensor,
                       active: torch.Tensor | None = None,
                       cols: tuple[int, int] | None = None):
    """The plain version: `out = bmm(float(m), float(mT)ᵀ) > 0` (with mT
    the transpose of m, the square of m), `outT = outᵀ`, and
    `changed[b] = any(out[b] != m[b])`. Exact, because every sum of 0/1
    products is an integer below 2^24 for T <= 32768. (int8 bmm would
    return int8 and wrap: all-ones at T=256 sums to 0.) With `active`,
    as `closure_square` takes it, all on the device: an inactive round
    returns `m` and `mT` unchanged with no history changed. With `cols`
    only that column block is computed, from rows c0..c1 of `mT`, and
    the rest of `out` and `outT` is zero."""
    if cols is not None and tuple(cols) != (0, m.shape[-1]):
        c0, c1 = cols
        blk = torch.bmm(m.to(torch.float32),
                        mT[:, c0:c1].to(torch.float32).transpose(1, 2)) > 0
        mblk = m[:, :, c0:c1]
        changed = (blk != mblk).flatten(1).any(1)
        if active is not None:
            on = active[0] != 0
            blk = torch.where(on, blk, mblk)
            changed &= on
            active[1:2].bitwise_or_(changed.any().to(active.dtype))
        out = torch.zeros_like(m)
        outT = torch.zeros_like(m)
        out[:, :, c0:c1] = blk
        outT[:, c0:c1, :] = blk.transpose(1, 2)
        return out, outT, changed
    out = torch.bmm(m.to(torch.float32),
                    mT.to(torch.float32).transpose(1, 2)) > 0
    changed = (out != m).flatten(1).any(1)
    if active is not None:
        on = active[0] != 0
        out = torch.where(on, out, m)
        changed &= on
        active[1:2].bitwise_or_(changed.any().to(active.dtype))
    return out, out.transpose(1, 2).contiguous(), changed


def _check(m: torch.Tensor, mT: torch.Tensor,
           active: torch.Tensor | None, cols=None) -> None:
    for name, x in (("m", m), ("mT", mT)):
        if x.dtype != torch.bool:
            raise TypeError(
                f"closure_square takes bool tensors, got {name} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"closure_square takes contiguous tensors "
                             f"({name} is not)")
    if m.dim() != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"closure_square takes [B,T,T], got {tuple(m.shape)}")
    if mT.shape != m.shape or mT.device != m.device:
        raise ValueError(f"mT {tuple(mT.shape)} on {mT.device} does not "
                         f"match m {tuple(m.shape)} on {m.device}")
    if m.shape[1] % TILE:
        raise ValueError(f"T={m.shape[1]} is not a multiple of {TILE}")
    if active is not None and (
            active.dtype != torch.int32 or active.shape != (2,)
            or not active.is_contiguous() or active.device != m.device):
        raise ValueError(f"active must be a contiguous int32 pair on "
                         f"{m.device}, got {active.dtype} "
                         f"{tuple(active.shape)} on {active.device}")
    if cols is not None:
        T = m.shape[1]
        c0, c1 = cols
        if not (0 <= c0 < c1 <= T and c0 % COL_TILE == 0
                and (c1 % COL_TILE == 0 or c1 == T)):
            raise ValueError(f"cols {tuple(cols)} is not a range of whole "
                             f"{COL_TILE}-column tiles in [0, {T})")


def closure_square(m: torch.Tensor, mT: torch.Tensor,
                   active: torch.Tensor | None = None,
                   cols: tuple[int, int] | None = None):
    """One closure round of `m` ([B,T,T] bool, T a multiple of 128),
    given `mT`, its per-history transpose: returns `(out, outT, changed)`
    — the round, its transpose and a [B] bool "out differs from m" — from
    the CUDA kernel for CUDA tensors, from the plain version for CPU
    tensors. All three are new tensors. `active` (an int32 pair on m's
    device, see the module doc) makes the round conditional on the
    device; `cols` computes one column block (module doc)."""
    _check(m, mT, active, cols)
    if m.device.type == "cpu":
        return closure_square_ref(m, mT, active, cols)
    if m.device.type != "cuda":
        raise ValueError(f"closure_square runs on cuda or cpu, not {m.device}")
    B, T, _ = m.shape
    out = torch.empty_like(m)
    outT = torch.empty_like(m)
    changed = torch.zeros(B, dtype=torch.bool, device=m.device)
    if B == 0:
        return out, outT, changed
    from ... import _build

    lib = _build.load("closure_square")
    stream = torch.cuda.current_stream(m.device)
    events = closure_square.events
    if events is not None:
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    args = (m.data_ptr(), mT.data_ptr(), out.data_ptr(), outT.data_ptr(),
            changed.data_ptr(),
            None if active is None else active.data_ptr(), B, T)
    if cols is None:
        rc = lib.closure_square_launch(*args, m.device.index,
                                       stream.cuda_stream)
    else:
        rc = lib.closure_square_cols_launch(*args, int(cols[0]),
                                            int(cols[1]), m.device.index,
                                            stream.cuda_stream)
    if rc != 0:
        msg = lib.closure_square_error_string(rc).decode()
        raise _build.KernelLaunchError(
            f"closure_square launch failed (B={B}, T={T}"
            f"{'' if cols is None else f', cols={tuple(cols)}'}): {msg}")
    with _COUNT_LOCK:   # launches come from several host threads
        closure_square.launches += 1
    if events is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        events.append((start, end))
    return out, outT, changed


closure_square.launches = 0
closure_square.events = None
#: Guards the read-modify-write of `.launches`: `independent.checker`'s
#: fan-out and `checker.compose` launch from several threads.
_COUNT_LOCK = threading.Lock()
