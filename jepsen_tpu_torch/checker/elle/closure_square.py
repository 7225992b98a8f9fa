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

`closure_square.launches` counts kernel launches (never plain-version
calls), so a run can show that its closures went through the kernel.
`closure_square.events`, when set to a list, gets a (start, end) CUDA
event pair appended around each launch, for timing a whole sweep.
"""

from __future__ import annotations

import torch

#: The kernel's row-tile edge; T must be a multiple of it.
TILE = 128


def closure_square_ref(m: torch.Tensor, mT: torch.Tensor):
    """The plain version: `out = bmm(float(m), float(mT)ᵀ) > 0` (with mT
    the transpose of m, the square of m), `outT = outᵀ`, and
    `changed[b] = any(out[b] != m[b])`. Exact, because every sum of 0/1
    products is an integer below 2^24 for T <= 32768. (int8 bmm would
    return int8 and wrap: all-ones at T=256 sums to 0.)"""
    out = torch.bmm(m.to(torch.float32),
                    mT.to(torch.float32).transpose(1, 2)) > 0
    return (out, out.transpose(1, 2).contiguous(),
            (out != m).flatten(1).any(1))


def _check(m: torch.Tensor, mT: torch.Tensor) -> None:
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


def closure_square(m: torch.Tensor, mT: torch.Tensor):
    """One closure round of `m` ([B,T,T] bool, T a multiple of 128),
    given `mT`, its per-history transpose: returns `(out, outT, changed)`
    — the round, its transpose and a [B] bool "out differs from m" — from
    the CUDA kernel for CUDA tensors, from the plain version for CPU
    tensors. All three are new tensors."""
    _check(m, mT)
    if m.device.type == "cpu":
        return closure_square_ref(m, mT)
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
    rc = lib.closure_square_launch(
        m.data_ptr(), mT.data_ptr(), out.data_ptr(), outT.data_ptr(),
        changed.data_ptr(), B, T, m.device.index, stream.cuda_stream)
    if rc != 0:
        msg = lib.closure_square_error_string(rc).decode()
        raise RuntimeError(
            f"closure_square launch failed (B={B}, T={T}): {msg}")
    closure_square.launches += 1
    if events is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        events.append((start, end))
    return out, outT, changed


closure_square.launches = 0
closure_square.events = None
