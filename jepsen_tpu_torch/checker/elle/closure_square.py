"""The closure-squaring step, THE hot op of the Elle sweep: one round
`out[b,i,j] = OR_k (m[b,i,k] AND m[b,k,j])` over a [B,T,T] bool batch.

Replaces the Pallas TPU kernel `jepsen_tpu/checker/elle/pallas_square.py`
(`closure_square`, reached through `kernels._square`). On a CUDA tensor
`closure_square` launches the hand-written Hopper kernel
`csrc/closure_square.cu` (built by `_build` at first use); on a CPU
tensor it computes the plain version, `closure_square_ref`. Any other
device, dtype or shape raises — a failed build or launch raises too,
and nothing switches to the plain version behind the caller's back.

`closure_square.launches` counts kernel launches (never plain-version
calls), so a run can show that its closures went through the kernel.
"""

from __future__ import annotations

import torch

#: The kernel's tile edge; T must be a multiple of it.
TILE = 128


def closure_square_ref(m: torch.Tensor) -> torch.Tensor:
    """The plain version: `bmm(float(m), float(m)) > 0`. Exact, because
    every sum of 0/1 products is an integer below 2^24 for T <= 32768.
    (int8 bmm would return int8 and wrap: all-ones at T=256 sums to 0.)"""
    mf = m.to(torch.float32)
    return torch.bmm(mf, mf) > 0


def _check(m: torch.Tensor) -> None:
    if m.dtype != torch.bool:
        raise TypeError(f"closure_square takes a bool tensor, got {m.dtype}")
    if m.dim() != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"closure_square takes [B,T,T], got {tuple(m.shape)}")
    if m.shape[1] % TILE:
        raise ValueError(f"T={m.shape[1]} is not a multiple of {TILE}")
    if not m.is_contiguous():
        raise ValueError("closure_square takes a contiguous tensor")


def closure_square(m: torch.Tensor) -> torch.Tensor:
    """One closure round of `m` ([B,T,T] bool, T a multiple of 128):
    the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor. Returns a new bool tensor."""
    _check(m)
    if m.device.type == "cpu":
        return closure_square_ref(m)
    if m.device.type != "cuda":
        raise ValueError(f"closure_square runs on cuda or cpu, not {m.device}")
    out = torch.empty_like(m)
    B, T, _ = m.shape
    if B == 0:
        return out
    from ... import _build

    lib = _build.load("closure_square")
    stream = torch.cuda.current_stream(m.device)
    rc = lib.closure_square_launch(
        m.data_ptr(), out.data_ptr(), B, T, m.device.index,
        stream.cuda_stream)
    if rc != 0:
        msg = lib.closure_square_error_string(rc).decode()
        raise RuntimeError(
            f"closure_square launch failed (B={B}, T={T}): {msg}")
    closure_square.launches += 1
    return out


closure_square.launches = 0
