#!/usr/bin/env python3
"""The column-range launch of closure_square, held to its plain version
and timed against the full round, on one card.

    python3 -m jepsen_tpu_torch.tools.closure_square_cols

Builds `csrc/closure_square.cu`, then for random reflexive [B,T,T]
batches splits the output columns over mp parts
(`closure_square.column_blocks`) and launches each block with
`cols=(c0, c1)`: every block's out columns, outT rows, changed flags and
active word must equal `closure_square_ref` with the same range
exactly, with `active` absent, at 1 and at 0; the blocks stitched
together must equal the full launch, and their changed flags and active
words ORed the full ones. Then, at B=2, T=5120 (the append bucket), the
full launch and each block at mp=2 and mp=4 are timed (medians of CUDA
event pairs around bursts of 5 launches) beside each block's bound: its
2·B·T²·(c1-c0) int8 multiply-adds at the card's int8 peak against the
bytes it reads and writes (all of m, rows c0..c1 of mT, the out and
outT blocks) at its memory rate. Prints one JSON line with the card's
name and power limit. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

#: (B, T, mp) of each kernel-vs-plain case: T past one column tile,
#: ragged last tiles (T = 128·odd), fewer tiles than parts, and the
#: append bucket's shape.
CASES = [(2, 384, 2), (3, 640, 3), (2, 1280, 4), (1, 384, 4),
         (2, 5120, 2), (2, 5120, 4)]
TIMED = [(2, 5120, 2), (2, 5120, 4)]
#: Published dense peaks: int8 tensor-core operations/s and HBM bytes/s
#: (NVIDIA H100 data sheet; the SXM part unless the name says PCIe).
PEAKS = (("H100 PCIe", 1513e12, 2.0e12), ("H100", 1979e12, 3.35e12))


def random_batch(B: int, T: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    m = torch.rand((B, T, T), generator=g, device=device) < 4.0 / T
    return m | torch.eye(T, dtype=torch.bool, device=device)


def block_bound_ms(name: str, B: int, T: int, c0: int, c1: int) -> dict:
    """The least time for one block launch on the card named `name`."""
    ops, bw = next(((o, b) for key, o, b in PEAKS if key in name),
                   PEAKS[-1][1:])
    w = c1 - c0
    flops = 2.0 * B * T * T * w
    nbytes = B * T * T + 3 * B * T * w + B
    t_ops, t_bytes = flops / ops * 1e3, nbytes / bw * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_cases(device, cases=CASES) -> list[str]:
    """Every case's blocks against the plain version and the full
    launch (module doc); returns one line per case, raises on a
    mismatch."""
    from ..checker.elle import closure_square as cs
    lines = []
    for n, (B, T, mp) in enumerate(cases):
        m = random_batch(B, T, 7 + n, device)
        mT = m.transpose(1, 2).contiguous()
        blocks = [c for c in cs.column_blocks(T, mp) if c[0] < c[1]]
        for word in (None, 1, 0):
            act = None if word is None else torch.tensor(
                [word, 0], dtype=torch.int32, device=device)
            full_act = None if act is None else act.clone()
            full, fullT, fch = cs.closure_square(m, mT, full_act)
            st_out = torch.zeros_like(m)
            st_outT = torch.zeros_like(m)
            ch_or = torch.zeros(B, dtype=torch.bool, device=device)
            act_or = 0
            for c0, c1 in blocks:
                ka = None if act is None else act.clone()
                ra = None if act is None else act.clone()
                o, oT, ch = cs.closure_square(m, mT, ka, cols=(c0, c1))
                r, rT, rch = cs.closure_square_ref(m, mT, ra, cols=(c0, c1))
                same = (torch.equal(o[:, :, c0:c1], r[:, :, c0:c1])
                        and torch.equal(oT[:, c0:c1], rT[:, c0:c1])
                        and torch.equal(ch, rch)
                        and (ka is None or torch.equal(ka, ra)))
                if not same:
                    raise AssertionError(
                        f"block {c0}:{c1} of B={B} T={T} mp={mp} "
                        f"active={word} differs from closure_square_ref")
                st_out[:, :, c0:c1] = o[:, :, c0:c1]
                st_outT[:, c0:c1] = oT[:, c0:c1]
                ch_or |= ch
                if ka is not None:
                    act_or |= int(ka[1])
            if not (torch.equal(st_out, full) and torch.equal(st_outT, fullT)
                    and torch.equal(ch_or, fch)
                    and (act is None or act_or == int(full_act[1]))):
                raise AssertionError(
                    f"the blocks of B={B} T={T} mp={mp} active={word} do "
                    "not stitch into the full round")
        lines.append(f"B={B} T={T} mp={mp}: blocks {blocks} equal the "
                     "plain version and stitch into the full round "
                     "(active none, 1, 0)")
    return lines


def cuda_ms(fn, reps: int = 20, burst: int = 5) -> float:
    """Median per-launch milliseconds of `fn` (CUDA event pairs around
    bursts of `burst` calls)."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / burst)
    return statistics.median(out)


def time_blocks(device, name: str, timed=TIMED) -> list[dict]:
    """The full launch and each block's median ms at each timed shape,
    with each block's bound."""
    from ..checker.elle import closure_square as cs
    out = []
    for B, T, mp in timed:
        m = random_batch(B, T, 99, device)
        mT = m.transpose(1, 2).contiguous()
        full = cuda_ms(lambda: cs.closure_square(m, mT))
        rec = {"B": B, "T": T, "mp": mp, "full_ms": full,
               **{f"full_{k}": v for k, v in
                  block_bound_ms(name, B, T, 0, T).items()},
               "blocks": []}
        for c0, c1 in cs.column_blocks(T, mp):
            if c0 == c1:
                continue
            ms = cuda_ms(lambda: cs.closure_square(m, mT, cols=(c0, c1)))
            rec["blocks"].append({"cols": [c0, c1], "ms": ms,
                                  **block_bound_ms(name, B, T, c0, c1)})
        out.append(rec)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from .. import _build
    _build.build("closure_square")
    print(_build.build_log("closure_square").strip(), flush=True)
    dev = torch.device("cuda", 0)
    for ln in check_cases(dev):
        print(ln, flush=True)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "timed": time_blocks(dev, name)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
