#!/usr/bin/env python3
"""The port's three hand kernels checked for memory faults on one card:
compute-sanitizer runs, and guarded launches that need no tool.

    python3 -m jepsen_tpu_torch.tools.sanitize_kernels [--tool T ...]
        [--log-dir DIR]
    python3 -m jepsen_tpu_torch.tools.sanitize_kernels --guard

With the tool: one process per tool (memcheck, racecheck, synccheck,
initcheck, in that order; `--tool` picks some), each `compute-sanitizer
--tool T --error-exitcode 86` over this module's own `--child T`,
filtered to the port's kernels (`closure_square_kernel`,
`dense_warp_kernel`, `dense_block_kernel`, `frontier_kernel`: PyTorch's
own kernels are not instrumented), with PYTORCH_NO_CUDA_MEMORY_CACHING=1
(the caching allocator packs tensors into shared segments, where an
overrun into a neighbour is no error to memcheck and an unwritten byte
may have been written by a freed tensor). The child launches the three
kernels over `cases(tool)` and holds every output to its plain version
(`closure_square_ref`, `scan_dense_ref`, `_scan_history` and
`_scan_history_packed`) exactly. Then one more initcheck process, the
canary, launches each kernel on unwritten inputs and must be reported:
proof that the filter reaches all four kernel functions and the tool
sees their reads. A tool's report, an output unequal to
its plain version, a canary not reported, a tool that refuses the
device ("Device not supported": it then checks nothing) or a missing
tool fails the run (exit 1). The last line is one JSON object: per
tool its wall, exit code, error and warning counts (the tool's
summary), whether it refused the device, the report lines naming each
kernel, and the cases each kernel ran. compute-sanitizer is looked for
as nvcc is (`_build.find_cuda_tool`): $CUDA_HOME/bin, $CUDA_PATH/bin,
PATH, then /usr/local/cuda/bin.

`--guard`, no tool: every case of the memcheck list launched through
the kernels' C entry points on buffers set between GUARD-byte bands of
a pattern, every output starting as the pattern (an input's bands take
its complement, so a copy that runs past an input shows in an output's
band), once with each of FILLS: every output must equal its plain
version, and every band, and outside a column range the rest of out
and outT, must still hold its pattern (the frontier's global tier
also gets its workspace between bands). That finds a write past a
buffer, a write outside a column range, an output left unwritten, and
a read of bytes no launch or copy wrote where it changes a result
(`_ColumnSplit`'s exchange: a column left at the pattern reads as
true). It does not see a read past a buffer that changes nothing, a
race or a barrier fault; a shared-memory access past the block's
allocation faults the launch. It is no substitute for the tools, so
`chip_smoke.py` does not run it: it is run by hand on the card.

What the cases cover. `closure_square`: B in {1, 3}, T in {128, 384,
1024} (384 = 128·3: the ragged 256-wide N tile TMA zero-fills on load
and clips on store), `active` absent, [1, 0] and [0, 0] (the skipped
round's 16-byte copy); the column range at T=1024 over mp=2 and mp=4
and at T=384, whose block (256, 384) ends at T, off the tile, each
with the skipped round's block copy; `_ColumnSplit`'s exchange, a
whole closure over mp=2 and 4 blocks of one card whose every round
reads the matrix the blocks and the copies wrote (`torch.empty_like`
outputs, one block written a launch: initcheck reports any column
nobody wrote), its last rounds skipped; memcheck (and `--guard`) also
the main shape, B=2, T=5120. `knossos_dense_scan`: both tiers and each
tier's STATS twin, both sides of the tier boundary at V=8 (S=11, 12)
and at V=64 (S=8, 9), B in {1, 3, 33} (the warp tier packs two
histories a block, so an odd B leaves half a block), ragged histories
(pad steps past each one's end), every other one corrupted, and the
block tier's shared scratch past the grid (S=13, 14 at V=64) with
STATS' popcount word one past it. `knossos_frontier_scan`: each
variant (packed; two arrays; two arrays with stats) on the shared tier
(F=4, every history overflowing, and F=64) and on the global tier
(F=2048 for two arrays, packed there on the shared tier; F=4096 for
both), one global case with a workspace of two blocks striding over
five histories, and the register walk's layout edges of
`knossos_frontier_check.EDGE_CASES` (sorts of 256 keys on one warp to
16,384 on 1,024 threads of 16 keys; events staged and from device
memory); ragged batches with pad tails, info ops and every other
history corrupted.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import signal
import subprocess
import sys
import time
from dataclasses import asdict, dataclass
from pathlib import Path

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
#: The kernels' names as compiled (a substring of each mangled name).
KERNELS = ("closure_square_kernel", "dense_warp_kernel",
           "dense_block_kernel", "frontier_kernel")
#: compute-sanitizer's exit code when it found an error.
ERROR_EXIT = 86
#: A tool's process may take this long (s): a hang fails.
TIMEOUT_S = 600
#: The checkout's root, where the child runs as a module.
ROOT = Path(__file__).resolve().parents[2]
#: This module as `python -m` runs it (run so, its `__name__` is
#: "__main__").
MODULE = "jepsen_tpu_torch.tools.sanitize_kernels"
#: The child's line carrying its cases' results.
CASES_TAG = "sanitize-cases "


@dataclass(frozen=True)
class Case:
    """One launch (or one closure) held to its plain version."""
    kernel: str                  # "closure_square", "knossos_dense_scan"
    #                              or "knossos_frontier_scan"
    kind: str                    # "square", "split", "scan", "frontier"
    B: int
    T: int = 0                   # closure_square
    active: tuple | None = None  # closure_square: the active pair
    cols: tuple | None = None    # closure_square: the column range
    mp: int = 0                  # split: blocks a round
    S: int = 0                   # knossos_dense_scan
    V: int = 0
    stats: bool = False
    seed: int = 0
    F: int = 0                   # knossos_frontier_scan: the frontier
    packed: bool = False
    blocks: int = 0              # its global tier: workspace blocks (0: B)

    @property
    def label(self) -> str:
        if self.kernel == "closure_square":
            return (f"{self.kind} B={self.B} T={self.T} active="
                    f"{self.active} cols={self.cols} mp={self.mp}")
        if self.kernel == "knossos_frontier_scan":
            return (f"frontier B={self.B} F={self.F} S={self.S} "
                    f"packed={self.packed} stats={self.stats} "
                    f"blocks={self.blocks or self.B}")
        return (f"scan B={self.B} S={self.S} V={self.V} "
                f"stats={self.stats}")


def cases(tool: str) -> list[Case]:
    """Every case the child runs under `tool` (the module doc)."""
    from ..checker.elle import closure_square as cs

    out = []
    seed = 0
    for B in (1, 3):
        for T in (128, 384, 1024):
            for active in (None, (1, 0), (0, 0)):
                seed += 1
                out.append(Case("closure_square", "square", B, T,
                                active=active, seed=seed))
    for T, mp in ((1024, 2), (1024, 4), (384, 2)):
        for cols in cs.column_blocks(T, mp):
            for active in (None, (1, 0), (0, 0)):
                seed += 1
                out.append(Case("closure_square", "square", 3, T,
                                active=active, cols=cols, seed=seed))
    for T, mp in ((1024, 2), (1024, 4), (384, 2)):
        seed += 1
        out.append(Case("closure_square", "split", 3, T, mp=mp, seed=seed))
    if tool == "memcheck":
        for active in (None, (0, 0)):
            seed += 1
            out.append(Case("closure_square", "square", 2, 5120,
                            active=active, seed=seed))
    # knossos_dense_scan: (S, V) across both tiers and both boundaries,
    # the block tier's scratch (S=13, 14 at V=64); each batch through
    # the plain build and its STATS twin
    for S, V, Bs in ((3, 8, (1, 3, 33)), (11, 8, (1, 3, 33)),
                     (12, 8, (1, 3)), (8, 64, (1, 3, 33)),
                     (9, 64, (1, 3, 33)), (13, 64, (1, 3)),
                     (14, 64, (1,))):
        for B in Bs:
            seed += 1
            for stats in (False, True):
                out.append(Case("knossos_dense_scan", "scan", B, S=S, V=V,
                                stats=stats, seed=seed))
    # knossos_frontier_scan: both tiers, each variant, overflow (F=4),
    # blocks striding over histories on the global tier, the register
    # walk's layout edges
    from .knossos_frontier_check import EDGE_CASES

    for F, S, B, blocks in ((4, 3, 3, 0), (64, 8, 5, 0), (2048, 8, 3, 0),
                            (4096, 8, 2, 0), (2048, 8, 5, 2),
                            *((F, S, B, 0) for F, S, B, *_ in EDGE_CASES)):
        seed += 1
        for packed, stats in ((True, False), (False, False), (False, True)):
            out.append(Case("knossos_frontier_scan", "frontier", B, S=S,
                            F=F, packed=packed, stats=stats, seed=seed,
                            blocks=blocks))
    return out


def tool_argv(sanitizer: str, tool: str,
              child: str | None = None) -> list[str]:
    """The command of one tool's process: the tool over this module's
    child, filtered to the port's kernels, failing on any error."""
    filters = [a for k in KERNELS for a in ("--kernel-name", f"kns={k}")]
    return [sanitizer, "--tool", tool, "--error-exitcode", str(ERROR_EXIT),
            "--print-limit", "100", *filters,
            sys.executable, "-m", MODULE, "--child", child or tool]


def tool_env() -> dict:
    """The child's environment: PyTorch's caching allocator off."""
    env = dict(os.environ)
    env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    return env


# ------------------------------------------------------------ the child

def _bool_batch(B: int, T: int, seed: int, device):
    """Reflexive [B,T,T] bool: history 0 a total order (closed: a round
    leaves it as it is), the others sparse random (a round changes
    them)."""
    import torch

    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    m = torch.rand((B, T, T), generator=g) < 3.0 / T
    m[0] = torch.ones(T, T, dtype=torch.bool).triu()
    m |= torch.eye(T, dtype=torch.bool)
    return m.to(device)


def _dense_inputs(case: Case):
    """B register histories at concurrency S over V values, ragged (each
    its own length, pad steps past its end), every other one
    corrupted: (regs, comp) int32 numpy arrays."""
    from ..checker.knossos import synth
    from ..checker.knossos.dense import (DenseBatchShape,
                                         encode_dense_history,
                                         pack_dense_batch)

    rng = random.Random(case.seed)
    # the plain version's time grows with the grid and the batch: the
    # wide grids and the odd 33 take short histories
    top = 80 if case.S < 11 and case.B < 33 else 24
    encs = []
    for i in range(case.B):
        h = synth.synth_register_history(
            n_ops=rng.randrange(top // 3, top), n_procs=case.S,
            n_values=min(5, case.V - 2) if case.V <= 8 else case.V - 4,
            info_prob=0.02, seed=rng.randrange(1 << 30),
            max_pending=case.S)
        encs.append(encode_dense_history(
            synth.corrupt(h, seed=i) if i % 2 else h))
    b = pack_dense_batch(encs, DenseBatchShape(
        n_steps=max(e.n_steps for e in encs) + 3, n_slots=case.S,
        n_values=case.V))
    return b["regs"], b["comp"]


def run_case(case: Case, device, plain: dict | None = None,
             guard: "Guard | None" = None) -> None:
    """Launch `case` on `device` and hold it to the plain version;
    raises AssertionError on any difference. `plain`, when given, keeps
    each dense batch's inputs and plain results (computed on the CPU,
    with the peak), so a STATS twin reuses its batch's. With `guard`
    the launches are its guarded ones, and every byte they should not
    write (the bands, and outside a column range the rest of out and
    outT) must still hold its pattern."""
    import torch

    from ..checker.elle import closure_square as cs
    from ..checker.elle import kernels as K
    from ..checker.knossos import dense

    from ..checker.knossos import kernels as KK
    from ..checker.knossos import synth as ksynth
    from ..checker.knossos.packed import _scan_history_packed

    square = cs.closure_square if guard is None else guard.square
    scan = dense.knossos_dense_scan if guard is None else guard.scan
    tag = case.label if guard is None else \
        f"{case.label} fill {guard.fill:#x}"
    u8 = torch.uint8
    if case.kind == "frontier":
        key = ("frontier", case.B, case.F, case.S, case.packed, case.stats,
               case.seed)
        plain = {} if plain is None else plain
        if key not in plain:
            # ragged histories at concurrency S, info ops, pad events
            ev = torch.from_numpy(ksynth.frontier_batch(case.S, case.B, 40,
                                                        case.seed))
            plain[key] = ev, (_scan_history_packed(ev, case.F, case.S)
                              if case.packed else KK._scan_history(
                                  ev, case.F, case.S, case.stats))
        ev, want = plain[key]
        if guard is not None:
            got = guard.frontier(ev.to(device), case.F, case.S, case.packed,
                                 case.stats, case.blocks)
        else:
            saved = KK.WORKSPACE_BYTES
            if case.blocks:
                KK.WORKSPACE_BYTES = case.blocks * KK.plan_frontier(
                    case.F, case.S, case.packed).work_bytes
            try:
                got = KK.knossos_frontier_scan(
                    ev.to(device), case.F, case.S, packed=case.packed,
                    with_stats=case.stats)
            finally:
                KK.WORKSPACE_BYTES = saved
        assert len(got) == len(want), f"{tag}: {len(got)} outputs"
        names = ("valid", "overflow", "rounds", "peak", "explored")
        for part, g, w in zip(names, got, want):
            assert torch.equal(g.cpu(), w.to(g.dtype)), \
                f"{tag}: {part} {g.tolist()} != {w.tolist()}"
    elif case.kind == "scan":
        key = (case.B, case.S, case.V, case.seed)
        plain = {} if plain is None else plain
        if key not in plain:
            regs, comp = (torch.from_numpy(a) for a in _dense_inputs(case))
            plain[key] = regs, comp, dense.scan_dense_ref(
                regs, comp, case.V, case.S, with_stats=True)
        regs, comp, want = plain[key]
        got = scan(regs.to(device), comp.to(device), case.V, case.S,
                   with_stats=case.stats)
        for part, g, w in zip(("valid", "rounds", "peak"), got, want):
            if g is not None:
                assert torch.equal(g.cpu(), w.to(g.dtype)), \
                    f"{tag}: {part} {g.tolist()} != {w.tolist()}"
    elif case.kind == "split":
        m = _bool_batch(case.B, case.T, case.seed, device)
        steps = 12           # past the fixpoint: the last rounds skip
        got = K._closure_batched(m, steps, square=square,
                                 mp=[m.device] * case.mp)
        want = K._closure_batched(m, steps, square=cs.closure_square_ref)
        assert torch.equal(got.view(u8), want.view(u8)), \
            f"{tag}: closure differs"
    else:
        m = _bool_batch(case.B, case.T, case.seed, device)
        mT = m.transpose(1, 2).contiguous()

        def act():
            return None if case.active is None else torch.tensor(
                case.active, dtype=torch.int32, device=device)

        ka, ra = act(), act()
        out, outT, ch = square(m, mT, ka, cols=case.cols)
        rout, routT, rch = cs.closure_square_ref(m, mT, ra, cols=case.cols)
        c0, c1 = case.cols or (0, case.T)
        assert torch.equal(out[:, :, c0:c1].view(u8),
                           rout[:, :, c0:c1].view(u8)), f"{tag}: out differs"
        assert torch.equal(outT[:, c0:c1].view(u8),
                           routT[:, c0:c1].view(u8)), f"{tag}: outT differs"
        assert torch.equal(ch.view(u8), rch.view(u8)), \
            f"{tag}: changed differs"
        assert ka is None or torch.equal(ka, ra), \
            f"{tag}: active {ka.tolist()} != {ra.tolist()}"
        if guard is not None:
            guard.untouched(tag, out, outT, c0, c1)
    if guard is not None:
        guard.intact(tag)


def run_canary(device) -> None:
    """Each kernel launched on unwritten device memory (`torch.empty`
    with the caching allocator off: fresh allocations): a skipped
    closure round reads m and mT, each dense tier reads regs and comp.
    The frontier kernel reads unwritten events. Under initcheck every
    launch must be reported."""
    import torch

    from ..checker.elle import closure_square as cs
    from ..checker.knossos import dense

    B, T = 1, 128
    m = torch.empty((B, T, T), dtype=torch.bool, device=device)
    mT = torch.empty_like(m)
    cs.closure_square(m, mT, torch.zeros(2, dtype=torch.int32,
                                         device=device))
    for S, V in ((3, 8), (12, 8)):     # the warp tier, the block tier
        regs = torch.empty((1, 4, S, 4), dtype=torch.int32, device=device)
        comp = torch.full((1, 4), -1, dtype=torch.int32, device=device)
        comp[0, 0] = 0                 # step 0 completes slot 0
        dense.knossos_dense_scan(regs, comp, V, S)
    from ..checker.knossos import kernels as KK
    events = torch.empty((1, 4, 6), dtype=torch.int32, device=device)
    KK.knossos_frontier_scan(events, 4, 3, packed=True)
    torch.cuda.synchronize(device)


def child(tool: str) -> int:
    """The process under the tool: every case, or the canary."""
    import torch

    device = torch.device("cuda", torch.cuda.current_device())
    if tool == "canary":
        run_canary(device)
        print(CASES_TAG + json.dumps({"canary": True}), flush=True)
        return 0
    done: dict = {}
    plain: dict = {}
    t0 = time.perf_counter()
    for case in cases(tool):
        t = time.perf_counter()
        run_case(case, device, plain)
        torch.cuda.synchronize(device)
        done[case.kernel] = done.get(case.kernel, 0) + 1
        print(f"  {case.label}: equal ({time.perf_counter() - t:.2f}s)",
              flush=True)
    print(CASES_TAG + json.dumps({"cases": done, "secs": round(
        time.perf_counter() - t0, 3)}), flush=True)
    return 0


# ------------------------------------------------- guard bands, no tool

#: Bytes of pattern either side of every buffer of a guarded launch (a
#: multiple of the 1,024-byte alignment TMA's swizzled tiles keep).
GUARD = 1 << 16
#: The two byte patterns every guarded case runs with, neither 0 nor 1.
FILLS = (0x5A, 0xA5)


class Guarded:
    """`nbytes` of device memory between two GUARD-byte bands, the
    whole buffer filled with `fill`: what a launch does not write keeps
    the pattern. An input's bands take the complement instead, so a
    copy that runs past an input into an output changes the output's
    band."""

    def __init__(self, nbytes: int, fill: int, device):
        import torch

        self.fill = fill
        self.buf = torch.full((nbytes + 2 * GUARD,), fill,
                              dtype=torch.uint8, device=device)
        self.inner = self.buf[GUARD:GUARD + nbytes]

    def load(self, t) -> "Guarded":
        """Make this an input: `t`'s bytes inside, the complement of the
        fill in the bands."""
        import torch

        self.fill ^= 0xFF
        self.buf.fill_(self.fill)
        self.inner.copy_(t.contiguous().view(torch.uint8).flatten())
        return self

    def intact(self) -> bool:
        """Both bands still hold their pattern."""
        return bool((self.buf[:GUARD] == self.fill).all()
                    and (self.buf[-GUARD:] == self.fill).all())


def _stream(device):
    import torch
    return torch.cuda.current_stream(device).cuda_stream


class Guard:
    """The launches of one guarded case with pattern `fill`: each
    kernel through its C entry point on Guarded copies of its inputs
    into Guarded outputs that start as `fill`, with the wrappers'
    signatures, so `run_case` and `_ColumnSplit` call them as they call
    the wrappers. Every buffer made is kept for `intact`."""

    def __init__(self, fill: int):
        self.fill = fill
        self.bands: list[Guarded] = []

    def _buf(self, nbytes: int, device, t=None) -> Guarded:
        g = Guarded(nbytes, self.fill, device)
        self.bands.append(g if t is None else g.load(t))
        return g

    def square(self, m, mT, active=None, cols=None):
        """closure_square's launch: (out, outT, changed) as bool views of
        the guarded outputs (a byte left at the pattern reads as true,
        so a column no block or copy wrote changes a closure);
        `active`, when given, is updated in place as the wrapper's
        is."""
        import torch

        from .. import _build

        B, T, _ = m.shape
        dev = m.device
        n = B * T * T
        gm, gmT = self._buf(n, dev, m), self._buf(n, dev, mT)
        gout, goutT, gch = (self._buf(n, dev), self._buf(n, dev),
                            self._buf(B, dev))
        gch.inner.zero_()
        gact = None if active is None else self._buf(8, dev, active)
        c0, c1 = cols or (0, T)
        lib = _build.load("closure_square")
        rc = lib.closure_square_cols_launch(
            gm.inner.data_ptr(), gmT.inner.data_ptr(),
            gout.inner.data_ptr(), goutT.inner.data_ptr(),
            gch.inner.data_ptr(),
            None if gact is None else gact.inner.data_ptr(), B, T, c0, c1,
            dev.index, _stream(dev))
        if rc:
            raise _build.KernelLaunchError(
                lib.closure_square_error_string(rc).decode())
        if active is not None:
            active.copy_(gact.inner.view(torch.int32))
        return (gout.inner.view(torch.bool).view(B, T, T),
                goutT.inner.view(torch.bool).view(B, T, T),
                gch.inner.view(torch.bool))

    def scan(self, regs, comp, V: int, S: int, with_stats: bool = False):
        """knossos_dense_scan's launch, as `dense.plan_scan` plans it:
        (valid uint8 [B], rounds int32 [B]) and, with stats, peak int32
        [B]."""
        import torch

        from .. import _build
        from ..checker.knossos import dense

        B, C = comp.shape
        dev = regs.device
        gregs = self._buf(regs.numel() * 4, dev, regs)
        gcomp = self._buf(comp.numel() * 4, dev, comp)
        gvalid, grounds = self._buf(B, dev), self._buf(4 * B, dev)
        gpeak = self._buf(4 * B, dev) if with_stats else None
        plan = dense.plan_scan(S, V)
        lib = _build.load("knossos_dense")
        rc = lib.knossos_dense_launch(
            gregs.inner.data_ptr(), gcomp.inner.data_ptr(),
            gvalid.inner.data_ptr(), grounds.inner.data_ptr(),
            None if gpeak is None else gpeak.inner.data_ptr(), B, C, S, V,
            0 if plan.tier == "warp" else 1, plan.threads, dev.index,
            _stream(dev))
        if rc:
            raise _build.KernelLaunchError(
                lib.knossos_dense_error_string(rc).decode())
        got = (gvalid.inner, grounds.inner.view(torch.int32))
        return got + ((gpeak.inner.view(torch.int32),) if with_stats
                      else ())

    def frontier(self, events, F: int, S: int, packed: bool,
                 with_stats: bool, blocks: int = 0):
        """knossos_frontier_scan's launch, as `plan_frontier` plans it,
        its global tier's workspace guarded too (`blocks` of it, 0: one
        a history): (valid uint8, overflow uint8, rounds int32) [B] and,
        with stats, (peak, explored) int32 [B]."""
        import torch

        from .. import _build
        from ..checker.knossos import kernels as KK

        B, E, _ = events.shape
        dev = events.device
        gev = self._buf(events.numel() * 4, dev, events)
        gvalid, gover = self._buf(B, dev), self._buf(B, dev)
        outs = [self._buf(4 * B, dev) for _ in range(3 if with_stats
                                                     else 1)]
        plan = KK.plan_frontier(F, S, packed)
        grid, gwork = B, None
        if plan.tier == "global":
            grid = blocks or B
            gwork = self._buf(grid * plan.work_bytes, dev)
        lib = _build.load("knossos_frontier")
        rc = lib.knossos_frontier_launch(
            gev.inner.data_ptr(), gvalid.inner.data_ptr(),
            gover.inner.data_ptr(), outs[0].inner.data_ptr(),
            *([o.inner.data_ptr() for o in outs[1:]] if with_stats
              else [None, None]),
            None if gwork is None else gwork.inner.data_ptr(), B, E, F, S,
            int(packed), grid, dev.index, _stream(dev))
        if rc:
            raise _build.KernelLaunchError(
                lib.knossos_frontier_error_string(rc).decode())
        return (gvalid.inner.view(torch.bool), gover.inner.view(torch.bool),
                *(o.inner.view(torch.int32) for o in outs))

    def untouched(self, tag: str, out, outT, c0: int, c1: int) -> None:
        """Outside columns [c0, c1) out and outT still hold the
        pattern."""
        import torch

        for part, rest in (("out", out[:, :, :c0]), ("out", out[:, :, c1:]),
                           ("outT", outT[:, :c0]), ("outT", outT[:, c1:])):
            assert bool((rest.view(torch.uint8) == self.fill).all()), \
                f"{tag}: {part} written outside columns [{c0}, {c1})"

    def intact(self, tag: str) -> None:
        """Every band of the case's buffers still holds its pattern (each
        read waits for the launches before it)."""
        bad = [i for i, g in enumerate(self.bands) if not g.intact()]
        assert not bad, f"{tag}: guard bands of buffers {bad} of " \
            f"{len(self.bands)} overwritten"


def run_guard(device) -> dict:
    """Every case of `cases("memcheck")` through the guarded launches,
    once with each of FILLS: {kernel: cases}; raises AssertionError on
    the first fault."""
    done: dict = {}
    plain: dict = {}
    for case in cases("memcheck"):
        t = time.perf_counter()
        for fill in FILLS:
            run_case(case, device, plain, guard=Guard(fill))
        done[case.kernel] = done.get(case.kernel, 0) + 1
        print(f"  guarded {case.label}: equal, bands intact "
              f"({time.perf_counter() - t:.2f}s)", flush=True)
    return done


# ----------------------------------------------------------- the parent

_SUMMARY = re.compile(r"ERROR SUMMARY: (\d+) errors?")
#: What the tool prints when it cannot attach to the card at all.
REFUSED = "Device not supported"
_RACE = re.compile(r"RACECHECK SUMMARY: (\d+) hazards? displayed "
                   r"\((\d+) errors?, (\d+) warnings?\)")


def parse_report(text: str) -> dict:
    """From a tool's output: its error and warning counts (None where
    it printed no summary), whether it refused the device, the report
    lines naming each kernel, and the child's cases line."""
    errors = warnings = None
    m = _SUMMARY.search(text)
    if m:
        errors = int(m.group(1))
    r = _RACE.search(text)
    if r:
        errors, warnings = int(r.group(2)), int(r.group(3))
    named = {k: sum(1 for ln in text.splitlines()
                    if ln.startswith("=========") and k in ln)
             for k in KERNELS}
    child_line = None
    for ln in text.splitlines():
        if ln.startswith(CASES_TAG):
            child_line = json.loads(ln[len(CASES_TAG):])
    return {"errors": errors, "warnings": warnings,
            "refused": REFUSED in text, "named": named,
            "child": child_line}


@dataclass
class ToolRun:
    tool: str
    rc: int
    wall_s: float
    errors: int | None
    warnings: int | None
    refused: bool
    named: dict
    cases: dict
    log: str

    @property
    def ok(self) -> bool:
        if self.refused:
            return False
        if self.tool == "canary":
            return (self.rc == ERROR_EXIT and bool(self.errors)
                    and all(self.named.values()))
        return (self.rc == 0 and self.errors == 0 and not self.warnings
                and not any(self.named.values()) and bool(self.cases))


def run_tool(sanitizer: str, tool: str, log_dir: Path) -> ToolRun:
    """One tool's process over the child (tool "canary": initcheck over
    the canary), ended after TIMEOUT_S; its output is kept in
    `log_dir/<tool>.log`."""
    argv = tool_argv(sanitizer, "initcheck" if tool == "canary" else tool,
                     child=tool)
    t0 = time.perf_counter()
    # a session of its own: a hung tool is ended with its target
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=tool_env(), cwd=ROOT, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=TIMEOUT_S)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        rc = -1
        text += f"\n(timed out after {TIMEOUT_S}s)"
    wall = time.perf_counter() - t0
    log = log_dir / f"{tool}.log"
    log.write_text(" ".join(argv) + "\n" + text)
    rep = parse_report(text)
    child_line = rep["child"] or {}
    return ToolRun(tool, rc, round(wall, 3), rep["errors"], rep["warnings"],
                   rep["refused"], rep["named"], child_line.get("cases", {}),
                   str(log))


def run_tools(tools=TOOLS, log_dir: Path | None = None) -> list[ToolRun]:
    """Each tool's process in turn, then the canary, each ended after
    TIMEOUT_S; raises FileNotFoundError when compute-sanitizer is not
    installed."""
    from .. import _build

    sanitizer = _build.find_cuda_tool("compute-sanitizer")
    if sanitizer is None:
        raise FileNotFoundError(
            "compute-sanitizer not found in $CUDA_HOME/bin, $CUDA_PATH/bin, "
            "on PATH or in /usr/local/cuda/bin")
    # absolute: the children run from the checkout's root
    log_dir = Path(log_dir or Path.cwd()).resolve()
    log_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for tool in (*tools, "canary"):
        run = run_tool(sanitizer, tool, log_dir)
        print(f"{tool}: rc {run.rc}, {run.wall_s:.1f}s, errors "
              f"{run.errors}, warnings {run.warnings}, report lines "
              f"{run.named}, cases {run.cases}: "
              f"{'ok' if run.ok else 'FAILED'} (log {run.log})"
              + (f"; {sanitizer} refused the device ({REFUSED!r}): "
                 "nothing was checked" if run.refused else ""),
              flush=True)
        runs.append(run)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tool", action="append", choices=TOOLS,
                    help="a tool to run (repeatable; default: all four)")
    ap.add_argument("--log-dir", default="sanitize-logs",
                    help="where each tool's output is kept")
    ap.add_argument("--guard", action="store_true",
                    help="no tool: the guarded launches (module doc)")
    ap.add_argument("--child", choices=(*TOOLS, "canary"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)
    import torch
    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA device", file=sys.stderr)
        return 2
    from .. import _build
    for name in ("closure_square", "knossos_dense",
                 "knossos_frontier"):                 # before any tool
        _build.build(name)
    if args.guard:
        t0 = time.perf_counter()
        try:
            done = run_guard(torch.device("cuda", 0))
        except AssertionError as e:
            print(f"sanitize_kernels --guard: FAILED: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "guard": {"cases": done, "fills": list(FILLS),
                                    "band_bytes": GUARD,
                                    "secs": round(time.perf_counter() - t0,
                                                  3)}}))
        return 0
    try:
        runs = run_tools(args.tool or TOOLS, Path(args.log_dir))
    except FileNotFoundError as e:
        print(f"sanitize_kernels: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "tools": [asdict(r) | {"ok": r.ok} for r in runs]}))
    return 0 if all(r.ok for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
