#!/usr/bin/env python3
"""The bounded frontier's hand kernel, `knossos_frontier_scan`, held to
its plain versions and timed, on one card.

    python3 -m jepsen_tpu_torch.tools.knossos_frontier_check

Builds `csrc/knossos_frontier.cu` (ptxas's registers and spills of
every instantiation are printed) and, beside it, the source variants of
`source_variants` (the register walk at 16 and 32 keys a thread), then
launches every case of CASES in each variant that takes it (packed; two
arrays; two arrays with stats) and holds every output (valid, overflow,
rounds, and with stats peak and explored) equal to the plain version run
on the card on the same events. Then conc-20's frontier histories
(BASELINE's conc-20 populations as `chip_smoke.py` phase 8 builds them,
those the tiered checker sends to the frontier) are timed in each
variant: the kernel (median of CUDA-event samples) beside the plain
version (one CUDA-event pair around the call) and the bound (`bound`),
the slowest history's rounds, the microseconds a round (the kernel's ms
over those rounds) and the instantiation's registers and spills; one
kernel-only launch of the histories repeated to THROUGHPUT_B
(`throughput`); each source variant on conc-20's histories and on
ARENA's batches, outputs equal to the shipped build's
(`time_candidates`); and conc-20's histories and ARENA's batches through
the wrapper alone (`time_arena`, which runs against any tree that has
the wrapper: load this file under that tree's package to time it).
Prints one JSON line with the card's name and power limit. Needs one
CUDA card and nvcc; `chip_smoke.py` phase 28 runs `check_cases`,
`time_variants` and `throughput`.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys

import torch

#: The register walk's layout edges, (F, S, B, ops, values) as CASES:
#: sorts of 256 keys (one warp at 8 keys a thread: exactly 32·8), 512
#: (two warps, a power of two past it: the first warp-bit strides; 32·16
#: for 16 keys a thread), 1,024 (128 threads; 32·32), 4,096 (512
#: threads) and 16,384 (1,024 threads of 16 keys). With CASES' sorts of
#: 8, 16, 2,048, 8,192 and 32,768 keys (1,024 threads of 32), every
#: (threads, keys) `plan_frontier` picks has a case.
EDGE_CASES = [(32, 7, 3, 40, 1000), (64, 7, 3, 40, 1000),
              (128, 7, 2, 40, 1000), (256, 15, 2, 40, 1000),
              (1024, 15, 2, 30, 1000)]
#: (frontier F, slots S, histories B, ops a history, values) of each
#: kernel-vs-plain case: F from 4 to 512 on the shared tier and 2048,
#: 4096 past it (two arrays: both global; packed: 2048 shared, 4096
#: global), S from 1 to the two-array limit 24 and the packed one near
#: 27 (few values, so `state << S` fits), odd and single-block batches;
#: F = 4 overflows; a sort below one warp's keys (F = 4, S = 1), and
#: EDGE_CASES. Every batch has pad events past each history's end, info
#: ops holding their slots, and every other history corrupted; odd E
#: (read from device memory) and even E (staged) both occur.
CASES = [(4, 1, 5, 30, 1000), (4, 3, 9, 60, 1000), (16, 8, 9, 60, 1000),
         (64, 3, 33, 80, 1000), (64, 16, 5, 60, 1000),
         (512, 8, 13, 120, 1000), (16, 24, 3, 40, 100),
         (64, 27, 2, 40, 6), (2048, 8, 3, 60, 1000),
         (4096, 8, 3, 60, 1000)] + EDGE_CASES
#: Keys a thread of the source variants (`source_variants`): 512 and 256
#: threads at conc-20's sort of 8,192 keys, beside the shipped 1,024 x
#: 8; 32 keys also 512 threads at ARENA's 16,384.
CANDIDATES = (16, 32)
#: Batches past conc-20's sort size at the default arena, (F, S, B, ops):
#: two arrays at S = 16 and 24 (sorts of 16,384 keys on 1,024 threads
#: of 16), and packed at S = 16; `synth.frontier_batch`'s histories.
ARENA = [(512, 16, 13, 400), (512, 24, 13, 400)]
#: Histories of the kernel-only throughput launch: conc-20's repeated to
#: two a streaming multiprocessor of an H100.
THROUGHPUT_B = 264
#: The case whose global tier runs with a workspace of two blocks, so
#: blocks stride over its histories.
STRIDED = (2048, 8, 5, 40, 1000)
#: (label, packed, with_stats) of the three variants.
VARIANTS = (("packed", True, False), ("pairs", False, False),
            ("stats", False, True))
#: conc-20 (chip_smoke.py phase 8): each population's histories and ops.
C20_B, C20_OPS = 20, 400
#: The frontier's default arena (`Linearizable`'s and the CLI's).
FRONTIER = 512
#: Peaks: HBM bytes/s (NVIDIA H100 data sheet; the SXM part unless the
#: name says PCIe), and 32-bit integer compares/s: 64 a clock an SM at
#: compute capability 9.0 against 128 float32 FMAs (CUDA C++ Programming
#: Guide, arithmetic instruction throughput), so a quarter of the data
#: sheet's float32 rate (67 and 51 TFLOP/s), which counts an FMA as two.
PEAKS = (("H100 PCIe", 2.0e12, 51e12 / 4), ("H100", 3.35e12, 67e12 / 4))


def n_values(events) -> int:
    """Interned values a batch's events name (nil included)."""
    return int(max(events[:, :, 3].max(), events[:, :, 4].max())) + 1


def variants_for(events, S: int) -> list[tuple[str, bool, bool]]:
    """The variants that take a batch: two arrays up to S = 24, packed
    while every `state << S | mask` fits an int32."""
    from ..checker.knossos.kernels import MAX_SLOTS
    from ..checker.knossos.packed import packable

    return [v for v in VARIANTS
            if (packable(n_values(events), S) if v[1] else S <= MAX_SLOTS)]


def same(got: tuple, want: tuple, what: str) -> None:
    names = ("valid", "overflow", "rounds", "peak", "explored")
    for part, g, w in zip(names, got, want):
        assert torch.equal(g, w), \
            f"{what}: {part} {g.tolist()} != plain {w.tolist()}"


def run_case(F: int, S: int, B: int, ops: int, values: int, seed: int,
             device, workspace: int | None = None) -> list[str]:
    """One case in each variant that takes it, the kernel against the
    plain version on `device`'s tensors; `workspace` bounds the global
    tier's workspace (bytes). Raises AssertionError on a difference."""
    from ..checker.knossos import kernels as K
    from ..checker.knossos import synth
    from ..checker.knossos.packed import _scan_history_packed

    events = synth.frontier_batch(S, B, ops, seed, n_values=values)
    ev = torch.from_numpy(events).to(device)
    out = []
    pairs = None    # one `_scan_history` serves both two-array variants
    for label, packed, stats in variants_for(events, S):
        plan = K.plan_frontier(F, S, packed)
        saved = K.WORKSPACE_BYTES
        if workspace is not None:
            K.WORKSPACE_BYTES = workspace
        try:
            got = K.knossos_frontier_scan(ev, F, S, packed=packed,
                                          with_stats=stats)
        finally:
            K.WORKSPACE_BYTES = saved
        if packed:
            want = _scan_history_packed(ev, F, S)
        else:
            pairs = pairs or K._scan_history(ev, F, S, with_stats=True)
            want = pairs if stats else pairs[:3]
        torch.cuda.synchronize(device)
        grid = B if plan.tier == "shared" else min(B, max(
            1, (workspace or K.WORKSPACE_BYTES) // plan.work_bytes))
        layout = f"{plan.threads} threads x {plan.keys} keys, " \
            if plan.tier == "shared" else ""
        what = f"F={F} S={S} B={B} {label} ({plan.tier} tier, {layout}" \
            f"{grid} blocks)"
        same(got, want, what)
        out.append(f"{what}: valid {sum(got[0].tolist())}/{B}, overflow "
                   f"{sum(got[1].tolist())}, rounds {int(got[2].sum())}, "
                   f"E={events.shape[1]}: equal")
    return out


def check_cases(device, cases=CASES) -> list[str]:
    """Every case, and STRIDED with a two-block workspace; one line
    each. Raises AssertionError on the first difference."""
    from ..checker.knossos import kernels as K

    lines = []
    for seed, case in enumerate(cases):
        lines += run_case(*case, seed=seed, device=device)
    F, S = STRIDED[:2]
    two = 2 * K.plan_frontier(F, S, False).work_bytes
    return lines + run_case(*STRIDED, seed=len(cases), device=device,
                            workspace=two)


def conc20_encodings() -> list:
    """conc-20's histories that the tiered checker sends to the frontier
    (past the dense grid, within the frontier's feasibility budget), as
    `chip_smoke.py` phase 8 builds the populations."""
    from ..checker.knossos import dense, synth
    from ..checker.knossos import encode as kenc

    hs = synth.synth_register_batch(B=C20_B, n_ops=C20_OPS, n_procs=20,
                                    info_prob=0.005, seed=7, max_pending=16)
    hs += synth.synth_register_batch(B=C20_B, n_ops=max(C20_OPS, 256),
                                     n_procs=20, n_values=10_000,
                                     info_prob=0.005, seed=11, max_pending=8)
    budget = 2 * (FRONTIER.bit_length() - 1)
    out = []
    for h in hs:
        try:
            dense.encode_dense_history(h)
        except kenc.EncodingError:
            try:
                e = kenc.encode_register_history(h)
            except kenc.EncodingError:
                continue
            if e.half_doublings_peak <= budget:
                out.append(e)
    return out


def sort_compares(n: int) -> int:
    """Compares of one round over n keys: n·⌈log2 n⌉ (the least a
    comparison sort does) and n for the dedupe pass."""
    return n * math.ceil(math.log2(n)) + n if n > 1 else n


def bound(name: str, B: int, E: int, F: int, S: int, rounds: int,
          live: list[int] | None = None) -> dict:
    """The least time for the walk on the card named `name`: the events
    read once and valid, overflow and rounds written once, against the
    rounds' compares at the 32-bit integer rate. Two arrays: every round
    (summed over histories) sorts the F·(S+1) keys, since the dead tail
    is part of the exit test, and a compare of their 64-bit keys is two
    32-bit ones. Packed: a round sorts its live configurations and
    their candidates, L·(S+1) keys for each L of `live` (every round of
    every history, from `_expand_fixpoint_packed.live`)."""
    bw, word = next(((b, w) for key, b, w in PEAKS if key in name),
                    PEAKS[-1][1:])
    if live is None:
        ops = 2 * rounds * sort_compares(F * (S + 1))
    else:
        ops = sum(sort_compares(L * (S + 1)) for L in live)
    nbytes = 4 * 6 * B * E + 6 * B
    t_ops, t_bytes = ops / word * 1e3, nbytes / bw * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "compares": ops, "bytes": nbytes}


def cuda_ms(fn, reps: int = 5) -> list[float]:
    """Milliseconds of `fn`, one CUDA-event pair a sample."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def event_ms(fn):
    """fn() between a CUDA event pair: (its result, the milliseconds)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    b.synchronize()
    return res, a.elapsed_time(b)


def ptxas(log: str) -> dict:
    """ptxas's registers and spill bytes of each frontier_kernel
    instantiation in a build log: {(packed, stats, keys a thread (0:
    the global tier)): {"registers", "spill_bytes"}}."""
    from .knossos_dense_variants import ptxas_summary

    out = {}
    for f in ptxas_summary(log):
        m = re.search(r"frontier_kernelILb(\d)ELb(\d)ELi(\d+)E",
                      f["function"])
        if m:
            out[(m.group(1) == "1", m.group(2) == "1", int(m.group(3)))] = {
                "registers": f.get("registers"),
                "spill_bytes": f["spill_stores"] + f["spill_loads"]}
    return out


def source_variants(src: str) -> dict[int, str]:
    """The kernel's source with KEYS (keys a thread wherever 1,024
    threads hold the sort) set to each of CANDIDATES, and its launch
    bound at 512 threads, so that 32 keys a thread may take 128
    registers: {keys: source}."""
    keys, bounds = "constexpr int KEYS = 8;", "__launch_bounds__(MAX_THREADS)"
    assert src.count(keys) == 1 and src.count(bounds) == 1
    return {k: src.replace(keys, f"constexpr int KEYS = {k};").replace(
        bounds, "__launch_bounds__(MAX_THREADS / 2)") for k in CANDIDATES}


def build_variants() -> dict:
    """Start one nvcc a source variant: {keys: (library, process)}."""
    from .. import _build

    out_dir = _build.BUILD_DIR / "frontier_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    src = (_build.SRC_DIR / "knossos_frontier.cu").read_text()
    for k, text in source_variants(src).items():
        cu = out_dir / f"knossos_frontier_k{k}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[k] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def launch_lib(lib, ev, F: int, S: int, packed: bool, stats: bool) -> tuple:
    """One shared-tier launch of a source variant's library `lib`
    (`knossos_frontier_launch` as the wrapper calls it): the wrapper's
    outputs."""
    from .. import _build

    B, E, _ = ev.shape
    outs = [torch.empty(B, dtype=torch.bool, device=ev.device)
            for _ in range(2)] + [
        torch.empty(B, dtype=torch.int32, device=ev.device)
        for _ in range(3 if stats else 1)]
    rc = lib.knossos_frontier_launch(
        ev.data_ptr(), *(o.data_ptr() for o in outs[:3]),
        *([o.data_ptr() for o in outs[3:]] if stats else [None, None]),
        None, B, E, F, S, int(packed), B, ev.device.index,
        torch.cuda.current_stream(ev.device).cuda_stream)
    if rc:
        raise _build.KernelLaunchError(
            lib.knossos_frontier_error_string(rc).decode())
    return tuple(outs)


def live_rounds(ev, F: int, S: int) -> list[int]:
    """The live configurations of every round of the plain packed walk
    over `ev` (one untimed run with `_expand_fixpoint_packed.live` set),
    each history's rounds only."""
    from ..checker.knossos import packed as P

    P._expand_fixpoint_packed.live = []
    try:
        P._scan_history_packed(ev, F, S)
        rows = P._expand_fixpoint_packed.live
    finally:
        P._expand_fixpoint_packed.live = None
    return [x for x in torch.stack(rows).flatten().tolist() if x >= 0] \
        if rows else []


def time_variants(device, name: str, encs: list, reps: int = 5) -> dict:
    """The frontier histories `encs` (one batch, as the checker packs
    it) in each variant: the kernel's median ms and the plain version's
    ms on the card (one `_scan_history` run, which carries its stats
    either way, for both two-array variants), every output equal, the
    kernel's rounds, its slowest history's rounds, the microseconds a
    round (ms over those rounds), the launch's threads and keys a
    thread, the registers and spills of the instantiation it ran, and
    its bound (packed: from the live configurations of each round,
    `live_rounds`). {label: record}."""
    from .. import _build
    from ..checker.knossos import kernels as K
    from ..checker.knossos.encode import pack_register_batch
    from ..checker.knossos.packed import _scan_history_packed, packable

    batch = pack_register_batch(encs)
    S, E = batch["shape"].n_slots, batch["shape"].n_events
    ev = torch.from_numpy(batch["events"]).to(device)
    fits = all(packable(e.n_values, S) for e in encs)
    regs = ptxas(_build.build_log("knossos_frontier"))
    out = {}
    pairs = None    # one `_scan_history` serves both two-array variants
    for label, packed, stats in VARIANTS:
        if packed and not fits:
            continue

        def kernel():
            return K.knossos_frontier_scan(ev, FRONTIER, S, packed=packed,
                                           with_stats=stats)

        got = kernel()
        if packed:
            want, plain_ms = event_ms(
                lambda: _scan_history_packed(ev, FRONTIER, S))
        else:
            pairs = pairs or event_ms(
                lambda: K._scan_history(ev, FRONTIER, S, with_stats=True))
            want, plain_ms = pairs[0] if stats else pairs[0][:3], pairs[1]
        same(got, want, f"conc-20's frontier histories, {label}")
        ms = statistics.median(cuda_ms(kernel, reps))
        rounds, slowest = int(got[2].sum()), int(got[2].max())
        plan = K.plan_frontier(FRONTIER, S, packed)
        live = live_rounds(ev, FRONTIER, S) if packed else None
        if live is not None:
            assert len(live) == rounds, (len(live), rounds)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "rounds": rounds,
                      "slowest_rounds": slowest,
                      "us_per_round": 1e3 * ms / slowest,
                      "B": len(encs), "E": E, "F": FRONTIER, "S": S,
                      "tier": plan.tier, "threads": plan.threads,
                      "keys": plan.keys,
                      **regs.get((packed, stats, plan.keys), {}),
                      **bound(name, len(encs), E, FRONTIER, S, rounds,
                              live)}
    return out


def arena_batches(device, encs: list) -> dict:
    """conc-20's frontier histories `encs` and ARENA's batches on
    `device`: {label: (events, S)}."""
    from ..checker.knossos import synth
    from ..checker.knossos.encode import pack_register_batch

    batch = pack_register_batch(encs)
    out = {"conc-20": (torch.from_numpy(batch["events"]).to(device),
                       batch["shape"].n_slots)}
    for F, S, B, ops in ARENA:
        ev = synth.frontier_batch(S, B, ops, seed=S)
        out[f"F={F} S={S} B={B}"] = (torch.from_numpy(ev).to(device), S)
    return out


def time_arena(device, encs: list, reps: int = 5) -> dict:
    """`arena_batches` through the wrapper alone, in each variant that
    takes a batch: the median ms, the rounds and the slowest history's.
    Uses only the wrapper and `synth.frontier_batch`, so it times any
    tree that has them. {batch: {variant: record}}."""
    from ..checker.knossos import kernels as K

    out = {}
    for label, (ev, S) in arena_batches(device, encs).items():
        rec = {}
        for var, packed, stats in variants_for(ev.cpu().numpy(), S):
            def kernel():
                return K.knossos_frontier_scan(ev, FRONTIER, S,
                                               packed=packed,
                                               with_stats=stats)

            got = kernel()
            rec[var] = {"ms": statistics.median(cuda_ms(kernel, reps)),
                        "rounds": int(got[2].sum()),
                        "slowest_rounds": int(got[2].max())}
        out[label] = rec
    return out


def time_candidates(device, encs: list, procs: dict, reps: int = 5) -> dict:
    """Each source variant of `procs` (`build_variants`) on
    `arena_batches`, in each variant that takes a batch and fits the
    variant's 512-thread bound: outputs equal to the shipped build's
    (the wrapper's), the median ms, the threads and the ptxas record of
    the instantiation. {keys: {batch: {variant: record}}}."""
    from .. import _build
    from ..checker.knossos import kernels as K
    from .knossos_dense_variants import ptxas_summary

    batches = arena_batches(device, encs)
    out = {}
    for k, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise _build.KernelBuildError(f"{k} keys a thread: nvcc "
                                          f"failed\n{log}")
        lib = _build.load("knossos_frontier", path=so)
        regs = {}
        for f in ptxas_summary(log):
            m = re.search(r"frontier_kernelILb(\d)ELb(\d)ELi(\d+)E",
                          f["function"])
            if m:
                regs[(m.group(1) == "1", m.group(2) == "1",
                      int(m.group(3)))] = {
                    "registers": f.get("registers"),
                    "spill_bytes": f["spill_stores"] + f["spill_loads"]}
        out[k] = {}
        for label, (ev, S) in batches.items():
            p = 1 << (FRONTIER * (S + 1) - 1).bit_length()
            kpt = max(k, p // 1024)
            if p // kpt > 512:
                continue
            rec = {}
            for var, packed, stats in variants_for(ev.cpu().numpy(), S):
                want = K.knossos_frontier_scan(ev, FRONTIER, S,
                                               packed=packed,
                                               with_stats=stats)

                def cand(packed=packed, stats=stats):
                    return launch_lib(lib, ev, FRONTIER, S, packed, stats)

                same(cand(), want, f"{label} {var}, {k} keys a thread")
                rec[var] = {"threads": max(32, p // kpt), "keys": kpt,
                            "ms": statistics.median(cuda_ms(cand, reps)),
                            **regs.get((packed, stats, kpt), {})}
            out[k][label] = rec
    return out


def throughput(device, encs: list, packed: bool, copies: int = THROUGHPUT_B
               ) -> float:
    """One kernel-only launch of the histories `encs` repeated to
    `copies` rows (no plain version): its outputs held equal to the
    one-copy launch's repeated; returns its CUDA-event ms."""
    from ..checker.knossos import kernels as K
    from ..checker.knossos.encode import pack_register_batch

    batch = pack_register_batch(encs)
    S = batch["shape"].n_slots
    ev = torch.from_numpy(batch["events"]).to(device)
    rows = torch.arange(copies, device=device) % ev.shape[0]
    evs = ev[rows].contiguous()
    one = K.knossos_frontier_scan(ev, FRONTIER, S, packed=packed)
    many, ms = event_ms(lambda: K.knossos_frontier_scan(
        evs, FRONTIER, S, packed=packed))
    same(many, tuple(x[rows] for x in one),
         f"conc-20's frontier histories repeated to {copies}")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("knossos_frontier_check: no CUDA device", file=sys.stderr)
        return 2
    from .. import _build

    procs = build_variants()
    _build.build("knossos_frontier")
    print(_build.build_log("knossos_frontier").strip(), flush=True)
    regs = ptxas(_build.build_log("knossos_frontier"))
    print("ptxas (packed, stats, keys a thread; 0 the global tier): "
          + json.dumps({str(k): v for k, v in sorted(regs.items())}),
          flush=True)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for ln in check_cases(device):
        print(ln, flush=True)
    encs = conc20_encodings()
    timed = time_variants(device, name, encs)
    for label, rec in timed.items():
        print(f"conc-20 {label}: {json.dumps(rec)}", flush=True)
    many = {label: throughput(device, encs, packed)
            for label, packed, stats in VARIANTS[:2] if label in timed}
    print(f"conc-20 repeated to {THROUGHPUT_B} histories (ms): "
          f"{json.dumps(many)}", flush=True)
    cands = time_candidates(device, encs, procs)
    for k, rec in cands.items():
        print(f"{k} keys a thread: {json.dumps(rec)}", flush=True)
    arena = time_arena(device, encs)
    print(f"through the wrapper: {json.dumps(arena)}", flush=True)
    print(json.dumps({"device": name, "nvidia_smi": smi,
                      "cases": len(CASES) + 1, "conc20": timed,
                      "throughput_ms": many, "candidates": cands,
                      "arena": arena}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
