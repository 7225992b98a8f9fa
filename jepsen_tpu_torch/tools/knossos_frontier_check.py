#!/usr/bin/env python3
"""The bounded frontier's hand kernel, `knossos_frontier_scan`, held to
its plain versions and timed, on one card.

    python3 -m jepsen_tpu_torch.tools.knossos_frontier_check

Builds `csrc/knossos_frontier.cu` (ptxas's registers and spills are
printed), then launches every case of CASES in each variant that takes
it (packed; two arrays; two arrays with stats) and holds every output
(valid, overflow, rounds, and with stats peak and explored) equal to
the plain version run on the card on the same events. Then conc-20's
frontier histories (BASELINE's conc-20 populations as `chip_smoke.py`
phase 8 builds them, those the tiered checker sends to the frontier)
are timed in each variant: the kernel (median of CUDA-event samples)
beside the plain version (one CUDA-event pair around the call) and the
bound (`bound`). Prints one JSON line with the card's name and power
limit. Needs one CUDA card and nvcc; `chip_smoke.py` phase 28 runs the
same functions.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys

import torch

#: (frontier F, slots S, histories B, ops a history, values) of each
#: kernel-vs-plain case: F from 4 to 512 on the shared tier and 2048,
#: 4096 past it (two arrays: both global; packed: 2048 shared, 4096
#: global), S from 1 to the two-array limit 24 and the packed one near
#: 27 (few values, so `state << S` fits), odd and single-block batches;
#: F = 4 overflows. Every batch has pad events past each history's end,
#: info ops holding their slots, and every other history corrupted.
CASES = [(4, 1, 5, 30, 1000), (4, 3, 9, 60, 1000), (16, 8, 9, 60, 1000),
         (64, 3, 33, 80, 1000), (64, 16, 5, 60, 1000),
         (512, 8, 13, 120, 1000), (16, 24, 3, 40, 100),
         (64, 27, 2, 40, 6), (2048, 8, 3, 60, 1000),
         (4096, 8, 3, 60, 1000)]
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
#: Published peaks: HBM bytes/s, and 32-bit operations/s outside the
#: tensor cores (the float32 rate; the data sheet has no int32 row)
#: (NVIDIA H100 data sheet; the SXM part unless the name says PCIe).
PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))


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
        want = _scan_history_packed(ev, F, S) if packed else \
            K._scan_history(ev, F, S, with_stats=stats)
        torch.cuda.synchronize(device)
        grid = B if plan.tier == "shared" else min(B, max(
            1, (workspace or K.WORKSPACE_BYTES) // plan.work_bytes))
        what = f"F={F} S={S} B={B} {label} ({plan.tier} tier, {grid} " \
            "blocks)"
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


def bound(name: str, B: int, E: int, F: int, S: int, rounds: int) -> dict:
    """The least time for the walk on the card named `name`: the events
    read once and valid, overflow and rounds written once, against, per
    round run (summed over histories), one sort and one dedupe pass over
    the F·(S+1) keys (N·⌈log2 N⌉ + N compares, the least a comparison
    sort does) at the 32-bit rate."""
    bw, word = next(((b, w) for key, b, w in PEAKS if key in name),
                    PEAKS[-1][1:])
    n = F * (S + 1)
    ops = rounds * (n * math.ceil(math.log2(n)) + n)
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


def time_variants(device, name: str, encs: list, reps: int = 5) -> dict:
    """The frontier histories `encs` (one batch, as the checker packs
    it) in each variant: the kernel's median ms and the plain version's
    ms on the card, every output equal, the kernel's rounds and its
    bound. {label: record}."""
    from ..checker.knossos import kernels as K
    from ..checker.knossos.encode import pack_register_batch
    from ..checker.knossos.packed import _scan_history_packed, packable

    batch = pack_register_batch(encs)
    S, E = batch["shape"].n_slots, batch["shape"].n_events
    ev = torch.from_numpy(batch["events"]).to(device)
    fits = all(packable(e.n_values, S) for e in encs)
    out = {}
    for label, packed, stats in VARIANTS:
        if packed and not fits:
            continue

        def kernel():
            return K.knossos_frontier_scan(ev, FRONTIER, S, packed=packed,
                                           with_stats=stats)

        def plain():
            return _scan_history_packed(ev, FRONTIER, S) if packed else \
                K._scan_history(ev, FRONTIER, S, with_stats=stats)

        got = kernel()
        want, plain_ms = event_ms(plain)
        same(got, want, f"conc-20's frontier histories, {label}")
        ms = statistics.median(cuda_ms(kernel, reps))
        rounds = int(got[2].sum())
        out[label] = {"ms": ms, "plain_ms": plain_ms, "rounds": rounds,
                      "B": len(encs), "E": E, "F": FRONTIER, "S": S,
                      "tier": K.plan_frontier(FRONTIER, S, packed).tier,
                      **bound(name, len(encs), E, FRONTIER, S, rounds)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("knossos_frontier_check: no CUDA device", file=sys.stderr)
        return 2
    from .. import _build

    _build.build("knossos_frontier")
    print(_build.build_log("knossos_frontier").strip(), flush=True)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for ln in check_cases(device):
        print(ln, flush=True)
    timed = time_variants(device, name, conc20_encodings())
    for label, rec in timed.items():
        print(f"conc-20 {label}: {json.dumps(rec)}", flush=True)
    print(json.dumps({"device": name, "nvidia_smi": smi,
                      "cases": len(CASES) + 1, "conc20": timed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
