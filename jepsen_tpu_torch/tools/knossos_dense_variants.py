#!/usr/bin/env python3
"""Checks and times the launch variants of the knossos_dense_scan kernel
on one card.

    python3 jepsen_tpu_torch/tools/knossos_dense_variants.py [--check-only]

Builds `csrc/knossos_dense.cu` (printing the build's seconds and, per
kernel instantiation, ptxas's registers, stack frame and spills), then:

  1. check: every tier a shape allows (the warp tier at 1 and 8
     histories a block while the grid fits it, the block tier always)
     against `scan_dense_ref` on the card, valid and rounds exactly, at
     S = 1..14 slots and V in {3, 8, 16, 24, 40, 64} values; every mismatch
     is printed, and any fails the script;
  2. time (unless --check-only): in turns, CUDA event pairs around
     bursts of 3 launches, each variant at BASELINE config #1's shape
     (100 histories of 1,000 ops at concurrency 10: the warp tier at 1,
     2, 4 and 8 histories a block, the block tier, and the source
     variants below, built beside the shipped source and held to
     `scan_dense_ref` there first) and at the shapes on either side of
     the tier boundary (512 and 1,024 words: the warp tier where it
     fits, and the block tier).

Source variants: "skip free slots" (a round branches past a slot no
operation holds, instead of running it with empty masks).

Prints one JSON line with the card's name and power limit, the build
seconds and spill summary, the check's case count and each variant's
median milliseconds. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CHECK_V = (3, 8, 16, 24, 40, 64)
#: (S, V, B, ops) timed on either side of the tier boundary
BOUNDARY = [(11, 8, 100, 400), (12, 8, 100, 400), (8, 64, 100, 400),
            (9, 64, 100, 400), (9, 32, 100, 400), (10, 32, 100, 400)]


def ptxas_summary(log: str) -> list[dict]:
    """One dict per compiled function: its (demangled-ish) name,
    registers, stack frame and spill bytes, from `-Xptxas=-v`."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.append({"function": name, "stack": int(m.group(1)),
                        "spill_stores": int(m.group(2)),
                        "spill_loads": int(m.group(3))})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["function"] == name:
            out[-1]["registers"] = int(m.group(1))
    return out


def source_variants(src: str) -> dict[str, str]:
    old = "        // a free slot runs with empty masks: no branch between slots\n"
    assert old in src
    return {"skip free slots": src.replace(
        old, "        if (!((sm.rd | sm.wr | sm.cas) & bit)) continue;\n")}


def build_variants(_build) -> dict:
    """Start one nvcc a source variant; returns name -> (library, proc)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = source_variants((_build.SRC_DIR / "knossos_dense.cu").read_text())
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = out_dir / f"knossos_v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"knossos_v{i}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def variants(S: int, V: int) -> dict:
    """Launch plans to try at (S, V): the warp tier at 1 and 8 histories
    a block when the grid fits it, and the block tier."""
    from jepsen_tpu_torch.checker.knossos import dense

    out = {}
    if dense.plan_scan(S, V).tier == "warp":
        for hpb in (1, 8):
            out[f"warp x{hpb}"] = dense.plan_scan(
                S, V, histories_per_block=hpb)
    out["block"] = dense.plan_scan(S, V, warp_max_words=0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.checker.knossos import dense, synth

    procs = build_variants(_build)
    t0 = time.perf_counter()
    _build.load("knossos_dense")
    build_s = time.perf_counter() - t0
    funcs = ptxas_summary(_build.build_log("knossos_dense"))
    for f in funcs:
        print(json.dumps(f))

    def on_card(S, V, B, ops, seed):
        regs, comp = synth.dense_batch(S, V, B, ops, seed)
        return (torch.from_numpy(regs).cuda(), torch.from_numpy(comp).cuda())

    bad, n_cases = 0, 0
    for S in range(1, 15):
        for V in CHECK_V:
            B = 37 if S <= 10 else 5
            ops = 150 if V > 8 else 60
            regs, comp = on_card(S, V, B, ops, seed=S * 100 + V)
            want = dense.scan_dense_ref(regs, comp, V, S)
            for label, plan in variants(S, V).items():
                got = dense.knossos_dense_scan(regs, comp, V, S, plan=plan)
                torch.cuda.synchronize()
                n_cases += 1
                for part, g, w in zip(("valid", "rounds"), got, want):
                    if not torch.equal(g, w):
                        bad += 1
                        idx = (g != w).nonzero().flatten()[:5].tolist()
                        print(f"MISMATCH S={S} V={V} {label} {plan}: {part} "
                              f"at {idx}: kernel {g[idx].tolist()} plain "
                              f"{w[idx].tolist()}", flush=True)
    print(f"check: {n_cases} (shape, variant) cases, {bad} mismatches",
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    record = {"card": smi, "build_s": build_s,
              "max_spill_bytes": max((f["spill_stores"] + f["spill_loads"]
                                      for f in funcs), default=None),
              "max_stack_bytes": max((f["stack"] for f in funcs),
                                     default=None),
              "check_cases": n_cases, "mismatches": bad}
    if bad or "--check-only" in sys.argv:
        print(json.dumps(record))
        return 1 if bad else 0

    def burst_ms(fn, n=3) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    hs = synth.synth_register_batch(B=100, n_ops=1000, n_procs=10,
                                    info_prob=0.0, seed=1)
    b = dense.pack_dense_batch([dense.encode_dense_history(h) for h in hs])
    sh = b["shape"]
    shapes = {"config1": (torch.from_numpy(b["regs"]).cuda(),
                          torch.from_numpy(b["comp"]).cuda(),
                          sh.n_slots, sh.n_values)}
    for S, V, B, ops in BOUNDARY:
        regs, comp = on_card(S, V, B, ops, seed=7)
        shapes[f"S={S} V={V} B={B} ops={ops}"] = (regs, comp, S, V)
    src_fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(so)).knossos_dense_launch
        fn.restype, fn.argtypes = _build.PROTOTYPES["knossos_dense"][
            "knossos_dense_launch"]
        src_fns[name] = fn

    def source_variant(fn, regs, comp, S, V, plan):
        B, C = comp.shape
        valid = torch.empty(B, dtype=torch.bool, device="cuda")
        rounds = torch.empty(B, dtype=torch.int32, device="cuda")

        def run():
            rc = fn(regs.data_ptr(), comp.data_ptr(), valid.data_ptr(),
                    rounds.data_ptr(), None, B, C, S, V,
                    0 if plan.tier == "warp" else 1, plan.threads, 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
            return valid, rounds
        return run

    timed = {}
    for key, (regs, comp, S, V) in shapes.items():
        plans = variants(S, V)
        if key == "config1":
            plans = {f"warp x{h}": dense.plan_scan(S, V,
                                                   histories_per_block=h)
                     for h in (1, 2, 4, 8)}
            plans["block"] = dense.plan_scan(S, V, warp_max_words=0)
        fns = {label: (lambda p=p, r=regs, c=comp, s=S, v=V:
                       dense.knossos_dense_scan(r, c, v, s, plan=p))
               for label, p in plans.items()}
        if key == "config1":
            want = dense.knossos_dense_scan(regs, comp, V, S)
            for name, fn in src_fns.items():
                run = source_variant(fn, regs, comp, S, V,
                                     dense.plan_scan(S, V))
                got = run()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    print(f"{name} differs from the shipped kernel",
                          file=sys.stderr)
                    return 1
                fns[name] = run
        for fn in fns.values():
            burst_ms(fn, 2)                                    # warm-up
        samples = {k: [] for k in fns}
        order = list(fns) + list(reversed(fns))
        for _ in range(3):              # in turns, so drift hits them all
            for k in order:
                samples[k].append(burst_ms(fns[k]))
        timed[key] = {"S": S, "V": V, "B": int(comp.shape[0]),
                      "C_pad": int(comp.shape[1]),
                      "ms": {k: statistics.median(v)
                             for k, v in samples.items()}}
        print(json.dumps({key: timed[key]}), flush=True)
    record["timed"] = timed
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
