#!/usr/bin/env python3
"""Times source variants of the closure_square kernel on one card.

    python3 jepsen_tpu_torch/tools/closure_square_variants.py

Builds `csrc/closure_square.cu` as shipped and a few variants of it made
by editing a copy of the source (the raster's GROUP_M, and one whose
epilogue does no staging, comparing or storing, which is wrong on
purpose and timed only to price the epilogue), runs each at B=5,
T=5120, checks the correct ones against `closure_square_ref` exactly,
and times them in turns. Prints one JSON line with the card's name and
power limit and each variant's per-launch milliseconds (medians of CUDA
event pairs around bursts of 10 launches). Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
B, T = 5, 5120


def variants(src: str) -> dict[str, str]:
    def group(g: int) -> str:
        old = "constexpr int GROUP_M = 8;"
        assert old in src
        return src.replace(old, f"constexpr int GROUP_M = {g};")

    a = src.index("      const int live_cols = c1 - j0;")
    b = src.index('      asm volatile("fence.proxy.async.shared::cta;"')
    no_epilogue = (src[:a] + "      uint32_t diff = 0;\n#pragma unroll\n"
                   "      for (int c = 0; c < 128; ++c) diff |= d[c];\n"
                   + src[b:])
    return {"shipped (GROUP_M=8)": src, "GROUP_M=4": group(4),
            "GROUP_M=16": group(16), "GROUP_M=40 (whole column)": group(40),
            "no epilogue (wrong output)": no_epilogue}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.checker.elle import closure_square as cs

    nvcc = _build.find_nvcc()
    if nvcc is None:
        print("nvcc not found", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((_build.SRC_DIR / "closure_square.cu").read_text())
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu = out_dir / f"v{i}.cu"
        cu.write_text(text)
        procs[name] = (out_dir / f"v{i}.so", subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out_dir / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    launch = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(so)).closure_square_launch
        fn.restype, fn.argtypes = _build.PROTOTYPES["closure_square"][
            "closure_square_launch"]
        launch[name] = fn

    g = torch.Generator(device="cuda")
    g.manual_seed(99)
    m = (torch.rand((B, T, T), generator=g, device="cuda") < 0.01) \
        | torch.eye(T, dtype=torch.bool, device="cuda")
    mt = m.transpose(1, 2).contiguous()
    out, outT = torch.empty_like(m), torch.empty_like(m)
    changed = torch.zeros(B, dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn):
        changed.zero_()
        rc = fn(m.data_ptr(), mt.data_ptr(), out.data_ptr(),
                outT.data_ptr(), changed.data_ptr(), B, T, 0, stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    want = cs.closure_square_ref(m, mt)
    exact = {}
    for name, fn in launch.items():
        run(fn)
        torch.cuda.synchronize()
        exact[name] = all(torch.equal(x, y)
                          for x, y in zip((out, outT, changed), want))
        if not exact[name] and "wrong output" not in name:
            print(f"{name} differs from closure_square_ref",
                  file=sys.stderr)
            return 1

    def burst_ms(fn, n=10) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            run(fn)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    for fn in launch.values():
        burst_ms(fn, 3)                                        # warm-up
    samples = {name: [] for name in launch}
    order = list(launch) + list(reversed(launch))
    for _ in range(3):                  # in turns, so drift hits them all
        for name in order:
            samples[name].append(burst_ms(launch[name]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "B": B, "T": T, "variants": {
        name: {"ms": statistics.median(v), "exact": exact[name]}
        for name, v in samples.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
