#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`jepsen_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and the CUDA
toolkit's nvcc; it refuses to run without CUDA. Phases, each fatal on
failure:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    every csrc/*.cu kernel from this checkout's sources
  3. kernels  each hand kernel held to its plain PyTorch version on the
              card (exact equality of every output), then timed at the
              main path's shape beside the plain version and the nearest
              library calls (bf16 bmm, and int8 torch._int_mm)
  4. main     `analyze-store --checker append` on cuda over a synthetic
              two-level store of 64 runs x 10,000 ops (T=5000 txns,
              K=64 keys, every 8th run carrying a G1c cycle): exactly the
              corrupt runs must come out G1c/invalid, the launch counts
              must show the closures went through the kernel (and
              CUDA event pairs around each launch time it), and a
              re-run with the plain squaring on a copy of the store must
              write byte-identical results; then the installed CLI,
              `python -m jepsen_tpu_torch.cli ... --device cuda`, on a
              small store, byte-identical to a --device cpu run
  5. wr       `analyze-store --checker wr` on cuda over a synthetic
              rw-register store of 32 runs x 10,000 ops (5,000 txns, K=64
              keys, every 8th run carrying a write-skew pair): exactly
              those runs must come out G2-item/invalid, the launches must
              equal the buckets' closure rounds, and a plain-squaring
              re-run on a copy of 8 of the runs must write byte-identical
              results
  6. long     `analyze-store --checker append` over 3 list-append runs of
              100,000 ops (50,000 txns, K=64), past the dense limit, so
              through SCC condensation: a valid run (no SCC, no launch),
              one with an adjacent G1c pair (a 2-txn SCC) and one whose
              read observes an append 16,304 txns into its future (one
              SCC of ~4,000 txns, classified by closure_square at
              T_pad=4096); verdicts as designed, launches equal to the
              closure rounds, and a plain-squaring re-run of the two
              cyclic runs byte-identical

Each path is driven with the kernel's launch count set to 0 just before
it and read just after; a path that launched it no time fails.

The last lines are a `{"kernels": [...]}` record per kernel (with its
launches and summed device milliseconds per path), the nvidia-smi line,
and `{"ok": true, "device": {...}}`. Scratch data goes
to `.chip_smoke/` in the checkout and is removed at the end.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".chip_smoke"

#: Published dense peaks: int8 tensor-core operations/s and HBM bytes/s
#: (NVIDIA H100 data sheet; the SXM part unless the name says PCIe).
PEAKS = (("H100 PCIe", 1513e12, 2.0e12), ("H100", 1979e12, 3.35e12))

#: The main path's closure shape: 5000-txn histories pad to T=5120, and
#: the 1<<27-cell bucket budget fits 5 of them.
MAIN_B, MAIN_T = 5, 5120
DEVICE = "cuda"
STORE_RUNS, STORE_T, STORE_K, BAD_EVERY = 64, 5000, 64, 8
#: Phase 5: rw-register runs; the plain re-run takes the first WR_PLAIN.
WR_RUNS, WR_T, WR_K, WR_BAD_EVERY, WR_PLAIN = 32, 5000, 64, 8, 8
#: Phase 6: long list-append runs (synth.LONG_RUN_KINDS) and the
#: anomaly types each must come out with. The future run's classes are
#: those the host classifier (graph.classify_cycles) finds in its SCC.
LONG_T, LONG_K, LONG_GAP = 50_000, 64, 16_304
LONG_EXPECT = {"valid": [], "pair": ["G1c"],
               "future": ["G-single", "G1c", "G2-item"]}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def peaks(name: str) -> tuple[float, float]:
    for key, ops, bw in PEAKS:
        if key in name:
            return ops, bw
    say(f"no published peak for {name!r}; bounds use the H100 SXM row")
    return PEAKS[-1][1], PEAKS[-1][2]


def cuda_ms(fn, reps: int, burst: int = 5) -> list[float]:
    """Per-launch milliseconds of `fn`: `reps` samples, each a CUDA event
    pair around `burst` back-to-back calls, so that the host's launch
    overhead overlaps the device's work instead of adding to it."""
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
    return out


def random_bool(B: int, T: int, density: float, seed: int,
                reflexive: bool = True) -> torch.Tensor:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    m = torch.rand((B, T, T), generator=g, device="cuda") < density
    if reflexive:
        m |= torch.eye(T, dtype=torch.bool, device="cuda")
    return m


def transposed(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(1, 2).contiguous()


def kernel_cases() -> list:
    """(label, m) pairs: random batches at T not a multiple of the
    256-wide column tile, at the wr and long paths' shapes and at the
    main path's own bucket shapes (B=4 and B=5 at T=5120), then special
    inputs."""
    cases = []
    seed = 0
    shapes = [(B, T) for B in (1, 3) for T in (128, 384, 640)]
    # the wr and long paths' shapes: the last wr bucket (32 runs = 6 x 5
    # + 2), condensed SCCs at B=1 (a ragged 128-multiple, and the long
    # run's T_pad=4096)
    shapes += [(2, MAIN_T), (1, 3968), (1, 4096)]
    for B, T in shapes + [(MAIN_B - 1, MAIN_T), (MAIN_B, MAIN_T)]:
        for density in (0.001, 0.01, 0.05):
            seed += 1
            cases.append((f"B={B} T={T} p={density}",
                          random_bool(B, T, density, seed)))
    cases.append(("zeros", torch.zeros((2, 384, 384), dtype=torch.bool,
                                       device="cuda")))
    cases.append(("ones", torch.ones((2, 384, 384), dtype=torch.bool,
                                     device="cuda")))
    wide = torch.zeros((1, 384, 384), dtype=torch.bool, device="cuda")
    wide[0, 5, :] = True      # 384 products per cell: past int8's range
    wide[0, :, 7] = True
    cases.append(("wide row", wide))
    eye = torch.eye(640, dtype=torch.bool, device="cuda")
    cases.append(("identity", eye.expand(3, 640, 640).contiguous()))
    cases.append(("non-reflexive", random_bool(3, 640, 0.004, 98,
                                               reflexive=False)))
    # converged (identity) and unconverged histories in one batch
    cases.append(("mixed", torch.cat([eye[:384, :384][None],
                                      random_bool(2, 384, 0.01, 97)])))
    return cases


def phase_kernels(name: str) -> dict:
    """closure_square against closure_square_ref on the card (out, outT
    and changed, exactly), then its timing at the main path's shape."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs

    cases = kernel_cases()
    max_err = 0.0
    for label, m in cases:
        mt = transposed(m)
        got = cs.closure_square(m, mt)
        want = cs.closure_square_ref(m, mt)
        torch.cuda.synchronize()
        for part, g, w in zip(("out", "outT", "changed"), got, want):
            err = float((g != w).any())
            max_err = max(max_err, err)
            check(err == 0.0, f"closure_square's {part} differs from its "
                              f"plain version on {label}")
        if label == "identity":
            check(not bool(got[2].any()), "identity squared came out "
                                          "changed")
    say(f"closure_square == closure_square_ref on {len(cases)} cases "
        "(out, outT and changed; exact)")

    m = random_bool(MAIN_B, MAIN_T, 0.01, 99)
    mt = transposed(m)
    mb = m.to(torch.bfloat16)
    mi = m.view(torch.int8)
    kernel = lambda: cs.closure_square(m, mt)                  # noqa: E731
    plain = lambda: cs.closure_square_ref(m, mt)               # noqa: E731
    library = lambda: torch.bmm(mb, mb) > 0                    # noqa: E731

    def int8_library():
        return torch.stack([torch._int_mm(mi[b], mi[b]) > 0
                            for b in range(MAIN_B)])

    want = library()
    check(torch.equal(kernel()[0], want),
          "closure_square differs from bf16 bmm at the main shape")
    fns = {"kernel": kernel, "plain": plain, "library": library,
           "int8_library": int8_library}
    try:
        got8 = int8_library()
    except RuntimeError as e:          # a yardstick only: never fatal
        say(f"torch._int_mm is not available here ({e}); int8_library_ms "
            "is null")
        del fns["int8_library"]
    else:
        check(torch.equal(got8, want),
              "torch._int_mm > 0 differs from bf16 bmm at the main shape")
    for fn in fns.values():
        cuda_ms(fn, 3)                                         # warm-up
    samples: dict = {k: [] for k in fns}
    order = list(fns) + list(reversed(fns))
    for _ in range(5):                  # in turns, so drift hits them all
        for key in order:
            samples[key] += cuda_ms(fns[key], 1)
    ms = {k: statistics.median(v) for k, v in samples.items()}
    ops_peak, bw_peak = peaks(name)
    ops = 2 * MAIN_B * MAIN_T ** 3           # multiply-adds
    # m and mT read once, out and outT written once, B changed bytes
    nbytes = 4 * MAIN_B * MAIN_T ** 2 + MAIN_B
    t_ops, t_bytes = ops / ops_peak * 1e3, nbytes / bw_peak * 1e3
    say(f"closure_square B={MAIN_B} T={MAIN_T} median ms: kernel "
        f"{ms['kernel']}, plain (fp32 bmm) {ms['plain']}, library (bf16 "
        f"bmm > 0) {ms['library']}, int8 library (torch._int_mm > 0 per "
        f"history) {ms.get('int8_library')}; bound {max(t_ops, t_bytes)} "
        f"(operations {t_ops}, bytes {t_bytes})")
    return {"name": "closure_square", "route": "cuda",
            "source": "jepsen_tpu_torch/csrc/closure_square.cu",
            "replaces": "jepsen_tpu/checker/elle/pallas_square.py:63",
            "launches": None, "max_abs_err": max_err,
            "ms": ms["kernel"], "plain_ms": ms["plain"],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": ms["library"],
            "int8_library_ms": ms.get("int8_library")}


def sweep(store: Path, checker: str = "append",
          **kw) -> tuple[int, list, float, str]:
    """One in-process analyze-store sweep; its stdout summary lines are
    captured, not printed."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.store import Store

    log: list = []
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.analyze_store(Store(store), checker=checker,
                               bucket_log=log, **kw)
    torch.cuda.synchronize()
    return rc, log, time.perf_counter() - t0, buf.getvalue()


def counted(fn):
    """Run fn() with closure_square's launch count set to 0 and a CUDA
    event pair recorded around each launch; returns (fn's result, the
    launches, their summed device milliseconds)."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs

    cs.closure_square.launches = 0
    cs.closure_square.events = events = []
    try:
        out = fn()
    finally:
        cs.closure_square.events = None
    launches = cs.closure_square.launches
    check(len(events) == launches, "an event pair per launch")
    return out, launches, sum(a.elapsed_time(b) for a, b in events)


def copy_runs(src: Path, dst: Path, runs: list[str]) -> None:
    for run in runs:
        shutil.copytree(src / run, dst / run)


def same_outputs(a: Path, b: Path, runs: list[str]) -> None:
    """results.json/.edn of `runs` byte-identical under test dirs a and
    b, and so are the stores' verdicts.jsonl lines for those runs."""
    for run in runs:
        for f in ("results.json", "results.edn"):
            check((a / run / f).read_bytes() == (b / run / f).read_bytes(),
                  f"{f} of {run} differs between {a} and {b}")
    dirs = {f"{a.name}/{run}" for run in runs}

    def lines(store: Path) -> list[str]:
        return [ln for ln in (store / "verdicts.jsonl").read_text()
                .splitlines() if json.loads(ln)["dir"] in dirs]

    check(len(lines(a.parent)) == len(runs)
          and lines(a.parent) == lines(b.parent),
          f"verdicts.jsonl differs between {a.parent} and {b.parent}")


def phase_main() -> tuple[int, float]:
    """The main path on the card; returns its closure_square launches
    and their summed device milliseconds."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import synth

    t0 = time.perf_counter()
    store, plain_store = WORK / "store", WORK / "store-plain"
    synth.write_synth_run_store(store, B=STORE_RUNS, T=STORE_T, K=STORE_K,
                                bad_every=BAD_EVERY)
    shutil.copytree(store, plain_store)
    say(f"wrote {STORE_RUNS} runs x {2 * STORE_T} ops in "
        f"{time.perf_counter() - t0:.1f}s")

    (rc, log, wall, out), launches, square_ms = counted(
        lambda: sweep(store, device=DEVICE))
    square_s = square_ms / 1e3
    check(rc == 1, f"analyze-store exited {rc}, expected 1 (invalid runs)")
    check(len(out.splitlines()) == STORE_RUNS,
          "expected one summary line per run")
    runs = sorted(p.name for p in (store / "synth").iterdir())
    for h, run in enumerate(runs):
        res = json.loads((store / "synth" / run / "results.json").read_text())
        if h % BAD_EVERY == BAD_EVERY - 1:
            check(res["valid?"] is False and "G1c" in res["anomaly-types"],
                  f"{run} should be invalid with G1c: {res}")
        else:
            check(res["valid?"] is True and res["anomaly-types"] == [],
                  f"{run} should be valid: {res}")
    rounds = [b["closure_rounds"] for b in log]
    check(launches == sum(map(sum, rounds)) and launches > 0,
          f"{launches} kernel launches for {rounds} closure rounds")
    say(f"main path ({DEVICE}, hand kernel): {wall:.3f}s wall, "
        f"{STORE_RUNS / wall:.3f} histories/s, "
        f"{sum(b['seconds'] for b in log):.3f}s of it in bucket checks "
        f"(pack, copy, kernels, flags; the rest is load + encode), "
        f"{len(log)} buckets of "
        f"{[b['histories'] for b in log]} at T_pad "
        f"{sorted({b['t_pad'] for b in log})}, closure rounds per bucket "
        f"{rounds}, {launches} closure_square launches taking "
        f"{square_s:.6f}s of device time (CUDA event pairs)")

    (rc_p, log_p, wall_p, _), relaunched, _ = counted(
        lambda: sweep(plain_store, device=DEVICE,
                      square=cs.closure_square_ref))
    check(rc_p == rc, f"plain-squaring sweep exited {rc_p}")
    check(relaunched == 0, "the plain-squaring sweep launched the kernel")
    same_outputs(store / "synth", plain_store / "synth", runs)
    say(f"plain-squaring sweep: {wall_p:.3f}s wall, "
        f"{sum(b['seconds'] for b in log_p):.3f}s in bucket checks; "
        "results.json, results.edn and verdicts.jsonl byte-identical")
    return launches, square_ms


def phase_cli() -> None:
    """The installed entry point on the card, against a CPU run."""
    from jepsen_tpu_torch.checker.elle import synth

    gpu, cpu = WORK / "small-cuda", WORK / "small-cpu"
    for s in (gpu, cpu):
        synth.write_synth_run_store(s, B=8, T=300, K=16, bad_every=4)
    proc = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.cli", "analyze-store",
         "--store", str(gpu), "--checker", "append", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 1,
          f"cli exited {proc.returncode}: {proc.stderr[-3000:]}")
    rc, _, _, _ = sweep(cpu, device="cpu")
    check(rc == 1, f"cpu sweep exited {rc}")
    same_outputs(gpu / "synth", cpu / "synth",
                 sorted(p.name for p in (gpu / "synth").iterdir()))
    say("python -m jepsen_tpu_torch.cli --device cuda == --device cpu "
        "(byte-identical)")


def phase_wr() -> tuple[int, float]:
    """`analyze-store --checker wr` on the card; returns its
    closure_square launches and their summed device milliseconds."""
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import synth

    t0 = time.perf_counter()
    store, plain_store = WORK / "wr", WORK / "wr-plain"
    synth.write_wr_run_store(store, B=WR_RUNS, T=WR_T, K=WR_K,
                             bad_every=WR_BAD_EVERY)
    runs = sorted(p.name for p in (store / "wr").iterdir())
    copy_runs(store / "wr", plain_store / "wr", runs[:WR_PLAIN])
    say(f"wrote {WR_RUNS} rw-register runs x {2 * WR_T} ops in "
        f"{time.perf_counter() - t0:.1f}s")

    (rc, log, wall, out), launches, square_ms = counted(
        lambda: sweep(store, checker="wr", device=DEVICE))
    check(rc == 1, f"wr analyze-store exited {rc}, expected 1")
    check(len(out.splitlines()) == WR_RUNS,
          "expected one summary line per run")
    for h, run in enumerate(runs):
        res = json.loads((store / "wr" / run / "results.json").read_text())
        if h % WR_BAD_EVERY == WR_BAD_EVERY - 1:
            check(res["valid?"] is False
                  and res["anomaly-types"] == ["G2-item"],
                  f"{run} should be invalid with G2-item: {res}")
        else:
            check(res["valid?"] is True and res["anomaly-types"] == [],
                  f"{run} should be valid: {res}")
    rounds = [b["closure_rounds"] for b in log]
    check(launches == sum(map(sum, rounds)) and launches > 0,
          f"{launches} kernel launches for {rounds} closure rounds")
    say(f"wr path ({DEVICE}, hand kernel): {wall:.3f}s wall, "
        f"{WR_RUNS / wall:.3f} histories/s, "
        f"{sum(b['seconds'] for b in log):.3f}s of it in bucket checks "
        f"(pack, copy, scatter, kernels, flags), {len(log)} buckets of "
        f"{[b['histories'] for b in log]} at T_pad "
        f"{[b['t_pad'] for b in log]}, closure rounds per bucket "
        f"{rounds}, {launches} closure_square launches taking "
        f"{square_ms / 1e3:.6f}s of device time (CUDA event pairs)")

    (rc_p, log_p, wall_p, _), relaunched, _ = counted(
        lambda: sweep(plain_store, checker="wr", device=DEVICE,
                      square=cs.closure_square_ref))
    check(rc_p == 1, f"plain-squaring wr sweep exited {rc_p}")
    check(relaunched == 0, "the plain-squaring sweep launched the kernel")
    same_outputs(store / "wr", plain_store / "wr", runs[:WR_PLAIN])
    say(f"plain-squaring wr sweep of {WR_PLAIN} runs: {wall_p:.3f}s wall, "
        f"{sum(b['seconds'] for b in log_p):.3f}s in bucket checks; "
        "byte-identical")
    return launches, square_ms


def phase_long() -> tuple[int, float]:
    """Long list-append runs on the card through SCC condensation;
    returns the closure_square launches and their summed device
    milliseconds."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.elle import condense, kernels, synth

    t0 = time.perf_counter()
    store, plain_store = WORK / "long", WORK / "long-plain"
    synth.write_long_append_store(store, T=LONG_T, K=LONG_K,
                                  future_gap=LONG_GAP)
    runs = sorted(p.name for p in (store / "long").iterdir())
    kinds = dict(zip(runs, synth.LONG_RUN_KINDS))
    cyclic = [r for r in runs if LONG_EXPECT[kinds[r]]]
    copy_runs(store / "long", plain_store / "long", cyclic)
    say(f"wrote {len(runs)} list-append runs x {2 * LONG_T} ops in "
        f"{time.perf_counter() - t0:.1f}s")
    check(LONG_T > parallel.DENSE_TXN_LIMIT, "long runs must be condensed")

    clog: list = []
    (rc, log, wall, _), launches, square_ms = counted(
        lambda: sweep(store, device=DEVICE, condense_log=clog))
    check(rc == 1, f"long analyze-store exited {rc}, expected 1")
    for run in runs:
        res = json.loads((store / "long" / run / "results.json")
                         .read_text())
        want = LONG_EXPECT[kinds[run]]
        check(res["valid?"] is (not want) and res["anomaly-types"] == want,
              f"{run} ({kinds[run]}) should come out {want}: "
              f"{res['valid?']} {res['anomaly-types']}")
    check(len(clog) == len(runs), f"{len(clog)} condensed histories")
    by_kind = dict(zip(synth.LONG_RUN_KINDS, clog))
    check(by_kind["valid"]["scc_sizes"] == []
          and by_kind["valid"]["closure_rounds"] == 0,
          f"the valid run found an SCC or launched: {by_kind['valid']}")
    check(by_kind["pair"]["scc_sizes"] == [2],
          f"the pair run's SCCs: {by_kind['pair']['scc_sizes']}")
    fut = by_kind["future"]
    check(len(fut["scc_sizes"]) == 1
          and LONG_GAP // 8 < fut["scc_sizes"][0]
          and fut["scc_sizes"][0] <= condense.DEVICE_SCC_LIMIT
          and fut["t_pads"] == [kernels.pad_to(fut["scc_sizes"][0], 128)]
          and fut["closure_rounds"] > 0,
          f"the future run's SCC was not classified on the card: {fut}")
    for kind, rec in by_kind.items():
        if rec["host_scc_sizes"]:
            say(f"long {kind}: SCCs of {rec['host_scc_sizes']} txns went "
                f"to the host classifier (> {condense.DEVICE_SCC_LIMIT})")
    rounds = [b["closure_rounds"] for b in log]
    check(launches == sum(map(sum, rounds)) and launches > 0,
          f"{launches} kernel launches for {rounds} closure rounds")
    say(f"long path ({DEVICE}, hand kernel): {wall:.3f}s wall, "
        f"{len(runs) / wall:.3f} histories/s; condensation (edge build + "
        f"SCCs) {sum(r['condense_seconds'] for r in clog):.6f}s, "
        f"classification {sum(r['classify_seconds'] for r in clog):.6f}s "
        f"of which {sum(b['seconds'] for b in log):.6f}s in device "
        f"buckets and {square_ms / 1e3:.6f}s closure_square device time "
        f"(CUDA event pairs); the rest is load + encode. SCC sizes "
        + ", ".join(f"{k} {r['scc_sizes']} (T_pad {r['t_pads']}, "
                    f"{r['closure_rounds']} rounds)"
                    for k, r in by_kind.items())
        + f"; {launches} closure_square launches")

    (rc_p, _, wall_p, _), relaunched, _ = counted(
        lambda: sweep(plain_store, device=DEVICE,
                      square=cs.closure_square_ref))
    check(rc_p == 1, f"plain-squaring long sweep exited {rc_p}")
    check(relaunched == 0, "the plain-squaring sweep launched the kernel")
    same_outputs(store / "long", plain_store / "long", cyclic)
    say(f"plain-squaring long sweep of {cyclic}: {wall_p:.3f}s wall; "
        "byte-identical")
    return launches, square_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not (ROOT / "jepsen_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no jepsen_tpu_torch checkout beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from jepsen_tpu_torch import _build

    t_start = time.perf_counter()
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    say(f"device {name} ({smi}); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    libs = _build.build_all()
    say(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for lib in libs:
        print(_build.build_log(lib).strip(), flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    try:
        record = phase_kernels(name)
        paths = {}
        paths["append"] = phase_main()
        phase_cli()
        paths["wr"] = phase_wr()
        paths["long"] = phase_long()
        record["launches"] = sum(n for n, _ in paths.values())
        record["paths"] = {k: {"launches": n, "device_ms": ms}
                           for k, (n, ms) in paths.items()}
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [record]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
