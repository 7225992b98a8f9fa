"""`python -m jepsen_tpu_torch.warm_bench [--device cuda|cpu]` — the
port's copy-free warm-path gate, the counterpart of the reference's
`make bench-warm`.

Runs the smoke-shape cold → warm → warm-again sequence, each sweep in
its OWN process (`python -m jepsen_tpu_torch.warm_bench --child STORE
--device D`; default cuda, where it launches `closure_square`) over a
shared store, and fails (exit 1) unless the third run proves the warm
path is actually copy-free:

  * `warm_copy_bytes == 0` — every bucket copied to the device straight
    from the v2 sidecar's mapped views, no host-side pack copies;
  * `cache_misses == 0` — every history hit its sidecar, nothing was
    encoded again;
  * verdicts byte-identical across all three runs (the parity floor —
    a fast wrong answer is not a win).

The reference also gates `compile_cache_misses == 0` (its persistent
AOT executable cache); the port has no AOT cache (`_build`'s keyed
`.so` cache stands in for it), so that check has no counterpart here.
Separate processes are the point: the warm runs start with empty
in-memory state, so their hits can only come from the sidecars on
disk. One JSON line per run and one summary line out (BENCH_WARM_B/T/K
scale the shape).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def _write_store(root: Path, B: int, T: int, K: int) -> list[Path]:
    """B serial list-append run dirs (the bench's north-star execution
    shape via the SHARED generator, scaled to smoke size), the last
    one seeded with a G1c cycle so the classify path runs too."""
    from .checker.elle.synth import write_synth_store
    return write_synth_store(root, B, T, K, bad_every=B)


def _child(store_dir: str, device: str) -> int:
    """One sweep over the store on `device`; prints counters + a
    verdict digest."""
    import time

    from . import ingest, parallel, trace
    from .devices import resolve_device

    dev = resolve_device(device)
    tr = trace.fresh_run("warm-bench")

    def ctr(name: str) -> int:
        return getattr(tr.counter(name), "value", 0) or 0

    dirs = sorted(Path(store_dir).iterdir())
    t0 = time.perf_counter()
    encs = [ingest.encode_run_dir(d, "append") for d in dirs]
    t_ingest = time.perf_counter() - t0
    bad = [e for e in encs if isinstance(e, Exception)]
    assert not bad, bad[:1]
    t0 = time.perf_counter()
    verdicts = parallel.check_bucketed(encs, dev)
    t_check = time.perf_counter() - t0
    digest = hashlib.sha256(
        json.dumps([sorted(v) for v in verdicts]).encode()).hexdigest()
    print(json.dumps({
        "ingest_secs": round(t_ingest, 3),
        "check_secs": round(t_check, 3),
        "verdict_digest": digest,
        "invalid": sum(1 for v in verdicts if v),
        "warm_copy_bytes": ctr("warm_copy_bytes"),
        "h2d_bytes": ctr("h2d_bytes"),
        "cache_hits": ctr("cache_hits"),
        "cache_misses": ctr("cache_misses"),
    }))
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":      # --child STORE --device D
        return _child(argv[1], argv[3])
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.warm_bench")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    B = int(os.environ.get("BENCH_WARM_B", 6))
    T = int(os.environ.get("BENCH_WARM_T", 60))
    K = int(os.environ.get("BENCH_WARM_K", 8))
    with tempfile.TemporaryDirectory(prefix="bench-warm-") as td:
        store_dir = Path(td) / "store"
        store_dir.mkdir()
        _write_store(store_dir, B, T, K)
        env = {**os.environ, "JEPSEN_TPU_TRACE": "1"}
        runs = []
        for name in ("cold", "warm", "warm-again"):
            p = subprocess.run(
                [sys.executable, "-m", "jepsen_tpu_torch.warm_bench",
                 "--child", str(store_dir), "--device", args.device],
                capture_output=True, text=True, timeout=600, env=env)
            got = None
            for line in reversed((p.stdout or "").strip().splitlines()):
                try:
                    got = json.loads(line)
                    break
                except json.JSONDecodeError:
                    continue
            if got is None:
                print(f"bench-warm: {name} run produced no JSON "
                      f"(rc={p.returncode}): "
                      + (p.stderr or "")[-300:], file=sys.stderr)
                return 1
            got["run"] = name
            runs.append(got)
            print(json.dumps(got))

        failures = []
        if len({r["verdict_digest"] for r in runs}) != 1:
            failures.append("verdicts differ across cold/warm runs")
        last = runs[-1]
        if last["warm_copy_bytes"] != 0:
            failures.append(
                f"warm-again copied {last['warm_copy_bytes']} host "
                "bytes (want 0: the copy to the device must read the "
                "v2 sidecar's mapped views)")
        for r in runs[1:]:
            if r["cache_misses"] != 0:
                failures.append(
                    f"{r['run']} re-encoded {r['cache_misses']} "
                    "run(s) (want 0: every history hits its sidecar)")
        if failures:
            for f in failures:
                print(f"bench-warm: FAIL: {f}", file=sys.stderr)
            return 1
        print(f"bench-warm: OK — {B}x{T}-txn smoke store on "
              f"{args.device}: warm path copy-free (warm_copy_bytes=0), "
              f"{last['cache_hits']} sidecar hits, 0 re-encodes, "
              "verdicts byte-identical")
        return 0


if __name__ == "__main__":
    sys.exit(main())
