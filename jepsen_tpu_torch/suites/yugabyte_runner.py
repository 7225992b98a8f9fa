"""YugabyteDB CI sweep runner.

Counterpart of yugabyte/run-jepsen.py (the reference's python2 CI
orchestrator): sweep workload x nemesis x api combinations, each test
in its own subprocess with a hard wall-clock timeout (a wedged cluster
must not wedge the sweep), keep going on failures, and print a summary
whose exit code is the worst outcome seen.

    python -m jepsen_tpu_torch.suites.yugabyte_runner \
        --workloads bank,set --nemeses none,partition \
        --apis ysql --time-limit 60 --test-timeout 1200

The port's copy of `jepsen_tpu/suites/yugabyte_runner.py`; it imports
the standard library and the port's own modules only, and each test it
spawns is the port's suite (`-m jepsen_tpu_torch.suites.yugabyte`).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def run_one(workload: str, nemesis: str, api: str, args) -> dict:
    """One test in a subprocess; returns {combo, outcome, secs}."""
    cmd = [sys.executable, "-m", "jepsen_tpu_torch.suites.yugabyte",
           "test",
           "--workload", workload, "--api", api,
           "--time-limit", str(args.time_limit),
           "--nemesis", nemesis]
    for n in args.nodes.split(","):
        cmd += ["-n", n]
    if args.extra:
        cmd += args.extra.split()
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, timeout=args.test_timeout)
        outcome = {0: "valid", 1: "invalid"}.get(proc.returncode,
                                                 "error")
    except subprocess.TimeoutExpired:
        outcome = "timeout"
    return {"workload": workload, "nemesis": nemesis, "api": api,
            "outcome": outcome, "secs": round(time.time() - t0, 1)}


def main(argv=None) -> int:
    from . import yugabyte

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workloads", default=None,
                   help="comma list (default: the per-API matrix)")
    p.add_argument("--nemeses", default="none,partition",
                   help=f"comma list from {sorted(yugabyte.NEMESES)}")
    p.add_argument("--apis", default="ysql,ycql")
    p.add_argument("--nodes", default="n1,n2,n3,n4,n5")
    p.add_argument("--time-limit", type=int, default=60)
    p.add_argument("--test-timeout", type=int, default=1200,
                   help="hard per-test wall clock (run-jepsen.py's "
                        "TEST_TIMEOUT)")
    p.add_argument("--extra", default=None,
                   help="extra args passed through to each test")
    args = p.parse_args(argv)

    results = []
    for api in args.apis.split(","):
        workloads = (args.workloads.split(",") if args.workloads
                     else sorted(yugabyte.workloads(api=api)))
        for w in workloads:
            for nem in args.nemeses.split(","):
                print(f"=== {api} {w} nemesis={nem}", flush=True)
                results.append(run_one(w, nem, api, args))
                print(f"--- {results[-1]}", flush=True)

    print("\n== sweep summary ==")
    worst = 0
    for r in results:
        print(f"  {r['api']:5s} {r['workload']:12s} "
              f"{r['nemesis']:16s} {r['outcome']:8s} {r['secs']}s")
        worst = max(worst, {"valid": 0, "invalid": 1,
                            "timeout": 2, "error": 2}[r["outcome"]])
    return worst


if __name__ == "__main__":
    sys.exit(main())
