"""`python -m jepsen_tpu_torch.obs.smoke [--device cuda|cpu]` — the port's one-command live-telemetry smoke, the
counterpart of the reference's `make obs-smoke`.

Builds a tiny throwaway store with the port's own synth, runs a real POOLED `analyze-store`
sweep (JEPSEN_TPU_PIPELINE=1 forces the worker pool even on 1-core
boxes) with the health sampler, the `/metrics` endpoint and the
attribution report force-enabled (interval 0.2 s, ephemeral port),
scrapes `/metrics` and `/healthz` once mid-flight via a hook, and
asserts the contract the acceptance criteria pin: health.json
snapshots exist and parse, the scraped counters match the final
metrics.json, the flight recorder holds the sweep's start/end events,
the merged trace.json carries at least one worker-process track with
encode spans, and report.json exists with stage shares summing to
~1.0. Exit 0 on success, 1 with a reason on any violation; a few
seconds end to end on the CPU.

The sweep is the port's CLI body, `cli.analyze_store`, run in this
process on `--device` (default cuda, where it launches
`closure_square`; `cpu` only when asked): the mid-flight scrape needs
its `obs_hook`, as the reference's smoke does. The costdb contract is
the port's own provenance tag: on a card every record is `measured`
(its windows are CUDA-event pairs), on the CPU `estimated`.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import urllib.request
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.obs.smoke")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    from .. import cli, gates, trace
    from ..checker.elle.synth import synth_append_history
    from ..store import Store

    gates.export("JEPSEN_TPU_HEALTH_INTERVAL_S", 0.2)
    gates.export("JEPSEN_TPU_METRICS_PORT", 0)    # ephemeral
    # a REAL pooled sweep, even on a 1-core box: the trace-fabric
    # assertions below need actual worker processes spooling spans
    gates.export("JEPSEN_TPU_PIPELINE", 1)
    # the device cost observatory: the assertions below pin the
    # residency gauges on /metrics + health.json, the report's device
    # section and the costdb contract
    gates.export("JEPSEN_TPU_COSTDB", 1)
    # kernel search telemetry: the assertions below pin the analytics
    # ledger, the report "search" section, and the kernel.* series on
    # a live sweep
    gates.export("JEPSEN_TPU_KERNEL_STATS", 1)

    root = Path(tempfile.mkdtemp(prefix="obs-smoke-"))
    try:
        store = Store(root / "store")
        for i in range(3):
            d = store.base / "smoke" / f"2020010{i + 1}T000000"
            d.mkdir(parents=True)
            hist = synth_append_history(T=40, K=4, seed=i)
            (d / "history.jsonl").write_text(
                "\n".join(json.dumps(o) for o in hist) + "\n")

        scraped: dict = {}

        def on_obs_up(server, sampler):
            """Mid-sweep scrape hook: the endpoint is live, the
            sampler has written its first snapshot."""
            base = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=10) as r:
                scraped["metrics"] = r.read().decode()
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=10) as r:
                scraped["healthz"] = json.loads(r.read().decode())

        rc = cli.analyze_store(store, checker="append",
                               device=args.device, obs_hook=on_obs_up,
                               report=True)
        if rc != 0:
            print(f"obs-smoke: sweep failed rc={rc}")
            return 1
        if "metrics" not in scraped:
            print("obs-smoke: endpoint never scraped")
            return 1
        health = json.loads((store.base / "health.json").read_text())
        if health["heartbeat"]["seq"] < 1 \
                or health["progress"]["runs_total"] != 3 \
                or health["progress"]["runs_verdicted"] != 3:
            print(f"obs-smoke: bad final health snapshot: {health}")
            return 1
        if scraped["healthz"].get("v") != 1:
            print(f"obs-smoke: bad /healthz: {scraped['healthz']}")
            return 1
        if "jepsen_tpu_shm_stale_reclaimed " not in scraped["metrics"]:
            print("obs-smoke: mid-flight /metrics page malformed:\n"
                  + scraped["metrics"])
            return 1
        # exposition↔metrics.json parity: rendering the sweep tracer
        # now (it is still current) must carry every final counter at
        # its final value — the mid-flight page is the same renderer
        # over earlier state
        from .prom import _name, render_prometheus
        page_lines = render_prometheus(
            trace.get_current()).splitlines()
        final = json.loads((store.base / "metrics.json").read_text())
        for name, v in final["counters"].items():
            want = f"{_name(name)} {v}"
            # whole-line match: a renderer bug that extends the value
            # by a digit must not pass a prefix check
            if want not in page_lines:
                print(f"obs-smoke: {want!r} not in /metrics render")
                return 1
        for name in ("buckets_dispatched", "buckets_resolved",
                     "runs_verdicted"):
            if name not in final["counters"]:
                print(f"obs-smoke: counter {name} missing from "
                      "metrics.json")
                return 1
        from .events import load_events
        evs = [e["event"] for e in load_events(store.base)]
        if "sweep_start" not in evs or "sweep_end" not in evs:
            print(f"obs-smoke: flight recorder incomplete: {evs}")
            return 1
        # -- trace fabric + attribution report contract ---------------
        if not trace.iter_spools(store.base):
            print("obs-smoke: pooled sweep left no worker trace "
                  "spools")
            return 1
        tj = json.loads((store.base / "trace.json").read_text())
        worker_pids = {e["pid"] for e in tj["traceEvents"]
                       if e.get("ph") == "M"
                       and e.get("name") == "process_name"
                       and "worker" in str(e["args"].get("name", ""))}
        if not worker_pids:
            print("obs-smoke: merged trace has no worker-process "
                  "track")
            return 1
        if not any(e.get("ph") == "X" and e.get("name") == "encode"
                   and e.get("pid") in worker_pids
                   for e in tj["traceEvents"]):
            print("obs-smoke: no encode span on any worker track")
            return 1
        rep = json.loads((store.base / "report.json").read_text())
        share_sum = sum(rep["shares"].values())
        if abs(share_sum - 1.0) > 0.02:
            print(f"obs-smoke: report shares sum to {share_sum:.4f}, "
                  "not 1.0 +/- 0.02")
            return 1
        if not (store.base / "report.md").is_file():
            print("obs-smoke: report.md missing")
            return 1
        if final["counters"].get("worker_spans", 0) < 1:
            print("obs-smoke: worker_spans digest never reached the "
                  "parent tracer")
            return 1
        # -- device cost observatory contract --------------------------
        for gname in ("jepsen_tpu_resident_executables",
                      "jepsen_tpu_hbm_modeled_bytes"):
            if not any(ln.startswith(gname + " ")
                       for ln in page_lines):
                print(f"obs-smoke: residency gauge {gname} missing "
                      "from /metrics render")
                return 1
        dev = health.get("device") or {}
        if not isinstance(dev.get("resident_executables"), int):
            print(f"obs-smoke: health.json device section missing "
                  f"residency gauges: {dev}")
            return 1
        from ..store import load_costdb
        cost_recs = load_costdb(store.base)
        if not cost_recs:
            print("obs-smoke: no costdb.jsonl records despite "
                  "JEPSEN_TPU_COSTDB=1")
            return 1
        want_tag = "measured" if args.device == "cuda" else "estimated"
        if any(r.get("provenance") != want_tag for r in cost_recs):
            print(f"obs-smoke: costdb provenance is not {want_tag!r} "
                  f"on {args.device}: {cost_recs[:1]}")
            return 1
        if "device" not in rep or not rep["device"].get("records"):
            print("obs-smoke: report.json has no device section")
            return 1
        if "Device roofline" not in \
                (store.base / "report.md").read_text():
            print("obs-smoke: report.md has no device roofline "
                  "section")
            return 1
        # -- kernel search telemetry contract --------------------------
        from ..store import load_analytics
        stats_recs = load_analytics(store.base)
        if len(stats_recs) != 3:
            print(f"obs-smoke: analytics.jsonl has {len(stats_recs)} "
                  "record(s), expected 3 (one per run)")
            return 1
        if any("margin" not in r or "closure_rounds" not in r
               for r in stats_recs):
            print(f"obs-smoke: analytics record missing stat fields: "
                  f"{stats_recs[:1]}")
            return 1
        if "search" not in rep or rep["search"].get("histories") != 3:
            print(f"obs-smoke: report.json search section missing or "
                  f"wrong: {rep.get('search')}")
            return 1
        if "Search telemetry" not in \
                (store.base / "report.md").read_text():
            print("obs-smoke: report.md has no search section")
            return 1
        if not any(ln.startswith("jepsen_tpu_kernel_stats_records ")
                   for ln in page_lines):
            print("obs-smoke: kernel.stats_records missing from "
                  "/metrics render")
            return 1
        print("obs-smoke: OK — health.json "
              f"(seq {health['heartbeat']['seq']}), /metrics scraped "
              f"({len(scraped['metrics'].splitlines())} lines), "
              f"{len(evs)} flight-recorder events, "
              f"{len(worker_pids)} worker track(s), report bound="
              f"{rep.get('bound')}, costdb {len(cost_recs)} "
              f"record(s) [{cost_recs[0]['provenance']}]")
        return 0
    finally:
        trace.reset()
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
