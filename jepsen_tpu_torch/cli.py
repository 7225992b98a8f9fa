"""Command line of the PyTorch port:

    python -m jepsen_tpu_torch.cli test|test-all [--dummy] [--store DIR] \\
        [--concurrency N|Nn] [--test-count N] [--node HOST ...] \\
        [--faults F,...] [--backend auto|tpu|cpu|race] [--[no-]trace] \\
        [--[no-]jax-profile] [--device cuda|cpu]
    python -m jepsen_tpu_torch.cli analyze [RUN_DIR] [--store DIR] \\
        [--backend auto|tpu|cpu|race] [--[no-]trace] [--[no-]jax-profile]
    python -m jepsen_tpu_torch.cli analyze-store --store DIR \\
        [--checker append|wr|register|stored] [--name NAME] [--resume] \\
        [--report] [--mesh] [--backend auto|tpu|cpu|race] [--[no-]trace] \\
        [--[no-]jax-profile] [--device cuda|cpu]
    python -m jepsen_tpu_torch.cli serve --store DIR [--socket PATH] \\
        [--port P] [--host H] [--drain-timeout S] [--fleet-instance K] \\
        [--fleet-epoch E] [--[no-]trace] [--device cuda|cpu]
    python -m jepsen_tpu_torch.cli fleet --store DIR [--daemons N] \\
        [--socket PATH] [--no-stonith] [--[no-]trace] [--device cuda|cpu]

Counterpart of `jepsen_tpu/cli.py`. A suite's main calls
`run_cli(test_fn, ...)`, as the reference's do. `test` runs
`--test-count` tests, each `core.run(test_fn(base_test, args))`: the
generator drives the clients and the nemesis through the interpreter,
the history is stored (`Store.save_1`), then checked by the test map's
checker and the verdict stored, one JSON result line a run, stopping
at the first run that is not valid. `test-all` runs every test map of
`tests_fn(base_test, args)` (default: the one `test_fn` gives), one
line each, a crashed test printed as `{"name", "error"}` with 255; it
exits the worst code. `analyze` re-runs the test map's checker on one
stored run (default: the store's latest) and writes its results, its
checkers' artifacts and the run's `trace.json`/`metrics.json` into the
run dir, printing one JSON line. `python -m jepsen_tpu_torch.cli` is
`run_cli` with the base test map as it is: `test` runs the noop test
(no generator, `unbridled_optimism`), `analyze` a stored test map (no
checker: `valid? true`). A test map's checker built without a device
runs on the card: without one, `test` exits 255. `--device` (test and
test-all) puts `device` into the base test map, which a suite's
checkers that reach a kernel run on (`suites.standard_workloads`), and
`--faults` puts `faults`, which a suite's `suite_test` builds the
combined nemesis bundle from (`nemesis.combined.nemesis_package`).

`--backend` exports `JEPSEN_TPU_BACKEND` for the call (restored when
`run_cli` returns), which every `auto` checker reads
(`devices.resolve_backend`): `tpu` and `auto` the device path, `cpu`
the host oracles, `race` both at once for linearizability.

`serve` runs the verdict daemon (`serve.daemon`): tenants stream
histories over `<store>/serve.sock` (or TCP with `--port`) and get
verdicts back, journaled per tenant; it prints one ready line and exits
0 when SIGTERM's drain ends. `fleet` runs N such daemons behind a router
(`serve.fleet`). Both run on `--device` (default cuda) and exit 255
without it; `serve` also exits 255 when a fold meets a device or kernel
failure. `serve --web` serves the store browser (`web.py`: the run
table, per-run listings, zip export) instead, on `--host` (default
0.0.0.0) and `--port` (default 8080), until it is interrupted.

`analyze-store`, the batch path: every stored run
(with `--name`, every run of that test name) is checked, and each
verdict lands as the reference writes it — `results.edn`,
`results.json` (atomic), the `.sweep-<checker>` resume marker, one
`verdicts.jsonl` line and one JSON summary line on stdout.

- `append` (list-append): runs up to `parallel.DENSE_TXN_LIMIT` txns
  are length-bucketed through the dense closure; longer ones follow,
  one at a time, through SCC condensation (`parallel.check_long_history`).
- `wr` (rw-register): host-built dependency edges, length-bucketed
  through the same device classification
  (`kernels.check_edge_batch_bucketed`, which dispatches through
  `parallel.check_bucketed_async` one bucket at a time).
- `register` (per-key CAS-register linearizability): every run's values
  are re-lifted to `[k v]` and split per key in one pass, and every key
  of every run goes down in one `Linearizable.check_batch` (dense grid
  -> bounded frontier -> CPU WGL); verdicts regroup per run.
- `stored`: every run through its own stored checker (`core.analyze`:
  a stored test map holds no checker, so the verdict is `valid? true`
  unless the run cannot be loaded or saved).

Ingest is pooled, as the reference's: `append` and `wr` runs are
encoded in spawned workers (`ingest.iter_encode_chunks`) while the
parent checks the previous chunk, one worker per core on the card (the
CPU leaves the choice to ingest: more than one core, or
`JEPSEN_TPU_PIPELINE`); `register` loads its runs through the same
pool (`ingest.parallel_load`). Each worker spools its spans to
`<store>/trace-<pid>.jsonl`, folded into `trace.json` at the end; a
sweep starts by clearing stale spools and reclaiming shared-memory
segments of dead sweeps (`shm.reclaim_stale`, the
`shm_stale_reclaimed` counter).

A run the device path cannot take goes to the stored checker too, as in
the reference: for `append` and `wr` a run that is not encodable or has
no txn ops (after the dense and the long runs), for `register` a run
that cannot be loaded, is not register-shaped, or looks lifted but was
declined by relift (in run order). A stored check that raises is
quarantined (`valid? unknown`) without overwriting an existing
results.json.

`--resume` skips every run this checker already verdicted — its
`.sweep-<checker>` marker, a results.json naming the checker, or a
`verdicts.jsonl` line — and counts their recorded validity toward the
exit code.

`--mesh` (or `JEPSEN_TPU_MESH=1`) sweeps one shard of a mesh sweep
(`mesh`): the shard `JEPSEN_TPU_MESH_SHARD` of `JEPSEN_TPU_MESH_SHARDS`,
journaled to `verdicts-<shard>.jsonl`, with the shard's telemetry in
per-shard files and `.shard-<k>.done` last; shard 0 then merges the
fleet and prints one `{"mesh": true, ...}` summary line. Shards may run
at once on one card, each in its own process. A lost, crashed or
incompletely journaled shard makes the merged exit code at least 2.
With a coordinator address (`JAX_COORDINATOR_ADDRESS` or
`COORDINATOR_ADDRESS`, with `JAX_NUM_PROCESSES` and `JAX_PROCESS_ID`)
and no `JEPSEN_TPU_MESH_SHARDS`, a `--mesh` shard joins the job (a
`torch.distributed` gloo group) and takes its rank and size as its
shard; a join that fails exits 255. A sweep without `--mesh` joins no
job: a process holds only its own cards, so a joined job spreads a
sweep through `--mesh` alone.

`--backend cpu` sweeps append and wr runs through the host oracles
(`cycle_anomalies_cpu`: witness cycles where the device path records
flags) and register runs through the CPU WGL engine, with no launch
and no device; `race` reaches the register sweep's
`Linearizable.check_batch`.

Exit codes, as the reference's: 0 every run valid, 1 some run invalid,
2 validity unknown, 254 usage error (or no stored runs), 255 crash or
no CUDA device. Every checker resolves the device first, `stored`
included, unless `--backend cpu` is given.

What goes wrong is quarantined as the reference's supervisor does
(`supervisor`): the run gets `valid? unknown` with its cause and
stage, and the sweep goes on. An encode fault injected by the
self-nemesis (`JEPSEN_TPU_FAULT_INJECT`) quarantines its run at once
(stage `encode`), without the stored-checker detour; the append sweep's
dispatcher (`parallel.check_bucketed_async`) backs down from an OOM and
quarantines a bucket that outlasts the watchdog
(`JEPSEN_TPU_DISPATCH_TIMEOUT_S`) or fails to pack; a wr chunk backs
down to single histories (`_wr_chunk_with_backdown`); a long
list-append run whose condensed check raises is quarantined alone.
A kernel build or launch failure, a missing device or a CUDA error
still ends the sweep, and `JEPSEN_TPU_STRICT=1` re-raises every
failure instead of quarantining it.

Every sweep runs under a fresh sweep tracer (`trace`) and leaves in the
store what the reference's leaves: `trace.json` (the Chrome timeline:
the "parse", "pack", "h2d", "feed", "dispatch" and "collect" phases,
the device windows, quarantines) and `metrics.json` (counters, gauges,
histograms) unless `JEPSEN_TPU_TRACE=0`, and always `events.jsonl`, the
flight recorder of lifecycle events. `--report` (or
`JEPSEN_TPU_REPORT=1`) adds the attribution report, `report.json` and
`report.md`; `JEPSEN_TPU_KERNEL_STATS=1` adds `analytics.jsonl`, one
search-telemetry record per history; `JEPSEN_TPU_JAX_PROFILE=1` wraps
the sweep in a `torch.profiler` capture (`torch-profile/trace.json`).
Writing them never sinks a sweep: a failure is a logged warning.

The live telemetry and the planner, each behind the reference's gate:
`JEPSEN_TPU_COSTDB=1` appends `costdb.jsonl` (one record per kernel
flags and bucket geometry: the dispatches' counted closure work and
their CUDA-event device seconds, `obs.device`) and gives `--report` its
device roofline section and the search section's cost join;
`JEPSEN_TPU_HEALTH_INTERVAL_S=N` writes `health.json` atomically every
N seconds; `JEPSEN_TPU_METRICS_PORT=P` serves `/metrics` and `/healthz`
during the sweep; `JEPSEN_TPU_PLANNER=1` loads `plan.json`, lets the
planner compose the append sweep's buckets and pick fused or two-pass
classify, and refits `plan.json` at the end. No gate changes a verdict.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Callable

from . import trace
from .devices import BACKENDS
from .store import Store, VerdictJournal

log = logging.getLogger(__name__)

CHECKERS = ("append", "wr", "register", "stored")


def validity_exit_code(results: dict | None) -> int:
    v = (results or {}).get("valid?")
    if v is True:
        return 0
    if v == "unknown" or v is None:
        return 2
    return 1


def _json_safe(v):
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def _verdicted(d, checker: str) -> bool:
    """Did a prior sweep of THIS checker fully verdict this run? Every
    completed verdict leaves an additive `.sweep-<checker>` sidecar
    (so alternating sweeps never erase each other's progress); a
    parseable results.json naming the checker counts too."""
    if (d / f".sweep-{checker}").exists():
        return True
    p = d / "results.json"
    if not p.exists() or checker == "stored":
        return False  # stored sweeps mark ONLY via the sidecar: the
        #               run's own results.json predates the sweep
    try:
        return json.loads(p.read_text()).get("checker") == checker
    except (OSError, json.JSONDecodeError):
        return False  # truncated marker: redo the run


def _prior_code(d, checker: str) -> int:
    """Exit-code contribution of an already-verdicted (skipped) run.
    THIS sweep's sidecar is consulted first: results.json is whichever
    checker wrote it last, and stored-fallback runs may never write
    one. Legacy empty sidecars fall through to results.json."""
    try:
        return validity_exit_code(
            json.loads((d / f".sweep-{checker}").read_text()))
    except (OSError, json.JSONDecodeError, ValueError):
        pass
    try:
        return validity_exit_code(
            json.loads((d / "results.json").read_text()))
    except (OSError, json.JSONDecodeError):
        return 0  # legacy empty sidecar: validity was reported when run


def _write_results(d, res: dict, checker: str, journal=None,
                   persist: bool = True) -> int:
    """Persist results.json/.edn into a run dir, mark it verdicted for
    this checker, journal it and print the one-line summary; returns the
    validity exit code. results.json lands via a per-process temp file
    and an atomic rename. persist=False skips the results.json/.edn
    write (marker, journal and summary only), so a failed stored check
    cannot overwrite a run's recorded results."""
    from . import edn
    from .store import _results_to_edn
    if persist:
        safe = _json_safe(res)
        (d / "results.edn").write_text(edn.dumps(_results_to_edn(safe))
                                       + "\n")
        tmp = d / f"results.json.tmp.{os.getpid()}"
        tmp.write_text(json.dumps(safe, indent=2))
        os.replace(tmp, d / "results.json")
    (d / f".sweep-{checker}").write_text(
        json.dumps({"valid?": res.get("valid?")}))
    if journal is not None:
        journal.record(d, checker, res)
    trace.get_current().counter("runs_verdicted").inc()
    line = {"dir": str(d), "valid?": res.get("valid?")}
    if "anomaly-types" in res:
        line["anomalies"] = res.get("anomaly-types", [])
    if "failures" in res:
        line["failures"] = res["failures"]
    if "quarantined" in res:
        line["quarantined"] = res["quarantined"]
        line["error"] = res.get("error")
    print(json.dumps(line))
    return validity_exit_code(res)


def _quarantine_run(d, err, stage: str, checker: str, journal=None,
                    persist: bool = True) -> int:
    """Record a run the sweep abandoned as a `valid? unknown` verdict —
    never a false verdict, never a dead sweep — persisting the cause for
    triage and journaling it, with a "quarantine" span, the
    `quarantined` counter and a `quarantine` event. JEPSEN_TPU_STRICT=1
    re-raises instead (fail-fast)."""
    from . import supervisor
    from .obs import events
    if supervisor.strict_enabled():
        if isinstance(err, BaseException):
            raise err
        raise RuntimeError(str(err))
    tr = trace.get_current()
    with tr.span("quarantine", stage=stage):
        tr.counter("quarantined").inc()
    events.emit("quarantine", stage=stage, run=str(d),
                cause=str(err)[:300])
    log.warning("quarantining %s (%s): %s", d, stage, err)
    return _write_results(d, supervisor.quarantine_verdict(err, stage,
                                                           checker),
                          checker, journal=journal, persist=persist)


def _stored_fallback(d, stored_check, checker: str, journal=None) -> int:
    """Run a dir through its own stored checker, quarantining (an
    `unknown` verdict, never an exception, never a dead sweep) on
    failure. A success leaves the `.sweep-<checker>` marker with its
    validity, so --resume counts the run done for that sweep."""
    try:
        res = stored_check(d)
    except Exception as e:
        # never clobber an existing results.json: the stored path's
        # success leaves it to core.analyze, and a failure must not
        # replace a recorded verdict with an unknown. A run dir without
        # one records the quarantine so triage has something to read.
        return _quarantine_run(
            d, e, "stored", checker, journal=journal,
            persist=not (d / "results.json").exists())
    print(json.dumps({"dir": str(d), "valid?": res.get("valid?")}))
    trace.get_current().counter("runs_verdicted").inc()
    (d / f".sweep-{checker}").write_text(
        json.dumps({"valid?": res.get("valid?")}))
    if journal is not None:
        journal.record(d, checker, res)
    return validity_exit_code(res)


def _register_sweep(run_dirs: list, dev, emit, stored,
                    dense_scan=None, register_log: dict | None = None,
                    record=None) -> None:
    """Per-key CAS-register linearizability over every run: each key's
    subhistory from every run goes down in one tiered `check_batch`,
    then verdicts regroup per run and `emit` writes them, in run order.
    If the batch raises (a malformed run), each key is re-checked alone
    and a key that raises again gets `{"valid?": "unknown", "error"}` —
    except a build or device failure, which is no run's fault and
    propagates. A run that cannot be loaded, is not register-shaped or
    looks lifted but was declined by relift goes to `stored(d)`, the
    stored checker, in its place in run order. With `record` (the
    kernel-stats path), each emitted run's search record,
    `_register_run_stats` over its keys, goes to `record(d, stats,
    failures)`; the isolation re-checks run without stats."""
    from . import _build, independent, ingest
    from .checker import linearizable, merge_valid, models
    from .devices import DeviceUnavailable

    c = linearizable(models.cas_register(), device=dev,
                     dense_scan=dense_scan)
    t0 = time.perf_counter()
    hists = ingest.parallel_load(run_dirs)
    t1 = time.perf_counter()
    subs: list[list] = []          # flattened subhistories
    owners: list[tuple[int, object]] = []   # (run index, key)
    fallback: set[int] = set()
    for i, (d, hist) in enumerate(zip(run_dirs, hists)):
        if isinstance(hist, Exception):
            fallback.add(i)
            continue
        hist = independent.relift_history(hist)
        client_fs = {o.get("f") for o in hist
                     if o.get("process") != "nemesis"
                     and o.get("f") is not None}
        if not client_fs or not client_fs <= {"read", "write", "cas"}:
            fallback.add(i)
            continue
        by_key = independent.subhistories(hist)   # one pass, all keys
        ks = list(by_key)
        # a plain cas value is [old new] (scalars); a LIFTED cas value
        # is [key [old new]] — second element a list marks it lifted
        if not ks and any(
                isinstance(o.get("value"), (list, tuple))
                and len(o["value"]) == 2
                and (o.get("f") != "cas"
                     or isinstance(o["value"][1], (list, tuple)))
                for o in hist if o.get("process") != "nemesis"):
            # looks lifted ([k v] values) but relift declined (e.g. no
            # ok read survived the faults): checking it as ONE register
            # would feed the oracle [key value] pairs
            fallback.add(i)
            continue
        for k in (ks or [None]):
            subs.append(by_key[k] if ks else hist)
            owners.append((i, k))
    t2 = time.perf_counter()
    tiers: list = []
    ksouts: list | None = [] if record is not None else None
    try:
        results = c.check_batch({}, subs, {}, tier_log=tiers,
                                stats_out=ksouts) if subs else []
    except (_build.KernelBuildError, _build.KernelLaunchError,
            DeviceUnavailable):
        raise
    except Exception:
        # one malformed run must not sink the sweep: re-dispatch each
        # subhistory in isolation, degrading only the broken ones
        log.warning("batched register sweep failed; isolating per key",
                    exc_info=True)
        results = []
        ksouts = None
        for s in subs:
            try:
                results.append(c.check_batch({}, [s], {})[0])
            except (_build.KernelBuildError, _build.KernelLaunchError,
                    DeviceUnavailable):
                raise
            except Exception as e:
                results.append({"valid?": "unknown",
                                "error": repr(e)[:200]})
    t3 = time.perf_counter()
    if register_log is not None:
        register_log.update(load_s=t1 - t0, split_s=t2 - t1,
                            check_s=t3 - t2, keys=len(subs), tiers=tiers)
    per_run: dict[int, dict] = {}
    per_run_stats: dict[int, list] = {}
    for j, ((i, k), res) in enumerate(zip(owners, results)):
        per_run.setdefault(i, {})[k] = res
        if ksouts is not None:
            per_run_stats.setdefault(i, []).append(
                (k, len(subs[j]), ksouts[j]))
    for i, d in enumerate(run_dirs):
        if i in fallback:
            stored(d)
            continue
        keyed = per_run.get(i, {})
        failures = sorted(str(k) for k, r in keyed.items()
                          if r.get("valid?") is False)
        emit(d, {"valid?": merge_valid([r.get("valid?", True)
                                        for r in keyed.values()] or [True]),
                 "checker": "register",       # --resume marker
                 "key-count": len(keyed),
                 "results": {str(k): r for k, r in keyed.items()},
                 "failures": failures})
        if ksouts is not None and i in per_run_stats:
            record(d, _register_run_stats(per_run_stats[i]),
                   failures or None)


def _register_run_stats(keyed: list) -> dict | None:
    """One run's register-sweep search record, from (key, subhistory
    ops, engine stats) per key: the subhistory sizes plus the engines'
    counters over its keys — summed where additive (configs,
    backtracks, rounds), maxed where a peak (frontier width, depth)."""
    sizes = [n for _k, n, _s in keyed]
    stats = [s for _k, _n, s in keyed if isinstance(s, dict)]
    if not sizes:
        return None
    out: dict = {
        "keys": len(sizes),
        "subhistory_ops": {"min": min(sizes), "max": max(sizes),
                           "mean": round(sum(sizes) / len(sizes), 2)},
        "engines": sorted({s.get("engine") for s in stats
                           if s.get("engine")}),
    }
    for f in ("configs", "backtracks", "rounds"):
        vals = [s[f] for s in stats if isinstance(s.get(f), int)]
        if vals:
            out[f] = sum(vals)
    for f in ("frontier_peak", "max_depth"):
        vals = [s[f] for s in stats if isinstance(s.get(f), int)]
        if vals:
            out[f] = max(vals)
    return out


def _parse_timed(it):
    """Re-yield an iterator, recording each wait on it as a "parse"
    phase span of the sweep tracer (load and encode, in the port)."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        chunk = next(it, None)
        trace.get_current().phase("parse", t0)
        if chunk is None:
            return
        yield chunk


def analyze_store(store: Store, checker: str = "append", device=None,
                  name: str | None = None, resume: bool = False,
                  square=None, bucket_log: list | None = None,
                  condense_log: list | None = None, dense_scan=None,
                  register_log: dict | None = None,
                  report: bool | None = None, obs_hook=None,
                  mesh: bool | None = None) -> int:
    """Batch re-check every stored run (with `name`, that test name's
    runs) with `checker` ("append", "wr", "register" or "stored") on
    `device` (default cuda; raises devices.DeviceUnavailable without
    one, whatever the checker). With `resume`, runs this checker already
    verdicted are skipped and count with their recorded validity.
    `square` replaces the closure squaring (e.g. `closure_square_ref`,
    the plain version, in place of the hand kernel) and `dense_scan` the
    register checker's dense scan (e.g. `dense.scan_dense_ref` in place
    of `knossos_dense_scan`); `bucket_log` collects one dict per device
    bucket (see parallel.check_bucketed), `condense_log` one dict per
    condensed long history (see condense.check_condensed) and
    `register_log` the register sweep's load/split/check seconds, key
    count and device tiers. Returns the worst exit code. With
    JEPSEN_TPU_BACKEND=cpu (`--backend cpu`) every check runs on the
    host oracles and no device is resolved.

    The sweep runs under a fresh sweep tracer and the flight recorder
    (module doc): at its end `trace.json` and `metrics.json` are written
    (the tracer on), `events.jsonl` always, `report.json` + `report.md`
    with `report` (None defers to JEPSEN_TPU_REPORT; it needs the
    tracer on), and `analytics.jsonl` with JEPSEN_TPU_KERNEL_STATS. The
    device resolves first: without it nothing is written.

    The live telemetry, as the reference's (module doc):
    JEPSEN_TPU_COSTDB appends `costdb.jsonl` at the end (and gives
    `--report` its device section), JEPSEN_TPU_HEALTH_INTERVAL_S
    writes `health.json` during the sweep, JEPSEN_TPU_METRICS_PORT
    serves `/metrics` and `/healthz` during it, and JEPSEN_TPU_PLANNER
    loads `plan.json` at the start and refits it at the end.
    `obs_hook(server, sampler)`, when given, is called once both are
    up, before the sweep (a test or a smoke scrapes there).

    With `mesh` (`--mesh`; None defers to JEPSEN_TPU_MESH) this process
    sweeps ONE SHARD of a mesh sweep (`mesh`): the run dirs
    `store.shard_of` assigns it, journaled to `verdicts-<shard>.jsonl`
    (resume reads that journal alone), its worker spools in
    `spool-shard<k>/`, its telemetry in `trace-shard<k>.json`,
    `metrics-shard<k>.json`, `costdb-shard<k>.jsonl` and
    `analytics-shard<k>.jsonl` (the planner refit is the coordinator's),
    and `.shard-<k>.done` last. Shard 0, the coordinator, then merges
    the fleet (`mesh.coordinator_merge`): a shard that never reports is
    lost (exit at least 2) and re-assignable with
    `JEPSEN_TPU_MESH_SHARD=<k> --mesh --resume`."""
    from . import gates, obs, shm
    from . import mesh as meshmod
    from . import planner as planner_mod
    from . import supervisor as sv
    from .devices import resolve_device
    from .obs import device as device_obs
    from .obs import search as search_obs
    from .store import analytics_path, costdb_path

    if checker not in CHECKERS:
        raise ValueError(f"unknown checker {checker!r}")
    # the host oracles need no device (`--backend cpu`)
    dev = None if gates.get("JEPSEN_TPU_BACKEND") == "cpu" \
        else resolve_device(device)
    if report is None:
        report = gates.get("JEPSEN_TPU_REPORT")
    if mesh is None:
        mesh = meshmod.mesh_enabled()
    shard = n_shards = None
    run_name = f"analyze-store:{checker}"
    if mesh:
        shard, n_shards = meshmod.resolve_shard()
        # the shard rides the run name, so every process track of this
        # shard's trace carries it after the merge
        run_name = f"{run_name}@shard{shard}/{n_shards}"
    tr = trace.fresh_run(run_name, scope="sweep")
    # the cost observatory, the search ledger and the planner are
    # per-sweep state like the tracer: a fresh sweep inherits no records
    # or half-open windows, and loads the store's plan.json (a warm
    # start) or runs cold — each a no-op with its gate off
    device_obs.reset()
    search_obs.reset()
    planner_mod.activate(store.base)
    if tr.enabled and store.base.is_dir():
        # point the worker trace fabric at the store: pool workers
        # spool their spans to <spool dir>/trace-<pid>.jsonl; stale
        # spools of an earlier sweep are cleared, so the dir holds
        # exactly this sweep's set. Mesh shards share the store at
        # once and two hosts' workers may share a pid, so each shard
        # spools into a subdirectory of its own
        sd = store.base if not mesh \
            else trace.shard_spool_dir(store.base, shard)
        sd.mkdir(exist_ok=True)
        trace.clean_spools(sd)
        tr.spool_dir = sd
    elif report:
        print("attribution report needs tracing on "
              "(JEPSEN_TPU_TRACE=0 set); skipping", file=sys.stderr)
    tr.counter("shm_stale_reclaimed").inc(shm.reclaim_stale())
    journal = VerdictJournal(
        meshmod.shard_journal_path(store.base, shard) if mesh
        else store.base / "verdicts.jsonl", base=store.base)
    if mesh and store.base.is_dir():
        sv.mark_shard_start(store.base, shard)
    obs.install_events(store.base)
    obs.emit("sweep_start", checker=checker, resume=bool(resume),
             store=str(store.base),
             **({"shard": shard, "shards": n_shards} if mesh else {}))
    sampler = obs.maybe_start_health_sampler(store.base)
    server = obs.maybe_start_metrics_server(
        health_fn=(sampler.write_snapshot if sampler is not None
                   else None))
    rc: int | None = None
    try:
        if obs_hook is not None:
            obs_hook(server, sampler)
        # two shards with the profiler gate on must not share one dir
        with trace.profile_session(
                store.base / ("torch-profile" if not mesh
                              else f"torch-profile-shard{shard}")):
            rc = _analyze_store_impl(
                store, checker, dev, name, resume, journal, square=square,
                bucket_log=bucket_log, condense_log=condense_log,
                dense_scan=dense_scan, register_log=register_log,
                shard=shard, n_shards=n_shards)
    finally:
        journal.close()
        obs.emit("sweep_end", exit_code=rc if rc is not None else "crashed")
        if sampler is not None:
            sampler.stop()
        if server is not None:
            server.stop()
        if store.base.is_dir():
            # the costdb and the ledger land before the recorder is
            # uninstalled, so their flush marks reach events.jsonl; the
            # costdb lands whether or not tracing was on
            try:
                n_cost = device_obs.flush(costdb_path(store.base, shard))
                if n_cost:
                    print(f"costdb: {n_cost} record(s) appended to "
                          f"{costdb_path(store.base, shard)}",
                          file=sys.stderr)
            except Exception:
                log.warning("costdb flush failed", exc_info=True)
            try:
                n_stats = search_obs.flush(analytics_path(store.base, shard))
                if n_stats:
                    print(f"analytics: {n_stats} record(s) appended to "
                          f"{analytics_path(store.base, shard)}",
                          file=sys.stderr)
            except Exception:
                log.warning("analytics flush failed", exc_info=True)
            # the planner refits from the whole on-disk tables (this
            # sweep's records included): plan.json is what the next
            # sweep warm-starts from. Mesh shards skip it: the
            # coordinator refits once over the fleet's merged tables
            if not mesh and planner_mod.enabled():
                try:
                    from .store import load_analytics, load_costdb
                    plan = planner_mod.refresh(
                        store.base, load_costdb(costdb_path(store.base)),
                        load_analytics(analytics_path(store.base)))
                    if plan is not None:
                        print(f"planner: plan.json refit from "
                              f"{plan['trained_records']} record(s)",
                              file=sys.stderr)
                except Exception:
                    log.warning("planner refresh failed", exc_info=True)
        obs.reset_events()
        if tr.enabled and store.base.is_dir():
            try:
                evs = trace.merge_traces(tr)
                if mesh:
                    # a resume that checked nothing records no timed
                    # event: the previous shard trace stays, the
                    # evidence of how this shard's journaled verdicts
                    # were made, which the per-shard report reads
                    timed = any(e.get("ph") != "M" for e in evs)
                    sp = trace.shard_trace_path(store.base, shard)
                    if timed or not sp.exists():
                        p = trace.export_shard_trace(
                            tr, store.base, shard, n_shards, evs)
                        tr.export_metrics(
                            store.base / f"metrics-shard{shard}.json")
                        print(f"shard trace written to {p}",
                              file=sys.stderr)
                    else:
                        print(f"shard {shard}: no new events; "
                              f"keeping {sp}", file=sys.stderr)
                else:
                    p = trace.atomic_write_text(
                        store.base / "trace.json",
                        json.dumps({"traceEvents": evs,
                                    "displayTimeUnit": "ms"}))
                    tr.export_metrics(store.base / "metrics.json")
                    print(f"trace written to {p}", file=sys.stderr)
                if report and not mesh:
                    from .obs import attribution
                    rj, _rmd = attribution.write_report(
                        store.base, evs, tr.metrics_dict(),
                        device_records=(device_obs.records()
                                        if device_obs.enabled() else None),
                        search_records=(search_obs.records()
                                        if search_obs.enabled() else None))
                    print(f"report written to {rj}", file=sys.stderr)
            except Exception:
                log.warning("sweep trace export failed", exc_info=True)
        if mesh and store.base.is_dir():
            # the done marker is the last artifact: a coordinator that
            # sees it may merge this shard's journal and trace at once
            sv.mark_shard_done(store.base, shard, {
                "shard": shard, "shards": n_shards, "checker": checker,
                "exit_code": rc if rc is not None else "crashed"})
    if mesh:
        return meshmod.coordinator_merge(store, checker, shard, n_shards,
                                         rc, report=report, tracer=tr,
                                         name=name)
    return rc


def _analyze_store_impl(store: Store, checker: str, dev, name, resume: bool,
                        journal: VerdictJournal, *, square=None,
                        bucket_log: list | None = None,
                        condense_log: list | None = None, dense_scan=None,
                        register_log: dict | None = None,
                        shard: int | None = None,
                        n_shards: int | None = None) -> int:
    """The sweep itself (`analyze_store` without its telemetry
    wrapper), verdicts journaled to `journal`. With `shard`/`n_shards`
    (a mesh sweep) only this shard's slice of the run dirs is walked:
    the store walk applies the split as it lists, so no shard builds
    another's run list."""
    from . import core, ingest, parallel, supervisor
    from .checker import elle
    from .checker.elle import kernels, wr
    from .obs import events
    from .obs import search as search_obs

    run_dirs = list(store.iter_run_dirs(
        name=name, shard=shard,
        n_shards=n_shards if n_shards is not None else 1))
    prior_worst = 0
    if resume:
        # skip runs a sweep of THIS checker already verdicted: its
        # marker or results.json, else its journal line (appended as
        # each verdict lands, so it survives a killed sweep). Their
        # recorded validity still counts: an invalid verdict from the
        # completed part of a cut sweep must not read as success.
        journaled = VerdictJournal.load(journal.path)
        pending = []
        for d in run_dirs:
            ent = journaled.get((journal.rel(d), checker))
            if _verdicted(d, checker):
                prior_worst = max(prior_worst, _prior_code(d, checker))
            elif ent is not None:
                prior_worst = max(prior_worst, validity_exit_code(ent))
            else:
                pending.append(d)
        events.emit("sweep_resume", skipped=len(run_dirs) - len(pending),
                    pending=len(pending))
        if not pending and run_dirs:
            print(f"all {len(run_dirs)} runs already verdicted "
                  f"({checker}); nothing to resume", file=sys.stderr)
            return prior_worst
        run_dirs = pending
    if not run_dirs:
        if shard is not None \
                and next(store.iter_run_dirs(name=name), None) is not None:
            # a mesh assignment the split left empty (a small store,
            # many shards), not a usage error: the shard completes
            # empty so that the coordinator can merge the fleet
            print(f"shard {shard}/{n_shards}: no runs assigned",
                  file=sys.stderr)
            return prior_worst
        print("no stored runs", file=sys.stderr)
        return 254
    trace.get_current().gauge("runs_total").set(len(run_dirs))
    worst = prior_worst
    # kernel search telemetry: the checks return per-history stats,
    # recorded under the store-relative dir the journal uses; the host
    # oracles of an append or wr sweep run no kernel, so record none
    host_only = dev is None
    want_stats = search_obs.enabled() and (
        checker == "register" or not host_only)

    def record_stats(d, stats, anomalies=None) -> None:
        if stats is not None:
            search_obs.record(journal.rel(d), checker, stats,
                              anomalies=anomalies)

    def emit(d, res: dict) -> None:
        nonlocal worst
        res["checker"] = checker   # the reference's --resume marker
        worst = max(worst, _write_results(d, res, checker, journal=journal))

    def stored_check(d) -> dict:
        test = dict(store.load_test(d))
        test["store"] = store
        return core.analyze(test)["results"]

    def stored(d) -> None:
        nonlocal worst
        worst = max(worst, _stored_fallback(d, stored_check, checker,
                                            journal=journal))

    def render(enc, cycles) -> dict:
        if isinstance(cycles, supervisor.Quarantined):
            # the dispatcher abandoned this history (OOM backdown
            # exhausted, watchdog, pack failure)
            return cycles.verdict(checker)
        if checker == "wr":
            return wr.render_wr_verdict(enc, cycles, wr.WR_PROHIBITED)
        return elle.render_verdict(enc, cycles, elle.APPEND_PROHIBITED)

    if checker == "stored":
        for d in run_dirs:
            stored(d)
    elif checker == "register":
        _register_sweep(run_dirs, dev, emit, stored,
                        dense_scan=dense_scan, register_log=register_log,
                        record=record_stats if want_stats else None)
    else:
        # the pool's size, decided as the reference decides it: on the
        # card a worker pays even on a one-core host (it parses while
        # the parent waits on the device); on the CPU, ingest decides
        # (more than one core, or JEPSEN_TPU_PIPELINE)
        procs = max(1, os.cpu_count() or 1) \
            if dev is not None and dev.type == "cuda" else None
        # the dispatch mesh: dp over this process's devices of dev's
        # kind (a shard's own; one device is the single-device path),
        # built at the first device dispatch: a store of fallback runs
        # needs none
        mesh_box: list = []

        def get_mesh():
            if not mesh_box:
                from .devices import default_devices
                mesh_box.append(parallel.dp_mesh(default_devices(dev)))
            return mesh_box[0]

        def spread() -> dict:
            m = get_mesh()
            return {} if m.size == 1 else {"devices": list(m.devices.flat)}

        huge, fallback = [], []
        for chunk in _parse_timed(ingest.iter_encode_chunks(
                run_dirs, checker=checker, processes=procs)):
            good = []
            for d, enc in chunk:
                if isinstance(enc, supervisor.InjectedFault):
                    # a self-nemesis fault simulates a poisoned
                    # history, whose terminal state IS quarantine:
                    # no stored-checker detour
                    worst = max(worst, _quarantine_run(
                        d, enc, "encode", checker, journal=journal))
                elif isinstance(enc, Exception):
                    log.info("run %s not encodable as %s (%r); using "
                             "stored checker", d, checker, enc)
                    fallback.append(d)
                elif enc.n == 0:    # no txn ops: not a txn workload
                    fallback.append(d)
                elif checker == "append" and \
                        enc.n > parallel.DENSE_TXN_LIMIT:
                    # too long for the dense [T,T] closure: SCC
                    # condensation, after the dense sweep (the
                    # reference's order of verdicts)
                    huge.append((d, enc))
                else:
                    good.append((d, enc))
            if not good:
                continue
            souts: list | None = [] if want_stats else None
            if host_only:
                oracle = wr.cycle_anomalies_cpu if checker == "wr" \
                    else elle.cycle_anomalies_cpu
                cycles_per = [oracle(e) for _d, e in good]
            elif checker == "wr":
                cycles_per = _wr_chunk_with_backdown(
                    good, kernels, wr, stats_out=souts, device=dev,
                    square=square, bucket_log=bucket_log, **spread())
            else:
                cycles_per = parallel.check_bucketed(
                    [e for _, e in good], dev, mesh=get_mesh(),
                    square=square, bucket_log=bucket_log,
                    stats_out=souts)
            for i, ((d, enc), cycles) in enumerate(zip(good, cycles_per)):
                emit(d, render(enc, cycles))
                if souts is not None and i < len(souts):
                    record_stats(d, souts[i], cycles
                                 if isinstance(cycles, dict) else None)
        for d, enc in huge:
            shuge: list | None = [] if want_stats else None
            try:
                cycles = elle.cycle_anomalies_cpu(enc) if host_only \
                    else parallel.check_long_history(
                        enc, dev, dense_limit=parallel.DENSE_TXN_LIMIT,
                        square=square, bucket_log=bucket_log,
                        condense_log=condense_log, stats_out=shuge)
            except Exception as e:
                if supervisor.must_end_sweep(e):
                    raise
                # one monster history must fail alone, not take the
                # whole sweep's remaining verdicts with it
                worst = max(worst, _quarantine_run(
                    d, e, "check", checker, journal=journal))
                continue
            emit(d, render(enc, cycles))
            if shuge:
                record_stats(d, shuge[0], cycles)
        # runs the device path cannot take: their own stored
        # checker, after the dense and the long runs (the
        # reference's order)
        for d in fallback:
            stored(d)
    return worst


def _wr_chunk_with_backdown(good, elle_kernels, elle_wr,
                            stats_out: list | None = None, **kw) -> list:
    """One wr chunk's device check with the supervisor's OOM and
    watchdog degradation: the bucketed batch first
    (`elle_kernels.check_edge_batch_bucketed(edges, **kw)`); on an OOM
    or a watchdog timeout the chunk re-checks one history at a time (the
    wr dispatcher has no incremental split, so singletons ARE the
    backdown floor), and a history that still fails alone quarantines.
    Two CONSECUTIVE singleton watchdog timeouts mean the device is
    wedged, not the data: the chunk's remainder quarantines without
    re-probing. Other errors (and strict mode) re-raise. An OOM counts
    `oom_retries`; each quarantine a "quarantine" span, the
    `quarantined` counter and a `quarantine` event.

    `stats_out`, when given, is extended with one stats dict per history
    in chunk order (None for a quarantined one), only on completion; the
    stats keyword reaches the check only then."""
    from . import supervisor
    from .obs import events

    def recoverable(e) -> bool:
        return not supervisor.strict_enabled() and (
            supervisor.is_oom_error(e)
            or isinstance(e, supervisor.WatchdogTimeout))

    def check(eds: list, souts: list | None) -> list:
        if souts is None:
            return elle_kernels.check_edge_batch_bucketed(eds, **kw)
        got: list = []
        res = elle_kernels.check_edge_batch_bucketed(eds, stats_out=got,
                                                     **kw)
        souts.extend(got)
        return res

    def quarantine(stage: str, cause: str) -> None:
        with tr.span("quarantine", stage=stage, histories=1):
            tr.counter("quarantined").inc()
        events.emit("quarantine", stage=stage, histories=1, cause=cause)

    edges = [elle_wr.to_edge_dict(e) for _d, e in good]
    tr = trace.get_current()
    try:
        batch: list | None = [] if stats_out is not None else None
        res = check(edges, batch)
        if stats_out is not None:
            stats_out.extend(batch)
        return res
    except Exception as e:
        if not recoverable(e):
            raise
        if supervisor.is_oom_error(e):
            # watchdog failures are counted inside the bounded wait
            tr.counter("oom_retries").inc()
    out: list = []
    souts: list | None = [] if stats_out is not None else None
    wedged = 0
    for ed in edges:
        if wedged >= 2:
            quarantine("watchdog", "device wedged")
            out.append(supervisor.Quarantined(
                "watchdog", "device wedged: consecutive singleton "
                "watchdog timeouts"))
            if souts is not None:
                souts.append(None)
            continue
        one: list | None = [] if souts is not None else None
        try:
            out.append(check([ed], one)[0])
            if souts is not None:
                souts.append(one[0] if one else None)
            wedged = 0
        except Exception as e:
            if not recoverable(e):
                raise
            if isinstance(e, supervisor.WatchdogTimeout):
                stage = "watchdog"
                wedged += 1
            else:
                stage = "oom"
            quarantine(stage, repr(e)[:300])
            out.append(supervisor.Quarantined(stage, repr(e)))
            if souts is not None:
                souts.append(None)
    if stats_out is not None:
        stats_out.extend(souts)
    return out


def add_trace_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="write trace.json (Chrome trace-event / "
                        "Perfetto) + metrics.json into the store "
                        "(default on; --no-trace or JEPSEN_TPU_TRACE=0 "
                        "disables)")
    p.add_argument("--jax-profile",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="additionally capture a torch.profiler session "
                        "(sets JEPSEN_TPU_JAX_PROFILE, the reference's "
                        "name; lands in <store>/torch-profile for a "
                        "sweep, <run-dir>/torch-profile for test and "
                        "analyze; --no-jax-profile overrides an "
                        "inherited env)")


def apply_trace_opts(args: argparse.Namespace) -> None:
    """Export --trace/--no-trace/--jax-profile to the env gates every
    layer reads (JEPSEN_TPU_TRACE / JEPSEN_TPU_JAX_PROFILE), so
    embedded callers and subprocesses see the same choice."""
    from . import gates
    if getattr(args, "trace", None) is not None:
        gates.export("JEPSEN_TPU_TRACE", args.trace)
        trace.reset()
    if getattr(args, "jax_profile", None) is not None:
        gates.export("JEPSEN_TPU_JAX_PROFILE", args.jax_profile)


def add_test_opts(p: argparse.ArgumentParser) -> None:
    """The reference's test option set (cli.clj:55-99), so a suite's
    `test_fn` sees a complete args namespace (`test_map_from_args`
    turns it into the base test map)."""
    p.add_argument("--node", "-n", action="append", dest="nodes",
                   metavar="HOST", help="node to test (repeatable)")
    p.add_argument("--nodes-file", help="file with one node per line")
    p.add_argument("--username", default="root")
    p.add_argument("--password")
    p.add_argument("--port", type=int, default=22)
    p.add_argument("--private-key-path")
    p.add_argument("--dummy", action="store_true",
                   help="use the no-op dummy remote")
    p.add_argument("--concurrency", default="1n",
                   help="worker count; 'Nn' means N per node")
    p.add_argument("--time-limit", type=float, default=60.0,
                   help="seconds of main workload")
    p.add_argument("--test-count", type=int, default=1)
    p.add_argument("--leave-db-running", action="store_true")
    p.add_argument("--store", default="store", help="store directory")
    p.add_argument("--faults", default=None,
                   help="comma list for the combined nemesis bundle "
                        "(partition,kill,pause,clock)")
    p.add_argument("--backend", default="auto", choices=BACKENDS,
                   help="analysis backend: the device path (tpu, and "
                        "auto, the default), the host oracles (cpu), or "
                        "both raced for linearizability (race)")
    add_trace_opts(p)


def add_device_opt(p: argparse.ArgumentParser) -> None:
    """`--device` of `test` and `test-all`: where a suite's checkers
    that reach a kernel run. `test_map_from_args` writes it into the
    test map only when given; without it they run on cuda."""
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the checkers' kernels run (default cuda; "
                        "cpu only when asked)")


def _trace_path_of(test: dict) -> str | None:
    """The run's written trace.json path (None when tracing is off)."""
    try:
        p = test["store"].test_dir(test) / "trace.json"
        return str(p) if p.exists() else None
    except Exception:
        return None


def _print_result_line(test: dict, line: dict) -> None:
    """The one-line JSON result every run-style subcommand prints,
    with the run's written trace.json path attached when one exists."""
    tp = _trace_path_of(test)
    if tp:
        line["trace"] = tp
    print(json.dumps(line))


def test_map_from_args(args: argparse.Namespace) -> dict:
    nodes = list(args.nodes or [])
    if args.nodes_file:
        nodes += [ln.strip() for ln in
                  Path(args.nodes_file).read_text().splitlines()
                  if ln.strip()]
    t: dict = {
        "backend": getattr(args, "backend", "auto"),
        "concurrency": args.concurrency,
        **({"faults": [f.strip() for f in args.faults.split(",")
                       if f.strip()]}
           if getattr(args, "faults", None) else {}),
        "time_limit": args.time_limit,
        "leave_db_running": args.leave_db_running,
        "store": Store(args.store),
        "ssh": {"username": args.username, "password": args.password,
                "port": args.port, "private_key_path": args.private_key_path,
                "dummy": args.dummy},
    }
    if nodes:
        t["nodes"] = nodes
    if getattr(args, "device", None):
        t["device"] = args.device
    return t


def _analyze(test_fn, args: argparse.Namespace) -> int:
    """`analyze`: one stored run through the test map's checker
    (`core.analyze`) under a fresh run-scoped tracer, so `save_2` also
    writes the run's trace.json and metrics.json."""
    from . import core, independent
    store = Store(args.store)
    run_dir = args.run_dir or store.latest()
    if run_dir is None:
        print("no stored runs", file=sys.stderr)
        return 254
    stored = store.load_test(run_dir)
    test = test_fn(stored, args)
    test.setdefault("name", stored.get("name", "analyze"))
    # json/edn round trips erase the lifted-tuple type; re-lift so
    # per-key checkers split the history again
    test["history"] = independent.relift_history(stored["history"])
    test["store"] = store
    trace.fresh_run(test.get("name"))
    with trace.profile_session(Path(run_dir) / "torch-profile"):
        test = core.analyze(test)
    _print_result_line(test, {"valid?": test["results"].get("valid?")})
    return validity_exit_code(test["results"])


def run_cli(test_fn: Callable[[dict, argparse.Namespace], dict],
            name: str = "jepsen-tpu-torch", opt_fn=None,
            argv: list[str] | None = None,
            tests_fn: Callable[[dict, argparse.Namespace], list] | None
            = None) -> int:
    """Build and dispatch the CLI (the reference's `run_cli`):
    `test_fn(base_test, args)` returns the full test map, its checker
    included; `opt_fn(parser)` may add suite-specific options to
    `test`, `analyze` and `test-all`; `tests_fn(base_test, args)`
    returns the test maps `test-all` runs (default: the single
    `test_fn` test). Returns the exit code."""
    parser = argparse.ArgumentParser(prog=name)
    sub = parser.add_subparsers(dest="command", required=True)

    p_test = sub.add_parser("test", help="run a test")
    add_test_opts(p_test)
    add_device_opt(p_test)
    p_an = sub.add_parser("analyze",
                          help="re-run the checker on a stored history")
    p_an.add_argument("run_dir", nargs="?",
                      help="store run dir (default: latest)")
    add_test_opts(p_an)
    p_all = sub.add_parser(
        "test-all",
        help="run a whole suite of tests (cli.clj:413-491's test-all)")
    add_test_opts(p_all)
    add_device_opt(p_all)
    if opt_fn:
        for p in (p_test, p_an, p_all):
            opt_fn(p)

    a = sub.add_parser(
        "analyze-store",
        help="batch re-check every stored run on the GPU")
    a.add_argument("--store", default="store")
    a.add_argument("--checker", default="append", choices=CHECKERS,
                   help="append/wr: encode and check on the device; "
                        "register: per-key CAS linearizability, every "
                        "key of every run in one batch; stored: re-run "
                        "each run's own checker")
    a.add_argument("--name", default=None,
                   help="only runs of this test name")
    a.add_argument("--backend", default="auto", choices=BACKENDS,
                   help="cpu: the host oracles, no device; race: the "
                        "register sweep races the device path against "
                        "the CPU engine; auto and tpu: the device path")
    a.add_argument("--resume", action="store_true",
                   help="continue an interrupted sweep: skip runs this "
                        "checker already verdicted (its .sweep-* "
                        "marker, a results.json naming it, or a "
                        "verdicts.jsonl line)")
    a.add_argument("--report", action="store_true",
                   help="write the critical-path attribution report "
                        "(<store>/report.json + report.md) from the "
                        "sweep's timeline at exit (JEPSEN_TPU_REPORT=1 "
                        "is the env equivalent; needs tracing on)")
    a.add_argument("--mesh", action="store_true",
                   help="run as ONE SHARD of a mesh sweep "
                        "(JEPSEN_TPU_MESH=1 is the env equivalent): "
                        "deterministic shard of the run dirs, per-shard "
                        "verdicts-<shard>.jsonl journal and "
                        "trace-shard<k>.json artifacts, coordinator merge "
                        "on shard 0; shard identity from "
                        "JEPSEN_TPU_MESH_SHARD/_SHARDS")
    a.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the kernels run (default cuda; cpu only "
                        "when asked)")
    add_trace_opts(a)

    p_serve = sub.add_parser(
        "serve",
        help="run the multi-tenant verdict daemon: tenants stream "
             "histories over a local socket and get verdicts back "
             "(continuous batching, per-tenant fairness, journaled "
             "verdicts; analyze-store remains the batch path)")
    p_serve.add_argument("--port", type=int, default=None,
                         help="TCP port for the daemon (default: unix "
                              "socket <store>/serve.sock)")
    p_serve.add_argument("--host", default=None,
                         help="bind address (default 127.0.0.1)")
    p_serve.add_argument("--store", default="store")
    p_serve.add_argument("--socket", default=None,
                         help="unix-socket path the daemon listens on "
                              "(default <store>/serve.sock; "
                              "JEPSEN_TPU_SERVE_SOCKET is the env "
                              "equivalent)")
    p_serve.add_argument("--drain-timeout", type=float, default=None,
                         help="seconds to drain admitted work on "
                              "SIGTERM (default "
                              "JEPSEN_TPU_SERVE_DRAIN_S)")
    p_serve.add_argument("--web", action="store_true",
                         help="serve the legacy HTTP store browser "
                              "instead of the verdict daemon")
    p_serve.add_argument("--fleet-instance", type=int, default=None,
                         help="run as member <k> of a serve fleet "
                              "(the `fleet` subcommand spawns these): "
                              "bind fleet-d<k>.sock, heartbeat the "
                              "fleet-d<k>.json beacon, honor the "
                              "epoch fence")
    p_serve.add_argument("--fleet-epoch", type=int, default=None,
                         help="the membership epoch this member was "
                              "started under (the fleet router sets "
                              "it)")
    p_serve.add_argument("--device", default="cuda",
                         choices=["cuda", "cpu"],
                         help="where the folds run (default cuda; cpu "
                              "only when asked)")
    add_trace_opts(p_serve)

    p_fleet = sub.add_parser(
        "fleet",
        help="run N verdict daemons behind a fault-tolerant router: "
             "tenants connect to one fleet socket; the router "
             "hash-affines them to daemons, spills on backpressure, "
             "and on a daemon death replays its tenants' journals on "
             "a successor")
    p_fleet.add_argument("--store", default="store")
    p_fleet.add_argument("--daemons", type=int, default=3,
                         help="fleet size (default 3)")
    p_fleet.add_argument("--socket", default=None,
                         help="router socket path (default "
                              "<store>/fleet.sock)")
    p_fleet.add_argument("--no-stonith", action="store_true",
                         help="skip the router's best-effort SIGKILL "
                              "of a daemon it declares dead")
    p_fleet.add_argument("--device", default="cuda",
                         choices=["cuda", "cpu"],
                         help="where every member's folds run (default "
                              "cuda; cpu only when asked)")
    add_trace_opts(p_fleet)

    from . import lint as _lint   # stdlib-only, import-cheap
    p_lint = sub.add_parser(
        "lint",
        help="the port's static analysis (gate registry, tensor "
             "contracts, concurrency, shm lifecycle, tracer "
             "discipline, durability, the serve protocol, the C ABI)")
    _lint.add_args(p_lint)
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        return 254 if e.code not in (0, None) else 0
    if args.command == "lint":
        # no logging, device or trace setup: lint parses source, it
        # never imports or executes the target package
        return _lint.run_from_args(args)
    logging.basicConfig(level=logging.WARNING)
    from . import gates
    # every auto-backend checker of this call, and the processes it
    # starts, resolve per this choice (devices.resolve_backend), and
    # see `--mesh` as JEPSEN_TPU_MESH; the exports end with the call,
    # so an in-process caller's later sweeps keep their own
    exports = {}
    if getattr(args, "backend", "auto") != "auto":
        exports["JEPSEN_TPU_BACKEND"] = args.backend
    if getattr(args, "mesh", False):
        exports["JEPSEN_TPU_MESH"] = True
    prior = {k: gates.get_raw(k) for k in exports}
    for k, v in exports.items():
        gates.export(k, v)
    try:
        return _dispatch(test_fn, args, tests_fn)
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _test(test_fn, args: argparse.Namespace) -> int:
    """`test`: `--test-count` runs, one result line each, stopping at
    the first that is not valid (cli.clj:328-352)."""
    from . import core
    code = 0
    for _ in range(args.test_count):
        test = core.run(test_fn(test_map_from_args(args), args))
        _print_result_line(test, {
            "valid?": test["results"].get("valid?"),
            "dir": str(test["store"].test_dir(test))})
        code = max(code, validity_exit_code(test.get("results")))
        if code:
            break
    return code


def _test_all(test_fn, tests_fn, args: argparse.Namespace) -> int:
    """`test-all`: every test map in turn, one line each; a test that
    raises prints `{"name", "error"}` and counts 255; returns the worst
    code (cli.clj:413-491)."""
    from . import core
    tests = (tests_fn(test_map_from_args(args), args)
             if tests_fn is not None
             else [test_fn(test_map_from_args(args), args)])
    worst = 0
    for test in tests:
        try:
            test = core.run(test)
            code = validity_exit_code(test.get("results"))
            _print_result_line(test, {
                "name": test.get("name"),
                "valid?": test["results"].get("valid?"),
                "dir": str(test["store"].test_dir(test))})
        except Exception as e:
            log.exception("test %s crashed", test.get("name"))
            print(json.dumps({"name": test.get("name"), "error": str(e)}))
            code = 255
        worst = max(worst, code)
    return worst


def _dispatch(test_fn, args: argparse.Namespace, tests_fn=None) -> int:
    """Run `run_cli`'s parsed command; returns the exit code."""
    from .checker import Linearizable
    from .devices import DeviceUnavailable
    apply_trace_opts(args)
    try:
        if args.command == "test":
            return _test(test_fn, args)
        if args.command == "test-all":
            return _test_all(test_fn, tests_fn, args)
        if args.command == "analyze":
            return _analyze(test_fn, args)
        if args.command == "serve":
            if args.web:
                from . import web
                web.serve(Store(args.store),
                          host=args.host or "0.0.0.0",
                          port=args.port if args.port is not None
                          else 8080)
                return 0
            from .serve import run_daemon
            return run_daemon(Store(args.store),
                              socket_path=args.socket, port=args.port,
                              host=args.host or "127.0.0.1",
                              drain_s=args.drain_timeout,
                              fleet_instance=args.fleet_instance,
                              fleet_epoch=args.fleet_epoch,
                              device=args.device)
        if args.command == "fleet":
            from .serve.fleet import run_fleet
            return run_fleet(Store(args.store), daemons=args.daemons,
                             socket_path=args.socket,
                             stonith=not args.no_stonith,
                             device=args.device)
        t0 = time.perf_counter()
        rc = analyze_store(Store(args.store), checker=args.checker,
                           device=args.device, name=args.name,
                           resume=args.resume, report=args.report or None,
                           mesh=args.mesh or None)
        Linearizable.settle_races()   # a race's losing device side
        print(f"analyze-store: {time.perf_counter() - t0:.3f}s",
              file=sys.stderr)
        return rc
    except DeviceUnavailable as e:
        print(f"{args.command}: {e}", file=sys.stderr)
        return 255
    except KeyboardInterrupt:
        return 255
    except Exception:
        log.exception("fatal error")
        return 255


def main(argv: list[str] | None = None) -> int:
    """`python -m jepsen_tpu_torch.cli`: `run_cli` over the base test
    map as it is (`test` runs the noop test, `analyze` a stored test
    map)."""
    return run_cli(lambda tmap, args: tmap, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
