"""Command line of the PyTorch port:

    python -m jepsen_tpu_torch.cli analyze-store --store DIR \\
        --checker append|wr|register [--device cuda|cpu]

Counterpart of `jepsen_tpu/cli.py`'s `analyze-store` for the Elle and
register checkers: every stored run is checked on the device, and each
verdict lands as the reference writes it — `results.edn`,
`results.json` (atomic), the `.sweep-<checker>` resume marker, one
`verdicts.jsonl` line and one JSON summary line on stdout.

- `append` (list-append): runs up to `parallel.DENSE_TXN_LIMIT` txns
  are length-bucketed through the dense closure; longer ones follow,
  one at a time, through SCC condensation (`parallel.check_long_history`).
- `wr` (rw-register): host-built dependency edges, length-bucketed
  through the same device classification
  (`kernels.check_edge_batch_bucketed`).
- `register` (per-key CAS-register linearizability): every run's values
  are re-lifted to `[k v]` and split per key in one pass, and every key
  of every run goes down in one `Linearizable.check_batch` (dense grid
  -> bounded frontier -> CPU WGL); verdicts regroup per run.

Exit codes, as the reference's: 0 every run valid, 1 some run invalid,
2 validity unknown, 254 usage error (or no stored runs), 255 crash or
no CUDA device. A long list-append run whose condensed check raises is
quarantined alone (`valid? unknown`, the cause kept in its results)
and the sweep goes on; a build or device failure still ends it. A run
the port cannot check yet — one the reference
sends to its stored-checker path: not encodable, with no txn ops, or
for `register` not register-shaped — gets no verdict: it is named on
stderr and the sweep exits 2 at least.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from .store import Store, VerdictJournal

log = logging.getLogger(__name__)

NOT_PORTED = "not yet ported: stored-checker path"


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


def _write_results(d, res: dict, checker: str, journal=None) -> int:
    """Persist results.json/.edn into a run dir, mark it verdicted for
    this checker, journal it and print the one-line summary; returns the
    validity exit code. results.json lands via a per-process temp file
    and an atomic rename."""
    from . import edn
    from .store import _results_to_edn
    safe = _json_safe(res)
    (d / "results.edn").write_text(edn.dumps(_results_to_edn(safe)) + "\n")
    tmp = d / f"results.json.tmp.{os.getpid()}"
    tmp.write_text(json.dumps(safe, indent=2))
    os.replace(tmp, d / "results.json")
    (d / f".sweep-{checker}").write_text(
        json.dumps({"valid?": res.get("valid?")}))
    if journal is not None:
        journal.record(d, checker, res)
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


def _quarantine_run(d, err, stage: str, checker: str, journal=None) -> int:
    """Record a run the sweep abandoned as a `valid? unknown` verdict —
    never a false verdict, never a dead sweep — persisting the cause for
    triage and journaling it. The reference's tracer span, counter and
    flight-recorder event are left out (the port has no tracer yet), and
    so is its strict gate (JEPSEN_TPU_STRICT=1 re-raising): the port has
    no supervisor gates yet."""
    from . import supervisor
    log.warning("quarantining %s (%s): %s", d, stage, err)
    return _write_results(d, supervisor.quarantine_verdict(err, stage,
                                                           checker),
                          checker, journal=journal)


def _register_sweep(run_dirs: list, dev, emit, skipped: list,
                    dense_scan=None, register_log: dict | None = None
                    ) -> None:
    """Per-key CAS-register linearizability over every run: each key's
    subhistory from every run goes down in one tiered `check_batch`,
    then verdicts regroup per run and `emit` writes them, in run order.
    If the batch raises (a malformed run), each key is re-checked alone
    and a key that raises again gets `{"valid?": "unknown", "error"}` —
    except a build or device failure, which is no run's fault and
    propagates. Runs the reference sends to its stored checker land in
    `skipped`."""
    from . import _build, independent, ingest
    from .checker import linearizable, merge_valid, models
    from .devices import DeviceUnavailable

    c = linearizable(models.cas_register(), device=dev,
                     dense_scan=dense_scan)
    t0 = time.perf_counter()
    hists = ingest.load_runs(run_dirs)
    t1 = time.perf_counter()
    subs: list[list] = []          # flattened subhistories
    owners: list[tuple[int, object]] = []   # (run index, key)
    checked: set[int] = set()
    for i, (d, hist) in enumerate(zip(run_dirs, hists)):
        if isinstance(hist, Exception):
            skipped.append((d, f"not loadable: {hist!r}"))
            continue
        hist = independent.relift_history(hist)
        client_fs = {o.get("f") for o in hist
                     if o.get("process") != "nemesis"
                     and o.get("f") is not None}
        if not client_fs or not client_fs <= {"read", "write", "cas"}:
            skipped.append((d, f"not register-shaped (client f "
                               f"{sorted(map(str, client_fs))})"))
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
            skipped.append((d, "lifted values, but relift declined"))
            continue
        checked.add(i)
        for k in (ks or [None]):
            subs.append(by_key[k] if ks else hist)
            owners.append((i, k))
    t2 = time.perf_counter()
    tiers: list = []
    try:
        results = c.check_batch({}, subs, {}, tier_log=tiers) \
            if subs else []
    except (_build.KernelBuildError, DeviceUnavailable):
        raise
    except Exception:
        # one malformed run must not sink the sweep: re-dispatch each
        # subhistory in isolation, degrading only the broken ones
        log.warning("batched register sweep failed; isolating per key",
                    exc_info=True)
        results = []
        for s in subs:
            try:
                results.append(c.check_batch({}, [s], {})[0])
            except (_build.KernelBuildError, DeviceUnavailable):
                raise
            except Exception as e:
                results.append({"valid?": "unknown",
                                "error": repr(e)[:200]})
    t3 = time.perf_counter()
    if register_log is not None:
        register_log.update(load_s=t1 - t0, split_s=t2 - t1,
                            check_s=t3 - t2, keys=len(subs), tiers=tiers)
    per_run: dict[int, dict] = {}
    for (i, k), res in zip(owners, results):
        per_run.setdefault(i, {})[k] = res
    for i, d in enumerate(run_dirs):
        if i not in checked:
            continue
        keyed = per_run.get(i, {})
        emit(d, {"valid?": merge_valid([r.get("valid?", True)
                                        for r in keyed.values()] or [True]),
                 "checker": "register",       # --resume marker
                 "key-count": len(keyed),
                 "results": {str(k): r for k, r in keyed.items()},
                 "failures": sorted(str(k) for k, r in keyed.items()
                                    if r.get("valid?") is False)})


def analyze_store(store: Store, checker: str = "append", device=None,
                  square=None, bucket_log: list | None = None,
                  condense_log: list | None = None, dense_scan=None,
                  register_log: dict | None = None) -> int:
    """Batch re-check every stored run with `checker` ("append", "wr"
    or "register") on `device` (default cuda; raises
    devices.DeviceUnavailable without one). `square` replaces the
    closure squaring (e.g. `closure_square_ref`, the plain version, in
    place of the hand kernel) and `dense_scan` the register checker's
    dense scan (e.g. `dense.scan_dense_ref` in place of
    `knossos_dense_scan`); `bucket_log` collects one dict per device
    bucket (see parallel.check_bucketed), `condense_log` one dict per
    condensed long history (see condense.check_condensed) and
    `register_log` the register sweep's load/split/check seconds, key
    count and device tiers. Returns the worst exit code."""
    from . import _build, ingest, parallel
    from .checker import elle
    from .checker.elle import kernels, wr
    from .devices import DeviceUnavailable, resolve_device

    if checker not in ("append", "wr", "register"):
        raise ValueError(f"checker {checker!r} is not ported")
    dev = resolve_device(device)
    run_dirs = list(store.iter_run_dirs())
    if not run_dirs:
        print("no stored runs", file=sys.stderr)
        return 254
    journal = VerdictJournal(store.base / "verdicts.jsonl", base=store.base)
    worst = 0
    skipped: list[tuple] = []

    def emit(d, res: dict) -> None:
        nonlocal worst
        res["checker"] = checker   # the reference's --resume marker
        worst = max(worst, _write_results(d, res, checker, journal=journal))

    if checker == "register":
        try:
            _register_sweep(run_dirs, dev, emit, skipped,
                            dense_scan=dense_scan,
                            register_log=register_log)
        finally:
            journal.close()
        return _report_skipped(skipped, worst)

    def render(enc, cycles) -> dict:
        if checker == "wr":
            return wr.render_wr_verdict(enc, cycles, wr.WR_PROHIBITED)
        return elle.render_verdict(enc, cycles, elle.APPEND_PROHIBITED)

    try:
        huge = []
        for chunk in ingest.iter_encode_chunks(run_dirs, checker=checker):
            good = []
            for d, enc in chunk:
                if isinstance(enc, Exception):
                    skipped.append((d, f"not encodable as {checker}: "
                                       f"{enc!r}"))
                elif enc.n == 0:
                    skipped.append((d, "no txn ops"))
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
            if checker == "wr":
                cycles_per = kernels.check_edge_batch_bucketed(
                    [wr.to_edge_dict(e) for _, e in good], dev,
                    square=square, bucket_log=bucket_log)
            else:
                cycles_per = parallel.check_bucketed(
                    [e for _, e in good], dev, square=square,
                    bucket_log=bucket_log)
            for (d, enc), cycles in zip(good, cycles_per):
                emit(d, render(enc, cycles))
        for d, enc in huge:
            try:
                cycles = parallel.check_long_history(
                    enc, dev, dense_limit=parallel.DENSE_TXN_LIMIT,
                    square=square, bucket_log=bucket_log,
                    condense_log=condense_log)
            except (_build.KernelBuildError, DeviceUnavailable):
                raise
            except Exception as e:
                # one monster history must fail alone, not take the
                # whole sweep's remaining verdicts with it
                worst = max(worst, _quarantine_run(d, e, "check", checker,
                                                   journal=journal))
                continue
            emit(d, render(enc, cycles))
    finally:
        journal.close()
    return _report_skipped(skipped, worst)


def _report_skipped(skipped: list, worst: int) -> int:
    """Name the runs left without a verdict on stderr; the sweep's exit
    code is then 2 at least."""
    for d, why in skipped:
        print(f"{NOT_PORTED}: {d} ({why}); no verdict written",
              file=sys.stderr)
    return max(worst, 2) if skipped else worst


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    a = sub.add_parser(
        "analyze-store",
        help="batch re-check every stored run on the GPU")
    a.add_argument("--store", default="store")
    a.add_argument("--checker", default="append",
                   choices=["append", "wr", "register"])
    a.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the kernels run (default cuda; cpu only "
                        "when asked)")
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 254 if e.code not in (0, None) else 0
    logging.basicConfig(level=logging.WARNING)
    from .devices import DeviceUnavailable
    try:
        t0 = time.perf_counter()
        rc = analyze_store(Store(args.store), checker=args.checker,
                           device=args.device)
        print(f"analyze-store: {time.perf_counter() - t0:.3f}s",
              file=sys.stderr)
        return rc
    except DeviceUnavailable as e:
        print(f"analyze-store: {e}", file=sys.stderr)
        return 255
    except KeyboardInterrupt:
        return 255
    except Exception:
        log.exception("fatal error")
        return 255


if __name__ == "__main__":
    sys.exit(main())
