"""Command line of the PyTorch port:

    python -m jepsen_tpu_torch.cli analyze-store --store DIR \\
        --checker append [--device cuda|cpu]

Counterpart of `jepsen_tpu/cli.py`'s `analyze-store` for the dense
list-append path: every stored run is encoded, the runs are length-
bucketed and checked on the device, and each verdict lands as the
reference writes it — `results.edn`, `results.json` (atomic), the
`.sweep-append` resume marker, one `verdicts.jsonl` line and one JSON
summary line on stdout.

Exit codes, as the reference's: 0 every run valid, 1 some run invalid,
2 validity unknown, 254 usage error (or no stored runs), 255 crash or
no CUDA device. A run the port cannot check yet — past
`parallel.DENSE_TXN_LIMIT` txns, not encodable, or with no txn ops (the
reference's long-history and stored-checker paths) — gets no verdict:
it is named on stderr and the sweep exits 2 at least.
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

NOT_PORTED = "not yet ported: long-history / stored-checker path"


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
    print(json.dumps(line))
    return validity_exit_code(res)


def analyze_store(store: Store, checker: str = "append", device=None,
                  square=None, bucket_log: list | None = None) -> int:
    """Batch re-check every stored run on `device` (default cuda; raises
    devices.DeviceUnavailable without one). `square` replaces the
    closure squaring (e.g. `closure_square_ref`, the plain version, in
    place of the hand kernel); `bucket_log` collects one dict per
    device bucket (see parallel.check_bucketed). Returns the worst exit
    code."""
    from . import ingest, parallel
    from .checker import elle
    from .devices import resolve_device

    if checker != "append":
        raise ValueError(f"checker {checker!r} is not ported")
    dev = resolve_device(device)
    run_dirs = list(store.iter_run_dirs())
    if not run_dirs:
        print("no stored runs", file=sys.stderr)
        return 254
    journal = VerdictJournal(store.base / "verdicts.jsonl", base=store.base)
    worst = 0
    skipped: list[tuple] = []
    try:
        for chunk in ingest.iter_encode_chunks(run_dirs):
            dense, dense_map = [], []
            for d, enc in chunk:
                if isinstance(enc, Exception):
                    skipped.append((d, f"not encodable: {enc!r}"))
                elif enc.n == 0:
                    skipped.append((d, "no txn ops"))
                elif enc.n > parallel.DENSE_TXN_LIMIT:
                    skipped.append((d, f"{enc.n} txns > "
                                       f"{parallel.DENSE_TXN_LIMIT}"))
                else:
                    dense.append(enc)
                    dense_map.append(d)
            if not dense:
                continue
            cycles_per = parallel.check_bucketed(
                dense, dev, square=square, bucket_log=bucket_log)
            for d, enc, cycles in zip(dense_map, dense, cycles_per):
                res = elle.render_verdict(enc, cycles,
                                          elle.APPEND_PROHIBITED)
                res["checker"] = checker   # the reference's --resume marker
                worst = max(worst, _write_results(d, res, checker,
                                                  journal=journal))
    finally:
        journal.close()
    for d, why in skipped:
        print(f"{NOT_PORTED}: {d} ({why}); no verdict written",
              file=sys.stderr)
    if skipped:
        worst = max(worst, 2)
    return worst


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    a = sub.add_parser(
        "analyze-store",
        help="batch re-check every stored run on the GPU")
    a.add_argument("--store", default="store")
    a.add_argument("--checker", default="append", choices=["append"])
    a.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the kernels run (default cuda; cpu only "
                        "when asked)")
    args = p.parse_args(argv)
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
