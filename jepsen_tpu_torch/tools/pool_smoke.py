"""The pooled ingest, driven and measured from a process of its own.

    python -m jepsen_tpu_torch.tools.pool_smoke cli [--processes N] ARGS...
    python -m jepsen_tpu_torch.tools.pool_smoke encodings STORE CHECKER N
    python -m jepsen_tpu_torch.tools.pool_smoke load STORE N

The pool spawns its workers, and a spawned worker re-imports the main
module of the process that made it: this module imports nothing at
load time but the standard library, so its workers start without
torch, as the CLI's own do (`python -m jepsen_tpu_torch.cli`).
`chip_smoke.py` (phase 13) runs it in a subprocess for that reason.

- `cli`: `python -m jepsen_tpu_torch.cli ARGS...`, with each hand
  kernel's launches counted and timed by a CUDA event pair around each
  launch (`closure_square`, `knossos_dense_scan`), the ingest's `info`
  (`pooled`, the workers' parse spans) and the register load's pool
  recorded; `--processes N` sizes the append/wr pool at N workers in
  place of the CLI's choice (0: the serial path). The CUDA context is
  made before the sweep and its time reported apart. At exit one line `pool_smoke {json}` on stderr: the exit
  code, the wall, each kernel's launches and device ms, `pooled`, the
  parse spans' count, sum and extent, the device windows' count and
  extent (s from the sweep tracer's origin), and the measured overlap
  of the parse spans with the device windows
  (`ingest.overlap_seconds`).
- `encodings`: every encoding `iter_encode_chunks(processes=N)`
  delivers for STORE's runs against `processes=0`'s, array for array
  (dtypes included) and in run order; one JSON line with both walls.
- `load`: `parallel_load(processes=N)` against `load_runs`, equal
  histories in order; one JSON line with both walls.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _run_dirs(store: str) -> list:
    from jepsen_tpu_torch.store import Store
    return list(Store(store).iter_run_dirs())


def _cli(argv: list, processes: int | None = None) -> int:
    import torch

    from jepsen_tpu_torch import cli, ingest, trace
    from jepsen_tpu_torch.checker.elle import closure_square as cs
    from jepsen_tpu_torch.checker.knossos import dense

    kernels = {"closure_square": cs.closure_square,
               "knossos_dense_scan": dense.knossos_dense_scan}
    for k in kernels.values():
        k.launches = 0
        k.events = []
    rec: dict = {}
    real_iter, real_map = ingest.iter_encode_chunks, ingest._pool_map

    def iter_encode_chunks(*a, **kw):
        info = kw.setdefault("info", {})
        rec["ingest"] = info
        if processes is not None:
            kw["processes"] = processes
        yield from real_iter(*a, **kw)

    def pool_map(worker, items, processes):
        n = min(len(items), os.cpu_count() or 1) if processes is None \
            else processes
        t0 = time.perf_counter()
        out = real_map(worker, items, processes)
        rec["load"] = {"items": len(items), "processes": n,
                       "pooled": n > 1 and len(items) > 1
                       and ingest._spawn_safe(),
                       "secs": time.perf_counter() - t0}
        return out

    ingest.iter_encode_chunks = iter_encode_chunks
    ingest._pool_map = pool_map
    cuda_init = None
    if torch.cuda.is_available():
        # the CUDA context, made before the sweep as in a process that
        # has swept before: the wall is the sweep's alone
        t0 = time.perf_counter()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        cuda_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = {"rc": rc, "wall": wall, "cuda_init_s": cuda_init}
    for name, k in kernels.items():
        out[name] = {"launches": k.launches,
                     "device_ms": sum(a.elapsed_time(b)
                                      for a, b in k.events)}
    info = rec.get("ingest")
    if info is not None:
        tr = trace.get_current()
        spans = info.get("parse_spans", [])
        windows = []
        if getattr(tr, "enabled", False):
            om = tr.origin_mono()
            windows = [(om + e["ts"] / 1e6, om + (e["ts"] + e["dur"]) / 1e6)
                       for e in tr.chrome_events()
                       if e.get("cat") == "device" and e["ph"] == "X"]
        om = tr.origin_mono() if getattr(tr, "enabled", False) else 0.0

        def extent(iv: list) -> list | None:
            # first start and last end, in s from the tracer's origin
            return [min(a for a, _ in iv) - om,
                    max(b for _, b in iv) - om] if iv else None
        out.update(pooled=info.get("pooled"), parse_spans=len(spans),
                   parse_secs=sum(b - a for a, b in spans),
                   parse_range=extent(spans),
                   device_windows=len(windows),
                   device_range=extent(windows),
                   overlap_secs=ingest.overlap_seconds(spans, windows))
    if "load" in rec:
        out["load"] = rec["load"]
    print("pool_smoke " + json.dumps(out), file=sys.stderr, flush=True)
    return rc


def _same(a, b, checker: str) -> str | None:
    """None when encodings a and b are equal, field for field, else what
    differs."""
    import numpy as np

    from jepsen_tpu_torch import store
    if isinstance(a, Exception) or isinstance(b, Exception):
        return None if (type(a), str(a)) == (type(b), str(b)) \
            else f"{a!r} / {b!r}"
    for (f, x), (_f, y) in zip(store.encoded_arrays(a, checker),
                               store.encoded_arrays(b, checker)):
        if x.dtype != y.dtype or not np.array_equal(x, y):
            return f
    scalars = ("n", "key_count") if checker == "wr" \
        else ("n", "n_keys", "max_pos")
    for f in scalars:
        if getattr(a, f) != getattr(b, f):
            return f
    if checker == "append" and list(a.key_names) != list(b.key_names):
        return "key_names"
    if list(a.anomalies.items()) != list(b.anomalies.items()):
        return "anomalies"
    return None


def _encodings(store: str, checker: str, processes: int) -> int:
    """The serial pass first (its encodings on the heap), then the
    pooled one, each chunk compared as it arrives and dropped, so the
    shared-memory pages a chunk maps are released before the next."""
    from jepsen_tpu_torch import ingest, trace

    dirs = _run_dirs(store)
    t0 = time.perf_counter()
    serial = [x for part in ingest.iter_encode_chunks(
        dirs, checker, processes=0) for x in part]
    serial_secs = time.perf_counter() - t0
    tr = trace.fresh_run("pool_smoke", scope="sweep")
    info: dict = {}
    diffs, order, errors = [], [], 0
    t0 = time.perf_counter()
    for part in ingest.iter_encode_chunks(dirs, checker,
                                          processes=processes, info=info):
        for d, a in part:
            i = len(order)
            order.append(str(d))
            errors += isinstance(a, Exception)
            what = _same(a, serial[i][1], checker) \
                if i < len(serial) else "extra run"
            if what is not None:
                diffs.append(f"{d}: {what}")
        del part
    pooled_secs = time.perf_counter() - t0
    if order != [str(d) for d in dirs]:
        diffs.append("run order")
    print(json.dumps({
        "runs": len(dirs), "processes": processes,
        "pooled": info["pooled"], "pooled_secs": pooled_secs,
        "serial_secs": serial_secs, "errors": errors,
        "counters": tr.metrics_dict()["counters"],
        "diffs": diffs[:10]}), flush=True)
    return 1 if diffs else 0


def _load(store: str, processes: int) -> int:
    from jepsen_tpu_torch import ingest

    dirs = _run_dirs(store)
    t0 = time.perf_counter()
    pooled = ingest.parallel_load(dirs, processes=processes)
    t1 = time.perf_counter()
    serial = ingest.load_runs(dirs)
    t2 = time.perf_counter()
    same = len(pooled) == len(serial) and all(
        (type(a), str(a)) == (type(b), str(b))
        if isinstance(b, Exception) else a == b
        for a, b in zip(pooled, serial))
    print(json.dumps({"runs": len(dirs), "processes": processes,
                      "pooled_secs": t1 - t0, "serial_secs": t2 - t1,
                      "equal": same}), flush=True)
    return 0 if same else 1


def main(argv: list | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 254
    cmd, rest = argv[0], argv[1:]
    if cmd == "cli" and rest[:1] == ["--processes"] and len(rest) > 1:
        return _cli(rest[2:], int(rest[1]))
    if cmd == "cli":
        return _cli(rest)
    if cmd == "encodings" and len(rest) == 3:
        return _encodings(rest[0], rest[1], int(rest[2]))
    if cmd == "load" and len(rest) == 2:
        return _load(rest[0], int(rest[1]))
    print(__doc__, file=sys.stderr)
    return 254


if __name__ == "__main__":
    sys.exit(main())
