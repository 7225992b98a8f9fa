"""Store -> encoding ingest, pooled.

Counterpart of `jepsen_tpu/ingest.py`. A list-append or rw-register run
is taken, in the reference's order, from its encoded sidecar
(`store.load_encoded`), else from the native encoder
(`checker/elle/native_encode.py`, which also writes the sidecar), else
from the port's pure-Python encoders (`encode.encode_history`,
`wr.encode_wr_history`) for a file the native side declines, whose
sidecar is then written from Python (`encode_run_dir`).

The sweep does not run that serially. `iter_encode_chunks` runs it in a
spawned `ProcessPoolExecutor`: the workers parse the next chunk of runs
while the parent checks the current one on the device. Encodings come
back through POSIX shared memory (`shm`) or, for a warm v2 sidecar hit,
as a reference the parent maps itself; a reorder buffer keeps the run
order, and a dead pool (a SIGKILLed worker) resumes serially from the
last chunk yielded. Each worker spools its spans for the merged
`trace.json` (`trace.ensure_worker_tracer`). `parallel_load` loads raw
histories through the same pool recipe (the register sweep);
`load_runs` is its serial twin.

The worker's import closure is torch-free (and jax-free): a worker
imports this module, `store`, `trace`, `supervisor`, `shm` and the
encoders, nothing that loads PyTorch.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import time
from pathlib import Path
from typing import Sequence

log = logging.getLogger(__name__)

#: the checkers this module encodes for
CHECKERS = ("append", "wr")


def load_history_dir(run_dir: str | os.PathLike) -> list:
    """History ops from a run dir (the store's loader)."""
    from .store import load_history_dir as _load
    return _load(run_dir)


def native_ingest_enabled() -> bool:
    """The JEPSEN_TPU_NATIVE_INGEST gate (default on)."""
    from . import gates
    return gates.get("JEPSEN_TPU_NATIVE_INGEST")


def encode_run_dir(run_dir: str | os.PathLike, checker: str = "append",
                   info: dict | None = None):
    """Load + encode one run dir for `checker` ("append" or "wr"), lean:
    witnesses reduced to the lean shape (as the reference's batch sweep
    persists them) and the per-row completion ops dropped.

    In the reference's order, each step its span: the self-nemesis
    (JEPSEN_TPU_FAULT_INJECT) strikes first, so a selected run dir
    fails identically every time; then the sidecar cache
    ("cache_probe", counting `cache_hits` / `cache_misses`); then the
    native encoder ("encode_native", writing the sidecar from its own
    buffers when cache writes are on); then, for a file the native side
    declines or with JEPSEN_TPU_NATIVE_INGEST=0, "load_history" and
    "encode_py", and the sidecar written from Python
    ("sidecar_write").

    `info`, when given, gets info["cache"] = "hit" / "miss" (None when
    the cache is off) and info["upgraded"] = True for a v1 sidecar
    upgraded to v2: a pool worker's counters are its own and never
    exported, so the parent relays them from this dict."""
    from . import store as _store
    from . import supervisor, trace
    supervisor.maybe_inject_encode_fault(run_dir)
    if checker not in CHECKERS:
        raise ValueError(f"unknown checker {checker!r}")
    if info is not None:
        info["cache"] = None
    if _store.encode_cache_enabled():
        with trace.span("cache_probe"):
            enc = _store.load_encoded(run_dir, checker)
        if enc is not None:
            trace.counter("cache_hits").inc()
            if info is not None:
                info["cache"] = "hit"
                if getattr(enc, "upgraded", False):
                    info["upgraded"] = True
            return enc
        trace.counter("cache_misses").inc()
        if info is not None:
            info["cache"] = "miss"
    if native_ingest_enabled():
        jl = Path(run_dir) / "history.jsonl"
        if jl.is_file():
            from .checker.elle import native_encode as ne
            sidecar = None
            if _store.encode_cache_enabled() \
                    and _store.encode_cache_write_enabled():
                sidecar = _store.encoded_cache_path(run_dir, checker)
            with trace.span("encode_native"):
                enc = (ne.encode_history_file(jl, sidecar_path=sidecar)
                       if checker == "append"
                       else ne.encode_wr_history_file(
                           jl, sidecar_path=sidecar))
            if enc is not None:
                return enc
    with trace.span("load_history"):
        hist = load_history_dir(run_dir)
    with trace.span("encode_py"):
        if checker == "append":
            from .checker.elle.encode import encode_history, lean_anomalies
            enc = encode_history(hist)
            enc.anomalies = lean_anomalies(enc)
        else:
            from .checker.elle.wr import encode_wr_history, \
                lean_wr_anomalies
            enc = encode_wr_history(hist)
            enc.anomalies = lean_wr_anomalies(enc)
    enc.txn_ops = []
    with trace.span("sidecar_write"):
        _store.save_encoded(run_dir, checker, enc)
    return enc


def _worker(args):
    """`encode_run_dir(*args)`, a per-run failure returned in place of
    the encoding — except a native library that cannot be built or
    loaded, which raises: it is no run's fault."""
    from . import _build
    try:
        return encode_run_dir(*args)
    except _build.KernelBuildError:
        raise
    except Exception as e:   # per-run isolation: the caller reports it
        return e


def overlap_seconds(spans_a: list, spans_b: list) -> float:
    """Total seconds where some span in `a` intersects some span in `b`
    (both lists of (start, end) pairs): worker parse spans against the
    caller's device windows give the measured pipeline overlap."""
    from . import trace
    return trace.overlap_seconds(spans_a, spans_b)


def _stream_worker(args):
    """Pool worker of the pipeline: encode one run dir and move the
    arrays through shared memory when a segment name was assigned, or
    send a sidecar reference for a dispatch-shaped (v2) sidecar, or
    pickle the encoding. Returns (idx, payload, encode-info, t0, t1);
    payload is a shm descriptor, a sidecar reference, the encoding
    itself, or the per-run Exception. The (t0, t1) parse span is
    time.monotonic, system-wide on Linux, so it compares across
    processes.

    With worker tracing on (`tctx` not None), the worker records its
    spans into its own tracer, spools them to `<store>/trace-<pid>.jsonl`
    per task, and ships a digest back in einfo["tdigest"]."""
    idx, run_dir, checker, seg_name, tctx = args
    from . import trace
    trace.ensure_worker_tracer(tctx)
    t0 = time.monotonic()
    einfo: dict = {}
    try:
        with trace.span("encode",
                        run=os.path.basename(str(run_dir).rstrip("/"))):
            enc = encode_run_dir(run_dir, checker, info=einfo)
        from . import shm
        from . import store as _store
        if _store.sidecar_version(checker) == 2 \
                and _store.encode_cache_enabled() \
                and (einfo.get("cache") == "hit"
                     or _store.encode_cache_write_enabled()) \
                and _store.encoded_cache_path(run_dir, checker,
                                              2).is_file():
            # a dispatch-shaped sidecar answers for this run (a warm
            # hit, or this encode just wrote it; with cache writes off
            # only a validated hit qualifies): the parent maps it
            # itself, so its views stay its own mapping of the file
            payload = shm.sidecar_ref(run_dir, checker)
        elif seg_name is not None:
            with trace.span("shm_export"):
                payload = shm.export(enc, seg_name, checker)
        else:
            payload = enc
    except Exception as e:
        payload = e
    t1 = time.monotonic()
    digest = trace.flush_worker_spool()
    if digest:
        einfo["tdigest"] = digest
    return idx, payload, einfo, t0, t1


def _load_worker(run_dir):
    try:
        return load_history_dir(run_dir)
    except Exception as e:
        return e


def _spawn_safe() -> bool:
    """Can a spawned worker boot? spawn re-imports __main__; when it has
    no importable file (a stdin script, a REPL) every worker dies in
    bootstrap and the pool would respawn them forever."""
    import sys
    m = sys.modules.get("__main__")
    f = getattr(m, "__file__", None)
    if f is None:
        # `python -m pkg.mod` has a spec instead of a file: fine
        return getattr(m, "__spec__", None) is not None
    return os.path.exists(f)


def _pool_map(worker, items: list, processes: int | None) -> list:
    """The shared pool recipe: spawned workers (the parent may hold a
    CUDA context), per-item exceptions returned, not raised, and a
    serial fallback when the pool fails. A ProcessPoolExecutor, so a
    SIGKILLed worker surfaces as BrokenProcessPool (and the fallback)
    instead of a hang."""
    if processes is None:
        processes = min(len(items), os.cpu_count() or 1)
    if processes <= 1 or len(items) <= 1 or not _spawn_safe():
        return [worker(it) for it in items]
    from concurrent.futures import ProcessPoolExecutor
    ctx = mp.get_context("spawn")
    try:
        with ProcessPoolExecutor(max_workers=processes,
                                 mp_context=ctx) as ex:
            return list(ex.map(worker, items,
                               chunksize=max(1, len(items)
                                             // (4 * processes))))
    except Exception:
        log.warning("process-pool map failed; falling back to serial",
                    exc_info=True)
        return [worker(it) for it in items]


def parallel_load(run_dirs: Sequence[str | os.PathLike],
                  processes: int | None = None) -> list:
    """The raw op histories of `run_dirs` through the process pool (the
    register sweep's load), aligned with run_dirs: each history or the
    Exception its load raised. processes=0 forces the serial path."""
    return _pool_map(_load_worker, list(run_dirs), processes)


def parallel_encode(run_dirs: Sequence[str | os.PathLike],
                    checker: str = "append",
                    processes: int | None = None) -> list:
    """Encode many run dirs through the process pool, aligned with
    run_dirs: the encoding, or the Exception its encode raised (a
    KernelBuildError raises). processes=0 forces the serial path."""
    return _pool_map(_worker, [(d, checker) for d in run_dirs],
                     processes)


def iter_encode_chunks(run_dirs: Sequence[str | os.PathLike],
                       checker: str = "append", chunk: int = 64,
                       processes: int | None = None,
                       info: dict | None = None):
    """Yield lists of (run_dir, encoding) pairs, `chunk` at a time, in
    order, while later run dirs keep encoding in spawned workers, so a
    caller that checks each chunk on the device overlaps it with the
    parsing of the next. A run dir that fails to encode yields the
    Exception in place of its encoding — except a native library that
    cannot be built or loaded, which raises. With the native gate on,
    the library is probed in this process before anything is spawned:
    its build happens here, never in a worker.

    `processes`: None lets this function decide — a pool of
    min(runs, cores) when the host has more than one core or
    JEPSEN_TPU_PIPELINE is set, else the serial path; 0 forces the
    serial path; N caps the workers at N (never more than runs).

    `info`, when given, gets info["pooled"] (did workers run) and
    info["parse_spans"], each worker parse's (start, end) monotonic
    pair, appended when its item is YIELDED: a mid-stream pool failure
    leaves no span of an item the caller never saw.

    Transport: shared memory (`shm`) unless JEPSEN_TPU_SHM_INGEST=0 or
    /dev/shm is unusable (then the pickle pipe); a warm v2 sidecar
    travels as a reference. Results arrive as they complete and a
    reorder buffer restores run order (`reorder_depth` gauge: the
    deepest it got). A dead pool resumes serially from the last item
    yielded, with a warning; segments never consumed are unlinked."""
    dirs = list(run_dirs)
    if info is not None:
        info["pooled"] = False
        info["parse_spans"] = []
    if not dirs:
        return
    if checker in CHECKERS and native_ingest_enabled():
        from .checker.elle import native_encode
        native_encode.hist_lib()
    if processes is None:
        from . import gates
        ncpu = os.cpu_count() or 1
        force = gates.get("JEPSEN_TPU_PIPELINE")
        processes = min(len(dirs), ncpu) if ncpu > 1 or force else 0
    else:
        # never spawn more workers than there are run dirs to parse
        processes = min(int(processes), len(dirs))
    done = 0   # dirs fully yielded: a mid-stream pool failure resumes
    #            serially from here instead of double-yielding
    if processes and processes > 0 and len(dirs) > 1 and _spawn_safe():
        from . import _build, shm, trace
        from . import store as _store
        use_shm = shm.enabled() and shm.available()
        names = [shm.gen_name() if use_shm else None for _ in dirs]
        consumed = [name is None for name in names]
        from concurrent.futures import ProcessPoolExecutor, as_completed
        ctx = mp.get_context("spawn")
        ex = None
        try:
            ex = ProcessPoolExecutor(max_workers=processes,
                                     mp_context=ctx)
            if info is not None:
                info["pooled"] = True
            tr = trace.get_current()
            tctx = trace.worker_ctx()
            futs = [ex.submit(_stream_worker,
                              (i, d, checker, names[i], tctx))
                    for i, d in enumerate(dirs)]
            pending: dict = {}   # idx -> ((dir, enc), span)
            frontier = 0         # next idx to yield
            buf, span_buf = [], []
            for fut in as_completed(futs):
                idx, payload, einfo, t0, t1 = fut.result()
                if shm.is_sidecar_ref(payload):
                    # warm v2 hit: map the sidecar in this process
                    payload = shm.materialize_sidecar(payload)
                elif shm.is_descriptor(payload):
                    tr.counter("shm_bytes").inc(payload["nbytes"])
                    payload = shm.materialize(payload)
                consumed[idx] = True
                if isinstance(payload, _build.KernelBuildError):
                    raise payload
                if einfo.get("cache") == "hit":
                    tr.counter("cache_hits").inc()
                elif einfo.get("cache") == "miss":
                    tr.counter("cache_misses").inc()
                td = einfo.get("tdigest")
                if td:
                    # the worker's span digest (its full spans are in
                    # its spool, for merge_traces)
                    tr.counter("worker_spans").inc(
                        int(td.get("spans", 0)))
                    for k, secs in (td.get("stage_secs")
                                    or {}).items():
                        tr.histogram(f"worker.{k}").observe(secs)
                if einfo.get("upgraded"):
                    # the worker's v1->v2 upgrade, relayed: its own
                    # counters and events are never exported
                    tr.counter("sidecar_upgrades").inc()
                    from .obs import events as obs_events
                    obs_events.emit(
                        "cache_rebuild",
                        path=str(_store.encoded_cache_path(
                            dirs[idx], checker, 2)),
                        cause="v1->v2 upgrade")
                # the worker's parse window, on its own trace track
                tr.add_span("parse", t0, t1, track="ingest-pool",
                            clock="monotonic")
                pending[idx] = ((dirs[idx], payload), (t0, t1))
                if len(pending) > 1:
                    g = tr.gauge("reorder_depth")
                    g.set(max(getattr(g, "value", 0) or 0,
                              len(pending)))
                while frontier in pending:
                    item, span = pending.pop(frontier)
                    buf.append(item)
                    span_buf.append(span)
                    frontier += 1
                    if len(buf) >= chunk:
                        if info is not None:
                            info["parse_spans"].extend(span_buf)
                        yield buf
                        done += len(buf)
                        buf, span_buf = [], []
            if buf:
                if info is not None:
                    info["parse_spans"].extend(span_buf)
                yield buf
                done += len(buf)
            return
        except _build.KernelBuildError:
            raise
        except Exception:
            log.warning("pipelined encode pool failed; falling back "
                        "to serial", exc_info=True)
        finally:
            if ex is not None:
                # cancel queued work and give running tasks a bounded
                # grace; a wedged worker (a hang in a huge or corrupt
                # parse) is killed, and its segment falls to the sweep
                # below or to shm.reclaim_stale at the next sweep
                procs = list((getattr(ex, "_processes", None)
                              or {}).values())
                ex.shutdown(wait=False, cancel_futures=True)
                deadline = time.monotonic() + 5.0
                for p in procs:
                    p.join(max(0.0, deadline - time.monotonic()))
                for p in procs:
                    if p.is_alive():
                        log.warning("killing wedged encode worker "
                                    "pid=%s", p.pid)
                        p.kill()
            # a segment a worker created but the parent never mapped
            # must not outlive the pool
            for name, ok in zip(names, consumed):
                if not ok:
                    shm.unlink_stale(name)
    for i in range(done, len(dirs), chunk):
        yield [(d, _worker((d, checker))) for d in dirs[i:i + chunk]]


def load_runs(run_dirs: Sequence[str | os.PathLike]) -> list:
    """The raw op histories of `run_dirs`, in order and in this process:
    each run's history, or the Exception its load raised (per-run
    isolation: the caller reports it). The serial twin of
    `parallel_load`."""
    out: list = []
    for d in run_dirs:
        try:
            out.append(load_history_dir(d))
        except Exception as e:
            out.append(e)
    return out
