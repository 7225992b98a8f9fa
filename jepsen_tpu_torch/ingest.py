"""Store -> encoding ingest, serial.

Counterpart of `jepsen_tpu/ingest.py` (`encode_run_dir`,
`iter_encode_chunks`, and `load_runs`, the serial twin of its
`parallel_load`). A list-append or rw-register run is taken, in the
reference's order, from its encoded sidecar (`store.load_encoded`),
else from the native encoder (`checker/elle/native_encode.py`, which
also writes the sidecar), else from the port's pure-Python encoders
(`encode.encode_history`, `wr.encode_wr_history`) for a file the
native side declines, whose sidecar is then written from Python. The
reference's process pool and shared-memory transport are not ported
yet.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence

from .checker.elle.encode import EncodedHistory, encode_history, \
    lean_anomalies
from .checker.elle.wr import WrEncoded, encode_wr_history, \
    lean_wr_anomalies
from .store import load_history_dir

#: checker -> (encoder, lean-witness reducer)
ENCODERS = {"append": (encode_history, lean_anomalies),
            "wr": (encode_wr_history, lean_wr_anomalies)}


def native_ingest_enabled() -> bool:
    """The JEPSEN_TPU_NATIVE_INGEST gate (default on)."""
    from . import gates
    return gates.get("JEPSEN_TPU_NATIVE_INGEST")


def encode_run_dir(run_dir: str | os.PathLike, checker: str = "append"
                   ) -> EncodedHistory | WrEncoded:
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
    ("sidecar_write")."""
    from . import store as _store
    from . import supervisor, trace
    supervisor.maybe_inject_encode_fault(run_dir)
    if checker not in ENCODERS:
        raise ValueError(f"unknown checker {checker!r}")
    if _store.encode_cache_enabled():
        with trace.span("cache_probe"):
            enc = _store.load_encoded(run_dir, checker)
        if enc is not None:
            trace.counter("cache_hits").inc()
            return enc
        trace.counter("cache_misses").inc()
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
    encode, lean = ENCODERS[checker]
    with trace.span("load_history"):
        hist = load_history_dir(run_dir)
    with trace.span("encode_py"):
        enc = encode(hist)
        enc.anomalies = lean(enc)
    enc.txn_ops = []
    with trace.span("sidecar_write"):
        _store.save_encoded(run_dir, checker, enc)
    return enc


def iter_encode_chunks(run_dirs: Sequence[str | os.PathLike],
                       checker: str = "append", chunk: int = 64):
    """Yield lists of (run_dir, encoding) pairs, in order, `chunk` at a
    time. A run dir that fails to load or encode yields the Exception
    in place of its encoding — except a native library that cannot be
    built or loaded, which raises: it is no run's fault. With the
    native gate on, the library is probed before the first run, as the
    reference probes it in its parent process."""
    from . import _build
    dirs = list(run_dirs)
    if not dirs:
        return
    if checker in ENCODERS and native_ingest_enabled():
        from .checker.elle import native_encode
        native_encode.hist_lib()
    for i in range(0, len(dirs), chunk):
        out = []
        for d in dirs[i:i + chunk]:
            try:
                out.append((d, encode_run_dir(d, checker)))
            except _build.KernelBuildError:
                raise
            except Exception as e:   # per-run isolation: caller reports it
                out.append((d, e))
        yield out


def load_runs(run_dirs: Sequence[str | os.PathLike]) -> list:
    """The raw op histories of `run_dirs`, in order: each run's history,
    or the Exception its load raised (per-run isolation: the caller
    reports it)."""
    out: list = []
    for d in run_dirs:
        try:
            out.append(load_history_dir(d))
        except Exception as e:
            out.append(e)
    return out
