"""Store -> encoding ingest, serial.

Counterpart of `jepsen_tpu/ingest.py` (`encode_run_dir`,
`iter_encode_chunks`, and `load_runs`, the serial twin of its
`parallel_load`) over the port's own store loader and pure-Python
encoders: `encode.encode_history` for list-append runs and
`wr.encode_wr_history` for rw-register runs. The reference's process
pool, shared-memory transport, sidecar cache and native encoder are not
ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

from .checker.elle.encode import EncodedHistory, encode_history, \
    lean_anomalies
from .checker.elle.wr import WrEncoded, encode_wr_history, \
    lean_wr_anomalies
from .store import load_history_dir

#: checker -> (encoder, lean-witness reducer)
ENCODERS = {"append": (encode_history, lean_anomalies),
            "wr": (encode_wr_history, lean_wr_anomalies)}


def encode_run_dir(run_dir: str | os.PathLike, checker: str = "append"
                   ) -> EncodedHistory | WrEncoded:
    """Load + encode one run dir for `checker` ("append" or "wr"), lean:
    witnesses reduced to the lean shape (as the reference's batch sweep
    persists them) and the per-row completion ops dropped. The
    self-nemesis (JEPSEN_TPU_FAULT_INJECT) strikes first, ahead of
    everything else, so a selected run dir fails identically every
    time. The load and the encode are the reference's "load_history"
    and "encode_py" spans."""
    from . import supervisor, trace
    supervisor.maybe_inject_encode_fault(run_dir)
    if checker not in ENCODERS:
        raise ValueError(f"unknown checker {checker!r}")
    encode, lean = ENCODERS[checker]
    with trace.span("load_history"):
        hist = load_history_dir(run_dir)
    with trace.span("encode_py"):
        enc = encode(hist)
        enc.anomalies = lean(enc)
    enc.txn_ops = []
    return enc


def iter_encode_chunks(run_dirs: Sequence[str | os.PathLike],
                       checker: str = "append", chunk: int = 64):
    """Yield lists of (run_dir, encoding) pairs, in order, `chunk` at a
    time. A run dir that fails to load or encode yields the Exception
    in place of its encoding."""
    dirs = list(run_dirs)
    for i in range(0, len(dirs), chunk):
        out = []
        for d in dirs[i:i + chunk]:
            try:
                out.append((d, encode_run_dir(d, checker)))
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
