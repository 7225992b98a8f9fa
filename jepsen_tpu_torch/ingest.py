"""Store -> EncodedHistory ingest, serial.

Counterpart of `jepsen_tpu/ingest.py` (`encode_run_dir`,
`iter_encode_chunks`) over the port's own store loader and pure-Python
encoder. The reference's process pool, shared-memory transport,
sidecar cache and native encoder are not ported yet.
"""

from __future__ import annotations

import os
from typing import Sequence

from .checker.elle.encode import EncodedHistory, encode_history, \
    lean_anomalies
from .store import load_history_dir


def encode_run_dir(run_dir: str | os.PathLike) -> EncodedHistory:
    """Load + encode one list-append run dir, lean: witnesses reduced to
    the lean shape (`lean_anomalies`, as the reference's batch sweep
    persists them) and the per-row completion ops dropped."""
    enc = encode_history(load_history_dir(run_dir))
    enc.anomalies = lean_anomalies(enc)
    enc.txn_ops = []
    return enc


def iter_encode_chunks(run_dirs: Sequence[str | os.PathLike],
                       chunk: int = 64):
    """Yield lists of (run_dir, encoding) pairs, in order, `chunk` at a
    time. A run dir that fails to load or encode yields the Exception
    in place of its encoding."""
    dirs = list(run_dirs)
    for i in range(0, len(dirs), chunk):
        out = []
        for d in dirs[i:i + chunk]:
            try:
                out.append((d, encode_run_dir(d)))
            except Exception as e:   # per-run isolation: caller reports it
                out.append((d, e))
        yield out
