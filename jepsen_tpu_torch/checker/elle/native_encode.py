"""ctypes bridge to the native history encoder (`csrc/hist_encode.cc`).

Counterpart of `jepsen_tpu/checker/elle/native_encode.py`, with the
parts of `jepsen_tpu/native_lib.py` it uses (`hist_lib`,
`count_fallback`, `note_fallback`). `encode_history_file` parses and
encodes a history.jsonl straight to an EncodedHistory in C++, skipping
json.loads and the Python dict walk; `encode_wr_history_file` does the
same for rw-register runs. The native side keeps a strict parity
contract (see hist_encode.cc's header): a file it cannot encode byte
for byte returns None, and the caller runs the Python encoder on it.
Witnesses on this path are lean, plain-int dicts, identical to the
Python encoder's `lean_anomalies` / `lean_wr_anomalies`.

The library is the port's own g++ build of `csrc/hist_encode.cc`
(`_build.load`), or with JEPSEN_TPU_NATIVE_LIB_DIR the
`libjepsen_histenc.so` already built in that directory.

One deliberate departure from the reference: its `_cached_lib` warns
and carries on in Python when the library cannot be built, loaded or
bound, so a whole sweep can run degraded. Here a failed build, load or
ABI check raises `_build.KernelBuildError`; only JEPSEN_TPU_NO_NATIVE
turns the library off, and then every call that wanted it counts
`native_fallback` and `native_fallback.hist_encode.cc`, as the
reference counts them.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
from pathlib import Path

import numpy as np

from ... import _build, gates
from .encode import EncodedHistory

log = logging.getLogger(__name__)

#: The reference's name of the library, as JEPSEN_TPU_NATIVE_LIB_DIR
#: holds it, and of the component its fallback counters name.
LIB_NAME = "libjepsen_histenc.so"
COMPONENT = "hist_encode.cc"

# anomaly row codes, per hist_encode.cc's ABI comment
_CODES = {
    1: "duplicate-appends",
    2: "internal",
    3: "duplicate-elements",
    4: "incompatible-order",
    5: "G1a",
    6: "dirty-update",
    7: "phantom-read",
    8: "G1b",
    9: "duplicate-writes",
}

# Fallbacks already warned about (one line per degraded component per
# process; the counter still counts every degraded call).
_warned: set[str] = set()


def count_fallback(what: str) -> None:
    """Count a native→Python degrade in the current tracer's metrics:
    `native_fallback` and `native_fallback.<what>`."""
    from ... import trace
    trace.counter("native_fallback").inc()
    trace.counter(f"native_fallback.{what}").inc()


def note_fallback(what: str, detail: str = "") -> None:
    """Count a native→Python degrade and log ONE warning per component
    per process."""
    count_fallback(what)
    if what not in _warned:
        _warned.add(what)
        log.warning("native %s disabled%s; degrading to the Python path",
                    what, f" ({detail})" if detail else "")


def hist_lib() -> ctypes.CDLL | None:
    """The native history encoder, built on first call. None (counted
    as a fallback) only under JEPSEN_TPU_NO_NATIVE; a build, load or
    ABI failure raises KernelBuildError."""
    if gates.get("JEPSEN_TPU_NO_NATIVE"):
        note_fallback(COMPONENT, "JEPSEN_TPU_NO_NATIVE set")
        return None
    libdir = gates.get("JEPSEN_TPU_NATIVE_LIB_DIR")
    if libdir:
        return _build.load("hist_encode", Path(libdir) / LIB_NAME)
    return _build.load("hist_encode")


def _np(ptr, n, dtype):
    """Copy n elements out of a ctypes pointer into a fresh array (the
    handle is freed right after, so views would dangle)."""
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _witness(code: int, f0: int, f1: int, f2: int, f3: int,
             pre_names: list, wr: bool) -> dict:
    key = pre_names[f0] if 0 <= f0 < len(pre_names) else f0
    if code == 2:                       # internal (f0=row, f1=pre_key)
        k2 = pre_names[f1] if 0 <= f1 < len(pre_names) else f1
        return {"row": f0, "key": k2}
    if wr:
        if code == 5:                   # G1a: reader row + failed writer
            return {"key": key, "value": f1, "writer-index": f2,
                    "row": f3}
        if code == 8:                   # G1b (f1=row, f2=value)
            return {"key": key, "value": f2, "row": f1}
        # duplicate-writes / phantom-read: (key, value, row)
        return {"key": key, "value": f1, "row": f2}
    if code == 1:                       # duplicate-appends
        return {"key": key, "value": f1, "row": f2}
    if code in (3, 4, 8):               # dup-elements / incompat / G1b
        return {"key": key, "row": f1}
    if code in (5, 6):                  # G1a / dirty-update
        return {"key": key, "value": f1, "writer-index": f2}
    return {"key": key, "value": f1}    # phantom-read


def _write_sidecar(L, h, hist_path: Path, sidecar_path) -> None:
    """Persist the encoded sidecar straight from the native handle's
    buffers (store.py's flat layout, no Python round-trip). The layout
    version rides the target filename (`.v2.bin` = dispatch-shaped),
    which store.encoded_cache_path already resolved from the gate.
    Best-effort: a 0 return just leaves the run uncached."""
    if sidecar_path is None:
        return
    version = 2 if str(sidecar_path).endswith(".v2.bin") else 1
    try:
        L.jt_ha_write_sidecar(h, os.fsencode(str(hist_path)),
                              os.fsencode(str(sidecar_path)), version)
    except Exception:
        pass


def _anomalies(L, h, n_anom: int, pre_names: list, wr: bool
               ) -> dict | None:
    """The handle's raw anomaly rows as lean witness dicts, in note
    order; None on an unknown code (ABI drift: don't guess)."""
    out: dict = {}
    anom = _np(L.jt_ha_anomalies(h), n_anom * 5, np.int64).reshape(-1, 5)
    for code, f0, f1, f2, f3 in anom.tolist():
        name = _CODES.get(code)
        if name is None:
            return None
        out.setdefault(name, []).append(
            _witness(code, f0, f1, f2, f3, pre_names, wr=wr))
    return out


def _encode_file(path, wr: bool):
    """(library, handle, history path) for one native encode, or None
    when the library is off, the file is absent or the native side
    declines it."""
    L = hist_lib()
    if L is None:
        return None
    p = Path(path)
    if not p.is_file():
        return None
    fn = L.jt_wr_encode_file if wr else L.jt_ha_encode_file
    h = fn(str(p).encode())
    if not h:
        return None
    return L, h, p


def encode_history_file(path: str | os.PathLike,
                        sidecar_path: str | os.PathLike | None = None
                        ) -> EncodedHistory | None:
    """Encode one history.jsonl natively; None means "use the Python
    path" (library off, file absent, or unrepresentable content).
    `sidecar_path`, when given, also writes the encoded sidecar from
    the native buffers."""
    got = _encode_file(path, wr=False)
    if got is None:
        return None
    L, h, p = got
    try:
        _write_sidecar(L, h, p, sidecar_path)
        dims = (ctypes.c_int64 * 8)()
        L.jt_ha_dims(h, dims)
        n, n_keys, max_pos, n_app, n_rd, n_anom, json_len, _n_pre = dims
        enc = EncodedHistory()
        enc.n = int(n)
        enc.n_keys = int(n_keys)
        enc.max_pos = int(max_pos)
        enc.appends = _np(L.jt_ha_appends(h), n_app * 3,
                          np.int32).reshape(-1, 3)
        enc.reads = _np(L.jt_ha_reads(h), n_rd * 3,
                        np.int32).reshape(-1, 3)
        enc.status = _np(L.jt_ha_status(h), n, np.int32)
        enc.process = _np(L.jt_ha_process(h), n, np.int32)
        enc.invoke_index = _np(L.jt_ha_invoke_index(h), n, np.int64)
        enc.complete_index = _np(L.jt_ha_complete_index(h), n, np.int64)
        enc.op_index = enc.complete_index
        pre_names = json.loads(
            L.jt_ha_pre_key_names_json(h).decode("utf-8")) if json_len \
            else []
        kid_to_pre = _np(L.jt_ha_kid_to_pre(h), n_keys, np.int32)
        enc.key_names = [pre_names[i] for i in kid_to_pre]
        anomalies = _anomalies(L, h, n_anom, pre_names, wr=False)
        if anomalies is None:
            return None
        enc.anomalies = anomalies
        enc.txn_ops = []
        return enc
    finally:
        L.jt_ha_free(h)


def encode_wr_history_file(path: str | os.PathLike,
                           sidecar_path: str | os.PathLike | None = None):
    """Native sibling of wr.encode_wr_history with DEFAULT version-order
    flags (the analyze-store wr sweep's configuration); None means "use
    the Python path". `sidecar_path` as in encode_history_file."""
    from .wr import WrEncoded
    got = _encode_file(path, wr=True)
    if got is None:
        return None
    L, h, p = got
    try:
        _write_sidecar(L, h, p, sidecar_path)
        dims = (ctypes.c_int64 * 8)()
        L.jt_ha_dims(h, dims)
        n, key_count, _mp, _n_app, _n_rd, n_anom, json_len, n_edges = dims
        enc = WrEncoded()
        enc.n = int(n)
        enc.key_count = int(key_count)
        edges = _np(L.jt_ha_edges(h), n_edges * 3, np.int32).reshape(-1, 3)
        enc.edges = [(int(a), int(b), int(c)) for a, b, c in edges]
        enc.status = _np(L.jt_ha_status(h), n, np.int32)
        enc.process = _np(L.jt_ha_process(h), n, np.int32)
        enc.invoke_index = _np(L.jt_ha_invoke_index(h), n, np.int64)
        enc.complete_index = _np(L.jt_ha_complete_index(h), n, np.int64)
        pre_names = json.loads(
            L.jt_ha_pre_key_names_json(h).decode("utf-8")) if json_len \
            else []
        anomalies = _anomalies(L, h, n_anom, pre_names, wr=True)
        if anomalies is None:
            return None
        enc.anomalies = anomalies
        enc.txn_ops = []
        return enc
    finally:
        L.jt_ha_free(h)
