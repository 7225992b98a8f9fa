"""The native per-key split (`csrc/hist_encode.cc`'s jt_ks_* pass).

The port's copy of `split_key_ids` from `jepsen_tpu/native_lib.py`;
the rest of that module (the graph kernels) the port does not carry
(ROADMAP "Not queued"), and the history encoder's bridge is
`checker/elle/native_encode.py`, whose library this reuses.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os

import numpy as np

from .checker.elle.native_encode import (count_fallback, hist_lib,
                                         note_fallback)

log = logging.getLogger(__name__)


def split_key_ids(path) -> tuple[list, np.ndarray] | None:
    """Per-op [key value] split ids for a history.jsonl, from the
    native splitter (hist_encode.cc's jt_ks_* ABI): returns
    (keys, key_ids) where `keys` are the lifted key values in
    first-seen order and `key_ids` is an int32 array aligned with the
    file's op lines (-1 = un-lifted op). None means "use the Python
    splitter" (JEPSEN_TPU_NO_NATIVE set, file absent, or content whose
    lift / key-equality semantics the native pass can't replicate). A
    library that cannot be built or loaded raises KernelBuildError, as
    every native path of the port does."""
    L = hist_lib()
    if L is None:
        return None
    h = L.jt_ks_split_file(os.fsencode(path))
    if not h:
        # benign: the library is healthy, this file's lift semantics
        # just aren't natively replicable — count, don't warn
        count_fallback("split_key_ids")
        log.debug("native split declined %s", path)
        return None
    try:
        dims = (ctypes.c_int64 * 4)()
        L.jt_ks_dims(h, dims)
        n_ops, n_keys, json_len, _lifted = dims
        if n_ops == 0:
            ids = np.zeros(0, np.int32)
        else:
            ids = np.ctypeslib.as_array(
                L.jt_ks_key_ids(h), shape=(int(n_ops),)).copy()
        keys = json.loads(
            L.jt_ks_key_names_json(h).decode("utf-8")) if json_len \
            else []
        if len(keys) != int(n_keys):
            note_fallback("split_key_ids", "key-name/ids ABI drift")
            return None  # ABI drift: don't guess
        return keys, ids
    finally:
        L.jt_ks_free(h)
