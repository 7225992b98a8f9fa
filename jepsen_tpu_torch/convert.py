"""Carrying the JAX package's state across to the port.

This system has no weights: the state a check runs on is the packed
batch (`kernels.pack_batch`) and the `EncodedHistory` it is packed
from, or, for rw-register runs, the `WrEncoded` whose edge lists
`kernels.pack_edge_matrices` packs. Both are plain numpy on either side, so carrying them across is
a copy into the port's own types — which lets a test feed the JAX
function and its port counterpart identical inputs. Nothing here
imports the JAX package: the reference objects arrive as numpy arrays,
dicts and plain attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from .checker.elle.encode import EncodedHistory
from .checker.elle.wr import WrEncoded
from .checker.elle.kernels import BatchShape, batch_to_device

#: The EncodedHistory fields a check reads.
ENCODED_FIELDS = ("n", "n_keys", "max_pos", "appends", "reads", "status",
                  "process", "invoke_index", "complete_index", "anomalies",
                  "key_names")


def from_reference_batch(packed: dict, device: torch.device) -> dict:
    """A reference packed batch (`pack_batch` / `synth_valid_batch`
    output: numpy arrays plus a `shape` with n_txns, n_appends,
    n_reads, n_keys and max_pos) as the port's device-resident batch."""
    s = packed["shape"]
    shape = BatchShape(n_txns=int(s.n_txns), n_appends=int(s.n_appends),
                       n_reads=int(s.n_reads), n_keys=int(s.n_keys),
                       max_pos=int(s.max_pos))
    return batch_to_device({**packed, "shape": shape}, device)


def encoded_from_arrays(*, n, n_keys, max_pos, appends, reads, status,
                        process, invoke_index, complete_index,
                        anomalies=None, key_names=None) -> EncodedHistory:
    """A port EncodedHistory from a reference one's fields
    (`{f: getattr(ref, f) for f in ENCODED_FIELDS}`), arrays copied."""
    return EncodedHistory(
        n=int(n), n_keys=int(n_keys), max_pos=int(max_pos),
        appends=np.array(appends, np.int32).reshape(-1, 3),
        reads=np.array(reads, np.int32).reshape(-1, 3),
        status=np.array(status, np.int32),
        process=np.array(process, np.int32),
        invoke_index=np.array(invoke_index, np.int64),
        complete_index=np.array(complete_index, np.int64),
        op_index=np.array(complete_index, np.int64),
        anomalies=dict(anomalies or {}),
        key_names=list(key_names or []))


#: The WrEncoded fields a check and its verdict read.
WR_ENCODED_FIELDS = ("n", "edges", "status", "process", "invoke_index",
                     "complete_index", "anomalies", "key_count")


def wr_encoded_from_fields(*, n, edges, status, process, invoke_index,
                           complete_index, anomalies=None,
                           key_count=0) -> WrEncoded:
    """A port WrEncoded from a reference one's fields
    (`{f: getattr(ref, f) for f in WR_ENCODED_FIELDS}`), arrays and the
    edge list copied."""
    return WrEncoded(
        n=int(n), edges=[tuple(int(x) for x in e) for e in edges],
        status=np.array(status, np.int32),
        process=np.array(process, np.int32),
        invoke_index=np.array(invoke_index, np.int64),
        complete_index=np.array(complete_index, np.int64),
        anomalies=dict(anomalies or {}), key_count=int(key_count))
