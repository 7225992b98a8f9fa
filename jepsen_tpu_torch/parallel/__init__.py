"""Bucketed batch dispatch: many encoded histories, one device.

Counterpart of `jepsen_tpu/parallel/__init__.py`, synchronous: each
length bucket is packed on the host, copied to the device, checked, and
its flags read back before the next bucket starts. Results come back in
input order. The reference's async pipeline, OOM backdown, watchdog and
AOT cache are not ported yet.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from ..checker.elle import kernels as K

# Above this txn count the dense [T,T] closure no longer fits a device;
# the reference switches to SCC condensation there (not ported yet).
DENSE_TXN_LIMIT = 32_768


def bucket_by_length(encs: Sequence, *, multiple: int = 128,
                     budget_cells: int = 1 << 27) -> list[list[int]]:
    """Partition history indices into buckets of similar padded txn
    count. Each bucket satisfies B * T_pad² <= budget_cells, where T_pad
    is the bucket max rounded up to `multiple` and B the bucket size.
    Returns buckets of indices into encs, longest histories first."""
    order = sorted(range(len(encs)), key=lambda i: -encs[i].n)
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_tpad = 0
    for i in order:
        tpad = max(K.pad_to(max(encs[i].n, 1), multiple), 1)
        t = max(cur_tpad, tpad)
        if cur and (len(cur) + 1) * t * t > budget_cells:
            buckets.append(cur)
            cur, cur_tpad = [], 0
            t = tpad
        cur.append(i)
        cur_tpad = t
    if cur:
        buckets.append(cur)
    return buckets


def check_bucketed(encs: Sequence, device: torch.device, *,
                   classify: bool = True, realtime: bool = False,
                   process_order: bool = False,
                   budget_cells: int = 1 << 27,
                   two_pass: bool | None = None,
                   fused: bool = True,
                   square: K.Square | None = None,
                   bucket_log: list | None = None) -> list[dict]:
    """Check many encoded histories bucketed by length on `device`: one
    bucket at a time (pack → copy → kernels → flags), results returned
    in input order as {anomaly-name: True} dicts.

    With classify=True the default is the fused detect/classify kernel.
    two_pass=True (the default when fused=False) sweeps every bucket in
    detect mode and re-checks ONLY flagged histories with the chained
    classification closures; verdicts are identical either way.

    `square` replaces the closure squaring (see kernels.check_batch_device).
    `bucket_log`, when given, gets one dict per bucket: its history
    count, padded T, the squarings of each closure and the seconds the
    bucket took from packing to flags on the host."""
    if not len(encs):
        return []
    if two_pass is None:
        two_pass = classify and not fused
    if classify and two_pass:
        detect = check_bucketed(encs, device, classify=False,
                                realtime=realtime,
                                process_order=process_order,
                                budget_cells=budget_cells, square=square,
                                bucket_log=bucket_log)
        flagged = [i for i, f in enumerate(detect) if f]
        if not flagged:
            return detect
        full = check_bucketed([encs[i] for i in flagged], device,
                              classify=True, realtime=realtime,
                              process_order=process_order,
                              budget_cells=budget_cells, two_pass=False,
                              fused=False, square=square,
                              bucket_log=bucket_log)
        out = list(detect)
        for i, r in zip(flagged, full):
            out[i] = r
        return out
    out: list[dict | None] = [None] * len(encs)
    for bucket in bucket_by_length(encs, budget_cells=budget_cells):
        t0 = time.perf_counter()
        group = [encs[i] for i in bucket]
        packed = K.pack_batch(group)
        batch = K.batch_to_device(packed, device)
        rounds: list[int] = []
        flags = K.check_batch_device(
            batch, classify=classify, realtime=realtime,
            process_order=process_order, fused=fused, square=square,
            rounds=rounds).tolist()
        for j, w in zip(bucket, flags):
            out[j] = K.flags_to_names(w)
        if bucket_log is not None:
            bucket_log.append({"histories": len(bucket),
                               "t_pad": packed["shape"].n_txns,
                               "closure_rounds": rounds,
                               "seconds": time.perf_counter() - t0})
    return out  # type: ignore[return-value]
