"""Fold pricing: the part of `jepsen_tpu/parallel/folding.py` the
planner's admission lever needs (`fold_cost`). The fold dispatcher
itself belongs to the serve daemon, which the port does not have."""

from __future__ import annotations


def fold_cost(n_txns: int, multiple: int = 128) -> int:
    """The padded closure footprint one history contributes to a
    shared bucket: T_pad² cells with the txn axis rounded up to the
    kernel's row tile — `bucket_by_length`'s unit, restated without
    torch so admission can price a request before any device work.
    This is the analytic proxy; with JEPSEN_TPU_PLANNER on,
    `planner.admission_cost` prices with the fitted cost model
    normalized back to this same cell unit, with this function as its
    bit-exact cold-start fallback."""
    t = max(int(n_txns), 1)
    t = max(multiple, ((t + multiple - 1) // multiple) * multiple)
    return t * t
