"""Elle-style list-append checking: verdict rendering.

Counterpart of `jepsen_tpu/checker/elle/__init__.py`. The device path
lives in `kernels` (edge build, closure, anomaly flags) and
`closure_square` (the hand kernel); this module turns host-detected
anomalies plus the kernels' cycle flags into a checker verdict.
"""

from __future__ import annotations

from typing import Any, Iterable

from .encode import EncodedHistory

# Anomalies that invalidate a history regardless of requested level —
# they indicate corrupted data structures, not isolation-level choices.
ALWAYS_INVALID = frozenset({
    "internal", "incompatible-order", "duplicate-elements", "dirty-update",
    "phantom-read", "duplicate-appends", "G0",
})

ANOMALY_EXPANSION = {
    "G0": {"G0"},
    "G1": {"G0", "G1a", "G1b", "G1c"},
    "G1a": {"G1a"},
    "G1b": {"G1b"},
    "G1c": {"G1c"},
    "G2": {"G-single", "G2-item"},
    "G-single": {"G-single"},
    "G2-item": {"G2-item"},
}


def expand_anomalies(wanted: Iterable[str]) -> frozenset:
    out: set = set()
    for a in wanted:
        out |= ANOMALY_EXPANSION.get(a, {a})
    return frozenset(out)


#: The reference AppendChecker's default `prohibited` set (G1 + G2),
#: which its analyze-store sweep applies to every history.
APPEND_PROHIBITED = expand_anomalies(("G1", "G2"))


def render_verdict(enc: EncodedHistory, cycles: dict,
                   prohibited: frozenset = APPEND_PROHIBITED) -> dict:
    """Combine host-detected and cycle anomalies into a checker verdict."""
    anomalies: dict = dict(enc.anomalies)
    for name, witness in cycles.items():
        if witness is True:
            anomalies[name] = True
        else:
            anomalies[name] = [
                {"cycle-txns": [_witness_op(enc, r) for r in witness]}]
    bad = {a for a in anomalies
           if a in prohibited or a in ALWAYS_INVALID}
    if enc.n == 0:
        return {"valid?": "unknown",
                "anomaly-types": ["empty-transaction-graph"],
                "anomalies": {}, "txn-count": 0}
    return {
        "valid?": not bad,
        "anomaly-types": sorted(anomalies),
        "anomalies": anomalies,
        "txn-count": enc.n,
        "key-count": enc.n_keys,
    }


def _witness_op(enc: EncodedHistory, row: int) -> Any:
    if 0 <= row < len(enc.txn_ops):
        return enc.txn_ops[row]
    return row
