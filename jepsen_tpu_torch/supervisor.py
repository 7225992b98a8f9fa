"""The quarantine policy of a sweep: a run the sweep abandons is
recorded as `valid? unknown`, never as valid or invalid, and the sweep
goes on.

Counterpart of `jepsen_tpu/supervisor.py`, of which only
`quarantine_verdict` is copied so far; the retry, OOM backdown,
watchdog, fault injection and strict mode are not ported yet.
"""

from __future__ import annotations


def quarantine_verdict(error, stage: str,
                       checker: str | None = None) -> dict:
    """The one shape every quarantine path records: validity is
    *unknown* (exit code 2), never false — an abandoned history is not
    evidence of an anomaly — with the cause preserved for triage."""
    res = {"valid?": "unknown", "error": str(error)[:500],
           "quarantined": stage}
    if checker is not None:
        res["checker"] = checker
    return res
