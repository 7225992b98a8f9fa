"""Elle-style anomaly artifacts: an `elle/` directory under the run
dir with one file per anomaly class plus an anomalies.edn summary.

The port's copy of `jepsen_tpu/checker/elle/artifacts.py`; the files
are the reference's, byte for byte.

The reference's checker emits explained anomalies into an elle/
subdirectory of the store (jepsen/src/jepsen/tests/cycle/append.clj:
17-22, elle's :directory option); re-checking a stored run must leave
the same breadcrumbs here. Each <anomaly>.txt renders the witness
cycles txn-by-txn; flag-only anomalies (host-detected, e.g. internal)
render their op evidence from the encoded history's notes.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Callable

from ... import edn

log = logging.getLogger(__name__)


def _render_txn(op: Any) -> str:
    if isinstance(op, dict):
        return edn.dumps({k: op.get(k) for k in
                          ("process", "type", "f", "value", "index")
                          if k in op}, keywordize=True)
    return repr(op)


def render_anomaly(name: str, witness: Any) -> str:
    """One anomaly class -> human-readable explanation text."""
    lines = [f"Anomaly: {name}", ""]
    if witness is True:
        lines.append("Present (flag-only: no witness cycle recorded).")
    elif isinstance(witness, list):
        for i, w in enumerate(witness):
            if isinstance(w, dict) and "cycle-txns" in w:
                lines.append(f"Cycle {i + 1}:")
                cycle = w["cycle-txns"]
                closed = len(cycle) > 1 and cycle[0] == cycle[-1]
                for op in (cycle[:-1] if closed else cycle):
                    lines.append(f"  {_render_txn(op)}")
                if cycle:
                    lines.append(f"  ... and back to "
                                 f"{_render_txn(cycle[0])}")
            else:
                lines.append(f"Witness {i + 1}: {w!r}")
            lines.append("")
    else:
        lines.append(repr(witness))
    lines.append("")
    return "\n".join(lines)


def write_artifacts(anomalies: dict, directory: Path) -> Path:
    """Write elle/-style artifacts for a verdict's anomalies map.
    Returns the directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    summary = {}
    for name, witness in sorted(anomalies.items()):
        (directory / f"{name}.txt").write_text(
            render_anomaly(name, witness))
        summary[name] = (True if witness is True
                         else f"{len(witness)} witness(es)"
                         if isinstance(witness, list) else repr(witness))
    (directory / "anomalies.edn").write_text(
        edn.dumps(summary, keywordize=True) + "\n")
    return directory


def store_dir(test: dict, opts: dict | None) -> Path | None:
    """The elle/ directory for this (possibly independent-keyed) check,
    or None when the test has no store. Shares perf's
    subdirectory-resolution rule so per-key layouts can't drift."""
    from ..perf import store_path
    return store_path(test, opts or {}, "elle")


def device_host_refine(device_cycles: dict,
                       host_fn: Callable[[], dict]) -> tuple[dict, dict]:
    """Turn device anomaly FLAGS into host witness cycles. Parity runs
    both ways (SURVEY.md §4.3): a device flag the host can't reproduce
    stays in the result (flag-only), and an anomaly the host finds that
    the device missed is equally a divergence — both are reported,
    since either direction means one of the two paths is wrong."""
    host = host_fn()
    device_only = sorted(set(device_cycles) - set(host))
    host_only = sorted(set(host) - set(device_cycles))
    merged = dict(host)
    for name in device_only:
        log.warning("device flagged %s but host pass found no witness "
                    "— keeping the flag (kernel/host divergence?)", name)
        merged[name] = True
    for name in host_only:
        log.warning("host pass found %s the device did not flag "
                    "(kernel false negative?)", name)
    divergence = {}
    if device_only:
        divergence["device-only"] = device_only
    if host_only:
        divergence["host-only"] = host_only
    return merged, divergence


def attach(verdict: dict, divergent: dict | list, test: dict,
           opts: dict | None) -> dict:
    """Record divergences and write the elle/ artifacts for any
    anomalies in the verdict."""
    if divergent:
        verdict["device-host-divergence"] = divergent
    if verdict.get("anomalies"):
        d = store_dir(test, opts)
        if d is not None:
            write_artifacts(verdict["anomalies"], d)
            verdict["elle-dir"] = str(d)
    return verdict
