"""Elle-style list-append checking: the single-run checker and its
verdict.

Counterpart of `jepsen_tpu/checker/elle/__init__.py` (the reference's
jepsen.tests.cycle.append checker, append.clj:11-22): `AppendChecker`
over histories whose op values are transactions of [f k v] micro-ops,
with two interchangeable backends:

  backend="cpu"  hash-join edges + Tarjan SCC + BFS witnesses (the oracle)
  backend="tpu"  the device path: dense edge scatter and the closure by
                 `closure_square` (`parallel.check_long_history`; many
                 histories through `parallel.check_bucketed`), on the
                 checker's `device` (default cuda); "auto" is this one
                 too (`devices.resolve_backend`)

Device flags are refined into witness cycles by the host pass
(`artifacts.device_host_refine`). `render_verdict` turns host-detected
anomalies plus cycles into the verdict the batch sweep
(`cli.analyze_store`) writes too.
"""

from __future__ import annotations

from typing import Any, Iterable

from .. import Checker
from . import graph as g
from .encode import EncodedHistory, encode_history

# NOTE: `kernels`, `parallel` and torch are imported where used: this
# package init is on every ingest pool worker's import path (spawn
# re-imports it to encode histories), and a worker must not pay for
# torch.

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


#: The AppendChecker's default `prohibited` set (G1 + G2), which the
#: analyze-store sweep applies to every history.
APPEND_PROHIBITED = expand_anomalies(("G1", "G2"))


def cycle_anomalies_cpu(enc: EncodedHistory, realtime: bool = False,
                        process_order: bool = False) -> dict:
    edges = g.build_edges(enc, process_order=process_order, realtime=realtime)
    return g.classify_cycles(enc.n, edges)


def cycle_anomalies_tpu(enc: EncodedHistory, realtime: bool = False,
                        process_order: bool = False, device=None,
                        square=None, bucket_log: list | None = None
                        ) -> dict:
    """The device path's anomaly flags for one history, on `device`'s
    visible devices (`parallel.check_long_history`: the dense closure
    over their `sp_mesh`, or the SCC condensation past its limit);
    `square` and `bucket_log` as there."""
    from ... import parallel
    return parallel.check_long_history(
        enc, device, realtime=realtime, process_order=process_order,
        square=square, bucket_log=bucket_log)


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


class AppendChecker(Checker):
    """Checker for list-append histories.

    Options (the reference's):
      anomalies:      which anomaly classes to prohibit (default G1+G2,
                      like the reference wrapper append.clj:14-16)
      backend:        "auto" | "tpu" (the device path) | "cpu" (the
                      host oracle); see `devices.resolve_backend`
      realtime:       add realtime (strict-serializability) edges
      process_order:  add per-process order edges
    and the port's:
      device:         where the device path runs (default cuda)
      square:         replaces the closure squaring (e.g.
                      `closure_square_ref`, the plain version)
      bucket_log:     gets one dict per device dispatch (see
                      `parallel.check_bucketed`)
    """

    def __init__(self, anomalies: Iterable[str] = ("G1", "G2"),
                 backend: str = "auto", realtime: bool = False,
                 process_order: bool = False, device=None, square=None,
                 bucket_log: list | None = None):
        self.prohibited = expand_anomalies(anomalies)
        self.backend = backend
        self.realtime = realtime
        self.process_order = process_order
        self.device = device
        self.square = square
        self.bucket_log = bucket_log

    def check(self, test, history, opts):
        from ...devices import resolve_backend
        from . import artifacts
        backend = resolve_backend(self.backend)
        enc = encode_history(history)
        kw = dict(realtime=self.realtime, process_order=self.process_order)
        divergent: dict = {}
        if backend == "tpu":
            cycles = cycle_anomalies_tpu(
                enc, device=self.device, square=self.square,
                bucket_log=self.bucket_log, **kw)
            if cycles:
                # the device path returns anomaly FLAGS; a flagged
                # history runs the host pass for its witness cycles
                cycles, divergent = artifacts.device_host_refine(
                    cycles, lambda: cycle_anomalies_cpu(enc, **kw))
        else:
            cycles = cycle_anomalies_cpu(enc, **kw)
        verdict = render_verdict(enc, cycles, self.prohibited)
        return artifacts.attach(verdict, divergent, test, opts)

    def render_failure(self, test, history, res, opts) -> None:
        """Per-key artifact hook: `independent.checker` calls this with
        the key's subdirectory opts for each invalid batch result, so
        batched dispatch still leaves elle/ witness artifacts for the
        keys that failed."""
        from . import artifacts
        artifacts.attach(res, res.get("device-host-divergence", {}),
                         test, opts)

    def check_batch(self, test, histories: list, opts) -> list[dict]:
        """Check MANY histories in one bucketed device sweep
        (`parallel.check_bucketed`) — the route `independent.checker`
        takes, over `parallel.dp_mesh` of the visible devices of the
        checker's `device` kind. Flagged histories re-run the host oracle
        for witness cycles; verdicts match check() minus store
        artifacts. A history
        the dispatcher abandoned (a `supervisor.Quarantined`: OOM
        backdown exhausted, watchdog) gets its unknown verdict."""
        from ...devices import resolve_backend
        from . import artifacts
        backend = resolve_backend(self.backend)
        encs = [encode_history(h) for h in histories]
        kw = dict(realtime=self.realtime,
                  process_order=self.process_order)
        if backend != "tpu":
            return [render_verdict(e, cycle_anomalies_cpu(e, **kw),
                                   self.prohibited) for e in encs]
        from ... import parallel
        from ...devices import default_devices
        # dp over every visible device of the checker's kind (one card:
        # the single-device path)
        cycles_list = parallel.check_bucketed(
            encs, mesh=parallel.dp_mesh(default_devices(self.device)),
            square=self.square, bucket_log=self.bucket_log, **kw)
        out = []
        for enc, cycles in zip(encs, cycles_list):
            if hasattr(cycles, "verdict"):
                out.append(cycles.verdict())
                continue
            divergent: dict = {}
            if cycles:
                cycles, divergent = artifacts.device_host_refine(
                    cycles,
                    lambda enc=enc: cycle_anomalies_cpu(enc, **kw))
            verdict = render_verdict(enc, cycles, self.prohibited)
            if divergent:  # either direction means a path is wrong
                verdict["device-host-divergence"] = divergent
            out.append(verdict)
        return out


def append_checker(anomalies: Iterable[str] = ("G1", "G2"),
                   backend: str = "auto", realtime: bool = False,
                   process_order: bool = False, **kw) -> Checker:
    return AppendChecker(anomalies, backend, realtime, process_order, **kw)
