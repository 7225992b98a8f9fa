"""Checkers of the PyTorch port: Elle (`checker.elle`) and
linearizability (`checker.knossos`, through `Linearizable` here).

Counterpart of the part of `jepsen_tpu/checker/__init__.py` the batch
sweeps use: `merge_valid` (invalid < unknown < valid), the
`Linearizable` checker with its tiered device routing, and what the
stored-checker path runs (`check_safe`, `unbridled_optimism`).
"""

from __future__ import annotations

import time
import traceback
from typing import Any

from . import models as model

VALID_PRIORITIES = {True: 2, "unknown": 1, False: 0}


def merge_valid(valids: list) -> Any:
    """Merge validity values: false wins over unknown wins over true."""
    out: Any = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid? value")
        if VALID_PRIORITIES[v] < VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    def check(self, test: dict, history: list, opts: dict) -> dict | None:
        raise NotImplementedError


def check_safe(checker: Checker, test: dict, history: list,
               opts: dict | None = None) -> dict:
    """Like check, but returns exceptions as {"valid?": "unknown"}
    results. Every check runs inside a trace span named after the
    checker class."""
    from .. import trace
    try:
        with trace.span(f"check:{type(checker).__name__}",
                        ops=len(history)):
            r = checker.check(test, history, opts or {})
        return r if r is not None else {"valid?": True}
    except Exception:
        return {"valid?": "unknown", "error": traceback.format_exc()}


class UnbridledOptimism(Checker):
    """Everything is awesome."""

    def check(self, test, history, opts):
        return {"valid?": True}


def unbridled_optimism() -> Checker:
    return UnbridledOptimism()


class Linearizable(Checker):
    """Linearizability checker over a data-type model — the reference's
    `checker/linearizable` with `backend="tpu"`: a fresh CAS register
    goes through the tiered device path on `device` (default cuda; the
    CPU only when asked), every other model through the CPU engine
    (`knossos.analysis`: native WGL for a fresh mutex, the Python
    engine otherwise).

    `frontier` is the bounded frontier's arena size (None: the
    JEPSEN_TPU_FRONTIER gate, default 512). `dense_scan`
    replaces the dense grid's scan (e.g. `dense.scan_dense_ref` in
    place of the `knossos_dense_scan` kernel)."""

    def __init__(self, m: model.Model | None = None, device=None,
                 frontier: int | None = None, dense_scan=None):
        self.model = m if m is not None else model.cas_register()
        self.device = device
        if frontier is None:
            from .. import gates
            frontier = gates.get("JEPSEN_TPU_FRONTIER")
        self.frontier = frontier
        self.dense_scan = dense_scan

    def _cpu(self, history: list, search_stats: dict | None = None) -> dict:
        from . import knossos
        return knossos.analysis(self.model, history,
                                search_stats=search_stats)

    def check(self, test, history, opts):
        return self.check_batch(test, [history], opts)[0]

    def check_batch(self, test, histories: list[list], opts,
                    tier_log: list | None = None,
                    stats_out: list | None = None) -> list[dict]:
        """Check many histories at once, the device tiers batched over
        all of them.

        Device routing is tiered: (1) the dense configuration grid
        (`.knossos.dense`, exact verdicts) for histories inside its
        budgets (14 pending slots, 64 values); (2) histories past it go
        to the bounded sorted frontier (`.knossos.kernels`) unless its
        feasibility gate predicts overflow; (3) those, the frontier's
        ":frontier-overflow" unknowns and anything not register-shaped
        run on the CPU WGL oracle. Verdicts only ever degrade toward
        the oracle, never diverge from it. `tier_log` gets one dict per
        tier that ran (tier, histories, seconds). `stats_out`, when given,
        is extended with one search-telemetry dict per history (grid or
        frontier occupancy from the device tiers, the WGL counters from
        the oracle), or None where an engine reported nothing."""
        if not (type(self.model) is model.CASRegister
                and self.model.value is None):
            out = []
            for hs in histories:
                sd: dict | None = {} if stats_out is not None else None
                out.append(self._cpu(hs, search_stats=sd))
                if stats_out is not None:
                    stats_out.append(sd or None)
            return out
        return self._device_batch(histories, tier_log, stats_out)

    def _device_batch(self, histories: list[list],
                      tier_log: list | None = None,
                      stats_out: list | None = None) -> list[dict]:
        from ..devices import resolve_device
        from .knossos import dense, kernels
        from .knossos import encode as kenc

        dev = resolve_device(self.device)
        dense_encs, dense_idx = [], []
        front_encs, front_idx = [], []
        cpu_idx = []
        # every simultaneously-open write or unknown-value read doubles
        # the frontier, every open cas or known-value read about half
        # doubles it: a history whose estimated closure can't fit the
        # arena goes straight to the oracle
        budget = 2 * (max(self.frontier, 1).bit_length() - 1)
        for i, hs in enumerate(histories):
            try:
                dense_encs.append(dense.encode_dense_history(hs))
                dense_idx.append(i)
            except kenc.EncodingError:
                try:
                    enc = kenc.encode_register_history(hs)
                    if enc.half_doublings_peak > budget:
                        cpu_idx.append(i)
                    else:
                        front_encs.append(enc)
                        front_idx.append(i)
                except kenc.EncodingError:
                    cpu_idx.append(i)
        results: list[dict | None] = [None] * len(histories)

        def note(tier: str, n: int, t0: float) -> None:
            if tier_log is not None and n:
                tier_log.append({"tier": tier, "histories": n,
                                 "seconds": time.perf_counter() - t0})

        with_stats = stats_out is not None
        stats: list = [None] * len(histories)
        t0 = time.perf_counter()
        if dense_encs:
            ds: list | None = [] if with_stats else None
            for j, (i, r) in enumerate(zip(
                    dense_idx, dense.check_encoded_dense_batch(
                        dense_encs, dev, scan=self.dense_scan,
                        stats_out=ds))):
                results[i] = r
                if ds is not None:
                    stats[i] = ds[j]
        note("tpu-dense", len(dense_encs), t0)
        t0 = time.perf_counter()
        if front_encs:
            fs: list | None = [] if with_stats else None
            for j, (i, r) in enumerate(zip(
                    front_idx, kernels.check_encoded_batch(
                        front_encs, frontier=self.frontier, device=dev,
                        stats_out=fs))):
                if r.get("valid?") == "unknown":
                    cpu_idx.append(i)  # overflow: exact answer from CPU
                else:
                    results[i] = r
                    if fs is not None:
                        stats[i] = fs[j]
        note("tpu-jit", len(front_encs), t0)
        t0 = time.perf_counter()
        for i in cpu_idx:
            sd: dict | None = {} if with_stats else None
            results[i] = self._cpu(histories[i], search_stats=sd)
            if with_stats:
                stats[i] = sd or None
        note("wgl", len(cpu_idx), t0)
        if with_stats:
            stats_out.extend(stats)
        return results  # type: ignore[return-value]


def linearizable(m: model.Model | None = None, **kw) -> Checker:
    return Linearizable(m, **kw)
