"""Checkers of the PyTorch port: Elle (`checker.elle`) and
linearizability (`checker.knossos`, through `Linearizable` here).

Counterpart of the part of `jepsen_tpu/checker/__init__.py` the batch
sweeps use: `merge_valid` (invalid < unknown < valid) and the
`Linearizable` checker with its tiered device routing.
"""

from __future__ import annotations

import time
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


class Linearizable(Checker):
    """Linearizability checker over a data-type model — the reference's
    `checker/linearizable` with `backend="tpu"`: a fresh CAS register
    goes through the tiered device path on `device` (default cuda; the
    CPU only when asked), every other model through the CPU engine
    (`knossos.analysis`: native WGL for a fresh mutex, the Python
    engine otherwise).

    `frontier` is the bounded frontier's arena size. `dense_scan`
    replaces the dense grid's scan (e.g. `dense.scan_dense_ref` in
    place of the `knossos_dense_scan` kernel)."""

    def __init__(self, m: model.Model | None = None, device=None,
                 frontier: int = 512, dense_scan=None):
        self.model = m if m is not None else model.cas_register()
        self.device = device
        self.frontier = frontier
        self.dense_scan = dense_scan

    def _cpu(self, history: list) -> dict:
        from . import knossos
        return knossos.analysis(self.model, history)

    def check(self, test, history, opts):
        return self.check_batch(test, [history], opts)[0]

    def check_batch(self, test, histories: list[list], opts,
                    tier_log: list | None = None) -> list[dict]:
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
        tier that ran (tier, histories, seconds)."""
        if not (type(self.model) is model.CASRegister
                and self.model.value is None):
            return [self._cpu(hs) for hs in histories]
        return self._device_batch(histories, tier_log)

    def _device_batch(self, histories: list[list],
                      tier_log: list | None = None) -> list[dict]:
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

        t0 = time.perf_counter()
        if dense_encs:
            for i, r in zip(dense_idx, dense.check_encoded_dense_batch(
                    dense_encs, dev, scan=self.dense_scan)):
                results[i] = r
        note("tpu-dense", len(dense_encs), t0)
        t0 = time.perf_counter()
        if front_encs:
            for i, r in zip(front_idx, kernels.check_encoded_batch(
                    front_encs, frontier=self.frontier, device=dev)):
                if r.get("valid?") == "unknown":
                    cpu_idx.append(i)  # overflow: exact answer from CPU
                else:
                    results[i] = r
        note("tpu-jit", len(front_encs), t0)
        t0 = time.perf_counter()
        for i in cpu_idx:
            results[i] = self._cpu(histories[i])
        note("wgl", len(cpu_idx), t0)
        return results  # type: ignore[return-value]


def linearizable(m: model.Model | None = None, **kw) -> Checker:
    return Linearizable(m, **kw)
