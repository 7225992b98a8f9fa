"""Tenant admission for the verdict daemon.

Counterpart of `jepsen_tpu/serve/scheduler.py`, the same lanes,
picks and backpressure.

One `Admission` object owns every tenant's scheduling state: a
`parallel.folding.Lane` per (tenant, checker) pair, the per-tenant
queue-depth cap (JEPSEN_TPU_SERVE_MAX_QUEUE), and the weighted
deficit-round-robin fold selection (`parallel.folding.plan_fold`) the
daemon's dispatch loop pulls from. Admission control is priced by
PREDICTED WORK, not request count — the arxiv 1908.04509 posture: one
tenant's 5000-txn histories cost it ~1500x the fold share of another
tenant's 128-txn ones, so the queue-depth cap plus the cost-priced
fairness bound both dimensions a tenant can hog. The price is
`folding.fold_cost`'s T_pad² cell proxy by default; with
JEPSEN_TPU_PLANNER on, the daemon prices with the fitted cost model's
predicted device seconds normalized to the SAME cell unit
(`planner.admission_cost`), so budgets and the DRR below are
unchanged either way.

Backpressure is EXPLICIT: a full lane rejects the request and the
daemon answers a `retry-after` frame with a depth-derived delay hint —
a tenant is never silently dropped, and the admitted set is exactly
the journal-or-ack set.

Thread model: reader threads admit, the scheduler thread plans folds;
both go through the one condition variable here. Fold planning mutates
the lanes' deques — pure computation, done under the same condition so
no partially-planned fold is ever observable.
"""

from __future__ import annotations

import threading
import time

from .. import gates

#: Fold geometry: at most this many histories per fold, so one fold's
#: verdict latency stays bounded even when the queues are deep (the
#: cell budget bounds the big-history dimension; this bounds the
#: many-tiny-histories one).
DEFAULT_MAX_FOLD = 64


def parse_weights(spec: str | None = None) -> dict[str, float]:
    """`tenant=weight,...` from JEPSEN_TPU_SERVE_WEIGHTS (or an
    explicit spec). Malformed or non-positive entries are skipped —
    a bad weights string degrades to equal shares, never a crash."""
    if spec is None:
        spec = gates.get("JEPSEN_TPU_SERVE_WEIGHTS")
    out: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, raw = part.partition("=")
        try:
            w = float(raw.strip())
        except ValueError:
            continue
        if w > 0:
            out[name.strip()] = w
    return out


def max_queue_depth() -> int:
    v = gates.get("JEPSEN_TPU_SERVE_MAX_QUEUE")
    return max(1, int(v)) if v is not None else 256


class Request:
    """One admitted (or about-to-be-admitted) check request."""

    __slots__ = ("tenant", "rid", "checker", "enc", "cost", "t0",
                 "conn")

    def __init__(self, tenant: str, rid: str, checker: str, enc,
                 cost: int, conn=None):
        self.tenant = tenant
        self.rid = rid
        self.checker = checker
        self.enc = enc          # encoding, or the encode Exception
        self.cost = cost
        self.t0 = time.perf_counter()
        self.conn = conn


class Admission:
    """The daemon's admission queue set (see module docstring)."""

    def __init__(self, weights: dict[str, float] | None = None,
                 max_queue: int | None = None):
        self._cv = threading.Condition()
        self._lanes: dict[tuple[str, str], object] = {}
        self._weights = dict(weights if weights is not None
                             else parse_weights())
        self._max_queue = max_queue if max_queue is not None \
            else max_queue_depth()
        self._pending = 0
        self._closed = False

    @property
    def max_queue(self) -> int:
        """This instance's per-tenant depth cap (the gate default, or
        the owner's explicit override)."""
        return self._max_queue

    # -- tenant registry ---------------------------------------------------

    def weight_of(self, tenant: str, requested=None) -> float:
        """The effective fairness weight: the operator's gate spec
        wins; a client-requested weight applies only for tenants the
        spec doesn't name (a tenant must not out-rank the operator)."""
        w = self._weights.get(tenant)
        if w is None and requested is not None:
            try:
                w = float(requested)
            except (TypeError, ValueError):
                w = None
        return max(float(w), 1e-3) if w and w > 0 else 1.0

    def _lane(self, tenant: str, checker: str, requested=None):
        from ..parallel import folding
        key = (tenant, checker)
        ln = self._lanes.get(key)
        if ln is None:
            ln = folding.Lane(tenant, self.weight_of(tenant, requested))
            self._lanes[key] = ln
        return ln

    def register(self, tenant: str, requested_weight=None) -> float:
        """Pre-create the tenant's append lane (hello time) and return
        the effective weight — the welcome frame reports it."""
        with self._cv:
            self._lane(tenant, "append", requested_weight)
        return self.weight_of(tenant, requested_weight)

    # -- admit / plan ------------------------------------------------------

    def depth(self, tenant: str) -> int:
        """The tenant's total queued histories across checkers."""
        with self._cv:
            return sum(len(ln.queue) for (t, _c), ln
                       in self._lanes.items() if t == tenant)

    def pending(self) -> int:
        with self._cv:
            return self._pending

    def close(self) -> None:
        """Close admission (drain): no request can enter a queue after
        this returns — the atomic half of the drain contract. A reader
        mid-encode that reaches `admit` after the scheduler observed
        an empty queue set is refused here, not admitted into a queue
        nobody will ever drain."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def admit(self, req: Request) -> bool:
        """Queue one request, or refuse it (False = backpressure: the
        tenant's lanes already hold max_queue histories — or admission
        is closed for drain)."""
        with self._cv:
            if self._closed:
                return False
            held = sum(len(ln.queue) for (t, _c), ln
                       in self._lanes.items() if t == req.tenant)
            if held >= self._max_queue:
                return False
            self._lane(req.tenant, req.checker).queue.append(req)
            self._pending += 1
            self._cv.notify_all()
        return True

    def retry_after_s(self) -> float:
        """The backpressure delay hint: proportional to the global
        backlog (a deep queue means a longer wait before capacity
        frees), floored so clients never busy-spin."""
        return round(min(30.0, max(0.2, 0.02 * self.pending())), 3)

    def wait_pending(self, timeout: float) -> bool:
        """Block until any request is queued (or timeout). The
        scheduler thread's park point."""
        with self._cv:
            if self._pending:
                return True
            self._cv.wait(timeout)
            return self._pending > 0

    def next_fold(self, budget_cells: int,
                  max_histories: int = DEFAULT_MAX_FOLD
                  ) -> tuple[str | None, list[Request]]:
        """The next shared bucket dispatch: picks the checker whose
        oldest queued request has waited longest (a fold is single-
        checker — append and wr ride different kernels), then runs the
        weighted DRR over that checker's lanes. Returns (checker,
        requests) — (None, []) when nothing is queued."""
        from ..parallel import folding
        with self._cv:
            oldest: tuple[float, str] | None = None
            for (_t, c), ln in self._lanes.items():
                if ln.queue:
                    t0 = ln.queue[0].t0
                    if oldest is None or t0 < oldest[0]:
                        oldest = (t0, c)
            if oldest is None:
                return None, []
            checker = oldest[1]
            lanes = [ln for (_t, c), ln in self._lanes.items()
                     if c == checker]
            picked = folding.plan_fold(lanes,
                                       budget_cells=budget_cells,
                                       max_histories=max_histories)
            self._pending -= len(picked)
            return checker, [req for _ln, req in picked]

    def tenants_snapshot(self) -> dict:
        """Per-tenant queue depths + weights for the health snapshot's
        serve section and the per-tenant gauges."""
        with self._cv:
            out: dict[str, dict] = {}
            for (t, _c), ln in self._lanes.items():
                d = out.setdefault(t, {"queued": 0,
                                       "weight": ln.weight})
                d["queued"] += len(ln.queue)
            return out
