"""Batch folding: the verdict service's scheduler seam.

Counterpart of `jepsen_tpu/parallel/folding.py`. `check_bucketed_async`
answers "given THIS list of histories, sweep them". A verdict service
asks the inverse: many tenants' admission queues fill at once, and the
daemon must decide WHICH pending histories form the next shared
dispatch. Two pieces:

  * `plan_fold` — weighted deficit round-robin (DRR) across per-tenant
    lanes under a padded-cell budget. The cost unit is `fold_cost`
    (T_pad² closure cells, `bucket_by_length`'s unit), so admission is
    priced by history size, not request count: a tenant's long
    histories cannot starve another's short ones. Deficits persist
    across folds (the caller owns the lanes), so a tenant whose head is
    briefly unaffordable earns credit instead of starving.
  * `FoldDispatcher` — one owner's dispatch of a fold on one
    `torch.device`: the sweep's own routing (`check_bucketed` with its
    OOM backdown and watchdog quarantine, `check_long_history` past
    `DENSE_TXN_LIMIT`, the wr chunk backdown), rendering the same
    verdict dicts `analyze-store` persists, so a streamed verdict is
    byte-identical to the post-hoc one. A fold that fails outright
    quarantines only its own histories — unless the failure is one
    `supervisor.must_end_sweep` names (a kernel that cannot be built or
    launched, a missing device, a CUDA error other than an OOM): that
    one raises, because every later fold would fail the same way and a
    quarantine would hide a device fault (the port's departure from the
    reference, which quarantines everything).

Both are plain objects with no socket or tenant knowledge; the serve
daemon composes them. The planner (`planner.py`, JEPSEN_TPU_PLANNER)
replaces the `fold_cost` price with its model's prediction in the same
cell unit; `plan_fold` only ever reads `.cost` as a positive number.
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)

#: Default fold budget in padded closure cells, the envelope
#: `check_bucketed_async` budgets per dispatch pipeline.
DEFAULT_FOLD_CELLS = 1 << 27

#: DRR safety valve: rounds are bounded so a pathological lane set can
#: never spin the scheduler.
_MAX_ROUNDS = 1024


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


class Lane:
    """One tenant's scheduling lane: a FIFO of cost-carrying items, a
    fairness weight, and the DRR deficit `plan_fold` maintains. The
    owner serializes access (the daemon's admission lock)."""

    __slots__ = ("name", "weight", "deficit", "queue")

    def __init__(self, name: str, weight: float = 1.0):
        from collections import deque
        self.name = name
        # a zero or negative weight would never earn deficit: clamp to
        # a small positive floor so every admitted tenant runs
        self.weight = max(float(weight), 1e-3)
        self.deficit = 0.0
        self.queue = deque()


def plan_fold(lanes, *, budget_cells: int = DEFAULT_FOLD_CELLS,
              max_histories: int | None = None) -> list:
    """Pick the next fold: weighted deficit round-robin over `lanes`,
    popping items until the padded-cell budget (or `max_histories`) is
    reached. Returns [(lane, item), ...] in pick order; items carry
    `.cost` (a `fold_cost` value).

    With equally sized items and full queues, pick counts converge to
    the weight ratio; an item larger than the whole budget still
    dispatches, alone; a lane's deficit resets when its queue drains,
    so idle tenants cannot hoard credit."""
    active = [ln for ln in lanes if ln.queue]
    if not active:
        return []
    # one round must not hand a lane more credit than about one item,
    # or the first lane drains the whole fold before the second's turn:
    # the quantum is capped at the smallest head cost (and at an 1/8th
    # budget share for a monster head)
    quantum = max(1.0, min(float(budget_cells) / (8 * len(active)),
                           float(min(ln.queue[0].cost
                                     for ln in active))))
    picked: list = []
    cells = 0

    def fits(cost: int) -> bool:
        if picked and cells + cost > budget_cells:
            return False
        return max_histories is None or len(picked) < max_histories

    for _ in range(_MAX_ROUNDS):
        earned = False
        for ln in active:
            if not ln.queue or not fits(ln.queue[0].cost):
                continue
            ln.deficit += ln.weight * quantum
            earned = True
            while ln.queue and ln.deficit >= ln.queue[0].cost \
                    and fits(ln.queue[0].cost):
                item = ln.queue.popleft()
                picked.append((ln, item))
                cells += item.cost
                ln.deficit -= item.cost
        if not earned:
            break   # fold full, or every queue drained
    if not picked and active:
        # the _MAX_ROUNDS valve tripped: take one head anyway, the
        # scheduler must always make progress
        ln = active[0]
        picked.append((ln, ln.queue.popleft()))
        ln.deficit = 0.0
    for ln in lanes:
        if not ln.queue:
            ln.deficit = 0.0
    return picked


class FoldDispatcher:
    """Dispatch one fold of encoded histories on `device` and render
    the exact verdict dicts `analyze-store` would persist for them.

    The supervisor's recovery ladder comes with `check_bucketed` (OOM
    backdown, watchdog quarantine, per-history `Quarantined`
    sentinels). Any other error quarantines the whole fold's histories
    (`valid? unknown`, cause attached), except one that
    `supervisor.must_end_sweep` names, which raises to the owner.

    `device` is a `torch.device` (or its name). `mesh` (a
    `parallel.Mesh`) spreads each fold's buckets over its devices, as
    the reference's dispatcher over its mesh; its first device is then
    the fold's device (long histories, the wr edge batches over all of
    its devices). Under JEPSEN_TPU_BACKEND=cpu every history goes to the
    host oracles and no device is used."""

    def __init__(self, device=None, *, mesh=None,
                 budget_cells: int = DEFAULT_FOLD_CELLS):
        self.mesh = mesh
        self.device = mesh.devices.flat[0] if mesh is not None else device
        self.budget_cells = budget_cells
        self.phases: dict = {}
        #: when a list, `check_bucketed`'s bucket log: one dict per
        #: device bucket of every fold (a caller that measures folds
        #: sets it)
        self.bucket_log: list | None = None

    @staticmethod
    def _host_only() -> bool:
        from .. import gates
        return gates.get("JEPSEN_TPU_BACKEND") == "cpu"

    def verdicts(self, encs: list, checker: str = "append",
                 stats_out: list | None = None) -> list[dict]:
        """Per-history verdict dicts for one fold, aligned with `encs`.
        Entries that are Exceptions (a failed encode riding the queue)
        quarantine individually at the `encode` stage, unless
        `supervisor.must_end_sweep` names them (a native encoder that
        cannot be built), which raises. `stats_out` (a list,
        JEPSEN_TPU_KERNEL_STATS) is extended with one kernel-stats dict
        per history, aligned with the verdicts (None for a quarantined
        one): the daemon attaches them to reply frames beside the
        result, so verdict bytes stay those of the sweep."""
        from .. import supervisor as sv
        out: list = [None] * len(encs)
        stats: list = [None] * len(encs)
        good_idx = [i for i, e in enumerate(encs)
                    if not isinstance(e, Exception)]
        for i, e in enumerate(encs):
            if isinstance(e, Exception):
                if sv.must_end_sweep(e):
                    raise e
                out[i] = sv.quarantine_verdict(e, "encode", checker)
        good = [encs[i] for i in good_idx]
        if good:
            gs: list | None = [] if stats_out is not None else None
            try:
                rendered = self._check(good, checker, stats_out=gs)
            except Exception as e:
                if sv.must_end_sweep(e):
                    raise
                log.warning("fold dispatch failed; quarantining %d "
                            "histories", len(good), exc_info=True)
                rendered = [sv.quarantine_verdict(e, "dispatch",
                                                  checker)
                            for _ in good]
                gs = None
            for j, (i, res) in enumerate(zip(good_idx, rendered)):
                out[i] = res
                if gs is not None and j < len(gs):
                    stats[i] = gs[j]
        if stats_out is not None:
            stats_out.extend(stats)
        return out

    def _check(self, encs: list, checker: str,
               stats_out: list | None = None) -> list[dict]:
        from .. import parallel, supervisor as sv
        from ..checker import elle
        from ..checker.elle import kernels as elle_kernels
        from ..checker.elle import wr as elle_wr
        host_only = self._host_only()
        want_stats = stats_out is not None and not host_only
        fold_stats: list = [None] * len(encs)
        if checker == "append":
            if host_only:
                cycles_per = [elle.cycle_anomalies_cpu(e) for e in encs]
            else:
                # the sweep's routing: histories past the dense [T,T]
                # limit go through SCC condensation, the rest through
                # the bucketed dispatch
                cycles_per: list = [None] * len(encs)
                dense = [i for i, e in enumerate(encs)
                         if e.n <= parallel.DENSE_TXN_LIMIT]
                if dense:
                    ds: list | None = [] if want_stats else None
                    got = parallel.check_bucketed(
                        [encs[i] for i in dense], self.device,
                        mesh=self.mesh, budget_cells=self.budget_cells,
                        bucket_log=self.bucket_log, phases=self.phases,
                        stats_out=ds)
                    for j, (i, cy) in enumerate(zip(dense, got)):
                        cycles_per[i] = cy
                        if ds is not None:
                            fold_stats[i] = ds[j]
                for i, e in enumerate(encs):
                    if e.n <= parallel.DENSE_TXN_LIMIT:
                        continue
                    hs: list | None = [] if want_stats else None
                    try:
                        cycles_per[i] = parallel.check_long_history(
                            e, self.device, mesh=self.mesh,
                            dense_limit=parallel.DENSE_TXN_LIMIT,
                            bucket_log=self.bucket_log, stats_out=hs)
                        if hs:
                            fold_stats[i] = hs[0]
                    except Exception as err:
                        if sv.must_end_sweep(err):
                            raise
                        # one monster history fails alone (the sweep's
                        # long-run contract)
                        cycles_per[i] = sv.Quarantined("check",
                                                       repr(err))
            out = []
            for enc, cycles in zip(encs, cycles_per):
                if isinstance(cycles, sv.Quarantined):
                    out.append(cycles.verdict("append"))
                    continue
                res = elle.render_verdict(enc, cycles,
                                          elle.APPEND_PROHIBITED)
                res["checker"] = "append"
                out.append(res)
            if stats_out is not None:
                stats_out.extend(fold_stats)
            return out
        if checker == "wr":
            if host_only:
                cycles_per = [elle_wr.cycle_anomalies_cpu(e)
                              for e in encs]
            else:
                # the wr sweep's backdown ladder (bucketed batch ->
                # singletons -> quarantine), shared with the CLI so
                # the two dispatch owners cannot drift
                from ..cli import _wr_chunk_with_backdown
                ws: list | None = [] if want_stats else None
                # (a fake kernel module may not take `devices`: passed
                # only for a mesh)
                spread = {} if self.mesh is None \
                    else {"devices": list(self.mesh.devices.flat)}
                cycles_per = _wr_chunk_with_backdown(
                    [(None, e) for e in encs], elle_kernels, elle_wr,
                    stats_out=ws, device=self.device,
                    bucket_log=self.bucket_log, **spread)
                if ws is not None:
                    fold_stats[:len(ws)] = ws
            out = []
            for enc, cycles in zip(encs, cycles_per):
                if isinstance(cycles, sv.Quarantined):
                    out.append(cycles.verdict("wr"))
                    continue
                res = elle_wr.render_wr_verdict(enc, cycles,
                                                elle_wr.WR_PROHIBITED)
                res["checker"] = "wr"
                out.append(res)
            if stats_out is not None:
                stats_out.extend(fold_stats)
            return out
        raise ValueError(f"unknown checker {checker!r}")
