"""Sharded sweeps: `analyze-store --mesh` coordination.

Counterpart of `jepsen_tpu/mesh.py`. Checking is embarrassingly
parallel across independent histories, and a history's dependency
graph never spans run dirs, so the shard axis of a mesh sweep is a
deterministic split of the store's run dirs, not a dispatch across
devices. Each shard (a process, here or on another host) runs the
ordinary sweep over its own slice on its own device, journals to its
own `verdicts-<shard>.jsonl` and exports its own trace; the coordinator
(shard 0) folds journals, traces, metrics, the costdb and the analytics
into the store-level artifacts once every shard's done marker has
landed or its bounded wait has run out (a dead shard is lost and
re-assignable, never a dead sweep). Several shard processes may share
one card: each has its own CUDA context and its own ingest pool.

Shard identity comes from `JEPSEN_TPU_MESH_SHARDS` (the shard count,
set on every host) and `JEPSEN_TPU_MESH_SHARD` (this process's index,
default 0). The same pair re-assigns a dead shard:
`JEPSEN_TPU_MESH_SHARD=<k> ... --resume`. Without a count the sweep is
one shard, a mesh of one, with a per-shard journal.

The second route is a joined job: with a coordinator address set
(`JAX_COORDINATOR_ADDRESS` or `COORDINATOR_ADDRESS`, the reference's
variables, with `JAX_NUM_PROCESSES` and `JAX_PROCESS_ID`) and no shard
count, the process joins it (`parallel.init_distributed`, a
`torch.distributed` gloo group, the port's `jax.distributed`) and its
rank and the group's size become the shard's; `JEPSEN_TPU_MESH_SHARD`
still overrides the index. A join that fails raises: degrading to a
whole-store sweep would have every host of the job sweep everything and
race the same journals (the CLI exits 255).

The split itself (`store.shard_of` over the key `<name>/<run>`) is the
reference's to the byte, so both packages partition one store alike and
a shard of either resumes the other's journal.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from pathlib import Path

from . import gates

log = logging.getLogger(__name__)

#: The environment that names a distributed job's coordinator, as the
#: reference's `parallel.init_distributed` reads it.
COORDINATOR_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def mesh_enabled() -> bool:
    """The JEPSEN_TPU_MESH gate (default off; `--mesh` exports it)."""
    return gates.get("JEPSEN_TPU_MESH")


def resolve_shard() -> tuple[int, int]:
    """(shard index, shard count) of this process, as the module doc
    says. An index out of range is an error (wrapping a mistyped
    re-assignment onto another live shard would race its journal), and
    so is a bare index with no count; a coordinator address with no
    count joins the job, and a join that fails raises RuntimeError."""
    override = gates.get("JEPSEN_TPU_MESH_SHARD")
    shards = gates.get("JEPSEN_TPU_MESH_SHARDS")

    def ranged(shard: int, count: int) -> tuple[int, int]:
        if not 0 <= shard < count:
            raise ValueError(
                f"JEPSEN_TPU_MESH_SHARD={shard} out of range for "
                f"a {count}-shard mesh (indices are 0..{count - 1})")
        return shard, count

    if shards is not None and shards > 0:
        return ranged(0 if override is None else override, shards)
    if any(os.environ.get(v) for v in COORDINATOR_VARS):
        from . import parallel
        try:
            parallel.init_distributed()
            import torch.distributed as dist
            rank, size = dist.get_rank(), dist.get_world_size()
        except Exception as e:
            raise RuntimeError(
                "mesh shard identity unresolvable: a coordinator address "
                "is set (JAX_COORDINATOR_ADDRESS/COORDINATOR_ADDRESS) but "
                "joining its job (torch.distributed over gloo, the port's "
                f"jax.distributed) failed: {e} — refusing to degrade to a "
                "full-store single-shard sweep (every host would sweep "
                "everything, racing the same journals). Set "
                "JEPSEN_TPU_MESH_SHARDS/_SHARD for coordinator-free "
                "identity instead.") from e
        # the re-assignment override applies inside a joined job too: a
        # replacement process can take a dead one's shard
        return ranged(rank if override is None else override, size)
    if override is not None:
        raise ValueError(
            f"JEPSEN_TPU_MESH_SHARD={override} set with no shard "
            "count: set JEPSEN_TPU_MESH_SHARDS too (or join a job "
            "through a coordinator address) — a bare index cannot "
            "define a partition")
    return 0, 1


def shard_journal_path(store_base, shard: int) -> Path:
    """This shard's resumable verdict journal. One file a shard keeps
    resume local: a cut fleet resumes each shard from its own journal,
    reading none of another's, and a replacement host needs one file."""
    return Path(store_base) / f"verdicts-{shard}.jsonl"


def merge_journals(store_base, n_shards: int, checker: str) -> dict:
    """{store-relative run dir: last journal entry} of `checker` across
    every shard's journal: the coordinator's one verdict set. Shards
    partition the run dirs, so keys cannot collide across journals;
    within one, the last entry wins (resume)."""
    from .store import VerdictJournal
    out: dict[str, dict] = {}
    for k in range(n_shards):
        loaded = VerdictJournal.load(shard_journal_path(store_base, k))
        for (d, c), e in loaded.items():
            if c == checker:
                out[d] = e
    return out


def merge_shard_metrics(store_base, n_shards: int) -> dict:
    """The fleet's metrics: counters summed across every present
    `metrics-shard<k>.json`; gauges and histograms stay per shard under
    `per_shard` (a max summed across shards would mean nothing)."""
    counters: dict[str, int] = {}
    per_shard: dict[str, dict] = {}
    for k in range(n_shards):
        p = Path(store_base) / f"metrics-shard{k}.json"
        try:
            m = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if not isinstance(m, dict):
            continue
        per_shard[str(k)] = m
        for name, v in (m.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[name] = counters.get(name, 0) + v
    return {"counters": counters, "per_shard": per_shard}


def coordinator_merge(store, checker: str, shard: int, n_shards: int,
                      own_rc: int | None, report: bool = False,
                      tracer=None, name: str | None = None) -> int:
    """The mesh sweep's merge. A shard other than 0 returns its own exit
    code. Shard 0 waits (bounded) for the others' done markers, folds
    the shards' journals into one verdict set (an invalid verdict on any
    shard fails the fleet), prints the one-line mesh summary, merges the
    costdbs and analytics, refits the planner once, and, with the tracer
    on, merges the shards' traces into trace.json and metrics.json (and,
    with `report`, the report with per-shard shares).

    What decides a shard's state is its journal's coverage of its hash
    assignment (one store walk gives every shard's), not its marker: a
    marker is only the hint the wait polls, so a stale one, or one a
    crashed shard stamped ("crashed"), can end the wait early but never
    makes a partial shard read as complete. A lost (no marker), crashed
    (not a validity exit code) or incomplete (runs missing from its
    journal) shard floors the merged exit code at 2, is named in the
    summary and is re-assignable; only a fully covered fleet lets the
    merge remove the worker spool dirs."""
    own_rc = 255 if own_rc is None else own_rc
    if shard != 0 or n_shards <= 0:
        return own_rc
    from . import obs
    from . import supervisor as sv
    from .cli import validity_exit_code
    from .store import VerdictJournal, shard_of
    obs.install_events(store.base)
    try:
        others = [k for k in range(n_shards) if k != shard]
        done, lost = sv.wait_for_shards(
            store.base, others,
            timeout_s=gates.get("JEPSEN_TPU_MESH_WAIT_S"))
        # one walk gives every shard's assignment: the split each shard
        # computed for itself
        expected: dict[int, set] = {k: set() for k in range(n_shards)}
        for d in store.iter_run_dirs(name=name):
            key = os.path.relpath(d, store.base)
            expected[shard_of(key, n_shards)].add(key)
        journaled: dict[int, dict] = {}
        for k in range(n_shards):
            journaled[k] = {
                d: e for (d, c), e in VerdictJournal.load(
                    shard_journal_path(store.base, k)).items()
                if c == checker}
        crashed, incomplete = [], []
        for k in sorted(done):
            ec = done[k].get("exit_code")
            obs.emit("shard_done", shard=k, exit_code=ec)
            if not isinstance(ec, int) or ec not in (0, 1, 2):
                crashed.append(k)
            elif not expected[k] <= set(journaled[k]):
                # a marker without the journal to back it: stale, or a
                # partial re-sweep
                incomplete.append(k)
        for k in lost:
            obs.emit("shard_lost", shard=k, shards=n_shards)
        for k in lost + crashed + incomplete:
            log.warning(
                "shard %d/%d %s: its runs are unverdicted; re-assign "
                "it with JEPSEN_TPU_MESH_SHARD=%d "
                "JEPSEN_TPU_MESH_SHARDS=%d analyze-store --mesh "
                "--resume", k, n_shards,
                "missing at merge" if k in lost
                else "crashed" if k in crashed
                else "incompletely journaled",
                k, n_shards)
        merged: dict[str, dict] = {}
        for k in range(n_shards):
            merged.update(journaled[k])
        worst = own_rc
        counts = {0: 0, 1: 0, 2: 0}
        for e in merged.values():
            c = validity_exit_code(e)
            worst = max(worst, c)
            counts[c if c in counts else 2] += 1
        total = sum(len(v) for v in expected.values())
        unaccounted = max(0, total - len(merged))
        if lost or crashed or incomplete or unaccounted:
            worst = max(worst, 2)
        print(json.dumps({
            "mesh": True, "checker": checker, "shards": n_shards,
            "runs_total": total, "runs_verdicted": len(merged),
            "unaccounted": unaccounted, "valid": counts[0],
            "invalid": counts[1], "unknown": counts[2],
            "lost_shards": lost, "crashed_shards": crashed,
            "incomplete_shards": incomplete,
            "valid?": worst == 0}))
        cost_records: list = []
        search_records: list = []
        if Path(store.base).is_dir():
            # the shards' costdbs and analytics exist iff they ran with
            # their gates on: merge whatever landed, whatever the tracer
            try:
                cost_records = merge_costdbs(store.base, n_shards)
            except Exception:
                log.warning("mesh costdb merge failed", exc_info=True)
            try:
                search_records = merge_analytics(store.base, n_shards)
            except Exception:
                log.warning("mesh analytics merge failed", exc_info=True)
            # one planner refit over the fleet's merged tables (the
            # shards skipped theirs); a no-op with the gate off
            try:
                from . import planner as planner_mod
                planner_mod.refresh(store.base, cost_records,
                                    search_records)
            except Exception:
                log.warning("mesh planner refresh failed", exc_info=True)
        if tracer is not None and getattr(tracer, "enabled", False) \
                and Path(store.base).is_dir():
            try:
                _merge_trace_artifacts(
                    store.base, n_shards, report,
                    fleet_complete=not (lost or crashed or incomplete
                                        or unaccounted),
                    device_records=cost_records,
                    search_records=search_records)
            except Exception:
                log.warning("mesh trace merge failed", exc_info=True)
        return worst
    finally:
        obs.reset_events()


def merge_costdbs(store_base, n_shards: int) -> list[dict]:
    """Fold every present `costdb-shard<k>.jsonl` into one deduplicated
    `<store>/costdb.jsonl` (`obs.device.merge_records`: one (kernel
    flags, geometry) on two shards becomes one record with the windows
    summed and the roofline derived again). A missing shard file (gate
    off, or the shard lost) is an empty table, not an error. The merged
    file is written atomically, so a repeat merge replaces it. Returns
    the merged records ([] when no shard captured any)."""
    from . import trace
    from .obs import device as device_obs
    from .store import COSTDB_NAME, costdb_path, load_costdb
    lists = [load_costdb(costdb_path(store_base, k))
             for k in range(n_shards)]
    absent = sum(1 for t in lists if not t.exists)
    if absent:
        log.debug("costdb merge: %d/%d shard file(s) absent",
                  absent, n_shards)
    if not any(lists):
        return []
    merged = device_obs.merge_records(lists)
    trace.atomic_write_text(
        Path(store_base) / COSTDB_NAME,
        "".join(json.dumps(r) + "\n" for r in merged))
    print(f"merged costdb: {len(merged)} record(s) across "
          f"{n_shards} shard(s)", file=sys.stderr)
    return merged


def merge_analytics(store_base, n_shards: int) -> list[dict]:
    """Fold every present `analytics-shard<k>.jsonl` into one
    `<store>/analytics.jsonl`. Records cannot collide across shards;
    within one file the last record of a (dir, checker) wins (a
    resumed history's fresher stats). Written atomically, so a repeat
    merge replaces it. Returns the merged records ([] when no shard
    captured any)."""
    from . import trace
    from .store import ANALYTICS_NAME, analytics_path, load_analytics
    merged: dict[tuple, dict] = {}
    for k in range(n_shards):
        for rec in load_analytics(analytics_path(store_base, k)):
            merged[(rec.get("dir"), rec.get("checker"))] = rec
    if not merged:
        return []
    out = list(merged.values())
    trace.atomic_write_text(
        Path(store_base) / ANALYTICS_NAME,
        "".join(json.dumps(r) + "\n" for r in out))
    print(f"merged analytics: {len(out)} record(s) across "
          f"{n_shards} shard(s)", file=sys.stderr)
    return out


def _merge_trace_artifacts(store_base, n_shards: int, report: bool,
                           fleet_complete: bool = True,
                           device_records: list | None = None,
                           search_records: list | None = None) -> None:
    """trace.json, metrics.json and (with `report`) report.json and
    report.md from the shards' exports; a lost shard's missing files are
    skipped. `device_records` is the costdb the coordinator has just
    merged, handed through so the report never reads a stale file."""
    from . import trace
    evs, per_shard = trace.merge_shard_traces(store_base, range(n_shards))
    if not evs:
        return
    p = trace.atomic_write_text(
        Path(store_base) / "trace.json",
        json.dumps({"traceEvents": evs, "displayTimeUnit": "ms"}))
    print(f"merged mesh trace written to {p}", file=sys.stderr)
    metrics = merge_shard_metrics(store_base, n_shards)
    trace.atomic_write_text(Path(store_base) / "metrics.json",
                            json.dumps(metrics, indent=2))
    if report:
        from .obs import attribution
        rj, _md = attribution.write_report(
            store_base, evs, metrics, per_shard_events=per_shard,
            device_records=device_records or None,
            search_records=search_records or None)
        print(f"merged mesh report written to {rj}", file=sys.stderr)
    # every shard's spans now live in its trace-shard<k>.json, but a
    # lost, crashed or incomplete shard may still be sweeping: its live
    # spool dir stays until a fully covered merge (each shard cleans
    # its own at its next sweep start)
    if fleet_complete:
        for k in range(n_shards):
            sd = trace.shard_spool_dir(store_base, k)
            trace.clean_spools(sd)
            try:
                sd.rmdir()
            except OSError:
                pass
