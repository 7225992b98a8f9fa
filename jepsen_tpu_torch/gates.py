"""The registry of the `JEPSEN_TPU_*` environment gates the port reads.

The port's own copy of `jepsen_tpu/gates.py` (`Gate`, `_g`, `gate`,
`get`, `get_raw`, `is_set`, `export`, `unset` and the README table's
renderers), declaring only the gates the port reads. The names are the reference's, so one environment drives both
packages.
Every read of a `JEPSEN_TPU_*` variable in the port goes through
`get` (or `get_raw`/`is_set`), at call time, so tests can monkeypatch
the environment freely.

Parse rules, per gate kind and default:

  * bool, default on  — unset or anything but ``"0"`` is True;
  * bool, default off — only a set, non-empty, non-``"0"`` value is
    True;
  * int/float — parsed, falling back to the declared default on a
    malformed value instead of crashing the run;
  * str — the stripped raw value, empty treated as unset.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

PREFIX = "JEPSEN_TPU_"

#: Parse kinds a gate may declare.
KINDS = ("bool", "int", "float", "str")


class Gate:
    """One declared gate: name, kind, default, one doc line."""

    __slots__ = ("name", "kind", "default", "doc")

    def __init__(self, name: str, kind: str, default, doc: str):
        if kind not in KINDS or not name.startswith(PREFIX):
            raise ValueError(f"bad gate declaration {name!r} ({kind})")
        self.name = name
        self.kind = kind
        self.default = default
        self.doc = doc

    def parse(self, raw: str | None):
        """Typed value for a raw env string (None = unset)."""
        if raw is None or (raw == "" and self.kind != "bool"):
            return self.default
        if self.kind == "bool":
            if self.default:
                return raw != "0"
            return raw not in ("", "0")
        if self.kind in ("int", "float"):
            try:
                return int(raw) if self.kind == "int" else float(raw)
            except ValueError:
                log.debug("malformed %s=%r; using default %r",
                          self.name, raw, self.default)
                return self.default
        raw = raw.strip()
        return self.default if raw == "" else raw

    def default_str(self) -> str:
        """The README-table rendering of the default."""
        if self.kind == "bool":
            return "`1`" if self.default else "off"
        if self.default is None or self.default == "":
            return "off"
        return f"`{self.default}`"


GATES: dict[str, Gate] = {}


def _g(name: str, kind: str, default, doc: str) -> None:
    if name in GATES:
        raise ValueError(f"duplicate gate {name}")
    GATES[name] = Gate(name, kind, default, doc)


# -- observability ----------------------------------------------------------
_g("JEPSEN_TPU_TRACE", "bool", True,
   "`0`: no trace/metrics files, no-op spans (the flight recorder "
   "`events.jsonl` is still written)")
_g("JEPSEN_TPU_TRACE_MAX_EVENTS", "int", 200_000,
   "bounded tracer event buffer; overflow is counted "
   "(`dropped_events`), never silent")
_g("JEPSEN_TPU_WORKER_TRACE", "bool", True,
   "`0`: ingest pool workers record no spans and write no "
   "`trace-<pid>.jsonl` spools (the merged sweep trace then carries "
   "only parent-side tracks); moot when `JEPSEN_TPU_TRACE=0` — no "
   "tracer means no spools either way")
_g("JEPSEN_TPU_REPORT", "bool", False,
   "set: `analyze-store` writes the critical-path attribution report "
   "(`<store>/report.json` + `report.md`) at sweep end, as if "
   "`--report` were passed")
_g("JEPSEN_TPU_JAX_PROFILE", "bool", False,
   "`1`: wrap the sweep in a `torch.profiler` capture (CPU and CUDA "
   "activities; a Chrome trace under `<store>/torch-profile/`)")
_g("JEPSEN_TPU_EVENTS_MAX_BYTES", "int", None,
   "rotate `<store>/events.jsonl` once it exceeds this many bytes "
   "(atomic rename to `events.jsonl.1`, then an `events_rotated` "
   "event opens the fresh log); unset/<=0 = unbounded (the default)")
_g("JEPSEN_TPU_HEALTH_INTERVAL_S", "float", None,
   "live telemetry: write `<store>/health.json` atomically every this "
   "many seconds during a sweep (progress, robustness, throughput, "
   "heartbeat); unset/<=0 = off")
_g("JEPSEN_TPU_METRICS_PORT", "int", None,
   "serve `/metrics` (Prometheus text exposition) + `/healthz` (the "
   "health snapshot) on this port during a sweep; `0` binds an "
   "ephemeral port; unset = off")
_g("JEPSEN_TPU_COSTDB", "bool", False,
   "set: the device cost observatory — count each bucket dispatch's "
   "`closure_square` work from its shapes and rounds, time the "
   "dispatch with CUDA events on the compute stream, publish the "
   "residency gauges, append one record per (kernel flags, geometry) "
   "to `<store>/costdb.jsonl` at sweep end, and add the device "
   "roofline section to `--report`; off (the default) writes zero "
   "new files and records no event")
_g("JEPSEN_TPU_RESIDENCY_INTERVAL_S", "float", 5.0,
   "minimum seconds between `torch.cuda.memory_stats()` polls for the "
   "`hbm_device_bytes` residency gauge (the cheap gauges still "
   "publish per dispatch); `<=0` disables the poll; only read when "
   "`JEPSEN_TPU_COSTDB` is on")
_g("JEPSEN_TPU_KERNEL_STATS", "bool", False,
   "set: kernel search telemetry — checker dispatches additionally "
   "return a per-history graph/search stats record (edge counts, "
   "closure rounds, SCC shape, decision-boundary margin; grid and "
   "frontier occupancy; WGL counters), journaled to "
   "`<store>/analytics.jsonl` and aggregated into the report's "
   "\"search\" section; off (the default) leaves verdicts, files and "
   "launches as they are")
_g("JEPSEN_TPU_KERNEL_STATS_SAMPLE", "int", 1,
   "journal every Nth history's stats line into `analytics.jsonl` "
   "(in-memory aggregates and the report still cover every history); "
   "`1` (the default) journals all; only read when "
   "`JEPSEN_TPU_KERNEL_STATS` is on")
# -- verdict service --------------------------------------------------------
_g("JEPSEN_TPU_SERVE_SOCKET", "str", None,
   "unix-socket path the `serve` verdict daemon listens on (default "
   "`<store>/serve.sock`); tenants stream length-prefixed frames over "
   "it and get verdicts back")
_g("JEPSEN_TPU_SERVE_PORT", "int", None,
   "TCP port for the `serve` daemon instead of the unix socket "
   "(`0` binds an ephemeral port, printed in the ready line); unset = "
   "unix socket")
_g("JEPSEN_TPU_SERVE_MAX_QUEUE", "int", 256,
   "per-tenant admission-queue depth of the `serve` daemon; a CHECK "
   "past the cap gets an explicit `retry-after` frame (never a "
   "silent drop)")
_g("JEPSEN_TPU_SERVE_WEIGHTS", "str", "",
   "per-tenant fairness weights for the `serve` daemon's continuous "
   "batcher, e.g. `fleetA=3,fleetB=1` (unlisted tenants weigh 1); "
   "fold shares follow weighted deficit round-robin")
_g("JEPSEN_TPU_SERVE_DRAIN_S", "float", 30.0,
   "seconds the `serve` daemon spends draining admitted work on "
   "SIGTERM before closing; work never admitted (or past the "
   "deadline) is left for the tenant to resend — never half-acked")
_g("JEPSEN_TPU_SERVE_RETRY_S", "float", 60.0,
   "client-side retry budget: `ServeClient` stops retrying a "
   "backpressured or unreachable endpoint this many seconds after "
   "its last progress (verdict or successful send) and raises "
   "`ServeUnavailable` — the terminal error fleet failover bounds "
   "tenants to; `0` fails on the first retryable condition")
# -- serve fleet ------------------------------------------------------------
_g("JEPSEN_TPU_FLEET_HEARTBEAT_S", "float", 1.0,
   "seconds between a fleet daemon's beacon rewrites "
   "(`fleet-d<k>.json`: pid, epoch, load) — the router's liveness "
   "evidence; lower = faster death detection, more beacon churn")
_g("JEPSEN_TPU_FLEET_FAILOVER_S", "float", 5.0,
   "beacon staleness (kernel mtime age, immune to daemon clock skew) "
   "past which the fleet router declares a daemon dead, fences it "
   "out of the membership epoch, and replays its tenants' journals "
   "on a successor")
_g("JEPSEN_TPU_FLEET_SPILL_DEPTH", "int", 32,
   "queued histories on a tenant's affine daemon past which the "
   "fleet router spills new checks to the least-loaded live daemon "
   "(by beacon queue depth, tie-broken on modeled HBM bytes) "
   "instead of queueing deeper")
# -- cost-aware planner -----------------------------------------------------
_g("JEPSEN_TPU_PLANNER", "bool", False,
   "set: the cost-aware dispatch planner — route bucket geometry and "
   "the fused-vs-two-pass choice from a cost model fit on "
   "`costdb.jsonl` x `analytics.jsonl` (persisted as "
   "`<store>/plan.json`); cold start (no costdb, unseen device kind, "
   "corrupt plan) degrades to the exact current heuristics — planner "
   "decisions never change verdicts, only placement")
_g("JEPSEN_TPU_PLANNER_PATH", "str", None,
   "explicit `plan.json` path for the planner (load AND save), e.g. "
   "one shared model across stores; default `<store>/plan.json`; only "
   "read when `JEPSEN_TPU_PLANNER` is on")
# -- mesh (sharded sweep) ---------------------------------------------------
_g("JEPSEN_TPU_MESH", "bool", False,
   "set: `analyze-store` runs as ONE SHARD of a multi-host mesh sweep "
   "(the `--mesh` flag exports it): deterministic shard of the run "
   "dirs, per-shard `verdicts-<shard>.jsonl` journal and "
   "`trace-shard<k>.json` artifacts, coordinator merge on shard 0")
_g("JEPSEN_TPU_MESH_SHARD", "int", None,
   "mesh shard index override (re-assign a dead host's shard to "
   "another host); default 0 — requires `JEPSEN_TPU_MESH_SHARDS`")
_g("JEPSEN_TPU_MESH_SHARDS", "int", None,
   "mesh shard count — set on every host to shard a store without a "
   "coordinator; default 1 (a distributed job's coordinator address "
   "without it is refused)")
_g("JEPSEN_TPU_MESH_WAIT_S", "float", 600.0,
   "seconds the mesh coordinator (shard 0) waits for the other "
   "shards' done markers before declaring them lost (re-assignable, "
   "exit code ≥2) and merging what exists; `0` merges immediately")
# -- dispatch and supervision -----------------------------------------------
_g("JEPSEN_TPU_FUSED_CLASSIFY", "bool", True,
   "`0`: detect-then-classify two-pass instead of the fused kernel")
_g("JEPSEN_TPU_PACK_THREAD", "bool", True,
   "`0`: bucket packing + the host-to-device copy stay inline on the "
   "dispatching thread instead of the dedicated pack-h2d thread")
_g("JEPSEN_TPU_STRICT", "bool", False,
   "set: restore fail-fast — no quarantine, no OOM backdown; the "
   "first failure raises (CI bisection, debugging one corrupt store)")
_g("JEPSEN_TPU_DISPATCH_TIMEOUT_S", "float", None,
   "per-dispatch device watchdog: bound each bucket's wait to this "
   "many seconds, retry once, then quarantine the bucket")
_g("JEPSEN_TPU_FAULT_INJECT", "str", "",
   "self-nemesis spec, e.g. `encode:0.05,oom:first` — deterministic "
   "encode faults / simulated OOMs")
_g("JEPSEN_TPU_BACKEND", "str", None,
   "analysis backend override: `tpu` (the device path, on the "
   "checker's device)|`cpu` (the host oracles)|`race` (the CLI's "
   "`--backend` exports it; `auto` is the device path)")
_g("JEPSEN_TPU_FRONTIER", "int", 512,
   "bounded-frontier arena size for the sorted-frontier register "
   "kernel")
# -- ingest / native --------------------------------------------------------
_g("JEPSEN_TPU_NATIVE_INGEST", "bool", True,
   "`0`: Python jsonl→tensor encoder")
_g("JEPSEN_TPU_NATIVE_SPLIT", "bool", True,
   "`0`: Python per-key splitter for register sweeps")
_g("JEPSEN_TPU_NO_NATIVE", "bool", False,
   "set (non-`0`): disable every ctypes-loaded helper")
_g("JEPSEN_TPU_NATIVE_LIB_DIR", "str", None,
   "load the native `.so`s from this directory instead of "
   "building into `jepsen_tpu_torch/_build/` — no rebuild, and a "
   "missing or stale lib there raises")
_g("JEPSEN_TPU_SHM_INGEST", "bool", True,
   "`0`: pool-encoded histories ride the classic pickle pipe instead "
   "of `multiprocessing.shared_memory` descriptors (also "
   "auto-falls-back when /dev/shm is unusable)")
_g("JEPSEN_TPU_PIPELINE", "bool", False,
   "set: force the multi-process ingest pipeline even on single-core "
   "hosts")
_g("JEPSEN_TPU_ENCODE_CACHE", "bool", True,
   "`0`: no `encoded.v1.bin` sidecar reads or writes — every sweep "
   "re-parses")
_g("JEPSEN_TPU_ENCODE_CACHE_WRITE", "bool", True,
   "`0`: read-only cache (hit existing sidecars, never write — e.g. "
   "a read-only store mount)")
# -- warm path --------------------------------------------------------------
_g("JEPSEN_TPU_SIDECAR_V2", "bool", True,
   "`0`: write/read only v1 (unpadded) encoded sidecars — no "
   "dispatch-shaped `encoded.v2.bin`, no v1→v2 upgrade, warm sweeps "
   "pack with host copies as before")


def gate(name: str) -> Gate:
    """The declaration for `name` (KeyError on an unregistered gate)."""
    return GATES[name]


def get(name: str):
    """The typed value of gate `name` from the current environment
    (KeyError on an unregistered name)."""
    return GATES[name].parse(os.environ.get(name))


def get_raw(name: str) -> str | None:
    """The raw env string of a registered gate (None = unset)."""
    GATES[name]  # KeyError on unregistered names
    return os.environ.get(name)


def is_set(name: str) -> bool:
    """Is the gate explicitly set (non-empty) in the environment?"""
    GATES[name]
    return bool(os.environ.get(name))


def export(name: str, value) -> None:
    """Write gate `name` into the environment (the CLI flag→env
    export; subprocesses and embedded callers then see the choice).
    Booleans serialize to the canonical `1`/`0`."""
    GATES[name]
    if isinstance(value, bool):
        value = "1" if value else "0"
    os.environ[name] = str(value)


def unset(name: str) -> None:
    """Remove gate `name` from the environment."""
    GATES[name]
    os.environ.pop(name, None)


# ---------------------------------------------------------------------------
# README rendering — the port's env-gate table is generated, never
# hand-kept.
# ---------------------------------------------------------------------------

#: Markers delimiting the port's generated block in README.md (they
#: differ from the reference's, whose table stays beside this one);
#: lint rule JT-GATE-003 fails when the committed block drifts from the
#: registry.
TABLE_BEGIN = "<!-- env-gates:begin (generated by jepsen_tpu_torch.gates) -->"
TABLE_END = "<!-- env-gates:end (jepsen_tpu_torch.gates) -->"


def render_env_table() -> str:
    """The README env-gate table, one row per registered gate. Literal
    `|` in a doc line is escaped: markdown splits cells on every
    unescaped pipe, code spans included."""
    lines = ["| gate | default | meaning |", "|---|---|---|"]
    for g in GATES.values():
        doc = g.doc.replace("|", "\\|")
        lines.append(f"| `{g.name}` | {g.default_str()} | {doc} |")
    return "\n".join(lines)


def render_env_block() -> str:
    """The full generated README block, markers included."""
    return f"{TABLE_BEGIN}\n{render_env_table()}\n{TABLE_END}"
