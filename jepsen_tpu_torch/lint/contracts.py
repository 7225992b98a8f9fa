"""The declared-contracts registry the cross-boundary analyses check
against.

`gates.py` proved the pattern: an invariant written down ONCE, in a
typed table, is an invariant the linter can enforce everywhere it is
consumed. This module does the same for the encode→pack→dispatch
tensor contracts (JT-TENSOR), the lock/shared-state discipline of the
sweep's thread graph (JT-LOCK), the hot-path scoping both share, the
store-artifact durability protocols (JT-DUR) — every on-disk
format a sweep persists, declared once with its crash-consistency
protocol, sanctioned writer/reader helpers and retention class —
and the serve fleet's happens-before protocol (JT-ORD): the
journal-then-reply, fence-between-dispatch-and-journal and
failover-ordering contracts, declared once and proved
path-sensitively against the cfg.py graphs.
The ABI/layout contracts (JT-ABI) are NOT declared here — their source
of truth is the port's `csrc/` itself, parsed by `cparse.py` and
cross-checked against `_build.PROTOTYPES`/`store.py`; duplicating them
in a third place would just add one more thing to drift.

This is the port's copy of the reference's registry: every entry names
the port's module for its contract. Where the port's counterpart has
another name or shape, the entry names it: the kernel-library cache of
`_build.py` stands where the reference's AOT executable cache stands,
the `torch.profiler` capture where its `jax.profiler` capture stands,
and JT-ORD-004's leak contract guards the cost observatory's pending
dispatch window, the port's per-dispatch device-side resource (it has
no donated-buffer slots).

Every table is consumed by a rule in `rules_tensor.py` /
`rules_lock.py` / `rules_dur.py` / `order.py`; tests/test_torch_lint.py
pins the registry's shape so an entry can't silently vanish.
"""

from __future__ import annotations

from dataclasses import dataclass
from fnmatch import fnmatchcase

# ---------------------------------------------------------------------------
# JT-TENSOR — dtype/shape/fill contracts of the encode→pack→dispatch path
# ---------------------------------------------------------------------------

#: Canonical dtype per encoded-tensor field (numpy dtype names). The
#: lean int64 index tensors and the int32 device (`d_*`) tensors are
#: both declared — the narrowing between them is explicit below, so an
#: UNdeclared cast anywhere on the path is a finding.
TENSOR_DTYPES: dict[str, str] = {
    "appends": "int32",
    "reads": "int32",
    "edges": "int32",
    "status": "int32",
    "process": "int32",
    "invoke_index": "int64",
    "complete_index": "int64",
    "d_invoke": "int32",
    "d_complete": "int32",
    "n_txns": "int32",
    "kid_to_pre": "int32",
}

#: Common local-variable spellings of the declared fields (the packers
#: shorten `*_index` to `*_idx`); dataflow tags resolve through this.
FIELD_ALIASES: dict[str, str] = {
    "invoke_idx": "invoke_index",
    "complete_idx": "complete_index",
}

#: Sanctioned narrowings: (source field, destination dtype). The v2
#: sidecar's device tensors are the int32 narrowing of the lean int64
#: index tensors — declared here because both writers (store.py's
#: `_padded_arrays`, hist_encode.cc's `write_sidecar`) perform it; any
#: OTHER cast of a contracted tensor is drift.
DECLARED_NARROWINGS: frozenset[tuple[str, str]] = frozenset({
    ("invoke_index", "int32"),
    ("complete_index", "int32"),
})

#: pack_batch's fill convention: dead triple/process rows are -1 (no
#: txn, no key), dead index rows 0. A `np.full` building a contracted
#: tensor with any other fill silently corrupts the kernel's masking.
FILL_VALUES: dict[str, int] = {
    "appends": -1,
    "reads": -1,
    "edges": -1,
    "process": -1,
    "invoke_index": 0,
    "complete_index": 0,
    "d_invoke": 0,
    "d_complete": 0,
    "n_txns": 0,
}

#: Fields whose minor axis is a triple — a reshape of one of these to
#: a literal shape must end in 3.
TRIPLE_FIELDS: frozenset[str] = frozenset({"appends", "reads", "edges"})

#: The bucket geometry: txn axis pads to the MXU tile, every minor
#: axis to 8 — kernels.BatchShape.plan, store.dispatch_pad_plan and
#: hist_encode.cc's pad_up all agree on these two numbers (JT-ABI-004
#: proves the native side; JT-TENSOR-003 flags any literal pad
#: multiple outside this set on the Python side).
PAD_TXNS = 128
PAD_MINOR = 8
PAD_MULTIPLES: frozenset[int] = frozenset({PAD_TXNS, PAD_MINOR})

#: Donated-arg positions of a single-device bucket dispatch: the six
#: packed input tensors, nothing else. `donate_argnums` anywhere in
#: the analyzed files must spell exactly this.
DONATE_ARGNUMS: tuple[int, ...] = (0, 1, 2, 3, 4, 5)

#: Files whose whole body is the pack/h2d hot path for the host-
#: materialization rule (JT-TENSOR-002, ex-JT-JAX-005).
HOT_PATH_FILES = ("jepsen_tpu_torch/parallel/", "jepsen_tpu_torch/shm.py")

#: Function-name shapes treated as hot-path regardless of file — the
#: packers and h2d stages (also what makes the rule fixture-testable).
HOT_FN_PREFIXES = ("pack_", "_h2d", "_prep_bucket", "shard_batch")

#: Files the tensor dataflow pass analyzes module-wide (beyond the
#: hot-path scoping above): everywhere contracted tensors are built,
#: persisted, or packed.
TENSOR_FILES = (
    "jepsen_tpu_torch/checker/elle/kernels.py",
    "jepsen_tpu_torch/checker/knossos/kernels.py",
    "jepsen_tpu_torch/parallel/",
    "jepsen_tpu_torch/shm.py",
    "jepsen_tpu_torch/store.py",
)


def is_tensor_file(rel: str) -> bool:
    return any(t in rel for t in TENSOR_FILES)


def is_hot_path_file(rel: str) -> bool:
    return any(h in rel for h in HOT_PATH_FILES)


def field_of(name: str) -> str | None:
    """The declared field a local name refers to, or None."""
    name = FIELD_ALIASES.get(name, name)
    return name if name in TENSOR_DTYPES else None


# ---------------------------------------------------------------------------
# JT-LOCK — shared state, its guarding locks, and blocking calls
# ---------------------------------------------------------------------------

#: Shared mutable state and the lock that must be held to WRITE it:
#: (class name, attribute, lock). The lock is either a `self.<attr>`
#: spelled as the attr name, or a module-global lock name. Reads are
#: out of scope (the registry entries are all either monotonic
#: counters or snapshot-read-by-design); `__init__` is exempt
#: (construction is single-threaded by definition). These are exactly
#: the structures earlier reviews of this code found raced by hand: the
#: donated-slot ledger, the health snapshot's seq, the tracer's
#: metric cells.
SHARED_STATE: tuple[tuple[str, str, str], ...] = (
    ("DeviceSlotLedger", "_inflight", "_lock"),
    ("HealthSampler", "_seq", "_wlock"),
    ("Counter", "value", "_MLOCK"),
    ("Histogram", "count", "_MLOCK"),
    ("Histogram", "total", "_MLOCK"),
    ("Histogram", "min", "_MLOCK"),
    ("Histogram", "max", "_MLOCK"),
    ("_Injector", "_fired", "_lock"),
)

#: Calls that park the calling thread for unbounded/long time — doing
#: one while holding a lock starves every other waiter (the "gauge
#: published outside the lock" / "write_snapshot serialized" class,
#: inverted). Consumed by rules_lock._is_blocking in three forms:
#: exact dotted names, dotted-name prefixes, and attribute-call tails.
#: `.join()` is deliberately NOT here: the spelling is shared with
#: `str.join` (every f-string-averse formatter in the tree), and a
#: receiver-type analysis precise enough to split them doesn't fit a
#: lexical pass — thread joins under a lock surface via JT-LOCK-001's
#: call-graph edges instead when the joined worker takes locks.
BLOCKING_EXACT: frozenset[str] = frozenset({"time.sleep", "sleep"})
BLOCKING_PREFIXES: tuple[str, ...] = ("subprocess.",)
BLOCKING_METHOD_TAILS: frozenset[str] = frozenset({
    "block_until_ready",   # unbounded device wait
    "result",              # Future.result
})

#: Constructors whose instances are thread-safe by design: a Thread
#: target may share these with its spawner freely (JT-LOCK-004's
#: confinement rule skips them).
THREADSAFE_CTORS: frozenset[str] = frozenset({
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "Semaphore", "BoundedSemaphore", "Event", "Lock", "RLock",
    "Condition", "Barrier", "deque",
})


# ---------------------------------------------------------------------------
# JT-DUR — the store-artifact registry: every on-disk format a sweep
# persists, declared ONCE with its crash-consistency protocol.
# ---------------------------------------------------------------------------

#: The two-and-a-half durability protocols the package implements:
#:
#:   * `journal`  — append-only JSON lines, each record written as ONE
#:     `write()` and `flush()`ed as it lands; a crash tears at most
#:     the line in flight, which the reader skips and the next append
#:     seals (the VerdictJournal discipline).
#:   * `snapshot` — whole-file artifacts published via temp file +
#:     `os.replace` (`trace.atomic_write_text`): a reader sees the
#:     previous complete file or the new one, never bytes of both.
#:   * `spool`    — a journal owned by ONE process for ONE sweep,
#:     cleaned at the next sweep start (worker trace spools).
#:   * `marker`   — a tiny atomic pointer/flag (done markers, the
#:     latest/current symlinks): existence + content flip atomically.
#:   * `sidecar`  — a derived binary cache keyed by its source;
#:     written to a temp name and `os.replace`d, discarded (never
#:     trusted) on any mismatch.
PROTOCOLS = ("journal", "snapshot", "spool", "marker", "sidecar")

#: Declared retention classes — how an artifact is kept from growing
#: without bound. JT-DUR-005 requires every append-forever (journal/
#: spool) artifact to declare one:
#:
#:   * `rotated`        — size-capped, rotated by atomic rename
#:                        (events.jsonl under JEPSEN_TPU_EVENTS_MAX_BYTES);
#:   * `replaced`       — each write replaces the whole artifact;
#:   * `merged`         — periodically folded/deduplicated into one
#:                        file by a coordinator (per-shard costdbs);
#:   * `per-run`        — bounded by the run dir it lives in;
#:   * `per-sweep`      — cleared at the next sweep start;
#:   * `store-lifetime` — grows with the store; pruned only when the
#:                        store is recycled (verdict journals —
#:                        compaction is ROADMAP item 5).
RETENTION_CLASSES: frozenset[str] = frozenset({
    "rotated", "replaced", "merged", "per-run", "per-sweep",
    "store-lifetime",
})


@dataclass(frozen=True)
class StoreArtifact:
    """One declared on-disk artifact: where it lives, which protocol
    its writers/readers must speak, and who is sanctioned to speak it.
    `patterns` are fnmatch globs over the artifact's FILE NAME
    (store-root-relative for `root="store"`, compile-cache-relative
    for `root="cache"`, run-dir for the sidecars). `writers`/`readers`
    name the sanctioned helpers as `<module rel>:<qualname>`;
    `helpers` are path-constructor functions whose RETURN is this
    artifact's path — the fileflow pass resolves calls to them
    interprocedurally."""

    name: str
    patterns: tuple[str, ...]
    protocol: str
    writers: tuple[str, ...]
    readers: tuple[str, ...]
    retention: str | None
    doc: str
    root: str = "store"
    helpers: tuple[str, ...] = ()


STORE_ARTIFACTS: tuple[StoreArtifact, ...] = (
    StoreArtifact(
        "verdict journal", ("verdicts*.jsonl",), "journal",
        writers=("jepsen_tpu_torch/store.py:VerdictJournal.record",),
        readers=("jepsen_tpu_torch/store.py:VerdictJournal.load",),
        retention="store-lifetime",
        helpers=("shard_journal_path",),
        doc="resumable per-history verdict log (`verdicts-<k>.jsonl` "
            "per mesh shard); torn tail sealed on reopen, skipped on "
            "load; compaction is ROADMAP item 5"),
    StoreArtifact(
        "flight recorder", ("events.jsonl*",), "journal",
        writers=("jepsen_tpu_torch/obs/events.py:emit",),
        readers=("jepsen_tpu_torch/obs/events.py:load_events",),
        retention="rotated",
        doc="typed lifecycle events, one flushed line each; size-"
            "capped by `JEPSEN_TPU_EVENTS_MAX_BYTES` (atomic rename "
            "to `events.jsonl.1`, an `events_rotated` event opens "
            "the fresh log)"),
    StoreArtifact(
        "cost database", ("costdb*.jsonl",), "journal",
        writers=("jepsen_tpu_torch/store.py:append_costdb",
                 "jepsen_tpu_torch/mesh.py:merge_costdbs"),
        readers=("jepsen_tpu_torch/store.py:load_costdb",),
        retention="merged",
        helpers=("costdb_path",),
        doc="per-(executable, geometry) device cost records; mesh "
            "shards append `costdb-shard<k>.jsonl`, the coordinator "
            "replaces the merged `costdb.jsonl` atomically"),
    StoreArtifact(
        "analytics ledger", ("analytics*.jsonl",), "journal",
        writers=("jepsen_tpu_torch/store.py:append_analytics",
                 "jepsen_tpu_torch/mesh.py:merge_analytics"),
        readers=("jepsen_tpu_torch/store.py:load_analytics",),
        retention="merged",
        helpers=("analytics_path",),
        doc="kernel search telemetry (JEPSEN_TPU_KERNEL_STATS): one "
            "stats line per checked history (edge counts, closure "
            "rounds, SCC shape, decision-boundary margin); mesh "
            "shards append `analytics-shard<k>.jsonl`, the "
            "coordinator replaces the merged `analytics.jsonl` "
            "atomically"),
    StoreArtifact(
        # jt-lint: ok JT-TRACE-004 (the registry's declared pattern, not an ad-hoc spool writer)
        "worker trace spool", ("trace-*.jsonl",), "spool",
        writers=("jepsen_tpu_torch/trace.py:ensure_worker_tracer",
                 "jepsen_tpu_torch/trace.py:flush_worker_spool"),
        readers=("jepsen_tpu_torch/trace.py:load_spool",),
        retention="per-sweep",
        helpers=("spool_path",),
        doc="per-pid span spool of one sweep's pool workers; stale "
            "spools cleared at sweep start, merged into trace.json "
            "at sweep end"),
    StoreArtifact(
        "shard spool dir", ("spool-shard*",), "spool",
        writers=("jepsen_tpu_torch/trace.py:flush_worker_spool",),
        readers=("jepsen_tpu_torch/trace.py:merge_shard_traces",),
        retention="per-sweep",
        helpers=("shard_spool_dir",),
        doc="one mesh shard's spool subdirectory (two hosts' workers "
            "can share a pid); removed by the coordinator after a "
            "fully-covered merge"),
    StoreArtifact(
        "health snapshot", ("health.json",), "snapshot",
        writers=("jepsen_tpu_torch/obs/health.py:write_health",),
        readers=(),
        retention="replaced",
        doc="live progress/robustness/throughput snapshot, rewritten "
            "atomically every `JEPSEN_TPU_HEALTH_INTERVAL_S` seconds"),
    StoreArtifact(
        "sweep trace", ("trace.json", "trace-shard*.json"), "snapshot",
        writers=("jepsen_tpu_torch/trace.py:Tracer.export",
                 "jepsen_tpu_torch/trace.py:Tracer.export_merged",
                 "jepsen_tpu_torch/trace.py:export_shard_trace",
                 "jepsen_tpu_torch/mesh.py:_merge_trace_artifacts"),
        readers=("jepsen_tpu_torch/trace.py:load_shard_trace",),
        retention="replaced",
        helpers=("shard_trace_path",),
        doc="merged Chrome trace of the sweep (per-shard exports "
            "under a mesh, folded by the coordinator)"),
    StoreArtifact(
        "metrics export", ("metrics.json", "metrics-shard*.json"),
        "snapshot",
        writers=("jepsen_tpu_torch/trace.py:Tracer.export_metrics",
                 "jepsen_tpu_torch/mesh.py:_merge_trace_artifacts"),
        readers=("jepsen_tpu_torch/mesh.py:merge_shard_metrics",),
        retention="replaced",
        doc="the tracer's counters/gauges/histograms at sweep end"),
    StoreArtifact(
        "attribution report", ("report.json", "report.md"), "snapshot",
        writers=("jepsen_tpu_torch/obs/attribution.py:write_report",),
        readers=(),
        retention="replaced",
        doc="critical-path attribution (`analyze-store --report`)"),
    StoreArtifact(
        "shard done marker", (".shard-*.done",), "marker",
        writers=("jepsen_tpu_torch/supervisor.py:mark_shard_done",),
        readers=("jepsen_tpu_torch/supervisor.py:load_shard_done",),
        retention="per-sweep",
        helpers=("shard_done_path",),
        doc="one mesh shard's completion marker (exit code + counts), "
            "cleared at its own sweep start, polled by the "
            "coordinator's bounded wait"),
    StoreArtifact(
        "latest/current links", ("latest", "current"), "marker",
        writers=("jepsen_tpu_torch/store.py:Store._relink",),
        readers=(),
        retention="replaced",
        doc="monotonic symlinks to the newest run dir"),
    StoreArtifact(
        "serve tenant journal", ("serve-*.verdicts.jsonl",), "journal",
        writers=("jepsen_tpu_torch/store.py:VerdictJournal.record",),
        readers=("jepsen_tpu_torch/store.py:VerdictJournal.load",),
        retention="store-lifetime",
        helpers=("tenant_journal_path",),
        doc="one tenant's verdict log from the serve daemon — FULL "
            "result per line (journal-then-reply: written before the "
            "ack frame), replayed on reconnect without re-checking; "
            "compaction is ROADMAP item 5"),
    StoreArtifact(
        "serve request spool", ("serve-requests.jsonl",), "spool",
        writers=("jepsen_tpu_torch/serve/daemon.py:RequestSpool.append",),
        readers=("jepsen_tpu_torch/serve/daemon.py:RequestSpool.load",),
        retention="per-sweep",
        helpers=("request_spool_path",),
        doc="one flushed line per admitted request (tenant/id/"
            "checker) — crash triage for admitted-but-unverdicted "
            "work; cleared at daemon start"),
    StoreArtifact(
        "serve socket", ("serve.sock",), "marker",
        writers=("jepsen_tpu_torch/serve/daemon.py:VerdictDaemon._bind",),
        readers=(),
        retention="per-sweep",
        helpers=("serve_socket_path",),
        doc="the daemon's unix listen socket "
            "(JEPSEN_TPU_SERVE_SOCKET overrides); a stale one (prior "
            "daemon SIGKILLed) is probe-reclaimed at bind, removed at "
            "drain"),
    StoreArtifact(
        "serve pidfile", ("serve.pid",), "marker",
        writers=("jepsen_tpu_torch/serve/daemon.py:VerdictDaemon.start",),
        readers=(),
        retention="per-sweep",
        helpers=("serve_pid_path",),
        doc="the daemon's pid + listen address, published atomically "
            "(temp+`os.replace`), removed at drain"),
    StoreArtifact(
        "fleet member beacon", ("fleet-d*.json",), "snapshot",
        writers=("jepsen_tpu_torch/serve/daemon.py:"
                 "VerdictDaemon._write_beacon",),
        readers=("jepsen_tpu_torch/serve/fleet.py:"
                 "FleetRouter._wait_member_live",
                 "jepsen_tpu_torch/serve/fleet.py:FleetRouter._scan"),
        retention="replaced",
        helpers=("fleet_member_path",),
        doc="one fleet daemon's heartbeat (pid/epoch/load), "
            "atomically replaced every JEPSEN_TPU_FLEET_HEARTBEAT_S; "
            "the router reads liveness off the kernel mtime (clock-"
            "skew immune) and load off the payload; retired at clean "
            "drain, left to go stale by a crash"),
    StoreArtifact(
        "fleet epoch marker", ("fleet-epoch.json",), "snapshot",
        writers=("jepsen_tpu_torch/serve/fleet.py:FleetRouter._write_epoch",),
        readers=("jepsen_tpu_torch/serve/daemon.py:VerdictDaemon._fenced",),
        retention="replaced",
        helpers=("fleet_epoch_path",),
        doc="the fleet membership epoch (atomic replace), bumped "
            "BEFORE any tenant reassignment — the fence a resurrected "
            "zombie daemon checks between a fold's compute and its "
            "journal writes, so it can never double-serve a "
            "reassigned tenant"),
    StoreArtifact(
        "fleet reassignment journal", ("fleet-reassign.jsonl",),
        "journal",
        writers=("jepsen_tpu_torch/serve/fleet.py:"
                 "FleetRouter._append_reassign",),
        readers=("jepsen_tpu_torch/serve/fleet.py:load_reassignments",),
        retention="per-sweep",
        helpers=("fleet_reassign_path",),
        doc="one line per failover move (epoch, dead member, tenant, "
            "successor, in-flight count) — the router's reassignment "
            "evidence for post-mortems; cleared at router start"),
    StoreArtifact(
        "fleet router socket", ("fleet.sock",), "marker",
        writers=("jepsen_tpu_torch/serve/fleet.py:FleetRouter._bind",),
        readers=(),
        retention="per-sweep",
        helpers=("fleet_socket_path",),
        doc="the router's tenant-facing unix listen socket; a stale "
            "one is probe-reclaimed at bind, removed at stop"),
    StoreArtifact(
        "fleet daemon socket", ("fleet-d*.sock",), "marker",
        writers=("jepsen_tpu_torch/serve/daemon.py:VerdictDaemon._bind",),
        readers=(),
        retention="per-sweep",
        helpers=("fleet_daemon_socket_path",),
        doc="fleet daemon <k>'s own listen socket (the router proxies "
            "tenant frames to it here); same probe-reclaim rule as "
            "serve.sock"),
    StoreArtifact(
        "dispatch plan", ("plan.json",), "snapshot",
        writers=("jepsen_tpu_torch/planner.py:save_plan",),
        readers=("jepsen_tpu_torch/planner.py:load_plan",),
        retention="replaced",
        helpers=("plan_path",),
        doc="the cost-aware planner's fitted model "
            "(JEPSEN_TPU_PLANNER): per-mode device-seconds "
            "coefficients fit from costdb × analytics, published "
            "temp+`os.replace` at sweep end; a corrupt or stale plan "
            "degrades to the deterministic heuristic fallback, never "
            "to a failed sweep"),
    StoreArtifact(
        "encoded sidecar", ("encoded*.bin",), "sidecar",
        writers=("jepsen_tpu_torch/store.py:save_encoded",),
        readers=("jepsen_tpu_torch/store.py:load_encoded",),
        retention="per-run",
        helpers=("encoded_cache_path",),
        doc="flat binary encode cache next to history.jsonl, keyed "
            "by the history's size/mtime/xxh64; written temp + "
            "`os.replace`, discarded on any key mismatch"),
    StoreArtifact(
        "kernel library cache", ("*.so",), "snapshot",
        writers=("jepsen_tpu_torch/_build.py:build",),
        readers=("jepsen_tpu_torch/_build.py:load",),
        retention="replaced",
        root="cache",
        doc="the compiled `csrc/` libraries under "
            "`jepsen_tpu_torch/_build/<name>-<key>.so`, keyed by the "
            "source, the flags and the compiler; written to a "
            "temporary name and renamed into place, so an edited "
            "source builds anew and a torn build is never loaded"),
    StoreArtifact(
        "torch profile capture",
        ("torch-profile", "torch-profile-shard*"), "sidecar",
        writers=("jepsen_tpu_torch/trace.py:profile_session",),
        readers=(),
        retention="store-lifetime",
        doc="`torch.profiler` trace dir (JEPSEN_TPU_JAX_PROFILE; one "
            "per mesh shard)"),
)

#: Path-constructor helper name -> the artifact whose path it returns
#: (the fileflow pass's interprocedural edge: a call to one of these
#: resolves to the artifact wherever it appears).
PATH_HELPERS: dict[str, StoreArtifact] = {
    h: a for a in STORE_ARTIFACTS for h in a.helpers
}


def artifact_for_name(tail: str) -> StoreArtifact | None:
    """The declared artifact a file-name skeleton belongs to, or None
    (= an UNdeclared store write, JT-DUR-001). Skeletons carry `*` for
    interpolated segments; fnmatch treats the pattern's own `*` as the
    wildcard, so `costdb-shard*.jsonl` matches `costdb*.jsonl`."""
    for a in STORE_ARTIFACTS:
        for p in a.patterns:
            if fnmatchcase(tail, p):
                return a
    return None


#: README markers for the generated "Store durability" table — the
#: env-gate table's pattern: edit the registry, run `python -m jepsen_tpu_torch.lint --tables`,
#: JT-DUR-006 fails the build on drift.
DUR_BEGIN = ("<!-- store-durability:begin "
             "(generated by jepsen_tpu_torch.lint.contracts) -->")
DUR_END = "<!-- store-durability:end (jepsen_tpu_torch.lint.contracts) -->"


def _short(spec: str) -> str:
    """`store.py:VerdictJournal.record` for the table cell."""
    return spec.replace("jepsen_tpu_torch/", "")


def render_dur_table() -> str:
    rows = ["| artifact | pattern | protocol | retention | "
            "writer → reader |", "|---|---|---|---|---|"]
    for a in STORE_ARTIFACTS:
        pats = " ".join(f"`{p}`" for p in a.patterns)
        w = ", ".join(_short(s) for s in a.writers) or "—"
        r = ", ".join(_short(s) for s in a.readers) or "—"
        rows.append(f"| {a.name} | {pats} | {a.protocol} | "
                    f"{a.retention or '—'} | {w} → {r} |")
    return "\n".join(rows)


def render_dur_block() -> str:
    return f"{DUR_BEGIN}\n{render_dur_table()}\n{DUR_END}"


# ---------------------------------------------------------------------------
# JT-ORD — happens-before contracts of the serve/fleet protocol
# ---------------------------------------------------------------------------

#: Marker syntax (matched per CFG pseudo-instruction, headers only for
#: compound statements):
#:
#:   ``call:<glob>``          a statement containing a call whose
#:                            loosely-dotted callee (subscript links
#:                            render as ``[]``: ``ent[].record``)
#:                            fnmatches the glob;
#:   ``call:<glob>{op=<v>}``  additionally requires a positional arg
#:                            that is a dict LITERAL with "op" == v
#:                            (frames built elsewhere stay unmatched
#:                            on purpose — the marker names a specific
#:                            emission, not a variable);
#:   ``set:<name>``           an assignment/augassign/annassign whose
#:                            target is the bare name or attribute
#:                            ``<name>``.
#:
#: Kinds — all proved path-sensitively on cfg.py graphs (finally
#: bodies routed, branch polarity recorded):
#:
#:   ``dominates``      first lies on EVERY entry→second path;
#:   ``postdominates``  second lies on EVERY first→exit path
#:                      (exception edges included);
#:   ``between``        mid lies on EVERY first→second path;
#:   ``never-after``    no path from first ever reaches second;
#:   ``under-lock``     first executes with ``lock`` MUST-held.
#:
#: ``guard`` names a bare local flag assigned exactly once: paths
#: taking the false arm of an ``if <guard>:`` are pruned, so a
#: release guarded by the same flag as its acquire is not a false
#: leak. Pruning is skipped (conservative) if the flag is ever
#: reassigned.

@dataclass(frozen=True)
class OrderContract:
    rule: str       #: JT-ORD rule id that proves this entry
    file: str       #: repo-relative module the contract lives in
    func: str       #: qualname within the module (iter_defs form)
    kind: str       #: dominates|postdominates|between|never-after|under-lock
    first: str      #: marker (see syntax above)
    second: str = ""
    mid: str = ""
    guard: str = ""
    lock: str = ""
    doc: str = ""


ORDER_CONTRACTS: tuple[OrderContract, ...] = (
    OrderContract(
        rule="JT-ORD-001",
        file="jepsen_tpu_torch/serve/daemon.py",
        func="VerdictDaemon._run_fold",
        kind="dominates",
        first="call:*.record",
        second="call:*.send",
        doc="journal-then-reply: the journal append dominates every "
            "reply-frame send, so an ack can only name a verdict the "
            "journal already holds (or explicitly flags journaled: "
            "false)"),
    OrderContract(
        rule="JT-ORD-002",
        file="jepsen_tpu_torch/serve/daemon.py",
        func="VerdictDaemon._run_fold",
        kind="between",
        first="call:*.verdicts",
        mid="call:*._fenced",
        second="call:*.record",
        doc="the zombie fence: the epoch-fence read lies on every "
            "path between a fold's dispatch and its journal write"),
    OrderContract(
        rule="JT-ORD-002",
        file="jepsen_tpu_torch/serve/daemon.py",
        func="VerdictDaemon._run_fold",
        kind="never-after",
        first="call:*.request_drain",
        second="call:*.record",
        doc="a fenced fold drains and drops: once the fold entered "
            "the fenced path no journal write may follow — the "
            "successor is already journaling these ids"),
    OrderContract(
        rule="JT-ORD-003",
        file="jepsen_tpu_torch/serve/fleet.py",
        func="FleetRouter._fail_over",
        kind="dominates",
        first="call:*._write_epoch",
        second="call:os.kill",
        doc="fence before STONITH: the epoch bump is durably "
            "published (temp+os.replace) before the dead member's "
            "process is signalled"),
    OrderContract(
        rule="JT-ORD-003",
        file="jepsen_tpu_torch/serve/fleet.py",
        func="FleetRouter._fail_over",
        kind="dominates",
        first="call:*._write_epoch",
        second="call:*.send{op=adopt}",
        doc="fence before adoption: a successor only learns it owns "
            "a tenant after the epoch fence that stops the old "
            "owner is on disk"),
    OrderContract(
        rule="JT-ORD-003",
        file="jepsen_tpu_torch/serve/fleet.py",
        func="FleetRouter._fail_over",
        kind="never-after",
        first="call:*.send{op=adopt}",
        second="call:os.kill",
        doc="STONITH precedes adoption and never follows it: "
            "signalling the old owner after a successor adopted "
            "would be fencing out of order"),
    OrderContract(
        rule="JT-ORD-004",
        file="jepsen_tpu_torch/parallel/__init__.py",
        func="_sync_check",
        kind="postdominates",
        first="call:_enqueue",
        second="call:*.discard_dispatch",
        doc="no leaked in-flight window: the cost observatory's "
            "release of the retry's pending dispatch window (a no-op "
            "once `_resolve` closed it) post-dominates the observed "
            "enqueue on every exit path, exception edges included, so "
            "the in-flight bytes gauge never keeps a dead dispatch"),
    OrderContract(
        rule="JT-ORD-005",
        file="jepsen_tpu_torch/serve/scheduler.py",
        func="Admission.close",
        kind="under-lock",
        first="set:_closed",
        lock="self._cv",
        doc="admission close happens under its condition variable: "
            "a waiter never misses the wakeup that tells it the "
            "queue closed"),
    OrderContract(
        rule="JT-ORD-005",
        file="jepsen_tpu_torch/serve/daemon.py",
        func="VerdictDaemon.request_drain",
        kind="dominates",
        first="call:*.close",
        second="call:*._draining.set",
        doc="close-before-drain-visible: admission is closed before "
            "the draining flag becomes observable, so the scheduler "
            "can never see draining ∧ pending==0 while a reader can "
            "still admit a request nobody will serve"),
)
