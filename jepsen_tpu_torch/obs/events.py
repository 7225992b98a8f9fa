"""The flight-recorder event log: `<store>/events.jsonl`.

Counterpart of `jepsen_tpu/obs/events.py`, copied whole. trace.json is
written at exit, so a sweep that dies by SIGKILL leaves no causal
record of what it was doing; the flight recorder closes that gap the
way the verdict journal does for verdicts: every lifecycle event
appends one JSON line, written and flushed as it happens.

Events are typed: `emit(kind, **fields)` refuses a kind not declared in
`EVENT_KINDS` (a typo fails loudly instead of forking the stream).
Each emit is one `open(append) → write one line → close`, so emitters
on several threads interleave at line granularity and a crash tears at
most the line in flight — `load_events` skips unparseable lines. With
`JEPSEN_TPU_EVENTS_MAX_BYTES` set, a log over the cap is renamed aside
to `events.jsonl.1` (atomic `os.replace`) and the fresh log opens with
an `events_rotated` event naming it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path

log = logging.getLogger(__name__)

EVENTS_NAME = "events.jsonl"

#: The declared event kinds. An undeclared kind raises ValueError at
#: emit time — the event stream is an API surface, not a scratch pad.
EVENT_KINDS = frozenset({
    "sweep_start",        # checker, runs, resume
    "sweep_resume",       # skipped (already-journaled runs)
    "sweep_end",          # exit_code
    "quarantine",         # stage, cause, histories|run
    "oom_split",          # histories (bucket size being halved)
    "watchdog_fire",      # timeout_s, attempt
    "journal_seal",       # path (crash-torn journal tail sealed)
    "cache_rebuild",      # path (corrupt/stale sidecar discarded)
    "health_sample",      # seq (periodic heartbeat mark, first+last)
    "metrics_serve",      # port (endpoint came up)
    "shard_done",         # shard, exit_code (mesh shard completed)
    "shard_lost",         # shard, shards (no done marker at merge —
    #                       re-assignable via JEPSEN_TPU_MESH_SHARD)
    "costdb_flush",       # path, records (device cost observatory
    #                       appended its per-executable records)
    "analytics_flush",    # path, records (kernel search telemetry
    #                       appended its per-history stats lines)
    "events_rotated",     # rotated_to, size (the log hit
    #                       JEPSEN_TPU_EVENTS_MAX_BYTES and was
    #                       renamed aside; first line of the new log)
    # -- the serve_* group: the verdict daemon's lifecycle ---------------
    "serve_start",        # socket|port, store (daemon accepting)
    "serve_tenant_connect",   # tenant, weight, journaled (replayable)
    "serve_admit",        # histories, tenants (one continuous-batch
    #                       fold formed from the admission queues)
    "serve_backpressure",  # tenant, depth (explicit retry-after frame
    #                       sent — a full queue never drops silently)
    "serve_drain",        # pending, reason (SIGTERM/stop: admission
    #                       closed, queued work finishing)
    "serve_stop",         # verdicts, drained (daemon exit)
    # -- the fleet_* group: the serve-fleet router's lifecycle -----------
    "fleet_start",        # daemons, socket, epoch (router accepting)
    "fleet_daemon_up",    # instance, pid (beacon observed live)
    "fleet_daemon_dead",  # instance, cause (beacon stale / conn
    #                       refused / process exit — fenced next)
    "fleet_failover",     # instance, successor, tenants, epoch (dead
    #                       daemon's tenants reassigned; journals
    #                       replay on the successor)
    "fleet_spill",        # tenant, affine, chosen, depth (backpressure
    #                       routed a check off its affine daemon)
    "fleet_fence",        # instance, epoch (a fenced daemon observed
    #                       its own death mark and dropped a fold
    #                       instead of double-serving — zombie fence)
    "fleet_stop",         # verdicts, daemons (router exit)
})

_lock = threading.Lock()
_path: Path | None = None


def install_events(store_base) -> Path | None:
    """Point the flight recorder at `<store_base>/events.jsonl`.
    Best-effort: an uncreatable directory leaves the recorder
    uninstalled rather than sinking the sweep."""
    global _path
    base = Path(store_base)
    if not base.is_dir():
        # a sweep of a nonexistent store is a usage error (exit 254);
        # the recorder must not fabricate the directory for it
        _path = None
        return None
    _path = base / EVENTS_NAME
    return _path


def reset_events() -> None:
    """Uninstall the recorder (emit becomes a no-op)."""
    global _path
    _path = None


def current_path() -> Path | None:
    return _path


def _max_bytes() -> int | None:
    """The JEPSEN_TPU_EVENTS_MAX_BYTES rotation cap (unset/<=0 = off,
    the default) — the registry-declared `rotated` retention class of
    the flight recorder, made real."""
    from .. import gates
    v = gates.get("JEPSEN_TPU_EVENTS_MAX_BYTES")
    return v if v is not None and v > 0 else None


#: A crashed rotator's lockfile is broken after this many seconds —
#: rotation pauses (the log grows past the cap), it never loses data.
_ROTLOCK_STALE_S = 60.0


def _maybe_rotate(p: Path) -> str | None:
    """Rotate the log aside (atomic rename to `<name>.1`) when it
    exceeds the cap; returns the `events_rotated` line to open the
    fresh log with, or None. `_lock` serializes threads; PROCESSES
    (mesh shards share one store log) are serialized by an
    O_CREAT|O_EXCL lockfile, and the size is re-stat'ed after the
    claim — a stale pre-claim stat from a racing emitter can't
    rename the freshly-rotated log over the generation it just kept.
    Losing the claim (or any OSError) skips rotation for this emit:
    the next emit retries, nothing is lost."""
    cap = _max_bytes()
    if cap is None:
        return None
    try:
        if p.stat().st_size < cap:
            return None
    except OSError:
        return None
    lock = p.with_name(p.name + ".rotlock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        # another process holds the rotation; break only a stale
        # lock (its holder crashed mid-rotation) and retry NEXT
        # emit. The break is rename-then-verify, never unlink-by-
        # path: between our staleness stat and the unlink a live
        # claimant could have replaced the stale lock, and deleting
        # ITS claim would let two rotators run at once. os.rename is
        # atomic (exactly one breaker gets the inode), and the
        # renamed file's mtime proves which lock we actually took —
        # a live claim is renamed straight back.
        try:
            if time.time() - lock.stat().st_mtime <= _ROTLOCK_STALE_S:
                return None
            breaking = lock.with_name(f"{lock.name}.{os.getpid()}")
            os.rename(lock, breaking)
            if time.time() - breaking.stat().st_mtime \
                    > _ROTLOCK_STALE_S:
                os.unlink(breaking)        # broke the crashed holder
            else:
                os.rename(breaking, lock)  # stole a live claim: undo
        except OSError:
            pass
        return None
    except OSError:
        return None
    try:
        os.close(fd)
        # re-stat under the lock: the crossing this emit observed may
        # already have been rotated by the previous lock holder
        try:
            size = p.stat().st_size
        except OSError:
            return None
        if size < cap:
            return None
        rotated = p.with_name(p.name + ".1")
        try:
            os.replace(p, rotated)
        except OSError:
            log.debug("events rotation failed for %s", p,
                      exc_info=True)
            return None
        return json.dumps({"event": "events_rotated",
                           "t_mono": round(time.monotonic(), 6),
                           "t_wall": round(time.time(), 6),
                           "pid": os.getpid(),
                           "rotated_to": rotated.name,
                           "size": size}) + "\n"
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def emit(kind: str, **fields) -> bool:
    """Append one typed event; returns True when a line was written.
    No-op (False) when no log is installed — callers never guard.
    Undeclared kinds raise: that is a bug in the caller, caught by
    the tests long before production."""
    if kind not in EVENT_KINDS:
        raise ValueError(f"undeclared obs event kind {kind!r} "
                         "(declare it in obs.events.EVENT_KINDS)")
    p = _path
    if p is None:
        return False
    rec = {"event": kind,
           "t_mono": round(time.monotonic(), 6),
           "t_wall": round(time.time(), 6),
           "pid": os.getpid(), **fields}
    try:
        line = json.dumps(rec) + "\n"
    except (TypeError, ValueError):
        log.debug("unserializable obs event %r dropped", kind,
                  exc_info=True)
        return False
    try:
        with _lock:
            rot = _maybe_rotate(p)
            if rot is not None:
                # the rotation mark and the record open the fresh log
                # as ONE write — a crash between two writes would
                # leave a log whose first record isn't the rotation
                line = rot + line
            with open(p, "a") as f:
                f.write(line)
                f.flush()
        return True
    except OSError:
        # a read-only store mount must not sink the sweep
        log.debug("obs event append failed for %s", p, exc_info=True)
        return False


def load_events(path) -> list[dict]:
    """Events from an existing log, in file order; unparseable lines
    (the crash-torn tail) are skipped, mirroring VerdictJournal.load."""
    out: list[dict] = []
    p = Path(path)
    if p.is_dir():
        p = p / EVENTS_NAME
    if not p.is_file():
        return out
    try:
        lines = p.read_text().splitlines()
    except OSError:
        return out
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            e = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(e, dict) and "event" in e:
            out.append(e)
    return out
