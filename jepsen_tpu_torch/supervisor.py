"""The supervision policy of a sweep: retry, quarantine and fail-fast.

Counterpart of `jepsen_tpu/supervisor.py` (the sentinels, the gates'
readers and the self-nemesis). A run or bucket the sweep abandons is
recorded as `valid? unknown`, never as valid or invalid, and the sweep
goes on:

  * **Quarantine** — a history whose encode fails, or whose bucket
    exhausts its recovery, becomes a `Quarantined` sentinel and then a
    ``{"valid?": "unknown", "error": ...}`` verdict
    (`quarantine_verdict`).
  * **OOM backdown** — `parallel.check_bucketed_async` catches a device
    OOM (`is_oom_error`: `torch.cuda.OutOfMemoryError`, or the
    injected one), splits the bucket in half and retries at a halved
    cell budget, down to singletons; an oversized singleton
    quarantines.
  * **Watchdog** — `JEPSEN_TPU_DISPATCH_TIMEOUT_S` (default off)
    bounds each bucket's device wait; one retry, then `WatchdogTimeout`
    and the bucket quarantines.
  * **Self-nemesis** — `JEPSEN_TPU_FAULT_INJECT` (e.g.
    ``encode:0.05,oom:first``) injects encode failures and simulated
    OOMs deterministically, so every recovery path runs without real
    faults.

``JEPSEN_TPU_STRICT=1`` restores fail-fast on every path (injection
still fires, so a strict run under the nemesis dies loudly).

What must end a sweep is never quarantined (`must_end_sweep`): a
kernel that cannot be built or launched, a missing device, a CUDA
error other than an OOM (it poisons the context), and interrupts.

Mesh shards (`analyze-store --mesh`) leave a done marker each,
`.shard-<k>.done`, which the coordinator polls with a bounded wait
(`wait_for_shards`): a shard with none is lost and re-assignable, never
a dead sweep.

Left out: the reference's device-slot ledger and donation gate (a
bucket's inputs go back to PyTorch's caching allocator, in stream
order, when they are dropped).

The module imports no torch at load time (only `is_oom_error` and
`must_end_sweep` need it): `ingest.encode_run_dir` calls the
self-nemesis in every pooled encode worker, and a worker must stay as
cheap to start as the reference's.
"""

from __future__ import annotations

import os
import threading
import zlib

from . import gates

_M = 1_000_000


class InjectedFault(RuntimeError):
    """A fault raised by the self-nemesis (JEPSEN_TPU_FAULT_INJECT)."""


class InjectedOom(RuntimeError):
    """A simulated device OOM ('RESOURCE_EXHAUSTED' is in the message,
    so `is_oom_error` classifies it as it does the real thing)."""


class WatchdogTimeout(RuntimeError):
    """A device dispatch exceeded JEPSEN_TPU_DISPATCH_TIMEOUT_S twice."""


class Quarantined:
    """Per-history sentinel verdict for work the supervisor abandoned:
    it flows through `PendingVerdicts.result` / `check_bucketed` in
    place of an anomaly dict, and callers render it as a
    ``valid? unknown`` verdict (`.verdict()`)."""

    __slots__ = ("stage", "error")

    def __init__(self, stage: str, error: str):
        # "encode" | "oom" | "watchdog" | "pack" | "stored" | "check"
        self.stage = stage
        self.error = error

    def __repr__(self) -> str:
        return f"Quarantined({self.stage}: {self.error})"

    def verdict(self, checker: str | None = None) -> dict:
        return quarantine_verdict(self.error, self.stage, checker)


def quarantine_verdict(error, stage: str,
                       checker: str | None = None) -> dict:
    """The one shape every quarantine path records: validity is
    *unknown* (exit code 2), never false — an abandoned history is not
    evidence of an anomaly — with the cause preserved for triage."""
    res = {"valid?": "unknown", "error": str(error)[:500],
           "quarantined": stage}
    if checker is not None:
        res["checker"] = checker
    return res


def strict_enabled() -> bool:
    """JEPSEN_TPU_STRICT=1 restores fail-fast: no quarantine, no OOM
    backdown — the first failure raises to the caller."""
    return gates.get("JEPSEN_TPU_STRICT")


def dispatch_timeout_s() -> float | None:
    """The per-dispatch device watchdog (JEPSEN_TPU_DISPATCH_TIMEOUT_S,
    seconds; unset, empty or <= 0 disables it — the default, because a
    healthy closure of a huge bucket can legitimately run minutes)."""
    t = gates.get("JEPSEN_TPU_DISPATCH_TIMEOUT_S")
    return t if t is not None and t > 0 else None


def is_oom_error(e: BaseException) -> bool:
    """Device memory exhaustion: PyTorch's CUDA OOM by type, or the
    RESOURCE_EXHAUSTED status string the injected OOM carries."""
    if isinstance(e, InjectedOom) or "RESOURCE_EXHAUSTED" in str(e):
        return True
    import torch
    return isinstance(e, torch.cuda.OutOfMemoryError)


def must_end_sweep(e: BaseException) -> bool:
    """Failures no quarantine may hide: interrupts and exits, a kernel
    that cannot be built or launched, a missing device, and a CUDA
    error other than an OOM (an illegal address poisons the context,
    so every later bucket would fail too)."""
    from . import _build
    from .devices import DeviceUnavailable
    if not isinstance(e, Exception) or isinstance(
            e, (_build.KernelBuildError, _build.KernelLaunchError,
                DeviceUnavailable)):
        return True
    if is_oom_error(e):
        return False
    import torch
    return isinstance(e, getattr(torch, "AcceleratorError", ())) \
        or "CUDA error" in str(e)


# ---------------------------------------------------------------------------
# Mesh shards' done markers (analyze-store --mesh).
#
# Each shard writes `.shard-<k>.done` atomically (its exit code and the
# shard geometry) once its journal and trace artifacts are final; the
# coordinator polls the markers up to JEPSEN_TPU_MESH_WAIT_S and counts
# the shards still missing as lost: their runs are unverdicted and the
# operator re-runs that shard anywhere with
# `JEPSEN_TPU_MESH_SHARD=<k> ... --resume` (its journal is the resume
# evidence).
# ---------------------------------------------------------------------------

def shard_done_path(store_base, shard: int):
    from pathlib import Path
    return Path(store_base) / f".shard-{shard}.done"


def mark_shard_start(store_base, shard: int) -> None:
    """Clear this shard's done marker of an earlier sweep, so the
    coordinator cannot merge against that sweep's completion."""
    try:
        shard_done_path(store_base, shard).unlink(missing_ok=True)
    except OSError:
        pass


def mark_shard_done(store_base, shard: int, payload: dict) -> None:
    """Write this shard's done marker atomically (best-effort: a
    read-only store must not turn a finished shard into a crash)."""
    import json

    from . import trace
    try:
        trace.atomic_write_text(shard_done_path(store_base, shard),
                                json.dumps(payload))
    except OSError:
        pass


def load_shard_done(store_base, shard: int) -> dict | None:
    import json
    try:
        v = json.loads(shard_done_path(store_base, shard).read_text())
        return v if isinstance(v, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def wait_for_shards(store_base, shards, timeout_s: float,
                    poll_s: float = 0.25):
    """Poll the done markers of `shards` until all have landed or
    `timeout_s` has passed. Returns (done: {shard: marker payload},
    lost: [shard, ...]); a lost shard is re-assignable, not fatal."""
    import time

    shards = list(shards)
    deadline = time.monotonic() + max(0.0, float(timeout_s or 0.0))
    done: dict[int, dict] = {}
    while True:
        for k in shards:
            if k not in done:
                p = load_shard_done(store_base, k)
                if p is not None:
                    done[k] = p
        missing = [k for k in shards if k not in done]
        if not missing or time.monotonic() >= deadline:
            return done, missing
        time.sleep(min(poll_s, max(0.01,
                                   deadline - time.monotonic())))


# ---------------------------------------------------------------------------
# Self-nemesis: deterministic fault injection (JEPSEN_TPU_FAULT_INJECT)
# ---------------------------------------------------------------------------
#
# Spec grammar: comma-separated `mode:arg` pairs.
#
#   encode:<rate>   fail the encode of the run dirs whose name hashes
#                   under <rate> (0..1) — deterministic per run dir, so
#                   the same histories fail in every process.
#   encode:first / encode:<N>
#                   fail the first (N) encodes in this process.
#   kill:<rate|first|N>
#                   the same selection; a pool worker flushes its trace
#                   spool and SIGKILLs itself (the sweep resumes
#                   serially), in the parent it degrades to an encode
#                   fault, never a dead sweep.
#   oom:<first|N>   raise a simulated RESOURCE_EXHAUSTED on the first
#                   (N) bucket dispatches of this process.
#
# State is process-local and rebuilt whenever the env spec changes.

class _Injector:
    def __init__(self, spec: str):
        self.spec = spec
        self.modes: dict[str, tuple[str, float]] = {}
        self._lock = threading.Lock()
        self._fired: dict[str, int] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part or ":" not in part:
                continue
            mode, _, arg = part.partition(":")
            mode, arg = mode.strip(), arg.strip()
            if arg == "first":
                self.modes[mode] = ("count", 1)
            else:
                try:
                    v = float(arg)
                except ValueError:
                    continue
                if "." in arg or (0 < v < 1):
                    self.modes[mode] = ("rate", v)
                else:
                    self.modes[mode] = ("count", int(v))

    def selects(self, mode: str, name: str | None = None) -> bool:
        """Does `mode` fire for this event? Rate modes hash `name`
        (deterministic everywhere); count modes burn one of N
        per-process charges."""
        m = self.modes.get(mode)
        if m is None:
            return False
        kind, arg = m
        if kind == "rate":
            h = zlib.crc32((name or "").encode()) % _M
            return h < int(arg * _M)
        with self._lock:
            if self._fired.get(mode, 0) >= arg:
                return False
            self._fired[mode] = self._fired.get(mode, 0) + 1
            return True


_injector: _Injector | None = None
_inj_lock = threading.Lock()


def _get_injector() -> _Injector | None:
    spec = gates.get("JEPSEN_TPU_FAULT_INJECT")
    global _injector
    inj = _injector
    if inj is None or inj.spec != spec:
        if not spec:
            _injector = None
            return None
        with _inj_lock:
            inj = _injector
            if inj is None or inj.spec != spec:
                inj = _injector = _Injector(spec)
    return inj


def reset_injection() -> None:
    """Drop the per-process injection state (tests re-arm count
    modes)."""
    global _injector
    _injector = None


def _in_pool_worker() -> bool:
    import multiprocessing as mp
    return mp.parent_process() is not None


def maybe_inject_encode_fault(run_dir) -> None:
    """The encode-side nemesis hook, at the top of
    `ingest.encode_run_dir`: raises InjectedFault for a selected run
    dir, or, for kill mode in a pool worker, SIGKILLs the worker (in
    the parent, kill degrades to a raise: the nemesis never kills the
    sweep itself). Each injection leaves a `fault_inject` mark on the
    current tracer, in a worker its own, which kill mode flushes to the
    worker's spool first: a SIGKILLed process writes nothing after."""
    inj = _get_injector()
    if inj is None:
        return
    name = os.path.basename(str(run_dir).rstrip("/"))
    if inj.selects("kill", name):
        from . import trace
        trace.get_current().instant("fault_inject", kind="kill", run=name)
        if _in_pool_worker():
            trace.flush_worker_spool()
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedFault(f"injected worker kill for {name!r} "
                            "(parent process: degraded to encode fault)")
    if inj.selects("encode", name):
        from . import trace
        trace.get_current().instant("fault_inject", kind="encode",
                                    run=name)
        raise InjectedFault(f"injected encode fault for {name!r}")


def maybe_inject_oom() -> None:
    """The dispatch-side nemesis hook, just before each bucket's
    enqueue in `parallel`."""
    inj = _get_injector()
    if inj is not None and inj.selects("oom"):
        raise InjectedOom("RESOURCE_EXHAUSTED: injected device OOM "
                          "(JEPSEN_TPU_FAULT_INJECT)")
