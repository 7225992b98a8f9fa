"""Bucketed batch dispatch: many encoded histories, one device, under
supervision.

Counterpart of `jepsen_tpu/parallel/__init__.py`. `check_bucketed_async`
packs each length bucket on the host, copies it to the device and
enqueues its check without waiting for the device: the closure loop and
the fused classifier's branch run on the device (`kernels`), so an
enqueue returns at once and `PendingVerdicts` reads the flags later.
With `max_inflight=2` a "pack-h2d" thread packs and copies bucket N+1
(pinned host memory, its own CUDA stream) while the device checks
bucket N. The supervisor's policy (`supervisor`) wraps it: an OOM splits
the bucket in half at half the budget, down to singletons; a dispatch
that outlasts the watchdog twice, or a bucket that fails to pack, is
quarantined alone (`Quarantined`), and `JEPSEN_TPU_STRICT=1` re-raises
instead. A bucket's packed inputs go back to PyTorch's caching
allocator, in stream order, as soon as its check is enqueued (the
reference donates them to XLA instead).

One history past `DENSE_TXN_LIMIT` txns goes through
`check_long_history`, which condenses it to its strongly connected
components first.

The sweep tracer (`trace`) sees what the reference's sees: "pack",
"h2d", "feed", "dispatch" and "collect" phase spans (also summed into a
caller's `phases` dict), a "bucket" window on the device track from each
bucket's enqueue to the host seeing its CUDA event complete, the
counters `h2d_bytes`, `warm_copy_bytes`, `pad_waste_cells`,
`buckets_dispatched`, `buckets_resolved`, `quarantined`, `oom_retries`,
`bucket_splits` and `watchdog_timeouts`, the `inflight_depth` gauge,
the `bucket_cells` histogram, and the flight recorder's `quarantine`,
`oom_split` and `watchdog_fire` events. A dispatch of host-built edge dicts (the wr
sweep, a condensed run's SCCs) records only its watchdog, as the
reference's `check_edge_batch` does. With `with_stats` /
`stats_out` each bucket's check also computes the kernel-stats matrix
(`kernels.STAT_FIELDS`), read with the flags when the bucket resolves.

With `JEPSEN_TPU_COSTDB` the device cost observatory (`obs.device`)
brackets each bucket dispatch of encoded histories at the reference's
points — opened at each enqueue of `check_bucketed_async` and
`_sync_check`, closed when the bucket resolves, discarded when it goes
to quarantine or the OOM backdown — with two CUDA events on the compute
stream. With `JEPSEN_TPU_PLANNER` the cost-aware planner (`planner`)
composes `check_bucketed_async`'s buckets and picks `check_bucketed`'s
fused or two-pass classify. Neither touches an edge batch or
`check_long_history`, as in the reference.

Several devices: a `Mesh` is a dp×mp grid of torch devices with the
reference's axes — dp over histories, mp over the columns of each
history's closure matrices — built by `make_mesh`, `host_local_mesh`
and `sp_mesh` with the reference's shapes, and by `dp_mesh` (N×1, the
mesh the port's own sweeps and folds build). A mesh may repeat a device
(a card, or the CPU, standing in for several, as the reference's tests
use virtual XLA devices). `check_bucketed_async(..., mesh=)` pads each
bucket to a multiple of dp by replicating its last history (the
replicas' results are dropped), splits it into dp contiguous rows,
copies each row to its row's first device (pinned memory, a copy stream
per device: `shard_batch`) and enqueues each row's check there
(`sharded_check_fn`); a row of several devices squares each closure
round as one column block per device (`closure_square`'s `cols`) and
exchanges the blocks and the round's active word between them on the
device (`kernels._closure_batched`). The rows' flags are gathered onto
the mesh's first device, and the dispatch's done event is one per
device, each waited on by the watchdog. A bucket whose padding would
pass the budget is dispatched unsharded on the first device, and a mesh
of one device is the single-device path itself. Nothing here is a
compiled graph: the reference's jit memo has no counterpart.

A process holds only its own devices. Several processes join a job
through `init_distributed` (the reference's coordinator variables, a
`torch.distributed` gloo group); `analyze-store --mesh` takes its shard
identity from it (`mesh.resolve_shard`), and `check_joined` spreads one
batch over the processes: each rank checks its contiguous slice on its
own mesh and the flags are all-gathered over gloo (host bytes; no
device collective).
"""

from __future__ import annotations

import logging
import math
import queue as _queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from .. import gates
from ..util import pad_to_multiple
from .. import planner as _planner
from .. import supervisor as sv
from .. import trace
from ..checker.elle import kernels as K
from ..obs import device as obs_device
from ..obs import events as obs_events

log = logging.getLogger(__name__)

# Above this txn count the dense [T,T] closure no longer fits a device;
# check_long_history switches to SCC condensation (elle.condense).
DENSE_TXN_LIMIT = 32_768


def factor2(n: int) -> tuple[int, int]:
    """Split n into (a, b), a*b == n, as square as possible, a >= b."""
    b = int(math.isqrt(n))
    while n % b:
        b -= 1
    return n // b, b


class Mesh:
    """A dp×mp grid of `torch.device`s with named axes, the port's
    counterpart of the reference's `jax.sharding.Mesh`: `devices` is a
    [dp, mp] numpy object array, which may repeat a device. Row r of the
    grid checks the r-th contiguous slice of a batch; its devices split
    each closure round's columns."""

    def __init__(self, devices, axis_names: tuple[str, str] = ("dp", "mp")):
        rows = [list(r) for r in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        grid = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for j, d in enumerate(row):
                grid[i, j] = torch.device(d)
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """{axis name: size}, as the reference's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def rows(self) -> list[list[torch.device]]:
        """The dp rows, each the list of its mp devices."""
        return [list(r) for r in self.devices]

    def distinct(self) -> list[torch.device]:
        """Each device of the grid once, in grid order."""
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"[{', '.join(map(str, self.devices.flat))}])")


def make_mesh(devices: Sequence | None = None,
              axes: tuple[str, str] = ("dp", "mp")) -> Mesh:
    """A 2-D mesh (`factor2`'s dp×mp) over `devices` (default: every
    visible CUDA device, `devices.default_devices`)."""
    from ..devices import default_devices
    devices = list(devices if devices is not None else default_devices())
    dp, mp = factor2(len(devices))
    return Mesh([devices[r * mp:(r + 1) * mp] for r in range(dp)], axes)


def host_local_mesh(requested=None) -> Mesh:
    """The reference's mesh over this process's own devices of the kind
    `requested` names (default cuda). A process here holds only its own
    devices, so this is `make_mesh` over them. The port's own sweeps
    dispatch over `dp_mesh` of the same devices instead."""
    from ..devices import default_devices
    return make_mesh(default_devices(requested))


def dp_mesh(devices: Sequence | None = None) -> Mesh:
    """An N×1 mesh over each distinct device of `devices` (default:
    every visible CUDA device): dp alone, each history's closure whole
    on one device. The mesh the port's own bucketed dispatch builds
    (the `analyze-store` sweeps, `AppendChecker`, `serve`'s folds): the
    column split exchanges the whole matrix every round, a cost no
    measured traffic has justified, so it is left to a caller that asks
    for it (`make_mesh`, and `sp_mesh` for one long history)."""
    from ..devices import default_devices
    devices = list(devices if devices is not None else default_devices())
    return Mesh([[d] for d in Mesh([devices]).distinct()])


def sp_mesh(devices: Sequence | None = None) -> Mesh:
    """A 1×N mesh giving every device to one history: its closure
    rounds split their columns over all of them (the reference's
    sequence-parallel mesh for long histories)."""
    from ..devices import default_devices
    devices = list(devices if devices is not None else default_devices())
    return Mesh([devices])


#: Seconds a join waits for the other processes before it fails.
JOIN_TIMEOUT_S = 300.0


def init_distributed() -> bool:
    """Join a multi-process job when a coordinator address is set
    (JAX_COORDINATOR_ADDRESS, else COORDINATOR_ADDRESS, as host:port),
    with JAX_NUM_PROCESSES processes of which this is JAX_PROCESS_ID —
    the reference's variables, so one environment drives both
    packages: a `torch.distributed` process group over gloo at
    `tcp://<address>`, rank 0 serving the rendezvous. Returns False
    without an address (a single-process run), True once joined;
    idempotent. A join that fails (no process count, a rendezvous that
    outlasts JOIN_TIMEOUT_S) raises."""
    import datetime
    import os

    import torch.distributed as dist

    from ..mesh import COORDINATOR_VARS
    addr = next((os.environ[v] for v in COORDINATOR_VARS
                 if os.environ.get(v)), None)
    if not addr:
        return False
    if dist.is_initialized():
        return True
    count = os.environ.get("JAX_NUM_PROCESSES")
    if not count:
        raise RuntimeError(
            f"coordinator address {addr} set without JAX_NUM_PROCESSES: "
            "a torch.distributed group needs its size")
    rank = int(os.environ.get("JAX_PROCESS_ID") or 0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{addr}", world_size=int(count),
        rank=rank, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    return True


def check_joined(encs: Sequence, device=None, *, mesh: Mesh | None = None,
                 **kw) -> list:
    """`check_bucketed` of one batch spread over a joined job: rank k of
    n checks the k-th contiguous slice of `encs` (the batch padded to a
    multiple of n by replicating its last history) on its own `mesh`
    (or `device`), and every rank gets every verdict, the flag words
    all-gathered over the gloo group (host bytes). Without a joined
    group it is `check_bucketed` itself."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return check_bucketed(encs, device, mesh=mesh, **kw)
    n, k = dist.get_world_size(), dist.get_rank()
    padded = pad_to_multiple(list(encs), n)
    per = len(padded) // n
    mine = check_bucketed(padded[k * per:(k + 1) * per], device, mesh=mesh,
                          **kw)
    gathered: list = [None] * n
    dist.all_gather_object(gathered, mine)
    return [v for part in gathered for v in part][:len(encs)]


class _Sweep:
    """What every bucket of one dispatch shares: the histories (encoded
    histories, or host-built edge dicts: `edges`), the device, the
    kernel options, the caller's bucket log, whether the supervisor
    recovers from failures here (`supervise`) or leaves every one to the
    caller, whether the checks compute the stats matrix (`with_stats`),
    the caller's `phases` dict, the tracer its spans and counters go
    to (the null tracer for edge dicts, which the reference does not
    trace), and the mesh its buckets spread over (None: `device` alone;
    a mesh's unsharded buckets run on its first device, `device`)."""

    __slots__ = ("encs", "device", "kw", "bucket_log", "edges", "supervise",
                 "with_stats", "phases", "tr", "mesh", "streams")

    def __init__(self, encs: Sequence, device: torch.device, kw: dict,
                 bucket_log: list | None, supervise: bool = True,
                 with_stats: bool = False, phases: dict | None = None,
                 mesh: Mesh | None = None):
        self.encs = encs
        self.device = device
        self.mesh = mesh
        # one copy stream a CUDA device, made here: the pack-h2d thread
        # and the calling thread both look them up
        self.streams = {d: torch.cuda.Stream(d) for d in
                        ([device] + (mesh.distinct() if mesh else []))
                        if d.type == "cuda"}
        self.kw = kw
        self.bucket_log = bucket_log
        self.edges = bool(len(encs)) and isinstance(encs[0], dict)
        self.supervise = supervise
        self.with_stats = with_stats
        self.phases = phases
        self.tr = trace.NullTracer() if self.edges else trace.get_current()

    def fail_fast(self) -> bool:
        """Re-raise a failure instead of recovering: strict mode, or a
        caller that owns the policy."""
        return not self.supervise or sv.strict_enabled()

    def copy_stream(self, device: torch.device):
        """The CUDA stream the sweep's copies to `device` go on, one per
        device (None on the CPU)."""
        return self.streams[device] if device.type == "cuda" else None


class _Staged:
    """One bucket of sweep `sw` on its way to the device: packed on the
    host (`packed`), then copied (`batch`, with `ready` the copy's CUDA
    event and `host` its pinned buffers, kept until the bucket
    resolves). A bucket `sharded` over the sweep's mesh holds one of each
    per dp row, the row's slice on the row's first device."""

    __slots__ = ("sw", "bucket", "t0", "packed", "batch", "ready", "host",
                 "sharded")

    def __init__(self, sw: _Sweep, bucket: list[int], t0: float,
                 packed, sharded: bool = False):
        self.sw = sw
        self.bucket = bucket
        self.t0 = t0
        self.packed = packed
        self.sharded = sharded
        self.batch = self.ready = self.host = None


class _Dispatch:
    """One bucket enqueued on the device and not yet read: its [B] flag
    words, closure round counters and, under stats, its [B, N_STATS]
    stats matrix (device tensors), the CUDA event recorded after its
    last launch (None on the CPU; over a mesh, a tuple of one a card),
    its padded T, pack start and enqueue end (for the bucket log and the
    device window), and its pinned host buffers. Over a mesh the flags
    and stats are the rows' gathered onto its first device (replicas
    included, dropped when read), `rounds` every row's closures,
    `launches` the closure_square launches it enqueued and `b_row` the
    histories a row checks."""

    __slots__ = ("flags", "rounds", "stats", "done", "t_pad", "t0",
                 "t_disp", "host", "launches", "b_row")

    def __init__(self, flags, rounds, done, t_pad: int, t0: float,
                 host=None, stats=None, launches: int | None = None,
                 b_row: int | None = None):
        self.flags = flags
        self.rounds = rounds
        self.stats = stats
        self.done = done
        self.t_pad = t_pad
        self.t0 = t0
        self.t_disp = time.perf_counter()
        self.host = host
        self.launches = K.closure_steps(t_pad) * len(rounds) \
            if launches is None else launches
        self.b_row = int(flags.shape[0]) if b_row is None else b_row

    def is_ready(self) -> bool:
        if isinstance(self.done, tuple):
            return all(d.query() for d in self.done)
        return self.done is None or self.done.query()


def _done_event(device: torch.device, timing: bool = False):
    """A CUDA event recorded on `device`'s current stream after the work
    enqueued so far (`timing`: one `elapsed_time` can read, for the cost
    observatory); None on the CPU, where work is done when enqueued."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=timing)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _device_ready(done, timeout: float | None) -> bool:
    """Wait for `done` (see `_done_event`; a tuple of them: every one),
    at most `timeout` seconds (None: no bound): True once the work before
    it has completed. The one place a dispatch waits on the device."""
    if isinstance(done, tuple):
        end = None if timeout is None else time.monotonic() + timeout
        return all(_device_ready(
            d, None if end is None else max(0.0, end - time.monotonic()))
            for d in done)
    if done is None:
        return True
    if timeout is None:
        done.synchronize()
        return True
    deadline = time.monotonic() + timeout
    while not done.query():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.0005)
    return True


def _block_flags(done) -> None:
    """Wait for a dispatch's `done` event, bounded by the dispatch
    watchdog (JEPSEN_TPU_DISPATCH_TIMEOUT_S; default off = a plain
    wait). On a timeout the wait is retried once — a transient host
    stall under a healthy device resolves here — then WatchdogTimeout
    raises and the caller quarantines the bucket. The device work itself
    cannot be cancelled: it runs on, and what it reads and writes is
    freed in stream order. One wedged dispatch counts one
    `watchdog_timeouts`; each timed-out attempt leaves a
    `watchdog_timeout` mark on the device track and a `watchdog_fire`
    event."""
    timeout = sv.dispatch_timeout_s()
    tr = trace.get_current()
    for attempt in range(2):
        if _device_ready(done, timeout):
            return
        if attempt == 0:
            tr.counter("watchdog_timeouts").inc()
        tr.instant("watchdog_timeout", track="device", timeout_s=timeout,
                   attempt=attempt)
        obs_events.emit("watchdog_fire", timeout_s=timeout,
                        attempt=attempt)
    raise sv.WatchdogTimeout(f"device dispatch exceeded {timeout}s twice")


def _acc_phase(sw: _Sweep, key: str, t0: float) -> None:
    """Record a phase span started at `t0` on the sweep's tracer and add
    its seconds to the caller's `phases` dict, so the two agree."""
    dt = sw.tr.phase(key, t0)
    if sw.phases is not None:
        sw.phases[key] = sw.phases.get(key, 0.0) + dt


def check_long_history(enc, device=None, *, mesh: Mesh | None = None,
                       classify: bool = True,
                       realtime: bool = False, process_order: bool = False,
                       dense_limit: int = DENSE_TXN_LIMIT,
                       square: K.Square | None = None,
                       bucket_log: list | None = None,
                       condense_log: list | None = None,
                       stats_out: list | None = None) -> dict:
    """Check ONE encoded history on `device` (default cuda); returns
    {anomaly: True} flags.

    Up to `dense_limit` txns: the dense closure, one bucket, on `mesh`
    (default `sp_mesh` over `device`'s visible devices: every closure
    round split into column blocks, one a device; one device is the
    single-device path), its wait bounded by the dispatch watchdog (a
    timeout raises WatchdogTimeout to the caller), its device window
    named "long-history". Beyond it: host SCC condensation feeding the
    device classification per nontrivial SCC (`condense.check_condensed`
    over the mesh's devices, which also takes `condense_log`) — the
    100k-op path, exact because every anomaly query is answered inside
    one SCC. `square` and `bucket_log` as in `check_bucketed`.
    `stats_out`, when given, gets one stats dict for the history: from
    the device on the dense path (`kernels.stats_row`), from the
    condensation past it (`condense.condensed_stats`)."""
    from ..devices import default_devices, resolve_device
    if mesh is None:
        mesh = sp_mesh(default_devices(device))
    dev = resolve_device(mesh.devices.flat[0])
    if enc.n > dense_limit:
        from ..checker.elle import condense
        return condense.check_condensed(
            enc, dev, classify=classify, realtime=realtime,
            process_order=process_order, square=square,
            bucket_log=bucket_log, condense_log=condense_log,
            stats_out=stats_out, devices=list(mesh.devices.flat))
    sw = _Sweep([enc], dev, dict(
        classify=classify, realtime=realtime, process_order=process_order,
        fused=K.fused_classify_enabled(), square=square), bucket_log,
        with_stats=stats_out is not None,
        mesh=mesh if mesh.size > 1 else None)
    staged = _h2d_bucket(_prep_bucket(sw, [0]), dev)
    (w,) = _resolve(sw, [0], _enqueue(sw, staged, sw.with_stats),
                    "long-history", txns=enc.n)
    if isinstance(w, tuple):
        w, st = w
        stats_out.append(st)
    return K.flags_to_names(w)


def _size_of(e) -> int:
    """Txn count of an encoded history (attribute) or packed edge dict
    (key) — both bucket the same way."""
    return e["n"] if isinstance(e, dict) else e.n


def bucket_by_length(encs: Sequence, *, multiple: int = 128,
                     budget_cells: int = 1 << 27,
                     dp: int = 1) -> list[list[int]]:
    """Partition history indices into buckets of similar padded txn
    count. Each bucket satisfies B_pad * T_pad² <= budget_cells, where
    T_pad is the bucket max rounded up to `multiple` and B_pad the
    bucket size rounded up to a multiple of `dp` (a mesh dispatch pads
    ragged buckets so, so that headroom is budgeted here). Returns
    buckets of indices into encs, longest histories first. Elements may
    be EncodedHistory-like (`.n`) or packed edge dicts (`["n"]`)."""
    order = sorted(range(len(encs)), key=lambda i: -_size_of(encs[i]))
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_tpad = 0
    for i in order:
        tpad = max(K.pad_to(max(_size_of(encs[i]), 1), multiple), 1)
        t = max(cur_tpad, tpad)
        b_pad = -(-(len(cur) + 1) // dp) * dp
        if cur and b_pad * t * t > budget_cells:
            buckets.append(cur)
            cur, cur_tpad = [], 0
            t = tpad
        cur.append(i)
        cur_tpad = t
    if cur:
        buckets.append(cur)
    return buckets


class PendingVerdicts:
    """Verdicts still in flight: `check_bucketed_async` enqueues every
    bucket's check without reading the device, so the caller can overlap
    host work with the device's. `.result()` waits, reads the flag words
    back and returns per-history {anomaly: True} dicts in input order (a
    history the supervisor abandoned yields its `supervisor.Quarantined`
    sentinel instead — callers render it as `valid? unknown`);
    `.stats()` then holds the per-history stats dicts of a `with_stats`
    dispatch."""

    def __init__(self, n: int, parts: list, finish, sw: _Sweep):
        self._n = n
        # [bucket indices, a _Dispatch still on the device, or the
        # resolved per-history flag words / (word, stats dict) pairs /
        # Quarantined sentinels]
        self._parts = parts
        # finish(idx, dispatch) -> resolved list: the dispatcher's
        # watchdog + OOM-backdown closure
        self._finish = finish
        self._sw = sw
        self._result: list | None = None
        self._stats: list = [None] * n

    def is_ready(self) -> bool:
        """True when every bucket's work has completed on the device;
        never blocks."""
        return all(not isinstance(x, _Dispatch) or x.is_ready()
                   for _, x in self._parts)

    def stats(self) -> list:
        """Per-history `kernels.stats_row` dicts aligned with the
        verdicts (None for a history whose check carried no stats: gate
        off, quarantined, or resolved through the OOM backdown, whose
        re-checks run stats-free). Filled by `.result()`."""
        return self._stats

    def result(self) -> list:
        """The verdicts, in input order; idempotent (a second call
        records no more "collect" time)."""
        if self._result is not None:
            return self._result
        t0 = time.perf_counter()
        out: list = [None] * self._n
        for idx, words in self._parts:
            if isinstance(words, _Dispatch):
                words = self._finish(idx, words)
            for i, w in zip(idx, words):
                if isinstance(w, tuple):
                    w, self._stats[i] = w
                out[i] = (w if isinstance(w, sv.Quarantined)
                          else K.flags_to_names(int(w)))
        self._parts = []
        self._sw.tr.gauge("inflight_depth").set(0)   # fully drained
        _acc_phase(self._sw, "collect", t0)
        self._result = out
        return out


def pack_thread_enabled() -> bool:
    """The JEPSEN_TPU_PACK_THREAD gate (default on): check_bucketed_async
    packs buckets and copies them to the device on a dedicated thread,
    so the calling thread only enqueues checks and resolves them. 0
    keeps everything inline on the calling thread."""
    return gates.get("JEPSEN_TPU_PACK_THREAD")


def _est_cells(encs: Sequence, bucket: list[int], dp: int = 1) -> int:
    """The padded footprint bucket_by_length budgeted for this bucket
    (B rounded up to a multiple of dp x T_pad²), computable before
    packing, so the dispatcher can spot buckets over the per-slot budget
    (only a single history too big to subdivide can be)."""
    tpad = max(K.pad_to(max(_size_of(encs[i]) for i in bucket), 128), 1)
    return -(-len(bucket) // dp) * dp * tpad * tpad


def _prep_bucket(sw: _Sweep, bucket: list[int],
                 budget_cells: float = math.inf) -> _Staged:
    """Host-side packing of one bucket (the "pack" phase): its histories
    padded into numpy arrays (`kernels.pack_batch`), or its edge dicts
    into cell lists (`kernels.pack_edge_matrices`). Runs on the pack-h2d
    thread when pack_thread_enabled(), inline otherwise — the span lands
    on whichever thread did the work. Counts the bucket's padding waste
    (`pad_waste_cells`: B·T_pad² less its histories' own cells) and its
    footprint (`bucket_cells`).

    On a mesh the bucket is padded to a multiple of dp by replicating
    its last history, unless that padding would pass `budget_cells`
    (then it goes unsharded, on the mesh's first device), and packed as
    dp rows of one shape, one a mesh row.

    A single-device bucket whose histories all carry v2-sidecar views
    that fit its planned shape is packed as those views
    (`kernels.pack_batch_views`): no host tensor is built. Otherwise
    pack_batch copies, and the bytes it copied for warm (cache-loaded)
    histories count as `warm_copy_bytes`, as the reference counts
    them."""
    t0 = time.perf_counter()
    group = [sw.encs[i] for i in bucket]
    tpad = max(K.pad_to(max(_size_of(e) for e in group), 128), 1)
    parts = None
    if sw.mesh is not None:
        dp = sw.mesh.devices.shape[0]
        padded = pad_to_multiple(group, dp)
        if len(padded) * tpad * tpad <= budget_cells:
            group, per = padded, len(padded) // dp
            parts = [group[r * per:(r + 1) * per] for r in range(dp)]
    if sw.edges:
        packed = K.pack_edge_matrices(group) if parts is None else \
            [K.pack_edge_matrices(p, t_pad=tpad) for p in parts]
    else:
        shape = K.BatchShape.plan(group)
        packed = None if parts else K.pack_batch_views(group, shape)
        if packed is None:
            packed = K.pack_batch(group, shape) if parts is None else \
                [K.pack_batch(p, shape) for p in parts]
            if sw.tr.enabled:
                warm = sum(
                    e.appends.nbytes + e.reads.nbytes
                    + e.invoke_index.nbytes + e.complete_index.nbytes
                    + e.process.nbytes
                    for e in group if getattr(e, "warm", False))
                if warm:
                    sw.tr.counter("warm_copy_bytes").inc(warm)
    if sw.tr.enabled:
        cells = len(group) * tpad * tpad
        # replicas padded in count as waste too: less the bucket's own
        sw.tr.counter("pad_waste_cells").inc(
            cells - sum(max(_size_of(sw.encs[i]), 1) ** 2 for i in bucket))
        sw.tr.histogram("bucket_cells").observe(cells)
    _acc_phase(sw, "pack", t0)
    return _Staged(sw, bucket, t0, packed, parts is not None)


def _h2d_bucket(item: _Staged, device: torch.device,
                stream=None) -> _Staged:
    """The host-to-device copy of one packed bucket (the "h2d" phase,
    counting the bytes that cross in `h2d_bytes`), on `stream` (the
    dispatch's copy stream; None: the current stream), an event marking
    its end. A packed batch's arrays are pinned and copied without
    blocking, widened to int64 there; the pinned buffers stay with the
    bucket until it resolves. A views-packed batch's views are copied
    from their mapped pages and padded and stacked on the device
    (`kernels.views_to_device`), and an edge batch's cell lists are
    copied and scattered into its [B,T,T] matrices
    (`kernels.edge_batch_to_device`), each on that stream, so the copy
    waits for no earlier bucket's check."""
    t0 = time.perf_counter()
    sw = item.sw
    packed, item.packed = item.packed, None
    if item.sharded:
        item.batch, item.ready, item.host = shard_batch(
            sw.mesh, packed, sw.copy_stream, sw.tr)
    else:
        item.batch, item.ready, item.host = _to_device(packed, device,
                                                       stream, sw.tr)
    _acc_phase(sw, "h2d", t0)
    return item


def _to_device(packed: dict, device: torch.device, stream, tr):
    """One packed batch to `device` on `stream`: (the device batch, the
    copy's CUDA event or None, its pinned host buffers or None); counts
    `h2d_bytes` (see `_h2d_bucket`)."""
    if "T" in packed:
        to_device = K.edge_batch_to_device
    elif packed.get("views"):
        to_device = K.views_to_device
        if tr.enabled:
            tr.counter("h2d_bytes").inc(
                sum(v.nbytes for k in K.VIEW_FILLS for v in packed[k]))
    else:
        to_device = K.batch_to_device
        if tr.enabled:
            tr.counter("h2d_bytes").inc(
                sum(np.asarray(packed[k]).nbytes for k in K.DEVICE_FIELDS))
    if device.type != "cuda":
        return to_device(packed, device), None, None
    host = None
    with torch.cuda.stream(stream):
        if to_device is K.batch_to_device:
            host = {k: torch.from_numpy(packed[k]).pin_memory()
                    for k in K.DEVICE_FIELDS}
            batch = {k: host[k].to(device, non_blocking=True).to(dt)
                     for k, dt in K.DEVICE_FIELDS.items()}
            batch["shape"] = packed["shape"]
        else:
            batch = to_device(packed, device)
        ready = torch.cuda.Event()
        ready.record(stream)
    return batch, ready, host


def shard_batch(mesh: Mesh, packed: list, streams, tr) -> tuple:
    """Each dp row's slice of a packed batch (`packed`, one packed dict
    a row: `_prep_bucket`'s) to its row's first device, from pinned host
    memory on that device's copy stream (`streams(device)`; None on the
    CPU). Returns (per-row device batches, per-row copy events — None
    on the CPU — and per-row pinned buffers)."""
    out = [_to_device(p, row[0], streams(row[0]), tr)
           for p, row in zip(packed, mesh.rows())]
    return tuple(list(x) for x in zip(*out))


def sharded_check_fn(mesh: Mesh, *, classify: bool = True,
                     realtime: bool = False, process_order: bool = False,
                     fused: bool | None = None,
                     square: K.Square | None = None,
                     with_stats: bool = False):
    """The check of one mesh-sharded batch: a callable taking the dp
    rows' device batches (`shard_batch`'s) and a list for the closures'
    round counters, that enqueues each row's check on its row's devices
    (`kernels.check_batch_device` or `classify_matrices_device`; a row
    of several devices splits every closure round's columns over them)
    and returns (the rows' flag words gathered onto the mesh's first
    device, their stats matrices likewise or None, the closure_square
    launches enqueued). Nothing is read back. It is not compiled, so
    there is no memo of it."""
    fused = K.fused_classify_enabled() if fused is None else fused
    rows = mesh.rows()
    first = rows[0][0]
    kw = dict(classify=classify, realtime=realtime,
              process_order=process_order, fused=fused, square=square,
              with_stats=with_stats)

    def check(batches: list, rounds: list | None = None):
        flags, stats, launches = [], [], 0
        for devs, batch in zip(rows, batches):
            rr: list = []
            edges = "T" in batch
            t_pad = batch["T"] if edges else batch["shape"].n_txns
            entry = K.classify_matrices_device if edges \
                else K.check_batch_device
            out = entry(batch, rounds=rr,
                        mp=devs if len(devs) > 1 else None, **kw)
            f, st = out if with_stats else (out, None)
            launches += K.closure_steps(t_pad) * len(rr) \
                * K.mp_parts(t_pad, len(devs))
            flags.append(f.to(first))
            if st is not None:
                stats.append(st.to(first))
            if rounds is not None:
                rounds.extend(r.to(first) for r in rr)
        return (torch.cat(flags), torch.cat(stats) if with_stats else None,
                launches)

    return check


def _enqueue(sw: _Sweep, item: _Staged, with_stats: bool = False,
             observe: bool = False) -> _Dispatch:
    """Enqueue one copied bucket's check on the device's current stream
    and return without reading anything back (with `with_stats`, the
    check also computes the stats matrix). The stream first waits
    for the bucket's copy, and each input tensor is marked as used on
    it, so the caching allocator cannot hand the inputs' memory to a
    later copy before this check has read them; the inputs are then
    dropped. With `observe` (a bucket dispatch of encoded histories,
    the reference's observed points) the cost observatory, when its
    gate is on, opens the dispatch's window: a start event after the
    wait, and a timing end event (`obs.device`)."""
    if item.sharded:
        return _enqueue_rows(sw, item, with_stats, observe)
    batch, item.batch = item.batch, None
    compute = None
    if item.ready is not None:
        compute = torch.cuda.current_stream(sw.device)
        compute.wait_event(item.ready)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(compute)
    win = obs_device.open_window(sw.kw, batch, with_stats, sw.device,
                                 compute) \
        if observe and not sw.edges else None
    rounds: list = []
    if sw.edges:
        out = K.classify_matrices_device(batch, rounds=rounds,
                                         with_stats=with_stats, **sw.kw)
        t_pad = batch["T"]
    else:
        out = K.check_batch_device(batch, rounds=rounds,
                                   with_stats=with_stats, **sw.kw)
        t_pad = batch["shape"].n_txns
    flags, stats = out if with_stats else (out, None)
    part = _Dispatch(flags, rounds,
                     _done_event(sw.device, timing=win is not None),
                     t_pad, item.t0, item.host, stats)
    item.host = None
    obs_device.begin_dispatch(part, win, sw.tr)
    return part


def _enqueue_rows(sw: _Sweep, item: _Staged, with_stats: bool,
                  observe: bool) -> _Dispatch:
    """`_enqueue` of a bucket sharded over a mesh: each row's compute
    stream waits for its copy, the rows' checks are enqueued
    (`sharded_check_fn`) and their flags gathered onto the mesh's first
    device, then a done event is recorded on every device of the mesh.
    The cost observatory's window, when observed, is one CUDA-event pair
    a device (`obs.device.open_mesh_window`)."""
    mesh = sw.mesh
    batches, item.batch = item.batch, None
    for row, batch, ready in zip(mesh.rows(), batches, item.ready):
        if ready is not None:
            compute = torch.cuda.current_stream(row[0])
            compute.wait_event(ready)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(compute)
    devices = mesh.distinct()
    win = obs_device.open_mesh_window(sw.kw, batches, with_stats, devices) \
        if observe and not sw.edges else None
    rounds: list = []
    flags, stats, launches = sharded_check_fn(mesh, **sw.kw,
                                              with_stats=with_stats)(
        batches, rounds)
    first = batches[0]
    t_pad = first["T"] if sw.edges else first["shape"].n_txns
    done = tuple(_done_event(d, timing=win is not None) for d in devices)
    part = _Dispatch(flags, rounds, None if done[0] is None else done,
                     t_pad, item.t0, item.host, stats, launches=launches,
                     b_row=len(first["n_txns"]))
    item.host = None
    obs_device.begin_dispatch(part, win, sw.tr)
    return part


def _resolve(sw: _Sweep, idx: list, part: _Dispatch,
             window: str = "bucket", **args) -> list:
    """Wait for one dispatch (bounded by the watchdog) and read its flag
    words (with a stats matrix, (word, `kernels.stats_row` dict) pairs),
    recording its device window (`window`, from enqueue to the host
    seeing it complete; `args` default to the bucket's history count).
    The bucket log gets the bucket's history count, padded T, the
    rounds each closure ran (`kernels.read_rounds`), the closure_square
    launches it enqueued (every round of every closure, skipped ones
    included) and the seconds since its packing began."""
    _block_flags(part.done)
    sw.tr.device_complete(window, part.t_disp,
                          **(args or {"histories": len(idx)}))
    # the observatory's window ends here too (a no-op for a dispatch
    # it never began): read after the host has seen the end event
    obs_device.close_dispatch(part, len(idx), sw.tr)
    # a mesh dispatch's padded replicas are dropped here
    words = part.flags.tolist()[:len(idx)]
    if part.stats is not None:
        words = [(w, K.stats_row(r, n_txns=_size_of(sw.encs[i]),
                                 t_pad=part.t_pad))
                 for w, r, i in zip(words, part.stats.tolist(), idx)]
    if sw.bucket_log is not None:
        sw.bucket_log.append({
            "histories": len(words), "t_pad": part.t_pad,
            "closure_rounds": K.read_rounds(part.rounds),
            "launches": part.launches,
            "seconds": time.perf_counter() - part.t0})
    return words


def _quarantine_bucket(sw: _Sweep, idx: list, stage: str, err) -> list:
    """Per-history Quarantined sentinels for a bucket the supervisor
    abandoned, attributed as a "quarantine" span, the `quarantined`
    counter and a `quarantine` event."""
    with sw.tr.span("quarantine", stage=stage, histories=len(idx)):
        sw.tr.counter("quarantined").inc(len(idx))
        log.warning("quarantined %d histories (%s): %r", len(idx), stage,
                    err)
    e = repr(err)
    obs_events.emit("quarantine", stage=stage, histories=len(idx),
                    cause=e[:300])
    return [sv.Quarantined(stage, e) for _ in idx]


def _drop_frames(err: BaseException) -> None:
    """Free what a failed enqueue still holds: its traceback's frames
    keep that bucket's device tensors alive, which an OOM backdown needs
    for its halves."""
    seen: set[int] = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        err.__traceback__ = None
        err = err.__context__


def _sync_check(sw: _Sweep, idx: list, budget_cells: int) -> list[int]:
    """One synchronous bucket check — the OOM-backdown retry path: pack,
    copy, enqueue, wait (on a mesh, padded within `budget_cells`).
    Raises on OOM or watchdog timeout; the caller owns the
    split/quarantine policy. Stats-free, as the reference's retries
    are: a re-planned history keeps its verdict and drops its
    telemetry."""
    item = _h2d_bucket(_prep_bucket(sw, idx, budget_cells), sw.device)
    sv.maybe_inject_oom()
    part = _enqueue(sw, item, observe=True)
    try:
        return _resolve(sw, idx, part)
    finally:
        # drops the observatory's pending window on a raise; a no-op
        # once _resolve has closed it
        obs_device.discard_dispatch(part, sw.tr)


def _oom_backdown(sw: _Sweep, idx: list, budget_cells: int, err) -> list:
    """Recover from a bucket that ran out of device memory: split it in
    half and check each half synchronously at a HALVED cell budget,
    recursing to singletons. A singleton that still OOMs is oversized
    for the device outright — it quarantines instead of crashing the
    sweep. In strict mode the original error re-raises untouched.

    The other in-flight bucket is not drained first; the halved budget
    is what makes room beside it."""
    if sw.fail_fast():
        raise err
    _drop_frames(err)
    sw.tr.counter("oom_retries").inc()
    if len(idx) == 1:
        return _quarantine_bucket(sw, idx, "oom", err)
    sw.tr.counter("bucket_splits").inc()
    obs_events.emit("oom_split", histories=len(idx),
                    budget_cells=budget_cells)
    mid = (len(idx) + 1) // 2
    half_budget = max(1, budget_cells // 2)
    out: list = []
    for half in (idx[:mid], idx[mid:]):
        try:
            out.extend(_sync_check(sw, half, half_budget))
        except BaseException as e:
            if isinstance(e, sv.WatchdogTimeout) and not sw.fail_fast():
                out.extend(_quarantine_bucket(sw, half, "watchdog", e))
            elif sv.is_oom_error(e) and not sw.fail_fast():
                out.extend(_oom_backdown(sw, half, half_budget, e))
            else:
                raise
    return out


def _finish_part(sw: _Sweep, idx: list, part: _Dispatch,
                 budget_cells: int) -> list:
    """Resolve one dispatched bucket to per-history flag words,
    recovering from an OOM (backdown) and a watchdog timeout
    (quarantine) unless strict. The device window is recorded on the
    success path only: a recovered bucket's device time is the
    backdown's own windows."""
    try:
        return _resolve(sw, idx, part)
    except BaseException as e:
        # the abandoned dispatch's cost window is discarded: a
        # recovered bucket's device time is the backdown's own windows
        obs_device.discard_dispatch(part, sw.tr)
        if isinstance(e, sv.WatchdogTimeout) and not sw.fail_fast():
            return _quarantine_bucket(sw, idx, "watchdog", e)
        if sv.is_oom_error(e) and not sw.fail_fast():
            return _oom_backdown(sw, idx, budget_cells, e)
        raise


def check_bucketed_async(encs: Sequence, device=None, *,
                         mesh: Mesh | None = None,
                         classify: bool = True, realtime: bool = False,
                         process_order: bool = False,
                         budget_cells: int = 1 << 27,
                         fused: bool | None = None,
                         max_inflight: int = 2,
                         square: K.Square | None = None,
                         bucket_log: list | None = None,
                         supervise: bool = True,
                         phases: dict | None = None,
                         with_stats: bool = False) -> PendingVerdicts:
    """Dispatch a bucketed sweep WITHOUT waiting on the device: every
    bucket is packed, copied and enqueued, and the returned
    PendingVerdicts resolves the flags later. `encs` are encoded
    histories (`kernels.check_batch_device`) or host-built edge dicts
    (`kernels.classify_matrices_device`; see pack_edge_matrices).

    `max_inflight` bounds how many buckets are on the device unresolved
    at once: past that, the oldest is resolved before the next bucket is
    copied. `budget_cells` bounds the total resident footprint, so each
    bucket is planned at budget_cells // max_inflight. A single history
    too long for that per-slot budget cannot be subdivided; such
    singleton buckets are dispatched LAST and strictly alone (everything
    else resolved first).

    With pack_thread_enabled() (default) and more than one bucket, a
    "pack-h2d" thread packs bucket N+1 and copies it while the calling
    thread enqueues and resolves bucket N; a semaphore caps
    copied-but-unresolved buckets at max_inflight. Copies go on a CUDA
    stream of their own either way, so no copy waits for a check.

    Failures, per bucket: an OOM at enqueue or resolution backs down
    (`_oom_backdown`); a watchdog timeout quarantines the bucket; a pack
    or copy failure quarantines just its bucket — unless it is one that
    must end the sweep (`supervisor.must_end_sweep`: a kernel build or
    launch error, a missing device, a CUDA error, an interrupt). Strict
    mode re-raises the first failure, and so does `supervise=False`,
    for a caller that owns the policy (the wr sweep's chunk backdown,
    the long-run quarantine).

    With `mesh` (more than one device) every bucket is planned with dp
    padding headroom and sharded over the mesh (module doc); `device` is
    then the mesh's first device. A mesh of one device is `device` =
    that device, the single-device path itself.

    `fused` defaults to the JEPSEN_TPU_FUSED_CLASSIFY gate; `square` and
    `bucket_log` as in `check_bucketed`. `phases` (a dict) accumulates
    the host seconds of each phase: "pack", "h2d", "feed" (the calling
    thread waiting on the pack-h2d thread), "dispatch" (enqueue) and
    "collect" (waits and reads). With `with_stats` every bucket's check
    also computes its stats matrix, and `.stats()` of the result holds
    the per-history dicts."""
    t_plan = time.perf_counter()
    if mesh is not None:
        device = mesh.devices.flat[0]
        if mesh.size == 1:
            mesh = None
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        # the pack-h2d thread names its device explicitly
        device = torch.device("cuda", torch.cuda.current_device())
    parts: list = []
    inflight: list[int] = []    # indices into parts, oldest first
    depth = max(1, max_inflight)
    sw = _Sweep(encs, device, dict(
        classify=classify, realtime=realtime, process_order=process_order,
        fused=K.fused_classify_enabled() if fused is None else fused,
        square=square), bucket_log, supervise, with_stats, phases, mesh)
    tr = sw.tr
    copies = sw.copy_stream(device)
    dp = mesh.devices.shape[0] if mesh is not None else 1
    eff_budget = max(1, budget_cells // depth)
    pl = None if sw.edges else _planner.get()
    if pl is not None:
        # the cost-aware planner races candidate pad multiples on
        # predicted device seconds and keeps the winner's composition;
        # without a model it answers bucket_by_length's own (multiple
        # 128), and composition never changes a verdict
        buckets = pl.plan_buckets(encs, budget_cells=eff_budget, dp=dp)
    else:
        buckets = bucket_by_length(encs, budget_cells=eff_budget, dp=dp)
    # Singleton buckets whose one history alone exceeds the per-slot
    # budget cannot share the envelope: peel them off to dispatch
    # strictly alone after the pipelined buckets drain.
    oversized = [b for b in buckets
                 if _est_cells(encs, b, dp) > eff_budget]
    buckets = [b for b in buckets if _est_cells(encs, b, dp) <= eff_budget]
    _acc_phase(sw, "pack", t_plan)

    def finish(idx, part):
        out = _finish_part(sw, idx, part, eff_budget)
        # exactly the buckets `buckets_dispatched` counted resolve here
        tr.counter("buckets_resolved").inc()
        return out

    def resolve_oldest():
        j = inflight.pop(0)
        t0 = time.perf_counter()
        idx, part = parts[j]
        parts[j] = [idx, finish(idx, part)]
        tr.gauge("inflight_depth").set(len(inflight))
        _acc_phase(sw, "collect", t0)

    def dispatch(item: _Staged) -> bool:
        """Enqueue one copied bucket; returns False when the bucket was
        instead resolved synchronously (an OOM at enqueue went down the
        backdown path — nothing joined the pipeline)."""
        t0 = time.perf_counter()
        try:
            sv.maybe_inject_oom()
            part = _enqueue(sw, item, with_stats, observe=True)
        except BaseException as e:
            if not sv.is_oom_error(e) or sw.fail_fast():
                raise
            _acc_phase(sw, "dispatch", t0)
            # the failed bucket's tensors go before the halves allocate
            item.batch = item.host = None
            parts.append([item.bucket, _oom_backdown(
                sw, item.bucket, eff_budget, e)])
            return False
        parts.append([item.bucket, part])
        inflight.append(len(parts) - 1)
        tr.counter("buckets_dispatched").inc()
        tr.gauge("inflight_depth").set(len(inflight))
        _acc_phase(sw, "dispatch", t0)
        return True

    def handle_failed(bucket, e):
        """A bucket whose pack or copy failed: strict and what must end
        the sweep re-raise; an OOM backs down; any other Exception
        quarantines JUST this bucket."""
        if sw.fail_fast() or sv.must_end_sweep(e):
            raise e
        if sv.is_oom_error(e):
            parts.append([bucket, _oom_backdown(sw, bucket, eff_budget,
                                                e)])
        else:
            parts.append([bucket, _quarantine_bucket(sw, bucket, "pack",
                                                     e)])

    failed = object()

    if pack_thread_enabled() and len(buckets) > 1:
        out: _queue.Queue = _queue.Queue()
        sem = threading.Semaphore(depth)
        stop = threading.Event()
        done = object()

        def producer():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                for b in buckets:
                    # per-bucket isolation: a history that breaks
                    # packing must not kill the producer, and with it
                    # every later bucket's verdict
                    try:
                        item = _prep_bucket(sw, b, eff_budget)
                    except BaseException as e:
                        out.put((failed, b, e))
                        continue
                    sem.acquire()
                    if stop.is_set():
                        return
                    try:
                        out.put(_h2d_bucket(item, device, copies))
                    except BaseException as e:
                        sem.release()   # no dispatch will free this slot
                        out.put((failed, b, e))
                out.put(done)
            except BaseException as e:   # surfaced on the caller
                out.put(e)

        th = threading.Thread(target=producer, name="pack-h2d",
                              daemon=True)
        th.start()
        try:
            while True:
                # the calling thread's stall on the producer is its own
                # phase ("feed"), pack and h2d accruing on that thread
                t0 = time.perf_counter()
                item = out.get()
                _acc_phase(sw, "feed", t0)
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, tuple):
                    handle_failed(item[1], item[2])
                    continue
                if not dispatch(item):
                    # resolved synchronously: its envelope slot frees now
                    sem.release()
                elif len(inflight) >= depth:
                    resolve_oldest()
                    sem.release()
        finally:
            stop.set()
            for _ in buckets:   # unblock a producer parked on sem
                sem.release()
            th.join(timeout=30)
    else:
        for bucket in buckets:
            while len(inflight) >= depth:
                resolve_oldest()
            try:
                item = _h2d_bucket(_prep_bucket(sw, bucket, eff_budget),
                                   device, copies)
            except BaseException as e:
                handle_failed(bucket, e)
                continue
            dispatch(item)
    for bucket in oversized:
        # strictly alone: drain everything first (its mesh padding may
        # use the whole budget: nothing shares the envelope with it)
        while inflight:
            resolve_oldest()
        try:
            item = _h2d_bucket(_prep_bucket(sw, bucket, budget_cells),
                               device, copies)
        except BaseException as e:
            handle_failed(bucket, e)
            continue
        dispatch(item)
    return PendingVerdicts(len(encs), parts, finish, sw)


def check_bucketed(encs: Sequence, device=None, *,
                   mesh: Mesh | None = None,
                   classify: bool = True, realtime: bool = False,
                   process_order: bool = False,
                   budget_cells: int = 1 << 27,
                   two_pass: bool | None = None,
                   fused: bool | None = None,
                   square: K.Square | None = None,
                   bucket_log: list | None = None,
                   phases: dict | None = None,
                   stats_out: list | None = None) -> list:
    """Check many encoded histories bucketed by length on `device`
    (`check_bucketed_async(...).result()`), results in input order as
    {anomaly-name: True} dicts, or `supervisor.Quarantined` for a
    history the supervisor abandoned.

    With classify=True the default strategy is the fused
    detect/classify path (the JEPSEN_TPU_FUSED_CLASSIFY gate).
    two_pass=True (the default when fused is off) sweeps every bucket in
    detect mode and re-checks ONLY flagged histories with the chained
    classification closures; quarantined histories pass straight
    through. Verdicts are identical either way.

    `mesh` spreads the buckets over a dp×mp mesh (`check_bucketed_async`).
    `square` replaces the closure squaring (see kernels.check_batch_device).
    `bucket_log`, when given, gets one dict per bucket checked (its
    history count, padded T, the rounds each closure ran, the launches it
    enqueued and the seconds from its packing to its flags on the host;
    see `_resolve`), in the order the buckets resolve. `phases` as in
    `check_bucketed_async`.

    `stats_out`, when given, is extended with one `kernels.stats_row`
    dict per history (None for a quarantined or backdown-recovered
    one). On the two-pass strategy the stats come from the detect pass
    (the from-scratch full closure); the classify re-check runs
    stats-free."""
    if not len(encs):
        return []
    if fused is None:
        fused = K.fused_classify_enabled()
        pl = _planner.get()
        if pl is not None and classify:
            # the planner may flip the classify strategy when the
            # costdb has measured BOTH fused and two-pass (their
            # verdicts are identical); an explicit fused= or a cold
            # planner keeps the gate's choice
            t_pad = K.pad_to(max((_size_of(e) for e in encs), default=1),
                             128)
            fused = pl.fused_choice(fused, classify=classify, t_pad=t_pad)
    if two_pass is None:
        two_pass = classify and not fused
    if classify and two_pass:
        detect = check_bucketed(encs, device, mesh=mesh, classify=False,
                                realtime=realtime,
                                process_order=process_order,
                                budget_cells=budget_cells, square=square,
                                bucket_log=bucket_log, phases=phases,
                                stats_out=stats_out)
        flagged = [i for i, f in enumerate(detect)
                   if f and not isinstance(f, sv.Quarantined)]
        if not flagged:
            return detect
        full = check_bucketed([encs[i] for i in flagged], device,
                              mesh=mesh, classify=True, realtime=realtime,
                              process_order=process_order,
                              budget_cells=budget_cells, two_pass=False,
                              fused=False, square=square,
                              bucket_log=bucket_log, phases=phases)
        out = list(detect)
        for i, r in zip(flagged, full):
            out[i] = r
        return out
    pv = check_bucketed_async(
        encs, device, mesh=mesh, classify=classify, realtime=realtime,
        process_order=process_order, budget_cells=budget_cells,
        fused=fused, square=square, bucket_log=bucket_log, phases=phases,
        with_stats=stats_out is not None)
    res = pv.result()
    if stats_out is not None:
        stats_out.extend(pv.stats())
    return res


def check_once(items: Sequence, devices: Sequence, *, kw: dict,
               with_stats: bool = False) -> list:
    """One dispatch of every item (encoded histories, or edge dicts) over
    a 1-D dp split of `devices` (the batch padded by replicating its
    last item, the replicas dropped; one device: the single-device
    path), waited on under the dispatch watchdog and read: the flag
    words in order, or (word, `kernels.stats_row` dict) pairs with
    `with_stats`. Unsupervised: a failure raises to the caller.
    `kw` holds the check's options (classify, realtime, process_order,
    fused, square)."""
    devices = [torch.device(d) for d in devices]
    mesh = Mesh([[d] for d in devices]) if len(devices) > 1 else None
    sw = _Sweep(items, devices[0], kw, None, supervise=False,
                with_stats=with_stats, mesh=mesh)
    idx = list(range(len(items)))
    staged = _h2d_bucket(_prep_bucket(sw, idx), devices[0])
    return _resolve(sw, idx, _enqueue(sw, staged, with_stats))
