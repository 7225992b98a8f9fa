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
components first. The reference's tracer spans and counters, its cost
planner and its mesh are not ported; each call site that feeds one of
its counters is marked with the counter's name.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from .. import gates
from .. import supervisor as sv
from ..checker.elle import kernels as K

log = logging.getLogger(__name__)

# Above this txn count the dense [T,T] closure no longer fits a device;
# check_long_history switches to SCC condensation (elle.condense).
DENSE_TXN_LIMIT = 32_768


class _Sweep:
    """What every bucket of one dispatch shares: the histories (encoded
    histories, or host-built edge dicts: `edges`), the device, the
    kernel options, the caller's bucket log, and whether the supervisor
    recovers from failures here (`supervise`) or leaves every one to the
    caller."""

    __slots__ = ("encs", "device", "kw", "bucket_log", "edges", "supervise")

    def __init__(self, encs: Sequence, device: torch.device, kw: dict,
                 bucket_log: list | None, supervise: bool = True):
        self.encs = encs
        self.device = device
        self.kw = kw
        self.bucket_log = bucket_log
        self.edges = bool(len(encs)) and isinstance(encs[0], dict)
        self.supervise = supervise

    def fail_fast(self) -> bool:
        """Re-raise a failure instead of recovering: strict mode, or a
        caller that owns the policy."""
        return not self.supervise or sv.strict_enabled()


class _Staged:
    """One bucket on its way to the device: packed on the host
    (`packed`), then copied (`batch`, with `ready` the copy's CUDA event
    and `host` its pinned buffers, kept until the bucket resolves)."""

    __slots__ = ("bucket", "t0", "packed", "batch", "ready", "host")

    def __init__(self, bucket: list[int], t0: float, packed: dict):
        self.bucket = bucket
        self.t0 = t0
        self.packed = packed
        self.batch = self.ready = self.host = None


class _Dispatch:
    """One bucket enqueued on the device and not yet read: its [B] flag
    words and closure round counters (device tensors), the CUDA event
    recorded after its last launch (None on the CPU), its padded T and
    pack start (for the bucket log), and its pinned host buffers."""

    __slots__ = ("flags", "rounds", "done", "t_pad", "t0", "host")

    def __init__(self, flags, rounds, done, t_pad: int, t0: float,
                 host=None):
        self.flags = flags
        self.rounds = rounds
        self.done = done
        self.t_pad = t_pad
        self.t0 = t0
        self.host = host

    def is_ready(self) -> bool:
        return self.done is None or self.done.query()


def _done_event(device: torch.device):
    """A CUDA event recorded on `device`'s current stream after the work
    enqueued so far; None on the CPU, where work is done when enqueued."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _device_ready(done, timeout: float | None) -> bool:
    """Wait for `done` (see `_done_event`), at most `timeout` seconds
    (None: no bound): True once the work before it has completed. The
    one place a dispatch waits on the device."""
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
    freed in stream order."""
    timeout = sv.dispatch_timeout_s()
    for _attempt in range(2):
        if _device_ready(done, timeout):
            return
        # counter: watchdog_timeouts (once per dispatch, first attempt)
    raise sv.WatchdogTimeout(f"device dispatch exceeded {timeout}s twice")


def check_long_history(enc, device=None, *, classify: bool = True,
                       realtime: bool = False, process_order: bool = False,
                       dense_limit: int = DENSE_TXN_LIMIT,
                       square: K.Square | None = None,
                       bucket_log: list | None = None,
                       condense_log: list | None = None) -> dict:
    """Check ONE encoded history on `device` (default cuda); returns
    {anomaly: True} flags.

    Up to `dense_limit` txns: the dense closure, one bucket, its wait
    bounded by the dispatch watchdog (a timeout raises WatchdogTimeout
    to the caller). Beyond it: host SCC condensation feeding the device
    classification per nontrivial SCC (`condense.check_condensed`,
    which also takes `condense_log`) — the 100k-op path, exact because
    every anomaly query is answered inside one SCC. `square` and
    `bucket_log` as in `check_bucketed`."""
    from ..devices import resolve_device
    dev = resolve_device(device)
    if enc.n > dense_limit:
        from ..checker.elle import condense
        return condense.check_condensed(
            enc, dev, classify=classify, realtime=realtime,
            process_order=process_order, square=square,
            bucket_log=bucket_log, condense_log=condense_log)
    sw = _Sweep([enc], dev, dict(
        classify=classify, realtime=realtime, process_order=process_order,
        fused=K.fused_classify_enabled(), square=square), bucket_log)
    staged = _h2d_bucket(_prep_bucket(sw, [0]), dev)
    return K.flags_to_names(_resolve(sw, _enqueue(sw, staged))[0])


def _size_of(e) -> int:
    """Txn count of an encoded history (attribute) or packed edge dict
    (key) — both bucket the same way."""
    return e["n"] if isinstance(e, dict) else e.n


def bucket_by_length(encs: Sequence, *, multiple: int = 128,
                     budget_cells: int = 1 << 27) -> list[list[int]]:
    """Partition history indices into buckets of similar padded txn
    count. Each bucket satisfies B * T_pad² <= budget_cells, where T_pad
    is the bucket max rounded up to `multiple` and B the bucket size.
    Returns buckets of indices into encs, longest histories first.
    Elements may be EncodedHistory-like (`.n`) or packed edge dicts
    (`["n"]`)."""
    order = sorted(range(len(encs)), key=lambda i: -_size_of(encs[i]))
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_tpad = 0
    for i in order:
        tpad = max(K.pad_to(max(_size_of(encs[i]), 1), multiple), 1)
        t = max(cur_tpad, tpad)
        if cur and (len(cur) + 1) * t * t > budget_cells:
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
    sentinel instead — callers render it as `valid? unknown`)."""

    def __init__(self, n: int, parts: list, finish):
        self._n = n
        # [bucket indices, a _Dispatch still on the device, or the
        # resolved per-history flag words / Quarantined sentinels]
        self._parts = parts
        # finish(idx, dispatch) -> resolved list: the dispatcher's
        # watchdog + OOM-backdown closure
        self._finish = finish
        self._result: list | None = None

    def is_ready(self) -> bool:
        """True when every bucket's work has completed on the device;
        never blocks."""
        return all(not isinstance(x, _Dispatch) or x.is_ready()
                   for _, x in self._parts)

    def result(self) -> list:
        """The verdicts, in input order; idempotent."""
        if self._result is not None:
            return self._result
        out: list = [None] * self._n
        for idx, words in self._parts:
            if isinstance(words, _Dispatch):
                words = self._finish(idx, words)
            for i, w in zip(idx, words):
                out[i] = (w if isinstance(w, sv.Quarantined)
                          else K.flags_to_names(int(w)))
        self._parts = []
        self._result = out
        return out


def pack_thread_enabled() -> bool:
    """The JEPSEN_TPU_PACK_THREAD gate (default on): check_bucketed_async
    packs buckets and copies them to the device on a dedicated thread,
    so the calling thread only enqueues checks and resolves them. 0
    keeps everything inline on the calling thread."""
    return gates.get("JEPSEN_TPU_PACK_THREAD")


def _est_cells(encs: Sequence, bucket: list[int]) -> int:
    """The padded footprint bucket_by_length budgeted for this bucket
    (B x T_pad²), computable before packing, so the dispatcher can spot
    buckets over the per-slot budget (only a single history too big to
    subdivide can be)."""
    tpad = max(K.pad_to(max(_size_of(encs[i]) for i in bucket), 128), 1)
    return len(bucket) * tpad * tpad


def _prep_bucket(sw: _Sweep, bucket: list[int]) -> _Staged:
    """Host-side packing of one bucket: its histories padded into numpy
    arrays (`kernels.pack_batch`), or its edge dicts into cell lists
    (`kernels.pack_edge_matrices`). Runs on the pack-h2d thread when
    pack_thread_enabled(), inline otherwise."""
    t0 = time.perf_counter()
    group = [sw.encs[i] for i in bucket]
    return _Staged(bucket, t0, K.pack_edge_matrices(group) if sw.edges
                   else K.pack_batch(group))


def _h2d_bucket(item: _Staged, device: torch.device,
                stream=None) -> _Staged:
    """The host-to-device copy of one packed bucket, on `stream` (the
    dispatch's copy stream; None: the current stream), an event marking
    its end. A packed batch's arrays are pinned and copied without
    blocking, widened to int64 there; the pinned buffers stay with the
    bucket until it resolves. An edge batch's cell lists are copied and
    scattered into its [B,T,T] matrices (`kernels.edge_batch_to_device`)
    on that stream, so the copy waits for no earlier bucket's check."""
    packed, item.packed = item.packed, None
    to_device = K.edge_batch_to_device if "T" in packed \
        else K.batch_to_device
    if device.type != "cuda":
        item.batch = to_device(packed, device)
        return item
    with torch.cuda.stream(stream):
        if to_device is K.batch_to_device:
            item.host = {
                k: torch.from_numpy(np.ascontiguousarray(packed[k]))
                .pin_memory() for k in K.DEVICE_FIELDS}
            item.batch = {k: item.host[k].to(device, non_blocking=True)
                          .to(dt) for k, dt in K.DEVICE_FIELDS.items()}
            item.batch["shape"] = packed["shape"]
        else:
            item.batch = to_device(packed, device)
        item.ready = torch.cuda.Event()
        item.ready.record()
    return item


def _enqueue(sw: _Sweep, item: _Staged) -> _Dispatch:
    """Enqueue one copied bucket's check on the device's current stream
    and return without reading anything back. The stream first waits
    for the bucket's copy, and each input tensor is marked as used on
    it, so the caching allocator cannot hand the inputs' memory to a
    later copy before this check has read them; the inputs are then
    dropped."""
    batch, item.batch = item.batch, None
    if item.ready is not None:
        compute = torch.cuda.current_stream(sw.device)
        compute.wait_event(item.ready)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(compute)
    rounds: list = []
    if sw.edges:
        flags = K.classify_matrices_device(batch, rounds=rounds, **sw.kw)
        t_pad = batch["T"]
    else:
        flags = K.check_batch_device(batch, rounds=rounds, **sw.kw)
        t_pad = batch["shape"].n_txns
    part = _Dispatch(flags, rounds, _done_event(sw.device), t_pad,
                     item.t0, item.host)
    item.host = None
    return part


def _resolve(sw: _Sweep, part: _Dispatch) -> list[int]:
    """Wait for one dispatch (bounded by the watchdog) and read its flag
    words. The bucket log gets the bucket's history count, padded T, the
    rounds each closure ran (`kernels.read_rounds`), the closure_square
    launches it enqueued (every round of every closure, skipped ones
    included) and the seconds since its packing began."""
    _block_flags(part.done)
    words = part.flags.tolist()
    if sw.bucket_log is not None:
        sw.bucket_log.append({
            "histories": len(words), "t_pad": part.t_pad,
            "closure_rounds": K.read_rounds(part.rounds),
            "launches": K.closure_steps(part.t_pad) * len(part.rounds),
            "seconds": time.perf_counter() - part.t0})
    return words


def _quarantine_bucket(idx: list, stage: str, err) -> list:
    """Per-history Quarantined sentinels for a bucket the supervisor
    abandoned."""
    # counter: quarantined (+= len(idx)), with a "quarantine" span
    log.warning("quarantined %d histories (%s): %r", len(idx), stage, err)
    e = repr(err)
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


def _sync_check(sw: _Sweep, idx: list) -> list[int]:
    """One synchronous bucket check — the OOM-backdown retry path: pack,
    copy, enqueue, wait. Raises on OOM or watchdog timeout; the caller
    owns the split/quarantine policy."""
    item = _h2d_bucket(_prep_bucket(sw, idx), sw.device)
    sv.maybe_inject_oom()
    return _resolve(sw, _enqueue(sw, item))


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
    # counter: oom_retries
    if len(idx) == 1:
        return _quarantine_bucket(idx, "oom", err)
    # counter: bucket_splits
    mid = (len(idx) + 1) // 2
    half_budget = max(1, budget_cells // 2)
    out: list = []
    for half in (idx[:mid], idx[mid:]):
        try:
            out.extend(_sync_check(sw, half))
        except BaseException as e:
            if isinstance(e, sv.WatchdogTimeout) and not sw.fail_fast():
                out.extend(_quarantine_bucket(half, "watchdog", e))
            elif sv.is_oom_error(e) and not sw.fail_fast():
                out.extend(_oom_backdown(sw, half, half_budget, e))
            else:
                raise
    return out


def _finish_part(sw: _Sweep, idx: list, part: _Dispatch,
                 budget_cells: int) -> list:
    """Resolve one dispatched bucket to per-history flag words,
    recovering from an OOM (backdown) and a watchdog timeout
    (quarantine) unless strict."""
    try:
        return _resolve(sw, part)
    except BaseException as e:
        if isinstance(e, sv.WatchdogTimeout) and not sw.fail_fast():
            return _quarantine_bucket(idx, "watchdog", e)
        if sv.is_oom_error(e) and not sw.fail_fast():
            return _oom_backdown(sw, idx, budget_cells, e)
        raise


def check_bucketed_async(encs: Sequence, device: torch.device, *,
                         classify: bool = True, realtime: bool = False,
                         process_order: bool = False,
                         budget_cells: int = 1 << 27,
                         fused: bool | None = None,
                         max_inflight: int = 2,
                         square: K.Square | None = None,
                         bucket_log: list | None = None,
                         supervise: bool = True) -> PendingVerdicts:
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

    `fused` defaults to the JEPSEN_TPU_FUSED_CLASSIFY gate; `square` and
    `bucket_log` as in `check_bucketed`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # the pack-h2d thread names its device explicitly
        device = torch.device("cuda", torch.cuda.current_device())
    parts: list = []
    inflight: list[int] = []    # indices into parts, oldest first
    depth = max(1, max_inflight)
    sw = _Sweep(encs, device, dict(
        classify=classify, realtime=realtime, process_order=process_order,
        fused=K.fused_classify_enabled() if fused is None else fused,
        square=square), bucket_log, supervise)
    copies = torch.cuda.Stream(device) if device.type == "cuda" else None
    eff_budget = max(1, budget_cells // depth)
    buckets = bucket_by_length(encs, budget_cells=eff_budget)
    # Singleton buckets whose one history alone exceeds the per-slot
    # budget cannot share the envelope: peel them off to dispatch
    # strictly alone after the pipelined buckets drain.
    oversized = [b for b in buckets if _est_cells(encs, b) > eff_budget]
    buckets = [b for b in buckets if _est_cells(encs, b) <= eff_budget]

    def finish(idx, part):
        # counter: buckets_resolved
        return _finish_part(sw, idx, part, eff_budget)

    def resolve_oldest():
        j = inflight.pop(0)
        idx, part = parts[j]
        parts[j] = [idx, finish(idx, part)]

    def dispatch(item: _Staged) -> bool:
        """Enqueue one copied bucket; returns False when the bucket was
        instead resolved synchronously (an OOM at enqueue went down the
        backdown path — nothing joined the pipeline)."""
        try:
            sv.maybe_inject_oom()
            part = _enqueue(sw, item)
        except BaseException as e:
            if not sv.is_oom_error(e) or sw.fail_fast():
                raise
            # the failed bucket's tensors go before the halves allocate
            item.batch = item.host = None
            parts.append([item.bucket, _oom_backdown(
                sw, item.bucket, eff_budget, e)])
            return False
        parts.append([item.bucket, part])
        inflight.append(len(parts) - 1)
        # counter: buckets_dispatched
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
            parts.append([bucket, _quarantine_bucket(bucket, "pack", e)])

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
                        item = _prep_bucket(sw, b)
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
                item = out.get()
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
                item = _h2d_bucket(_prep_bucket(sw, bucket), device,
                                   copies)
            except BaseException as e:
                handle_failed(bucket, e)
                continue
            dispatch(item)
    for bucket in oversized:
        # strictly alone: drain everything first
        while inflight:
            resolve_oldest()
        try:
            item = _h2d_bucket(_prep_bucket(sw, bucket), device, copies)
        except BaseException as e:
            handle_failed(bucket, e)
            continue
        dispatch(item)
    return PendingVerdicts(len(encs), parts, finish)


def check_bucketed(encs: Sequence, device: torch.device, *,
                   classify: bool = True, realtime: bool = False,
                   process_order: bool = False,
                   budget_cells: int = 1 << 27,
                   two_pass: bool | None = None,
                   fused: bool | None = None,
                   square: K.Square | None = None,
                   bucket_log: list | None = None) -> list:
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

    `square` replaces the closure squaring (see kernels.check_batch_device).
    `bucket_log`, when given, gets one dict per bucket checked (its
    history count, padded T, the rounds each closure ran, the launches it
    enqueued and the seconds from its packing to its flags on the host;
    see `_resolve`), in the order the buckets resolve."""
    if not len(encs):
        return []
    if fused is None:
        fused = K.fused_classify_enabled()
    if two_pass is None:
        two_pass = classify and not fused
    if classify and two_pass:
        detect = check_bucketed(encs, device, classify=False,
                                realtime=realtime,
                                process_order=process_order,
                                budget_cells=budget_cells, square=square,
                                bucket_log=bucket_log)
        flagged = [i for i, f in enumerate(detect)
                   if f and not isinstance(f, sv.Quarantined)]
        if not flagged:
            return detect
        full = check_bucketed([encs[i] for i in flagged], device,
                              classify=True, realtime=realtime,
                              process_order=process_order,
                              budget_cells=budget_cells, two_pass=False,
                              fused=False, square=square,
                              bucket_log=bucket_log)
        out = list(detect)
        for i, r in zip(flagged, full):
            out[i] = r
        return out
    return check_bucketed_async(
        encs, device, classify=classify, realtime=realtime,
        process_order=process_order, budget_cells=budget_cells,
        fused=fused, square=square, bucket_log=bucket_log).result()
