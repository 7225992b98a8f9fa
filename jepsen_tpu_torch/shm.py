"""Zero-copy shared-memory transport for pool-encoded histories.

Counterpart of `jepsen_tpu/shm.py`. The pooled ingest
(`ingest.iter_encode_chunks`) would otherwise move every encoding
through the pool's result pipe: each worker pickles its arrays and the
parent unpickles them serially, on the thread that also packs and
dispatches to the device. Here a worker writes the encoded arrays once
into a POSIX shared-memory segment and sends only a small descriptor —
(segment name, per-field offset/shape/dtype) — over the pipe; the
parent maps the segment and wraps numpy views around the same pages,
so the bytes cross the process boundary without a copy.

Leak discipline: the PARENT generates every segment name and hands it
to the worker with the task, so it can always enumerate — and unlink —
segments that were created but never consumed (a worker crash, a
mid-stream pool failure, a caller abandoning the iterator). On the
happy path the parent unlinks each segment the moment it maps it:
POSIX keeps the pages alive until the last mapping dies, so the name
never outlives one round trip. Workers unregister their create from
multiprocessing's resource_tracker (which would otherwise unlink
parent-held segments when a pool worker exits).

Names carry this package's own prefix, `jttshm`, which the reference's
`jtshm` scans (its leak checks and `reclaim_stale`) never match, and
which never matches theirs: two sweeps of the two packages can share a
host.

`JEPSEN_TPU_SHM_INGEST=0` (or an unusable /dev/shm, probed once per
process) falls back to the pickle transport; the pipeline is the same
either way, only the byte path differs.
"""

from __future__ import annotations

import logging
import os
import uuid
from typing import Any

import numpy as np

log = logging.getLogger(__name__)

#: Every segment this module creates carries this prefix, so leak
#: checks (tests, ops) can scan /dev/shm for strays attributably. It
#: is not the reference's `jtshm`, nor does it start with it.
NAME_PREFIX = "jttshm"

# The array fields moved through the segment come from the ONE
# canonical layout (store.ENCODED_FIELDS — shared with the encoded.v1
# sidecar cache). Everything else (key_names, anomalies, scalars)
# rides the descriptor: those are tiny, and only the arrays are worth
# zero-copying.


def enabled() -> bool:
    """One home for the JEPSEN_TPU_SHM_INGEST gate (default on)."""
    from . import gates
    return gates.get("JEPSEN_TPU_SHM_INGEST")


_probe: bool | None = None


def available() -> bool:
    """Can this host actually create shared memory? Probed once per
    process (containers sometimes mount /dev/shm noexec/ro or size 0);
    a False here routes ingest to the pickle transport instead of
    letting every worker die on ENOSPC."""
    global _probe
    if _probe is None:
        try:
            from multiprocessing import shared_memory as _sm
            seg = _sm.SharedMemory(create=True, size=16)
            seg.close()
            seg.unlink()
            _probe = True
        except Exception as e:
            log.info("shared memory unavailable (%r); ingest falls "
                     "back to pickle transport", e)
            _probe = False
    return _probe


def gen_name() -> str:
    """A parent-chosen segment name: unique, attributable, and known
    to the parent BEFORE the worker creates it (the leak-sweep
    contract in the module docstring)."""
    return f"{NAME_PREFIX}_{os.getpid()}_{uuid.uuid4().hex[:12]}"


def _untrack(seg) -> None:
    """Detach a segment from multiprocessing's resource_tracker: the
    creating WORKER must not let the (process-shared) tracker unlink a
    segment the parent still needs when the worker exits. Best-effort:
    the tracker API is semi-private, and on failure the cost is a
    spurious cleanup warning, not a leak."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(seg._name, "shared_memory")
    except Exception:
        pass


def export(enc, name: str, checker: str):
    """Worker side: copy `enc`'s arrays into a fresh segment `name`
    and return the descriptor dict. Any failure (shm mount full,
    unexpected field) degrades to returning `enc` itself — the item
    then rides the pickle pipe like before, per-item."""
    from . import store as _store
    if checker not in _store.ENCODED_FIELDS:
        return enc
    try:
        arrays = _store.encoded_arrays(enc, checker)
        off = 0
        layout = []
        for f, a in arrays:
            off = (off + 7) & ~7           # 8-byte align every field
            layout.append((f, off, a.shape, a.dtype.str))
            off += a.nbytes
        from multiprocessing import shared_memory as _sm
        seg = _sm.SharedMemory(name=name, create=True, size=max(1, off))
        _untrack(seg)
        try:
            for (f, a), (_f, o, _s, _d) in zip(arrays, layout):
                if a.nbytes:
                    # single memcpy into the segment (a is contiguous;
                    # tobytes() here would materialize a second copy)
                    seg.buf[o:o + a.nbytes] = memoryview(a).cast("B")
        finally:
            seg.close()
        if checker == "wr":
            meta = {"n": enc.n, "key_count": enc.key_count,
                    "anomalies": enc.anomalies}
        else:
            meta = {"n": enc.n, "n_keys": enc.n_keys,
                    "max_pos": enc.max_pos, "key_names": enc.key_names,
                    "anomalies": enc.anomalies}
        return {"__jt_shm__": True, "name": name, "checker": checker,
                "fields": layout, "nbytes": off, "meta": meta,
                # cache-hit provenance survives the transport: the
                # parent's warm_copy_bytes attribution needs to know
                # this encoding came from a sidecar even though the
                # rebuild makes fresh view objects
                "warm": bool(getattr(enc, "warm", False))}
    except Exception as e:
        log.debug("shm export failed (%r); item falls back to pickle",
                  e)
        try:
            unlink_stale(name)
        except Exception:
            pass
        return enc


def is_descriptor(payload) -> bool:
    return isinstance(payload, dict) and payload.get("__jt_shm__")


# -- sidecar references ----------------------------------------------------
#
# A warm v2 cache hit must NOT ride shared memory: the worker's mmap
# views would be memcpy'd into a segment and the parent's "zero-copy"
# views would alias that copy — the exact host copy the dispatch-shaped
# sidecar exists to remove, plus the parent-side encoding would lose
# its `.dispatch` views entirely. Instead the worker sends a tiny
# REFERENCE (run dir + checker) and the parent mmaps the sidecar
# itself, so the pages the pack stage hands to device_put are the
# parent's own mapping of the on-disk cache. The parent re-validates
# the cache key on materialize (bounded hash — microseconds), so a
# history rewritten between the worker's check and the parent's map
# degrades to a re-encode, never to stale tensors.

def sidecar_ref(run_dir, checker: str) -> dict:
    """Worker side: the descriptor for a dispatch-shaped cache hit."""
    return {"__jt_sidecar__": True, "dir": str(run_dir),
            "checker": checker}


def is_sidecar_ref(payload) -> bool:
    return isinstance(payload, dict) and payload.get("__jt_sidecar__")


def materialize_sidecar(ref: dict):
    """Parent side: mmap the referenced sidecar. Falls back to a full
    in-parent encode when the sidecar vanished or re-keyed between the
    worker's hit and now (rare; correctness over speed)."""
    from . import store as _store
    enc = _store.load_encoded(ref["dir"], ref["checker"])
    if enc is not None:
        return enc
    from .ingest import encode_run_dir
    try:
        return encode_run_dir(ref["dir"], ref["checker"])
    except Exception as e:
        return e


def _orphan(seg) -> None:
    """Hand the segment's mapping over to the numpy views built on it:
    neuter the SharedMemory object so neither GC nor close() can
    unmap pages the views still reference (mmap teardown then happens
    naturally when the last array dies). The fd is closed now — a
    sweep over thousands of runs must not hold thousands of fds."""
    try:
        if seg._fd >= 0:
            os.close(seg._fd)
            seg._fd = -1
    except OSError:
        pass
    seg._buf = None
    seg._mmap = None


def _attach_retrying(name: str):
    """Open segment `name`, with three jittered, exponentially
    backed-off retries on a transient OSError; FileNotFoundError fails
    at once."""
    import random
    import time
    from multiprocessing import shared_memory as _sm
    for attempt in range(4):
        try:
            return _sm.SharedMemory(name=name)
        except FileNotFoundError:
            raise
        except OSError:
            if attempt == 3:
                raise
            time.sleep(0.005 * 2 ** attempt * random.uniform(0.5, 1.5))


def materialize(desc: dict):
    """Parent side: map the descriptor's segment, UNLINK it
    immediately (pages survive until the views die; the name must
    never outlive this call), and rebuild the encoding with zero-copy
    numpy views over the shared pages. The attach rides a short
    jittered-exponential retry: a transiently starved host (EMFILE,
    ENOMEM under pressure) recovers, while a genuinely missing
    segment (FileNotFoundError) fails straight through — it can only
    mean the descriptor outlived its pages, and waiting won't bring
    them back."""
    seg = _attach_retrying(desc["name"])
    try:
        seg.unlink()
    except FileNotFoundError:
        pass
    buf = seg.buf
    arrays: dict[str, Any] = {}
    for f, off, shape, dt in desc["fields"]:
        n = int(np.prod(shape)) if shape else 1
        arrays[f] = np.frombuffer(buf, dtype=np.dtype(dt), count=n,
                                  offset=off).reshape(shape)
    _orphan(seg)
    from . import store as _store
    enc = _store.rebuild_encoded(desc["checker"], arrays,
                                 desc["meta"])
    if desc.get("warm"):
        enc.warm = True
    return enc


def _pid_alive(pid: int) -> bool:
    """Is `pid` a live process? Permission errors mean alive (someone
    else's process); any other failure errs on the safe side."""
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True


def reclaim_stale(shm_dir: str = "/dev/shm") -> int:
    """Sweep-start reclamation: unlink every `jttshm_<pid>_*` segment
    whose creating pid is DEAD — the parent-pregenerated names a
    previous run left behind when it crashed between a worker's create
    and the parent's materialize (SIGKILL of the whole sweep, OOM
    kill). Segments of live pids (a concurrent sweep on the same
    host) and foreign names are untouched, so /dev/shm can't leak
    across runs yet two sweeps can share a box. Returns the count
    reclaimed (callers attribute it as the `shm_stale_reclaimed`
    counter)."""
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return 0
    n = 0
    for name in names:
        if not name.startswith(NAME_PREFIX + "_"):
            continue
        parts = name.split("_")
        try:
            pid = int(parts[1])
        except (IndexError, ValueError):
            continue
        if pid == os.getpid() or _pid_alive(pid):
            continue
        if unlink_stale(name):
            log.info("reclaimed stale shm segment %s (pid %d dead)",
                     name, pid)
            n += 1
    return n


def unlink_stale(name: str) -> bool:
    """Best-effort unlink of a segment the parent never consumed (the
    exception-path sweep). True if a segment was actually removed."""
    from multiprocessing import shared_memory as _sm
    try:
        seg = _sm.SharedMemory(name=name)
    except FileNotFoundError:
        return False
    except Exception:
        return False
    try:
        seg.close()
    except Exception:
        pass
    try:
        seg.unlink()
        return True
    except Exception:
        return False
