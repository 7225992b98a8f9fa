"""JT-THREAD — concurrency discipline.

The hot path is three threads (dispatcher / pack-h2d / watchdog) over
process pools; the failure modes this family polices are exactly the
ones already hit and fixed in this tree: `multiprocessing.Pool` hangs
forever on a SIGKILLed worker (every pool moved to
`ProcessPoolExecutor` + spawn), fork-starting workers from a process
with live threads deadlocks in the child, a bare `.acquire()` leaks
the lock on any exception path, and out-of-API writes to tracer
internals race the recording threads.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, const_str, dotted

_TRACE_FILE = "jepsen_tpu_torch/trace.py"
_LOCK_CTORS = {"Lock", "RLock"}
_TRACERISH = {"tr", "tracer"}


class MpPool(ModuleRule):
    id = "JT-THREAD-001"
    doc = ("multiprocessing.Pool usage — a worker that dies without "
           "delivering (SIGKILL, OOM killer) hangs imap forever; the "
           "exact bug class the move to spawned executors removed")
    hint = ("use concurrent.futures.ProcessPoolExecutor with "
            "mp_context=get_context('spawn') — a dead worker raises "
            "BrokenProcessPool instead of hanging")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "Pool":
                yield self.finding(ctx, n, "multiprocessing-style .Pool()")


class BareLockAcquire(ModuleRule):
    id = "JT-THREAD-002"
    doc = ("bare .acquire() on a threading Lock/RLock — any exception "
           "between acquire and release leaks the lock and wedges "
           "every later waiter")
    hint = "use `with lock:` (or try/finally release at minimum)"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        # names (and attribute names) assigned from Lock()/RLock() —
        # Semaphores/Events acquired bare for flow control don't count
        lock_names: set[str] = set()
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                d = dotted(n.value.func)
                if d and d.split(".")[-1] in _LOCK_CTORS:
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            lock_names.add(t.id)
                        elif isinstance(t, ast.Attribute):
                            lock_names.add(t.attr)
        if not lock_names:
            return
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "acquire":
                recv = n.func.value
                name = recv.id if isinstance(recv, ast.Name) \
                    else recv.attr if isinstance(recv, ast.Attribute) \
                    else None
                if name in lock_names:
                    yield self.finding(
                        ctx, n, f"bare acquire() on lock `{name}`")


class ForkStart(ModuleRule):
    id = "JT-THREAD-003"
    doc = ("fork(server) start method — forking a process with live "
           "threads (dispatcher/pack-h2d/watchdog are always up) "
           "deadlocks the child on whatever locks the threads held")
    hint = "always pass 'spawn': mp.get_context('spawn')"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            d = dotted(n.func)
            tail = d.split(".")[-1] if d else None
            if tail not in ("get_context", "set_start_method"):
                continue
            arg = const_str(n.args[0]) if n.args else None
            if arg is None and not n.args:
                yield self.finding(
                    ctx, n,
                    f"{tail}() without an explicit method defaults to "
                    "fork on Linux")
            elif arg in ("fork", "forkserver"):
                yield self.finding(ctx, n, f"{tail}({arg!r})")


class TracerPrivateAccess(ModuleRule):
    id = "JT-THREAD-004"
    doc = ("access to tracer private state (tr._events, "
           "trace._current, ...) outside trace.py — the recording "
           "threads own those structures; out-of-API writes race them")
    hint = ("go through the trace API (span/add_span/instant/"
            "counter/…, set_current/reset)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if ctx.rel.endswith(_TRACE_FILE):
            return
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Attribute):
                continue
            if not (n.attr.startswith("_") and not n.attr.startswith("__")):
                continue
            recv = n.value
            if isinstance(recv, ast.Name) \
                    and (recv.id in _TRACERISH or recv.id == "trace"):
                yield self.finding(
                    ctx, n, f"private tracer state `{recv.id}.{n.attr}`")


RULES = [MpPool(), BareLockAcquire(), ForkStart(),
         TracerPrivateAccess()]
