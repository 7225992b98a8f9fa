"""The generator interpreter: pure generators meet real threads.

Counterpart of jepsen.generator.interpreter
(jepsen/src/jepsen/generator/interpreter.clj): spawns one worker thread
per context thread (clients + nemesis), pumps invocations through
per-worker queues, applies them with the test's client/nemesis, and
journals invocations and completions into the history.

Key behaviors preserved from the reference:
  * completions are drained before new invocations (latency-sensitive;
    interpreter.clj:196-204)
  * a crashed client op (:info) permanently retires that process; the
    thread is reassigned process p + concurrency and gets a fresh client
    (interpreter.clj:216-219)
  * :sleep and :log special ops execute on workers but stay out of the
    history (goes_in_history, interpreter.clj:167-173)
  * when the generator is pending, we wait at most 1 ms before asking it
    again (max-pending-interval, interpreter.clj:161-165)
  * generator exceptions cancel workers once, then queue :exit
    (interpreter.clj:276-292)

The port's copy of `jepsen_tpu/generator/interpreter.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any

from .. import client as jclient
from .. import generator as gen
from ..util import relative_time_nanos

log = logging.getLogger(__name__)

MAX_PENDING_INTERVAL_S = 0.001  # 1 ms


def goes_in_history(op: dict) -> bool:
    return op.get("type") not in ("sleep", "log")


class ClientWorker:
    """Owns the client for whatever process its thread currently runs
    (interpreter.clj:32-63)."""

    def __init__(self, node: str):
        self.node = node
        self.process = None
        self.client = None

    def invoke(self, test: dict, op: dict) -> dict:
        if self.process != op.get("process"):
            self.close(test)
            try:
                base = test.get("client") or jclient.noop()
                self.client = base.open(test, self.node)
                self.process = op.get("process")
            except Exception as e:
                log.warning("Error opening client: %s", e)
                self.client = None
                return {**op, "type": "fail", "error": ["no-client", str(e)]}
        return self.client.invoke(test, op)

    def close(self, test: dict) -> None:
        if self.client is not None:
            try:
                self.client.close(test)
            finally:
                self.client = None


class NemesisWorker:
    def invoke(self, test: dict, op: dict) -> dict:
        nem = test.get("nemesis")
        if nem is None:
            return {**op, "type": "info"}
        return nem.invoke(test, op)

    def close(self, test: dict) -> None:
        pass


def _make_worker(test: dict, wid) -> Any:
    if isinstance(wid, int):
        nodes = test.get("nodes") or ["local"]
        return ClientWorker(nodes[wid % len(nodes)])
    return NemesisWorker()


def _worker_loop(test: dict, wid, in_q: queue.Queue, out_q: queue.Queue,
                 drain_event: threading.Event):
    worker = _make_worker(test, wid)
    try:
        while True:
            op = in_q.get()
            t = op.get("type")
            if t == "exit":
                return
            try:
                if t == "sleep":
                    # interruptible: once the generator is exhausted the
                    # event loop sets drain_event, so a long nemesis
                    # sleep can't hold the whole run open past its
                    # time limit (the sleep's pacing is moot by then)
                    drain_event.wait(op.get("value") or 0)
                    out_q.put(op)
                elif t == "log":
                    log.info("%s", op.get("value"))
                    out_q.put(op)
                else:
                    out_q.put(worker.invoke(test, op))
            except BaseException as e:  # crashes become :info completions
                log.warning("Process %r crashed: %s", op.get("process"), e)
                out_q.put({**op, "type": "info",
                           "error": f"indeterminate: {e}",
                           "exception": {"class": type(e).__name__,
                                         "message": str(e)}})
    finally:
        worker.close(test)


def run(test: dict) -> list[dict]:
    """Evaluate all ops from test["generator"], returning the history.
    Callers must be inside util.relative_time (t=0 anchor)."""
    ctx = gen.Context.for_test(test)
    worker_ids = ctx.all_threads()
    completions: queue.Queue = queue.Queue()
    invocations: dict = {}
    drain_event = threading.Event()
    threads = []
    for wid in worker_ids:
        in_q: queue.Queue = queue.Queue(maxsize=1)
        invocations[wid] = in_q
        th = threading.Thread(
            target=_worker_loop,
            args=(test, wid, in_q, completions, drain_event),
            name=f"jepsen-worker-{wid}", daemon=True)
        th.start()
        threads.append(th)

    g = gen.Validate(gen.FriendlyExceptions(test.get("generator")))
    history: list = []
    outstanding = 0
    poll_timeout = 0.0
    try:
        while True:
            op_c = None
            try:
                if poll_timeout > 0:
                    op_c = completions.get(timeout=poll_timeout)
                else:
                    op_c = completions.get_nowait()
            except queue.Empty:
                op_c = None

            if op_c is not None:
                thread = ctx.process_to_thread(op_c.get("process"))
                now = relative_time_nanos()
                op_c = {**op_c, "time": now}
                ctx = ctx.with_time(now).free(thread)
                if thread != gen.NEMESIS and op_c.get("type") == "info":
                    ctx = ctx.with_worker(thread, ctx.next_process(thread))
                g = gen.update(g, test, ctx, op_c)
                if goes_in_history(op_c):
                    history.append(op_c)
                outstanding -= 1
                poll_timeout = 0.0
                continue

            now = relative_time_nanos()
            ctx = ctx.with_time(now)
            res = gen.op(g, test, ctx)
            if res is None:
                drain_event.set()   # wake any sleeping workers
                if outstanding > 0:
                    poll_timeout = MAX_PENDING_INTERVAL_S
                    continue
                for in_q in invocations.values():
                    in_q.put({"type": "exit"})
                for th in threads:
                    th.join()
                return history
            o, g2 = res
            if o is gen.PENDING:
                poll_timeout = MAX_PENDING_INTERVAL_S
                continue
            if now < o.get("time", 0):
                # Not time yet; wait for completions until it's due.
                poll_timeout = (o["time"] - now) / 1e9
                continue
            thread = ctx.process_to_thread(o.get("process"))
            invocations[thread].put(o)
            ctx = ctx.with_time(o.get("time", now)).busy(thread)
            g2 = gen.update(g2, test, ctx, o)
            if goes_in_history(o):
                history.append(o)
            g = g2
            outstanding += 1
            poll_timeout = 0.0
    except BaseException:
        log.info("Shutting down workers after abnormal exit")
        drain_event.set()
        for in_q in invocations.values():
            try:
                # Workers drain their single-slot queue quickly; if one is
                # truly wedged it's a daemon thread and dies with us.
                in_q.put({"type": "exit"}, timeout=1.0)
            except queue.Full:
                pass
        raise
