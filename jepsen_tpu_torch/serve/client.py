"""Tenant-side client for the verdict daemon.

Counterpart of `jepsen_tpu/serve/client.py`: it speaks the
reference's frames, so it drives a daemon or router of either
package.

A thin, dependency-light wrapper over the frame protocol: connect,
hello, stream CHECK frames, collect verdicts. Handles the service's
explicit flow control for the caller — `retry-after` frames are
honored by re-sending after the daemon's delay hint (bounded), so
`collect` returns exactly one verdict per submitted id or raises.

Retries are BOUNDED (the client half of the fleet failover contract):
backpressure resends and reconnects back off exponentially with
jitter, and once JEPSEN_TPU_SERVE_RETRY_S passes without progress (a
verdict landing, a connection succeeding) the client raises the
terminal `ServeUnavailable` instead of spinning forever against a
permanently dead endpoint. A router failover therefore shows up to a
tenant as at most a bounded stall, and a real outage as a clean error.

The tests and `chip_smoke.py` drive the real socket through this
class; there is no in-process shortcut to test instead.
"""

from __future__ import annotations

import random
import socket
import threading
import time

from .. import gates
from . import protocol


class ServeError(RuntimeError):
    pass


class ServeUnavailable(ServeError):
    """Terminal: the endpoint stayed unreachable or backpressured past
    JEPSEN_TPU_SERVE_RETRY_S without any progress. The caller's move
    is a fresh connection (possibly to a different endpoint), not
    another resend on this one."""


def retry_budget_s() -> float:
    """The JEPSEN_TPU_SERVE_RETRY_S no-progress budget (seconds; `0`
    fails on the first retryable condition)."""
    v = gates.get("JEPSEN_TPU_SERVE_RETRY_S")
    return max(0.0, float(v)) if v is not None else 60.0


class ServeClient:
    def __init__(self, socket_path=None, host: str = "127.0.0.1",
                 port: int | None = None, tenant: str = "default",
                 weight: float | None = None, timeout: float = 60.0):
        self.socket_path = socket_path
        self.host = host
        self.port = port
        self.tenant = tenant
        self.weight = weight
        self.timeout = timeout
        self.sock: socket.socket | None = None
        self.welcome: dict | None = None
        #: ids submitted but not yet verdicted (retry bookkeeping)
        self._inflight: dict[str, dict] = {}
        self.verdicts: dict[str, dict] = {}
        self.replays = 0
        self.retries = 0
        #: per-id submit/verdict monotonic stamps — the open-loop load
        #: generator's latency record (client-observed end to end)
        self.sent_at: dict[str, float] = {}
        self.done_at: dict[str, float] = {}
        # one connection may be driven by a submitter thread AND a
        # collector thread (the open-loop generator): frame sends are
        # serialized so two frames can't interleave on the stream
        self._slock = threading.Lock()

    # -- connection --------------------------------------------------------

    def _connect_once(self) -> dict:
        if self.port is not None:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.settimeout(self.timeout)
            s.connect((self.host, self.port))
        else:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self.timeout)
            s.connect(str(self.socket_path))
        self.sock = s
        hello = {"op": "hello", "tenant": self.tenant}
        if self.weight is not None:
            hello["weight"] = self.weight
        protocol.send_frame(s, hello)
        w = protocol.recv_frame(s)
        if not w or w.get("op") != "welcome":
            raise ServeError(f"expected welcome, got {w!r}")
        self.welcome = w
        return w

    def connect(self, retry: bool = False) -> dict:
        """Connect + hello. With `retry`, a refused/failed connect
        backs off exponentially (with jitter) and keeps trying until
        JEPSEN_TPU_SERVE_RETRY_S passes without success — then the
        terminal ServeUnavailable."""
        if not retry:
            return self._connect_once()
        budget = retry_budget_s()
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                return self._connect_once()
            except (OSError, ServeError):
                if time.monotonic() - t0 > budget:
                    raise ServeUnavailable(
                        f"endpoint unreachable for {budget:.1f}s "
                        "(JEPSEN_TPU_SERVE_RETRY_S)") from None
                self._backoff_sleep(attempt)
                attempt += 1

    def close(self) -> None:
        if self.sock is not None:
            try:
                protocol.send_frame(self.sock, {"op": "bye"})
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def __enter__(self) -> "ServeClient":
        self.connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission --------------------------------------------------------

    def _submit(self, frame: dict) -> str:
        rid = frame["id"]
        self._inflight[rid] = frame
        self.sent_at.setdefault(rid, time.monotonic())
        with self._slock:
            protocol.send_frame(self.sock, frame)
        return rid

    def check_dir(self, run_dir, checker: str = "append",
                  rid: str | None = None) -> str:
        """Submit a store run dir by reference (the daemon encodes it
        through the warm sidecar path — zero-copy on a v2 hit)."""
        return self._submit({"op": "check",
                             "id": rid or str(run_dir),
                             "checker": checker, "dir": str(run_dir)})

    def check_history(self, ops: list, rid: str,
                      checker: str = "append") -> str:
        """Submit inline history ops (the convenience path)."""
        return self._submit({"op": "check", "id": rid,
                             "checker": checker, "history": ops})

    def check_encoded(self, enc, rid: str,
                      checker: str = "append") -> str:
        """Submit a locally-encoded history through shared memory: the
        arrays are exported once into a segment and only the
        descriptor rides the socket — the daemon maps the same pages
        (zero-copy) and unlinks the name immediately. The segment is
        the port's (`jttshm*`): a daemon of this package maps it."""
        from .. import shm
        payload = shm.export(enc, shm.gen_name(), checker)
        if shm.is_descriptor(payload):
            return self._submit({"op": "check", "id": rid,
                                 "checker": checker, "shm": payload})
        # shm unavailable: fall back to inline ops? The encoding has
        # no ops anymore — refuse loudly rather than silently re-parse
        raise ServeError("shared-memory export unavailable "
                         "(JEPSEN_TPU_SHM_INGEST=0 or /dev/shm "
                         "unusable); submit by dir or history instead")

    # -- collection --------------------------------------------------------

    def recv(self) -> dict | None:
        return protocol.recv_frame(self.sock)

    def _backoff_sleep(self, attempt: int, hint: float | None = None,
                       deadline: float | None = None) -> None:
        """Exponential backoff with jitter: the daemon's delay hint is
        the floor, doubling per attempt since last progress, capped —
        a thundering herd of retrying tenants decorrelates instead of
        hammering a recovering daemon in lockstep."""
        delay = min(5.0, max(float(hint or 0.0),
                             0.05 * (2 ** min(attempt, 7))))
        delay *= random.uniform(0.5, 1.0)
        if deadline is not None:
            delay = min(delay, max(0.0, deadline - time.monotonic()))
        time.sleep(delay)

    def _reconnect(self, last_progress: float, budget: float,
                   deadline: float | None) -> None:
        """Bounded reconnect for `collect(reconnect=True)`: back off
        until the endpoint answers (a restarted daemon, a router past
        its failover), then re-send every outstanding id — journaled
        verdicts replay, the rest re-check."""
        try:
            self.sock.close()
        except OSError:
            pass
        attempt = 0
        while True:
            if time.monotonic() - last_progress > budget:
                raise ServeUnavailable(
                    f"endpoint unreachable for {budget:.1f}s "
                    "(JEPSEN_TPU_SERVE_RETRY_S) with "
                    f"{len(self._inflight)} outstanding")
            if deadline is not None and time.monotonic() > deadline:
                raise ServeError(
                    f"collect timed out with {len(self._inflight)} "
                    "verdict(s) outstanding")
            self._backoff_sleep(attempt, deadline=deadline)
            attempt += 1
            try:
                self._connect_once()
                break
            except (OSError, ServeError):
                continue
        for pend in list(self._inflight.values()):
            with self._slock:
                protocol.send_frame(self.sock, pend)

    def collect(self, timeout: float | None = None,
                max_retries: int = 100,
                expect: int | None = None,
                reconnect: bool = False) -> dict[str, dict]:
        """Drain the socket until every submitted id has a verdict.
        `retry-after` frames re-submit after a jittered exponential
        backoff floored at the daemon's delay hint (up to
        `max_retries` total); a `draining` retry-after keeps retrying
        too — after a restart the new daemon replays from the journal.
        With `reconnect`, a closed connection is retried the same way
        (outstanding ids are re-sent after the new welcome) instead of
        raising. Either way, JEPSEN_TPU_SERVE_RETRY_S without progress
        is terminal: ServeUnavailable. With `expect`, keep collecting
        until that many TOTAL verdicts have landed — the open-loop
        generator's collector thread starts before the first
        submission, when the in-flight set is still empty. Returns
        {id: result}."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        budget = retry_budget_s()
        last_progress = time.monotonic()
        attempts = 0     # retryable conditions since last progress
        while self._inflight or (expect is not None
                                 and len(self.verdicts) < expect):
            if deadline is not None and time.monotonic() > deadline:
                raise ServeError(
                    f"collect timed out with {len(self._inflight)} "
                    f"verdict(s) outstanding")
            try:
                frame = self.recv()
            except OSError:
                frame = None
            if frame is None:
                if not reconnect:
                    raise ServeError(
                        "daemon closed the connection with "
                        f"{len(self._inflight)} outstanding")
                self._reconnect(last_progress, budget, deadline)
                attempts += 1
                continue
            op = frame.get("op")
            if op == "verdict":
                rid = frame.get("id")
                self._inflight.pop(rid, None)
                self.verdicts[rid] = frame["result"]
                self.done_at[rid] = time.monotonic()
                if frame.get("replay"):
                    self.replays += 1
                last_progress = time.monotonic()
                attempts = 0
            elif op == "retry-after":
                rid = frame.get("id")
                pend = self._inflight.get(rid)
                if pend is None:
                    continue
                if self.retries >= max_retries:
                    raise ServeError("retry budget exhausted")
                if time.monotonic() - last_progress > budget:
                    raise ServeUnavailable(
                        f"no progress in {budget:.1f}s "
                        "(JEPSEN_TPU_SERVE_RETRY_S) with "
                        f"{len(self._inflight)} outstanding")
                self.retries += 1
                self._backoff_sleep(
                    attempts, hint=float(frame.get("delay_s") or 0.2),
                    deadline=deadline)
                attempts += 1
                with self._slock:
                    protocol.send_frame(self.sock, pend)
            elif op == "error":
                raise ServeError(f"daemon error: {frame.get('error')}")
        return dict(self.verdicts)
