"""The verdict daemon: `python -m jepsen_tpu_torch.cli serve`.

Counterpart of `jepsen_tpu/serve/daemon.py`. One long-lived process
per store, on one `torch.device` (default cuda; cpu only when asked),
resolved before the daemon binds: without a card `serve` exits 255 and
prints no ready line. Reader threads (one per tenant connection) admit
CHECK frames into the `scheduler.Admission` lanes, encoding on the host
(`ingest.encode_run_dir`, `shm.materialize`, `encode_history`); ONE
dispatch thread, `serve-dispatch`, folds pending histories from
different tenants into shared bucket dispatches
(`parallel.folding.plan_fold` -> `FoldDispatcher`) and is the only
thread that launches kernels (its own copy stream and events come from
`check_bucketed_async`, called on it). What keeps a warm daemon warm is
the docstring of `parallel/residency.py`: `_build`'s keyed cache of
loaded kernel libraries and PyTorch's caching allocator.

Durability contract (the reason a daemon crash loses nothing):

  * every verdict is journaled to the tenant's
    `serve-<tenant>.verdicts.jsonl` (FULL result per line,
    `VerdictJournal` discipline) BEFORE the ack frame is sent —
    journal-then-reply, so the journal is always a superset of what
    any tenant saw;
  * a reconnecting tenant re-sends its ids and the daemon replays
    journaled verdicts from the index without re-checking (the
    sweep's journal-resume discipline, per tenant);
  * admitted requests additionally spool one line each to
    `serve-requests.jsonl` (cleared at daemon start) so a post-mortem
    can tell admitted-but-unverdicted work from never-admitted work.

Failure isolation: a fold that fails outright quarantines only its
own histories (`FoldDispatcher`); OOM backdown and the watchdog
degrade inside the fold exactly as in a sweep. The departure from the
reference, whose daemon never dies: a failure that
`supervisor.must_end_sweep` names (a kernel that cannot be built or
launched, a missing device, a CUDA error other than an OOM) is not
quarantined, since every later fold would fail the same way. That fold
is neither journaled nor acked, admission closes, the dispatch thread
stops, and `run_until_drained` (and so `serve`) returns 255; tenants
resend its ids to a restarted daemon. Otherwise the daemon only exits
on drain.

Observability: `/metrics` + `/healthz` (JEPSEN_TPU_METRICS_PORT) with
per-tenant `serve.<tenant>.*` series, a `serve` section in
`<store>/health.json` (sampled every 5 s by default for the daemon;
JEPSEN_TPU_HEALTH_INTERVAL_S overrides), `serve_*` flight-recorder
events, and a `serve_request` span per verdict on the trace fabric's
`serve` track.

Fleet mode (`fleet_instance` set — see `serve.fleet`): the daemon is
one member of a fleet. It binds `fleet-d<k>.sock`,
heartbeats an atomic `fleet-d<k>.json` beacon instead of `serve.pid`,
honors the router's `adopt` frames (reload a reassigned tenant's
journal index from disk), and checks the `fleet-epoch.json` fence
between a fold's compute and its journal writes — a zombie member
resurrected after the router fenced it drops the fold unjournaled
rather than double-serving a reassigned tenant.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from pathlib import Path

from .. import gates, trace
from .. import store as store_mod
from ..obs import events as obs_events
from ..obs import health as obs_health
from ..obs import prom as obs_prom
from . import protocol, scheduler

log = logging.getLogger(__name__)


def _json_safe(v):
    """The value canonicalization `cli._write_results` applies before
    persisting results.json: the daemon journals and acks the same
    bytes, so streamed verdicts are byte-identical to the sweep's."""
    from ..cli import _json_safe as impl
    return impl(v)


class RequestSpool:
    """The admitted-request spool: one flushed JSON line per admission
    (`{"tenant", "id", "checker"}`), cleared at daemon start — crash
    triage, not a replay source (the per-tenant journals own that)."""

    def __init__(self, store_base):
        self.path = store_mod.request_spool_path(store_base)
        self._f = None
        self._lock = threading.Lock()
        try:
            self.path.unlink(missing_ok=True)   # per-sweep retention
        except OSError:
            pass

    def append(self, tenant: str, rid: str, checker: str) -> None:
        line = json.dumps({"tenant": tenant, "id": rid,
                           "checker": checker,
                           "t_wall": round(time.time(), 6)}) + "\n"
        try:
            with self._lock:
                if self._f is None:
                    self._f = open(self.path, "a")
                self._f.write(line)
                self._f.flush()
        except (OSError, ValueError):
            log.debug("request spool append failed", exc_info=True)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None

    @staticmethod
    def load(path) -> list[dict]:
        """Spooled admissions in file order; unparseable lines (the
        crash-torn tail) are skipped, the journal reader's rule."""
        out: list[dict] = []
        p = Path(path)
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
            if isinstance(e, dict) and "id" in e:
                out.append(e)
        return out


class _Conn:
    """One tenant connection; writes are serialized (the reader thread
    replays/backpressures and the dispatch thread acks verdicts on the
    same socket)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.tenant: str | None = None
        self.alive = True
        self._wlock = threading.Lock()

    def send(self, payload: dict) -> bool:
        try:
            with self._wlock:
                protocol.send_frame(self.sock, payload)
            return True
        except (OSError, protocol.ProtocolError):
            self.alive = False
            return False

    def close(self) -> None:
        self.alive = False
        try:
            self.sock.close()
        except OSError:
            pass


class VerdictDaemon:
    """See the module docstring. Lifecycle: `start()` binds and spins
    the threads; `run_until_drained()` blocks until a drain completes
    and tears everything down; `request_drain()` initiates one (the
    SIGTERM handler's body). In-process owners (tests, chip_smoke.py) call
    `start()` / `stop()`."""

    def __init__(self, store, socket_path=None, port: int | None = None,
                 host: str = "127.0.0.1",
                 budget_cells: int | None = None,
                 max_fold: int = scheduler.DEFAULT_MAX_FOLD,
                 weights: dict | None = None,
                 max_queue: int | None = None,
                 drain_s: float | None = None,
                 fleet_instance: int | None = None,
                 fleet_epoch: int | None = None,
                 device=None):
        self.store = store
        #: where the folds run: "cuda" (the default) or "cpu", resolved
        #: by start() before it binds
        self.device = device
        #: the error that ended the dispatch thread (a failure
        #: supervisor.must_end_sweep names), None while healthy
        self.fatal: BaseException | None = None
        self.socket_path = socket_path
        self.port = port
        self.host = host
        self.budget_cells = budget_cells
        self.max_fold = max_fold
        self.drain_s = drain_s
        #: fleet membership: set => this daemon is one member of a
        #: fleet (beacon heartbeats, epoch fence, adopt); None => the
        #: standalone daemon
        self.fleet_instance = fleet_instance
        self.fleet_epoch = fleet_epoch if fleet_epoch is not None else 0
        self._fence_stat: tuple | None = None
        self._fence_data: dict = {}
        self.admission = scheduler.Admission(weights=weights,
                                             max_queue=max_queue)
        self._tenants: dict[str, dict] = {}
        self._jlock = threading.Lock()
        self._conns: list[_Conn] = []
        self._clock = threading.Lock()
        self._draining = threading.Event()
        self._closing = threading.Event()
        self._drain_deadline: float | None = None
        self._listener: socket.socket | None = None
        self._listen_desc: str | None = None
        self._spool: RequestSpool | None = None
        self._sampler = None
        self._metrics = None
        self._dispatcher = None
        self._threads: list[threading.Thread] = []
        self._sched_thread: threading.Thread | None = None
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "VerdictDaemon":
        from .. import shm as _shm
        from ..devices import resolve_device
        from ..parallel import folding
        # the device first: without one nothing binds and no ready line
        # prints (devices.DeviceUnavailable raises to the caller)
        self.device = resolve_device(self.device)
        base = Path(self.store.base)
        base.mkdir(parents=True, exist_ok=True)
        trace.fresh_run(f"serve:{base.name}", scope="sweep")
        tr = trace.get_current()
        tr.counter("shm_stale_reclaimed").inc(_shm.reclaim_stale())
        from .. import obs
        obs.install_events(base)
        if self.budget_cells is None:
            self.budget_cells = folding.DEFAULT_FOLD_CELLS
        # folds spread (dp) over every visible device of the daemon's
        # kind (one card: the single-device path)
        from .. import parallel
        from ..devices import default_devices
        self._dispatcher = folding.FoldDispatcher(
            mesh=parallel.dp_mesh(default_devices(self.device)),
            budget_cells=self.budget_cells)
        # load the store's fitted dispatch plan (JEPSEN_TPU_PLANNER):
        # admission pricing then uses model-predicted cost instead of
        # the T_pad² proxy; gate off (or no plan.json yet) is a no-op
        from .. import planner as planner_mod
        planner_mod.activate(base)
        if self.fleet_instance is None:
            self._spool = RequestSpool(base)
        else:
            # fleet members share ONE store: a member starting must
            # not truncate the spool its peers are appending to. The
            # spool is crash triage, not replay — fleet triage reads
            # the router's reassignment journal instead.
            self._spool = None
        self._bind()
        if self.fleet_instance is None:
            trace.atomic_write_text(
                store_mod.serve_pid_path(base),
                json.dumps({"pid": os.getpid(),
                            "listen": self._listen_desc}))
        # the daemon is a service: health sampling defaults ON (5 s)
        # — an unset gate means "daemon default", an explicit <=0
        # disables, any other value overrides the interval. A FLEET
        # member defaults OFF: N daemons share one store, and the
        # router owns the single health.json writer (its `fleet`
        # section subsumes the per-daemon serve sections).
        interval = obs_health.health_interval_s()
        if interval is None \
                and not gates.is_set("JEPSEN_TPU_HEALTH_INTERVAL_S"):
            interval = 5.0 if self.fleet_instance is None else None
        if interval:
            self._sampler = obs_health.HealthSampler(
                base, interval, extra_fn=self._serve_section).start()
        self._metrics = obs_prom.maybe_start_metrics_server(
            health_fn=(self._sampler.write_snapshot
                       if self._sampler is not None else None))
        obs_events.emit("serve_start", listen=self._listen_desc,
                        store=str(base))
        if self.fleet_instance is not None:
            # first beacon synchronously (the router's spawn wait sees
            # the member the moment the ready line prints), then the
            # heartbeat thread keeps the kernel mtime fresh
            self._write_beacon(trace.get_current())
            bt = threading.Thread(target=self._beacon_loop,
                                  name="fleet-beacon", daemon=True)
            bt.start()
            self._threads.append(bt)
        acc = threading.Thread(target=self._accept_loop,
                               name="serve-accept", daemon=True)
        acc.start()
        self._threads.append(acc)
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="serve-dispatch")
        self._sched_thread.start()
        log.info("verdict daemon serving on %s (store %s)",
                 self._listen_desc, base)
        return self

    def ready_info(self) -> dict:
        """The machine-readable ready line (`run_daemon` prints it)."""
        info = {
            "listen": self._listen_desc,
            "socket": (str(self._resolved_socket())
                       if self.port is None else None),
            "port": self.port,
            "pid": os.getpid(),
            "metrics_port": (self._metrics.port
                             if self._metrics is not None else None),
            "store": str(self.store.base),
            "device": str(self.device)}
        if self.fleet_instance is not None:
            info["fleet_instance"] = self.fleet_instance
            info["fleet_epoch"] = self.fleet_epoch
        return {"serve": info}

    def request_drain(self, reason: str = "stop") -> None:
        """Close admission and let queued work finish (bounded by
        JEPSEN_TPU_SERVE_DRAIN_S). Idempotent; signal-handler-safe."""
        if self._draining.is_set():
            return
        drain_s = self.drain_s
        if drain_s is None:
            drain_s = gates.get("JEPSEN_TPU_SERVE_DRAIN_S")
        self._drain_deadline = time.monotonic() + max(0.0,
                                                      float(drain_s))
        # close admission BEFORE the draining flag becomes observable
        # (JT-ORD-005): the scheduler exits on draining ∧ pending==0,
        # so if the flag were set first a reader mid-encode could
        # still admit a request in the window before close() — one
        # the exiting scheduler would never serve. Closed-first,
        # admit() refuses it and the tenant gets the draining
        # retry-after instead.
        self.admission.close()
        self._draining.set()
        obs_events.emit("serve_drain", reason=reason,
                        pending=self.admission.pending())
        log.info("drain requested (%s): %d pending", reason,
                 self.admission.pending())

    def run_until_drained(self) -> int:
        """Block until the dispatch thread drains, then tear down.
        Returns the process exit code: 0 for a clean drain, 255 when a
        device or kernel failure ended the dispatch thread
        (`self.fatal`)."""
        try:
            while self._sched_thread.is_alive():
                self._sched_thread.join(timeout=0.5)
        except KeyboardInterrupt:
            self.request_drain("keyboard-interrupt")
            self._sched_thread.join()
        self._teardown()
        return 255 if self.fatal is not None else 0

    def stop(self) -> int:
        """In-process owners' one-call exit: drain + wait + teardown."""
        self.request_drain("stop")
        return self.run_until_drained()

    def _teardown(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self._closing.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._clock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        tr = trace.get_current()
        total = int(getattr(tr.counter("serve_verdicts"), "value", 0)
                    or 0)
        obs_events.emit("serve_stop", verdicts=total,
                        drained=self.admission.pending() == 0)
        with self._jlock:
            for ent in self._tenants.values():
                ent["journal"].close()
        if self._spool is not None:
            self._spool.close()
        if self._sampler is not None:
            self._sampler.stop()
        if self._metrics is not None:
            self._metrics.stop()
        from .. import obs
        obs.reset_events()
        base = Path(self.store.base)
        if self.fleet_instance is None:
            markers = (store_mod.serve_pid_path(base),)
        else:
            # a cleanly-exiting member retires its beacon; a SIGKILLed
            # one leaves it to go stale — the router's death evidence
            markers = (store_mod.fleet_member_path(
                base, self.fleet_instance),)
        for p in markers:
            try:
                p.unlink(missing_ok=True)
            except OSError:
                pass
        if self.port is None:
            try:
                self._resolved_socket().unlink(missing_ok=True)
            except OSError:
                pass

    # -- socket plumbing ---------------------------------------------------

    def _resolved_socket(self) -> Path:
        p = self.socket_path or gates.get("JEPSEN_TPU_SERVE_SOCKET")
        if p:
            return Path(p)
        if self.fleet_instance is not None:
            return store_mod.fleet_daemon_socket_path(
                self.store.base, self.fleet_instance)
        return store_mod.serve_socket_path(self.store.base)

    def _bind(self) -> None:
        if self.port is None:
            gate_port = gates.get("JEPSEN_TPU_SERVE_PORT")
            if gate_port is not None:
                self.port = gate_port
        if self.port is not None:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((self.host, self.port))
            s.listen(64)
            self.port = s.getsockname()[1]
            self._listen_desc = f"tcp://{self.host}:{self.port}"
        else:
            path = self._resolved_socket()
            if path.exists():
                # a live daemon answers a connect; a stale socket (the
                # previous daemon SIGKILLed) refuses — reclaim it
                probe = socket.socket(socket.AF_UNIX,
                                      socket.SOCK_STREAM)
                try:
                    probe.settimeout(1.0)
                    probe.connect(str(path))
                    probe.close()
                    raise RuntimeError(
                        f"a verdict daemon is already serving {path}")
                except (ConnectionRefusedError, socket.timeout,
                        FileNotFoundError, OSError):
                    try:
                        path.unlink(missing_ok=True)
                    except OSError:
                        pass
                finally:
                    try:
                        probe.close()
                    except OSError:
                        pass
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.bind(str(path))
            s.listen(64)
            self._listen_desc = f"unix://{path}"
        self._listener = s

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return   # listener closed: shutting down
            conn = _Conn(sock)
            with self._clock:
                self._conns.append(conn)
            t = threading.Thread(target=self._reader, args=(conn,),
                                 name="serve-reader", daemon=True)
            t.start()

    # -- per-connection reader ---------------------------------------------

    def _reader(self, conn: _Conn) -> None:
        try:
            while not self._closing.is_set():
                try:
                    frame = protocol.recv_frame(conn.sock)
                except protocol.ProtocolError as e:
                    conn.send({"op": "error", "error": str(e)[:300]})
                    return
                except OSError:
                    return
                if frame is None:
                    return
                op = frame.get("op")
                if op == "hello":
                    self._on_hello(conn, frame)
                elif op == "check":
                    self._on_check(conn, frame)
                elif op == "adopt":
                    self._on_adopt(conn, frame)
                elif op == "bye":
                    return
                else:
                    conn.send({"op": "error",
                               "error": f"unknown op {op!r}"})
        finally:
            conn.close()
            with self._clock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _tenant_state(self, tenant: str) -> dict:
        """The tenant's journal + replay index, created (and the
        journal's prior entries loaded — the resume evidence) on first
        contact after a (re)start."""
        with self._jlock:
            ent = self._tenants.get(tenant)
            if ent is None:
                p = store_mod.tenant_journal_path(self.store.base,
                                                  tenant)
                ent = {"journal": store_mod.VerdictJournal(p),
                       "index": store_mod.VerdictJournal.load(p),
                       "verdicts": 0}
                self._tenants[tenant] = ent
            return ent

    def _on_adopt(self, conn: _Conn, frame: dict) -> None:
        """Fleet failover: the router hands this daemon a dead peer's
        tenant. Reload the tenant's journal index FROM DISK — the dead
        peer appended verdicts after this daemon (maybe) first loaded
        it, and those must replay byte-identically, not re-check.
        In-order frame processing on this stream is the ordering
        guarantee: the router pipelines the resent checks right behind
        this frame, so no reply is needed."""
        tenant = str(frame.get("tenant") or "")
        if not tenant:
            conn.send({"op": "error", "error": "adopt names no tenant"})
            return
        p = store_mod.tenant_journal_path(self.store.base, tenant)
        idx = store_mod.VerdictJournal.load(p)
        with self._jlock:
            ent = self._tenants.get(tenant)
            if ent is None:
                self._tenants[tenant] = {
                    "journal": store_mod.VerdictJournal(p),
                    "index": idx, "verdicts": 0}
            else:
                # keep verdicts this daemon journaled itself that the
                # on-disk read may have raced past
                merged = dict(idx)
                merged.update(ent["index"])
                ent["index"] = merged

    def _on_hello(self, conn: _Conn, frame: dict) -> None:
        tenant = str(frame.get("tenant") or "") or "default"
        weight = self.admission.register(tenant, frame.get("weight"))
        conn.tenant = tenant
        ent = self._tenant_state(tenant)
        with self._jlock:
            journaled = len(ent["index"])
        tr = trace.get_current()
        tr.gauge("serve_tenants").set(len(self._tenants))
        obs_events.emit("serve_tenant_connect", tenant=tenant,
                        weight=weight, journaled=journaled)
        conn.send({"op": "welcome", "tenant": tenant,
                   "weight": weight, "journaled": journaled,
                   "max_queue": self.admission.max_queue})

    def _on_check(self, conn: _Conn, frame: dict) -> None:
        tr = trace.get_current()
        rid = str(frame.get("id") or "")
        if conn.tenant is None:
            conn.send({"op": "error", "id": rid,
                       "error": "hello must precede check"})
            return
        checker = str(frame.get("checker") or "append")
        if not rid or checker not in ("append", "wr"):
            conn.send({"op": "error", "id": rid,
                       "error": f"bad check frame (id={rid!r}, "
                                f"checker={checker!r})"})
            return
        tr.counter("serve_requests").inc()
        ent = self._tenant_state(conn.tenant)
        with self._jlock:
            prior = ent["index"].get((rid, checker))
        if prior is not None:
            # at-least-once delivery, idempotent checks: the journaled
            # verdict replays with zero device work
            res = prior.get("result")
            if res is None:
                res = {k: prior[k] for k in
                       ("valid?", "quarantined", "error")
                       if k in prior}
                res["checker"] = checker
            tr.counter("serve_replays").inc()
            conn.send({"op": "verdict", "id": rid, "checker": checker,
                       "result": res, "replay": True})
            return
        if self._draining.is_set():
            conn.send({"op": "retry-after", "id": rid,
                       "delay_s": self.admission.retry_after_s(),
                       "queue_depth": self.admission.depth(conn.tenant),
                       "draining": True})
            return
        # advisory load-shed BEFORE the encode: a tenant at its cap
        # must not make the daemon pay a full parse/encode per refused
        # retry (admit() below stays the atomic check)
        if self.admission.depth(conn.tenant) \
                >= self.admission.max_queue:
            self._send_backpressure(conn, rid, tr)
            return
        from .. import planner as planner_mod
        from ..parallel import folding
        enc = self._resolve_payload(frame, checker)
        n_txns = int(getattr(enc, "n", 1) or 1)
        pl = planner_mod.get()
        # admission price: the planner's model-predicted device
        # seconds normalized to fold_cost's cell unit when
        # JEPSEN_TPU_PLANNER is on (and fold_cost bit-exact on its
        # cold-start fallback); any positive cost preserves
        # plan_fold's weighted-DRR fairness semantics
        cost = (pl.admission_cost(n_txns, checker) if pl is not None
                else folding.fold_cost(n_txns))
        req = scheduler.Request(conn.tenant, rid, checker, enc, cost,
                                conn)
        if not self.admission.admit(req):
            if self._draining.is_set():
                # lost the race with a drain: admission closed while
                # this request was encoding — the draining frame, not
                # a backpressure count
                conn.send({"op": "retry-after", "id": rid,
                           "delay_s": self.admission.retry_after_s(),
                           "queue_depth":
                               self.admission.depth(conn.tenant),
                           "draining": True})
                return
            self._send_backpressure(conn, rid, tr)
            return
        if self._spool is not None:
            self._spool.append(conn.tenant, rid, checker)
        slug = store_mod.safe_tenant(conn.tenant)
        tr.gauge(f"serve.{slug}.queue_depth").set(
            self.admission.depth(conn.tenant))
        tr.gauge("serve_pending").set(self.admission.pending())

    def _send_backpressure(self, conn: _Conn, rid: str, tr) -> None:
        """The explicit refusal: counter + event + a retry-after frame
        with a backlog-derived delay hint — never a silent drop."""
        tr.counter("serve_backpressure").inc()
        depth = self.admission.depth(conn.tenant)
        obs_events.emit("serve_backpressure", tenant=conn.tenant,
                        depth=depth)
        conn.send({"op": "retry-after", "id": rid,
                   "delay_s": self.admission.retry_after_s(),
                   "queue_depth": depth})

    def _resolve_payload(self, frame: dict, checker: str):
        """CHECK frame -> encoding (or the Exception, which the fold
        quarantines at the `encode` stage — a tenant's bad history
        costs the tenant an `unknown` verdict, never the daemon)."""
        try:
            if frame.get("dir"):
                from .. import ingest
                with trace.span("serve_encode", kind="dir"):
                    return ingest.encode_run_dir(frame["dir"], checker)
            if frame.get("shm"):
                from .. import shm
                with trace.span("serve_encode", kind="shm"):
                    return shm.materialize(frame["shm"])
            if frame.get("history") is not None:
                with trace.span("serve_encode", kind="inline"):
                    if checker == "append":
                        from ..checker.elle.encode import (
                            encode_history, lean_anomalies)
                        enc = encode_history(frame["history"])
                        enc.anomalies = lean_anomalies(enc)
                    else:
                        from ..checker.elle.wr import (
                            encode_wr_history, lean_wr_anomalies)
                        enc = encode_wr_history(frame["history"])
                        enc.anomalies = lean_wr_anomalies(enc)
                enc.txn_ops = []
                return enc
            return ValueError(
                "check frame names no history (dir/shm/history)")
        except Exception as e:
            return e

    # -- the dispatch loop -------------------------------------------------

    def _scheduler_loop(self) -> None:
        tr = trace.get_current()
        while True:
            if self._draining.is_set():
                if self.admission.pending() == 0:
                    return
                if self._drain_deadline is not None \
                        and time.monotonic() > self._drain_deadline:
                    dropped = self.admission.pending()
                    log.warning("drain deadline passed with %d "
                                "unverdicted (tenants will resend)",
                                dropped)
                    return
            if not self.admission.wait_pending(0.2):
                continue
            checker, picked = self.admission.next_fold(
                self.budget_cells, self.max_fold)
            if not picked:
                continue
            try:
                self._run_fold(checker, picked, tr)
            except Exception as e:
                from .. import supervisor as sv
                if sv.must_end_sweep(e):
                    # no quarantine hides a device or kernel failure:
                    # this fold stays unjournaled and unacked, the
                    # daemon drains and exits 255 (module docstring)
                    self.fatal = e
                    log.error("fold of %d history(ies) hit a failure "
                              "no quarantine may hide (%r); stopping",
                              len(picked), e)
                    self.request_drain("fatal")
                    return
                # _run_fold already quarantines per fold; anything
                # escaping here is a bug, but the daemon must not die
                log.exception("fold processing failed")

    def _run_fold(self, checker: str, picked: list, tr) -> None:
        from ..obs import search as obs_search
        by_tenant: dict[str, int] = {}
        for r in picked:
            by_tenant[r.tenant] = by_tenant.get(r.tenant, 0) + 1
        obs_events.emit("serve_admit", checker=checker,
                        histories=len(picked), tenants=by_tenant)
        # kernel search telemetry (JEPSEN_TPU_KERNEL_STATS): stats ride
        # the reply frame BESIDE "result" — the journaled/acked verdict
        # bytes stay identical with the gate on or off — and feed the
        # kernel.* metrics only (the daemon is long-lived; the
        # per-sweep ledger is analyze-store's)
        souts: list | None = [] if obs_search.enabled() else None
        with tr.span("serve_fold", checker=checker,
                     histories=len(picked),
                     tenants=len(by_tenant)):
            # the stats kwarg is passed only when requested, so
            # stats-free dispatcher doubles (test seams) keep working
            if souts is not None:
                results = self._dispatcher.verdicts(
                    [r.enc for r in picked], checker,
                    stats_out=souts)
            else:
                results = self._dispatcher.verdicts(
                    [r.enc for r in picked], checker)
        tr.counter("serve_folds").inc()
        tr.histogram("serve_fold_histories").observe(len(picked))
        if self._fenced():
            # the zombie fence: this member was declared dead and its
            # tenants reassigned while the fold ran (SIGSTOP-resume,
            # partition heal). Journaling now would DUPLICATE lines the
            # successor is already writing for the same ids — drop the
            # whole fold unjournaled and unacked (the router already
            # replayed/re-checked these on the successor) and drain.
            tr.counter("fleet_fences").inc()
            obs_events.emit("fleet_fence", instance=self.fleet_instance,
                            epoch=self._fence_data.get("epoch"),
                            histories=len(picked))
            log.warning("fenced at epoch %s: dropping a %d-history "
                        "fold unjournaled and draining",
                        self._fence_data.get("epoch"), len(picked))
            self.request_drain("fenced")
            return
        for k, (r, res) in enumerate(zip(picked, results)):
            stats = souts[k] if souts is not None \
                and k < len(souts) else None
            if stats is not None:
                obs_search.note_metrics(stats, tr)
            res = _json_safe(res)
            ent = self._tenant_state(r.tenant)
            with self._jlock:
                # journal-then-reply: the ack below can only name a
                # verdict the journal already holds — unless the
                # append itself failed (read-only/full store), which
                # is surfaced on the frame: that verdict will be
                # RE-CHECKED after a restart, not replayed
                journaled = ent["journal"].record(r.rid, checker, res,
                                                  full=True)
                ent["index"][(r.rid, checker)] = {
                    "dir": r.rid, "checker": checker,
                    "valid?": res.get("valid?"), "result": res}
                ent["verdicts"] += 1
            if not journaled:
                log.warning("journal append failed for tenant %s id "
                            "%s — ack sent unjournaled (will "
                            "re-check after a restart)",
                            r.tenant, r.rid)
            # metrics before the ack: the moment a tenant sees its
            # verdict, the counters already account for it (a scrape
            # can lag an ack, never undercount a completed set)
            now = time.perf_counter()
            tr.histogram("serve_latency_ms").observe(
                (now - r.t0) * 1000.0)
            tr.counter("serve_verdicts").inc()
            slug = store_mod.safe_tenant(r.tenant)
            tr.counter(f"serve.{slug}.verdicts").inc()
            tr.add_span("serve_request", r.t0, now, track="serve",
                        tenant=r.tenant, id=r.rid, checker=checker)
            if r.conn is not None and r.conn.alive:
                frame = {"op": "verdict", "id": r.rid,
                         "checker": checker, "result": res}
                if stats is not None:
                    frame["stats"] = stats
                if not journaled:
                    frame["journaled"] = False
                r.conn.send(frame)
        for t in by_tenant:
            slug = store_mod.safe_tenant(t)
            tr.gauge(f"serve.{slug}.queue_depth").set(
                self.admission.depth(t))
        tr.gauge("serve_pending").set(self.admission.pending())

    # -- fleet membership --------------------------------------------------

    def _fenced(self) -> bool:
        """Is this member marked dead in the epoch marker? Checked
        between a fold's compute and its journal writes — the last
        possible moment a resurrected zombie can be stopped before it
        double-serves a reassigned tenant. The marker re-parses only
        on an mtime/size change (one stat per fold otherwise)."""
        if self.fleet_instance is None:
            return False
        p = store_mod.fleet_epoch_path(self.store.base)
        try:
            st = p.stat()
        except OSError:
            return False
        key = (st.st_mtime_ns, st.st_size)
        if key != self._fence_stat:
            try:
                data = json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                # a marker mid-replace reads clean or not at all
                # (atomic_write_text), but stay conservative
                return False
            self._fence_stat = key
            self._fence_data = data if isinstance(data, dict) else {}
        # alien shapes (members as a list, an entry as a bare string —
        # e.g. a hand-edited or version-skewed marker) must degrade to
        # "not fenced", never crash the fold loop mid-verdict
        m = self._fence_data.get("members")
        ent = m.get(str(self.fleet_instance)) if isinstance(m, dict) \
            else None
        return bool(isinstance(ent, dict)
                    and ent.get("status") == "dead")

    def _write_beacon(self, tr, seq: int = 0) -> None:
        """One atomic beacon rewrite. The router reads LIVENESS off
        the file's kernel-set mtime (a faketime-skewed member cannot
        lie about its own freshness) and LOAD off the payload."""
        try:
            hbm = int(getattr(tr.gauge("hbm_modeled_bytes"), "value",
                              0) or 0)
        except Exception:
            hbm = 0
        beacon = {"instance": self.fleet_instance,
                  "pid": os.getpid(),
                  "epoch": self.fleet_epoch,
                  "listen": self._listen_desc,
                  "seq": seq,
                  "queue_depth": self.admission.pending(),
                  "hbm_modeled_bytes": hbm,
                  "draining": self._draining.is_set(),
                  "t_wall": round(time.time(), 6)}
        try:
            trace.atomic_write_text(
                store_mod.fleet_member_path(self.store.base,
                                            self.fleet_instance),
                json.dumps(beacon))
        except OSError:
            log.debug("beacon write failed", exc_info=True)

    def _beacon_loop(self) -> None:
        tr = trace.get_current()
        seq = 1
        while not self._closing.is_set():
            interval = gates.get("JEPSEN_TPU_FLEET_HEARTBEAT_S")
            self._closing.wait(max(0.05, float(interval or 1.0)))
            if self._closing.is_set():
                return
            self._write_beacon(tr, seq)
            seq += 1

    # -- observability -----------------------------------------------------

    def _serve_section(self) -> dict:
        """The health.json `serve` section (rides the sampler's
        extra_fn seam)."""
        with self._jlock:
            verdicts = {t: ent["verdicts"]
                        for t, ent in self._tenants.items()}
        tenants = {}
        for t, d in self.admission.tenants_snapshot().items():
            tenants[t] = {**d, "verdicts": verdicts.get(t, 0)}
        for t, n in verdicts.items():
            tenants.setdefault(t, {"queued": 0, "weight": 1.0,
                                   "verdicts": n})
        return {"serve": {
            "listen": self._listen_desc,
            "pid": os.getpid(),
            "draining": self._draining.is_set(),
            "pending": self.admission.pending(),
            "tenants": tenants,
        }}


def run_daemon(store, socket_path=None, port: int | None = None,
               host: str = "127.0.0.1",
               drain_s: float | None = None,
               fleet_instance: int | None = None,
               fleet_epoch: int | None = None, device=None) -> int:
    """The CLI body: start the daemon on `device` (default cuda), print
    the machine-readable ready line, drain on SIGTERM/SIGINT; exit 0
    on a clean drain, 255 without the device (before any ready line)
    or after a fold's device or kernel failure."""
    import signal
    import sys

    from ..devices import DeviceUnavailable

    d = VerdictDaemon(store, socket_path=socket_path, port=port,
                      host=host, drain_s=drain_s,
                      fleet_instance=fleet_instance,
                      fleet_epoch=fleet_epoch, device=device)
    try:
        d.start()
    except DeviceUnavailable as e:
        print(f"serve: {e}", file=sys.stderr)
        return 255

    def _on_signal(signum, _frame):
        d.request_drain(f"signal {signum}")

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass   # not the main thread / unsupported platform
    print(json.dumps(d.ready_info()), flush=True)
    try:
        return d.run_until_drained()
    except Exception:
        log.exception("verdict daemon crashed")
        try:
            d._teardown()
        except Exception:
            pass
        print("verdict daemon crashed", file=sys.stderr)
        return 255
