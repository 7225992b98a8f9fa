"""The serve fleet: N verdict daemons behind a fault-tolerant router.

Counterpart of `jepsen_tpu/serve/fleet.py`. `python -m
jepsen_tpu_torch.cli fleet --device cuda|cpu` spawns (or attaches) N
`serve` daemons of this package, each on the router's device (one card
holds them all: each member is its own process with its own CUDA
context) — each a normal `VerdictDaemon` in fleet mode: own socket
`fleet-d<k>.sock`, atomic beacon `fleet-d<k>.json` every
JEPSEN_TPU_FLEET_HEARTBEAT_S, the epoch fence — behind a thin router
that tenants connect to at `<store>/fleet.sock` speaking the unchanged
JTSV frame protocol.

Routing: a tenant hash-affines to `live[shard_of(tenant, len(live))]`
(`store.shard_of`, a deterministic xxh64 partition equal to the
reference's), so a tenant's checks land on one daemon and its replay
index stays hot. When the affine daemon's load (beacon queue depth +
router-tracked in-flight, tie-broken on the beacon's
`hbm_modeled_bytes`) crosses
JEPSEN_TPU_FLEET_SPILL_DEPTH, NEW checks spill to the least-loaded
live daemon instead of queueing deeper — measured load, not guesses.
Resends of an id the router already holds in flight stay sticky to
their daemon while it lives, so one id is queued on at most one
member at a time.

Death and failover: a member is declared dead on process exit,
connection failure, or beacon staleness past
JEPSEN_TPU_FLEET_FAILOVER_S — staleness is the KERNEL's file mtime,
never the daemon's self-reported wall clock, so a faketime-skewed
member is not falsely buried. Failover order is the fencing order:

  1. mark the member dead and bump the epoch in `fleet-epoch.json`
     (atomic replace) — the fence a resurrected zombie checks between
     a fold's compute and its journal writes;
  2. best-effort STONITH (SIGKILL the member's pid; `--no-stonith`
     for nemesis harnesses that own the process);
  3. for each tenant with in-flight work on the dead member: send
     `adopt {tenant}` to its successor (the daemon reloads the
     tenant's `serve-<t>.verdicts.jsonl` index FROM DISK), then
     pipeline the in-flight checks right behind it — journaled
     verdicts replay byte-identically, unjournaled ones re-check;
     one `fleet-reassign.jsonl` line records each move.

The invariant all of this serves: a tenant observes at most a bounded
retry-after across a daemon death — never a lost verdict (the journal
is always a superset of the acked set) and never a duplicated one
(the router forwards a verdict only while its id is in flight on that
member, and the epoch fence stops a zombie from journaling a
reassigned tenant's fold).

Caveat: `shm` submissions are single-daemon-lifetime (the daemon
unlinks the segment on map), so a fleet tenant that must survive
failover submits by `dir` or `history` — the warm zero-copy path for
dirs is the sidecar, which every member shares through the store.

Observability: the router owns the store's single health.json writer
(`fleet` section: epoch, per-member status/beacon age/load, tenant
assignments), serves `/metrics` (JEPSEN_TPU_METRICS_PORT) with
`fleet_*` counters/gauges and per-member `fleet.d<k>.*` gauges, and
emits `fleet_*` flight-recorder events; member daemons run with
health sampling and the metrics port off.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from .. import gates, trace
from .. import store as store_mod
from ..obs import events as obs_events
from ..obs import health as obs_health
from ..obs import prom as obs_prom
from . import protocol

log = logging.getLogger(__name__)


def load_reassignments(store_base) -> list[dict]:
    """The `fleet-reassign.jsonl` reader: one dict per failover move,
    torn-tail tolerant like every journal reader (a router killed
    mid-append leaves a partial last line, skipped here and sealed by
    the next append)."""
    p = store_mod.fleet_reassign_path(store_base)
    out: list[dict] = []
    try:
        lines = p.read_text().splitlines()
    except OSError:
        return out
    for ln in lines:
        if not ln.strip():
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def heartbeat_s() -> float:
    v = gates.get("JEPSEN_TPU_FLEET_HEARTBEAT_S")
    return max(0.05, float(v)) if v is not None else 1.0


def failover_s() -> float:
    v = gates.get("JEPSEN_TPU_FLEET_FAILOVER_S")
    return max(0.1, float(v)) if v is not None else 5.0


def spill_depth() -> int:
    v = gates.get("JEPSEN_TPU_FLEET_SPILL_DEPTH")
    return max(1, int(v)) if v is not None else 32


class _Member:
    """One fleet daemon as the router sees it: spawned subprocess or
    attached (tests drive in-process daemons), beacon-backed."""

    def __init__(self, instance: int, socket_path, beacon_path,
                 proc=None, pid: int | None = None):
        self.instance = int(instance)
        self.socket_path = Path(socket_path)
        self.beacon_path = Path(beacon_path)
        self.proc = proc
        self.pid = pid
        self.status = "starting"      # starting -> live -> dead
        self.beacon: dict = {}
        self.beacon_age: float | None = None

    def current_pid(self) -> int | None:
        if self.proc is not None:
            return self.proc.pid
        if self.pid is not None:
            return self.pid
        p = self.beacon.get("pid")
        return int(p) if p else None


class _Upstream:
    """One router->daemon connection, per (tenant connection, member):
    the hello/welcome exchange happens synchronously at creation, then
    a pump thread forwards daemon->tenant frames."""

    def __init__(self, instance: int, sock: socket.socket,
                 welcome: dict):
        self.instance = instance
        self.sock = sock
        self.welcome = welcome
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


class _TenantConn:
    """One tenant connection to the router. `inflight` maps
    (id, checker) -> {"frame", "member", "failover"?} — the router's
    resend evidence; an entry lives from the check forward to the
    verdict forward, and failover re-targets it to the successor."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.tenant: str | None = None
        self.hello: dict | None = None
        self.alive = True
        self.lock = threading.Lock()
        self.upstreams: dict[int, _Upstream] = {}
        self.inflight: dict[tuple[str, str], dict] = {}
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
        with self.lock:
            ups = list(self.upstreams.values())
            self.upstreams.clear()
        for up in ups:
            up.close()


class FleetRouter:
    """See the module docstring. Lifecycle mirrors `VerdictDaemon`:
    `start()` spawns/attaches members and binds; `stop()` tears down.
    `spawn=False` + `attach_member(...)` lets tests drive in-process
    daemons (each still beaconing into the shared store)."""

    def __init__(self, store, daemons: int = 3, socket_path=None,
                 stonith: bool = True, spawn: bool = True,
                 member_env: dict[int, dict] | None = None,
                 start_timeout_s: float = 60.0, device: str = "cuda"):
        self.store = store
        #: the device every spawned member serves on (`--device`)
        self.device = str(device)
        self.daemons = int(daemons)
        self.socket_path = socket_path
        self.stonith = stonith
        self.spawn = spawn
        #: per-instance env additions for spawned members
        self.member_env = dict(member_env or {})
        self.start_timeout_s = start_timeout_s
        self._members: dict[int, _Member] = {}
        self._mlock = threading.Lock()
        self._epoch = 0
        self._conns: list[_TenantConn] = []
        self._cl = threading.Lock()
        self._suspects: set[int] = set()
        self._slock = threading.Lock()
        self._closing = threading.Event()
        self._listener: socket.socket | None = None
        self._sampler = None
        self._metrics = None
        self._threads: list[threading.Thread] = []
        self._verdicts = 0
        self._stopped = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetRouter":
        base = Path(self.store.base)
        base.mkdir(parents=True, exist_ok=True)
        trace.fresh_run(f"fleet:{base.name}", scope="sweep")
        from .. import obs
        obs.install_events(base)
        try:
            # per-sweep retention: this router's failover evidence
            # starts clean, like the daemon's request spool
            store_mod.fleet_reassign_path(base).unlink(missing_ok=True)
        except OSError:
            pass
        self._epoch = 1
        if self.spawn:
            for k in range(self.daemons):
                self._spawn_member(k)
        deadline = time.monotonic() + self.start_timeout_s
        for m in list(self._members.values()):
            if not self._wait_member_live(m, deadline):
                self.stop()
                raise RuntimeError(
                    f"fleet member d{m.instance} never beaconed "
                    f"(socket {m.socket_path})")
        self._write_epoch()
        self._bind()
        tr = trace.get_current()
        tr.gauge("fleet_daemons_live").set(len(self._live_members()))
        tr.gauge("fleet_epoch").set(self._epoch)
        # the router owns the store's ONE health.json writer; same
        # service default as the daemon (5 s unless the gate says)
        interval = obs_health.health_interval_s()
        if interval is None \
                and not gates.is_set("JEPSEN_TPU_HEALTH_INTERVAL_S"):
            interval = 5.0
        if interval:
            self._sampler = obs_health.HealthSampler(
                base, interval, extra_fn=self._fleet_section).start()
        self._metrics = obs_prom.maybe_start_metrics_server(
            health_fn=(self._sampler.write_snapshot
                       if self._sampler is not None else None))
        obs_events.emit("fleet_start", daemons=len(self._members),
                        socket=str(self._resolved_socket()),
                        epoch=self._epoch)
        acc = threading.Thread(target=self._accept_loop,
                               name="fleet-accept", daemon=True)
        acc.start()
        self._threads.append(acc)
        mon = threading.Thread(target=self._monitor_loop,
                               name="fleet-monitor", daemon=True)
        mon.start()
        self._threads.append(mon)
        log.info("fleet router serving %d daemon(s) on %s",
                 len(self._members), self._resolved_socket())
        return self

    def ready_info(self) -> dict:
        with self._mlock:
            members = {str(m.instance): {"socket": str(m.socket_path),
                                         "pid": m.current_pid(),
                                         "status": m.status}
                       for m in self._members.values()}
        return {"fleet": {
            "socket": str(self._resolved_socket()),
            "pid": os.getpid(),
            "epoch": self._epoch,
            "daemons": len(members),
            "members": members,
            "metrics_port": (self._metrics.port
                             if self._metrics is not None else None),
            "store": str(self.store.base)}}

    def stop(self) -> int:
        if self._stopped:
            return 0
        self._stopped = True
        self._closing.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._cl:
            conns = list(self._conns)
        for c in conns:
            c.close()
        obs_events.emit("fleet_stop", verdicts=self._verdicts,
                        daemons=len(self._live_members()))
        with self._mlock:
            members = list(self._members.values())
        for m in members:
            if m.proc is not None and m.proc.poll() is None:
                try:
                    m.proc.terminate()
                except OSError:
                    pass
        for m in members:
            if m.proc is not None:
                try:
                    m.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    try:
                        m.proc.kill()
                        m.proc.wait(timeout=5.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
        if self._sampler is not None:
            self._sampler.stop()
        if self._metrics is not None:
            self._metrics.stop()
        from .. import obs
        obs.reset_events()
        try:
            self._resolved_socket().unlink(missing_ok=True)
        except OSError:
            pass
        return 0

    # -- members -----------------------------------------------------------

    def attach_member(self, instance: int, socket_path,
                      pid: int | None = None) -> None:
        """Register an externally-managed member (in-process daemon or
        a subprocess the caller owns); call before `start()`. Pair
        with `stonith=False` when members share the caller's process:
        an in-process member's beacon carries the caller's pid, and a
        STONITH on conviction would SIGKILL the caller itself."""
        base = Path(self.store.base)
        with self._mlock:
            self._members[int(instance)] = _Member(
                instance, socket_path,
                store_mod.fleet_member_path(base, instance), pid=pid)

    def _spawn_member(self, k: int) -> None:
        base = Path(self.store.base)
        sock = store_mod.fleet_daemon_socket_path(base, k)
        env = dict(os.environ)
        # members must not fight the router (or each other) for the
        # metrics port, the store's health.json, or a serve socket
        # override meant for a standalone daemon
        for var in ("JEPSEN_TPU_METRICS_PORT",
                    "JEPSEN_TPU_HEALTH_INTERVAL_S",
                    "JEPSEN_TPU_SERVE_SOCKET",
                    "JEPSEN_TPU_SERVE_PORT"):
            env.pop(var, None)
        env.update({str(a): str(b) for a, b
                    in self.member_env.get(k, {}).items()})
        # on one card every member is its own process with its own
        # CUDA context, and each loads the kernel libraries through
        # `_build` at its first fold; `_build.build` renames a finished
        # library into place, so members that build at once are safe
        cmd = [sys.executable, "-m", "jepsen_tpu_torch.cli", "serve",
               "--store", str(base), "--socket", str(sock),
               "--fleet-instance", str(k),
               "--fleet-epoch", str(self._epoch),
               "--device", self.device]
        proc = subprocess.Popen(cmd, env=env,
                                stdout=subprocess.DEVNULL)
        with self._mlock:
            self._members[k] = _Member(
                k, sock, store_mod.fleet_member_path(base, k),
                proc=proc)

    def _wait_member_live(self, m: _Member, deadline: float) -> bool:
        while time.monotonic() < deadline:
            if m.proc is not None and m.proc.poll() is not None:
                return False
            if m.beacon_path.is_file() and m.socket_path.exists():
                try:
                    m.beacon = json.loads(m.beacon_path.read_text())
                except (OSError, json.JSONDecodeError):
                    time.sleep(0.05)
                    continue
                m.status = "live"
                obs_events.emit("fleet_daemon_up", instance=m.instance,
                                pid=m.current_pid())
                return True
            time.sleep(0.05)
        return False

    def _member(self, instance: int) -> _Member | None:
        with self._mlock:
            return self._members.get(instance)

    def _live_members(self) -> list[_Member]:
        with self._mlock:
            return sorted((m for m in self._members.values()
                           if m.status == "live"),
                          key=lambda m: m.instance)

    def _affine(self, tenant: str, live: list[_Member]) -> _Member:
        return live[store_mod.shard_of(tenant, len(live))]

    def _load(self, m: _Member) -> int:
        q = int(m.beacon.get("queue_depth") or 0)
        with self._cl:
            conns = list(self._conns)
        infl = 0
        for c in conns:
            with c.lock:
                infl += sum(1 for e in c.inflight.values()
                            if e["member"] == m.instance)
        return q + infl

    def _load_key(self, m: _Member) -> tuple:
        return (self._load(m),
                int(m.beacon.get("hbm_modeled_bytes") or 0),
                m.instance)

    # -- socket plumbing ---------------------------------------------------

    def _resolved_socket(self) -> Path:
        if self.socket_path:
            return Path(self.socket_path)
        return store_mod.fleet_socket_path(self.store.base)

    def _bind(self) -> None:
        path = self._resolved_socket()
        if path.exists():
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(1.0)
                probe.connect(str(path))
                raise RuntimeError(
                    f"a fleet router is already serving {path}")
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
        s.listen(128)
        self._listener = s

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            conn = _TenantConn(sock)
            with self._cl:
                self._conns.append(conn)
            t = threading.Thread(target=self._reader, args=(conn,),
                                 name="fleet-reader", daemon=True)
            t.start()

    # -- tenant side -------------------------------------------------------

    def _reader(self, conn: _TenantConn) -> None:
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
                    self._route_check(conn, frame)
                elif op == "bye":
                    return
                else:
                    conn.send({"op": "error",
                               "error": f"unknown op {op!r}"})
        finally:
            conn.close()
            with self._cl:
                if conn in self._conns:
                    self._conns.remove(conn)

    def _on_hello(self, conn: _TenantConn, frame: dict) -> None:
        conn.tenant = str(frame.get("tenant") or "") or "default"
        conn.hello = dict(frame)
        live = self._live_members()
        if not live:
            conn.send({"op": "error",
                       "error": "no live fleet members"})
            return
        up = self._upstream(conn, self._affine(conn.tenant, live))
        if up is None:
            conn.send({"op": "error",
                       "error": "fleet member unreachable; reconnect"})
            return
        conn.send(up.welcome)

    def _upstream(self, conn: _TenantConn,
                  m: _Member) -> _Upstream | None:
        with conn.lock:
            up = conn.upstreams.get(m.instance)
        if up is not None and up.alive:
            return up
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(10.0)
            s.connect(str(m.socket_path))
            hello = dict(conn.hello or {})
            hello.update({"op": "hello", "tenant": conn.tenant})
            protocol.send_frame(s, hello)
            w = protocol.recv_frame(s)
            if not w or w.get("op") != "welcome":
                raise protocol.ProtocolError(
                    f"expected welcome from d{m.instance}, got {w!r}")
            s.settimeout(None)
        except (OSError, protocol.ProtocolError):
            try:
                s.close()
            except OSError:
                pass
            self._suspect(m.instance)
            return None
        up = _Upstream(m.instance, s, w)
        with conn.lock:
            conn.upstreams[m.instance] = up
        t = threading.Thread(target=self._pump, args=(conn, up),
                             name=f"fleet-pump-d{m.instance}",
                             daemon=True)
        t.start()
        return up

    def _route_check(self, conn: _TenantConn, frame: dict) -> None:
        if conn.tenant is None:
            conn.send({"op": "error", "id": frame.get("id"),
                       "error": "hello must precede check"})
            return
        rid = str(frame.get("id") or "")
        checker = str(frame.get("checker") or "append")
        key = (rid, checker)
        live = self._live_members()
        if not live:
            # every member is down mid-failover: an explicit bounded
            # wait, never a silent drop — the client's RETRY_S budget
            # turns a permanent outage into ServeUnavailable
            conn.send({"op": "retry-after", "id": rid,
                       "delay_s": failover_s() / 2,
                       "queue_depth": 0, "draining": True})
            return
        target = None
        with conn.lock:
            ent = conn.inflight.get(key)
        if ent is not None:
            # sticky resend: one id queues on at most one member
            m = self._member(ent["member"])
            if m is not None and m.status == "live":
                target = m
        if target is None:
            target = affine = self._affine(conn.tenant, live)
            if len(live) > 1:
                depth = self._load(affine)
                if depth >= spill_depth():
                    best = min(live, key=self._load_key)
                    if best.instance != affine.instance:
                        target = best
                        trace.get_current().counter(
                            "fleet_spills").inc()
                        obs_events.emit("fleet_spill",
                                        tenant=conn.tenant,
                                        affine=affine.instance,
                                        chosen=best.instance,
                                        depth=depth)
        with conn.lock:
            conn.inflight[key] = {"frame": dict(frame),
                                  "member": target.instance}
        up = self._upstream(conn, target)
        if up is None or not up.send(frame):
            # the member died under this send: the inflight entry is
            # recorded, so the failover pass resends it
            self._suspect(target.instance)

    def _pump(self, conn: _TenantConn, up: _Upstream) -> None:
        while True:
            try:
                frame = protocol.recv_frame(up.sock)
            except (OSError, protocol.ProtocolError):
                frame = None
            if frame is None:
                up.alive = False
                if not self._closing.is_set() and conn.alive:
                    self._suspect(up.instance)
                return
            op = frame.get("op")
            if op in ("verdict", "retry-after"):
                key = (str(frame.get("id") or ""),
                       str(frame.get("checker") or "append"))
                if op == "retry-after" and not frame.get("checker"):
                    # retry-after frames carry no checker; match any
                    # in-flight entry with this id on this member
                    with conn.lock:
                        keys = [k for k, e in conn.inflight.items()
                                if k[0] == key[0]
                                and e["member"] == up.instance]
                    if not keys:
                        continue
                    conn.send(frame)
                    continue
                with conn.lock:
                    ent = conn.inflight.get(key)
                    if ent is None or ent["member"] != up.instance:
                        # late frame from a fenced zombie (or a
                        # duplicate after failover re-targeted the
                        # id): drop — the successor owns the reply
                        continue
                    if op == "verdict":
                        conn.inflight.pop(key, None)
                        replayed = bool(ent.get("failover")
                                        and frame.get("replay"))
                    else:
                        replayed = False
                if op == "verdict":
                    self._verdicts += 1
                    if replayed:
                        trace.get_current().counter(
                            "fleet_replayed_verdicts").inc()
                conn.send(frame)
            else:
                conn.send(frame)

    # -- death detection + failover ----------------------------------------

    def _suspect(self, instance: int) -> None:
        with self._slock:
            self._suspects.add(instance)

    def _monitor_loop(self) -> None:
        tick = min(0.25, heartbeat_s() / 2)
        while not self._closing.wait(tick):
            try:
                self._scan()
            except Exception:
                log.exception("fleet monitor scan failed")

    def _scan(self) -> None:
        fo = failover_s()
        with self._slock:
            suspects = set(self._suspects)
            self._suspects.clear()
        with self._mlock:
            members = list(self._members.values())
        tr = trace.get_current()
        for m in members:
            if m.status != "live":
                continue
            cause = None
            if m.proc is not None and m.proc.poll() is not None:
                cause = f"process exit {m.proc.returncode}"
            try:
                st = m.beacon_path.stat()
                m.beacon_age = max(0.0, time.time() - st.st_mtime)
                try:
                    m.beacon = json.loads(m.beacon_path.read_text())
                except (OSError, json.JSONDecodeError):
                    pass
            except OSError:
                # beacon retired: a clean drain (or a fenced zombie's
                # exit) — the member is gone either way
                m.beacon_age = None
                if cause is None:
                    cause = "beacon retired"
            if cause is None and m.beacon_age is not None \
                    and m.beacon_age > fo:
                # a SIGSTOPped member still accept()s (the kernel
                # backlog answers), so staleness alone is decisive
                cause = f"beacon stale {m.beacon_age:.1f}s"
            if cause is None and m.instance in suspects:
                if not self._probe(m):
                    cause = "connection refused"
            if cause is not None:
                self._fail_over(m, cause)
            else:
                tr.gauge(f"fleet.d{m.instance}.queue_depth").set(
                    int(m.beacon.get("queue_depth") or 0))

    def _probe(self, m: _Member) -> bool:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.settimeout(1.0)
            s.connect(str(m.socket_path))
            return True
        except OSError:
            return False
        finally:
            try:
                s.close()
            except OSError:
                pass

    def _fail_over(self, m: _Member, cause: str) -> None:
        with self._mlock:
            if m.status != "live":
                return
            m.status = "dead"
            self._epoch += 1
            epoch = self._epoch
        t0 = time.perf_counter()
        # 1. THE FENCE, before anything else: from here a resurrected
        # zombie drops its folds unjournaled instead of double-serving
        self._write_epoch()
        obs_events.emit("fleet_daemon_dead", instance=m.instance,
                        cause=cause, epoch=epoch)
        log.warning("fleet member d%d dead (%s); epoch -> %d",
                    m.instance, cause, epoch)
        # 2. best-effort STONITH: belt over the fence's suspenders
        if self.stonith:
            pid = m.current_pid()
            if pid:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        # 3. reassign + replay
        live = self._live_members()
        tr = trace.get_current()
        moved_tenants: list[str] = []
        with self._cl:
            conns = list(self._conns)
        for c in conns:
            if not c.alive or c.tenant is None:
                continue
            with c.lock:
                entries = [(k, e) for k, e in c.inflight.items()
                           if e["member"] == m.instance]
                dead_up = c.upstreams.pop(m.instance, None)
            if dead_up is not None:
                dead_up.close()
            if not entries:
                continue
            if not live:
                # nothing to fail over to: entries stay recorded; the
                # tenants' own resends route once a member returns
                continue
            succ = self._affine(c.tenant, live)
            up = self._upstream(c, succ)
            if up is None:
                continue
            # adopt-then-resend, pipelined: in-order processing on the
            # successor's stream guarantees the index reload lands
            # before the first resent check
            up.send({"op": "adopt", "tenant": c.tenant})
            moved = 0
            for k, e in entries:
                with c.lock:
                    e["member"] = succ.instance
                    e["failover"] = True
                if not up.send(e["frame"]):
                    self._suspect(succ.instance)
                    break
                moved += 1
            moved_tenants.append(c.tenant)
            self._append_reassign(epoch, m.instance, succ.instance,
                                  c.tenant, moved)
        dt_ms = (time.perf_counter() - t0) * 1000.0
        tr.counter("fleet_failovers").inc()
        tr.histogram("fleet_failover_ms").observe(dt_ms)
        tr.gauge("fleet_daemons_live").set(len(live))
        tr.gauge("fleet_epoch").set(epoch)
        obs_events.emit("fleet_failover", instance=m.instance,
                        successor=(live[0].instance if len(live) == 1
                                   else None),
                        tenants=len(moved_tenants), epoch=epoch,
                        ms=round(dt_ms, 3))

    # -- durable markers ---------------------------------------------------

    def _write_epoch(self) -> None:
        with self._mlock:
            data = {"epoch": self._epoch,
                    "router_pid": os.getpid(),
                    "t_wall": round(time.time(), 6),
                    "members": {str(m.instance):
                                {"status": m.status,
                                 "socket": str(m.socket_path)}
                                for m in self._members.values()}}
        try:
            trace.atomic_write_text(
                store_mod.fleet_epoch_path(self.store.base),
                json.dumps(data))
        except OSError:
            log.warning("epoch marker write failed", exc_info=True)

    def _append_reassign(self, epoch: int, dead: int, successor: int,
                         tenant: str, inflight: int) -> None:
        line = json.dumps({"epoch": epoch, "dead": dead,
                           "successor": successor, "tenant": tenant,
                           "inflight": inflight,
                           "t_wall": round(time.time(), 6)}) + "\n"
        try:
            with open(store_mod.fleet_reassign_path(self.store.base),
                      "a") as f:
                f.write(line)
                f.flush()
        except OSError:
            log.debug("reassign journal append failed", exc_info=True)

    # -- observability -----------------------------------------------------

    def _fleet_section(self) -> dict:
        with self._mlock:
            members = {}
            for m in self._members.values():
                members[str(m.instance)] = {
                    "status": m.status,
                    "pid": m.current_pid(),
                    "beacon_age_s": (round(m.beacon_age, 3)
                                     if m.beacon_age is not None
                                     else None),
                    "queue_depth": m.beacon.get("queue_depth"),
                    "hbm_modeled_bytes":
                        m.beacon.get("hbm_modeled_bytes"),
                }
        live = self._live_members()
        tenants = {}
        with self._cl:
            conns = list(self._conns)
        for c in conns:
            if c.tenant is None:
                continue
            with c.lock:
                on = sorted({e["member"]
                             for e in c.inflight.values()})
            tenants[c.tenant] = {
                "affine": (self._affine(c.tenant, live).instance
                           if live else None),
                "inflight_on": on}
        return {"fleet": {
            "epoch": self._epoch,
            "socket": str(self._resolved_socket()),
            "daemons": len(members),
            "live": len(live),
            "verdicts_forwarded": self._verdicts,
            "members": members,
            "tenants": tenants,
        }}


def run_fleet(store, daemons: int = 3, socket_path=None,
              stonith: bool = True, device: str = "cuda") -> int:
    """The CLI body: resolve `device` (255 without it, before anything
    spawns), start the router (spawning its daemons on that device),
    print the machine-readable ready line, stop on SIGTERM/SIGINT."""
    from ..devices import DeviceUnavailable, resolve_device
    try:
        device = str(resolve_device(device))
    except DeviceUnavailable as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 255
    router = FleetRouter(store, daemons=daemons,
                         socket_path=socket_path, stonith=stonith,
                         device=device)
    try:
        router.start()
    except Exception:
        log.exception("fleet failed to start")
        router.stop()
        return 255
    done = threading.Event()

    def _on_signal(signum, _frame):
        done.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass
    print(json.dumps(router.ready_info()), flush=True)
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    return router.stop()
