"""The port's serve fleet (jepsen_tpu_torch.serve.fleet) on the CPU:
tests/test_fleet.py's cases pointed at the port, every daemon on
`device="cpu"`.

- The store helpers, `safe_tenant` and `shard_of` equal the reference's
  for the same tenants, so a tenant lands on the same member in both
  packages.
- The epoch-fence predicate, with a torn, a corrupt and an alien
  marker.
- An in-process attach-mode fleet: a member's death, its tenant's
  journal replayed on the successor byte for byte; spill under a low
  JEPSEN_TPU_FLEET_SPILL_DEPTH with no lost or duplicated journal line.
- Subprocess fleets (`python -m jepsen_tpu_torch.cli serve --device
  cpu` members the router spawns): SIGKILL of the affine member
  mid-stream (every verdict once, the move in fleet-reassign.jsonl),
  and the SIGSTOP zombie, fenced out of the epoch, dropping its stale
  folds unjournaled.
- The client's bounded retry, on the connect and the reconnect path.

Every subprocess test has its own time limits and reaps what it
started (the router's stop terminates and waits for its members)."""

import json
import os
import signal
import socket
import threading
import time
from pathlib import Path

import pytest

import jepsen_tpu.store as ref_store
from jepsen_tpu_torch import obs, trace
from jepsen_tpu_torch.checker.elle import synth
from jepsen_tpu_torch.serve import fleet as fleet_mod
from jepsen_tpu_torch.serve import protocol
from jepsen_tpu_torch.serve.client import (ServeClient, ServeError,
                                           ServeUnavailable)
from jepsen_tpu_torch.serve.daemon import VerdictDaemon
from jepsen_tpu_torch.serve.fleet import FleetRouter, load_reassignments
from jepsen_tpu_torch.store import (Store, VerdictJournal,
                                    fleet_daemon_socket_path,
                                    fleet_epoch_path, fleet_member_path,
                                    fleet_reassign_path, fleet_socket_path,
                                    request_spool_path, safe_tenant,
                                    serve_pid_path, serve_socket_path,
                                    shard_of, tenant_journal_path)

def make_store(root: Path, b: int = 4, t: int = 64, k: int = 8,
               bad_every: int = 2) -> tuple[Path, list[Path]]:
    store = root / "store"
    synth.write_synth_run_store(store, B=b, T=t, K=k, bad_every=bad_every)
    return store, sorted(Store(store).iter_run_dirs())


@pytest.fixture
def keep_tracer():
    prev = trace.get_current()
    yield
    trace.set_current(prev)
    obs.reset_events()


@pytest.fixture
def fleet_env(monkeypatch):
    """Fast heartbeats and no health, metrics or socket settings
    inherited from the environment."""
    monkeypatch.setenv("JEPSEN_TPU_FLEET_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("JEPSEN_TPU_FLEET_FAILOVER_S", "1.0")
    monkeypatch.setenv("JEPSEN_TPU_HEALTH_INTERVAL_S", "0")
    monkeypatch.setenv("JEPSEN_TPU_SERVE_RETRY_S", "60")
    for var in ("JEPSEN_TPU_METRICS_PORT", "JEPSEN_TPU_SERVE_SOCKET",
                "JEPSEN_TPU_SERVE_PORT", "JEPSEN_TPU_BACKEND",
                "JEPSEN_TPU_FLEET_SPILL_DEPTH"):
        monkeypatch.delenv(var, raising=False)


def canon(v) -> str:
    return json.dumps(v, sort_keys=True)


def raw_line_count(p: Path) -> int:
    if not p.exists():
        return 0
    return sum(1 for ln in p.read_text().splitlines() if ln.strip())


def wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# units: the store helpers, shard_of, the epoch fence
# ---------------------------------------------------------------------------

TENANTS = ["tA", "tK", "tZ", "fleetA", "wB", "default", "a/b", "a_b-ish",
           "a.b", "../../etc/passwd", "ünïcode", "", "x" * 100]


@pytest.mark.parametrize("tenant", TENANTS)
def test_store_helpers_and_shard_of_equal_the_reference(tenant, tmp_path):
    assert safe_tenant(tenant) == ref_store.safe_tenant(tenant)
    assert tenant_journal_path(tmp_path, tenant) \
        == ref_store.tenant_journal_path(tmp_path, tenant)
    for n in (1, 2, 3, 7):
        assert shard_of(tenant, n) == ref_store.shard_of(tenant, n)


def test_fleet_paths_equal_the_reference(tmp_path):
    for mine, ref in ((serve_socket_path, ref_store.serve_socket_path),
                      (serve_pid_path, ref_store.serve_pid_path),
                      (request_spool_path, ref_store.request_spool_path),
                      (fleet_socket_path, ref_store.fleet_socket_path),
                      (fleet_epoch_path, ref_store.fleet_epoch_path),
                      (fleet_reassign_path, ref_store.fleet_reassign_path)):
        assert mine(tmp_path) == ref(tmp_path)
    for k in range(3):
        assert fleet_daemon_socket_path(tmp_path, k) \
            == ref_store.fleet_daemon_socket_path(tmp_path, k)
        assert fleet_member_path(tmp_path, k) \
            == ref_store.fleet_member_path(tmp_path, k)
    evil = safe_tenant("../../etc/passwd")
    assert "/" not in evil and ".." not in evil


def test_epoch_fence_predicate(tmp_path):
    store, _dirs = make_store(tmp_path)
    d = VerdictDaemon(Store(store), fleet_instance=1, fleet_epoch=1,
                      device="cpu")
    assert d._fenced() is False            # no marker yet
    marker = fleet_epoch_path(store)
    marker.write_text(json.dumps(
        {"epoch": 1, "members": {"0": {"status": "live"},
                                 "1": {"status": "live"}}}))
    assert d._fenced() is False
    time.sleep(0.02)   # a distinct mtime, so the stat cache re-parses
    marker.write_text(json.dumps(
        {"epoch": 2, "members": {"0": {"status": "live"},
                                 "1": {"status": "dead"}}}))
    assert d._fenced() is True
    assert VerdictDaemon(Store(store), device="cpu")._fenced() is False


@pytest.mark.parametrize("alien", [[1, 2, 3], {"epoch": 3, "members": ["1"]},
                                   {"epoch": 4, "members": {"1": "dead"}}],
                         ids=["list", "members-list", "bare-string"])
def test_epoch_fence_corrupt_and_alien_marker(alien, tmp_path):
    """A torn marker reads as not fenced and is not cached, so the clean
    rewrite is honored; an alien shape degrades to not fenced, and a
    clean marker after it fences again."""
    store, _dirs = make_store(tmp_path)
    d = VerdictDaemon(Store(store), fleet_instance=1, fleet_epoch=1,
                      device="cpu")
    marker = fleet_epoch_path(store)
    marker.write_text('{"epoch": 2, "members": {"1": {"status": "de')
    assert d._fenced() is False
    time.sleep(0.02)
    marker.write_text(json.dumps(
        {"epoch": 2, "members": {"1": {"status": "dead"}}}))
    assert d._fenced() is True
    time.sleep(0.02)
    marker.write_text(json.dumps(alien))
    assert d._fenced() is False
    time.sleep(0.02)
    marker.write_text(json.dumps(
        {"epoch": 5, "members": {"1": {"status": "dead"}}}))
    assert d._fenced() is True


def test_spawned_members_are_the_ports_on_the_routers_device(
        tmp_path, monkeypatch):
    seen = []

    class FakePopen:
        def __init__(self, cmd, env=None, stdout=None):
            seen.append((cmd, env))
            self.pid = 4242

    monkeypatch.setattr(fleet_mod.subprocess, "Popen", FakePopen)
    monkeypatch.setenv("JEPSEN_TPU_METRICS_PORT", "9")
    r = FleetRouter(Store(tmp_path), daemons=2, device="cpu")
    r._epoch = 3
    r._spawn_member(1)
    (cmd, env), = seen
    assert cmd[1:] == ["-m", "jepsen_tpu_torch.cli", "serve", "--store",
                       str(tmp_path), "--socket",
                       str(fleet_daemon_socket_path(tmp_path, 1)),
                       "--fleet-instance", "1", "--fleet-epoch", "3",
                       "--device", "cpu"]
    assert "JEPSEN_TPU_METRICS_PORT" not in env


# ---------------------------------------------------------------------------
# in-process attach-mode fleet
# ---------------------------------------------------------------------------

def attach_fleet(store: Path, n: int = 2):
    # stonith off: the members live in this process, so a STONITH of a
    # convicted member would SIGKILL the test run itself
    daemons = [VerdictDaemon(Store(store), fleet_instance=k, fleet_epoch=1,
                             device="cpu").start() for k in range(n)]
    router = FleetRouter(Store(store), daemons=n, spawn=False,
                         stonith=False)
    for k in range(n):
        router.attach_member(k, fleet_daemon_socket_path(store, k))
    router.start()
    return router, daemons


def stop_all(router, daemons) -> None:
    router.stop()
    for d in daemons:
        try:
            d.stop()
        except Exception:
            pass


def test_attach_failover_replays_the_journal(tmp_path, fleet_env,
                                             keep_tracer):
    store, dirs = make_store(tmp_path)
    router, daemons = attach_fleet(store)
    tenant = "tA"
    affine = shard_of(tenant, 2)
    try:
        c = ServeClient(socket_path=fleet_socket_path(store),
                        tenant=tenant, timeout=120)
        c.connect()
        for d in dirs:
            c.check_dir(d)
        first = dict(c.collect(timeout=240, reconnect=True))
        assert len(first) == len(dirs)
        daemons[affine].stop()     # a clean stop retires the beacon
        wait_for(lambda: router._member(affine).status == "dead", 15.0,
                 "the router to convict the stopped member")
        assert router._epoch == 2
        for d in dirs:
            c.check_dir(d)
        again = c.collect(timeout=240, reconnect=True)
        assert c.replays >= len(dirs)
        assert {r: canon(v) for r, v in again.items()} \
            == {r: canon(v) for r, v in first.items()}
        c.close()
        p = tenant_journal_path(store, tenant)
        assert set(VerdictJournal.load(p)) \
            == {(str(d), "append") for d in dirs}
        assert raw_line_count(p) == len(dirs)
        marker = json.loads(fleet_epoch_path(store).read_text())
        assert marker["epoch"] == 2
        assert marker["members"][str(affine)]["status"] == "dead"
        section = router._fleet_section()["fleet"]
        assert section["live"] == 1 and section["epoch"] == 2
    finally:
        stop_all(router, daemons)


def test_spill_keeps_tenants_whole(tmp_path, fleet_env, keep_tracer,
                                   monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_FLEET_SPILL_DEPTH", "1")
    store, dirs = make_store(tmp_path, b=6, bad_every=3)
    router, daemons = attach_fleet(store)
    tenants = {"wA": dirs[:3], "wB": dirs[3:]}
    try:
        clients = {}
        for name, share in tenants.items():
            c = ServeClient(socket_path=fleet_socket_path(store),
                            tenant=name, timeout=120,
                            weight=2.0 if name == "wA" else 1.0)
            c.connect()
            clients[name] = c
            for d in share:
                c.check_dir(d)
        for name, share in tenants.items():
            got = clients[name].collect(timeout=240, reconnect=True)
            assert len(got) == len(share)
            clients[name].close()
        assert trace.get_current().counter("fleet_spills").value > 0
        for name, share in tenants.items():
            p = tenant_journal_path(store, name)
            assert set(VerdictJournal.load(p)) \
                == {(str(d), "append") for d in share}
            assert raw_line_count(p) == len(share)
    finally:
        stop_all(router, daemons)


# ---------------------------------------------------------------------------
# subprocess fleets
# ---------------------------------------------------------------------------

def test_sigkill_midstream_failover_no_loss_no_dup(tmp_path, fleet_env,
                                                   keep_tracer):
    store, dirs = make_store(tmp_path)
    router = FleetRouter(Store(store), daemons=2, start_timeout_s=120.0,
                         device="cpu")
    tenant = "tK"
    procs = []
    try:
        router.start()
        procs = [m.proc for m in router._members.values()]
        c = ServeClient(socket_path=fleet_socket_path(store),
                        tenant=tenant, timeout=120)
        c.connect(retry=True)
        for d in dirs:
            c.check_dir(d)
        victim = router._affine(tenant, router._live_members())
        os.kill(victim.current_pid(), signal.SIGKILL)
        got = c.collect(timeout=240, reconnect=True)
        c.close()
        assert len(got) == len(dirs)
        wait_for(lambda: router._member(victim.instance).status == "dead",
                 15.0, "the router to convict the killed member")
        assert router._epoch == 2
        p = tenant_journal_path(store, tenant)
        assert set(VerdictJournal.load(p)) \
            == {(str(d), "append") for d in dirs}
        assert raw_line_count(p) == len(dirs)
        assert [g["valid?"] for _r, g in sorted(got.items())] \
            == [True, False] * 2
    finally:
        router.stop()
    moves = load_reassignments(store)
    assert all(m["dead"] == victim.instance for m in moves)
    assert all(p.poll() is not None for p in procs)   # every member reaped


def test_zombie_fenced_after_sigstop_resurrection(tmp_path, fleet_env,
                                                  keep_tracer):
    store, dirs = make_store(tmp_path)
    router = FleetRouter(Store(store), daemons=2, stonith=False,
                         start_timeout_s=120.0, device="cpu")
    tenant = "tZ"
    pid = None
    try:
        router.start()
        c = ServeClient(socket_path=fleet_socket_path(store),
                        tenant=tenant, timeout=120)
        c.connect(retry=True)
        victim = router._affine(tenant, router._live_members())
        pid = victim.current_pid()
        # stopped BEFORE the checks: they wait in its socket buffer, so
        # the resurrected zombie has stale folds to (not) journal
        os.kill(pid, signal.SIGSTOP)
        for d in dirs:
            c.check_dir(d)
        got = c.collect(timeout=240, reconnect=True)
        c.close()
        assert len(got) == len(dirs)
        wait_for(lambda: router._member(victim.instance).status == "dead",
                 15.0, "the staleness conviction of the stopped member")
        os.kill(pid, signal.SIGCONT)
        pid = None
        proc = router._member(victim.instance).proc
        wait_for(lambda: proc.poll() is not None, 120.0,
                 "the fenced zombie to drain itself")
        p = tenant_journal_path(store, tenant)
        assert set(VerdictJournal.load(p)) \
            == {(str(d), "append") for d in dirs}
        assert raw_line_count(p) == len(dirs)      # no double append
        kinds = {e.get("event") for e in obs.load_events(store)}
        assert "fleet_fence" in kinds
        moves = load_reassignments(store)
        assert moves and moves[0]["dead"] == victim.instance \
            and moves[0]["tenant"] == tenant
    finally:
        if pid is not None:
            os.kill(pid, signal.SIGCONT)
        router.stop()


# ---------------------------------------------------------------------------
# the client's bounded retry
# ---------------------------------------------------------------------------

def test_connect_retry_is_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_SERVE_RETRY_S", "0.3")
    c = ServeClient(socket_path=tmp_path / "nope.sock", timeout=2)
    t0 = time.monotonic()
    with pytest.raises(ServeUnavailable):
        c.connect(retry=True)
    assert time.monotonic() - t0 < 10.0


def one_shot_server(sock_path: Path):
    """Accept one connection, answer its hello, then close everything:
    a daemon that dies right after the welcome."""
    ls = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    ls.bind(str(sock_path))
    ls.listen(1)

    def run():
        conn, _ = ls.accept()
        hello = protocol.recv_frame(conn)
        assert hello and hello.get("op") == "hello"
        protocol.send_frame(conn, {"op": "welcome", "v": 1})
        time.sleep(0.2)
        conn.close()
        ls.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_collect_reconnect_budget_is_terminal(tmp_path, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_SERVE_RETRY_S", "0.4")
    sock = tmp_path / "one-shot.sock"
    t = one_shot_server(sock)
    c = ServeClient(socket_path=sock, tenant="t", timeout=5)
    c.connect()
    c.check_history([], rid="h1")
    t0 = time.monotonic()
    with pytest.raises(ServeUnavailable):
        c.collect(timeout=30, reconnect=True)
    assert time.monotonic() - t0 < 15.0
    t.join(timeout=10)


def test_collect_without_reconnect_raises_plain_error(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_SERVE_RETRY_S", "0.4")
    sock = tmp_path / "one-shot2.sock"
    t = one_shot_server(sock)
    c = ServeClient(socket_path=sock, tenant="t", timeout=5)
    c.connect()
    c.check_history([], rid="h1")
    with pytest.raises(ServeError, match="closed the connection"):
        c.collect(timeout=30)
    t.join(timeout=10)
