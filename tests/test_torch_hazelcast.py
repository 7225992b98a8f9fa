"""The port's `hazelcast` suite over its own wire driver
(`drivers/hazelcast_proto.py`), against the reference's.

- The reference's own cases (tests/test_hazelcast_client.py and the
  hazelcast cases of tests/test_template_suites.py) on the port's
  copies, against the fake on the port's codec
  (tests/fake_torch_hazelcast.py).
- The driver byte for byte: the Open Client Protocol bytes a session
  sends and receives against the fake, the Data blobs of seeded values,
  and each package's reading of scripted frames: the same values, and
  the same `DBError` or `DriverError`, with the same `is_retriable`, on
  a wire fault.
- The clients op for op against the fake: locks, queues (a drain cut
  short included), atomic-long ids and the map-set CAS.
- The test maps, workload menus, generators (under a seeded `random`),
  the DB setup (the merge policy's upload from the port's own copy)
  and `main`'s default workload, which the menu lacks.
- End to end: `main(["test", "--dummy", "--node", "127.0.0.1",
  "--device", "cpu", "--workload", W])` against the fake for every
  workload; both packages' `analyze --backend cpu` of the stored run, in
  turn on one path, give the same results and the same files.
"""

import copy
import json
import random
import struct
import sys
import threading
from pathlib import Path

import pytest
import torch

import jepsen_tpu.control as ref_control
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.suites.hazelcast as ref_hazelcast
from jepsen_tpu import drivers as ref_drivers
from jepsen_tpu.drivers import hazelcast_proto as ref_hz
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.suites.hazelcast as port_hazelcast
from jepsen_tpu_torch import core as port_core
from jepsen_tpu_torch import drivers as port_drivers
from jepsen_tpu_torch.drivers import hazelcast_proto as port_hz
from jepsen_tpu_torch.store import Store as PortStore

from fake_hazelcast import FakeHazelcastServer
from fake_torch_hazelcast import FakeHazelcastServer as PortFakeHazelcast
from test_torch_baseline_suites import (map_shape, no_threads_left, plain,
                                        recheck_in_turn, run_main,
                                        same_recheck)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_generator import perfect, simulate
from test_torch_more_suites import recorded  # noqa: F401
from test_torch_queue_suites import outcome, peer_got, wired

REF = dict(gen=ref_gen, control=ref_control, drivers=ref_drivers,
           hz=ref_hz, hazelcast=ref_hazelcast)
PORT = dict(gen=port_gen, control=port_control, drivers=port_drivers,
            hz=port_hz, hazelcast=port_hazelcast)
PKGS = (("ref", REF), ("port", PORT))


# ---------------------------------------------------------------------------
# The reference's cases on the port's copies
# ---------------------------------------------------------------------------

@pytest.fixture()
def srv():
    with PortFakeHazelcast() as s:
        yield s


def conn(srv):
    return port_hz.HzConn("127.0.0.1", srv.port)


def test_auth_rejected():
    with PortFakeHazelcast(creds=("u", "secret")) as s:
        with pytest.raises(port_hz.DBError):
            port_hz.HzConn("127.0.0.1", s.port)


def test_data_serialization_roundtrip():
    for v in (None, 7, -3, "hello", [1, 2, 3], []):
        got = port_hz.deser_data(port_hz.ser_data(v))
        assert got == (list(v) if isinstance(v, (list, tuple)) else v)


def test_map_cas_ops(srv):
    c = conn(srv)
    assert c.map_get("m", "hi") is None
    assert c.map_put_if_absent("m", "hi", [1]) is None
    assert c.map_put_if_absent("m", "hi", [9]) == [1]
    assert c.map_replace_if_same("m", "hi", [1], [1, 2]) is True
    assert c.map_replace_if_same("m", "hi", [1], [1, 3]) is False
    assert c.map_get("m", "hi") == [1, 2]
    c.close()


def test_queue_ops(srv):
    c = conn(srv)
    assert c.queue_offer("q", 10) is True
    assert c.queue_offer("q", 20) is True
    assert c.queue_size("q") == 2
    assert c.queue_poll("q") == 10
    assert c.queue_take("q") == 20
    assert c.queue_poll("q") is None
    c.close()


def test_lock_ops(srv):
    c1, c2 = conn(srv), conn(srv)
    assert c1.lock_try_lock("l", 100) is True
    assert c2.lock_try_lock("l", 100) is False
    with pytest.raises(port_hz.HazelcastError, match="not owner"):
        c2.lock_unlock("l")
    c1.lock_unlock("l")
    assert c2.lock_try_lock("l", 100) is True
    c1.close(), c2.close()


def test_atomic_long_ops(srv):
    c = conn(srv)
    assert c.atomic_long_increment_and_get("ids") == 1
    assert c.atomic_long_increment_and_get("ids") == 2
    assert c.atomic_long_add_and_get("ids", 10) == 12
    assert c.atomic_long_get("ids") == 12
    c.close()


def _opened(cls, srv, **kw):
    c = cls(port=srv.port, **kw)
    return c.open({}, "127.0.0.1")


def test_lock_client_classification(srv):
    a = _opened(port_hazelcast.LockClient, srv)
    b = _opened(port_hazelcast.LockClient, srv)
    assert a.invoke({}, {"f": "acquire"})["type"] == "ok"
    assert b.invoke({}, {"f": "acquire"})["type"] == "fail"
    out = b.invoke({}, {"f": "release"})
    assert out["type"] == "fail" and out["error"] == "not-lock-owner"
    assert a.invoke({}, {"f": "release"})["type"] == "ok"


def test_queue_client(srv):
    c = _opened(port_hazelcast.QueueClient, srv)
    assert c.invoke({}, {"f": "enqueue", "value": 5})["type"] == "ok"
    assert c.invoke({}, {"f": "enqueue", "value": 6})["type"] == "ok"
    out = c.invoke({}, {"f": "dequeue"})
    assert out["type"] == "ok" and out["value"] == 5
    out = c.invoke({}, {"f": "drain"})
    assert out["type"] == "ok" and out["value"] == [6]


def test_id_client(srv):
    c = _opened(port_hazelcast.AtomicLongIdClient, srv)
    vs = [c.invoke({}, {"f": "generate"})["value"] for _ in range(5)]
    assert vs == [1, 2, 3, 4, 5]


def test_map_set_client_cas_and_read(srv):
    a = _opened(port_hazelcast.MapSetClient, srv, crdt=True)
    assert a.invoke({}, {"f": "add", "value": 3})["type"] == "ok"
    assert a.invoke({}, {"f": "add", "value": 1})["type"] == "ok"
    out = a.invoke({}, {"f": "read"})
    assert out["type"] == "ok" and out["value"] == [1, 3]
    # uses the crdt map name the merge policy is registered for
    assert "jepsen.crdt-map" in srv.state.maps


def test_connection_refused_is_indeterminate():
    c = port_hazelcast.AtomicLongIdClient(port=1)
    with pytest.raises(port_hz.DriverError):
        c.open({}, "127.0.0.1")


def test_workload_menu_matches_reference():
    ws = port_hazelcast.workloads()
    assert set(ws) == {"lock", "lock-no-quorum", "queue",
                      "atomic-long-ids", "map", "crdt-map"}
    for name, f in ws.items():
        pkg = f()
        assert pkg.get("generator") is not None, name
        assert pkg.get("checker") is not None, name
        assert pkg.get("client") is not None, name


def test_hazelcast_test_default_client_wired():
    t = port_hazelcast.hazelcast_test({"time-limit": 1})
    assert t["client"] is not None


def test_lock_workload_full_run(tmp_path, srv, monkeypatch):
    monkeypatch.setattr(port_hazelcast._HzClient, "port", srv.port)
    t = port_hazelcast.hazelcast_test({
        "workload": "lock", "time-limit": 2, "nemesis-interval": 1000,
        "nodes": ["127.0.0.1"], "concurrency": 3, "device": "cpu",
        "ssh": {"dummy": True}})
    # partition nemesis sleeps would outlive the run; drop the nemesis
    t["nemesis"] = None
    wl = port_hazelcast.workloads()["lock"]()
    t["generator"] = port_gen.time_limit(2, port_gen.clients(
        wl["generator"]))
    t["store"] = PortStore(tmp_path / "store")
    t = port_core.run(t)
    assert t["results"]["valid?"] is True
    hist = [o for o in t["history"] if o.get("f") in ("acquire", "release")]
    assert len(hist) >= 4


def test_db_setup_against_dummy_remote():
    test = port_hazelcast.hazelcast_test({"ssh": {"dummy": True}})
    port_control.on_nodes(test, lambda t, n: t["db"].setup(t, n))
    cmds = "\n".join(str(p) for _n, kind, p in test["remote"].actions
                     if kind in ("execute", "upload"))
    assert "hazelcast" in cmds


def test_hazelcast_setup_compiles_merge_policy():
    test = port_hazelcast.hazelcast_test({"ssh": {"dummy": True}})
    port_control.on_nodes(test, lambda t, n: t["db"].setup(t, n))
    acts = test["remote"].actions
    uploads = [p for _n, kind, p in acts if kind == "upload"]
    cmds = "\n".join(str(p) for _n, kind, p in acts
                     if kind == "execute")
    assert any("SetUnionMergePolicy" in str(u) for u in uploads)
    assert "javac" in cmds


def test_suite_has_cli_and_workloads():
    assert callable(port_hazelcast.main)
    assert port_hazelcast.workloads()


# ---------------------------------------------------------------------------
# The driver byte for byte
# ---------------------------------------------------------------------------

def seeded_values(seed: int) -> list:
    rng = random.Random(seed)
    out = [None, 0, -1, 2 ** 63 - 1, -2 ** 63, "", "héllo", [], [0]]
    for _ in range(60):
        kind = rng.randrange(3)
        if kind == 0:
            out.append(rng.randrange(-2 ** 63, 2 ** 63))
        elif kind == 1:
            out.append("".join(chr(rng.randrange(32, 0x3000))
                               for _ in range(rng.randrange(30))))
        else:
            out.append([rng.randrange(-2 ** 40, 2 ** 40)
                        for _ in range(rng.randrange(12))])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_data_blobs_equal_the_references(seed):
    """`ser_data` and `deser_data` over seeded values: the reference's
    bytes and values; the same DriverError for what no workload sends
    (a bool, a float, a short blob, an unknown type id)."""
    for v in seeded_values(seed):
        blob = port_hz.ser_data(v)
        assert blob == ref_hz.ser_data(v)
        assert port_hz.deser_data(blob) == ref_hz.deser_data(blob)
    for bad in (True, 1.5, {"a": 1}, [1, "x"]):
        got = [outcome(P, lambda: P["hz"].ser_data(bad)) for _, P in PKGS]
        assert got[0] == got[1] and got[0][0] == "driver-error"
    for blob in (b"\0" * 7, struct.pack(">ii", 0, 99)):
        got = [outcome(P, lambda: P["hz"].deser_data(blob))
               for _, P in PKGS]
        assert got[0] == got[1] and got[0][0] == "driver-error"


def hazelcast_session(P, port: int) -> list:
    c = P["hz"].HzConn("127.0.0.1", port)
    d = P["hz"].HzConn("127.0.0.1", port)
    steps = [
        lambda: c.map_get("m", "hi"),
        lambda: c.map_put("m", "hi", [1]),
        lambda: c.map_put("m", "hi", [1, 2]),
        lambda: c.map_put_if_absent("m", "hi", [9]),
        lambda: c.map_put_if_absent("m", "lo", "héllo"),
        lambda: c.map_replace_if_same("m", "hi", [1, 2], [1, 2, 3]),
        lambda: c.map_replace_if_same("m", "hi", [1], [4]),
        lambda: c.queue_offer("q", 10),
        lambda: c.queue_offer("q", -20),
        lambda: c.queue_size("q"),
        lambda: c.queue_poll("q"),
        lambda: c.queue_take("q"),
        lambda: c.queue_poll("q"),
        lambda: c.lock_try_lock("l", 100),
        lambda: d.lock_try_lock("l", 100),
        lambda: d.lock_unlock("l"),
        lambda: d.lock_lock("l"),
        lambda: c.lock_unlock("l"),
        lambda: d.lock_lock("l"),
        lambda: c.atomic_long_increment_and_get("ids"),
        lambda: c.atomic_long_add_and_get("ids", -5),
        lambda: c.atomic_long_get("ids"),
        lambda: c.request(0x7777, b""),
    ]
    out = [outcome(P, f) for f in steps]
    c.close()
    d.close()
    out.append(outcome(P, lambda: c.map_get("m", "hi")))
    return out


def test_hazelcast_session_bytes_and_replies_equal_the_references(
        recorded):
    """The Open Client Protocol bytes each package's two connections
    send, the fake's reply bytes, and what each package makes of them:
    equal, the lock owner's error frames, an unknown message type and
    the closed connection included."""
    got = {}
    for name, P in PKGS:
        with FakeHazelcastServer() as srv:
            got[name] = hazelcast_session(P, srv.port)
    assert got["port"] == got["ref"]
    r1, r2, p1, p2 = recorded
    for ref_sock, port_sock in ((r1, p1), (r2, p2)):
        assert bytes(port_sock.sent) == bytes(ref_sock.sent)
        assert bytes(port_sock.got) == bytes(ref_sock.got)
    out = got["port"]
    assert out[2] == ("ok", [1]) and out[3] == ("ok", [1, 2])
    assert out[5] == ("ok", True) and out[6] == ("ok", False)
    assert out[13] == ("ok", True) and out[14] == ("ok", False)
    assert out[15][:2] == ("db-error", 25)
    assert "not owner" in out[15][2] and out[15][3] is False
    assert out[16][:2] == ("db-error", 1)
    assert out[21] == ("ok", -4)
    assert out[22][:2] == ("db-error", 2)
    assert out[-1][0] == "driver-error"


def frame(msg_type: int, corr: int, payload: bytes = b"") -> bytes:
    return ref_hz.pack_message(msg_type, corr, payload)


AUTH_OK = frame(ref_hz.RESP_AUTH, 1, b"\x00\x01")


def error_frame(corr: int, code: int, cls, msg) -> bytes:
    w = ref_hz._W()
    w.parts.append(struct.pack("<i", code))
    w.nullable_string(cls)
    w.nullable_string(msg)
    return frame(ref_hz.RESP_ERROR, corr, w.bytes_())


#: scripted frames -> what the handshake, a map_get and a queue_offer
#: read from them
HZ_REPLIES = {
    "ok": AUTH_OK + frame(ref_hz.RESP_DATA, 2, b"\x00" + struct.pack(
        "<i", 16) + ref_hz.ser_data(42)) + frame(ref_hz.RESP_BOOL, 3,
                                                 b"\x01"),
    "event-frames-skipped": AUTH_OK + frame(0x00CB, 99, b"x") + frame(
        ref_hz.RESP_DATA, 2, b"\x01") + frame(0x00CB, 1, b"") + frame(
        ref_hz.RESP_BOOL, 3, b"\x00"),
    "error-frames": AUTH_OK + error_frame(2, 42, None, None) + error_frame(
        3, 7, "java.lang.IllegalStateException", "QuorumException"),
    "auth-refused": frame(ref_hz.RESP_AUTH, 1, b"\x02\x01"),
    "auth-wrong-type": frame(ref_hz.RESP_BOOL, 1, b"\x01"),
    "truncated-payload": AUTH_OK + frame(ref_hz.RESP_DATA, 2, b"\x00\x10"),
    "short-data": AUTH_OK + frame(ref_hz.RESP_DATA, 2, b"\x00" +
                                  struct.pack("<i", 3) + b"abc"),
    "eof": AUTH_OK,
}


@pytest.mark.parametrize("reply", sorted(HZ_REPLIES))
def test_hazelcast_replies_and_wire_faults_as_the_references(reply):
    import itertools
    got = {}
    for name, P in PKGS:
        with wired(P["hz"].HzConn, HZ_REPLIES[reply],
                   lock=threading.Lock(),
                   corr=itertools.count(1)) as (c, peer):
            out = [outcome(P, lambda: c._authenticate("dev", "dev-pass")),
                   outcome(P, lambda: c.map_get("m", "k")),
                   outcome(P, lambda: c.queue_offer("q", 5))]
            got[name] = (out, peer_got(peer))
    assert got["port"] == got["ref"]
    out = got["port"][0]
    if reply == "ok":
        assert out == [("ok", None), ("ok", 42), ("ok", True)]
    if reply == "event-frames-skipped":
        assert out == [("ok", None), ("ok", None), ("ok", False)]
    if reply == "error-frames":
        assert out[1] == ("db-error", 42, "?: ", False)
        assert out[2][1] == 7 and "QuorumException" in out[2][2]
    if reply == "auth-refused":
        assert out[0] == ("db-error", 2, "authentication failed (2)", False)
    if reply == "auth-wrong-type":
        assert out[0][0] == "driver-error"
    if reply == "eof":
        assert out[1][0] == out[2][0] == "driver-error"


def test_hazelcast_refused_connection_as_the_references():
    got = [outcome(P, lambda: P["hz"].HzConn("127.0.0.1", 1))
           for _name, P in PKGS]
    assert got[0] == got[1] and got[0][0] == "driver-error"


# ---------------------------------------------------------------------------
# The clients op for op
# ---------------------------------------------------------------------------

def invoke_ops(client, ops) -> list:
    out = [plain(client.invoke({}, {"type": "invoke", "f": f, "value": v,
                                    "process": 0}))
           for f, v in ops]
    client.close({})
    return out


#: client -> (constructor kwargs, the ops of a first and a second client)
CLIENTS = {
    "LockClient": ({}, [("acquire", None), ("acquire", None),
                        ("release", None), ("release", None)],
                   [("acquire", None), ("release", None)]),
    "LockClient-no-quorum": ({"lock_name": "jepsen.lock.no-quorum"},
                             [("acquire", None), ("release", None)],
                             [("release", None)]),
    "QueueClient": ({}, [("enqueue", 1), ("enqueue", 2), ("dequeue", None),
                         ("enqueue", 3), ("frob", None)],
                    [("drain", None), ("dequeue", None)]),
    "AtomicLongIdClient": ({}, [("generate", None)] * 3,
                           [("generate", None)] * 2),
    "MapSetClient": ({"crdt": False}, [("read", None), ("add", 1),
                                       ("add", 2), ("read", None)],
                     [("add", 3), ("read", None), ("frob", None)]),
    "MapSetClient-crdt": ({"crdt": True}, [("add", 5), ("read", None)],
                          [("add", 5), ("read", None)]),
}


@pytest.mark.parametrize("which", sorted(CLIENTS))
def test_clients_op_for_op_with_the_references(which):
    """Two clients against one fake, then the server gone: the same
    completions in both packages (a lost lock owner fails as
    not-lock-owner, a gone server is indeterminate for every mutation)."""
    kw, ops_a, ops_b = CLIENTS[which]
    cls = which.split("-")[0]
    got = {}
    for name, P in PKGS:
        with FakeHazelcastServer() as srv:
            a = getattr(P["hazelcast"], cls)(port=srv.port, **kw).open(
                {}, "127.0.0.1")
            b = getattr(P["hazelcast"], cls)(port=srv.port, **kw).open(
                {}, "127.0.0.1")
            out = invoke_ops(a, ops_a) + invoke_ops(b, ops_b)
        got[name] = out + invoke_ops(a, ops_a[:2])
    assert got["port"] == got["ref"]
    assert {o["type"] for o in got["port"][-2:]} <= {"info", "fail"}


def test_queue_drain_cut_short_as_the_reference():
    """The connection drops mid-drain: the drain is indeterminate, its
    polled prefix gone with it, in both packages."""
    got = {}
    for name, P in PKGS:
        with FakeHazelcastServer() as srv:
            c = P["hazelcast"].QueueClient(port=srv.port).open(
                {}, "127.0.0.1")
            for v in (1, 2, 3):
                c.invoke({}, {"f": "enqueue", "value": v})
            real = c.conn.queue_poll
            calls = []

            def poll(name_, real=real, calls=calls):
                calls.append(name_)
                if len(calls) == 2:
                    raise P["drivers"].DriverError("hazelcast io: reset")
                return real(name_)

            c.conn.queue_poll = poll
            got[name] = plain(c.invoke({}, {"f": "drain"}))
            c.close({})
    assert got["port"] == got["ref"]
    assert got["port"]["type"] == "info"


def test_lock_quorum_error_and_other_errors_as_the_reference():
    """A QuorumException frame fails the op as quorum; any other server
    error raises out of invoke, in both packages."""
    got = {}
    for name, P in PKGS:
        c = P["hazelcast"].LockClient()
        out = []
        for err in (P["hz"].HazelcastError(7, "x: QuorumException"),
                    P["hz"].HazelcastError(9, "x: boom")):
            def raise_(*a, err=err):
                raise err
            c.conn = type("C", (), {"lock_try_lock": raise_,
                                    "lock_unlock": raise_})()
            for f in ("acquire", "release"):
                try:
                    out.append(plain(c.invoke({}, {"f": f})))
                except P["hz"].HazelcastError as e:
                    out.append(("raised", e.code, e.message))
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][0]["error"] == "quorum"
    assert got["port"][2] == ("raised", 9, "x: boom")


# ---------------------------------------------------------------------------
# Generators, test maps, DB commands, main's default
# ---------------------------------------------------------------------------

WORKLOADS = sorted(REF["hazelcast"].workloads({}))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_generators_draw_as_the_references(workload):
    """Each workload's ops (and its final phase, where it has one) under
    the same `random` seed, through the generator simulation: op for op
    the reference's."""
    got = {}
    for name, P in PKGS:
        random.seed(22)
        wl = P["hazelcast"].workloads({"queue-size": 50})[workload]()
        g = P["gen"].limit(300, wl["generator"])
        if wl.get("final_generator") is not None:
            g = P["gen"].phases(g, wl["final_generator"])
        got[name] = plain(simulate(P["gen"], g, perfect, concurrency=6))
    assert got["port"] == got["ref"]
    assert [o for o in got["port"] if o["type"] == "invoke"]


@pytest.mark.parametrize("workload", ["lock", "queue", "crdt-map"])
def test_whole_test_generators_draw_as_the_references(workload):
    got = {}
    for name, P in PKGS:
        random.seed(4)
        t = P["hazelcast"].hazelcast_test(
            {"workload": workload, "time-limit": 1,
             "nemesis-interval": 0.25})
        got[name] = plain(simulate(P["gen"], t["generator"], perfect,
                                   concurrency=4))
    assert got["port"] == got["ref"]
    assert [o for o in got["port"] if o["process"] == "nemesis"]
    if workload == "queue":
        fs = [o["f"] for o in got["port"] if o["type"] == "invoke"]
        assert "drain" in fs and fs.index("drain") > fs.index("enqueue")


MAP_OPTS = ({}, {"time-limit": 1}, {"device": "cpu"},
            {"faults": ["partition", "kill"]}, {"queue-size": 7},
            {"version": "9.9"})


def test_test_maps_and_menus_equal_the_references():
    menu = sorted(port_hazelcast.workloads({}))
    assert menu == WORKLOADS == sorted(port_hazelcast.workloads())
    for opts in [{"workload": w, **o} for w in menu for o in MAP_OPTS] + [
            {}]:
        ref = ref_hazelcast.hazelcast_test(copy.deepcopy(opts))
        port = port_hazelcast.hazelcast_test(copy.deepcopy(opts))
        assert map_shape(port) == map_shape(ref), opts
        assert port["db"].version == ref["db"].version
        for k in ("port", "lock_name", "crdt", "map_name", "queue_name",
                  "counter_name"):
            assert getattr(port["client"], k, None) == getattr(
                ref["client"], k, None), (opts, k)
    assert port_hazelcast._HzClient.port == ref_hazelcast._HzClient.port


@pytest.mark.parametrize("workload,device", [
    (w, d) for w in ("lock", "lock-no-quorum") for d in (None, "cpu")])
def test_lock_checkers_take_the_device(workload, device):
    """The one departure: the mutex `linearizable` runs on opts' device
    (None: cuda)."""
    t = port_hazelcast.hazelcast_test(
        {"workload": workload, **({"device": device} if device else {})})
    lin = t["checker"]
    assert type(lin).__name__ == "Linearizable" and lin.device == device
    assert type(lin.model).__name__ == "Mutex"
    ref = ref_hazelcast.hazelcast_test({"workload": workload})["checker"]
    assert type(ref.model).__name__ == "Mutex"


def db_commands(P, nodes: list) -> tuple:
    """The OS and DB setup and teardown on the dummy remote: (the sorted
    commands but the uploads, the uploads' (local, remote) paths)."""
    test = P["hazelcast"].hazelcast_test(
        {"ssh": {"dummy": True}, "nodes": nodes})

    def lifecycle(t, n):
        t["os"].setup(t, n)
        t["db"].setup(t, n)
        t["db"].teardown(t, n)

    P["control"].on_nodes(test, lifecycle)
    acts = test["remote"].actions
    return (sorted((n, k, str(p)) for n, k, p in acts if k != "upload"),
            [p for _n, k, p in acts if k == "upload"])


def test_db_setup_commands_as_the_references(monkeypatch):
    """The same commands node by node; each package uploads its own copy
    of SetUnionMergePolicy.java (the port's lies under jepsen_tpu_torch/
    and holds the reference's bytes) to the same remote path."""
    nodes = ["n1", "n2", "n3"]
    ref_cmds, ref_up = db_commands(REF, nodes)
    port_cmds, port_up = db_commands(PORT, nodes)
    assert port_cmds == ref_cmds
    assert len(port_up) == len(ref_up) == len(nodes)
    repo = Path(__file__).resolve().parent.parent
    for (pl, pr), (rl, rr) in zip(port_up, ref_up):
        assert pr == rr == "/tmp/SetUnionMergePolicy.java"
        assert Path(pl).resolve() == (
            repo / "jepsen_tpu_torch" / "suites" / "resources" /
            "SetUnionMergePolicy.java")
        assert Path(rl).resolve().parent.parent.parent.name == "jepsen_tpu"
        assert Path(pl).read_bytes() == Path(rl).read_bytes()
    assert any("javac" in str(p) for _n, k, p in port_cmds)
    for P in (REF, PORT):
        db = P["hazelcast"].hazelcast_test({})["db"]
        assert db.log_files({}, "n1") == [REF["hazelcast"].LOGFILE]


def test_main_without_a_workload_raises_as_the_reference(tmp_path,
                                                         caplog):
    """`main(["test"])` defaults --workload to `set`, which the menu
    lacks: building the test map raises the same ValueError in both
    packages (reference behaviour kept for parity), which each CLI logs
    as its fatal error and exits 255, before any op runs."""
    import logging
    caplog.set_level(logging.ERROR)
    errs = []
    for P in (REF, PORT):
        caplog.clear()
        assert P["hazelcast"].main(["test", "--store",
                                    str(tmp_path / "s")]) == 255
        fatal = [r for r in caplog.records if r.exc_info
                 and r.getMessage() == "fatal error"]
        assert len(fatal) == 1
        errs.append(fatal[0].exc_info[1])
    assert [type(e) for e in errs] == [ValueError, ValueError]
    assert str(errs[0]) == str(errs[1])
    assert str(errs[1]).startswith("unknown workload 'set'")
    assert not list(tmp_path.rglob("history.jsonl"))


# ---------------------------------------------------------------------------
# End to end through the suite's main
# ---------------------------------------------------------------------------

def main_run(workload: str, tmp_path: Path, monkeypatch,
             device=("--device", "cpu")):
    """The suite's own main on one node, 127.0.0.1, whose client class's
    port is the fake's; 2 s, the partitioner every 0.3 s, 40 enqueues for
    the queue. Returns (exit code, JSON lines, the remote)."""
    remote = port_control.DummyRemote()
    argv = ["test", "--dummy", "--node", "127.0.0.1", *device, "--store",
            str(tmp_path / "port"), "--concurrency", "4", "--workload",
            workload]
    with PortFakeHazelcast() as srv:
        monkeypatch.setattr(port_hazelcast._HzClient, "port", srv.port)
        rc, lines = run_main(
            monkeypatch, port_hazelcast, "hazelcast_test",
            {"time-limit": 2.0, "nemesis-interval": 0.3,
             "queue-size": 40}, argv, remote)
    return rc, lines, remote


@pytest.mark.parametrize("workload", WORKLOADS)
def test_suite_main_equals_the_reference(workload, tmp_path, reference_env,
                                         monkeypatch):
    """`main` (`test --dummy --node 127.0.0.1 --device cpu --workload W`)
    against the fake; the two packages' re-checks of the stored run, in
    turn on one path, give the same results and files."""
    before = set(threading.enumerate())
    rc, lines, remote = main_run(workload, tmp_path, monkeypatch)
    assert no_workers_left() and no_threads_left(before)
    assert rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True
    run = Path(lines[0]["dir"])
    res = json.loads((run / "results.json").read_text())
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    client_ops = [o for o in hist if isinstance(o["process"], int)]
    assert client_ops
    nem = {o["f"] for o in hist if o["process"] == "nemesis"}
    # the map workloads' final read is `each_thread`, which the nemesis
    # thread takes too: its partitioner crashes on it, as the reference's
    assert nem <= {"start", "stop", "read"} and "start" in nem
    assert ("read" in nem) == workload.endswith("map")
    stored = json.loads((run / "test.json").read_text())
    assert stored["device"] == "cpu"
    out = recheck_in_turn(
        run, tmp_path,
        lambda P: P["hazelcast"].hazelcast_test(
            {"workload": workload, "queue-size": 40})["checker"],
        monkeypatch, pkgs=(REF, PORT))
    got = same_recheck(out)
    assert got["valid?"] is True and res["valid?"] is True
    if workload.startswith("lock"):
        assert res["analyzer"] == "wgl"
        assert [o for o in client_ops if o["f"] == "acquire"
                and o["type"] == "ok"]
    if workload == "queue":
        q = res
        assert q["lost-count"] == 0 and q["acknowledged-count"] > 0
        last_drain = max(i for i, o in enumerate(hist)
                         if o["f"] == "drain" and o["type"] == "ok")
        last_enqueue = max(i for i, o in enumerate(hist)
                           if o["f"] == "enqueue")
        assert last_drain > last_enqueue
    if workload.endswith("map"):
        assert res["ok-count"] > 0 and res["lost-count"] == 0
    if workload == "atomic-long-ids":
        assert res["duplicated-count"] == 0 and res["acknowledged-count"]


def test_lock_main_without_a_card_answers_on_the_host(tmp_path,
                                                      monkeypatch):
    """The mutex model is no CAS register: `Linearizable` gives it the
    host WGL engine, so without a card and without --device the run still
    gets its verdict."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, _ = main_run("lock", tmp_path, monkeypatch, device=())
    assert rc == 0 and len(lines) == 1
    res = json.loads((Path(lines[0]["dir"]) / "results.json").read_text())
    assert res["valid?"] is True and res["analyzer"] == "wgl"


# ---------------------------------------------------------------------------
# The fake on the port's codec
# ---------------------------------------------------------------------------

def test_port_fake_serves_on_the_ports_codec(recorded):
    """tests/fake_torch_hazelcast.py (what chip_smoke.py loads) answers
    the same bytes as tests/fake_hazelcast.py, through the port's codec,
    leaving every `jepsen_tpu` entry of `sys.modules` as it was."""
    import fake_torch_hazelcast
    assert fake_torch_hazelcast._impl.hz is port_hz
    assert sys.modules["jepsen_tpu.drivers"] is ref_drivers
    assert sys.modules["jepsen_tpu.drivers.hazelcast_proto"] is ref_hz
    got = {}
    for which, fake in (("ref", FakeHazelcastServer),
                        ("port", PortFakeHazelcast)):
        with fake() as srv:
            got[which] = hazelcast_session(PORT, srv.port)
    assert got["port"] == got["ref"]
    r1, r2, p1, p2 = recorded
    for ref_sock, port_sock in ((r1, p1), (r2, p2)):
        assert bytes(port_sock.sent) == bytes(ref_sock.sent)
        assert bytes(port_sock.got) == bytes(ref_sock.got)
