"""The port's `aerospike` and `ignite` suites over their own wire drivers
(`drivers/aerospike_msg.py`, `drivers/ignite_thin.py`), against the
reference's.

- The reference's own cases (tests/test_ignite_aerospike_clients.py and
  the aerospike and ignite cases of tests/test_template_suites.py) on
  the port's copies, against the fakes on the port's codecs
  (tests/fake_torch_aerospike.py, tests/fake_torch_ignite.py).
- The drivers byte for byte: the bytes a session sends and receives
  against the fakes, the record digests over seeded keys, and each
  package's reading of scripted replies: the same values, and the same
  `DBError` or `DriverError`, with the same `is_retriable`, on a wire
  fault.
- The clients op for op against the fakes, a refused connection
  included.
- The test maps, workload menus, generators (under a seeded `random`)
  and the DB setup and teardown commands on a dummy remote.
- End to end: each suite's own `main(["test", "--dummy", "--node",
  "127.0.0.1", "--device", "cpu", ...])` against its fake, the client
  class's port set to the fake's; both packages' `analyze --backend
  cpu` of the stored run, in turn on one path, give the same results
  (per key for registers) and the same files.
"""

import copy
import hashlib
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
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.suites.aerospike as ref_aerospike
import jepsen_tpu.suites.ignite as ref_ignite
from jepsen_tpu import drivers as ref_drivers
from jepsen_tpu.drivers import aerospike_msg as ref_asp
from jepsen_tpu.drivers import ignite_thin as ref_ig
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.suites as port_suites
import jepsen_tpu_torch.suites.aerospike as port_aerospike
import jepsen_tpu_torch.suites.ignite as port_ignite
from jepsen_tpu_torch import core as port_core
from jepsen_tpu_torch import drivers as port_drivers
from jepsen_tpu_torch.drivers import aerospike_msg as port_asp
from jepsen_tpu_torch.drivers import ignite_thin as port_ig
from jepsen_tpu_torch.store import Store as PortStore

from fake_aerospike import FakeAerospikeServer
from fake_ignite import FakeIgniteServer
from fake_torch_aerospike import FakeAerospikeServer as PortFakeAerospike
from fake_torch_ignite import FakeIgniteServer as PortFakeIgnite
from test_torch_baseline_suites import (map_shape, no_threads_left,
                                        per_key, plain, recheck_in_turn,
                                        run_main, same_recheck)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_generator import perfect, simulate
from test_torch_more_suites import recorded, scripted_server  # noqa: F401
from test_torch_queue_suites import outcome, peer_got, wired

REF = dict(ind=ref_ind, gen=ref_gen, control=ref_control,
           drivers=ref_drivers, asp=ref_asp, ig=ref_ig,
           aerospike=ref_aerospike, ignite=ref_ignite)
PORT = dict(ind=port_ind, gen=port_gen, control=port_control,
            drivers=port_drivers, asp=port_asp, ig=port_ig,
            aerospike=port_aerospike, ignite=port_ignite)
PKGS = (("ref", REF), ("port", PORT))

#: The suites of this file, each with its `<db>_test` and the client
#: class whose `port` class attribute every client connects to.
SUITES = {"aerospike": ("aerospike_test", "_AsClient"),
          "ignite": ("ignite_test", "_IgClient")}


# ---------------------------------------------------------------------------
# The reference's cases on the port's copies
# ---------------------------------------------------------------------------

@pytest.fixture()
def igsrv():
    with PortFakeIgnite() as s:
        yield s


@pytest.fixture()
def assrv():
    with PortFakeAerospike() as s:
        yield s


def test_java_hash_matches_jvm():
    # golden values from java.lang.String#hashCode (31*h + c, int32)
    assert port_ig.java_hash("jepsen") == -1163551321
    assert port_ig.java_hash("") == 0
    assert port_ig.java_hash("a") == 97


def test_ignite_cache_ops(igsrv):
    c = port_ig.IgniteConn("127.0.0.1", igsrv.port)
    c.get_or_create_cache("jepsen")
    assert c.get("jepsen", "k") is None
    c.put("jepsen", "k", 5)
    assert c.get("jepsen", "k") == 5
    assert c.put_if_absent("jepsen", "k", 9) is False
    assert c.put_if_absent("jepsen", "k2", 9) is True
    assert c.replace_if_equals("jepsen", "k", 5, 6) is True
    assert c.replace_if_equals("jepsen", "k", 5, 7) is False
    assert c.get_and_put("jepsen", "k", 8) == 6
    c.close()


def test_ignite_transactions(igsrv):
    c = port_ig.IgniteConn("127.0.0.1", igsrv.port)
    c.put("jepsen", "a", 50)
    c.put("jepsen", "b", 50)
    tx = c.tx_start()
    a = c.get("jepsen", "a", tx=tx)
    c.put("jepsen", "a", a - 10, tx=tx)
    c.put("jepsen", "b", 60, tx=tx)
    c.tx_end(tx, True)
    assert c.get("jepsen", "a") == 40
    assert c.get("jepsen", "b") == 60
    tx = c.tx_start()
    c.put("jepsen", "a", 0, tx=tx)
    c.tx_end(tx, False)  # rollback
    assert c.get("jepsen", "a") == 40
    c.close()


def test_ignite_register_client(igsrv):
    c = port_ignite.IgniteRegisterClient(port=igsrv.port).open(
        {}, "127.0.0.1")
    kv = port_ind.tuple_
    assert c.invoke({}, {"f": "write", "value": kv(1, 3)})["type"] == "ok"
    out = c.invoke({}, {"f": "read", "value": kv(1, None)})
    assert out["type"] == "ok" and out["value"].value == 3
    assert c.invoke({}, {"f": "cas",
                         "value": kv(1, [3, 4])})["type"] == "ok"
    assert c.invoke({}, {"f": "cas",
                         "value": kv(1, [3, 5])})["type"] == "fail"


def test_ignite_bank_run(tmp_path, igsrv, monkeypatch):
    monkeypatch.setattr(port_ignite._IgClient, "port", igsrv.port)
    t = port_ignite.ignite_test({"workload": "bank", "time-limit": 2,
                                 "nodes": ["127.0.0.1"], "concurrency": 3,
                                 "ssh": {"dummy": True}})
    t["nemesis"] = None
    wl = port_ignite.workloads()["bank"]()
    t["generator"] = port_gen.time_limit(2, port_gen.clients(
        wl["generator"]))
    t["store"] = PortStore(tmp_path / "store")
    t = port_core.run(t)
    assert t["results"]["valid?"] is True
    reads = [o for o in t["history"]
             if o.get("type") == "ok" and o.get("f") == "read"]
    assert reads and all(sum(r["value"].values()) == 100 for r in reads)


def test_aerospike_info_and_records(assrv):
    c = port_asp.AsConn("127.0.0.1", assrv.port)
    assert "status" in c.info(["status"])
    assert c.get(1) is None
    c.put(1, {"value": 7})
    rec = c.get(1)
    assert rec["bins"]["value"] == 7 and rec["generation"] == 1
    c.put(1, {"value": 8}, generation=1)
    assert c.get(1)["bins"]["value"] == 8
    with pytest.raises(port_asp.AerospikeError) as ei:
        c.put(1, {"value": 9}, generation=1)  # stale generation
    assert ei.value.code == port_asp.RESULT_GENERATION
    c.add(1, "n", 5)
    c.add(1, "n", 2)
    assert c.get(1)["bins"]["n"] == 7
    c.close()


def test_aerospike_create_only(assrv):
    c = port_asp.AsConn("127.0.0.1", assrv.port)
    c.put(2, {"value": 1}, create_only=True)
    with pytest.raises(port_asp.AerospikeError):
        c.put(2, {"value": 2}, create_only=True)
    c.close()


def test_aerospike_cas_client(assrv):
    kv = port_ind.tuple_
    a = port_aerospike.AerospikeCasClient(port=assrv.port).open(
        {}, "127.0.0.1")
    b = port_aerospike.AerospikeCasClient(port=assrv.port).open(
        {}, "127.0.0.1")
    assert a.invoke({}, {"f": "write", "value": kv(1, 3)})["type"] == "ok"
    assert a.invoke({}, {"f": "cas", "value": kv(1, [3, 4])})["type"] == "ok"
    assert b.invoke({}, {"f": "cas", "value": kv(1, [3, 5])})["type"] == \
        "fail"
    out = b.invoke({}, {"f": "read", "value": kv(1, None)})
    assert out["type"] == "ok" and out["value"].value == 4


def test_aerospike_counter_run(tmp_path, assrv, monkeypatch):
    monkeypatch.setattr(port_aerospike._AsClient, "port", assrv.port)
    t = port_aerospike.aerospike_test({
        "workload": "counter", "time-limit": 2,
        "nodes": ["127.0.0.1"], "concurrency": 3,
        "ssh": {"dummy": True}})
    t["nemesis"] = None
    wl = port_aerospike.workloads()["counter"]()
    t["generator"] = port_gen.time_limit(2, port_gen.clients(
        wl["generator"]))
    t["store"] = PortStore(tmp_path / "store")
    t = port_core.run(t)
    assert t["results"]["valid?"] is True


def test_default_clients_wired():
    t1 = port_ignite.ignite_test({"time-limit": 1})
    t2 = port_aerospike.aerospike_test({"time-limit": 1})
    assert t1["client"] is not None
    assert t2["client"] is not None


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_db_setup_against_dummy_remote(suite):
    test = getattr(PORT[suite], SUITES[suite][0])({"ssh": {"dummy": True}})
    port_control.on_nodes(test, lambda t, n: t["db"].setup(t, n))
    cmds = "\n".join(str(p) for _n, kind, p in test["remote"].actions
                     if kind in ("execute", "upload"))
    assert suite in cmds


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_suite_has_cli_and_workloads(suite):
    assert callable(PORT[suite].main)
    assert PORT[suite].workloads()


def test_aerospike_spec_is_the_references_copy():
    """tests/test_template_suites.py's spec case, on the port's copy,
    which holds the reference's bytes."""
    spec = Path(port_suites.__file__).parent / "specs" / "aerospike.tla"
    text = spec.read_text()
    assert "NoLostAckedWrites" in text and "MODULE aerospike" in text
    ref = Path(ref_aerospike.__file__).parent / "specs" / "aerospike.tla"
    assert spec.read_bytes() == ref.read_bytes()


# ---------------------------------------------------------------------------
# The aerospike driver byte for byte
# ---------------------------------------------------------------------------

def digest_keys(seed: int) -> list:
    rng = random.Random(seed)
    keys = [0, -1, 1, 2 ** 63 - 1, -2 ** 63, "", "counter", "héllo"]
    keys += [rng.randrange(-2 ** 63, 2 ** 63) for _ in range(100)]
    keys += ["".join(chr(rng.randrange(32, 0x3000))
                     for _ in range(rng.randrange(0, 40)))
             for _ in range(100)]
    return keys


@pytest.mark.parametrize("seed", range(3))
def test_key_digests_equal_the_references_and_hashlibs(seed):
    """`key_digest` over seeded int and str keys and set names: the
    reference's bytes, and RIPEMD-160 of the set name and the
    particle-typed key as `hashlib` computes it."""
    for set_name in ("jepsen", "", "s-" + str(seed)):
        for k in digest_keys(seed):
            got = port_asp.key_digest(set_name, k)
            assert got == ref_asp.key_digest(set_name, k)
            kb = (b"\x01" + struct.pack(">q", k) if isinstance(k, int)
                  else b"\x03" + k.encode())
            h = hashlib.new("ripemd160")
            h.update(set_name.encode() + kb)
            assert got == h.digest() and len(got) == 20


def aerospike_session(P, port: int) -> list:
    c = P["asp"].AsConn("127.0.0.1", port)
    steps = [
        lambda: c.info(["status", "build"]),
        lambda: c.get(1),
        lambda: c.put(1, {"value": 7}),
        lambda: c.get(1),
        lambda: c.put(1, {"value": 8}, generation=1),
        lambda: c.put(1, {"value": 9}, generation=1),
        lambda: c.put("k", {"s": "héllo", "n": -3}, create_only=True),
        lambda: c.put("k", {"s": "x"}, create_only=True),
        lambda: c.get("k"),
        lambda: c.add("counter", "value", 5),
        lambda: c.add("counter", "value", -2),
        lambda: c.get("counter"),
    ]
    out = [outcome(P, f) for f in steps]
    c.close()
    out.append(outcome(P, lambda: c.get(1)))
    return out


def test_aerospike_session_bytes_and_replies_equal_the_references(
        recorded):
    """The message-protocol bytes each package's driver sends, the
    fake's reply bytes, and what each package makes of them: equal, the
    generation conflict, the create-only conflict and the closed
    connection included."""
    got = {}
    for name, P in PKGS:
        with FakeAerospikeServer() as srv:
            got[name] = aerospike_session(P, srv.port)
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("ok", {"status": "ok", "build": "ok"})
    assert got["port"][1] == ("ok", None)
    assert got["port"][5] == ("db-error", 3, "put: 3", False)
    assert got["port"][7] == ("db-error", 5, "put: 5", False)
    assert got["port"][8][1]["bins"] == {"s": "héllo", "n": -3}
    assert got["port"][11][1] == {"bins": {"value": 3}, "generation": 2}
    assert got["port"][-1][0] == "driver-error"


def as_reply(result: int, gen: int = 0, bins: dict | None = None,
             ver: int = 2, typ: int = 3) -> bytes:
    ops = [ref_asp._op(1, n, v) for n, v in (bins or {}).items()]
    pkt = ref_asp.pack_message(0, 0, gen, [], ops, result=result)
    word = (ver << 56) | (typ << 48) | (len(pkt) - 8)
    return struct.pack(">Q", word) + pkt[8:]


#: scripted replies -> what a `get` then an `add` read from them
AS_REPLIES = {
    "ok-get-then-ok-add": as_reply(0, 4, {"value": 9, "s": "x"}) +
    as_reply(0, 5),
    "not-found-then-error": as_reply(2) + as_reply(4),
    "generation-mismatch": as_reply(3) + as_reply(3),
    "bad-version": as_reply(0, ver=1),
    "info-type-for-a-message": as_reply(0, typ=1),
    "unknown-particle": as_reply(0, 1, {"v": None}),
    "truncated-body": as_reply(0, 1, {"value": 7})[:20],
    "short-header": b"\x02\x03\x00",
    "eof": b"",
}


@pytest.mark.parametrize("reply", sorted(AS_REPLIES))
def test_aerospike_replies_and_wire_faults_as_the_references(reply):
    """Each package's reading of the same scripted replies: the same
    records, the same AerospikeError or DriverError (with the same
    `is_retriable`), and the same request bytes."""
    got = {}
    for name, P in PKGS:
        with wired(P["asp"].AsConn, AS_REPLIES[reply],
                   lock=threading.Lock(), namespace="jepsen",
                   set_name="jepsen") as (c, peer):
            out = [outcome(P, lambda: c.get(1)),
                   outcome(P, lambda: c.add("counter", "value", 2))]
            got[name] = (out, peer_got(peer))
    assert got["port"] == got["ref"]
    if reply == "ok-get-then-ok-add":
        assert got["port"][0] == [
            ("ok", {"bins": {"value": 9, "s": "x"}, "generation": 4}),
            ("ok", None)]
    if reply in ("bad-version", "info-type-for-a-message"):
        assert got["port"][0][0][0] == "driver-error"
        assert "bad proto header" in got["port"][0][0][1]


def test_aerospike_refused_connection_as_the_references():
    got = [outcome(P, lambda: P["asp"].AsConn("127.0.0.1", 1))
           for _name, P in PKGS]
    assert got[0] == got[1]
    assert got[0][0] == "driver-error" and got[0][2] is False


# ---------------------------------------------------------------------------
# The ignite driver byte for byte
# ---------------------------------------------------------------------------

def ignite_session(P, port: int) -> list:
    c = P["ig"].IgniteConn("127.0.0.1", port)
    steps = [
        lambda: c.get_or_create_cache("jepsen"),
        lambda: c.get("jepsen", "k"),
        lambda: c.put("jepsen", "k", 5),
        lambda: c.put("jepsen", "s", "héllo"),
        lambda: c.get("jepsen", "s"),
        lambda: c.put_if_absent("jepsen", "k", 9),
        lambda: c.replace_if_equals("jepsen", "k", 5, True),
        lambda: c.get_and_put("jepsen", "k", None),
        lambda: c.tx_start(),
        lambda: c.get("jepsen", "k", tx=1),
        lambda: c.put("jepsen", "k", -7, tx=1),
        lambda: c.tx_end(1, True),
        lambda: c.get("jepsen", "k"),
        lambda: c.get_and_put("jepsen", "k", 3),    # not transactional
        lambda: c.put("jepsen", "k", 1.5),         # unserializable
    ]
    out = [outcome(P, f) for f in steps]
    c.close()
    out.append(outcome(P, lambda: c.get("jepsen", "k")))
    return out


def test_ignite_session_bytes_and_replies_equal_the_references(recorded):
    """The handshake and thin-client request bytes, the fake's reply
    bytes and each package's reading of them: equal, the server's error
    status and an unserializable value included."""
    got = {}
    for name, P in PKGS:
        with FakeIgniteServer() as srv:
            got[name] = ignite_session(P, srv.port)
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
    assert got["port"] == got["ref"]
    assert got["port"][4] == ("ok", "héllo")
    assert got["port"][5] == ("ok", False)
    assert got["port"][6] == ("ok", True)
    assert got["port"][12] == ("ok", -7)
    assert got["port"][14][0] == "driver-error"
    assert got["port"][-1][0] == "driver-error"


def ig_packet(body: bytes) -> bytes:
    return struct.pack("<i", len(body)) + body


def ig_reply(rid: int, status: int = 0, payload: bytes = b"") -> bytes:
    return ig_packet(struct.pack("<qi", rid, status) + payload)


HANDSHAKE_OK = ig_packet(b"\x01")

#: scripted replies after the handshake -> what a `get` and a `put` read
IG_REPLIES = {
    "ok": HANDSHAKE_OK + ig_reply(1, 0, ref_ig.ser(42)) + ig_reply(2),
    "error-status": HANDSHAKE_OK + ig_reply(1, 7, ref_ig.ser("boom")) +
    ig_reply(2, 9),
    "id-mismatch": HANDSHAKE_OK + ig_reply(5, 0, ref_ig.ser(1)),
    "unknown-type": HANDSHAKE_OK + ig_reply(1, 0, b"\x63"),
    "truncated": HANDSHAKE_OK + ig_packet(struct.pack("<q", 1) + b"\0"),
    "eof": HANDSHAKE_OK,
}


@pytest.mark.parametrize("reply", sorted(IG_REPLIES))
def test_ignite_replies_and_wire_faults_as_the_references(reply):
    got = {}
    for name, P in PKGS:
        import itertools
        with wired(P["ig"].IgniteConn, IG_REPLIES[reply],
                   lock=threading.Lock(),
                   req_id=itertools.count(1)) as (c, peer):
            out = [outcome(P, c._handshake),
                   outcome(P, lambda: c.get("jepsen", "k")),
                   outcome(P, lambda: c.put("jepsen", "k", 2))]
            got[name] = (out, peer_got(peer))
    assert got["port"] == got["ref"]
    if reply == "ok":
        assert got["port"][0] == [("ok", None), ("ok", 42), ("ok", None)]
    if reply == "error-status":
        assert got["port"][0][1] == ("db-error", 7, "boom", False)


def test_ignite_refused_handshake_as_the_references():
    """A server that refuses the handshake (its version and message), a
    refused connection: the same DBError and DriverError."""
    refusal = ig_packet(b"\x00" + struct.pack("<hhh", 1, 2, 0) +
                        ref_ig.ser("too old"))
    got = {}
    for name, P in PKGS:
        with scripted_server([refusal]) as port:
            out = [outcome(P, lambda: P["ig"].IgniteConn("127.0.0.1",
                                                         port))]
        out.append(outcome(P, lambda: P["ig"].IgniteConn("127.0.0.1", 1)))
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("db-error", "handshake",
                              "server (1, 2, 0): too old", False)
    assert got["port"][1][0] == "driver-error"


# ---------------------------------------------------------------------------
# The clients op for op
# ---------------------------------------------------------------------------

def invoke_ops(P, client, ops) -> list:
    out = [plain(client.invoke({}, {"type": "invoke", "f": f, "value": v,
                                    "process": 0}))
           for f, v in ops]
    client.close({})
    return out


def register_ops(kv) -> list:
    return [("read", kv(1, None)), ("write", kv(1, 3)),
            ("read", kv(1, None)), ("cas", kv(1, [3, 4])),
            ("cas", kv(1, [3, 5])), ("cas", kv(2, [None, 1])),
            ("cas", kv(2, [None, 2])), ("read", kv(2, None)),
            ("write", kv(3, 0)), ("cas", kv(3, [0, 2])),
            ("frob", kv(3, None))]


@pytest.mark.parametrize("suite,cls", [
    ("aerospike", "AerospikeCasClient"), ("ignite", "IgniteRegisterClient")])
def test_register_clients_op_for_op_with_the_references(suite, cls):
    fake = {"aerospike": FakeAerospikeServer,
            "ignite": FakeIgniteServer}[suite]
    got = {}
    for name, P in PKGS:
        with fake() as srv:
            c = getattr(P[suite], cls)(port=srv.port).open({}, "127.0.0.1")
            got[name] = invoke_ops(P, c, register_ops(P["ind"].tuple_))
        # the server gone: reads fail, writes are indeterminate
        got[name + "-gone"] = invoke_ops(P, c, [
            ("read", P["ind"].tuple_(1, None)),
            ("write", P["ind"].tuple_(1, 2))])
    assert got["port"] == got["ref"]
    assert got["port-gone"] == got["ref-gone"]
    assert [o["type"] for o in got["port-gone"]] == ["fail", "info"]
    assert got["port"][2]["value"] == ["tuple", 1, 3]
    assert [o["type"] for o in got["port"][3:5]] == ["ok", "fail"]


def test_aerospike_counter_client_op_for_op_with_the_references():
    got = {}
    for name, P in PKGS:
        with FakeAerospikeServer() as srv:
            c = P["aerospike"].AerospikeCounterClient(port=srv.port).open(
                {}, "127.0.0.1")
            got[name] = invoke_ops(P, c, [
                ("read", None), ("add", 3), ("add", 2), ("read", None),
                ("frob", None)])
    assert got["port"] == got["ref"]
    assert got["port"][3]["value"] == 5


def test_aerospike_cas_race_as_the_reference():
    """Another writer bumps the generation between the cas's read and its
    write: the cas fails as generation-mismatch in both packages."""
    got = {}
    for name, P in PKGS:
        with FakeAerospikeServer() as srv:
            c = P["aerospike"].AerospikeCasClient(port=srv.port).open(
                {}, "127.0.0.1")
            other = P["asp"].AsConn("127.0.0.1", srv.port)
            c.invoke({}, {"f": "write", "value": P["ind"].tuple_(1, 3)})
            real = c.conn.get

            def racing_get(k, real=real, other=other):
                out = real(k)
                other.put(k, {"value": 3})
                return out

            c.conn.get = racing_get
            got[name] = plain(c.invoke({}, {
                "f": "cas", "value": P["ind"].tuple_(1, [3, 4])}))
            other.close()
            c.close({})
    assert got["port"] == got["ref"]
    assert got["port"]["error"] == "generation-mismatch"


def test_ignite_bank_client_op_for_op_with_the_references():
    """Reads and transfers inside transactions, the insufficient-balance
    rollback and an unknown f, then the server gone mid-transfer."""
    got = {}
    for name, P in PKGS:
        with FakeIgniteServer() as srv:
            c = P["ignite"].IgniteBankClient(port=srv.port).open(
                {}, "127.0.0.1")
            ops = [("read", None),
                   ("transfer", {"from": 0, "to": 3, "amount": 5}),
                   ("transfer", {"from": 3, "to": 0, "amount": 99}),
                   ("transfer", {"from": 1, "to": 2, "amount": 1}),
                   ("read", None), ("frob", None)]
            got[name] = invoke_ops(P, c, ops)
        got[name + "-gone"] = invoke_ops(P, c, [
            ("read", None), ("transfer", {"from": 0, "to": 1,
                                          "amount": 1})])
    assert got["port"] == got["ref"]
    assert got["port-gone"] == got["ref-gone"]
    assert got["port"][2]["error"] == "insufficient"
    assert sum(got["port"][4]["value"].values()) == 100
    assert [o["type"] for o in got["port-gone"]] == ["fail", "info"]


# ---------------------------------------------------------------------------
# Generators, test maps, DB commands
# ---------------------------------------------------------------------------

GENERATORS = {
    f"{suite}-{w}": (lambda P, s=suite, w=w: P[s].workloads({})[w]()[
        "generator"])
    for suite in SUITES for w in sorted(REF[suite].workloads({}))}


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_generators_draw_as_the_references(which):
    """Each workload's ops under the same `random` seed, through the
    generator simulation: op for op the reference's (the counter's adds
    draw from the global `random`)."""
    got = {}
    for name, P in PKGS:
        random.seed(22)
        g = P["gen"].limit(300, GENERATORS[which](P))
        got[name] = plain(simulate(P["gen"], g, perfect, concurrency=10))
    assert got["port"] == got["ref"]
    assert [o for o in got["port"] if o["type"] == "invoke"]


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_whole_test_generators_draw_as_the_references(suite):
    got = {}
    for name, P in PKGS:
        random.seed(4)
        t = getattr(P[suite], SUITES[suite][0])(
            {"time-limit": 1, "nemesis-interval": 0.25})
        got[name] = plain(simulate(P["gen"], t["generator"], perfect,
                                   concurrency=4))
    assert got["port"] == got["ref"]
    assert [o for o in got["port"] if o["process"] == "nemesis"]


MAP_OPTS = ({}, {"time-limit": 1}, {"device": "cpu"},
            {"faults": ["partition", "kill"]}, {"version": "9.9"},
            {"nodes": ["127.0.0.1"], "concurrency": 3})


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_test_maps_and_menus_equal_the_references(suite):
    menu = sorted(PORT[suite].workloads({}))
    assert menu == sorted(REF[suite].workloads({}))
    assert menu == sorted(PORT[suite].workloads())
    make = SUITES[suite][0]
    for opts in [{"workload": w, **o} for w in menu for o in MAP_OPTS]:
        ref = getattr(REF[suite], make)(copy.deepcopy(opts))
        port = getattr(PORT[suite], make)(copy.deepcopy(opts))
        assert map_shape(port) == map_shape(ref), opts
        assert port.get("nodes") == ref.get("nodes")
        assert port["db"].version == ref["db"].version
        assert getattr(port.get("client"), "port", None) == getattr(
            ref.get("client"), "port", None)
    for cls in ("_AsClient", "_IgClient"):
        mod = "aerospike" if cls == "_AsClient" else "ignite"
        assert getattr(PORT[mod], cls).port == getattr(REF[mod], cls).port


@pytest.mark.parametrize("suite,device", [
    (s, d) for s in sorted(SUITES) for d in (None, "cpu")])
def test_register_checkers_take_the_device(suite, device):
    """`standard_workloads`' register: `linearizable` of a fresh CAS
    register, on opts' device (None: cuda)."""
    t = getattr(PORT[suite], SUITES[suite][0])(
        {"workload": "register", **({"device": device} if device else {})})
    lin = t["checker"].sub
    assert type(lin).__name__ == "Linearizable" and lin.device == device
    assert type(lin.model).__name__ == "CASRegister"


def db_commands(P, suite: str, nodes: list) -> list:
    test = getattr(P[suite], SUITES[suite][0])(
        {"ssh": {"dummy": True}, "nodes": nodes})

    def lifecycle(t, n):
        t["os"].setup(t, n)
        t["db"].setup(t, n)
        t["db"].teardown(t, n)

    P["control"].on_nodes(test, lifecycle)
    return sorted((n, k, str(p)) for n, k, p in test["remote"].actions)


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_db_setup_commands_as_the_references(suite):
    nodes = ["n1", "n2", "n3"]
    port = db_commands(PORT, suite, nodes)
    assert port == db_commands(REF, suite, nodes)
    assert any(suite in p for _n, k, p in port if k == "execute")
    for P in (REF, PORT):
        db = getattr(P[suite], SUITES[suite][0])({})["db"]
        assert db.log_files({}, "n1") == [REF[suite].LOGFILE]


# ---------------------------------------------------------------------------
# End to end through each suite's main
# ---------------------------------------------------------------------------

#: name -> (suite, the port's fake, --workload)
RUNS = {
    "aerospike-register": ("aerospike", PortFakeAerospike, "register"),
    "aerospike-counter": ("aerospike", PortFakeAerospike, "counter"),
    "ignite-register": ("ignite", PortFakeIgnite, "register"),
    "ignite-bank": ("ignite", PortFakeIgnite, "bank"),
}


def main_run(which: str, tmp_path: Path, monkeypatch, device=("--device",
                                                              "cpu")):
    """The suite's own main on one node, 127.0.0.1, whose client class's
    port is the fake's; 2 s, the partitioner every 0.3 s. Returns (exit
    code, JSON lines, the remote)."""
    suite, fake, workload = RUNS[which]
    remote = port_control.DummyRemote()
    argv = ["test", "--dummy", "--node", "127.0.0.1", *device, "--store",
            str(tmp_path / "port"), "--concurrency", "4", "--workload",
            workload]
    with fake() as srv:
        monkeypatch.setattr(getattr(PORT[suite], SUITES[suite][1]), "port",
                            srv.port)
        rc, lines = run_main(
            monkeypatch, PORT[suite], SUITES[suite][0],
            {"time-limit": 2.0, "nemesis-interval": 0.3}, argv, remote)
    return rc, lines, remote


@pytest.mark.parametrize("which", sorted(RUNS))
def test_suite_main_equals_the_reference(which, tmp_path, reference_env,
                                         monkeypatch):
    """The suite's `main` (`test --dummy --node 127.0.0.1 --device cpu
    --workload W`) against its fake; the two packages' re-checks of the
    stored run, in turn on one path, give the same results (per key for
    registers) and files."""
    suite, _fake, workload = RUNS[which]
    before = set(threading.enumerate())
    rc, lines, remote = main_run(which, tmp_path, monkeypatch)
    assert no_workers_left() and no_threads_left(before)
    assert rc == 0 and len(lines) == 1 and lines[0]["valid?"] is True
    run = Path(lines[0]["dir"])
    res = json.loads((run / "results.json").read_text())
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    assert [o for o in hist if isinstance(o["process"], int)]
    nem = {o["f"] for o in hist if o["process"] == "nemesis"}
    assert nem <= {"start", "stop"} and "start" in nem
    stored = json.loads((run / "test.json").read_text())
    assert stored["device"] == "cpu" and stored["nodes"] == ["127.0.0.1"]
    out = recheck_in_turn(
        run, tmp_path,
        lambda P: getattr(P[suite], SUITES[suite][0])(
            {"workload": workload})["checker"],
        monkeypatch, pkgs=(REF, PORT))
    got = same_recheck(out)
    assert got["valid?"] is True and res["valid?"] is True
    if workload == "register":
        assert per_key(got) == per_key(res) and per_key(res)
        assert all(v is True for v in per_key(res).values())
    if workload == "bank":
        assert res["bank"]["valid?"] is True
        assert res["bank"]["bad-read-count"] == 0
    if workload == "counter":
        assert res["valid?"] is True and res["reads"]


@pytest.mark.parametrize("which", ["aerospike-register", "ignite-register"])
def test_suite_main_without_a_card_exits_255(which, tmp_path, monkeypatch,
                                             capsys):
    """Without --device the register checker is the device path: no
    card here, so DeviceUnavailable and exit 255, the history stored and
    no verdict."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, _ = main_run(which, tmp_path, monkeypatch, device=())
    assert rc == 255 and not lines
    assert "no CUDA device is available" in capsys.readouterr().err
    runs = [p.parent for p in (tmp_path / "port").rglob("history.jsonl")]
    assert len(runs) == 1 and not (runs[0] / "results.json").exists()


# ---------------------------------------------------------------------------
# The fakes on the port's codecs
# ---------------------------------------------------------------------------

#: suite -> (its wrapper's name, the codec's key in REF and PORT, the
#: session, the reference's fake, the port's)
PORT_FAKES = {
    "aerospike": ("fake_torch_aerospike", "asp", aerospike_session,
                  FakeAerospikeServer, PortFakeAerospike),
    "ignite": ("fake_torch_ignite", "ig", ignite_session, FakeIgniteServer,
               PortFakeIgnite)}


@pytest.mark.parametrize("suite", sorted(PORT_FAKES))
def test_port_fakes_serve_on_the_ports_codecs(suite, recorded):
    """tests/fake_torch_aerospike.py and fake_torch_ignite.py (what
    chip_smoke.py loads) answer the same bytes as the reference's fakes,
    through the port's codec, leaving every `jepsen_tpu` entry of
    `sys.modules` as it was."""
    import importlib
    wrapper, codec, session, ref_fake, port_fake = PORT_FAKES[suite]
    assert getattr(importlib.import_module(wrapper)._impl, codec) is \
        PORT[codec]
    assert sys.modules["jepsen_tpu.drivers"] is ref_drivers
    assert sys.modules[REF[codec].__name__] is REF[codec]
    got = {}
    for which, fake in (("ref", ref_fake), ("port", port_fake)):
        with fake() as srv:
            got[which] = session(PORT, srv.port)
    assert got["port"] == got["ref"]
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
