"""The port's mongodb family (`mongodb`, `mongodb_rocks`,
`mongodb_smartos`), `zookeeper` and `consul` over their own wire
drivers (`drivers/mongo.py`, `drivers/zk.py`, consul's urllib client),
and the SQL suites that ride the ported SQL layer (`galera`, `percona`,
`mysql_cluster`, `postgres_rds`) with the `dirty_reads` workload,
against the reference's.

- The drivers byte for byte: BSON over seeded documents, the OP_MSG
  and jute bytes a session sends and receives, and each package's
  decoder on the fakes' replies; errors included.
- The clients op for op against `FakeMongoServer`, `FakeZKServer` and
  `FakeConsulServer`: the same completions, errors and races included.
- `DirtyReadsChecker`'s verdicts and counts on seeded histories.
- The test maps, workload menus, generators (under a seeded `random`)
  and DB setup commands on a dummy remote as the reference's.
- End to end: each suite's own `main(["test", "--dummy", "--device",
  "cpu", ...])` against its fake, the history stored; both packages'
  `analyze --backend cpu` of the stored run, in turn on one path, give
  the same results (per key for registers) and the same files.
"""

import contextlib
import copy
import json
import random
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

import jepsen_tpu.control as ref_control
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.suites as ref_suites
import jepsen_tpu.suites.consul as ref_consul
import jepsen_tpu.suites.galera as ref_galera
import jepsen_tpu.suites.mongodb as ref_mongodb
import jepsen_tpu.suites.mongodb_rocks as ref_mongodb_rocks
import jepsen_tpu.suites.mongodb_smartos as ref_mongodb_smartos
import jepsen_tpu.suites.mysql_cluster as ref_mysql_cluster
import jepsen_tpu.suites.percona as ref_percona
import jepsen_tpu.suites.postgres_rds as ref_postgres_rds
import jepsen_tpu.suites.zookeeper as ref_zookeeper
from jepsen_tpu.drivers import DBError as RefDBError
from jepsen_tpu.drivers import DriverError as RefDriverError
from jepsen_tpu.drivers import mongo as ref_mongo
from jepsen_tpu.drivers import zk as ref_zk
from jepsen_tpu.workloads import dirty_reads as ref_dirty_reads
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.suites as port_suites
import jepsen_tpu_torch.suites.consul as port_consul
import jepsen_tpu_torch.suites.galera as port_galera
import jepsen_tpu_torch.suites.mongodb as port_mongodb
import jepsen_tpu_torch.suites.mongodb_rocks as port_mongodb_rocks
import jepsen_tpu_torch.suites.mongodb_smartos as port_mongodb_smartos
import jepsen_tpu_torch.suites.mysql_cluster as port_mysql_cluster
import jepsen_tpu_torch.suites.percona as port_percona
import jepsen_tpu_torch.suites.postgres_rds as port_postgres_rds
import jepsen_tpu_torch.suites.zookeeper as port_zookeeper
from jepsen_tpu_torch.drivers import DBError as PortDBError
from jepsen_tpu_torch.drivers import DriverError as PortDriverError
from jepsen_tpu_torch.drivers import mongo as port_mongo
from jepsen_tpu_torch.drivers import zk as port_zk
from jepsen_tpu_torch.workloads import dirty_reads as port_dirty_reads

from fake_misc import FakeConsulServer, FakeZKServer
from fake_mongo import FakeMongoServer
from fake_sql import FakeMySQLServer, FakePGServer
from fake_torch_mongo import FakeMongoServer as PortFakeMongoServer
from test_torch_baseline_suites import (fake_hosts, map_shape,
                                        no_threads_left, per_key, plain,
                                        recheck_in_turn, run_main,
                                        same_recheck)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_generator import perfect, simulate
from test_torch_plots import block_matplotlib

REF = dict(ind=ref_ind, gen=ref_gen, control=ref_control,
           suites=ref_suites, mongo=ref_mongo, zk=ref_zk,
           mongodb=ref_mongodb, mongodb_rocks=ref_mongodb_rocks,
           mongodb_smartos=ref_mongodb_smartos, zookeeper=ref_zookeeper,
           consul=ref_consul, galera=ref_galera, percona=ref_percona,
           mysql_cluster=ref_mysql_cluster, postgres_rds=ref_postgres_rds,
           dirty_reads=ref_dirty_reads, DBError=RefDBError,
           DriverError=RefDriverError)
PORT = dict(ind=port_ind, gen=port_gen, control=port_control,
            suites=port_suites, mongo=port_mongo, zk=port_zk,
            mongodb=port_mongodb, mongodb_rocks=port_mongodb_rocks,
            mongodb_smartos=port_mongodb_smartos, zookeeper=port_zookeeper,
            consul=port_consul, galera=port_galera, percona=port_percona,
            mysql_cluster=port_mysql_cluster,
            postgres_rds=port_postgres_rds, dirty_reads=port_dirty_reads,
            DBError=PortDBError, DriverError=PortDriverError)
PKGS = (("ref", REF), ("port", PORT))

#: The suites this slice ports, with each one's `<db>_test`.
SUITES = {"mongodb": "mongodb_test", "mongodb_rocks": "mongodb_rocks_test",
          "mongodb_smartos": "mongodb_smartos_test",
          "zookeeper": "zookeeper_test", "consul": "consul_test",
          "galera": "galera_test", "percona": "percona_test",
          "mysql_cluster": "mysql_cluster_test",
          "postgres_rds": "postgres_rds_test"}


def outcome(P, fn):
    """`fn()`'s value, or the driver error it raised, as plain data."""
    try:
        return ("ok", plain(fn()))
    except P["DBError"] as e:
        return ("db-error", e.code, e.message)
    except P["DriverError"] as e:
        return ("driver-error", str(e))
    except OSError as e:
        return ("os-error", type(e).__name__)


# ---------------------------------------------------------------------------
# BSON and OP_MSG
# ---------------------------------------------------------------------------

#: int32 and int64 edges: the encoder picks 0x10 inside int32, 0x12 out
INT_EDGES = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 2 ** 31, -2 ** 31 - 1,
             2 ** 40, -2 ** 40, 2 ** 63 - 1, -2 ** 63]
STRINGS = ["", "a", "héllo", "日本語", "emoji \U0001F600", "tab\tnl\n"]


def bson_value(rng, depth: int):
    """One seeded value of a type the encoder takes (nested docs,
    arrays and tuples, bool, int32/int64 edges, null, doubles, UTF-8
    strings, bytes)."""
    kinds = ["bool", "int", "float", "str", "none", "bytes"]
    if depth < 3:
        kinds += ["doc", "list", "tuple"]
    k = kinds[int(rng.integers(0, len(kinds)))]
    if k == "bool":
        return bool(rng.integers(0, 2))
    if k == "int":
        if rng.integers(0, 2):
            return INT_EDGES[int(rng.integers(0, len(INT_EDGES)))]
        return int(rng.integers(-2 ** 62, 2 ** 62))
    if k == "float":
        return [0.0, -0.0, 1.5, -2.25e300, float("inf"),
                float(rng.standard_normal())][int(rng.integers(0, 6))]
    if k == "str":
        return STRINGS[int(rng.integers(0, len(STRINGS)))]
    if k == "none":
        return None
    if k == "bytes":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 9)),
                                  dtype=np.uint8))
    if k == "doc":
        return bson_doc(rng, depth + 1)
    items = [bson_value(rng, depth + 1)
             for _ in range(int(rng.integers(0, 5)))]
    return items if k == "list" else tuple(items)


def bson_doc(rng, depth: int = 0) -> dict:
    n = int(rng.integers(0, 6))
    return {f"{STRINGS[i % len(STRINGS)]}k{i}": bson_value(rng, depth)
            for i in range(n)}


@pytest.mark.parametrize("seed", range(8))
def test_bson_bytes_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        doc = bson_doc(rng)
        enc = ref_mongo.encode_doc(doc)
        assert port_mongo.encode_doc(doc) == enc
        ref_out, ref_off = ref_mongo.decode_doc(enc)
        port_out, port_off = port_mongo.decode_doc(enc)
        assert port_off == ref_off == len(enc)
        assert repr(port_out) == repr(ref_out)


def test_bson_edges_as_the_references():
    """bool before int (True is no int32 1), the int32/int64 split at
    both ends, and the types only a server sends (ObjectId, datetime,
    timestamp, binary); an unknown type raises in both."""
    for v in (True, False, 1, 0):
        assert port_mongo.encode_doc({"v": v}) == ref_mongo.encode_doc(
            {"v": v})
    assert port_mongo.encode_doc({"v": True})[4] == 0x08
    assert port_mongo.encode_doc({"v": 1})[4] == 0x10
    for v, t in ((2 ** 31 - 1, 0x10), (-2 ** 31, 0x10), (2 ** 31, 0x12),
                 (-2 ** 31 - 1, 0x12)):
        assert port_mongo.encode_doc({"v": v})[4] == t
    body = (b"\x07oid\0" + bytes(range(12)) +
            b"\x09at\0" + struct.pack("<q", 1_700_000_000_000) +
            b"\x11ts\0" + struct.pack("<q", 7) +
            b"\x05bin\0" + struct.pack("<i", 3) + b"\x00abc")
    doc = struct.pack("<i", len(body) + 5) + body + b"\0"
    assert port_mongo.decode_doc(doc) == ref_mongo.decode_doc(doc)
    bad = b"\x13dec\0" + bytes(16)
    bad_doc = struct.pack("<i", len(bad) + 5) + bad + b"\0"
    for P in (REF, PORT):
        with pytest.raises(P["DriverError"], match="0x13"):
            P["mongo"].decode_doc(bad_doc)
        with pytest.raises(TypeError):
            P["mongo"].encode_doc({"s": {1, 2}})


class Recording:
    """A socket that keeps every byte sent and received."""

    def __init__(self, sock):
        self.sock, self.sent, self.got = sock, bytearray(), bytearray()

    def sendall(self, b):
        self.sent += b
        return self.sock.sendall(b)

    def recv(self, n):
        b = self.sock.recv(n)
        self.got += b
        return b

    def __getattr__(self, k):
        return getattr(self.sock, k)


@pytest.fixture
def recorded(monkeypatch):
    """Every `socket.create_connection` of the test returns a
    Recording; the list holds them in order."""
    socks: list = []
    real = socket.create_connection

    def conn(*a, **kw):
        s = Recording(real(*a, **kw))
        socks.append(s)
        return s

    monkeypatch.setattr(socket, "create_connection", conn)
    return socks


MAJ = {"w": "majority"}


def mongo_session(P, port: int) -> list:
    c = P["mongo"].connect("127.0.0.1", port, database="jepsen")
    steps = [
        lambda: c.insert("registers", [{"_id": 1, "value": 5}],
                         write_concern=MAJ),
        lambda: c.find("registers", {"_id": 1},
                       read_concern={"level": "majority"}),
        lambda: c.find_and_modify("registers", {"_id": 1, "value": 5},
                                  {"$set": {"value": 6}},
                                  write_concern=MAJ),
        lambda: c.find_and_modify("registers", {"_id": 1, "value": 5},
                                  {"$set": {"value": 9}}),
        lambda: c.find_and_modify("registers", {"_id": 2, "value": None},
                                  {"$set": {"value": 1}}, upsert=True),
        lambda: c.update("registers", {"_id": 3}, {"$set": {"value": 2}},
                         upsert=True, write_concern=MAJ),
        lambda: c.update("registers", {"_id": 4}, {"$set": {"value": 2}}),
        lambda: c.find("registers"),
        lambda: c.insert("registers", [{"_id": 1}]),   # writeErrors
        lambda: c.command({"bogus": 1}),               # ok: 0
        lambda: c.command({"replSetInitiate": {
            "_id": "jepsen", "members": [{"_id": 0, "host": "n1:27017"}]}}),
    ]
    out = [outcome(P, f) for f in steps]
    c.close()
    out.append(outcome(P, lambda: c.find("registers")))
    return out


def test_mongo_session_bytes_and_replies_equal_the_references(recorded):
    """The OP_MSG bytes each package's driver sends, the fake's reply
    bytes, and what each package makes of them: equal, the duplicate
    key, the unknown command and the closed connection included."""
    got = {}
    for name, P in PKGS:
        with FakeMongoServer() as srv:
            got[name] = mongo_session(P, srv.port)
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
    assert got["port"] == got["ref"]
    assert got["port"][1][1] == [{"_id": 1, "value": 5}]
    assert got["port"][3][1]["value"] is None
    assert got["port"][8] == ("db-error", "11000", "duplicate key")
    assert got["port"][9][:2] == ("db-error", "59")
    assert got["port"][-1] == ("driver-error", "connection is closed")


@contextlib.contextmanager
def scripted_server(replies: list):
    """A TCP server for one connection: after each read it sends the
    next reply of `replies`, then it closes."""
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        with conn:
            for r in replies:
                if not conn.recv(65536):
                    return
                conn.sendall(r)
            conn.recv(65536)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        yield lsock.getsockname()[1]
    finally:
        lsock.close()
        t.join(5)


def test_mongo_wire_faults_as_the_references():
    """A reply that is no OP_MSG, and a server that hangs up: the same
    DriverError in both packages; a refused connection raises
    OSError in both."""
    not_msg = struct.pack("<iiii", 16 + 5 + 5, 1, 1, 1) + b"\0" * 5 + \
        struct.pack("<i", 5) + b"\0"
    got = {}
    for name, P in PKGS:
        out = []
        for replies in ([not_msg], []):
            with scripted_server(replies) as port:
                c = P["mongo"].connect("127.0.0.1", port)
                out.append(outcome(P, lambda: c.find("x")))
                out.append(outcome(P, lambda: c.find("x")))
        out.append(outcome(P, lambda: P["mongo"].connect("127.0.0.1", 1)))
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("driver-error", "unexpected opcode 1")
    assert got["port"][1] == ("driver-error", "connection is closed")
    assert got["port"][2] == ("driver-error",
                              "connection closed by server")
    assert got["port"][4] == ("os-error", "ConnectionRefusedError")


# ---------------------------------------------------------------------------
# jute (ZooKeeper)
# ---------------------------------------------------------------------------

def zk_session(P, port: int) -> list:
    c = P["zk"].connect("127.0.0.1", port)

    def stat(x):
        if isinstance(x, tuple):
            return (x[0], x[1].version)
        return x.version

    steps = [
        lambda: c.create("/r1", b"5"),
        lambda: stat(c.get_data("/r1")),
        lambda: stat(c.set_data("/r1", b"6", version=0)),
        lambda: stat(c.set_data("/r1", b"7", version=0)),  # bad-version
        lambda: stat(c.set_data("/r1", b"8")),             # any version
        lambda: c.create("/r1", b"1"),                     # node-exists
        lambda: stat(c.get_data("/nope")),                 # no-node
        lambda: stat(c.set_data("/nope", b"1")),
        lambda: c.create("/e", None, ephemeral=True),      # null buffer
        lambda: stat(c.get_data("/e")),
        lambda: c.exists("/r1"),
        lambda: c.exists("/nope"),
        lambda: c.delete("/r1"),
        lambda: c.delete("/r1"),                           # no-node
        lambda: c.ping(),
    ]
    out = [c.session_id] + [outcome(P, f) for f in steps]
    c.close()
    out.append(outcome(P, lambda: c.get_data("/e")))
    out.append(outcome(P, lambda: c.ping()))
    return out


def test_zk_session_bytes_and_replies_equal_the_references(recorded):
    got = {}
    for name, P in PKGS:
        with FakeZKServer() as srv:
            got[name] = zk_session(P, srv.port)
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p[1] == ("ok", "/r1") and p[2] == ("ok", [b"5", 0])
    assert p[4] == ("db-error", "bad-version", "zookeeper error -103")
    assert p[6][:2] == ("db-error", "node-exists")
    assert p[7][:2] == ("db-error", "no-node")
    assert p[11:13] == [("ok", True), ("ok", False)]
    assert p[-2] == p[-1] == ("driver-error", "connection is closed")


def zk_packet(payload: bytes) -> bytes:
    return struct.pack("!i", len(payload)) + payload


def test_zk_wire_faults_as_the_references():
    """A rejected session (id 0), a watch event skipped before a reply
    with the wrong xid, a server that hangs up, and a refused
    connection: the same outcome in both packages."""
    handshake = struct.pack("!iiq", 0, 10000, 0x77) + \
        struct.pack("!i", 16) + b"\0" * 16
    rejected = struct.pack("!iiq", 0, 10000, 0) + \
        struct.pack("!i", 16) + b"\0" * 16
    event = struct.pack("!iqi", -1, 0, 0)
    wrong = struct.pack("!iqi", 9, 0, 0)
    got = {}
    for name, P in PKGS:
        out = []
        with scripted_server([zk_packet(rejected)]) as port:
            out.append(outcome(P, lambda: P["zk"].connect("127.0.0.1",
                                                          port)))
        with scripted_server([zk_packet(handshake),
                              zk_packet(event) + zk_packet(wrong)]) as port:
            c = P["zk"].connect("127.0.0.1", port)
            out.append(c.session_id)
            out.append(outcome(P, lambda: c.exists("/x")))
            out.append(outcome(P, lambda: c.exists("/x")))
        with scripted_server([]) as port:
            out.append(outcome(P, lambda: P["zk"].connect("127.0.0.1",
                                                          port)))
        out.append(outcome(P, lambda: P["zk"].connect("127.0.0.1", 1)))
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("driver-error", "zookeeper session rejected")
    assert got["port"][1] == 0x77
    assert got["port"][2] == ("driver-error", "xid mismatch: sent 1, got 9")
    assert got["port"][3] == ("driver-error", "connection is closed")
    assert got["port"][4] == ("driver-error", "connection closed by server")
    assert got["port"][5] == ("os-error", "ConnectionRefusedError")


# ---------------------------------------------------------------------------
# The clients
# ---------------------------------------------------------------------------

def register_ops(kv) -> list:
    """A register client's cases: a read of a missing key, writes, reads,
    a cas that applies, one whose compare fails, one on a missing key,
    an unlifted value, and an unknown f."""
    return [("read", kv(4, None)), ("write", kv(4, 7)),
            ("read", kv(4, None)), ("cas", kv(4, [7, 8])),
            ("cas", kv(4, [7, 9])), ("read", kv(4, None)),
            ("cas", kv(5, [0, 1])), ("write", kv(4, 2)),
            ("read", kv(4, None)), ("write", 3), ("read", None),
            ("cas", [3, 4]), ("read", None), ("frob", kv(4, None))]


def invoke_all(P, client, test, ops) -> list:
    out = [plain(client.invoke(test, {"type": "invoke", "f": f,
                                      "value": v, "process": 0}))
           for f, v in ops]
    client.close(test)
    return out


def refused(P, make_client) -> list:
    """A read and a write against a port nobody listens on: the read
    fails, the write is indeterminate."""
    test = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
    c = make_client(P).open(test, "n1")
    return invoke_all(P, c, test, [("read", P["ind"].tuple_(1, None)),
                                   ("write", P["ind"].tuple_(1, 2))])


def test_mongo_client_op_for_op_with_the_references():
    got = {}
    for name, P in PKGS:
        out = {}
        with FakeMongoServer() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            c = P["mongodb"].MongoClient("register").open(test, "n1")
            out["register"] = invoke_all(P, c, test,
                                         register_ops(P["ind"].tuple_))
            c = P["mongodb"].MongoClient("set").open(test, "n2")
            out["set"] = invoke_all(P, c, test, [
                ("add", 5), ("add", 2), ("add", 5), ("read", None),
                ("frob", None)])
        out["refused"] = refused(P, lambda P: P["mongodb"].MongoClient())
        got[name] = out
    assert got["port"] == got["ref"]
    reg = got["port"]["register"]
    assert [o["type"] for o in reg] == [
        "ok", "ok", "ok", "ok", "fail", "ok", "fail", "ok", "ok", "ok",
        "ok", "ok", "ok", "fail"]
    assert reg[0]["value"] == ["tuple", 4, None]
    assert reg[5]["value"] == ["tuple", 4, 8] and reg[12]["value"] == 4
    assert got["port"]["set"][2]["error"] == "mongo-11000: duplicate key"
    assert got["port"]["set"][3]["value"] == [2, 5]
    assert [o["type"] for o in got["port"]["refused"]] == ["fail", "info"]


def zk_race(P, client, test):
    """The client's next get_data returns a stat that another session
    makes stale before the guarded set_data."""
    client._ensure_conn(test)
    conn = client.conn
    real = conn.get_data

    def stale(path):
        out = real(path)
        conn.get_data = real
        other = P["zk"].connect(*test["db-hosts"]["n1"])
        other.set_data(path, out[0])
        other.close()
        return out

    conn.get_data = stale


def test_zk_client_op_for_op_with_the_references():
    """The register cases, then a cas whose znode version moves between
    its read and its guarded write (bad-version), and a refused
    connection."""
    got = {}
    for name, P in PKGS:
        out = {}
        with FakeZKServer() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            c = P["zookeeper"].ZKClient().open(test, "n1")
            out["register"] = invoke_all(P, c, test,
                                         register_ops(P["ind"].tuple_))
            c = P["zookeeper"].ZKClient().open(test, "n1")
            zk_race(P, c, test)
            out["race"] = invoke_all(P, c, test, [
                ("cas", P["ind"].tuple_(4, [2, 3])),
                ("read", P["ind"].tuple_(4, None))])
            out["nodes"] = sorted((k, bytes(v[0]).decode(), v[1])
                                  for k, v in srv.nodes.items())
        out["refused"] = refused(P, lambda P: P["zookeeper"].ZKClient())
        got[name] = out
    assert got["port"] == got["ref"]
    reg = got["port"]["register"]
    assert [o.get("error") for o in reg if o["type"] == "fail"] == [
        "precondition", "no-node", "unknown f 'frob'"]
    assert reg[8]["value"] == ["tuple", 4, 2] and reg[12]["value"] == 4
    assert got["port"]["race"][0]["error"] == "bad-version"
    assert got["port"]["race"][1]["value"] == ["tuple", 4, 2]
    assert [o["type"] for o in got["port"]["refused"]] == ["fail", "info"]


class _StatusHandler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _answer(self):
        n = int(self.headers.get("Content-Length", 0) or 0)
        self.rfile.read(n)
        self.send_response(self.server.status)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    do_GET = do_PUT = do_POST = _answer


@contextlib.contextmanager
def status_server(status: int):
    """An HTTP server that answers every request with `status`."""
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StatusHandler)
    srv.status = status
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def consul_race(P, client, test):
    """The client's next read returns a ModifyIndex that another writer
    moves before the `?cas=` put."""
    real = client._get

    def stale(t, k):
        out = real(t, k)
        client._get = real
        client._put(t, k, out[0])
        return out

    client._get = stale


def test_consul_client_op_for_op_with_the_references():
    """The register cases, a cas whose index moved (cas-index), HTTP 400
    and 500 answers (a 4xx fails; a 5xx fails a read and leaves a
    write indeterminate), and a refused connection."""
    got = {}
    for name, P in PKGS:
        out = {}
        with FakeConsulServer() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            c = P["consul"].ConsulClient().open(test, "n1")
            out["register"] = invoke_all(P, c, test,
                                         register_ops(P["ind"].tuple_))
            consul_race(P, c, test)
            out["race"] = invoke_all(P, c, test, [
                ("cas", P["ind"].tuple_(4, [2, 3])),
                ("read", P["ind"].tuple_(4, None))])
            out["kv"] = sorted((k, v[0].decode(), v[1])
                               for k, v in srv.kv.items())
        for status in (400, 500):
            with status_server(status) as port:
                test = {"db-hosts": {"n1": ("127.0.0.1", port)}}
                c = P["consul"].ConsulClient().open(test, "n1")
                out[status] = invoke_all(P, c, test, [
                    ("read", P["ind"].tuple_(1, None)),
                    ("write", P["ind"].tuple_(1, 2)),
                    ("cas", P["ind"].tuple_(1, [2, 3]))])
        out["refused"] = refused(P, lambda P: P["consul"].ConsulClient())
        got[name] = out
    assert got["port"] == got["ref"]
    p = got["port"]
    assert [o["type"] for o in p["register"]] == [
        "ok", "ok", "ok", "ok", "fail", "ok", "fail", "ok", "ok", "ok",
        "ok", "ok", "ok", "fail"]
    assert p["race"][0]["error"] == "cas-index"
    assert [o["type"] for o in p[400]] == ["fail"] * 3
    assert [(o["type"], o["error"]) for o in p[500]] == [
        ("fail", "http-500"), ("info", "http-500"), ("info", "http-500")]
    assert [o["type"] for o in p["refused"]] == ["fail", "info"]


def test_dirty_reads_default_clients_as_the_references():
    """galera's and percona's dirty-reads client merges abort_prob 0.05
    under the caller's sql-opts; other workloads and mysql_cluster keep
    the caller's; postgres_rds's dialect takes port, user, database and
    password from the opts."""
    def shape(c):
        d = c.dialect
        return (type(c).__name__, c.mode, c.sql_opts, type(d).__name__,
                {k: v for k, v in sorted(vars(d).items())})

    cases = []
    for suite in ("galera", "percona", "mysql_cluster"):
        for w in sorted(PORT[suite].workloads({})):
            for sql_opts in (None, {"dirty_rows": 4},
                             {"abort_prob": 1.0}):
                cases.append((suite, w, {"sql-opts": sql_opts}))
    for w in sorted(PORT["postgres_rds"].workloads({})):
        cases.append(("postgres_rds", w, {}))
        cases.append(("postgres_rds", w, {
            "port": "6543", "user": "jepsen", "database": "d1",
            "password": "pw"}))
    for suite, w, opts in cases:
        ref = shape(REF[suite].default_client(w, copy.deepcopy(opts)))
        port = shape(PORT[suite].default_client(w, copy.deepcopy(opts)))
        assert port == ref, (suite, w, opts)
    assert shape(port_galera.default_client("dirty-reads", {}))[2] == \
        {"abort_prob": 0.05}
    assert shape(port_percona.default_client(
        "dirty-reads", {"sql-opts": {"dirty_rows": 4}}))[2] == \
        {"abort_prob": 0.05, "dirty_rows": 4}
    d = port_postgres_rds.default_client("bank", {
        "port": "6543", "user": "u", "database": "d", "password": "p"})
    assert (d.dialect.port, d.dialect.user, d.dialect.database,
            d.dialect.password) == (6543, "u", "d", "p")


# ---------------------------------------------------------------------------
# dirty_reads
# ---------------------------------------------------------------------------

def dirty_history(seed: int, n: int = 120) -> list:
    """Seeded writes (ok, fail, info) of values 0-19 and reads of 8 rows:
    all one value, a mix, a failed write's value among them, or no list
    at all."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        typ = ["ok", "ok", "fail", "info"][int(rng.integers(0, 4))]
        if rng.integers(0, 2):
            out.append({"type": typ, "f": "write", "process": i % 5,
                        "value": int(rng.integers(0, 20))})
            continue
        shape = int(rng.integers(0, 4))
        if shape == 0:
            value = [int(rng.integers(-1, 20))] * 8
        elif shape == 1:
            value = [int(x) for x in rng.integers(-1, 20, 8)]
        elif shape == 2:
            value = (-1, -1)
        else:
            value = None
        out.append({"type": typ, "f": "read", "process": i % 5,
                    "value": value})
    return out


@pytest.mark.parametrize("seed", range(10))
def test_dirty_reads_checker_counts_equal_the_references(seed):
    hist = dirty_history(seed)
    ref = ref_dirty_reads.DirtyReadsChecker().check(
        {}, copy.deepcopy(hist), {})
    port = port_dirty_reads.checker().check({}, copy.deepcopy(hist), {})
    assert port == ref


def test_dirty_reads_checker_cases_as_the_references():
    """tests/test_more_suites.py's cases: a clean read, a dirty and
    fractured read, and an `info` write's value seen (not dirty)."""
    hist = [{"type": "ok", "f": "write", "value": 1},
            {"type": "fail", "f": "write", "value": 2},
            {"type": "ok", "f": "read", "value": [1, 1, 1]}]
    cases = {
        "clean": hist,
        "dirty": hist + [{"type": "ok", "f": "read", "value": [1, 2, 1]}],
        "info": hist + [{"type": "info", "f": "write", "value": 3},
                        {"type": "ok", "f": "read", "value": [3, 3, 3]}],
    }
    got = {}
    for name, h in cases.items():
        ref = ref_dirty_reads.checker().check({}, copy.deepcopy(h), {})
        got[name] = port_dirty_reads.DirtyReadsChecker().check(
            {}, copy.deepcopy(h), {})
        assert got[name] == ref, name
    assert got["clean"]["valid?"] is True
    assert got["clean"]["failed-write-count"] == 1
    assert got["dirty"]["valid?"] is False
    assert got["dirty"]["dirty-count"] == got["dirty"][
        "inconsistent-count"] == 1
    assert got["info"]["valid?"] is True


# ---------------------------------------------------------------------------
# Generators, test maps, DB commands
# ---------------------------------------------------------------------------

GENERATORS = {
    "mongodb-register": lambda P: P["mongodb"].workloads({})["register"]()[
        "generator"],
    "mongodb-set": lambda P: P["mongodb"].workloads({})["set"]()[
        "generator"],
    "zookeeper": lambda P: P["zookeeper"].workloads({})["register"]()[
        "generator"],
    "consul": lambda P: P["consul"].workloads({})["register"]()[
        "generator"],
    "dirty-reads": lambda P: P["dirty_reads"].workload()["generator"],
    "mongodb-ops": lambda P: P["gen"].mix([P["mongodb"].r, P["mongodb"].w,
                                           P["mongodb"].cas]),
}


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_generators_draw_as_the_references(which):
    """Each workload's ops under the same `random` seed, through the
    generator simulation: op for op the reference's."""
    got = {}
    for name, P in PKGS:
        random.seed(20)
        g = P["gen"].limit(400, GENERATORS[which](P))
        got[name] = plain(simulate(P["gen"], g, perfect, concurrency=10))
    assert got["port"] == got["ref"]
    invokes = [o for o in got["port"] if o["type"] == "invoke"]
    assert len(invokes) == 400


#: the options each workload's test map is built with: none, the time
#: limit, the device, a fault request
MAP_OPTS = ({}, {"time-limit": 1}, {"device": "cpu"},
            {"faults": ["partition", "kill"]})


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_test_maps_and_menus_equal_the_references(suite):
    menu = sorted(PORT[suite].workloads({}))
    assert menu == sorted(REF[suite].workloads({}))
    cases = [{"workload": w, **o} for w in menu for o in MAP_OPTS]
    if suite == "postgres_rds":
        cases.append({"endpoint": "db.example"})
    make = SUITES[suite]
    for opts in cases:
        ref = getattr(REF[suite], make)(copy.deepcopy(opts))
        port = getattr(PORT[suite], make)(copy.deepcopy(opts))
        assert map_shape(port) == map_shape(ref), opts
        assert port.get("nodes") == ref.get("nodes")


@pytest.mark.parametrize("suite,device", [
    (s, d) for s in ("mongodb", "mongodb_rocks", "mongodb_smartos",
                     "zookeeper", "consul") for d in (None, "cpu")])
def test_register_checkers_take_the_device(suite, device):
    """The one departure: each register checker runs on opts' device
    (None: cuda)."""
    t = getattr(PORT[suite], SUITES[suite])(
        {"device": device} if device else {})
    sub = t["checker"].sub
    lin = sub.checker_map["linear"] if hasattr(sub, "checker_map") else sub
    assert type(lin).__name__ == "Linearizable" and lin.device == device


def db_commands(P, suite: str, nodes: list) -> list:
    """The suite's OS and DB setup and teardown on the dummy remote,
    node by node."""
    test = getattr(P[suite], SUITES[suite])(
        {"ssh": {"dummy": True}, "nodes": nodes})

    def lifecycle(t, n):
        if t.get("os") is not None:
            t["os"].setup(t, n)
        t["db"].setup(t, n)
        t["db"].teardown(t, n)

    P["control"].on_nodes(test, lifecycle)
    return sorted((n, k, str(p)) for n, k, p in test["remote"].actions)


@pytest.mark.parametrize("suite,needle", [
    ("mongodb", "mongod"), ("mongodb_rocks", "rocksdb"),
    ("mongodb_smartos", "pkgin"), ("zookeeper", "zookeeper"),
    ("consul", "consul agent"), ("galera", "galera"),
    ("percona", "percona"), ("mysql_cluster", "ndb"),
    ("postgres_rds", None)])
def test_db_setup_commands_as_the_references(suite, needle, monkeypatch):
    import time
    monkeypatch.setattr(time, "sleep", lambda s: None)
    nodes = ["n1", "n2", "n3"]
    ref = db_commands(REF, suite, nodes)
    port = db_commands(PORT, suite, nodes)
    assert port == ref
    if needle is None:
        assert not [a for a in port if a[1] == "execute"]
    else:
        assert any(needle in p for _n, k, p in port if k == "execute")


def test_mongodb_initiates_the_replica_set_as_the_reference(monkeypatch):
    """Node 0 of a live (not dummy) cluster sends replSetInitiate over
    the wire: the same config reaches the fake from both packages."""
    got = {}
    with FakeMongoServer() as srv:
        for name, P in PKGS:
            srv.rs_config = None
            monkeypatch.setattr(P["mongodb"], "PORT", srv.port)
            remote = P["control"].DummyRemote()
            test = {"nodes": ["127.0.0.1"], "ssh": {}, "remote": remote}
            P["control"].on_nodes(test, P["mongodb"].MongoDB().setup)
            got[name] = (plain(srv.rs_config),
                         sorted(str(p) for _n, _k, p in remote.actions))
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"_id": "jepsen", "members": [
        {"_id": 0, "host": f"127.0.0.1:{srv.port}"}]}


def test_port_fake_mongo_serves_on_the_ports_codec():
    """tests/fake_torch_mongo.py (what chip_smoke.py loads) answers as
    tests/fake_mongo.py does, through the port's codec, leaving no
    reference entry in sys.modules."""
    import sys
    import fake_torch_mongo
    assert fake_torch_mongo._impl.encode_doc is port_mongo.encode_doc
    assert sys.modules.get("jepsen_tpu.drivers.mongo") is ref_mongo
    got = {}
    for name, fake in (("ref", FakeMongoServer),
                       ("port", PortFakeMongoServer)):
        with fake() as srv:
            got[name] = mongo_session(PORT, srv.port)
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# End to end through each suite's main
# ---------------------------------------------------------------------------

#: name -> (suite, fake, --workload or None, extra opts, concurrency)
RUNS = {
    "mongodb-register": ("mongodb", FakeMongoServer, "register", {}, 4),
    "mongodb_rocks-register": ("mongodb_rocks", FakeMongoServer,
                               "register", {}, 4),
    "mongodb_smartos-register": ("mongodb_smartos", FakeMongoServer,
                                 "register", {}, 4),
    "zookeeper-register": ("zookeeper", FakeZKServer, None, {}, 4),
    "consul-register": ("consul", FakeConsulServer, None, {}, 4),
    "galera-dirty-reads": ("galera", FakeMySQLServer, "dirty-reads",
                           {"sql-opts": {"abort_prob": 1.0}}, 5),
    "percona-dirty-reads": ("percona", FakeMySQLServer, "dirty-reads",
                            {"sql-opts": {"abort_prob": 1.0}}, 5),
    "mysql_cluster-bank": ("mysql_cluster", FakeMySQLServer, "bank", {},
                           5),
    "postgres_rds-append": ("postgres_rds", FakePGServer, "append", {}, 5),
    "postgres_rds-bank": ("postgres_rds", FakePGServer, "bank", {}, 5),
}
#: the runs whose results compose plots, run a second time without
#: matplotlib
NO_MPL = ("galera-dirty-reads", "mysql_cluster-bank")


def main_run(which: str, tmp_path: Path, monkeypatch, device=("--device",
                                                              "cpu")):
    """The suite's own main against its fake, 2.5 s, the partitioner
    every 0.3 s; returns (exit code, JSON lines, the remote)."""
    suite, fake, workload, extra, conc = RUNS[which]
    remote = port_control.DummyRemote()
    argv = ["test", "--dummy", *device, "--store",
            str(tmp_path / "port"), "--concurrency", str(conc)]
    if workload:
        argv += ["--workload", workload]
    with fake() as srv:
        rc, lines = run_main(
            monkeypatch, PORT[suite], SUITES[suite],
            {"db-hosts": fake_hosts(srv), "time-limit": 2.5,
             "nemesis-interval": 0.3, **extra}, argv, remote)
    return rc, lines, remote


def strip_plot_errors(res: dict) -> dict:
    """A results map with each plot entry's errors (tracebacks naming
    their package's files) cut to whether they name matplotlib."""
    def cut(x):
        if not isinstance(x, dict):
            return x
        return {k: ("matplotlib" in str(v) if k == "error" else cut(v))
                for k, v in x.items()}

    return {k: cut(v) if k in ("perf", "plot") else v
            for k, v in res.items()}


@pytest.mark.parametrize("which,mpl", [
    *[(w, True) for w in sorted(RUNS)],
    *[(w, False) for w in NO_MPL]],
    ids=lambda x: x if isinstance(x, str) else ("mpl" if x else "no-mpl"))
def test_suite_main_equals_the_reference(which, mpl, tmp_path,
                                         reference_env, monkeypatch):
    """The suite's `main` (`test --dummy --device cpu [--workload W]`)
    against its fake; the two packages' re-checks of the stored run, in
    turn on one path, give the same results (per key for registers) and
    files; without matplotlib the plot entries are unknown in both and
    the run exits 2."""
    if not mpl:
        block_matplotlib(monkeypatch)
    suite, _fake, workload, _extra, _conc = RUNS[which]
    before = set(threading.enumerate())
    rc, lines, remote = main_run(which, tmp_path, monkeypatch)
    assert no_workers_left() and no_threads_left(before)
    assert len(lines) == 1
    run = Path(lines[0]["dir"])
    res = json.loads((run / "results.json").read_text())
    want = True if mpl or set(res).isdisjoint({"perf", "plot"}) \
        else "unknown"
    assert lines[0]["valid?"] == res["valid?"] == want
    assert rc == (0 if want is True else 2)
    hist = [json.loads(ln) for ln in
            (run / "history.jsonl").read_text().splitlines()]
    client_ops = [o for o in hist if isinstance(o["process"], int)]
    assert client_ops
    nem = {o["f"] for o in hist if o["process"] == "nemesis"}
    assert nem <= {"start", "stop"}
    if suite != "postgres_rds":      # its nemesis is the noop
        assert any("iptables" in str(p) for _n, k, p in remote.actions
                   if k == "execute")
    stored = json.loads((run / "test.json").read_text())
    assert stored["device"] == "cpu"
    name = workload or "register"
    out = recheck_in_turn(
        run, tmp_path,
        lambda P: P[suite].workloads({})[name]()["checker"],
        monkeypatch, pkgs=(REF, PORT))
    if mpl:
        got = same_recheck(out)
    else:
        (rrc, rres, rfiles), (prc, pres, pfiles) = out["ref"], out["port"]
        assert prc == rrc == 2
        assert strip_plot_errors(pres) == strip_plot_errors(rres)
        plot = pres.get("perf") or pres.get("plot")
        assert plot["valid?"] == "unknown" and "matplotlib" in str(plot)
        assert not [f for f in pfiles if f.endswith(".png")]
        assert sorted(pfiles) == sorted(rfiles)
        got = pres
    assert got["valid?"] == res["valid?"]
    if name == "register":
        assert per_key(got) == per_key(res) and per_key(res)
        assert all(v is True for v in per_key(res).values())
        if suite in ("zookeeper", "consul"):
            assert {f for f in out["port"][2]
                    if f.endswith("timeline.html")} == {
                f"independent/{k}/timeline.html" for k in per_key(res)}
    if name == "dirty-reads":
        dr = res["dirty-reads"]
        assert dr["valid?"] is True and dr["dirty-count"] == 0
        # abort_prob 1.0: no write commits
        writes = [o for o in client_ops if o["f"] == "write"
                  and o["type"] != "invoke"]
        assert not [o for o in writes if o["type"] == "ok"]
        assert dr["failed-write-count"] == len(
            {o["value"] for o in writes if o["type"] == "fail"})
    if name == "bank":
        assert res["bank"]["valid?"] is True


@pytest.mark.parametrize("which", ["mongodb-register",
                                   "postgres_rds-append"])
def test_suite_main_without_a_card_exits_255(which, tmp_path, monkeypatch,
                                             capsys):
    """Without --device the checker is the device path: no card here,
    so DeviceUnavailable and exit 255, the history stored and no
    verdict."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, _ = main_run(which, tmp_path, monkeypatch, device=())
    assert rc == 255 and not lines
    assert "no CUDA device is available" in capsys.readouterr().err
    runs = [p.parent for p in (tmp_path / "port").rglob("history.jsonl")]
    assert len(runs) == 1 and not (runs[0] / "results.json").exists()
