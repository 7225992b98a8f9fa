"""The port's RESP, ReQL and AMQP suites (`raftis`, `rethinkdb`,
`disque`, `rabbitmq`) and `robustirc`, with their drivers
(`drivers/resp.py`, `drivers/reql.py`, `drivers/amqp.py`) and the
`queue` workload, then the loose `causal` and `cycle` workloads, against
the reference's.

- The drivers byte for byte: the bytes a session sends and receives
  against the fakes of `tests/fake_misc.py` (the ReQL client nonce
  pinned in both packages), and each package's reading of scripted
  replies: the same values, and the same `DBError` or `DriverError`,
  with the same `is_retriable`, on a wire fault.
- The clients op for op against the fakes: the same completions,
  errors included (robustirc's topic parsing and partial backlog with
  its sentinel uuid pinned, the queues' indeterminate acks and partial
  drains).
- The test maps, workload menus, generators (under a seeded `random`)
  and the DB setup, kill, pause and resume commands on a dummy remote
  as the reference's.
- End to end: each suite's own `main(["test", "--dummy", "--device",
  "cpu", ...])` against its fake, the history stored; both packages'
  `analyze --backend cpu` of the stored run, in turn on one path, give
  the same results (per key for registers) and the same files.
- The reference's `causal` and `cycle` cases, and seeded histories, on
  the port's copies.
"""

import contextlib
import copy
import itertools
import json
import random
import socket
import struct
import threading
import types
import urllib.request
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

import jepsen_tpu.control as ref_control
import jepsen_tpu.generator as ref_gen
import jepsen_tpu.independent as ref_ind
import jepsen_tpu.suites.disque as ref_disque
import jepsen_tpu.suites.rabbitmq as ref_rabbitmq
import jepsen_tpu.suites.raftis as ref_raftis
import jepsen_tpu.suites.rethinkdb as ref_rethinkdb
import jepsen_tpu.suites.robustirc as ref_robustirc
from jepsen_tpu import drivers as ref_drivers
from jepsen_tpu.drivers import amqp as ref_amqp
from jepsen_tpu.drivers import reql as ref_reql
from jepsen_tpu.drivers import resp as ref_resp
from jepsen_tpu.workloads import causal as ref_causal
from jepsen_tpu.workloads import cycle as ref_cycle
from jepsen_tpu.workloads import queue as ref_queue
import jepsen_tpu_torch.control as port_control
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.independent as port_ind
import jepsen_tpu_torch.suites as port_suites
import jepsen_tpu_torch.suites.disque as port_disque
import jepsen_tpu_torch.suites.rabbitmq as port_rabbitmq
import jepsen_tpu_torch.suites.raftis as port_raftis
import jepsen_tpu_torch.suites.rethinkdb as port_rethinkdb
import jepsen_tpu_torch.suites.robustirc as port_robustirc
from jepsen_tpu_torch import drivers as port_drivers
from jepsen_tpu_torch.drivers import amqp as port_amqp
from jepsen_tpu_torch.drivers import reql as port_reql
from jepsen_tpu_torch.drivers import resp as port_resp
from jepsen_tpu_torch.workloads import causal as port_causal
from jepsen_tpu_torch.workloads import cycle as port_cycle
from jepsen_tpu_torch.workloads import queue as port_queue

from fake_misc import (FakeAMQPServer, FakeDisqueServer, FakeRedisServer,
                       FakeReqlServer, FakeRobustIRCServer)
from test_torch_baseline_suites import (fake_hosts, map_shape,
                                        no_threads_left, per_key, plain,
                                        recheck_in_turn, run_main,
                                        same_recheck)
from test_torch_cli import reference_env  # noqa: F401
from test_torch_core_run import no_workers_left
from test_torch_generator import perfect, simulate
from test_torch_more_suites import (invoke_all, recorded,  # noqa: F401
                                    refused, status_server,
                                    strip_plot_errors)
from test_torch_plots import block_matplotlib

REF = dict(ind=ref_ind, gen=ref_gen, control=ref_control,
           drivers=ref_drivers, resp=ref_resp, reql=ref_reql, amqp=ref_amqp,
           raftis=ref_raftis, rethinkdb=ref_rethinkdb, disque=ref_disque,
           rabbitmq=ref_rabbitmq, robustirc=ref_robustirc, queue=ref_queue,
           causal=ref_causal, cycle=ref_cycle)
PORT = dict(ind=port_ind, gen=port_gen, control=port_control,
            drivers=port_drivers, resp=port_resp, reql=port_reql,
            amqp=port_amqp, raftis=port_raftis, rethinkdb=port_rethinkdb,
            disque=port_disque, rabbitmq=port_rabbitmq,
            robustirc=port_robustirc, queue=port_queue, causal=port_causal,
            cycle=port_cycle)
PKGS = (("ref", REF), ("port", PORT))

#: The suites this slice ports, with each one's `<db>_test`.
SUITES = {"raftis": "raftis_test", "rethinkdb": "rethinkdb_test",
          "disque": "disque_test", "rabbitmq": "rabbitmq_test",
          "robustirc": "robustirc_test"}


def outcome(P, fn):
    """`fn()`'s value, or the driver error it raised (with the package's
    `is_retriable` of it), as plain data."""
    try:
        return ("ok", plain(fn()))
    except P["drivers"].DBError as e:
        return ("db-error", e.code, e.message,
                P["drivers"].is_retriable(e))
    except P["drivers"].DriverError as e:
        return ("driver-error", str(e), P["drivers"].is_retriable(e))
    except OSError as e:
        return ("os-error", type(e).__name__)


@pytest.fixture
def pinned_nonce(monkeypatch):
    """Both packages' ReQL drivers draw the same client nonce."""
    for P in (REF, PORT):
        monkeypatch.setattr(P["reql"], "os", types.SimpleNamespace(
            urandom=lambda n: bytes(range(7, 7 + n))))


@contextlib.contextmanager
def wired(cls, data: bytes, **attrs):
    """A driver connection (`cls`, its constructor skipped) on one end of
    a socket pair whose other end has sent `data` and then shut its
    writing side: the connection reads `data`, then the server's EOF.
    Yields (connection, the peer socket)."""
    a, b = socket.socketpair()
    a.settimeout(5)
    b.sendall(data)
    b.shutdown(socket.SHUT_WR)
    conn = cls.__new__(cls)
    conn.sock, conn._buf = a, b""
    for k, v in attrs.items():
        setattr(conn, k, v)
    try:
        yield conn, b
    finally:
        a.close()
        b.close()


def peer_got(b) -> bytes:
    """What the connection sent to the peer socket `b` so far."""
    b.settimeout(0.2)
    out = b""
    with contextlib.suppress(OSError):
        while True:
            chunk = b.recv(65536)
            if not chunk:
                break
            out += chunk
    return out


# ---------------------------------------------------------------------------
# RESP
# ---------------------------------------------------------------------------

def disque_session(P, port: int) -> list:
    c = P["resp"].connect("127.0.0.1", port)
    steps = [
        lambda: c.command("ADDJOB", "q", "41", 5000, "RETRY", 1),
        lambda: c.command("ADDJOB", "q", b"42", 5000),
        lambda: c.command("GETJOB", "TIMEOUT", 100, "FROM", "q"),
        lambda: c.command("ACKJOB", "D-1"),
        lambda: c.command("GETJOB", "TIMEOUT", 100, "FROM", "q"),
        lambda: c.command("GETJOB", "TIMEOUT", 100, "FROM", "q"),
        lambda: c.command("CLUSTER", "MEET", "n2", 7711),
        lambda: c.command("BOGUS", "x"),
    ]
    out = [outcome(P, f) for f in steps]
    c.close()
    out.append(outcome(P, lambda: c.command("GETJOB", "FROM", "q")))
    return out


def redis_session(P, port: int) -> list:
    c = P["resp"].connect("127.0.0.1", port, timeout=5.0)
    steps = [lambda: c.command("GET", "r1"),
             lambda: c.command("SET", "r1", 3),
             lambda: c.command("GET", "r1"),
             lambda: c.command("SET", "r1", "héllo"),
             lambda: c.command("GET", "r1"),
             lambda: c.command("INCR", "r1")]
    out = [outcome(P, f) for f in steps]
    c.close()
    return out


@pytest.mark.parametrize("fake,session", [
    (FakeDisqueServer, disque_session), (FakeRedisServer, redis_session)],
    ids=["disque", "redis"])
def test_resp_session_bytes_and_replies_equal_the_references(
        fake, session, recorded):
    got = {}
    for name, P in PKGS:
        with fake() as srv:
            got[name] = session(P, srv.port)
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
    assert got["port"] == got["ref"]
    p = got["port"]
    if session is disque_session:
        assert p[0] == ("ok", "D-1")
        assert p[2] == ("ok", [["q", "D-1", "41"]])
        assert p[3] == ("ok", 1) and p[5] == ("ok", None)
        assert p[7] == ("db-error", "ERR", "ERR unknown command BOGUS",
                        False)
        assert p[8] == ("driver-error", "connection is closed", False)
    else:
        assert p[0] == ("ok", None) and p[2] == ("ok", "3")
        assert p[4] == ("ok", "héllo")
        assert p[5][:2] == ("db-error", "ERR")


#: scripted RESP replies: nested arrays, null bulk and null array, an
#: integer, error lines with and without a message, a bad type byte, a
#: bulk string cut short by the server's EOF
RESP_REPLIES = {
    "nested": b"*3\r\n:7\r\n*2\r\n$2\r\nab\r\n$-1\r\n+OK\r\n",
    "null-array": b"*-1\r\n",
    "empty-bulk": b"$0\r\n\r\n",
    "noleader": b"-NOLEADER no leader elected\r\n",
    "bare-error": b"-\r\n",
    "bad-type": b"?what\r\n",
    "cut-bulk": b"$10\r\nabc",
    "cut-line": b"+OK",
    "nothing": b"",
}


@pytest.mark.parametrize("reply", sorted(RESP_REPLIES))
def test_resp_replies_and_wire_faults_as_the_references(reply):
    """Each package's reading of a scripted reply, and what it sent: the
    same value or the same error; a fault leaves the connection closed
    in both."""
    got = {}
    for name, P in PKGS:
        with wired(P["resp"].RespConn, RESP_REPLIES[reply]) as (c, b):
            out = [outcome(P, lambda: c.command("GET", "k", 5))]
            out.append(c.sock is None)
            out.append(outcome(P, lambda: c.command("GET", "k")))
            out.append(peer_got(b))
        got[name] = out
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p[3].startswith(b"*3\r\n$3\r\nGET\r\n$1\r\nk\r\n$1\r\n5\r\n")
    if reply == "noleader":
        assert p[0] == ("db-error", "NOLEADER", "NOLEADER no leader "
                        "elected", False)
    if reply == "bare-error":
        assert p[0] == ("db-error", "ERR", "", False)
    if reply == "bad-type":
        assert p[0] == ("driver-error", "bad RESP type byte b'?'", False)
    if reply in ("cut-bulk", "cut-line", "nothing"):
        assert p[0] == ("driver-error", "connection closed by server",
                        False)
        assert p[1] is True
        assert p[2] == ("driver-error", "connection is closed", False)


def test_resp_refused_connection_as_the_references():
    got = {name: outcome(P, lambda: P["resp"].connect("127.0.0.1", 1))
           for name, P in PKGS}
    assert got["port"] == got["ref"] == ("os-error",
                                         "ConnectionRefusedError")


# ---------------------------------------------------------------------------
# ReQL
# ---------------------------------------------------------------------------

def reql_session(P, port: int) -> list:
    c = P["reql"].connect("127.0.0.1", port)
    db = "jepsen"
    steps = [
        lambda: c.db_create(db),
        lambda: c.table_create(db, "registers"),
        lambda: c.table_create(db, "sets", shards=1),
        lambda: c.get(db, "registers", 1),
        lambda: c.insert(db, "registers", {"id": 1, "val": 3}),
        lambda: c.get(db, "registers", 1),
        lambda: c.insert(db, "registers", {"id": 1, "val": 4},
                         conflict="replace", durability="soft"),
        lambda: c.get(db, "registers", 1, read_mode="single"),
        lambda: c.insert(db, "sets", {"id": 5}, conflict="error"),
        lambda: c.insert(db, "sets", {"id": 6}, conflict="error"),
        lambda: c.insert(db, "sets", {"id": 7}, conflict="error"),
        lambda: c.insert(db, "sets", {"id": 5}, conflict="error"),
        lambda: c.run(c.table(db, "sets"), {"read_mode": "majority"}),
        lambda: c.run(c.table(db, "nope")),
        lambda: c.run([P["reql"].DELETE, [c.table(db, "sets")]]),
    ]
    out = [outcome(P, f) for f in steps]
    c.close()
    out.append(outcome(P, lambda: c.get(db, "registers", 1)))
    return out


def test_reql_session_bytes_and_replies_equal_the_references(
        recorded, pinned_nonce):
    """The V1_0 handshake (magic, SCRAM-SHA-256 over NUL-terminated JSON,
    the nonce pinned) and START/CONTINUE queries: the same bytes both
    ways and the same results, the duplicate key and the unsupported
    term included."""
    got = {}
    for name, P in PKGS:
        with FakeReqlServer() as srv:
            got[name] = reql_session(P, srv.port)
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p[3] == ("ok", None) and p[5] == ("ok", {"id": 1, "val": 3})
    assert p[7] == ("ok", {"id": 1, "val": 4})
    assert p[11] == ("db-error", "insert", "Duplicate key", False)
    # three rows: a partial batch of one, then the CONTINUE's two
    assert p[12] == ("ok", [{"id": 5}, {"id": 6}, {"id": 7}])
    assert p[13] == ("ok", [])
    assert p[14] == ("db-error", "reql-18", "unsupported term 54", False)
    assert p[-1] == ("driver-error", "connection is closed", False)
    assert bytes(port_sock.sent).startswith(
        struct.pack("<I", port_reql.V1_0_MAGIC))


def nul(obj) -> bytes:
    return json.dumps(obj).encode() + b"\0"


def reql_reply(token: int, obj) -> bytes:
    payload = json.dumps(obj).encode()
    return struct.pack("<QI", token, len(payload)) + payload


#: the server's side of a handshake that succeeds
HELLO = (nul({"success": True, "server_version": "x"}) +
         nul({"success": True,
              "authentication": "r=abcdef,s=c2FsdA==,i=64"}) +
         nul({"success": True, "authentication": "v=sig"}))

#: scripted ReQL exchanges: handshake refusals, error responses, a token
#: mismatch, partial batches, a cut reply
REQL_SCRIPTS = {
    "auth-refused": nul({"success": True}) + nul(
        {"success": False, "error": "Wrong password", "error_code": 12}),
    "version-refused": nul({"success": False,
                            "error": "Unsupported protocol"}),
    "hello-cut": nul({"success": True})[:-1],
    "atom": HELLO + reql_reply(1, {"t": 1, "r": [{"id": 2}]}),
    "empty-atom": HELLO + reql_reply(1, {"t": 1, "r": []}),
    "partials": HELLO + reql_reply(1, {"t": 3, "r": [1]}) +
    reql_reply(1, {"t": 3, "r": [2, 3]}) + reql_reply(1, {"t": 2, "r": []}),
    "client-error": HELLO + reql_reply(1, {"t": 16, "r": ["bad", 2]}),
    "compile-error": HELLO + reql_reply(1, {"t": 17, "r": ["x"]}),
    "token-mismatch": HELLO + reql_reply(9, {"t": 1, "r": [0]}),
    "insert-errors": HELLO + reql_reply(1, {"t": 1, "r": [
        {"errors": 2, "first_error": "Primary key too long"}]}),
    "exists": HELLO + reql_reply(1, {"t": 18, "r": [
        "Database `jepsen` already exists."]}),
    "cut-reply": HELLO + reql_reply(1, {"t": 1, "r": [1]})[:-3],
}


def reql_script(P, c, script: str) -> list:
    out = [outcome(P, lambda: c._handshake("admin", "pw"))]
    if out[0][0] != "ok":
        return out
    if script == "insert-errors":
        out.append(outcome(P, lambda: c.insert("d", "t", {"id": 1})))
    elif script == "exists":
        out.append(outcome(P, lambda: c.db_create("jepsen")))
    else:
        out.append(outcome(P, lambda: c.run(c.table("d", "t"))))
    out.append(c.sock is None)
    return out


@pytest.mark.parametrize("script", sorted(REQL_SCRIPTS))
def test_reql_replies_and_wire_faults_as_the_references(script,
                                                        pinned_nonce):
    got = {}
    for name, P in PKGS:
        with wired(P["reql"].ReqlConn, REQL_SCRIPTS[script],
                   _token=0) as (c, b):
            out = reql_script(P, c, script)
            out.append(peer_got(b))
        got[name] = out
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p[-1].startswith(struct.pack("<I", port_reql.V1_0_MAGIC))
    want = {
        "auth-refused": ("db-error", "12", "Wrong password", False),
        "version-refused": ("db-error", "auth", "Unsupported protocol",
                            False),
        "hello-cut": ("driver-error", "connection closed by server", False),
        "atom": ("ok", {"id": 2}), "empty-atom": ("ok", None),
        "partials": ("ok", [1, 2, 3]),
        "client-error": ("db-error", "reql-16", "bad; 2", False),
        "compile-error": ("db-error", "reql-17", "x", False),
        "token-mismatch": ("driver-error", "token mismatch 9 != 1", False),
        "insert-errors": ("db-error", "insert", "Primary key too long",
                          False),
        "exists": ("ok", None),
        "cut-reply": ("driver-error", "connection closed by server", False),
    }[script]
    assert p[0] == want if len(p) == 2 else p[1] == want


def test_reql_refused_connection_as_the_references():
    got = {name: outcome(P, lambda: P["reql"].connect("127.0.0.1", 1))
           for name, P in PKGS}
    assert got["port"] == got["ref"] == ("os-error",
                                         "ConnectionRefusedError")


# ---------------------------------------------------------------------------
# AMQP 0-9-1
# ---------------------------------------------------------------------------

def amqp_session(P, port: int) -> list:
    c = P["amqp"].connect("127.0.0.1", port)
    big = bytes(range(256)) * 600            # over one frame_max body
    steps = [
        lambda: c.queue_declare("q1"),
        lambda: c.queue_declare("q2", durable=False),
        lambda: c.publish("q1", b"1", persistent=False),
        lambda: c.get("q1"),
        lambda: c.confirm_select(),
        lambda: c.publish("q1", b"2"),
        lambda: c.publish("q1", b""),
        lambda: c.publish("q2", big),
        lambda: c.get("q1"),
        lambda: c.ack(2),
        lambda: c.get("q1"),
        lambda: (lambda g: (g[0], len(g[1]), g[1] == big))(c.get("q2")),
        lambda: c.get("q1", no_ack=True),
        lambda: c.publish("q1", b"3"),
        lambda: c.queue_purge("q1"),
        lambda: c.get("q1"),
    ]
    out = [outcome(P, f) for f in steps]
    c.close()
    out.append(outcome(P, lambda: c.close()))
    return out


def test_amqp_session_bytes_and_replies_equal_the_references(recorded):
    """PLAIN auth, one channel, publisher confirms, publish (a body over
    several frames and an empty one), get, ack, purge and close: the
    same bytes both ways and the same results."""
    got = {}
    for name, P in PKGS:
        with FakeAMQPServer() as srv:
            got[name] = amqp_session(P, srv.port)
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert bytes(port_sock.got) == bytes(ref_sock.got)
    assert got["port"] == got["ref"]
    p = got["port"]
    assert p[3] == ("ok", [1, b"1"])
    assert p[8] == ("ok", [2, b"2"]) and p[10] == ("ok", [3, b""])
    assert p[11] == ("ok", [4, 153600, True])
    assert p[12] == ("ok", None) and p[14] == ("ok", 1)
    assert bytes(port_sock.sent).startswith(b"AMQP\x00\x00\x09\x01")


def frame(ftype: int, payload: bytes, ch: int = 1, end: int = 0xCE) -> bytes:
    return struct.pack("!BHI", ftype, ch, len(payload)) + payload + \
        bytes([end])


def method(cls: int, mth: int, args: bytes = b"", ch: int = 1) -> bytes:
    return frame(1, struct.pack("!HH", cls, mth) + args, ch)


def shortstr(s: str) -> bytes:
    return bytes([len(s)]) + s.encode()


GET_OK = method(60, 71, struct.pack("!Q", 5) + b"\0" + shortstr("") +
                shortstr("q") + struct.pack("!I", 0))
HEARTBEAT = frame(8, b"", ch=0)

#: scripted AMQP replies to one call (get, publish under confirms, or
#: queue_declare): heartbeats skipped, a bad end octet, the server
#: closing the connection or the channel, frames out of order, confirm
#: nacks and tags, a cut frame
AMQP_SCRIPTS = {
    "heartbeat-get-empty": ("get", HEARTBEAT + HEARTBEAT +
                            method(60, 72, shortstr(""))),
    "get-two-bodies": ("get", GET_OK + HEARTBEAT +
                       frame(2, struct.pack("!HHQH", 60, 0, 5, 0)) +
                       frame(3, b"12") + frame(3, b"345")),
    "bad-end": ("get", frame(1, struct.pack("!HH", 60, 72), end=0xCD)),
    "connection-close": ("get", method(10, 50, struct.pack("!H", 320) +
                                       shortstr("CONNECTION_FORCED") +
                                       struct.pack("!HH", 0, 0), ch=0)),
    "channel-close": ("queue_declare", method(20, 40, struct.pack(
        "!H", 404) + shortstr("NOT_FOUND - no queue") +
        struct.pack("!HH", 50, 10))),
    "wrong-method": ("queue_declare", method(50, 31, b"\0\0\0\0")),
    "body-not-method": ("get", frame(3, b"x")),
    "get-then-body": ("get", GET_OK + frame(3, b"x")),
    "get-then-method": ("get", GET_OK +
                        frame(2, struct.pack("!HHQH", 60, 0, 2, 0)) +
                        method(60, 72, shortstr(""))),
    "get-unexpected": ("get", method(60, 80, struct.pack("!Q", 1) + b"\0")),
    "nack": ("publish", method(60, 120, struct.pack("!Q", 1) + b"\0")),
    "confirm-tag": ("publish", method(60, 80, struct.pack("!Q", 2) + b"\0")),
    "confirm-other": ("publish", method(50, 11, b"")),
    "confirm-ok": ("publish", method(60, 80, struct.pack("!Q", 1) + b"\0")),
    "cut": ("get", GET_OK[:9]),
}


@pytest.mark.parametrize("script", sorted(AMQP_SCRIPTS))
def test_amqp_replies_and_wire_faults_as_the_references(script):
    call, data = AMQP_SCRIPTS[script]
    got = {}
    for name, P in PKGS:
        with wired(P["amqp"].AMQPConn, data, frame_max=131072,
                   _confirms=True, _publish_seq=0) as (c, b):
            fn = {"get": lambda: c.get("q"),
                  "publish": lambda: c.publish("q", b"7"),
                  "queue_declare": lambda: c.queue_declare("q")}[call]
            out = [outcome(P, fn), c.sock is None]
            c.close()
            out.append(peer_got(b))
        got[name] = out
    assert got["port"] == got["ref"]
    first = got["port"][0]
    want = {
        "heartbeat-get-empty": ("ok", None),
        "get-two-bodies": ("ok", [5, b"12345"]),
        "bad-end": ("driver-error", "bad frame end octet", False),
        "connection-close": ("db-error", 320, "CONNECTION_FORCED", False),
        "channel-close": ("db-error", 404, "NOT_FOUND - no queue", False),
        "wrong-method": ("driver-error",
                         "expected method (50,11), got (50,31)", False),
        "body-not-method": ("driver-error", "expected method frame, got 3",
                            False),
        "get-then-body": ("driver-error", "expected content header", False),
        "get-then-method": ("driver-error", "expected content body", False),
        "get-unexpected": ("driver-error", "unexpected method (60,80)",
                           False),
        "nack": ("db-error", "nack", "broker refused the publish", False),
        "confirm-tag": ("driver-error", "confirm tag 2 != seq 1", False),
        "confirm-other": ("driver-error",
                          "expected publish confirm, got (50,11)", False),
        "confirm-ok": ("ok", None),
        "cut": ("driver-error", "connection closed by server", False),
    }[script]
    assert first == want


def test_amqp_handshake_and_refusal_as_the_references():
    """The handshake against scripted replies (tune with frame_max 0
    takes the default) sends the same bytes; a refused connection
    raises OSError in both."""
    script = (method(10, 10, bytes([0, 9]) + struct.pack("!I", 0) +
                     struct.pack("!I", 5) + b"PLAIN" +
                     struct.pack("!I", 5) + b"en_US", ch=0) +
              method(10, 30, struct.pack("!HIH", 7, 0, 60), ch=0) +
              method(10, 41, shortstr(""), ch=0) +
              method(20, 11, struct.pack("!I", 0)))
    got = {}
    for name, P in PKGS:
        with wired(P["amqp"].AMQPConn, script) as (c, b):
            out = [outcome(P, lambda: c._handshake("u", "p", "/v")),
                   c.frame_max]
            out.append(peer_got(b))
        out.append(outcome(P, lambda: P["amqp"].connect("127.0.0.1", 1)))
        got[name] = out
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("ok", None) and got["port"][1] == 131072
    assert b"\0u\0p" in got["port"][2]
    assert got["port"][3] == ("os-error", "ConnectionRefusedError")


# ---------------------------------------------------------------------------
# The clients
# ---------------------------------------------------------------------------

def test_raftis_client_op_for_op_with_the_references():
    """Reads of a missing key, writes, reads, unlifted values, an unknown
    f, and a refused connection (a read fails, a write is
    indeterminate)."""
    got = {}
    for name, P in PKGS:
        out = {}
        kv = P["ind"].tuple_
        with FakeRedisServer() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            c = P["raftis"].RaftisClient().open(test, "n1")
            out["register"] = invoke_all(P, c, test, [
                ("read", kv(4, None)), ("write", kv(4, 3)),
                ("read", kv(4, None)), ("write", kv(5, 0)),
                ("read", kv(5, None)), ("write", 2), ("read", None),
                ("cas", kv(4, [3, 4])), ("read", kv(4, None))])
            out["kv"] = sorted(srv.kv.items())
        out["refused"] = refused(P, lambda P: P["raftis"].RaftisClient())
        got[name] = out
    assert got["port"] == got["ref"]
    reg = got["port"]["register"]
    assert [o["type"] for o in reg] == ["ok"] * 7 + ["fail", "ok"]
    assert reg[0]["value"] == ["tuple", 4, None]
    assert reg[2]["value"] == ["tuple", 4, 3]
    assert reg[4]["value"] == ["tuple", 5, 0]
    assert reg[6]["value"] == 2
    assert reg[7]["error"] == "unknown f 'cas'"
    assert got["port"]["kv"] == [("r0", "2"), ("r4", "3"), ("r5", "0")]
    assert [o["type"] for o in got["port"]["refused"]] == ["fail", "info"]


def test_raftis_client_db_error_as_the_references():
    """A server error reply is a definite fail for either f."""
    got = {}
    for name, P in PKGS:
        out = []
        for f, v in (("read", None), ("write", 1)):
            with wired(P["resp"].RespConn, b"-NOLEADER none\r\n") as (
                    conn, _b):
                c = P["raftis"].RaftisClient()
                c.conn = conn
                out.append(plain(c.invoke({}, {"type": "invoke", "f": f,
                                               "value": v, "process": 0})))
        got[name] = out
    assert got["port"] == got["ref"]
    assert [o["error"] for o in got["port"]] == [
        "raftis-NOLEADER: NOLEADER none"] * 2


def test_rethinkdb_client_op_for_op_with_the_references(pinned_nonce):
    """The register mode (reads, writes, unlifted values, an unknown f),
    the set mode (adds, a duplicate add, reads through the partial
    cursor), a server error, and a refused connection."""
    got = {}
    for name, P in PKGS:
        out = {}
        kv = P["ind"].tuple_
        with FakeReqlServer() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            c = P["rethinkdb"].RethinkClient("register").open(test, "n1")
            out["register"] = invoke_all(P, c, test, [
                ("read", kv(3, None)), ("write", kv(3, 9)),
                ("read", kv(3, None)), ("write", 4), ("read", None),
                ("cas", kv(3, [9, 1]))])
            s = P["rethinkdb"].RethinkClient("set").open(test, "n2")
            out["set"] = invoke_all(P, s, test, [
                ("read", None), ("add", 7), ("add", 2), ("add", 7),
                ("add", 5), ("read", None), ("frob", None)])
            out["tables"] = sorted((t, sorted(map(str, v)))
                                   for t, v in srv.tables.items())
        out["refused"] = refused(
            P, lambda P: P["rethinkdb"].RethinkClient())
        got[name] = out
    assert got["port"] == got["ref"]
    reg = got["port"]["register"]
    assert [o["type"] for o in reg] == ["ok"] * 5 + ["fail"]
    assert reg[0]["value"] == ["tuple", 3, None]
    assert reg[2]["value"] == ["tuple", 3, 9] and reg[4]["value"] == 4
    st = got["port"]["set"]
    assert st[0]["value"] == [] and st[5]["value"] == [2, 5, 7]
    assert st[3] == {"type": "fail", "f": "add", "value": 7, "process": 0,
                     "error": "reql-insert: Duplicate key"}
    assert [o["type"] for o in got["port"]["refused"]] == ["fail", "info"]


def ack_fails(P, client, method_name: str):
    """The client's connection raises DriverError on its next ack."""
    conn = client.conn
    real = getattr(conn, method_name)

    def boom(*a):
        if method_name == "ack" or a[0] == "ACKJOB":
            setattr(conn, method_name, real)
            raise P["drivers"].DriverError("ack lost")
        return real(*a)

    setattr(conn, method_name, boom)


def fails_after(P, client, method_name: str, n: int):
    """The client's connection raises DriverError from its n+1-th call of
    `method_name` on."""
    conn = client.conn
    real = getattr(conn, method_name)
    calls = itertools.count()

    def maybe(*a, **kw):
        if next(calls) >= n:
            raise P["drivers"].DriverError("link down")
        return real(*a, **kw)

    setattr(conn, method_name, maybe)


QUEUE_CLIENTS = {
    "disque": (FakeDisqueServer, "DisqueClient", "command", "command"),
    "rabbitmq": (FakeAMQPServer, "RabbitClient", "ack", "get"),
}


@pytest.mark.parametrize("suite", sorted(QUEUE_CLIENTS))
def test_queue_clients_op_for_op_with_the_references(suite):
    """Enqueues, dequeues (an empty one fails), a drain, an unknown f; a
    dequeue whose ack is lost (info, ack-indeterminate); a drain whose
    ack is lost (ok with the acked prefix) and one cut after two
    elements (ok with them) or before any (fail); a refused
    connection."""
    fake, cls, ack_name, get_name = QUEUE_CLIENTS[suite]
    got = {}
    for name, P in PKGS:
        out = {}
        with fake() as srv:
            test = {"db-hosts": fake_hosts(srv)}
            c = getattr(P[suite], cls)().open(test, "n1")
            out["basic"] = invoke_all(P, c, test, [
                ("dequeue", None), ("enqueue", 1), ("enqueue", 2),
                ("dequeue", None), ("enqueue", 3), ("drain", None),
                ("drain", None), ("frob", None)])
            c = getattr(P[suite], cls)().open(test, "n2")
            c.invoke(test, {"type": "invoke", "f": "enqueue", "value": 4,
                            "process": 1})
            ack_fails(P, c, ack_name)
            out["lost-ack"] = plain(c.invoke(test, {
                "type": "invoke", "f": "dequeue", "value": None,
                "process": 1}))
            c = getattr(P[suite], cls)().open(test, "n3")
            for v in (5, 6, 7):
                c.invoke(test, {"type": "invoke", "f": "enqueue",
                                "value": v, "process": 2})
            ack_fails(P, c, ack_name)
            out["drain-lost-ack"] = plain(c.invoke(test, {
                "type": "invoke", "f": "drain", "value": None,
                "process": 2}))
            c = getattr(P[suite], cls)().open(test, "n4")
            for v in (8, 9, 10, 11):
                c.invoke(test, {"type": "invoke", "f": "enqueue",
                                "value": v, "process": 3})
            # disque's command also sends the ACKJOBs: two elements in
            # take four calls
            fails_after(P, c, get_name, 4 if suite == "disque" else 2)
            out["drain-cut"] = plain(c.invoke(test, {
                "type": "invoke", "f": "drain", "value": None,
                "process": 3}))
            c = getattr(P[suite], cls)().open(test, "n5")
            c._ensure_conn(test)
            fails_after(P, c, get_name, 0)
            out["drain-none"] = plain(c.invoke(test, {
                "type": "invoke", "f": "drain", "value": None,
                "process": 4}))
            c = getattr(P[suite], cls)().open(test, "n5")
            out["rest"] = invoke_all(P, c, test, [("drain", None)])
        test = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        c = getattr(P[suite], cls)().open(test, "n1")
        out["refused"] = invoke_all(P, c, test, [
            ("dequeue", None), ("enqueue", 1), ("drain", None)])
        got[name] = out
    assert got["port"] == got["ref"]
    p = got["port"]
    assert [(o["type"], o.get("value")) for o in p["basic"]] == [
        ("fail", None), ("ok", 1), ("ok", 2), ("ok", 1), ("ok", 3),
        ("ok", [2, 3]), ("ok", []), ("fail", None)]
    assert p["basic"][0]["error"] == "empty"
    assert p["lost-ack"]["type"] == "info"
    assert p["lost-ack"]["error"] == "ack-indeterminate"
    assert p["drain-lost-ack"] == {"type": "ok", "f": "drain", "value": [],
                                   "process": 2}
    assert p["drain-cut"]["type"] == "ok"
    # 5 went with the lost ack; 6 and 7 were still queued
    assert p["drain-cut"]["value"] == [6, 7]
    assert p["rest"][0]["value"] == [8, 9, 10, 11]
    assert p["drain-none"]["type"] == "fail"
    assert [o["type"] for o in p["refused"]] == ["fail", "info", "info"]


@contextlib.contextmanager
def pinned_uuids(P, monkeypatch):
    """The package's robustirc sentinels come from a counter."""
    n = itertools.count(1)
    monkeypatch.setattr(P["robustirc"], "uuid", types.SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=next(n) << 80)))
    yield


def test_robustirc_topic_parsing_as_the_references():
    lines = [":n1!j@h TOPIC #jepsen :17", "TOPIC #jepsen :17",
             ":n1!j@h PRIVMSG #jepsen :17", "PING :abc", "TOPIC", "",
             ":a TOPIC #j :x:y ", "TOPIC #jepsen :-4", "NICK TOPIC :1"]
    got = {name: [P["robustirc"].RobustIRCClient._topic_payload(ln)
                  for ln in lines] for name, P in PKGS}
    assert got["port"] == got["ref"]
    assert got["port"][:4] == ["17", "17", None, None]


def test_robustirc_client_op_for_op_with_the_references(monkeypatch):
    """Adds and reads over the robustsession HTTP API (own adds seen
    through topic reflection), an unknown f, a partial backlog (the
    sentinel dropped: the read fails), HTTP 400 and 500 answers, and a
    refused connection; the sentinels pinned in both packages."""
    got = {}
    for name, P in PKGS:
        out = {}
        with FakeRobustIRCServer() as srv, pinned_uuids(P, monkeypatch):
            test = {"db-hosts": fake_hosts(srv)}
            c = P["robustirc"].RobustIRCClient(tls=False).open(test, "n1")
            out["set"] = [plain(c.invoke(test, {
                "type": "invoke", "f": f, "value": v, "process": 0}))
                for f, v in (("read", None), ("add", 9), ("add", 4),
                             ("read", None), ("frob", None))]
            real_append = srv.messages.append

            class Dropping(list):
                def append(self, item):
                    if "end-" not in item:
                        real_append(item)

            srv.messages = Dropping(srv.messages)
            out["partial"] = plain(c.invoke(test, {
                "type": "invoke", "f": "read", "value": None,
                "process": 0}))
            out["messages"] = list(srv.messages)
            out["sessions"] = sorted(srv.sessions)
        for status in (400, 500):
            with status_server(status) as port:
                test = {"db-hosts": {"n1": ("127.0.0.1", port)}}
                c = P["robustirc"].RobustIRCClient(tls=False).open(test,
                                                                   "n1")
                out[status] = [plain(c.invoke(test, {
                    "type": "invoke", "f": f, "value": v, "process": 0}))
                    for f, v in (("add", 1), ("read", None))]
        test = {"db-hosts": {"n1": ("127.0.0.1", 1)}}
        c = P["robustirc"].RobustIRCClient(tls=False).open(test, "n1")
        out["refused"] = [plain(c.invoke(test, {
            "type": "invoke", "f": f, "value": v, "process": 0}))
            for f, v in (("add", 1), ("read", None))]
        out["refused"] = [(o["type"], "refused" in o["error"])
                          for o in out["refused"]]
        got[name] = out
    assert got["port"] == got["ref"]
    p = got["port"]
    assert [(o["type"], o.get("value")) for o in p["set"]] == [
        ("ok", []), ("ok", 9), ("ok", 4), ("ok", [4, 9]), ("fail", None)]
    assert p["partial"]["type"] == "fail"
    assert p["partial"]["error"] == "partial-backlog"
    # the pinned sentinels of the two complete reads; the third dropped
    assert p["messages"] == [f":fake!j@fake TOPIC #jepsen :{v}" for v in (
        "end-000000000001", 9, 4, "end-000000000002")]
    assert [(o["type"], o["error"]) for o in p[400]] == [
        ("fail", "http-400"), ("fail", "http-400")]
    assert [(o["type"], o["error"]) for o in p[500]] == [
        ("info", "http-500"), ("fail", "http-500")]
    assert p["refused"] == [("info", True), ("fail", True)]


def test_robustirc_tls_client_asks_for_https_as_the_reference(
        monkeypatch):
    """With tls on (the suite's default) the client dials https with an
    unverified context, in both packages."""
    got = {}
    for name, P in PKGS:
        seen = []

        def urlopen(req, timeout=None, context=None):
            seen.append((req.full_url, req.get_method(), timeout,
                         context.verify_mode, context.check_hostname))
            raise OSError("no server")

        monkeypatch.setattr(urllib.request, "urlopen", urlopen)
        test = {"db-hosts": {"n1": ("127.0.0.1", 13001)}}
        c = P["robustirc"].RobustIRCClient().open(test, "n1")
        out = plain(c.invoke(test, {"type": "invoke", "f": "add",
                                    "value": 1, "process": 0}))
        got[name] = (out, [tuple(map(str, s)) for s in seen])
    assert got["port"] == got["ref"]
    assert got["port"][1][0][0] == \
        "https://127.0.0.1:13001/robustirc/v1/session"


# ---------------------------------------------------------------------------
# Generators, test maps, DB commands
# ---------------------------------------------------------------------------

GENERATORS = {
    "raftis-register": lambda P: P["raftis"].workloads({})["register"]()[
        "generator"],
    "raftis-ops": lambda P: P["gen"].mix([P["raftis"].r, P["raftis"].w]),
    "rethinkdb-register": lambda P: P["rethinkdb"].workloads({})[
        "register"]()["generator"],
    "rethinkdb-set": lambda P: P["rethinkdb"].workloads({})["set"]()[
        "generator"],
    "queue": lambda P: P["queue"].generator(None),
    "queue-final": lambda P: P["queue"].final_generator(),
    "disque-queue": lambda P: P["disque"].workloads({"ops": 300})[
        "queue"]()["generator"],
    "robustirc-set": lambda P: P["robustirc"].workloads({})["set"]()[
        "generator"],
    "causal": lambda P: P["causal"].test(5, keys=range(40))["generator"],
}


@pytest.mark.parametrize("which", sorted(GENERATORS))
def test_generators_draw_as_the_references(which):
    """Each workload's ops under the same `random` seed, through the
    generator simulation: op for op the reference's."""
    got = {}
    for name, P in PKGS:
        random.seed(21)
        g = P["gen"].limit(400, GENERATORS[which](P))
        got[name] = plain(simulate(P["gen"], g, perfect, concurrency=10))
    assert got["port"] == got["ref"]
    invokes = [o for o in got["port"] if o["type"] == "invoke"]
    assert invokes
    if which not in ("queue-final", "causal", "disque-queue",
                     "robustirc-set"):
        assert len(invokes) == 400


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_whole_test_generators_draw_as_the_references(suite):
    """The suite's whole generator (time limit, nemesis cycle and, for
    the queues, the nemesis stop and the drain after the limit) under a
    seeded `random`, op for op the reference's."""
    got = {}
    for name, P in PKGS:
        random.seed(3)
        t = getattr(P[suite], SUITES[suite])(
            {"time-limit": 1, "nemesis-interval": 0.25})
        got[name] = plain(simulate(P["gen"], t["generator"], perfect,
                                   concurrency=4))
    assert got["port"] == got["ref"]
    fs = [o["f"] for o in got["port"] if o["type"] == "invoke"]
    assert fs
    if suite in ("disque", "rabbitmq"):
        assert "drain" in fs and fs.index("drain") > fs.index("enqueue")
        assert [o for o in got["port"] if o["process"] == "nemesis"]


#: the options each workload's test map is built with: none, the time
#: limit, the device, a fault request, the robustirc tls switch
MAP_OPTS = ({}, {"time-limit": 1}, {"device": "cpu"},
            {"faults": ["partition", "kill"]}, {"tls": False},
            {"ops": 7})


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_test_maps_and_menus_equal_the_references(suite):
    menu = sorted(PORT[suite].workloads({}))
    assert menu == sorted(REF[suite].workloads({}))
    assert menu == sorted(PORT[suite].workloads())
    make = SUITES[suite]
    cases = [{"workload": w, **o} for w in menu for o in MAP_OPTS]
    for opts in cases:
        ref = getattr(REF[suite], make)(copy.deepcopy(opts))
        port = getattr(PORT[suite], make)(copy.deepcopy(opts))
        assert map_shape(port) == map_shape(ref), opts
        assert port.get("nodes") == ref.get("nodes")
        assert port["name"] == ref["name"]
        for k in ("mode", "tls", "port", "timeout", "getjob_timeout_ms"):
            assert getattr(port.get("client"), k, None) == getattr(
                ref.get("client"), k, None), (opts, k)


@pytest.mark.parametrize("suite,device", [
    (s, d) for s in ("raftis", "rethinkdb") for d in (None, "cpu")])
def test_register_checkers_take_the_device(suite, device):
    """The one departure: each register checker runs on opts' device
    (None: cuda)."""
    t = getattr(PORT[suite], SUITES[suite])(
        {"device": device} if device else {})
    lin = t["checker"].sub
    assert type(lin).__name__ == "Linearizable" and lin.device == device
    wl = PORT[suite].workloads({"device": device})["register"]()
    assert wl["checker"].sub.device == device


def test_raftis_workloads_without_opts_as_the_reference():
    """`workloads()` with no opts builds as the reference's (the device
    then None: cuda)."""
    for P in (REF, PORT):
        wl = P["raftis"].workloads()["register"]()
        assert type(wl["checker"].sub).__name__ == "Linearizable"
    assert port_raftis.workloads()["register"]()["checker"].sub.device \
        is None


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
    ("raftis", "raftis"), ("rethinkdb", "rethinkdb"),
    ("disque", "disque"), ("rabbitmq", "rabbitmq"),
    ("robustirc", "robustirc")])
def test_db_setup_commands_as_the_references(suite, needle, monkeypatch):
    import time
    monkeypatch.setattr(time, "sleep", lambda s: None)
    nodes = ["n1", "n2", "n3"]
    ref = db_commands(REF, suite, nodes)
    port = db_commands(PORT, suite, nodes)
    assert port == ref
    assert any(needle in p for _n, k, p in port
               if k in ("execute", "upload"))


def fault_commands(P, db) -> list:
    test = {"nodes": ["n1"], "ssh": {"dummy": True}}
    remote = P["control"].remote_for(test)
    with P["control"].bind_session(P["control"].session(test, "n1")):
        db.kill(test, "n1")
        db.pause(test, "n1")
        db.resume(test, "n1")
        db.start(test, "n1")
    return [str(p) for _, k, p in remote.actions if k == "execute"]


@pytest.mark.parametrize("suite,cls", [
    ("raftis", "RaftisDB"), ("rethinkdb", "RethinkDB"),
    ("disque", "DisqueDB"), ("rabbitmq", "RabbitDB")])
def test_signal_process_dbs_kill_pause_as_the_references(suite, cls):
    """tests/test_suite_faults.py's kill/pause protocol: the same kill
    -KILL, -STOP and -CONT commands, and restart, in both packages."""
    from jepsen_tpu import db as ref_db
    from jepsen_tpu_torch import db as port_db
    got = {}
    for name, P, D in (("ref", REF, ref_db), ("port", PORT, port_db)):
        db = getattr(P[suite], cls)()
        assert isinstance(db, D.Process) and isinstance(db, D.Pause)
        got[name] = fault_commands(P, db)
    assert got["port"] == got["ref"]
    cmds = " || ".join(got["port"])
    assert "kill -KILL" in cmds and "kill -STOP" in cmds \
        and "kill -CONT" in cmds


def test_robustirc_db_has_no_signal_protocol_as_the_reference():
    from jepsen_tpu import db as ref_db
    from jepsen_tpu_torch import db as port_db
    for P, D in ((REF, ref_db), (PORT, port_db)):
        db = P["robustirc"].RobustIRCDB()
        assert not isinstance(db, D.Process)
        assert isinstance(db, D.LogFiles)
        assert db.log_files({}, "n1") == [REF["robustirc"].LOGFILE]


def test_disque_cluster_meet_as_the_reference(monkeypatch, recorded):
    """Node 0 of a live (not dummy) cluster meets its peers over RESP:
    the same commands reach the fake from both packages."""
    import time
    monkeypatch.setattr(time, "sleep", lambda s: None)
    got = {}
    with FakeDisqueServer() as srv:
        for name, P in PKGS:
            monkeypatch.setattr(P["disque"], "PORT", srv.port)
            remote = P["control"].DummyRemote()
            test = {"nodes": ["127.0.0.1", "n2", "n3"], "ssh": {},
                    "remote": remote}
            with P["control"].bind_session(
                    P["control"].session(test, "127.0.0.1")):
                P["disque"].DisqueDB().setup(test, "127.0.0.1")
            got[name] = sorted(str(p) for _n, _k, p in remote.actions)
    assert got["port"] == got["ref"]
    ref_sock, port_sock = recorded
    assert bytes(port_sock.sent) == bytes(ref_sock.sent)
    assert b"MEET\r\n$2\r\nn2" in bytes(port_sock.sent)


# ---------------------------------------------------------------------------
# End to end through each suite's main
# ---------------------------------------------------------------------------

#: name -> (suite, fake, --workload or None, extra opts, concurrency)
RUNS = {
    "raftis-register": ("raftis", FakeRedisServer, None, {}, 4),
    "rethinkdb-register": ("rethinkdb", FakeReqlServer, "register", {}, 4),
    "rethinkdb-set": ("rethinkdb", FakeReqlServer, "set", {}, 5),
    "disque-queue": ("disque", FakeDisqueServer, None, {}, 5),
    "rabbitmq-queue": ("rabbitmq", FakeAMQPServer, None, {}, 5),
    "robustirc-set": ("robustirc", FakeRobustIRCServer, "set",
                      {"tls": False}, 5),
}
#: the runs whose results compose plots, run a second time without
#: matplotlib
NO_MPL = ("disque-queue", "rabbitmq-queue")


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


@pytest.mark.parametrize("which,mpl", [
    *[(w, True) for w in sorted(RUNS)],
    *[(w, False) for w in NO_MPL]],
    ids=lambda x: x if isinstance(x, str) else ("mpl" if x else "no-mpl"))
def test_suite_main_equals_the_reference(which, mpl, tmp_path,
                                         reference_env, monkeypatch):
    """The suite's `main` (`test --dummy --device cpu [--workload W]`)
    against its fake; the two packages' re-checks of the stored run, in
    turn on one path, give the same results (per key for registers) and
    files; the queues lose no acknowledged enqueue and drain after the
    limit; without matplotlib the plot entries are unknown in both and
    the run exits 2."""
    if not mpl:
        block_matplotlib(monkeypatch)
    suite, _fake, workload, extra, _conc = RUNS[which]
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
    assert nem <= {"start", "stop"} and "start" in nem
    assert any("iptables" in str(p) for _n, k, p in remote.actions
               if k == "execute")
    stored = json.loads((run / "test.json").read_text())
    assert stored["device"] == "cpu"
    name = workload or ("queue" if suite in ("disque", "rabbitmq")
                        else "register")
    out = recheck_in_turn(
        run, tmp_path,
        lambda P: getattr(P[suite], SUITES[suite])(
            {"workload": name, **extra})["checker"],
        monkeypatch, pkgs=(REF, PORT))
    if mpl:
        got = same_recheck(out)
    else:
        (rrc, rres, rfiles), (prc, pres, pfiles) = out["ref"], out["port"]
        assert prc == rrc == 2
        assert strip_plot_errors(pres) == strip_plot_errors(rres)
        assert pres["perf"]["valid?"] == "unknown"
        assert "matplotlib" in str(pres["perf"])
        assert not [f for f in pfiles if f.endswith(".png")]
        assert sorted(pfiles) == sorted(rfiles)
        got = pres
    assert got["valid?"] == res["valid?"]
    if name == "register":
        assert per_key(got) == per_key(res) and per_key(res)
        assert all(v is True for v in per_key(res).values())
        # a plain register: the host WGL engine in both packages
        assert {r["analyzer"] for r in res["results"].values()} == {"wgl"}
    if name == "queue":
        q = res["queue"]
        assert q["valid?"] is True and q["lost-count"] == 0
        assert q["acknowledged-count"] > 0
        assert any(o["f"] == "drain" and o["type"] == "ok"
                   for o in client_ops)
        last_drain = max(i for i, o in enumerate(hist)
                         if o["f"] == "drain")
        last_enqueue = max(i for i, o in enumerate(hist)
                           if o["f"] == "enqueue")
        assert last_drain > last_enqueue
    if name == "set":
        assert res["valid?"] is True and res["ok-count"] > 0
        assert res["lost-count"] == 0


@pytest.mark.parametrize("which", sorted(RUNS))
def test_suite_main_without_a_card_answers_on_the_host(which, tmp_path,
                                                       monkeypatch):
    """No checker of these suites is a device path: the registers' model
    is the plain read/write `register`, which the reference's
    `Linearizable` gives its host WGL engine (only a fresh CAS register
    takes the device tiers), and `total_queue` and `set` are host
    checkers. So without a card and without --device each run still
    gets its verdict, and exits as with --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines, _ = main_run(which, tmp_path, monkeypatch, device=())
    assert len(lines) == 1
    res = json.loads((Path(lines[0]["dir"]) / "results.json").read_text())
    assert res["valid?"] is True and rc == 0
    stored = json.loads((Path(lines[0]["dir"]) / "test.json").read_text())
    assert stored.get("device") is None
    if RUNS[which][0] in ("raftis", "rethinkdb") and \
            RUNS[which][2] != "set":
        assert {r["analyzer"] for r in res["results"].values()} == {"wgl"}


def test_load_suite_returns_the_queue_suites():
    for name in SUITES:
        assert port_suites.load_suite(name) is PORT[name]
    # the last five suites load the port's modules too: none is left
    for name in ("charybdefs", "chronos", "crate", "elasticsearch",
                 "logcabin"):
        mod = port_suites.load_suite(name)
        assert mod.__name__ == f"jepsen_tpu_torch.suites.{name}"
        assert callable(mod.main) and callable(mod.workloads)


# ---------------------------------------------------------------------------
# The queue, causal and cycle workloads
# ---------------------------------------------------------------------------

def queue_history(seed: int, n: int = 200) -> list:
    """Seeded enqueues and dequeues (ok, fail, info) and drains (ok,
    fail): values lost, duplicated, unexpected and recovered among
    them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        typ = ["ok", "ok", "fail", "info"][int(rng.integers(0, 4))]
        f = ["enqueue", "enqueue", "dequeue", "drain"][
            int(rng.integers(0, 4))]
        v = int(rng.integers(0, 60))
        out.append({"type": "invoke", "f": f, "process": i % 5,
                    "value": v if f == "enqueue" else None})
        if f == "drain":
            typ = "fail" if typ == "info" else typ
            val = [int(x) for x in rng.integers(0, 70,
                                                int(rng.integers(0, 4)))]
        else:
            val = v if f == "enqueue" else int(rng.integers(0, 70))
        out.append({"type": typ, "f": f, "process": i % 5, "value": val})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_queue_checker_equals_the_references(seed):
    hist = queue_history(seed)
    ref = REF["queue"].test(5)["checker"].check({}, copy.deepcopy(hist), {})
    port = PORT["queue"].test(5)["checker"].check({}, copy.deepcopy(hist),
                                                  {})
    assert port == ref


def test_queue_checker_refuses_a_crashed_drain_as_the_reference():
    hist = [{"type": "invoke", "f": "drain", "process": 0, "value": None},
            {"type": "info", "f": "drain", "process": 0, "value": [3]}]
    errors = []
    for _name, P in PKGS:
        with pytest.raises(ValueError) as ei:
            P["queue"].test()["checker"].check({}, copy.deepcopy(hist), {})
        errors.append(str(ei.value))
    assert errors[0] == errors[1]
    assert "can't handle a crashed drain operation" in errors[1]


def test_queue_workload_package_as_the_references():
    for n in (None, 5, 500):
        ref, port = REF["queue"].test(n, x=1), PORT["queue"].test(n, x=1)
        assert sorted(port) == sorted(ref) == [
            "checker", "final_generator", "generator", "x"]
        assert type(port["checker"]).__name__ == \
            type(ref["checker"]).__name__ == "TotalQueue"


def causal_op(f, value=None, position=None, link=None):
    return {"type": "ok", "process": 0, "f": f, "value": value,
            "position": position, "link": link}


#: tests/test_workloads_extra.py's causal cases
CAUSAL_CASES = {
    "valid-order": ([causal_op("read-init", 0, 1, "init"),
                     causal_op("write", 1, 2, 1),
                     causal_op("read", 1, 3, 2),
                     causal_op("write", 2, 4, 3),
                     causal_op("read", 2, 5, 4)], True),
    "bad-link": ([causal_op("read-init", 0, 1, "init"),
                  causal_op("write", 1, 2, 99)], False),
    "stale-read": ([causal_op("read-init", 0, 1, "init"),
                    causal_op("write", 1, 2, 1),
                    causal_op("read", 0, 3, 2)], False),
    "wrong-write-value": ([causal_op("write", 7, 1, "init")], False),
    "nil-read": ([causal_op("read", None, 1, "init")], True),
    "init-after-write": ([causal_op("write", 1, 1, "init"),
                          causal_op("read-init", 1, 2, 1)], True),
    "unknown-f": ([causal_op("frob", 1, 1, "init")], False),
}


@pytest.mark.parametrize("case", sorted(CAUSAL_CASES))
def test_causal_cases_as_the_references(case):
    hist, valid = CAUSAL_CASES[case]
    ref = REF["causal"].check().check({}, copy.deepcopy(hist), {})
    port = PORT["causal"].check().check({}, copy.deepcopy(hist), {})
    assert port == ref
    assert port["valid?"] is valid
    if case == "bad-link":
        assert "Cannot link" in port["error"]
    if case == "wrong-write-value":
        assert "expected value 1" in port["error"]


def causal_history(seed: int) -> list:
    """A seeded walk of the causal order with a mistake now and then
    (a wrong value or a wrong link), failed ops mixed in."""
    rng = np.random.default_rng(seed)
    out, pos, value, last = [], 0, 0, "init"
    for f in ["read-init", "write", "read", "write", "read"] * 3:
        pos += 1
        v = value + 1 if f == "write" else value
        if rng.random() < 0.1:
            v += 1
        link = last if rng.random() > 0.1 else pos + 7
        typ = "ok" if rng.random() > 0.15 else "fail"
        out.append({"type": typ, "process": 0, "f": f, "value": v,
                    "position": pos, "link": link})
        if typ == "ok":
            value, last = (v if f == "write" else value), pos
    return out


@pytest.mark.parametrize("seed", range(12))
def test_causal_checker_equals_the_references_on_seeded_histories(seed):
    hist = causal_history(seed)
    ref = REF["causal"].check().check({}, copy.deepcopy(hist), {})
    port = PORT["causal"].check().check({}, copy.deepcopy(hist), {})
    assert port == ref


def test_causal_independent_checker_as_the_references():
    """The workload package's checker runs the model per key."""
    def lifted(P):
        t = P["ind"].tuple_
        return [{**o, "value": t(k, o["value"])}
                for k in (0, 1) for o in CAUSAL_CASES[
                    "valid-order" if k == 0 else "stale-read"][0]]

    got = {}
    for name, P in PKGS:
        chk = P["causal"].test(5)["checker"]
        got[name] = plain(chk.check({}, lifted(P), {}))
    assert got["port"] == got["ref"]
    assert got["port"]["valid?"] is False
    assert per_key(got["port"]) == {0: True, 1: False} or \
        per_key(got["port"]) == {"0": True, "1": False}


def ok(process, f, value):
    return {"type": "ok", "process": process, "f": f, "value": value}


def test_cycle_cases_as_the_references():
    """tests/test_workloads_extra.py's cycle cases: a two-op cycle with
    its explanation, and an acyclic graph."""
    h = [ok(0, "txn", None), ok(1, "txn", None), ok(2, "txn", None)]

    def analyzer(history):
        return [(0, 1, "ww"), (1, 0, "ww")], lambda comp: "0<->1"

    got = {}
    for name, P in PKGS:
        got[name] = (
            P["cycle"].checker(analyzer).check({}, copy.deepcopy(h), {}),
            P["cycle"].checker(lambda hist: [(0, 1, "ww")]).check(
                {}, copy.deepcopy(h[:2]), {}))
    assert got["port"] == got["ref"]
    res, acyclic = got["port"]
    assert res["valid?"] is False and res["scc-count"] == 1
    assert res["cycles"][0]["explanation"] == "0<->1"
    assert [o["index"] for o in res["cycles"][0]["ops"]] == [0, 1]
    assert acyclic["valid?"] is True


@pytest.mark.parametrize("seed", range(8))
def test_cycle_checker_equals_the_references_on_seeded_graphs(seed):
    """Seeded edge lists over 40 ops (several SCCs, self-loops, edges
    given twice): the same cycles in the same order, with and without
    an explainer."""
    rng = np.random.default_rng(seed)
    n = 40
    h = [ok(i % 4, "txn", i) for i in range(n)]
    edges = [(int(a), int(b), "rw") for a, b in
             rng.integers(0, n, (int(rng.integers(10, 60)), 2))]

    def explain(comp):
        return f"{len(comp)} ops from {comp[0]}"

    for expl in (None, explain):
        analyzer = (lambda hist: edges) if expl is None else \
            (lambda hist: (edges, expl))
        ref = REF["cycle"].checker(analyzer).check({}, copy.deepcopy(h), {})
        port = PORT["cycle"].checker(analyzer).check({}, copy.deepcopy(h),
                                                     {})
        assert port == ref
