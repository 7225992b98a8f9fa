"""CQL binary protocol v4 client (no external deps).

Speaks the Cassandra native protocol for YugabyteDB's YCQL API — the
reference's yugabyte suite drives YCQL through the java cassandra
driver (yugabyte/src/yugabyte/ycql/*). One socket, synchronous,
unprepared QUERY messages only: a jepsen worker needs nothing more, and
text-literal statements keep the client honest about exactly what hits
the server.

Frame: version:1 flags:1 stream:2 opcode:1 length:4, big-endian
(protocol spec §2). Results decode by column type id; only the types
YCQL workloads touch are mapped (varchar/int/bigint/boolean/list).

The port's copy of `jepsen_tpu/drivers/cql.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass, field

from . import DBError, DriverError

REQUEST = 0x04
RESPONSE = 0x84

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

CONSISTENCY_QUORUM = 0x0004

KIND_VOID = 0x0001
KIND_ROWS = 0x0002
KIND_SET_KEYSPACE = 0x0003
KIND_SCHEMA_CHANGE = 0x0005

TYPE_BIGINT = 0x0002
TYPE_BOOLEAN = 0x0004
TYPE_INT = 0x0009
TYPE_VARCHAR = 0x000D
TYPE_LIST = 0x0020


@dataclass
class Result:
    columns: list = field(default_factory=list)
    rows: list = field(default_factory=list)
    kind: int = KIND_VOID


class CQLConn:
    def __init__(self, host: str, port: int = 9042,
                 user: str | None = None, password: str | None = None,
                 keyspace: str | None = None, timeout: float = 10.0):
        self.host, self.port = host, port
        self._buf = b""
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.settimeout(timeout)
            self._startup(user, password)
            if keyspace:
                self.query(f"USE {keyspace}")
        except (OSError, DriverError, DBError):
            self._abandon()
            raise

    # -- framing --------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                chunk = self.sock.recv(65536)
            except OSError as e:
                self._abandon()
                raise DriverError(f"recv failed: {e}") from e
            if not chunk:
                self._abandon()
                raise DriverError("connection closed by server")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _send_frame(self, opcode: int, body: bytes) -> None:
        try:
            self.sock.sendall(struct.pack("!BBhBI", REQUEST, 0, 0,
                                          opcode, len(body)) + body)
        except OSError as e:
            self._abandon()
            raise DriverError(f"send failed: {e}") from e

    def _recv_frame(self) -> tuple[int, bytes]:
        head = self._recv_exact(9)
        _ver, _flags, _stream, opcode, length = struct.unpack("!BBhBI",
                                                              head)
        return opcode, self._recv_exact(length)

    def _abandon(self) -> None:
        try:
            if getattr(self, "sock", None) is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None

    # -- startup --------------------------------------------------------

    def _startup(self, user, password) -> None:
        opts = {"CQL_VERSION": "3.0.0"}
        body = struct.pack("!H", len(opts))
        for k, v in opts.items():
            body += _string(k) + _string(v)
        self._send_frame(OP_STARTUP, body)
        opcode, data = self._recv_frame()
        if opcode == OP_READY:
            return
        if opcode == OP_AUTHENTICATE:
            token = b"\0" + (user or "").encode() + b"\0" + \
                (password or "").encode()
            self._send_frame(OP_AUTH_RESPONSE,
                             struct.pack("!i", len(token)) + token)
            opcode, data = self._recv_frame()
            if opcode == OP_AUTH_SUCCESS:
                return
        if opcode == OP_ERROR:
            raise _error(data)
        raise DriverError(f"unexpected startup opcode 0x{opcode:02x}")

    # -- queries --------------------------------------------------------

    def query(self, cql: str,
              consistency: int = CONSISTENCY_QUORUM) -> Result:
        if self.sock is None:
            raise DriverError("connection is closed")
        body = _long_string(cql) + struct.pack("!HB", consistency, 0)
        self._send_frame(OP_QUERY, body)
        opcode, data = self._recv_frame()
        if opcode == OP_ERROR:
            raise _error(data)
        if opcode != OP_RESULT:
            self._abandon()
            raise DriverError(f"unexpected opcode 0x{opcode:02x}")
        return _result(data)

    exec = query

    def close(self) -> None:
        self._abandon()


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("!H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("!I", len(b)) + b


def _read_string(data: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("!H", data, off)
    off += 2
    return data[off:off + n].decode(), off + n


def _error(data: bytes) -> DBError:
    (code,) = struct.unpack_from("!i", data, 0)
    msg, _ = _read_string(data, 4)
    return DBError(f"cql-{code:#06x}", msg)


def _read_type(data: bytes, off: int) -> tuple[tuple, int]:
    (tid,) = struct.unpack_from("!H", data, off)
    off += 2
    if tid == TYPE_LIST:
        inner, off = _read_type(data, off)
        return (tid, inner), off
    if tid == 0x0000:  # custom: class name string follows
        _, off = _read_string(data, off)
    return (tid, None), off


def _decode(value: bytes | None, typ: tuple):
    if value is None:
        return None
    tid, inner = typ
    if tid == TYPE_BIGINT:
        return struct.unpack("!q", value)[0]
    if tid == TYPE_INT:
        return struct.unpack("!i", value)[0]
    if tid == TYPE_BOOLEAN:
        return bool(value[0])
    if tid == TYPE_LIST:
        (n,) = struct.unpack_from("!i", value, 0)
        off, out = 4, []
        for _ in range(n):
            (ln,) = struct.unpack_from("!i", value, off)
            off += 4
            if ln < 0:
                out.append(None)
            else:
                out.append(_decode(value[off:off + ln], inner))
                off += ln
        return out
    return value.decode()  # varchar & fallback


def _result(data: bytes) -> Result:
    (kind,) = struct.unpack_from("!i", data, 0)
    if kind != KIND_ROWS:
        return Result(kind=kind)
    off = 4
    flags, ncols = struct.unpack_from("!iI", data, off)
    off += 8
    if flags & 0x0002:  # has_more_pages: paging state bytes
        (n,) = struct.unpack_from("!i", data, off)
        off += 4 + max(0, n)
    global_spec = bool(flags & 0x0001)
    if global_spec:
        _, off = _read_string(data, off)
        _, off = _read_string(data, off)
    cols, types = [], []
    for _ in range(ncols):
        if not global_spec:
            _, off = _read_string(data, off)
            _, off = _read_string(data, off)
        name, off = _read_string(data, off)
        typ, off = _read_type(data, off)
        cols.append(name)
        types.append(typ)
    (nrows,) = struct.unpack_from("!i", data, off)
    off += 4
    rows = []
    for _ in range(nrows):
        row = []
        for c in range(ncols):
            (ln,) = struct.unpack_from("!i", data, off)
            off += 4
            if ln < 0:
                row.append(None)
            else:
                row.append(_decode(data[off:off + ln], types[c]))
                off += ln
        rows.append(row)
    return Result(columns=cols, rows=rows, kind=kind)


def connect(host: str, port: int = 9042, user: str | None = None,
            password: str | None = None, keyspace: str | None = None,
            timeout: float = 10.0) -> CQLConn:
    return CQLConn(host, port, user, password, keyspace, timeout)
