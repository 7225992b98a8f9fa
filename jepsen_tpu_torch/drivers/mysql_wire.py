"""MySQL client/server protocol driver (no external deps).

Speaks the text protocol against MySQL-compatible servers — built for
TiDB, which the reference drives through jdbc/mysql
(tidb/src/tidb/sql.clj). Supports the classic handshake
(HandshakeV10 / HandshakeResponse41), mysql_native_password and
cleartext auth, COM_QUERY with text result sets, and COM_QUIT.
CLIENT_DEPRECATE_EOF is deliberately not negotiated so result sets use
the classic EOF framing (one framing to parse, and every server still
speaks it).

Wire format (https://dev.mysql.com/doc/dev/mysql-server/latest/):
packets are `len:3(LE) seq:1 payload`, sequence id resets per command.

The port's copy of `jepsen_tpu/drivers/mysql_wire.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import hashlib
import socket
import struct
from dataclasses import dataclass, field

from . import DBError, DriverError

CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_TRANSACTIONS = 0x00002000
CLIENT_SECURE_CONNECTION = 0x00008000
CLIENT_PLUGIN_AUTH = 0x00080000

SERVER_MORE_RESULTS_EXISTS = 0x0008


@dataclass
class Result:
    columns: list = field(default_factory=list)
    rows: list = field(default_factory=list)
    affected_rows: int = 0
    last_insert_id: int = 0


class MyConn:
    def __init__(self, host: str, port: int = 3306, user: str = "root",
                 database: str = "", password: str = "",
                 timeout: float = 10.0):
        self.host, self.port, self.user = host, port, user
        self._buf = b""
        self._seq = 0
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.settimeout(timeout)
            self._handshake(database, password)
        except (OSError, DriverError, DBError):
            self._abandon()
            raise

    # ---- framing ------------------------------------------------------

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

    def _recv_packet(self) -> bytes:
        head = self._recv_exact(4)
        length = head[0] | (head[1] << 8) | (head[2] << 16)
        self._seq = (head[3] + 1) & 0xFF
        payload = self._recv_exact(length)
        if length == 0xFFFFFF:  # continuation framing for >16MB payloads
            payload += self._recv_packet()
        return payload

    def _send_packet(self, payload: bytes) -> None:
        try:
            self.sock.sendall(
                struct.pack("<I", len(payload))[:3] +
                bytes([self._seq]) + payload)
            self._seq = (self._seq + 1) & 0xFF
        except OSError as e:
            self._abandon()
            raise DriverError(f"send failed: {e}") from e

    def _abandon(self) -> None:
        try:
            if getattr(self, "sock", None) is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None

    # ---- handshake ----------------------------------------------------

    def _handshake(self, database: str, password: str) -> None:
        greeting = self._recv_packet()
        if greeting[:1] == b"\xff":
            raise _err_packet(greeting)
        if greeting[0] != 10:
            raise DriverError(f"unsupported protocol {greeting[0]}")
        off = 1
        end = greeting.index(b"\0", off)           # server version
        off = end + 1 + 4                          # thread id
        auth_data = greeting[off:off + 8]          # scramble part 1
        off += 8 + 1                               # filler
        off += 2                                   # capabilities (lower)
        plugin = "mysql_native_password"
        if len(greeting) > off:
            off += 1 + 2 + 2                       # charset, status, cap hi
            auth_len = greeting[off]
            off += 1 + 10                          # reserved
            more = max(13, auth_len - 8)
            auth_data += greeting[off:off + more].rstrip(b"\0")
            off += more
            if off < len(greeting):
                plugin = greeting[off:].split(b"\0")[0].decode()

        caps = (CLIENT_PROTOCOL_41 | CLIENT_SECURE_CONNECTION |
                CLIENT_TRANSACTIONS | CLIENT_PLUGIN_AUTH)
        if database:
            caps |= CLIENT_CONNECT_WITH_DB
        auth = _scramble(password, auth_data[:20], plugin)
        payload = struct.pack("<IIB23x", caps, 1 << 24, 33)
        payload += self.user.encode() + b"\0"
        payload += bytes([len(auth)]) + auth
        if database:
            payload += database.encode() + b"\0"
        payload += plugin.encode() + b"\0"
        self._send_packet(payload)

        pkt = self._recv_packet()
        while True:
            if pkt[:1] == b"\x00":
                return
            if pkt[:1] == b"\xff":
                raise _err_packet(pkt)
            if pkt[:1] == b"\xfe":                 # AuthSwitchRequest
                parts = pkt[1:].split(b"\0")
                plugin = parts[0].decode()
                seed = parts[1] if len(parts) > 1 else b""
                self._send_packet(_scramble(password, seed[:20], plugin))
                pkt = self._recv_packet()
            elif pkt[:1] == b"\x01":               # AuthMoreData
                pkt = self._recv_packet()
            else:
                raise DriverError(f"unexpected auth packet {pkt[:1]!r}")

    # ---- queries ------------------------------------------------------

    def query(self, sql: str) -> Result:
        if self.sock is None:
            raise DriverError("connection is closed")
        self._seq = 0
        self._send_packet(b"\x03" + sql.encode())
        return self._read_result()

    exec = query

    def _read_result(self) -> Result:
        pkt = self._recv_packet()
        if pkt[:1] == b"\xff":
            raise _err_packet(pkt)
        if pkt[:1] == b"\x00":                     # OK
            affected, off = _lenenc_int(pkt, 1)
            last_id, _ = _lenenc_int(pkt, off)
            return Result(affected_rows=affected, last_insert_id=last_id)
        ncols, _ = _lenenc_int(pkt, 0)
        cols = []
        for _ in range(ncols):
            cols.append(_column_name(self._recv_packet()))
        eof = self._recv_packet()
        if eof[:1] != b"\xfe":
            raise DriverError("expected EOF after column definitions")
        rows = []
        while True:
            pkt = self._recv_packet()
            if pkt[:1] == b"\xfe" and len(pkt) < 9:  # EOF
                return Result(columns=cols, rows=rows)
            if pkt[:1] == b"\xff":
                raise _err_packet(pkt)
            rows.append(_text_row(pkt, ncols))

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._seq = 0
                self._send_packet(b"\x01")         # COM_QUIT
            except DriverError:
                pass
            self._abandon()


def _scramble(password: str, seed: bytes, plugin: str) -> bytes:
    if not password:
        return b""
    if plugin in ("mysql_native_password", ""):
        # SHA1(pass) XOR SHA1(seed + SHA1(SHA1(pass)))
        h1 = hashlib.sha1(password.encode()).digest()
        h2 = hashlib.sha1(h1).digest()
        h3 = hashlib.sha1(seed + h2).digest()
        return bytes(a ^ b for a, b in zip(h1, h3))
    if plugin == "mysql_clear_password":
        return password.encode() + b"\0"
    if plugin == "caching_sha2_password":
        # fast path: XOR(SHA256(p), SHA256(SHA256(SHA256(p)) + seed))
        h1 = hashlib.sha256(password.encode()).digest()
        h2 = hashlib.sha256(hashlib.sha256(h1).digest() + seed).digest()
        return bytes(a ^ b for a, b in zip(h1, h2))
    raise DriverError(f"unsupported auth plugin {plugin!r}")


def _lenenc_int(data: bytes, off: int) -> tuple[int, int]:
    first = data[off]
    if first < 0xFB:
        return first, off + 1
    if first == 0xFC:
        return struct.unpack_from("<H", data, off + 1)[0], off + 3
    if first == 0xFD:
        b = data[off + 1:off + 4]
        return b[0] | (b[1] << 8) | (b[2] << 16), off + 4
    if first == 0xFE:
        return struct.unpack_from("<Q", data, off + 1)[0], off + 9
    raise DriverError(f"bad length-encoded int 0x{first:x}")


def _lenenc_str(data: bytes, off: int) -> tuple[bytes, int]:
    n, off = _lenenc_int(data, off)
    return data[off:off + n], off + n


def _column_name(pkt: bytes) -> str:
    off = 0
    for _ in range(4):                 # catalog, schema, table, org_table
        _, off = _lenenc_str(pkt, off)
    name, _ = _lenenc_str(pkt, off)
    return name.decode()


def _text_row(pkt: bytes, ncols: int) -> list:
    row, off = [], 0
    for _ in range(ncols):
        if pkt[off] == 0xFB:                       # NULL
            row.append(None)
            off += 1
        else:
            val, off = _lenenc_str(pkt, off)
            row.append(val.decode())
    return row


def _err_packet(pkt: bytes) -> DBError:
    (code,) = struct.unpack_from("<H", pkt, 1)
    off = 3
    if pkt[off:off + 1] == b"#":                   # SQLSTATE marker
        off += 6
    return DBError(code, pkt[off:].decode(errors="replace"))


def connect(host: str, port: int = 3306, user: str = "root",
            database: str = "", password: str = "",
            timeout: float = 10.0) -> MyConn:
    return MyConn(host, port, user, database, password, timeout)
