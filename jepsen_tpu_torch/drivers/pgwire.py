"""PostgreSQL wire protocol v3 client (no external deps).

Speaks the simple-query protocol against anything pg-compatible:
PostgreSQL itself, CockroachDB (--insecure => trust auth), and
YugabyteDB's YSQL port. Replaces the jdbc client layer of the
reference's SQL suites (cockroachdb/src/jepsen/cockroach/client.clj:1-60).

Supported auth: trust, cleartext password, md5, SCRAM-SHA-256.
Unsupported: TLS, COPY, extended query protocol — a jepsen client only
ever needs `BEGIN; ...; COMMIT` round-trips, and the simple protocol
pipelines a whole transaction in one message anyway.

Wire format (https://www.postgresql.org/docs/current/protocol.html):
every backend message is `type:1 len:4 payload`, where len includes
itself; the startup message has no type byte.

The port's copy of `jepsen_tpu/drivers/pgwire.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct
from dataclasses import dataclass, field

from . import DBError, DriverError

PROTOCOL_V3 = 196608  # 3 << 16


@dataclass
class Result:
    """One statement's result: column names, text-decoded rows, and the
    CommandComplete tag ("SELECT 3", "INSERT 0 1", ...)."""
    columns: list = field(default_factory=list)
    rows: list = field(default_factory=list)
    tag: str = ""


class PGConn:
    def __init__(self, host: str, port: int = 5432, user: str = "root",
                 database: str = "postgres", password: str | None = None,
                 timeout: float = 10.0, options: dict | None = None):
        self.host, self.port, self.user = host, port, user
        self.database = database
        self._buf = b""
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.settimeout(timeout)
            self._startup(password, options or {})
        except (OSError, DriverError, DBError):
            self._abandon()
            raise

    # ---- low-level framing -------------------------------------------

    def _send(self, type_byte: bytes, payload: bytes) -> None:
        try:
            self.sock.sendall(type_byte +
                              struct.pack("!I", len(payload) + 4) + payload)
        except OSError as e:
            self._abandon()
            raise DriverError(f"send failed: {e}") from e

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

    def _recv_msg(self) -> tuple[bytes, bytes]:
        head = self._recv_exact(5)
        mtype = head[:1]
        (length,) = struct.unpack("!I", head[1:5])
        return mtype, self._recv_exact(length - 4)

    def _abandon(self) -> None:
        try:
            if getattr(self, "sock", None) is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None

    # ---- startup / auth ----------------------------------------------

    def _startup(self, password: str | None, options: dict) -> None:
        params = {"user": self.user, "database": self.database, **options}
        body = b"".join(k.encode() + b"\0" + v.encode() + b"\0"
                        for k, v in params.items()) + b"\0"
        payload = struct.pack("!II", len(body) + 8, PROTOCOL_V3) + body
        try:
            self.sock.sendall(payload)
        except OSError as e:
            raise DriverError(f"startup send failed: {e}") from e
        scram = None
        while True:
            mtype, data = self._recv_msg()
            if mtype == b"R":
                (code,) = struct.unpack("!I", data[:4])
                if code == 0:                     # AuthenticationOk
                    continue
                if code == 3:                     # CleartextPassword
                    self._send(b"p", (password or "").encode() + b"\0")
                elif code == 5:                   # MD5Password
                    salt = data[4:8]
                    inner = hashlib.md5(
                        (password or "").encode() +
                        self.user.encode()).hexdigest()
                    outer = hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._send(b"p", b"md5" + outer.encode() + b"\0")
                elif code == 10:                  # SASL
                    mechs = data[4:].split(b"\0")
                    if b"SCRAM-SHA-256" not in mechs:
                        raise DriverError(
                            f"no supported SASL mechanism in {mechs}")
                    scram = _ScramClient(self.user, password or "")
                    first = scram.client_first().encode()
                    self._send(b"p", b"SCRAM-SHA-256\0" +
                               struct.pack("!I", len(first)) + first)
                elif code == 11:                  # SASLContinue
                    assert scram is not None
                    self._send(b"p",
                               scram.client_final(data[4:].decode()).encode())
                elif code == 12:                  # SASLFinal
                    assert scram is not None
                    scram.verify_server(data[4:].decode())
                else:
                    raise DriverError(f"unsupported auth method {code}")
            elif mtype in (b"S", b"K", b"N"):     # ParameterStatus/KeyData
                continue
            elif mtype == b"Z":                   # ReadyForQuery
                return
            elif mtype == b"E":
                raise _error(data)
            else:
                raise DriverError(f"unexpected startup msg {mtype!r}")

    # ---- queries ------------------------------------------------------

    def query(self, sql: str) -> list[Result]:
        """Run one simple-query round trip. `sql` may contain several
        statements separated by ';' — each yields a Result. Raises
        DBError on backend errors, DriverError on transport failure."""
        if self.sock is None:
            raise DriverError("connection is closed")
        self._send(b"Q", sql.encode() + b"\0")
        results: list[Result] = []
        current: Result | None = None
        error: DBError | None = None
        while True:
            mtype, data = self._recv_msg()
            if mtype == b"T":                     # RowDescription
                current = Result(columns=_row_description(data))
            elif mtype == b"D":                   # DataRow
                if current is None:
                    current = Result()
                current.rows.append(_data_row(data))
            elif mtype == b"C":                   # CommandComplete
                if current is None:
                    current = Result()
                current.tag = data.rstrip(b"\0").decode()
                results.append(current)
                current = None
            elif mtype == b"I":                   # EmptyQueryResponse
                results.append(Result())
            elif mtype == b"E":
                error = _error(data)
            elif mtype == b"N":                   # NoticeResponse
                continue
            elif mtype == b"Z":                   # ReadyForQuery
                if error is not None:
                    raise error
                return results
            else:
                self._abandon()
                raise DriverError(f"unexpected msg {mtype!r}")

    def exec(self, sql: str) -> Result:
        """One statement; returns its single Result."""
        res = self.query(sql)
        return res[0] if res else Result()

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._send(b"X", b"")
            except DriverError:
                pass
            self._abandon()


def _row_description(data: bytes) -> list[str]:
    (n,) = struct.unpack("!H", data[:2])
    cols, off = [], 2
    for _ in range(n):
        end = data.index(b"\0", off)
        cols.append(data[off:end].decode())
        off = end + 1 + 18  # tableoid:4 attnum:2 typoid:4 len:2 mod:4 fmt:2
    return cols


def _data_row(data: bytes) -> list:
    (n,) = struct.unpack("!H", data[:2])
    row, off = [], 2
    for _ in range(n):
        (length,) = struct.unpack("!i", data[off:off + 4])
        off += 4
        if length == -1:
            row.append(None)
        else:
            row.append(data[off:off + length].decode())
            off += length
    return row


def _error(data: bytes) -> DBError:
    fields = {}
    for part in data.split(b"\0"):
        if part:
            fields[chr(part[0])] = part[1:].decode(errors="replace")
    return DBError(fields.get("C", "XX000"), fields.get("M", "unknown"))


class _ScramClient:
    """SCRAM-SHA-256 (RFC 5802/7677), channel-binding 'n' (no TLS)."""

    def __init__(self, user: str, password: str):
        self.password = password
        self.nonce = base64.b64encode(os.urandom(18)).decode()
        # pg ignores the SCRAM username (uses the startup user)
        self.first_bare = f"n=,r={self.nonce}"
        self.server_signature: bytes | None = None

    def client_first(self) -> str:
        return "n,," + self.first_bare

    def client_final(self, server_first: str) -> str:
        attrs = dict(p.split("=", 1) for p in server_first.split(","))
        r, s, i = attrs["r"], attrs["s"], int(attrs["i"])
        if not r.startswith(self.nonce):
            raise DriverError("SCRAM server nonce mismatch")
        salted = hashlib.pbkdf2_hmac(
            "sha256", self.password.encode(), base64.b64decode(s), i)
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        final_bare = f"c=biws,r={r}"
        auth_msg = ",".join(
            (self.first_bare, server_first, final_bare)).encode()
        client_sig = hmac.digest(stored_key, auth_msg, "sha256")
        proof = bytes(a ^ b for a, b in zip(client_key, client_sig))
        server_key = hmac.digest(salted, b"Server Key", "sha256")
        self.server_signature = hmac.digest(server_key, auth_msg, "sha256")
        return f"{final_bare},p={base64.b64encode(proof).decode()}"

    def verify_server(self, server_final: str) -> None:
        attrs = dict(p.split("=", 1) for p in server_final.split(","))
        if "e" in attrs:
            raise DBError("28P01", f"SCRAM error: {attrs['e']}")
        if base64.b64decode(attrs["v"]) != self.server_signature:
            raise DriverError("SCRAM server signature mismatch")


def connect(host: str, port: int = 5432, user: str = "root",
            database: str = "postgres", password: str | None = None,
            timeout: float = 10.0, **kw) -> PGConn:
    return PGConn(host, port, user, database, password, timeout, **kw)
