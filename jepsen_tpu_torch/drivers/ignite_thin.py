"""Apache Ignite thin-client binary protocol driver.

The reference suite drives Ignite through the JVM thick client
(ignite/src/java/client/Client.java, Bank.java); this is a from-scratch
implementation of the documented thin-client binary protocol (port
10800, protocol 1.x as spoken by Ignite 2.7+), covering the cache
surface the register/set/bank workloads need: handshake, get, put,
putIfAbsent, replaceIfEquals (the CAS primitive), and getAndPut.

Wire format: every packet is int32-LE length + body.

  handshake  body = u8 1 | i16 major | i16 minor | i16 patch | u8 2
             response: u8 success (1) | [server ver + error on failure]
  request    body = i16 op | i64 request_id | payload
             response: i64 request_id | i32 status | [error string]
             | payload

Values are binary-protocol typed: u8 type code + LE body (4 long,
8 bool, 9 string, 101 null). Cache ids are the Java String hashCode of
the cache name. Constants follow the published protocol spec; exercised
round-trip against tests/fake_ignite.py (zero-egress build), live
cluster in the opt-in tier.

The port's copy of `jepsen_tpu/drivers/ignite_thin.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading

from . import DBError, DriverError

# -- op codes (thin client protocol) ---------------------------------------
OP_CACHE_GET = 1000
OP_CACHE_PUT = 1001
OP_CACHE_PUT_IF_ABSENT = 1002
OP_CACHE_GET_AND_PUT = 1005
OP_CACHE_REPLACE_IF_EQUALS = 1010
OP_CACHE_GET_OR_CREATE_WITH_NAME = 1052
OP_TX_START = 4000
OP_TX_END = 4001

FLAG_TRANSACTIONAL = 0x02

# -- binary type codes -----------------------------------------------------
T_LONG = 4
T_BOOL = 8
T_STRING = 9
T_NULL = 101


class IgniteError(DBError):
    pass


def java_hash(s: str) -> int:
    """Java String.hashCode — the protocol's cache-name -> cache-id map."""
    h = 0
    for c in s:
        h = (31 * h + ord(c)) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def ser(v) -> bytes:
    if v is None:
        return struct.pack("<B", T_NULL)
    if isinstance(v, bool):
        return struct.pack("<BB", T_BOOL, int(v))
    if isinstance(v, int):
        return struct.pack("<Bq", T_LONG, v)
    if isinstance(v, str):
        b = v.encode()
        return struct.pack("<Bi", T_STRING, len(b)) + b
    raise DriverError(f"unserializable ignite value {v!r}")


def deser(r: "_R"):
    t = r.u8()
    if t == T_NULL:
        return None
    if t == T_BOOL:
        return r.u8() != 0
    if t == T_LONG:
        return r.i64()
    if t == T_STRING:
        return r.take(r.i32()).decode()
    raise DriverError(f"unknown ignite type code {t}")


class _R:
    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise DriverError("truncated ignite payload")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def i16(self) -> int:
        return struct.unpack("<h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.take(8))[0]

    def string(self) -> str | None:
        v = deser(self)
        if v is not None and not isinstance(v, str):
            raise DriverError(f"expected string, got {v!r}")
        return v


class IgniteConn:
    """One handshaked thin-client connection."""

    def __init__(self, host: str, port: int = 10800,
                 timeout: float = 10.0):
        self.lock = threading.Lock()
        self.req_id = itertools.count(1)
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self._handshake()
        except OSError as e:
            raise DriverError(f"ignite connect {host}:{port}: {e}") from e

    def _send_packet(self, body: bytes) -> None:
        self.sock.sendall(struct.pack("<i", len(body)) + body)

    def _recv_packet(self) -> _R:
        head = self._recv_exact(4)
        (ln,) = struct.unpack("<i", head)
        return _R(self._recv_exact(ln))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise DriverError("ignite connection closed")
            buf += chunk
        return buf

    def _handshake(self) -> None:
        self._send_packet(struct.pack("<BhhhB", 1, 1, 0, 0, 2))
        r = self._recv_packet()
        if r.u8() != 1:
            ver = (r.i16(), r.i16(), r.i16())
            msg = r.string() or ""
            raise DBError("handshake", f"server {ver}: {msg}")

    def request(self, op: int, payload: bytes) -> _R:
        with self.lock:
            rid = next(self.req_id)
            try:
                self._send_packet(
                    struct.pack("<hq", op, rid) + payload)
                r = self._recv_packet()
            except OSError as e:
                raise DriverError(f"ignite io: {e}") from e
        got = r.i64()
        if got != rid:
            raise DriverError(f"request id mismatch {got} != {rid}")
        status = r.i32()
        if status != 0:
            raise IgniteError(status, r.string() or f"status {status}")
        return r

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- cache ops ---------------------------------------------------------

    @staticmethod
    def _cache_header(cache: str, tx: int | None = None) -> bytes:
        """Cache id + flags [+ tx id when the op joins a transaction —
        thin-client transactions are protocol 1.5+/Ignite 2.8+]."""
        if tx is None:
            return struct.pack("<iB", java_hash(cache), 0)
        return struct.pack("<iBi", java_hash(cache), FLAG_TRANSACTIONAL,
                           tx)

    # -- transactions (OP_TX_*, Ignite 2.8+) -------------------------------

    def tx_start(self, concurrency: int = 1, isolation: int = 2,
                 timeout_ms: int = 5000) -> int:
        """PESSIMISTIC (1) / REPEATABLE_READ (2) by default — the modes
        the reference bank workload runs under (ignite Client.java)."""
        r = self.request(OP_TX_START,
                         struct.pack("<BBq", concurrency, isolation,
                                     timeout_ms) + ser(None))
        return r.i32()

    def tx_end(self, tx: int, commit: bool) -> None:
        self.request(OP_TX_END, struct.pack("<iB", tx, int(commit)))

    def get_or_create_cache(self, cache: str) -> None:
        self.request(OP_CACHE_GET_OR_CREATE_WITH_NAME, ser(cache))

    def get(self, cache: str, key, tx: int | None = None):
        r = self.request(OP_CACHE_GET,
                         self._cache_header(cache, tx) + ser(key))
        return deser(r)

    def put(self, cache: str, key, value, tx: int | None = None) -> None:
        self.request(OP_CACHE_PUT,
                     self._cache_header(cache, tx) + ser(key) + ser(value))

    def get_and_put(self, cache: str, key, value):
        r = self.request(OP_CACHE_GET_AND_PUT,
                         self._cache_header(cache) + ser(key) + ser(value))
        return deser(r)

    def put_if_absent(self, cache: str, key, value) -> bool:
        r = self.request(OP_CACHE_PUT_IF_ABSENT,
                         self._cache_header(cache) + ser(key) + ser(value))
        return deser(r) is True

    def replace_if_equals(self, cache: str, key, old, new) -> bool:
        r = self.request(
            OP_CACHE_REPLACE_IF_EQUALS,
            self._cache_header(cache) + ser(key) + ser(old) + ser(new))
        return deser(r) is True
