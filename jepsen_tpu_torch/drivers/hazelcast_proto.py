"""Hazelcast Open Client Protocol (1.x) wire driver.

The reference suite drives Hazelcast through the JVM client
(hazelcast/src/jepsen/hazelcast.clj:119-144 `connect`,
lock-client 412, queue-client 270, atomic-long-id-client 146,
map-client 453); this is a from-scratch Python implementation of the
same binary protocol the 3.x client speaks, covering exactly the
surface those workloads need: authentication, IMap get/put/replace/
putIfAbsent, IQueue offer/poll/take/size, ILock lock/tryLock/unlock,
and IAtomicLong incrementAndGet/get/addAndGet.

Wire format (Open Client Protocol 1.x):

  connect, send b"CB2", then length-prefixed client messages:
    frame  = len:int32 LE | version:u8 | flags:u8 (0xC0 begin+end)
           | type:u16 LE | correlation:int64 LE | partition:int32 LE
           | dataOffset:u16 LE (18) | payload
  strings in the payload are int32-length + utf8; values cross as
  hazelcast `Data` blobs: partition-hash:int32 BE | type-id:int32 BE
  | big-endian body (type ids: -8 long, -11 string, -17 long[]).

Constants follow the published protocol spec; in this zero-egress
build they are exercised round-trip against the in-tree fake server
(tests/fake_hazelcast.py), with live-cluster verification in the
opt-in integration tier like every other wire driver here.

The port's copy of `jepsen_tpu/drivers/hazelcast_proto.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading

from . import DBError, DriverError

PROTOCOL_INIT = b"CB2"
VERSION = 1
FLAG_BEGIN_END = 0xC0
HEADER = struct.Struct("<iBBHqiH")  # len, ver, flags, type, corr, part, off
HEADER_SIZE = HEADER.size  # 22

# -- request message types (protocol 1.x codecs) ---------------------------
AUTH = 0x0002
MAP_PUT = 0x0101
MAP_GET = 0x0102
MAP_REPLACE_IF_SAME = 0x0105
MAP_PUT_IF_ABSENT = 0x010D
QUEUE_OFFER = 0x0301
QUEUE_SIZE = 0x0303
QUEUE_POLL = 0x0305
QUEUE_TAKE = 0x0306
LOCK_LOCK = 0x0705
LOCK_UNLOCK = 0x0706
LOCK_TRY_LOCK = 0x0708
ATOMIC_LONG_ADD_AND_GET = 0x0A05
ATOMIC_LONG_GET = 0x0A08
ATOMIC_LONG_INCREMENT_AND_GET = 0x0A0B

# -- response message types ------------------------------------------------
RESP_VOID = 0x0064
RESP_BOOL = 0x0065
RESP_INT = 0x0066
RESP_LONG = 0x0067
RESP_STRING = 0x0068
RESP_DATA = 0x0069
RESP_AUTH = 0x006B
RESP_ERROR = 0x006D

# -- hazelcast serialization type ids (Data body is big-endian) ------------
TYPE_NULL = 0
TYPE_LONG = -8
TYPE_STRING = -11
TYPE_LONG_ARRAY = -17


class HazelcastError(DBError):
    """Server-side error frame (error code + class name + message)."""


def ser_data(v) -> bytes:
    """Python value -> hazelcast Data blob."""
    if v is None:
        return struct.pack(">ii", 0, TYPE_NULL)
    if isinstance(v, bool):
        raise DriverError("bool Data not needed by these workloads")
    if isinstance(v, int):
        return struct.pack(">iiq", 0, TYPE_LONG, v)
    if isinstance(v, str):
        b = v.encode()
        return struct.pack(">ii i", 0, TYPE_STRING, len(b)) + b
    if isinstance(v, (list, tuple)) and all(isinstance(x, int) for x in v):
        return (struct.pack(">iii", 0, TYPE_LONG_ARRAY, len(v))
                + b"".join(struct.pack(">q", x) for x in v))
    raise DriverError(f"unserializable value {v!r}")


def deser_data(b: bytes):
    """Hazelcast Data blob -> Python value."""
    if len(b) < 8:
        raise DriverError(f"short Data blob ({len(b)}B)")
    (tid,) = struct.unpack(">i", b[4:8])
    body = b[8:]
    if tid == TYPE_NULL:
        return None
    if tid == TYPE_LONG:
        return struct.unpack(">q", body)[0]
    if tid == TYPE_STRING:
        (n,) = struct.unpack(">i", body[:4])
        return body[4:4 + n].decode()
    if tid == TYPE_LONG_ARRAY:
        (n,) = struct.unpack(">i", body[:4])
        return list(struct.unpack(f">{n}q", body[4:4 + 8 * n]))
    raise DriverError(f"unknown Data type id {tid}")


class _W:
    """Little-endian payload writer."""

    def __init__(self):
        self.parts: list[bytes] = []

    def string(self, s: str) -> "_W":
        b = s.encode()
        self.parts.append(struct.pack("<i", len(b)) + b)
        return self

    def nullable_string(self, s: str | None) -> "_W":
        if s is None:
            self.parts.append(b"\x01")
        else:
            self.parts.append(b"\x00")
            self.string(s)
        return self

    def boolean(self, v: bool) -> "_W":
        self.parts.append(b"\x01" if v else b"\x00")
        return self

    def u8(self, v: int) -> "_W":
        self.parts.append(struct.pack("<B", v))
        return self

    def i64(self, v: int) -> "_W":
        self.parts.append(struct.pack("<q", v))
        return self

    def data(self, v) -> "_W":
        b = ser_data(v)
        self.parts.append(struct.pack("<i", len(b)) + b)
        return self

    def bytes_(self) -> bytes:
        return b"".join(self.parts)


class _R:
    """Little-endian payload reader."""

    def __init__(self, b: bytes):
        self.b = b
        self.i = 0

    def _take(self, n: int) -> bytes:
        if self.i + n > len(self.b):
            raise DriverError("truncated hazelcast payload")
        out = self.b[self.i:self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def boolean(self) -> bool:
        return self._take(1)[0] != 0

    def i32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def string(self) -> str:
        return self._take(self.i32()).decode()

    def nullable_string(self) -> str | None:
        return None if self.u8() else self.string()

    def data(self) -> bytes:
        return self._take(self.i32())

    def nullable_data(self):
        return None if self.u8() else deser_data(self.data())


def pack_message(msg_type: int, correlation: int, payload: bytes,
                 partition: int = -1) -> bytes:
    return HEADER.pack(HEADER_SIZE + len(payload), VERSION, FLAG_BEGIN_END,
                       msg_type, correlation, partition,
                       HEADER_SIZE) + payload


def unpack_message(frame: bytes) -> tuple[int, int, bytes]:
    """frame (with length prefix) -> (type, correlation, payload)."""
    (_ln, _v, _fl, typ, corr, _part, off) = HEADER.unpack_from(frame)
    return typ, corr, frame[off:]


class HzConn:
    """One authenticated client connection to a member."""

    def __init__(self, host: str, port: int = 5701,
                 timeout: float = 10.0, username: str = "dev",
                 password: str = "dev-pass"):
        self.lock = threading.Lock()
        self.corr = itertools.count(1)
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.sendall(PROTOCOL_INIT)
            self._authenticate(username, password)
        except OSError as e:
            raise DriverError(f"hazelcast connect {host}:{port}: {e}") from e

    # -- transport --------------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise DriverError("hazelcast connection closed")
            buf += chunk
        return buf

    def request(self, msg_type: int, payload: bytes,
                partition: int = -1) -> tuple[int, _R]:
        """Send one message, read frames until our correlation id answers
        (event frames for other correlations are skipped)."""
        with self.lock:
            corr = next(self.corr)
            try:
                self.sock.sendall(
                    pack_message(msg_type, corr, payload, partition))
                while True:
                    head = self._recv_exact(4)
                    (ln,) = struct.unpack("<i", head)
                    frame = head + self._recv_exact(ln - 4)
                    typ, c, body = unpack_message(frame)
                    if c != corr:
                        continue
                    if typ == RESP_ERROR:
                        r = _R(body)
                        code = r.i32()
                        cls = r.nullable_string() or "?"
                        msg = r.nullable_string() or ""
                        raise HazelcastError(code, f"{cls}: {msg}")
                    return typ, _R(body)
            except OSError as e:
                raise DriverError(f"hazelcast io: {e}") from e

    def _authenticate(self, username: str, password: str) -> None:
        p = (_W().string(username).string(password)
             .nullable_string(None).nullable_string(None)
             .boolean(True).string("JPT").u8(1).string("3.10"))
        typ, r = self.request(AUTH, p.bytes_())
        if typ != RESP_AUTH:
            raise DriverError(f"unexpected auth response type {typ:#x}")
        status = r.u8()
        if status != 0:
            raise DBError(status, f"authentication failed ({status})")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- IMap -------------------------------------------------------------

    def map_get(self, name: str, key):
        _, r = self.request(
            MAP_GET, _W().string(name).data(key).i64(1).bytes_())
        return r.nullable_data()

    def map_put(self, name: str, key, value, ttl: int = -1):
        _, r = self.request(
            MAP_PUT,
            _W().string(name).data(key).data(value).i64(1).i64(ttl)
            .bytes_())
        return r.nullable_data()

    def map_put_if_absent(self, name: str, key, value, ttl: int = -1):
        """Returns the PREVIOUS value (None means the put won)."""
        _, r = self.request(
            MAP_PUT_IF_ABSENT,
            _W().string(name).data(key).data(value).i64(1).i64(ttl)
            .bytes_())
        return r.nullable_data()

    def map_replace_if_same(self, name: str, key, old, new) -> bool:
        _, r = self.request(
            MAP_REPLACE_IF_SAME,
            _W().string(name).data(key).data(old).data(new).i64(1)
            .bytes_())
        return r.boolean()

    # -- IQueue -----------------------------------------------------------

    def queue_offer(self, name: str, value, timeout_ms: int = 0) -> bool:
        _, r = self.request(
            QUEUE_OFFER,
            _W().string(name).data(value).i64(timeout_ms).bytes_())
        return r.boolean()

    def queue_poll(self, name: str, timeout_ms: int = 0):
        _, r = self.request(
            QUEUE_POLL, _W().string(name).i64(timeout_ms).bytes_())
        return r.nullable_data()

    def queue_take(self, name: str):
        _, r = self.request(QUEUE_TAKE, _W().string(name).bytes_())
        return r.nullable_data()

    def queue_size(self, name: str) -> int:
        _, r = self.request(QUEUE_SIZE, _W().string(name).bytes_())
        return r.i32()

    # -- ILock ------------------------------------------------------------

    def lock_lock(self, name: str, lease_ms: int = -1,
                  thread_id: int = 1, ref_id: int = 0) -> None:
        self.request(
            LOCK_LOCK,
            _W().string(name).i64(lease_ms).i64(thread_id).i64(ref_id)
            .bytes_())

    def lock_try_lock(self, name: str, timeout_ms: int,
                      lease_ms: int = -1, thread_id: int = 1,
                      ref_id: int = 0) -> bool:
        _, r = self.request(
            LOCK_TRY_LOCK,
            _W().string(name).i64(lease_ms).i64(timeout_ms)
            .i64(thread_id).i64(ref_id).bytes_())
        return r.boolean()

    def lock_unlock(self, name: str, thread_id: int = 1,
                    ref_id: int = 0) -> None:
        self.request(
            LOCK_UNLOCK,
            _W().string(name).i64(thread_id).i64(ref_id).bytes_())

    # -- IAtomicLong ------------------------------------------------------

    def atomic_long_increment_and_get(self, name: str) -> int:
        _, r = self.request(ATOMIC_LONG_INCREMENT_AND_GET,
                            _W().string(name).bytes_())
        return r.i64()

    def atomic_long_add_and_get(self, name: str, delta: int) -> int:
        _, r = self.request(ATOMIC_LONG_ADD_AND_GET,
                            _W().string(name).i64(delta).bytes_())
        return r.i64()

    def atomic_long_get(self, name: str) -> int:
        _, r = self.request(ATOMIC_LONG_GET, _W().string(name).bytes_())
        return r.i64()
