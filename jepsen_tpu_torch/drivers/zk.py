"""ZooKeeper wire protocol client (no external deps).

Speaks ZooKeeper's jute-serialized protocol directly — the reference's
zookeeper suite goes through the avout JVM client
(zookeeper/src/jepsen/zookeeper.clj:1-17); here the session handshake
and the four request types a CAS-register workload needs (create,
getData, setData, exists) are hand-framed. setData's version argument
is the CAS primitive: ZooKeeper rejects it with BADVERSION when the
node changed since the read.

Framing: every packet is `len:4` + payload, big-endian. Requests carry
`xid:4 type:4`; replies `xid:4 zxid:8 err:4`. Strings/buffers are
`len:4 bytes` (-1 = null).

The port's copy of `jepsen_tpu/drivers/zk.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import socket
import struct
import threading

from . import DBError, DriverError

CREATE, DELETE, EXISTS, GETDATA, SETDATA = 1, 2, 3, 4, 5
PING, CLOSE = 11, -11

#: error codes (zookeeper KeeperException)
OK = 0
NONODE = -101
BADVERSION = -103
NODEEXISTS = -110

ERR_NAMES = {NONODE: "no-node", BADVERSION: "bad-version",
             NODEEXISTS: "node-exists"}

def _buf(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack("!i", -1)
    return struct.pack("!i", len(b)) + b


def _string(s: str) -> bytes:
    return _buf(s.encode())


#: world-anyone ACL with all perms (31): one jute ACL entry
OPEN_ACL = (struct.pack("!i", 1) + struct.pack("!i", 31) +
            _string("world") + _string("anyone"))


class Stat:
    """The subset of the jute Stat a CAS register needs."""

    __slots__ = ("version",)

    def __init__(self, version: int):
        self.version = version


class ZKConn:
    def __init__(self, host: str, port: int = 2181,
                 timeout: float = 10.0, session_timeout_ms: int = 10000):
        self._buf = b""
        self._xid = 0
        self._lock = threading.Lock()
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.settimeout(timeout)
            self._connect(session_timeout_ms)
        except (OSError, DriverError, DBError):
            self._abandon()
            raise

    # -- framing --------------------------------------------------------

    def _recvn(self, n: int) -> bytes:
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
        (n,) = struct.unpack("!i", self._recvn(4))
        return self._recvn(n)

    def _send_packet(self, payload: bytes) -> None:
        try:
            self.sock.sendall(struct.pack("!i", len(payload)) + payload)
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

    # -- session --------------------------------------------------------

    def _connect(self, session_timeout_ms: int) -> None:
        req = struct.pack("!iqi", 0, 0, session_timeout_ms) + \
            struct.pack("!q", 0) + _buf(b"\0" * 16)
        self._send_packet(req)
        resp = self._recv_packet()
        _ver, timeout_ms, session_id = struct.unpack_from("!iiq", resp, 0)
        if session_id == 0:
            raise DriverError("zookeeper session rejected")
        self.session_id = session_id

    def _call(self, op_type: int, body: bytes) -> bytes:
        """One request/reply; raises DBError on server error codes."""
        with self._lock:
            if self.sock is None:
                raise DriverError("connection is closed")
            self._xid += 1
            xid = self._xid
            self._send_packet(struct.pack("!ii", xid, op_type) + body)
            while True:
                resp = self._recv_packet()
                rxid, _zxid, err = struct.unpack_from("!iqi", resp, 0)
                if rxid == -1:      # watch event notification: skip
                    continue
                if rxid != xid:
                    self._abandon()
                    raise DriverError(
                        f"xid mismatch: sent {xid}, got {rxid}")
                if err != OK:
                    raise DBError(ERR_NAMES.get(err, str(err)),
                                  f"zookeeper error {err}")
                return resp[16:]

    # -- ops ------------------------------------------------------------

    def create(self, path: str, data: bytes,
               ephemeral: bool = False) -> str:
        flags = 1 if ephemeral else 0
        body = _string(path) + _buf(data) + OPEN_ACL + \
            struct.pack("!i", flags)
        out = self._call(CREATE, body)
        (n,) = struct.unpack_from("!i", out, 0)
        return out[4:4 + n].decode()

    def get_data(self, path: str) -> tuple[bytes, Stat]:
        out = self._call(GETDATA, _string(path) + b"\0")  # watch=false
        (n,) = struct.unpack_from("!i", out, 0)
        if n < 0:
            data, off = b"", 4
        else:
            data, off = out[4:4 + n], 4 + n
        # jute Stat: czxid mzxid ctime mtime version ... (version at +32)
        (version,) = struct.unpack_from("!i", out, off + 32)
        return data, Stat(version)

    def set_data(self, path: str, data: bytes,
                 version: int = -1) -> Stat:
        out = self._call(SETDATA, _string(path) + _buf(data) +
                         struct.pack("!i", version))
        (version_,) = struct.unpack_from("!i", out, 32)
        return Stat(version_)

    def exists(self, path: str) -> bool:
        try:
            self._call(EXISTS, _string(path) + b"\0")
            return True
        except DBError as e:
            if e.code == "no-node":
                return False
            raise

    def delete(self, path: str, version: int = -1) -> None:
        self._call(DELETE, _string(path) + struct.pack("!i", version))

    def ping(self) -> None:
        with self._lock:
            if self.sock is None:
                raise DriverError("connection is closed")
            self._send_packet(struct.pack("!ii", -2, PING))
            while True:
                resp = self._recv_packet()
                (rxid,) = struct.unpack_from("!i", resp, 0)
                if rxid == -2:
                    return

    def close(self) -> None:
        if self.sock is not None:
            try:
                with self._lock:
                    self._xid += 1
                    self._send_packet(struct.pack("!ii", self._xid, CLOSE))
            except DriverError:
                pass
            self._abandon()


def connect(host: str, port: int = 2181, timeout: float = 10.0,
            **kw) -> ZKConn:
    return ZKConn(host, port, timeout, **kw)
