"""RESP (REdis Serialization Protocol) client — Disque speaks RESP
(the reference's disque suite uses the jedisque JVM client,
disque/src/jepsen/disque.clj). Commands go as arrays of bulk strings;
replies are simple strings, errors, integers, bulk strings, or arrays.

The port's copy of `jepsen_tpu/drivers/resp.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import socket

from . import DBError, DriverError


class RespConn:
    def __init__(self, host: str, port: int = 7711,
                 timeout: float = 10.0):
        self._buf = b""
        self.sock = socket.create_connection((host, port),
                                             timeout=timeout)
        self.sock.settimeout(timeout)

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

    def _recv_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            try:
                chunk = self.sock.recv(65536)
            except OSError as e:
                self._abandon()
                raise DriverError(f"recv failed: {e}") from e
            if not chunk:
                self._abandon()
                raise DriverError("connection closed by server")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _abandon(self) -> None:
        try:
            if getattr(self, "sock", None) is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None

    def _read_reply(self):
        line = self._recv_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            msg = rest.decode()
            code = msg.split(None, 1)[0] if msg else "ERR"
            raise DBError(code, msg)
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            out = self._recvn(n)
            self._recvn(2)  # trailing \r\n
            return out.decode()
        if t == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        self._abandon()
        raise DriverError(f"bad RESP type byte {t!r}")

    def command(self, *args):
        """Send one command; return the decoded reply."""
        if self.sock is None:
            raise DriverError("connection is closed")
        parts = [f"*{len(args)}\r\n".encode()]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            parts.append(f"${len(b)}\r\n".encode() + b + b"\r\n")
        try:
            self.sock.sendall(b"".join(parts))
        except OSError as e:
            self._abandon()
            raise DriverError(f"send failed: {e}") from e
        return self._read_reply()

    def close(self) -> None:
        self._abandon()


def connect(host: str, port: int = 7711, timeout: float = 10.0
            ) -> RespConn:
    return RespConn(host, port, timeout)
