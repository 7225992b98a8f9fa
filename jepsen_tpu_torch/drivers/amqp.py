"""Minimal AMQP 0-9-1 client for queue workloads (no external deps).

The reference's rabbitmq suite drives RabbitMQ through langohr
(rabbitmq/src/jepsen/rabbitmq.clj:104-175); this client implements just
the slice a jepsen queue workload needs: PLAIN auth, one channel,
queue.declare, basic.publish (with persistent delivery), basic.get,
basic.ack, and queue.purge. Everything is synchronous on one socket.

Frame: type:1 channel:2 size:4 payload 0xCE. Methods are
class-id:2 method-id:2 + packed args; content goes as a header frame
(class:2 weight:2 body-size:8 flags:2 [properties]) + body frames.

The port's copy of `jepsen_tpu/drivers/amqp.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import socket
import struct

from . import DBError, DriverError

FRAME_METHOD, FRAME_HEADER, FRAME_BODY, FRAME_HEARTBEAT = 1, 2, 3, 8
FRAME_END = 0xCE


def _shortstr(s: str) -> bytes:
    b = s.encode()
    return bytes([len(b)]) + b


def _longstr(b: bytes) -> bytes:
    return struct.pack("!I", len(b)) + b


def _read_shortstr(data: bytes, off: int) -> tuple[str, int]:
    n = data[off]
    return data[off + 1:off + 1 + n].decode(), off + 1 + n


def _read_longstr(data: bytes, off: int) -> tuple[bytes, int]:
    (n,) = struct.unpack_from("!I", data, off)
    return data[off + 4:off + 4 + n], off + 4 + n


def _skip_table(data: bytes, off: int) -> int:
    (n,) = struct.unpack_from("!I", data, off)
    return off + 4 + n


class AMQPConn:
    def __init__(self, host: str, port: int = 5672,
                 user: str = "guest", password: str = "guest",
                 vhost: str = "/", timeout: float = 10.0):
        self._buf = b""
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.settimeout(timeout)
            self._handshake(user, password, vhost)
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

    def _recv_frame(self) -> tuple[int, int, bytes]:
        head = self._recvn(7)
        ftype, channel, size = struct.unpack("!BHI", head)
        payload = self._recvn(size)
        end = self._recvn(1)
        if end[0] != FRAME_END:
            self._abandon()
            raise DriverError("bad frame end octet")
        if ftype == FRAME_HEARTBEAT:
            return self._recv_frame()
        return ftype, channel, payload

    def _recv_method(self) -> tuple[int, int, bytes]:
        """-> (class_id, method_id, args); raises on connection.close /
        channel.close."""
        ftype, _ch, payload = self._recv_frame()
        if ftype != FRAME_METHOD:
            self._abandon()
            raise DriverError(f"expected method frame, got {ftype}")
        cls, mth = struct.unpack_from("!HH", payload, 0)
        args = payload[4:]
        if (cls, mth) in ((10, 50), (20, 40)):   # connection/channel close
            code, off = struct.unpack_from("!H", args, 0)[0], 2
            text, off = _read_shortstr(args, off)
            self._abandon()
            raise DBError(code, text)
        return cls, mth, args

    def _send_frame(self, ftype: int, channel: int,
                    payload: bytes) -> None:
        try:
            self.sock.sendall(struct.pack("!BHI", ftype, channel,
                                          len(payload)) +
                              payload + bytes([FRAME_END]))
        except OSError as e:
            self._abandon()
            raise DriverError(f"send failed: {e}") from e

    def _send_method(self, channel: int, cls: int, mth: int,
                     args: bytes = b"") -> None:
        self._send_frame(FRAME_METHOD, channel,
                         struct.pack("!HH", cls, mth) + args)

    def _abandon(self) -> None:
        try:
            if getattr(self, "sock", None) is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None

    # -- connection negotiation ----------------------------------------

    def _expect(self, cls: int, mth: int) -> bytes:
        rcls, rmth, args = self._recv_method()
        if (rcls, rmth) != (cls, mth):
            self._abandon()
            raise DriverError(
                f"expected method ({cls},{mth}), got ({rcls},{rmth})")
        return args

    def _handshake(self, user: str, password: str, vhost: str) -> None:
        self.sock.sendall(b"AMQP\x00\x00\x09\x01")
        self._expect(10, 10)                       # connection.start
        response = b"\0" + user.encode() + b"\0" + password.encode()
        args = (struct.pack("!I", 0) +             # client-properties {}
                _shortstr("PLAIN") + _longstr(response) +
                _shortstr("en_US"))
        self._send_method(0, 10, 11, args)         # start-ok
        tune = self._expect(10, 30)                # tune
        channel_max, frame_max, heartbeat = struct.unpack_from(
            "!HIH", tune, 0)
        self.frame_max = frame_max or 131072
        self._send_method(0, 10, 31, struct.pack(  # tune-ok (no heartbeat)
            "!HIH", channel_max, self.frame_max, 0))
        self._send_method(0, 10, 40,               # open
                          _shortstr(vhost) + _shortstr("") + b"\0")
        self._expect(10, 41)                       # open-ok
        self._send_method(1, 20, 10, _shortstr(""))  # channel.open
        self._expect(20, 11)                       # channel.open-ok
        self._confirms = False
        self._publish_seq = 0

    def confirm_select(self) -> None:
        """Enter publisher-confirm mode: every publish then blocks until
        the broker acks it — without this, basic.publish is
        fire-and-forget and a lost message would be recorded as an
        acknowledged enqueue."""
        self._send_method(1, 85, 10, b"\0")        # confirm.select
        self._expect(85, 11)                       # select-ok
        self._confirms = True

    # -- queue ops ------------------------------------------------------

    def queue_declare(self, queue: str, durable: bool = True) -> None:
        flags = 0b00010 if durable else 0          # bit1 = durable
        args = (struct.pack("!H", 0) + _shortstr(queue) +
                bytes([flags]) + struct.pack("!I", 0))  # empty args table
        self._send_method(1, 50, 10, args)
        self._expect(50, 11)                       # declare-ok

    def queue_purge(self, queue: str) -> int:
        args = struct.pack("!H", 0) + _shortstr(queue) + b"\0"
        self._send_method(1, 50, 30, args)
        out = self._expect(50, 31)
        return struct.unpack_from("!I", out, 0)[0]

    def publish(self, queue: str, body: bytes,
                persistent: bool = True) -> None:
        args = (struct.pack("!H", 0) + _shortstr("") +  # default exchange
                _shortstr(queue) + b"\0")
        self._send_method(1, 60, 40, args)
        # content header: class 60, weight 0, size, flags: delivery-mode
        props_flags = 0x1000 if persistent else 0  # delivery-mode bit 12
        header = struct.pack("!HHQH", 60, 0, len(body), props_flags)
        if persistent:
            header += bytes([2])                   # delivery-mode = 2
        self._send_frame(FRAME_HEADER, 1, header)
        max_body = self.frame_max - 8
        for i in range(0, len(body), max_body):
            self._send_frame(FRAME_BODY, 1, body[i:i + max_body])
        if self._confirms:
            self._publish_seq += 1
            cls, mth, margs = self._recv_method()
            if (cls, mth) == (60, 120):            # basic.nack
                raise DBError("nack", "broker refused the publish")
            if (cls, mth) != (60, 80):             # basic.ack
                self._abandon()
                raise DriverError(
                    f"expected publish confirm, got ({cls},{mth})")
            (tag,) = struct.unpack_from("!Q", margs, 0)
            if tag != self._publish_seq:
                self._abandon()
                raise DriverError(
                    f"confirm tag {tag} != seq {self._publish_seq}")

    def get(self, queue: str, no_ack: bool = False
            ) -> tuple[int, bytes] | None:
        """basic.get -> (delivery_tag, body) or None when empty."""
        args = (struct.pack("!H", 0) + _shortstr(queue) +
                (b"\1" if no_ack else b"\0"))
        self._send_method(1, 60, 70, args)
        cls, mth, margs = self._recv_method()
        if (cls, mth) == (60, 72):                 # get-empty
            return None
        if (cls, mth) != (60, 71):                 # get-ok
            self._abandon()
            raise DriverError(f"unexpected method ({cls},{mth})")
        (tag,) = struct.unpack_from("!Q", margs, 0)
        ftype, _ch, header = self._recv_frame()
        if ftype != FRAME_HEADER:
            self._abandon()
            raise DriverError("expected content header")
        (size,) = struct.unpack_from("!Q", header, 4)
        body = b""
        while len(body) < size:
            ftype, _ch, chunk = self._recv_frame()
            if ftype != FRAME_BODY:
                self._abandon()
                raise DriverError("expected content body")
            body += chunk
        return tag, body

    def ack(self, delivery_tag: int) -> None:
        self._send_method(1, 60, 80,
                          struct.pack("!Q", delivery_tag) + b"\0")

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._send_method(0, 10, 50,       # connection.close
                                  struct.pack("!H", 200) +
                                  _shortstr("bye") +
                                  struct.pack("!HH", 0, 0))
            except (DriverError, DBError):
                pass
            self._abandon()


def connect(host: str, port: int = 5672, user: str = "guest",
            password: str = "guest", vhost: str = "/",
            timeout: float = 10.0) -> AMQPConn:
    return AMQPConn(host, port, user, password, vhost, timeout)
