"""MongoDB wire-protocol client: minimal BSON + OP_MSG (no deps).

The reference's mongodb suites use the java driver
(mongodb-rocks/src/jepsen/mongodb/, mongodb-smartos); this client
implements the modern wire protocol's single message type (OP_MSG,
opcode 2013) with hand-rolled BSON for the types a jepsen workload
touches: documents, arrays, strings, ints, bools, null, doubles.

Commands are plain documents (insert/find/update/findAndModify/
delete); read/write concerns ride along as subdocuments, which is how
the suites express majority acknowledgement.

The port's copy of `jepsen_tpu/drivers/mongo.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import socket
import struct
import threading

from . import DBError, DriverError

OP_MSG = 2013


# ---------------------------------------------------------------------
# BSON


def _enc_element(key: str, v) -> bytes:
    kb = key.encode() + b"\0"
    if isinstance(v, bool):                 # before int (bool is int)
        return b"\x08" + kb + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + kb + struct.pack("<i", v)
        return b"\x12" + kb + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + kb + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode() + b"\0"
        return b"\x02" + kb + struct.pack("<i", len(b)) + b
    if v is None:
        return b"\x0a" + kb
    if isinstance(v, dict):
        return b"\x03" + kb + encode_doc(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + kb + encode_doc(
            {str(i): x for i, x in enumerate(v)})
    if isinstance(v, bytes):
        return b"\x05" + kb + struct.pack("<i", len(v)) + b"\x00" + v
    raise TypeError(f"can't BSON-encode {type(v)}")


def encode_doc(doc: dict) -> bytes:
    body = b"".join(_enc_element(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\0"


def _dec_element(data: bytes, off: int) -> tuple[str, object, int]:
    t = data[off]
    off += 1
    end = data.index(b"\0", off)
    key = data[off:end].decode()
    off = end + 1
    if t == 0x01:
        return key, struct.unpack_from("<d", data, off)[0], off + 8
    if t == 0x02:
        (n,) = struct.unpack_from("<i", data, off)
        return key, data[off + 4:off + 4 + n - 1].decode(), off + 4 + n
    if t in (0x03, 0x04):
        doc, off2 = decode_doc(data, off)
        if t == 0x04:
            return key, [doc[str(i)] for i in range(len(doc))], off2
        return key, doc, off2
    if t == 0x05:
        (n,) = struct.unpack_from("<i", data, off)
        return key, data[off + 5:off + 5 + n], off + 5 + n
    if t == 0x07:
        return key, data[off:off + 12], off + 12
    if t == 0x08:
        return key, bool(data[off]), off + 1
    if t == 0x09 or t == 0x11 or t == 0x12:
        return key, struct.unpack_from("<q", data, off)[0], off + 8
    if t == 0x0A:
        return key, None, off
    if t == 0x10:
        return key, struct.unpack_from("<i", data, off)[0], off + 4
    raise DriverError(f"unsupported BSON type 0x{t:02x}")


def decode_doc(data: bytes, off: int = 0) -> tuple[dict, int]:
    (length,) = struct.unpack_from("<i", data, off)
    end = off + length - 1
    off += 4
    doc: dict = {}
    while off < end:
        key, v, off = _dec_element(data, off)
        doc[key] = v
    return doc, end + 1


# ---------------------------------------------------------------------
# OP_MSG transport


class MongoConn:
    def __init__(self, host: str, port: int = 27017,
                 database: str = "test", timeout: float = 10.0):
        self.database = database
        self._buf = b""
        self._req_id = 0
        self._lock = threading.Lock()
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.settimeout(timeout)
        except OSError:
            raise

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

    def _abandon(self) -> None:
        try:
            if getattr(self, "sock", None) is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None

    def command(self, doc: dict) -> dict:
        """Run one command document against self.database; returns the
        reply doc. Raises DBError when the server says ok: 0 or returns
        writeErrors."""
        with self._lock:
            if self.sock is None:
                raise DriverError("connection is closed")
            self._req_id += 1
            body = encode_doc({**doc, "$db": self.database})
            payload = struct.pack("<I", 0) + b"\x00" + body  # flags, kind 0
            header = struct.pack("<iiii", 16 + len(payload),
                                 self._req_id, 0, OP_MSG)
            try:
                self.sock.sendall(header + payload)
            except OSError as e:
                self._abandon()
                raise DriverError(f"send failed: {e}") from e
            length, _rid, _rto, opcode = struct.unpack("<iiii",
                                                       self._recvn(16))
            data = self._recvn(length - 16)
            if opcode != OP_MSG:
                self._abandon()
                raise DriverError(f"unexpected opcode {opcode}")
            # flags:4 kind:1 doc
            reply, _ = decode_doc(data, 5)
        if not reply.get("ok"):
            raise DBError(str(reply.get("code", "unknown")),
                          reply.get("errmsg", "command failed"))
        errs = reply.get("writeErrors")
        if errs:
            raise DBError(str(errs[0].get("code", "write")),
                          errs[0].get("errmsg", "write error"))
        return reply

    # convenience wrappers ------------------------------------------------

    def insert(self, coll: str, docs: list[dict],
               write_concern: dict | None = None) -> dict:
        cmd: dict = {"insert": coll, "documents": docs}
        if write_concern:
            cmd["writeConcern"] = write_concern
        return self.command(cmd)

    def find(self, coll: str, filter_: dict | None = None,
             read_concern: dict | None = None) -> list[dict]:
        cmd: dict = {"find": coll, "filter": filter_ or {}}
        if read_concern:
            cmd["readConcern"] = read_concern
        out = self.command(cmd)
        return out.get("cursor", {}).get("firstBatch", [])

    def find_and_modify(self, coll: str, query: dict, update: dict,
                        upsert: bool = False,
                        write_concern: dict | None = None) -> dict:
        cmd: dict = {"findAndModify": coll, "query": query,
                     "update": update, "upsert": upsert, "new": True}
        if write_concern:
            cmd["writeConcern"] = write_concern
        return self.command(cmd)

    def update(self, coll: str, query: dict, update: dict,
               upsert: bool = False,
               write_concern: dict | None = None) -> dict:
        cmd: dict = {"update": coll,
                     "updates": [{"q": query, "u": update,
                                  "upsert": upsert}]}
        if write_concern:
            cmd["writeConcern"] = write_concern
        return self.command(cmd)

    def close(self) -> None:
        self._abandon()


def connect(host: str, port: int = 27017, database: str = "test",
            timeout: float = 10.0) -> MongoConn:
    return MongoConn(host, port, database, timeout)
