"""RethinkDB ReQL wire protocol client (no external deps).

The reference's rethinkdb suite uses the official JVM driver
(rethinkdb/src/jepsen/rethinkdb.clj); this client speaks the wire
protocol directly: the V1_0 handshake (magic + SCRAM-SHA-256 over
NUL-terminated JSON frames) and START queries as JSON-serialized term
ASTs with 8-byte tokens.

Only the terms a register/set workload needs are modeled: DB(14),
TABLE(15), GET(16), INSERT(56, conflict update/replace), DELETE(54),
TABLE_CREATE(60), DB_CREATE(57), and raw datum arguments. Write acks
ride the query options (durability, read_mode).

The port's copy of `jepsen_tpu/drivers/reql.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import socket
import struct

from . import DBError, DriverError

V1_0_MAGIC = 0x34C2BDC3

# term type ids (ql2.proto)
DB, TABLE, GET, INSERT = 14, 15, 16, 56
DELETE, DB_CREATE, TABLE_CREATE = 54, 57, 60

START, CONTINUE, STOP = 1, 2, 3

# response types
SUCCESS_ATOM, SUCCESS_SEQUENCE, SUCCESS_PARTIAL = 1, 2, 3
CLIENT_ERROR, COMPILE_ERROR, RUNTIME_ERROR = 16, 17, 18


class ReqlConn:
    def __init__(self, host: str, port: int = 28015,
                 user: str = "admin", password: str = "",
                 timeout: float = 10.0):
        self._buf = b""
        self._token = 0
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
            self.sock.settimeout(timeout)
            self._handshake(user, password)
        except (OSError, DriverError, DBError):
            self._abandon()
            raise

    # -- transport ------------------------------------------------------

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

    def _recv_nul_json(self) -> dict:
        while b"\0" not in self._buf:
            try:
                chunk = self.sock.recv(65536)
            except OSError as e:
                self._abandon()
                raise DriverError(f"recv failed: {e}") from e
            if not chunk:
                self._abandon()
                raise DriverError("connection closed by server")
            self._buf += chunk
        frame, self._buf = self._buf.split(b"\0", 1)
        out = json.loads(frame)
        if not out.get("success", True):
            raise DBError(str(out.get("error_code", "auth")),
                          out.get("error", "handshake failed"))
        return out

    def _abandon(self) -> None:
        try:
            if getattr(self, "sock", None) is not None:
                self.sock.close()
        except OSError:
            pass
        self.sock = None

    # -- handshake ------------------------------------------------------

    def _handshake(self, user: str, password: str) -> None:
        self.sock.sendall(struct.pack("<I", V1_0_MAGIC))
        self._recv_nul_json()                       # server version info
        nonce = base64.b64encode(os.urandom(18)).decode()
        first_bare = f"n={user},r={nonce}"
        self.sock.sendall(json.dumps({
            "protocol_version": 0,
            "authentication_method": "SCRAM-SHA-256",
            "authentication": "n,," + first_bare,
        }).encode() + b"\0")
        resp = self._recv_nul_json()
        server_first = resp["authentication"]
        attrs = dict(p.split("=", 1) for p in server_first.split(","))
        salted = hashlib.pbkdf2_hmac(
            "sha256", password.encode(),
            base64.b64decode(attrs["s"]), int(attrs["i"]))
        ckey = hmac.digest(salted, b"Client Key", "sha256")
        stored = hashlib.sha256(ckey).digest()
        final_bare = f"c=biws,r={attrs['r']}"
        auth_msg = ",".join((first_bare, server_first,
                             final_bare)).encode()
        sig = hmac.digest(stored, auth_msg, "sha256")
        proof = bytes(a ^ b for a, b in zip(ckey, sig))
        self.sock.sendall(json.dumps({
            "authentication":
                f"{final_bare},p={base64.b64encode(proof).decode()}",
        }).encode() + b"\0")
        self._recv_nul_json()                       # server signature

    # -- queries --------------------------------------------------------

    def _send_query(self, token: int, q: list) -> dict:
        payload = json.dumps(q).encode()
        try:
            self.sock.sendall(struct.pack("<Q", token) +
                              struct.pack("<I", len(payload)) + payload)
        except OSError as e:
            self._abandon()
            raise DriverError(f"send failed: {e}") from e
        rtoken, = struct.unpack("<Q", self._recvn(8))
        rlen, = struct.unpack("<I", self._recvn(4))
        resp = json.loads(self._recvn(rlen))
        if rtoken != token:
            self._abandon()
            raise DriverError(f"token mismatch {rtoken} != {token}")
        t = resp.get("t")
        if t in (CLIENT_ERROR, COMPILE_ERROR, RUNTIME_ERROR):
            raise DBError(f"reql-{t}",
                          "; ".join(str(r) for r in resp.get("r", [])))
        return resp

    def run(self, term, opts: dict | None = None):
        """START a term; returns the decoded result (atom or full
        sequence — partial cursors are drained with CONTINUE)."""
        if self.sock is None:
            raise DriverError("connection is closed")
        self._token += 1
        token = self._token
        resp = self._send_query(token, [START, term, opts or {}])
        if resp.get("t") == SUCCESS_ATOM:
            r = resp.get("r", [])
            return r[0] if r else None
        out = list(resp.get("r", []))
        while resp.get("t") == SUCCESS_PARTIAL:
            resp = self._send_query(token, [CONTINUE])
            out += resp.get("r", [])
        return out                                   # full sequence

    # -- term builders --------------------------------------------------

    @staticmethod
    def table(db: str, name: str):
        return [TABLE, [[DB, [db]], name]]

    def db_create(self, name: str):
        try:
            return self.run([DB_CREATE, [name]])
        except DBError as e:
            if "already exists" in e.message:
                return None
            raise

    def table_create(self, db: str, name: str, **opts):
        try:
            return self.run([TABLE_CREATE, [[DB, [db]], name],
                             opts] if opts else
                            [TABLE_CREATE, [[DB, [db]], name]])
        except DBError as e:
            if "already exists" in e.message:
                return None
            raise

    def get(self, db: str, tbl: str, key, read_mode: str = "majority"):
        return self.run([GET, [self.table(db, tbl), key]],
                        {"read_mode": read_mode})

    def insert(self, db: str, tbl: str, doc: dict,
               conflict: str = "replace",
               durability: str = "hard") -> dict:
        res = self.run([INSERT, [self.table(db, tbl), doc],
                        {"conflict": conflict}],
                       {"durability": durability})
        # ReQL reports write failures in the result document, not as
        # an error response
        if isinstance(res, dict) and res.get("errors"):
            raise DBError("insert",
                          str(res.get("first_error", "insert failed")))
        return res

    def close(self) -> None:
        self._abandon()


def connect(host: str, port: int = 28015, user: str = "admin",
            password: str = "", timeout: float = 10.0) -> ReqlConn:
    return ReqlConn(host, port, user, password, timeout)
