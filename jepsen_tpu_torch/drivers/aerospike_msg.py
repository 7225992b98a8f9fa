"""Aerospike wire protocol driver (info + message protocols).

The reference suite drives Aerospike through the JVM client
(aerospike/src/aerospike/cas_register.clj:43 `AerospikeClient`,
counter.clj) — CAS is generation-check writes. This is a from-scratch
implementation of the server's bespoke binary protocol (port 3000):

  proto   8 bytes BE: version u8 (2) | type u8 (1 info, 3 message)
          | size u48
  info    payload = newline-separated names; reply "name\\tvalue\\n"
  message 22-byte header, all BE: header_sz u8 (22) | info1 u8
          | info2 u8 | info3 u8 | unused u8 | result u8
          | generation u32 | record_ttl u32 | transaction_ttl u32
          | n_fields u16 | n_ops u16, then fields and ops.
  field   size u32 (covers type+data) | type u8 | data
          (0 namespace, 1 set, 2 RIPEMD-160 key digest)
  op      size u32 | op u8 (1 read, 2 write) | particle u8
          (1 integer, 3 string) | version u8 | name_len u8 | name
          | particle data (integers are 8-byte BE)

CAS = read returning the record generation, then a write with
INFO2_GENERATION and the expected generation in the header — result 3
(generation mismatch) is the cas-failure. Exercised round-trip against
tests/fake_aerospike.py; live-cluster verification is the opt-in tier.

The port's copy of `jepsen_tpu/drivers/aerospike_msg.py`; it imports the
standard library and the port's own modules only.
"""

from __future__ import annotations

import hashlib
import socket
import struct
import threading

from . import DBError, DriverError

PROTO_VERSION = 2
TYPE_INFO = 1
TYPE_MSG = 3

INFO1_READ = 0x01
INFO1_GET_ALL = 0x02
INFO2_WRITE = 0x01
INFO2_DELETE = 0x02
INFO2_GENERATION = 0x04
INFO2_CREATE_ONLY = 0x20

FIELD_NAMESPACE = 0
FIELD_SET = 1
FIELD_DIGEST = 2

PARTICLE_INTEGER = 1
PARTICLE_STRING = 3

RESULT_OK = 0
RESULT_NOT_FOUND = 2
RESULT_GENERATION = 3

MSG_HEADER = struct.Struct(">BBBBBBIIIHH")  # 22 bytes


class AerospikeError(DBError):
    pass


def key_digest(set_name: str, key) -> bytes:
    """RIPEMD-160 over set name + particle-typed key — the record
    address every request carries."""
    if isinstance(key, int):
        kb = bytes([PARTICLE_INTEGER]) + struct.pack(">q", key)
    else:
        kb = bytes([PARTICLE_STRING]) + str(key).encode()
    h = hashlib.new("ripemd160")
    h.update(set_name.encode())
    h.update(kb)
    return h.digest()


def _field(ftype: int, data: bytes) -> bytes:
    return struct.pack(">iB", len(data) + 1, ftype) + data


def _op(op: int, name: str, value=None) -> bytes:
    nb = name.encode()
    if value is None:
        body = struct.pack(">BBBB", op, 0, 0, len(nb)) + nb
    elif isinstance(value, int):
        body = (struct.pack(">BBBB", op, PARTICLE_INTEGER, 0, len(nb))
                + nb + struct.pack(">q", value))
    else:
        vb = str(value).encode()
        body = (struct.pack(">BBBB", op, PARTICLE_STRING, 0, len(nb))
                + nb + vb)
    return struct.pack(">i", len(body)) + body


def pack_message(info1: int, info2: int, generation: int,
                 fields: list[bytes], ops: list[bytes],
                 result: int = 0, info3: int = 0) -> bytes:
    body = MSG_HEADER.pack(22, info1, info2, info3, 0, result,
                           generation, 0, 1000, len(fields), len(ops))
    body += b"".join(fields) + b"".join(ops)
    return struct.pack(">Q",
                       (PROTO_VERSION << 56) | (TYPE_MSG << 48)
                       | len(body)) + body


def unpack_proto(head: bytes) -> tuple[int, int, int]:
    (word,) = struct.unpack(">Q", head)
    return word >> 56, (word >> 48) & 0xFF, word & ((1 << 48) - 1)


def parse_message(body: bytes) -> dict:
    """-> {result, generation, bins: {name: value}}"""
    (hsz, _i1, _i2, _i3, _u, result, gen, _ttl, _ttt, n_fields,
     n_ops) = MSG_HEADER.unpack_from(body)
    i = hsz
    for _ in range(n_fields):
        (sz,) = struct.unpack_from(">i", body, i)
        i += 4 + sz
    bins: dict = {}
    for _ in range(n_ops):
        (sz,) = struct.unpack_from(">i", body, i)
        op_body = body[i + 4:i + 4 + sz]
        i += 4 + sz
        _opc, particle, _ver, name_len = struct.unpack_from(
            ">BBBB", op_body)
        name = op_body[4:4 + name_len].decode()
        data = op_body[4 + name_len:]
        if particle == PARTICLE_INTEGER:
            bins[name] = struct.unpack(">q", data)[0]
        elif particle == PARTICLE_STRING:
            bins[name] = data.decode()
        else:
            bins[name] = None
    return {"result": result, "generation": gen, "bins": bins}


class AsConn:
    """One connection to a node; requests are serialized."""

    def __init__(self, host: str, port: int = 3000,
                 timeout: float = 10.0, namespace: str = "jepsen",
                 set_name: str = "jepsen"):
        self.lock = threading.Lock()
        self.namespace = namespace
        self.set_name = set_name
        try:
            self.sock = socket.create_connection((host, port),
                                                 timeout=timeout)
        except OSError as e:
            raise DriverError(
                f"aerospike connect {host}:{port}: {e}") from e

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise DriverError("aerospike connection closed")
            buf += chunk
        return buf

    def _roundtrip(self, packet: bytes) -> dict:
        with self.lock:
            try:
                self.sock.sendall(packet)
                ver, typ, size = unpack_proto(self._recv_exact(8))
                body = self._recv_exact(size)
            except OSError as e:
                raise DriverError(f"aerospike io: {e}") from e
        if ver != PROTO_VERSION or typ != TYPE_MSG:
            raise DriverError(f"bad proto header v{ver} t{typ}")
        return parse_message(body)

    def _key_fields(self, key) -> list[bytes]:
        return [_field(FIELD_NAMESPACE, self.namespace.encode()),
                _field(FIELD_SET, self.set_name.encode()),
                _field(FIELD_DIGEST, key_digest(self.set_name, key))]

    def info(self, names: list[str]) -> dict:
        payload = ("\n".join(names) + "\n").encode()
        with self.lock:
            try:
                self.sock.sendall(struct.pack(
                    ">Q", (PROTO_VERSION << 56) | (TYPE_INFO << 48)
                    | len(payload)) + payload)
                ver, typ, size = unpack_proto(self._recv_exact(8))
                body = self._recv_exact(size)
            except OSError as e:
                raise DriverError(f"aerospike io: {e}") from e
        out = {}
        for line in body.decode().splitlines():
            if "\t" in line:
                k, v = line.split("\t", 1)
                out[k] = v
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    # -- record ops --------------------------------------------------------

    def get(self, key) -> dict | None:
        """-> {"bins": ..., "generation": n} or None when absent."""
        r = self._roundtrip(pack_message(
            INFO1_READ | INFO1_GET_ALL, 0, 0, self._key_fields(key), []))
        if r["result"] == RESULT_NOT_FOUND:
            return None
        if r["result"] != RESULT_OK:
            raise AerospikeError(r["result"], f"get: {r['result']}")
        return {"bins": r["bins"], "generation": r["generation"]}

    def put(self, key, bins: dict, generation: int | None = None,
            create_only: bool = False) -> None:
        """Write bins; with `generation`, only if the record's current
        generation matches (the CAS primitive); with create_only, only
        if the record doesn't exist. Raises AerospikeError(3) /
        AerospikeError(5) respectively on conflict."""
        info2 = INFO2_WRITE
        gen = 0
        if generation is not None:
            info2 |= INFO2_GENERATION
            gen = generation
        if create_only:
            info2 |= INFO2_CREATE_ONLY
        ops = [_op(2, n, v) for n, v in bins.items()]
        r = self._roundtrip(pack_message(
            0, info2, gen, self._key_fields(key), ops))
        if r["result"] != RESULT_OK:
            raise AerospikeError(r["result"], f"put: {r['result']}")

    def add(self, key, bin_name: str, delta: int) -> None:
        """Server-side counter increment (op 5 = INCR)."""
        r = self._roundtrip(pack_message(
            0, INFO2_WRITE, 0, self._key_fields(key),
            [_op(5, bin_name, delta)]))
        if r["result"] != RESULT_OK:
            raise AerospikeError(r["result"], f"add: {r['result']}")
