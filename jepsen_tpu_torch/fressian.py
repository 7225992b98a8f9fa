"""Fressian binary codec (read + write) for reference store compat.

The reference persists each test as ``test.fressian`` before analysis
(store.clj:31-116 defines custom write handlers; save-1! store.clj:372)
— this module lets those artifacts be loaded (and written) without a
JVM. The wire format follows the public fressian spec
(github.com/Datomic/fressian/wiki, org.fressian.impl.Codes); the subset
implemented is everything jepsen's store emits: nil/bool/ints/doubles/
strings/keywords/symbols/lists/maps/sets/insts, the priority and struct
caches (keywords and repeated tags are cache-referenced on the wire),
and tagged structs for the custom handlers (atoms, Joda DateTime,
multisets, MapEntry — surfaced as TaggedValue/known conversions).

Derived from the spec without a JVM to differentially test against, so
exotica (BIGINT chunks, regexes, metadata) raise cleanly rather than
guessing.

A copy of `jepsen_tpu/fressian.py` over the port's own `edn` and
`independent` types, so `Store.load_test` reads the reference's
`test.fressian` runs without importing the JAX package.
"""

from __future__ import annotations

import datetime
import io
import struct as _struct
from typing import Any

from .edn import Keyword, Symbol

# Code table (org.fressian.impl.Codes).
PRIORITY_CACHE_PACKED_START = 0x80   # ..0x9F
STRUCT_CACHE_PACKED_START = 0xA0     # ..0xAF
MAP = 0xC0
SET = 0xC1
UUID_ = 0xC3
REGEX = 0xC4
URI = 0xC5
BIGINT = 0xC6
BIGDEC = 0xC7
INST = 0xC8
SYM = 0xC9
KEY = 0xCA
GET_PRIORITY_CACHE = 0xCC
PUT_PRIORITY_CACHE = 0xCD
PRECACHE = 0xCE
FOOTER = 0xCF
BYTES_PACKED_START = 0xD0            # ..0xD7
BYTES_CHUNK = 0xD8
BYTES = 0xD9
STRING_PACKED_START = 0xDA           # ..0xE1
STRING_CHUNK = 0xE2
STRING = 0xE3
LIST_PACKED_START = 0xE4             # ..0xEB
LIST = 0xEC
BEGIN_CLOSED_LIST = 0xED
BEGIN_OPEN_LIST = 0xEE
STRUCTTYPE = 0xEF
STRUCT = 0xF0
META = 0xF1
ANY = 0xF4
TRUE = 0xF5
FALSE = 0xF6
NULL = 0xF7
INT = 0xF8
FLOAT = 0xF9
DOUBLE = 0xFA
DOUBLE_0 = 0xFB
DOUBLE_1 = 0xFC
END_COLLECTION = 0xFD
RESET_CACHES = 0xFE
INT_PACKED_1_NEG = 0xFF              # the single-byte -1


class TaggedValue:
    """A struct with a tag this codec has no native mapping for."""

    def __init__(self, tag: str, values: list):
        self.tag = tag
        self.values = values

    def __eq__(self, other):
        return (isinstance(other, TaggedValue) and other.tag == self.tag
                and other.values == self.values)

    def __repr__(self):
        return f"TaggedValue({self.tag!r}, {self.values!r})"


class StructType:
    def __init__(self, tag: str, n_fields: int):
        self.tag = tag
        self.n_fields = n_fields


class FressianError(Exception):
    pass


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class Reader:
    def __init__(self, data: bytes):
        self.buf = io.BytesIO(data)
        self.priority_cache: list = []
        self.struct_cache: list[StructType] = []

    # -- raw reads --------------------------------------------------------

    def _u1(self) -> int:
        b = self.buf.read(1)
        if not b:
            raise FressianError("unexpected EOF")
        return b[0]

    def _raw(self, n: int) -> bytes:
        b = self.buf.read(n)
        if len(b) != n:
            raise FressianError("unexpected EOF")
        return b

    def _int_n(self, n: int) -> int:
        """n-byte big-endian unsigned."""
        v = 0
        for b in self._raw(n):
            v = (v << 8) | b
        return v

    # -- object reads -----------------------------------------------------

    def read(self) -> Any:
        return self._read_object(self._u1())

    def at_eof(self) -> bool:
        pos = self.buf.tell()
        more = self.buf.read(1)
        self.buf.seek(pos)
        return not more

    def _read_object(self, code: int) -> Any:
        # Packed small ints 0..63 and -1.
        if code <= 0x3F:
            return code
        if code == INT_PACKED_1_NEG:
            return -1
        # Packed int zones (spec: signed (code-bias) high bits).
        if 0x40 <= code <= 0x5F:
            return ((code - 0x50) << 8) | self._int_n(1)
        if 0x60 <= code <= 0x6F:
            return ((code - 0x68) << 16) | self._int_n(2)
        if 0x70 <= code <= 0x73:
            return ((code - 0x72) << 24) | self._int_n(3)
        if 0x74 <= code <= 0x77:
            return ((code - 0x76) << 32) | self._int_n(4)
        if 0x78 <= code <= 0x7B:
            return ((code - 0x7A) << 40) | self._int_n(5)
        if 0x7C <= code <= 0x7F:
            return ((code - 0x7E) << 48) | self._int_n(6)
        if code == INT:
            return _struct.unpack(">q", self._raw(8))[0]

        if code == NULL:
            return None
        if code == TRUE:
            return True
        if code == FALSE:
            return False
        if code == DOUBLE:
            return _struct.unpack(">d", self._raw(8))[0]
        if code == DOUBLE_0:
            return 0.0
        if code == DOUBLE_1:
            return 1.0
        if code == FLOAT:
            return _struct.unpack(">f", self._raw(4))[0]

        # Strings / bytes.
        if STRING_PACKED_START <= code <= 0xE1:
            return self._raw(code - STRING_PACKED_START).decode("utf-8")
        if code == STRING:
            return self._raw(self._read_int()).decode("utf-8")
        if code == STRING_CHUNK:
            parts = [self._raw(self._read_int()).decode("utf-8")]
            nxt = self._u1()
            while nxt == STRING_CHUNK:
                parts.append(self._raw(self._read_int()).decode("utf-8"))
                nxt = self._u1()
            if nxt != STRING:
                raise FressianError("bad string chunk terminator")
            parts.append(self._raw(self._read_int()).decode("utf-8"))
            return "".join(parts)
        if BYTES_PACKED_START <= code <= 0xD7:
            return self._raw(code - BYTES_PACKED_START)
        if code == BYTES:
            return self._raw(self._read_int())

        # Lists.
        if LIST_PACKED_START <= code <= 0xEB:
            return [self.read() for _ in range(code - LIST_PACKED_START)]
        if code == LIST:
            return [self.read() for _ in range(self._read_int())]
        if code in (BEGIN_CLOSED_LIST, BEGIN_OPEN_LIST):
            out = []
            while True:
                c = self._u1()
                if c == END_COLLECTION:
                    return out
                out.append(self._read_object(c))

        # Caches.
        if PRIORITY_CACHE_PACKED_START <= code <= 0x9F:
            return self._cache_ref(code - PRIORITY_CACHE_PACKED_START)
        if code == GET_PRIORITY_CACHE:
            return self._cache_ref(self._read_int())
        if code == PUT_PRIORITY_CACHE:
            idx = len(self.priority_cache)
            self.priority_cache.append(None)   # reserve slot in order
            v = self.read()
            self.priority_cache[idx] = v
            return v
        if code == PRECACHE:
            idx = len(self.priority_cache)
            self.priority_cache.append(None)
            self.priority_cache[idx] = self.read()
            return self.read()  # precache then the actual object
        if code == RESET_CACHES:
            self.priority_cache = []
            self.struct_cache = []
            return self.read()

        # Structs / named types.
        if code == KEY:
            ns, name = self.read(), self.read()
            return Keyword(f"{ns}/{name}" if ns else str(name))
        if code == SYM:
            ns, name = self.read(), self.read()
            return Symbol(f"{ns}/{name}" if ns else str(name))
        if code == STRUCTTYPE:
            tag = self.read()
            n = self._read_int()
            st = StructType(str(tag), n)
            self.struct_cache.append(st)
            return self._read_struct(st)
        if code == STRUCT:
            tag = self.read()
            n = self._read_int()
            return self._read_struct(StructType(str(tag), n))
        if STRUCT_CACHE_PACKED_START <= code <= 0xAF:
            idx = code - STRUCT_CACHE_PACKED_START
            if idx >= len(self.struct_cache):
                raise FressianError(f"struct cache miss {idx}")
            return self._read_struct(self.struct_cache[idx])

        if code == MAP:
            kvs = self.read()   # a list of alternating k/v
            return dict(zip(kvs[::2], kvs[1::2]))
        if code == SET:
            items = self.read()
            try:
                return frozenset(items)
            except TypeError:
                return tuple(items)
        if code == INST:
            millis = self.read()
            return datetime.datetime.fromtimestamp(
                millis / 1000, tz=datetime.timezone.utc)
        if code == FOOTER:
            # length + magic + checksum follow; stream ends here.
            raise FressianError("footer")

        raise FressianError(f"unsupported fressian code 0x{code:02X}")

    def _cache_ref(self, idx: int) -> Any:
        if idx >= len(self.priority_cache):
            raise FressianError(f"priority cache miss {idx}")
        return self.priority_cache[idx]

    def _read_int(self) -> int:
        v = self.read()
        if not isinstance(v, int):
            raise FressianError(f"expected int, got {type(v)}")
        return v

    def _read_struct(self, st: StructType) -> Any:
        vals = [self.read() for _ in range(st.n_fields)]
        return convert_tagged(st.tag, vals)


def convert_tagged(tag: str, vals: list) -> Any:
    """Map jepsen's custom write handlers (store.clj:31-116) onto
    Python values; unknown tags stay TaggedValue."""
    if tag == "atom" and len(vals) == 1:
        return vals[0]                       # deref'd atom
    if tag in ("clojure/instant", "datetime", "org.joda.time.DateTime") \
            and len(vals) == 1 and isinstance(vals[0], int):
        return datetime.datetime.fromtimestamp(
            vals[0] / 1000, tz=datetime.timezone.utc)
    if tag == "map-entry" and len(vals) == 2:
        # The reference's independent/tuple IS a MapEntry
        # (independent.clj:22-30) — reconstruct the lifted type so
        # re-analysis of reference stores splits per key again.
        from .independent import Tuple
        return Tuple(vals[0], vals[1])
    if tag == "multiset" and len(vals) == 1 and isinstance(vals[0], dict):
        out = []
        for v, n in vals[0].items():
            out.extend([v] * int(n))
        return out
    return TaggedValue(tag, vals)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class Writer:
    def __init__(self):
        self.buf = io.BytesIO()
        self.priority_cache: dict = {}

    def getvalue(self) -> bytes:
        return self.buf.getvalue()

    def _w(self, *bs: int) -> None:
        self.buf.write(bytes(bs))

    def write(self, v: Any) -> None:
        if v is None:
            return self._w(NULL)
        if v is True:
            return self._w(TRUE)
        if v is False:
            return self._w(FALSE)
        if isinstance(v, int):
            return self._write_int(v)
        if isinstance(v, float):
            if v == 0.0:
                return self._w(DOUBLE_0)
            if v == 1.0:
                return self._w(DOUBLE_1)
            self._w(DOUBLE)
            return self.buf.write(_struct.pack(">d", v)) and None
        if isinstance(v, Keyword):
            return self._write_named(KEY, str(v))
        if isinstance(v, Symbol):
            return self._write_named(SYM, str(v))
        if isinstance(v, str):
            return self._write_string(v)
        if isinstance(v, (bytes, bytearray)):
            b = bytes(v)
            if len(b) <= 7:
                self._w(BYTES_PACKED_START + len(b))
            else:
                self._w(BYTES)
                self._write_int(len(b))
            return self.buf.write(b) and None
        if isinstance(v, datetime.datetime):
            self._w(INST)
            if v.tzinfo is None:
                # Codec convention: naive datetimes are UTC wall-clock,
                # so fields round-trip identically through the UTC-aware
                # value the reader returns, independent of host tz.
                v = v.replace(tzinfo=datetime.timezone.utc)
            return self._write_int(int(v.timestamp() * 1000))
        if isinstance(v, (set, frozenset)):
            self._w(SET)
            return self._write_list(sorted(v, key=repr))
        if isinstance(v, dict):
            self._w(MAP)
            kvs: list = []
            for k, val in v.items():
                kvs.append(k)
                kvs.append(val)
            return self._write_list(kvs)
        if isinstance(v, (list, tuple)):
            return self._write_list(list(v))
        if isinstance(v, TaggedValue):
            self._w(STRUCT)
            self.write(v.tag)
            self._write_int(len(v.values))
            for x in v.values:
                self.write(x)
            return None
        raise FressianError(f"can't write {type(v)}")

    def _write_int(self, n: int) -> None:
        """Packed ints per the spec's zones (high bits in code - bias)."""
        if -1 <= n <= 63:
            return self._w(n & 0xFF)
        for shift, bias, lo in ((8, 0x50, 0x40), (16, 0x68, 0x60),
                                (24, 0x72, 0x70), (32, 0x76, 0x74),
                                (40, 0x7A, 0x78), (48, 0x7E, 0x7C)):
            high = n >> shift
            code = bias + high
            hi_code = {0x50: 0x5F, 0x68: 0x6F, 0x72: 0x73, 0x76: 0x77,
                       0x7A: 0x7B, 0x7E: 0x7F}[bias]
            if lo <= code <= hi_code:
                self._w(code)
                rest = n & ((1 << shift) - 1)
                return self.buf.write(
                    rest.to_bytes(shift // 8, "big")) and None
        self._w(INT)
        self.buf.write(_struct.pack(">q", n))

    def _write_string(self, s: str) -> None:
        b = s.encode("utf-8")
        if len(b) <= 7:
            self._w(STRING_PACKED_START + len(b))
        else:
            self._w(STRING)
            self._write_int(len(b))
        self.buf.write(b)

    def _write_named(self, code: int, name: str) -> None:
        """Keyword/symbol: code + ns + name, with priority caching of
        the whole form the way the JVM writer caches them."""
        key = (code, name)
        if key in self.priority_cache:
            idx = self.priority_cache[key]
            if idx < 0x9F - PRIORITY_CACHE_PACKED_START:
                return self._w(PRIORITY_CACHE_PACKED_START + idx)
            self._w(GET_PRIORITY_CACHE)
            return self._write_int(idx)
        idx = len(self.priority_cache)
        self.priority_cache[key] = idx
        self._w(PUT_PRIORITY_CACHE)
        self._w(code)
        if "/" in name:
            ns, nm = name.split("/", 1)
            self.write(ns)
            self.write(nm)
        else:
            self.write(None)
            self.write(name)

    def _write_list(self, items: list) -> None:
        if len(items) <= 7:
            self._w(LIST_PACKED_START + len(items))
        else:
            self._w(LIST)
            self._write_int(len(items))
        for x in items:
            self.write(x)


def loads(data: bytes) -> Any:
    """Read the first object from fressian bytes."""
    return Reader(data).read()


def loads_all(data: bytes) -> list:
    r = Reader(data)
    out = []
    while not r.at_eof():
        try:
            out.append(r.read())
        except FressianError as e:
            if "footer" in str(e):
                break
            raise
    return out


def dumps(v: Any) -> bytes:
    w = Writer()
    w.write(v)
    return w.getvalue()


def load_test(path) -> Any:
    """Load a test.fressian artifact (store.clj:181-193's load)."""
    with open(path, "rb") as f:
        return loads(f.read())
