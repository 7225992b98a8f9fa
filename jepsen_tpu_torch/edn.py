"""EDN reader/writer.

The reference framework persists histories and results as EDN
(`history.edn`, `results.edn`; reference: jepsen/src/jepsen/store.clj:195-239)
so this codec exists for store compatibility: our framework can re-analyze
histories recorded by the reference and emit artifacts the reference's
tooling can read.

Design choices:
  * Keywords and symbols are str subclasses (`Keyword`, `Symbol`), so
    ``Keyword("ok") == "ok"`` — internal code works with plain strings while
    the printer still round-trips ``:ok``.
  * Tagged literals (``#foo/Bar {...}``) parse to `Tagged(tag, value)` unless
    a reader is registered; record tags like ``#knossos.model.CASRegister{}``
    are revived to plain dicts with the tag attached (mirroring the
    defrecord-reviving reader in the reference store, store.clj:195-239).
"""

from __future__ import annotations

import datetime
import io
import math
from typing import Any, Callable


class Keyword(str):
    """An EDN keyword. Compares equal to its name string."""

    __slots__ = ()
    _interned: dict[str, "Keyword"] = {}

    def __new__(cls, name: str) -> "Keyword":
        k = cls._interned.get(name)
        if k is None:
            k = super().__new__(cls, name)
            cls._interned[name] = k
        return k

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f":{str.__str__(self)}"


class Symbol(str):
    """An EDN symbol. Compares equal to its name string."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return str.__str__(self)


class Tagged:
    """A tagged literal the reader had no handler for."""

    __slots__ = ("tag", "value")

    def __init__(self, tag: str, value: Any):
        self.tag = tag
        self.value = value

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Tagged)
            and self.tag == other.tag
            and self.value == other.value
        )

    def __hash__(self) -> int:
        return hash((self.tag, _hashable(self.value)))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"#{self.tag} {self.value!r}"


def _hashable(v: Any) -> Any:
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(_hashable(x) for x in v)
    return v


_WS = " \t\r\n,"
_CHAR_NAMES = {
    "newline": "\n",
    "return": "\r",
    "space": " ",
    "tab": "\t",
    "backspace": "\b",
    "formfeed": "\f",
}


def _default_inst(s: str) -> datetime.datetime:
    # EDN instants are RFC-3339; datetime.fromisoformat handles the common
    # forms once a trailing Z is normalized.
    return datetime.datetime.fromisoformat(s.replace("Z", "+00:00"))


DEFAULT_READERS: dict[str, Callable[[Any], Any]] = {
    "inst": _default_inst,
    "uuid": lambda s: s,
}


class _Reader:
    def __init__(self, text: str, readers: dict[str, Callable[[Any], Any]]):
        self.text = text
        self.pos = 0
        self.n = len(text)
        self.readers = readers

    def error(self, msg: str) -> Exception:
        line = self.text.count("\n", 0, self.pos) + 1
        return ValueError(f"EDN parse error at line {line} (pos {self.pos}): {msg}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def next_ch(self) -> str:
        ch = self.text[self.pos]
        self.pos += 1
        return ch

    def skip_ws(self) -> None:
        while self.pos < self.n:
            ch = self.text[self.pos]
            if ch in _WS:
                self.pos += 1
            elif ch == ";":
                nl = self.text.find("\n", self.pos)
                self.pos = self.n if nl < 0 else nl + 1
            else:
                return

    def read(self) -> Any:
        self.skip_ws()
        if self.pos >= self.n:
            raise self.error("unexpected end of input")
        ch = self.peek()
        if ch == "(":
            self.pos += 1
            return tuple(self.read_seq(")"))
        if ch == "[":
            self.pos += 1
            return self.read_seq("]")
        if ch == "{":
            self.pos += 1
            return self.read_map()
        if ch == '"':
            return self.read_string()
        if ch == ":":
            self.pos += 1
            return Keyword(self.read_token())
        if ch == "\\":
            return self.read_char()
        if ch == "#":
            return self.read_dispatch()
        if ch in ")]}":
            raise self.error(f"unmatched delimiter {ch!r}")
        return self.read_atom()

    def read_seq(self, closer: str) -> list:
        out = []
        while True:
            self.skip_ws()
            if self.pos >= self.n:
                raise self.error(f"expected {closer!r}")
            if self.peek() == closer:
                self.pos += 1
                return out
            v = self.read()
            if v is not _DISCARDED:
                out.append(v)

    def read_map(self) -> dict:
        items = self.read_seq("}")
        if len(items) % 2:
            raise self.error("map literal with odd number of forms")
        out = {}
        for i in range(0, len(items), 2):
            out[_as_key(items[i])] = items[i + 1]
        return out

    def read_string(self) -> str:
        self.pos += 1  # opening quote
        buf = io.StringIO()
        while True:
            if self.pos >= self.n:
                raise self.error("unterminated string")
            ch = self.next_ch()
            if ch == '"':
                return buf.getvalue()
            if ch == "\\":
                esc = self.next_ch()
                if esc == "n":
                    buf.write("\n")
                elif esc == "t":
                    buf.write("\t")
                elif esc == "r":
                    buf.write("\r")
                elif esc == "b":
                    buf.write("\b")
                elif esc == "f":
                    buf.write("\f")
                elif esc == "u":
                    code = self.text[self.pos : self.pos + 4]
                    if len(code) < 4 or not all(c in "0123456789abcdefABCDEF"
                                                for c in code):
                        raise self.error(f"bad unicode escape \\u{code!r}")
                    self.pos += 4
                    buf.write(chr(int(code, 16)))
                else:
                    buf.write(esc)
            else:
                buf.write(ch)

    def read_char(self) -> str:
        self.pos += 1  # backslash
        start = self.pos
        # A char is either a named char or a single character.
        while self.pos < self.n and self.text[self.pos] not in _WS + '()[]{}";':
            self.pos += 1
        tok = self.text[start : self.pos]
        if len(tok) <= 1:
            if not tok:
                raise self.error("bad character literal")
            return tok
        if tok in _CHAR_NAMES:
            return _CHAR_NAMES[tok]
        if tok.startswith("u") and len(tok) == 5:
            return chr(int(tok[1:], 16))
        # Multi-char but unknown: take first char, rewind rest.
        self.pos = start + 1
        return tok[0]

    def read_dispatch(self) -> Any:
        self.pos += 1  # '#'
        ch = self.peek()
        if ch == "#":  # symbolic values: ##NaN ##Inf ##-Inf
            self.pos += 1
            tok = self.read_token()
            if tok == "NaN":
                return math.nan
            if tok == "Inf":
                return math.inf
            if tok == "-Inf":
                return -math.inf
            raise self.error(f"unknown symbolic value ##{tok}")
        if ch == "{":
            self.pos += 1
            return frozenset(_as_key(v) for v in self.read_seq("}"))
        if ch == "_":
            self.pos += 1
            self.read()  # discard next form
            return _DISCARDED
        # Tagged literal: #tag value, including record syntax #ns.Rec{...}.
        tag = self.read_token()
        value = self.read()
        reader = self.readers.get(tag)
        if reader is not None:
            return reader(value)
        if isinstance(value, dict):
            # Record-style: revive as a dict, remembering its type.
            out = dict(value)
            out[Keyword("edn/tag")] = tag
            return out
        return Tagged(tag, value)

    def read_token(self) -> str:
        start = self.pos
        while self.pos < self.n:
            ch = self.text[self.pos]
            if ch in _WS or ch in '()[]";' or ch in "}]":
                break
            if ch == "{":  # record literal opens right after the tag
                break
            self.pos += 1
        if self.pos == start:
            raise self.error("empty token")
        return self.text[start : self.pos]

    def read_atom(self) -> Any:
        tok = self.read_token()
        if tok == "nil":
            return None
        if tok == "true":
            return True
        if tok == "false":
            return False
        first = tok[0]
        if first.isdigit() or (first in "+-" and len(tok) > 1 and tok[1].isdigit()):
            return _parse_number(tok, self)
        return Symbol(tok)


def _parse_number(tok: str, rdr: _Reader) -> Any:
    if tok.endswith("N"):
        return int(tok[:-1])
    if tok.endswith("M"):
        return float(tok[:-1])
    if "/" in tok:  # ratio
        num, den = tok.split("/")
        return int(num) / int(den)
    try:
        if any(c in tok for c in ".eE") and not tok.startswith("0x"):
            return float(tok)
        return int(tok, 0) if tok.startswith(("0x", "-0x", "+0x")) else int(tok)
    except ValueError as e:
        raise rdr.error(f"bad number {tok!r}") from e


def _as_key(v: Any) -> Any:
    """Make a parsed value usable as a dict key / set member."""
    if isinstance(v, list):
        return tuple(_as_key(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _as_key(x)) for k, x in v.items()))
    return v


class _Discarded:
    __slots__ = ()


_DISCARDED = _Discarded()


def loads(text: str, readers: dict[str, Callable[[Any], Any]] | None = None) -> Any:
    """Parse a single EDN form from `text`."""
    r = _Reader(text, {**DEFAULT_READERS, **(readers or {})})
    v = r.read()
    while v is _DISCARDED:
        v = r.read()
    return v


def loads_all(text: str, readers=None) -> list:
    """Parse every top-level EDN form in `text` (e.g. a history.edn file)."""
    r = _Reader(text, {**DEFAULT_READERS, **(readers or {})})
    out = []
    while True:
        r.skip_ws()
        if r.pos >= r.n:
            return out
        v = r.read()
        if v is not _DISCARDED:
            out.append(v)


_STR_ESC = {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\t": "\\t", "\r": "\\r"}


def _dump(v: Any, out: io.StringIO, keywordize: bool) -> None:
    if v is None:
        out.write("nil")
    elif v is True:
        out.write("true")
    elif v is False:
        out.write("false")
    elif isinstance(v, Keyword):
        out.write(":" + str.__str__(v))
    elif isinstance(v, Symbol):
        out.write(str.__str__(v))
    elif isinstance(v, str):
        if keywordize and _keyword_safe(v):
            out.write(":" + v)
        else:
            out.write('"' + "".join(_STR_ESC.get(c, c) for c in v) + '"')
    elif isinstance(v, bool):  # pragma: no cover - caught above
        out.write("true" if v else "false")
    elif isinstance(v, int):
        out.write(str(v))
    elif isinstance(v, float):
        if math.isnan(v):
            out.write("##NaN")
        elif math.isinf(v):
            out.write("##Inf" if v > 0 else "##-Inf")
        else:
            out.write(repr(v))
    elif isinstance(v, dict):
        out.write("{")
        for i, (k, x) in enumerate(v.items()):
            if i:
                out.write(", ")
            _dump(k, out, keywordize)
            out.write(" ")
            _dump(x, out, keywordize)
        out.write("}")
    elif isinstance(v, (list, tuple)):
        out.write("[")
        for i, x in enumerate(v):
            if i:
                out.write(" ")
            _dump(x, out, keywordize)
        out.write("]")
    elif isinstance(v, (set, frozenset)):
        out.write("#{")
        for i, x in enumerate(sorted(v, key=repr)):
            if i:
                out.write(" ")
            _dump(x, out, keywordize)
        out.write("}")
    elif isinstance(v, Tagged):
        out.write(f"#{v.tag} ")
        _dump(v.value, out, keywordize)
    elif isinstance(v, datetime.datetime):
        out.write(f'#inst "{v.isoformat()}"')
    else:
        # Fall back to the repr as a string — never crash a store write.
        _dump(repr(v), out, False)


def _keyword_safe(s: str) -> bool:
    if not s:
        return False
    if s[0].isdigit() or s[0] == ":":
        return False
    return all(c.isalnum() or c in "-_.*+!?<>=/$&" for c in s)


def dumps(v: Any, keywordize: bool = False) -> str:
    """Serialize `v` to EDN.

    With `keywordize=True`, bare strings that look like keywords are emitted
    as keywords — this makes dict-based op maps round-trip to idiomatic
    history.edn (:type :invoke, ...) without an explicit Keyword wrapper at
    every call site.
    """
    out = io.StringIO()
    _dump(v, out, keywordize)
    return out.getvalue()
