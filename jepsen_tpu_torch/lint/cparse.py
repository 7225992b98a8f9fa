"""Lightweight parser over the native C++ sources (JT-ABI's C side).

This is NOT a C++ front end — it extracts exactly the ABI surface the
ctypes loader and the sidecar readers depend on, from source shaped
like ours (clang-formatted, `extern "C"` exports, `static constexpr`
layout constants), host C++ (`csrc/*.cc`) and CUDA (`csrc/*.cu`)
alike:

  * exported `jt_*` signatures (name, normalized return type,
    normalized arg types) from every `extern "C" { ... }` region, and
    the signature of every single-declaration export
    (`extern "C" int closure_square_launch(...) {`, the CUDA sources'
    form), whatever its name;
  * the literal each `jt_*_abi_version()` returns;
  * integer layout constants (`static constexpr ... NAME = expr;`
    with a tiny safe evaluator for `64 * 1024` / `int64_t(1) << 30`);
  * the sidecar MAGIC byte-string variants (ternary arms expanded);
  * the sidecar field-write order (`arrays.push_back({"name", ...})`
    in source order).

Everything degrades to "absent" rather than guessing: a construct the
parser can't read yields no value, and the cross-check rules treat a
missing value as unprovable, not as drift. The one exception is an
`extern "C"` region with NO parseable exports — that is reported by
the caller, since it means the parser (not the code) went blind.
"""

from __future__ import annotations

import ast
import itertools
import re
from dataclasses import dataclass, field

__all__ = [
    "CSig", "NativeABI", "parse_native", "normalize_type",
    "safe_int_eval",
]


@dataclass(frozen=True)
class CSig:
    """One exported C function: normalized types, no arg names."""

    name: str
    ret: str
    args: tuple[str, ...]
    line: int


@dataclass
class NativeABI:
    """Everything JT-ABI extracts from one .cc file."""

    path: str = ""
    exports: dict[str, CSig] = field(default_factory=dict)
    abi_versions: dict[str, int] = field(default_factory=dict)
    constants: dict[str, int] = field(default_factory=dict)
    magics: set[bytes] = field(default_factory=set)
    sidecar_fields: tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Comments and small helpers
# ---------------------------------------------------------------------------

def strip_comments(text: str) -> str:
    """// and /* */ comments replaced by spaces, preserving newlines
    (so line numbers computed on the stripped text stay true)."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == '"' or c == "'":
            q = c
            out.append(c)
            i += 1
            while i < n:
                out.append(text[i])
                if text[i] == "\\" and i + 1 < n:
                    out.append(text[i + 1])
                    i += 2
                    continue
                if text[i] == q:
                    i += 1
                    break
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                out.append(" ")
                i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "*":
            while i + 1 < n and not (text[i] == "*"
                                     and text[i + 1] == "/"):
                out.append("\n" if text[i] == "\n" else " ")
                i += 1
            out.append("  ")
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def normalize_type(decl: str, *, with_name: bool = False) -> str | None:
    """`const char* hist_path` → 'char*'; `int64_t out[8]` → 'int64_t*';
    `void` → None (empty arg list). `with_name=False` treats the whole
    string as a type (return types)."""
    decl = decl.strip()
    if not decl or decl == "void":
        return None if with_name else "void"
    stars = decl.count("*") + (1 if "[" in decl else 0)
    decl = re.sub(r"\[[^\]]*\]", " ", decl)
    toks = [t for t in decl.replace("*", " ").split()
            if t not in ("const", "struct")]
    if with_name and len(toks) > 1:
        toks = toks[:-1]     # drop the parameter name
    return " ".join(toks) + "*" * stars


_SUFFIX_RE = re.compile(r"(?<=[0-9a-fA-F])(?:[uU]?[lL]{1,2}|[uU])\b")
_CAST_RE = re.compile(r"\b(?:u?int(?:8|16|32|64)_t|size_t|long|int)\s*\(")


def safe_int_eval(expr: str) -> int | None:
    """Evaluate a constant integer expression (`64 * 1024`,
    `int64_t(1) << 30`, `0x9E37...ULL`) via a whitelisted AST walk;
    None for anything else (INT64_MIN, arithmetic we don't model)."""
    expr = _SUFFIX_RE.sub("", expr)
    expr = _CAST_RE.sub("(", expr)
    try:
        tree = ast.parse(expr.strip(), mode="eval")
    except SyntaxError:
        return None

    def ev(n: ast.AST) -> int:
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, int) \
                and not isinstance(n.value, bool):
            return n.value
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.USub):
            return -ev(n.operand)
        if isinstance(n, ast.BinOp):
            ops = {ast.Mult: lambda a, b: a * b,
                   ast.Add: lambda a, b: a + b,
                   ast.Sub: lambda a, b: a - b,
                   ast.LShift: lambda a, b: a << b,
                   ast.RShift: lambda a, b: a >> b,
                   ast.BitOr: lambda a, b: a | b,
                   ast.FloorDiv: lambda a, b: a // b}
            f = ops.get(type(n.op))
            if f is None:
                raise ValueError(ast.dump(n.op))
            return f(ev(n.left), ev(n.right))
        raise ValueError(ast.dump(n))

    try:
        return ev(tree)
    except (ValueError, ZeroDivisionError, RecursionError):
        return None


# ---------------------------------------------------------------------------
# extern "C" regions and exported signatures
# ---------------------------------------------------------------------------

def _extern_c_regions(text: str) -> list[tuple[int, int]]:
    """(start, end) character spans of each `extern "C" { ... }` body,
    by brace matching."""
    regions = []
    for m in re.finditer(r'extern\s+"C"\s*\{', text):
        depth = 1
        i = m.end()
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        regions.append((m.end(), i - 1))
    return regions


_FN_RE = re.compile(
    r"(?P<ret>[A-Za-z_][A-Za-z0-9_ \t]*?[\s\*]+)"
    r"(?P<name>jt_[A-Za-z0-9_]+)\s*\((?P<args>[^)]*)\)\s*\{")


#: `extern "C" <ret> <name>(<args>) {` — one exported definition with
#: no braced region (the CUDA sources' form); any identifier, since the
#: declaration itself says it is an export.
_SINGLE_RE = re.compile(
    r'extern\s+"C"\s+(?P<ret>[A-Za-z_][A-Za-z0-9_ \t]*?[\s\*]+)'
    r"(?P<name>[A-Za-z_][A-Za-z0-9_]*)\s*\((?P<args>[^)]*)\)\s*\{")


def _sig(m: re.Match, text: str, offset: int) -> CSig:
    ret = normalize_type(m.group("ret"))
    args = []
    raw = m.group("args").strip()
    if raw:
        for piece in raw.split(","):
            t = normalize_type(piece, with_name=True)
            if t is not None:
                args.append(t)
    line = text[:offset + m.start()].count("\n") + 1
    return CSig(m.group("name"), ret or "void", tuple(args), line)


def _parse_exports(text: str) -> dict[str, CSig]:
    out: dict[str, CSig] = {}
    for start, end in _extern_c_regions(text):
        body = text[start:end]
        for m in _FN_RE.finditer(body):
            sig = _sig(m, text, start)
            out[sig.name] = sig
    for m in _SINGLE_RE.finditer(text):
        sig = _sig(m, text, 0)
        out[sig.name] = sig
    return out


_VERSION_RE = re.compile(
    r"\b(jt_[A-Za-z0-9_]*abi_version)\s*\(\s*\)\s*\{\s*return\s+(\d+)")

_CONST_RE = re.compile(
    r"\bstatic\s+constexpr\s+[A-Za-z_][A-Za-z0-9_]*\s+"
    r"([A-Za-z_][A-Za-z0-9_]*)\s*=\s*([^;]+);")

_MAGIC_RE = re.compile(
    r"\bconst\s+char\s+MAGIC\s*\[\s*\d+\s*\]\s*=\s*\{([^}]*)\}")

_PUSH_RE = re.compile(r'arrays\.push_back\(\s*\{\s*"(\w+)"')

_CHAR_RE = re.compile(r"'(\\?[^'])'")


def _magic_variants(elems_src: str) -> set[bytes]:
    """Expand the MAGIC initializer into its possible byte strings —
    each element is a char literal or a ternary over two of them."""
    per_elem: list[list[bytes]] = []
    for piece in elems_src.split(","):
        chars = [c.encode().decode("unicode_escape").encode("latin-1")
                 for c in _CHAR_RE.findall(piece)]
        if not chars:
            return set()    # un-modeled element: give up, not guess
        per_elem.append(chars if "?" in piece else chars[:1])
    return {b"".join(combo)
            for combo in itertools.product(*per_elem)}


def parse_native(text: str, path: str = "") -> NativeABI:
    """The full JT-ABI extraction for one .cc or .cu source text."""
    stripped = strip_comments(text)
    abi = NativeABI(path=path)
    abi.exports = _parse_exports(stripped)
    for m in _VERSION_RE.finditer(stripped):
        abi.abi_versions[m.group(1)] = int(m.group(2))
    for m in _CONST_RE.finditer(stripped):
        v = safe_int_eval(m.group(2))
        if v is not None:
            abi.constants.setdefault(m.group(1), v)
    mm = _MAGIC_RE.search(stripped)
    if mm:
        abi.magics = _magic_variants(mm.group(1))
    # canonical field write order: the v1/v2 branches push the same
    # field name at the same relative position, so first occurrence
    # IS the order — and keeps a reordered reader from hiding behind
    # the duplicate
    seen: list[str] = []
    for m in _PUSH_RE.finditer(stripped):
        if m.group(1) not in seen:
            seen.append(m.group(1))
    abi.sidecar_fields = tuple(seen)
    return abi
