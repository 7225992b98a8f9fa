"""JT-ABI — the ABI/layout prover across the C++/Python boundary.

The port's native ABI lives in four places that nothing but this
family checks against each other: the `extern "C"` exports of
`csrc/*.cc` and `csrc/*.cu`, the ctypes prototypes of
`_build.PROTOTYPES` (one dict per library, `name: (restype,
[argtypes])`), the ABI version each library returns and
`_build.ABI_VERSIONS` pins, and the `encoded.v1/v2.bin` layout
mirrored between `hist_encode.cc`'s `write_sidecar` and `store.py`. A
half-landed change — a new export with no prototype, an argtype that
silently truncates, a pad constant changed on one side — either fails
at load (the good case) or corrupts tensors at a distance (the case
this family exists for).

Four project rules, all driven by `cparse.parse_native` on the C side
and plain `ast` extraction of `_build.py` on the Python side:

  JT-ABI-001  export/prototype coverage drift (symbol sets differ, or
              a prototype bound under another library than the
              source that exports it)
  JT-ABI-002  ABI version constant drift (C return vs ABI_VERSIONS)
  JT-ABI-003  prototype drift (arity / incompatible ctypes per arg)
  JT-ABI-004  sidecar layout drift (pad geometry, hash span, xxh64
              primes, magic strings, field write order)

Everything is path-relative to the ProjectCtx root, so the
seeded-mutation harness (tests/test_torch_contract_prover.py) can point
the rules at a fixture tree whose csrc / _build.py / store.py copies
carry exactly one induced drift each.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from . import Finding, ProjectCtx, ProjectRule, const_str, dotted
from . import cparse, dataflow

_CSRC = "jepsen_tpu_torch/csrc/"
_NATIVE_SOURCES = (_CSRC + "hist_encode.cc", _CSRC + "wgl.cc",
                   _CSRC + "closure_square.cu", _CSRC + "knossos_dense.cu",
                   _CSRC + "knossos_frontier.cu")
_NATIVE_LIB = "jepsen_tpu_torch/_build.py"
_STORE = "jepsen_tpu_torch/store.py"
_ENCODE = "jepsen_tpu_torch/checker/elle/encode.py"

#: Normalized C type → ctypes renders that faithfully bind it.
CTYPES_COMPAT: dict[str, frozenset[str]] = {
    "void": frozenset({"None"}),
    "int": frozenset({"c_int", "c_int32"}),
    "int32_t": frozenset({"c_int32", "c_int"}),
    "int64_t": frozenset({"c_int64"}),
    "uint32_t": frozenset({"c_uint32"}),
    "uint64_t": frozenset({"c_uint64"}),
    "double": frozenset({"c_double"}),
    "float": frozenset({"c_float"}),
    "char*": frozenset({"c_char_p"}),
    "void*": frozenset({"c_void_p"}),
    "uint8_t*": frozenset({"c_char_p", "POINTER(c_uint8)"}),
    "int32_t*": frozenset({"POINTER(c_int32)"}),
    "int64_t*": frozenset({"POINTER(c_int64)"}),
    "uint64_t*": frozenset({"POINTER(c_uint64)"}),
}


@dataclass
class Proto:
    """One ctypes prototype of `_build.PROTOTYPES`."""

    name: str
    restype: str | None
    argtypes: tuple[str, ...] | None
    line: int
    lib: str = ""       #: the PROTOTYPES key: the csrc stem that exports it


# ---------------------------------------------------------------------------
# Python-side extraction
# ---------------------------------------------------------------------------

def _render_ctype(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """'c_int64' / 'POINTER(c_int32)' / 'None' for a ctypes type
    expression; None when unrenderable (dynamic)."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    if isinstance(node, ast.Name):
        return aliases.get(node.id, node.id)
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        if d and d.split(".")[-1] == "POINTER" and node.args:
            inner = _render_ctype(node.args[0], aliases)
            return f"POINTER({inner})" if inner else None
    return None


def _proto_of(name: str, lib: str, value: ast.AST, line: int,
              aliases: dict[str, str]) -> Proto:
    """A `(restype, [argtypes])` tuple as a Proto (an unreadable shape
    leaves both None: unprovable, not drift)."""
    restype = argtypes = None
    if isinstance(value, ast.Tuple) and len(value.elts) == 2:
        restype = _render_ctype(value.elts[0], aliases)
        args = value.elts[1]
        if isinstance(args, (ast.List, ast.Tuple)):
            argtypes = tuple(_render_ctype(e, aliases) or "?"
                             for e in args.elts)
    return Proto(name, restype, argtypes, line, lib)


def _lib_protos(lib: str, node: ast.Dict,
                aliases: dict[str, str]) -> Iterator[Proto]:
    """The prototypes of one library's dict: `"fn": (restype, [...])`
    entries and `**{fn: (...) for fn in ("jt_a", "jt_b")}` spreads."""
    for k, v in zip(node.keys, node.values):
        if k is not None:
            name = const_str(k)
            if name:
                yield _proto_of(name, lib, v, v.lineno, aliases)
        elif isinstance(v, ast.DictComp) and len(v.generators) == 1 \
                and isinstance(v.key, ast.Name):
            g = v.generators[0]
            if isinstance(g.target, ast.Name) \
                    and g.target.id == v.key.id \
                    and isinstance(g.iter, (ast.Tuple, ast.List)):
                for e in g.iter.elts:
                    name = const_str(e)
                    if name:
                        yield _proto_of(name, lib, v.value, e.lineno,
                                        aliases)


def extract_ctypes(tree: ast.Module) -> tuple[dict[str, Proto],
                                              dict[str, tuple[int, int]]]:
    """(prototypes, version checks) from `_build.py`'s AST.

    Prototypes come from the module-level `PROTOTYPES = {lib: {name:
    (restype, [argtypes]), ...}}` table, the `**{fn: ... for fn in
    (...)}` batch form included, with module-level ctypes aliases
    (`_i32p = ctypes.POINTER(ctypes.c_int32)`) resolved. Version checks
    are the `ABI_VERSIONS = {lib: ("jt_x_abi_version", N)}` entries
    `load` compares at bind time, mapped name → (N, line)."""
    protos: dict[str, Proto] = {}
    checks: dict[str, tuple[int, int]] = {}
    aliases: dict[str, str] = {}
    for n in tree.body:
        if not (isinstance(n, (ast.Assign, ast.AnnAssign))):
            continue
        target = n.targets[0] if isinstance(n, ast.Assign) \
            and len(n.targets) == 1 else getattr(n, "target", None)
        if not isinstance(target, ast.Name) or n.value is None:
            continue
        r = _render_ctype(n.value, aliases)
        if r is not None and ("POINTER" in r or r.startswith("c_")):
            aliases[target.id] = r
            continue
        if target.id == "PROTOTYPES" and isinstance(n.value, ast.Dict):
            for k, v in zip(n.value.keys, n.value.values):
                lib = const_str(k) if k is not None else None
                if lib and isinstance(v, ast.Dict):
                    for p in _lib_protos(lib, v, aliases):
                        protos[p.name] = p
        elif target.id == "ABI_VERSIONS" \
                and isinstance(n.value, ast.Dict):
            for v in n.value.values:
                if isinstance(v, ast.Tuple) and len(v.elts) == 2:
                    fn = const_str(v.elts[0])
                    c = v.elts[1]
                    if fn and isinstance(c, ast.Constant) \
                            and isinstance(c.value, int):
                        checks[fn] = (c.value, v.lineno)
    return protos, checks


# ---------------------------------------------------------------------------
# store.py / encode.py layout extraction
# ---------------------------------------------------------------------------

@dataclass
class StoreLayout:
    consts: dict[str, tuple[int, int]]          # name -> (value, line)
    magics: dict[str, tuple[bytes, int]]        # name -> (value, line)
    field_orders: dict[str, tuple[tuple[str, ...], int]]


def _int_of(node: ast.AST, consts: dict[str, int]) -> int | None:
    v = dataflow.int_value(node, consts)
    if v is not None:
        return v
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Pow):
        b = dataflow.int_value(node.left, consts)
        e = dataflow.int_value(node.right, consts)
        if b is not None and e is not None and 0 <= e < 128:
            return b ** e
    if isinstance(node, ast.Call) and len(node.args) == 1:
        # np.int64(2**30)-style wrap
        return _int_of(node.args[0], consts)
    return None


def extract_store_layout(tree: ast.Module) -> StoreLayout:
    lay = StoreLayout({}, {}, {})
    known: dict[str, int] = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            name = n.targets[0].id
            if isinstance(n.value, ast.Constant) \
                    and isinstance(n.value.value, bytes):
                lay.magics[name] = (n.value.value, n.lineno)
                continue
            v = _int_of(n.value, known)
            if v is not None:
                known[name] = v
                lay.consts[name] = (v, n.lineno)
                continue
            if isinstance(n.value, ast.Dict):
                fields: dict[str, tuple[str, ...]] = {}
                for k, val in zip(n.value.keys, n.value.values):
                    ks = const_str(k) if k is not None else None
                    if ks and isinstance(val, (ast.Tuple, ast.List)) \
                            and all(const_str(e) for e in val.elts):
                        fields[ks] = tuple(const_str(e)
                                           for e in val.elts)
                for ks, fs in fields.items():
                    lay.field_orders[f"ENCODED_FIELDS[{ks!r}]"] = \
                        (fs, n.lineno)
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef) \
                and fn.name == "_padded_arrays":
            for r in ast.walk(fn):
                if isinstance(r, ast.Return) \
                        and isinstance(r.value, ast.List):
                    names = []
                    for e in r.value.elts:
                        if isinstance(e, ast.Tuple) and e.elts \
                                and const_str(e.elts[0]):
                            names.append(const_str(e.elts[0]))
                    if names:
                        lay.field_orders["_padded_arrays"] = \
                            (tuple(names), r.lineno)
    return lay


def _is_subsequence(sub: tuple[str, ...],
                    full: tuple[str, ...]) -> bool:
    it = iter(full)
    return all(s in it for s in sub)


# ---------------------------------------------------------------------------
# The shared project-context cache and the four rules
# ---------------------------------------------------------------------------

def _tree(ctx: ProjectCtx, rel: str) -> ast.Module | None:
    """One Python input of the prover, through the run's SHARED parse
    (ProjectCtx.module — the module-rule pass already parsed these
    files). None when missing or unparseable: the prover must
    DEGRADE on a broken file, never crash the run — the module pass
    already reports the syntax error as a JT-PARSE finding, and a
    half-parsed ABI would only add false drift on top of it."""
    m = ctx.module(rel)
    return None if m is None else m.tree


class _AbiState:
    def __init__(self, ctx: ProjectCtx):
        root = Path(ctx.root)
        self.native: dict[str, cparse.NativeABI] = {}
        for rel in _NATIVE_SOURCES:
            p = root / rel
            if p.is_file():
                try:
                    self.native[rel] = cparse.parse_native(
                        p.read_text(encoding="utf-8",
                                    errors="replace"), rel)
                except OSError:
                    pass
        self.protos: dict[str, Proto] = {}
        self.checks: dict[str, tuple[int, int]] = {}
        lib_tree = _tree(ctx, _NATIVE_LIB)
        self.lib_present = lib_tree is not None
        if lib_tree is not None:
            self.protos, self.checks = extract_ctypes(lib_tree)
        store_tree = _tree(ctx, _STORE)
        self.store: StoreLayout | None = \
            extract_store_layout(store_tree) \
            if store_tree is not None else None
        self.never_completed: int | None = None
        etree = _tree(ctx, _ENCODE)
        if etree is not None:
            for n in etree.body:
                if isinstance(n, ast.Assign) \
                        and isinstance(n.targets[0], ast.Name) \
                        and n.targets[0].id == "NEVER_COMPLETED":
                    self.never_completed = _int_of(n.value, {})

    def exports(self) -> dict[str, tuple[cparse.CSig, str]]:
        out = {}
        for rel, abi in self.native.items():
            for name, sig in abi.exports.items():
                out[name] = (sig, rel)
        return out


def _stem(rel: str) -> str:
    """`hist_encode` for `.../csrc/hist_encode.cc`: the PROTOTYPES key
    its library loads under."""
    return rel.rsplit("/", 1)[-1].rsplit(".", 1)[0]


def _state(ctx: ProjectCtx) -> _AbiState:
    st = getattr(ctx, "_abi_state", None)
    if st is None:
        st = _AbiState(ctx)
        ctx._abi_state = st
    return st


class ExportCoverageDrift(ProjectRule):
    id = "JT-ABI-001"
    doc = ("an `extern \"C\"` export of csrc/ with no ctypes "
           "prototype in _build.PROTOTYPES, a prototype for a symbol "
           "no source exports, or one bound under another library "
           "than the source that exports it — a half-landed ABI "
           "change")
    hint = ("bind the new export in its library's PROTOTYPES entry "
            "(restype + argtypes), or delete the orphaned prototype")

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        st = _state(ctx)
        if not st.native or not st.lib_present:
            return
        exports = st.exports()
        bound = set(st.protos) | set(st.checks)
        for name, (sig, rel) in sorted(exports.items()):
            if name not in bound:
                yield Finding(self.id, _NATIVE_LIB, 1,
                              f"export `{name}` ({rel}:{sig.line}) "
                              "has no ctypes prototype", self.hint)
        for name, p in sorted(st.protos.items()):
            if name not in exports:
                yield Finding(self.id, _NATIVE_LIB, p.line,
                              f"ctypes prototype for `{name}` but no "
                              "native export", self.hint)
            elif p.lib and _stem(exports[name][1]) != p.lib:
                yield Finding(self.id, _NATIVE_LIB, p.line,
                              f"`{name}` is bound under library "
                              f"{p.lib!r} but exported by "
                              f"{exports[name][1]}", self.hint)


class AbiVersionDrift(ProjectRule):
    id = "JT-ABI-002"
    doc = ("the ABI version a `jt_*_abi_version()` export returns "
           "differs from (or is never checked against) the literal "
           "_build.ABI_VERSIONS pins for `load`'s bind-time check")
    hint = ("bump BOTH sides together: the C return and the "
            "library's ABI_VERSIONS entry")

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        st = _state(ctx)
        if not st.native or not st.lib_present:
            return
        for rel, abi in sorted(st.native.items()):
            for name, cval in sorted(abi.abi_versions.items()):
                chk = st.checks.get(name)
                if chk is None:
                    yield Finding(
                        self.id, _NATIVE_LIB, 1,
                        f"`{name}` ({rel}) returns {cval} but "
                        "_build.ABI_VERSIONS never checks it — a stale "
                        ".so would bind silently", self.hint)
                elif chk[0] != cval:
                    yield Finding(
                        self.id, _NATIVE_LIB, chk[1],
                        f"ABI version drift for `{name}`: C++ returns "
                        f"{cval}, _build.ABI_VERSIONS pins {chk[0]}",
                        self.hint)


class PrototypeDrift(ProjectRule):
    id = "JT-ABI-003"
    doc = ("a ctypes prototype whose arity or types no longer match "
           "the C signature — calls through it corrupt arguments "
           "instead of failing")
    hint = ("update the PROTOTYPES entry to mirror the C signature "
            "(see rules_abi.CTYPES_COMPAT for the faithful binding)")

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        st = _state(ctx)
        if not st.native or not st.lib_present:
            return
        exports = st.exports()
        for name, p in sorted(st.protos.items()):
            if name not in exports:
                continue     # JT-ABI-001's finding
            sig, rel = exports[name]
            where = f"{rel}:{sig.line}"
            if p.argtypes is not None:
                if len(p.argtypes) != len(sig.args):
                    yield Finding(
                        self.id, _NATIVE_LIB, p.line,
                        f"`{name}` takes {len(sig.args)} args in C "
                        f"({where}) but argtypes declares "
                        f"{len(p.argtypes)}", self.hint)
                else:
                    for i, (c, py) in enumerate(zip(sig.args,
                                                    p.argtypes)):
                        ok = CTYPES_COMPAT.get(c)
                        if ok is not None and py not in ok:
                            yield Finding(
                                self.id, _NATIVE_LIB, p.line,
                                f"`{name}` arg {i} is `{c}` in C "
                                f"({where}) but bound as `{py}`",
                                self.hint)
            if p.restype is not None:
                ok = CTYPES_COMPAT.get(sig.ret)
                if ok is not None and p.restype not in ok:
                    yield Finding(
                        self.id, _NATIVE_LIB, p.line,
                        f"`{name}` returns `{sig.ret}` in C ({where}) "
                        f"but restype is `{p.restype}`", self.hint)


#: (C constant in hist_encode.cc, Python constant in store.py)
_CONST_PAIRS = (
    ("PAD_TXNS", "_PAD_TXNS"), ("PAD_MINOR", "_PAD_MINOR"),
    ("HASH_SPAN", "_HASH_SPAN"),
    ("XP1", "_X1"), ("XP2", "_X2"), ("XP3", "_X3"),
    ("XP4", "_X4"), ("XP5", "_X5"),
)

_HIST = _CSRC + "hist_encode.cc"


class SidecarLayoutDrift(ProjectRule):
    id = "JT-ABI-004"
    doc = ("encoded.v1/v2.bin layout drift between hist_encode.cc and "
           "store.py: pad geometry, hash span, xxh64 primes, magic "
           "strings, or the field write order")
    hint = ("the sidecar layout is defined in BOTH writers — change "
            "them together (store.save_encoded/_padded_arrays and "
            "hist_encode.cc write_sidecar)")

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        st = _state(ctx)
        abi = st.native.get(_HIST)
        if abi is None or st.store is None:
            return
        lay = st.store
        for cname, pyname in _CONST_PAIRS:
            cv = abi.constants.get(cname)
            pv = lay.consts.get(pyname)
            if cv is not None and pv is not None and cv != pv[0]:
                yield Finding(
                    self.id, _STORE, pv[1],
                    f"layout constant drift: {pyname}={pv[0]} but "
                    f"{_HIST} {cname}={cv}", self.hint)
        sc = abi.constants.get("SC_NEVER")
        if sc is not None and st.never_completed is not None \
                and sc != st.never_completed:
            yield Finding(
                self.id, _ENCODE, 1,
                f"NEVER_COMPLETED={st.never_completed} but {_HIST} "
                f"SC_NEVER={sc} — effective completion keys diverge "
                "between the writers", self.hint)
        if abi.magics:
            for name in ("ENCODED_MAGIC", "ENCODED_MAGIC_V2"):
                m = lay.magics.get(name)
                if m is not None and m[0] not in abi.magics:
                    yield Finding(
                        self.id, _STORE, m[1],
                        f"{name}={m[0]!r} is not a magic the native "
                        f"writer can produce ({sorted(abi.magics)})",
                        self.hint)
        if abi.sidecar_fields:
            for label, (fields, line) in sorted(
                    lay.field_orders.items()):
                if not _is_subsequence(fields, abi.sidecar_fields):
                    yield Finding(
                        self.id, _STORE, line,
                        f"sidecar field order drift: {label} = "
                        f"{fields} is not written in this order by "
                        f"{_HIST} write_sidecar "
                        f"({abi.sidecar_fields})", self.hint)


RULES = [ExportCoverageDrift(), AbiVersionDrift(), PrototypeDrift(),
         SidecarLayoutDrift()]
