"""Interprocedural file-effect analysis for the JT-DUR rules.

The unit of tracking is a *store-rooted path*: an expression that
names a file at the store root (or the compile-cache root) — a
``<base> / <literal>`` join, a call to a registered path-constructor
helper (``costdb_path``, ``shard_journal_path``, …), or a local alias
of either. Each resolves to a file-name *skeleton* (interpolated
segments become ``*``) that `contracts.artifact_for_name` maps to a
declared `StoreArtifact` — or to None, which IS the JT-DUR-001
finding.

On top of the path lattice the pass collects the module's *file
effects*, per scope:

  * write effects — ``open(p, "w"/"a"/…)``, ``p.write_text``/
    ``write_bytes`` (``os.replace`` and ``atomic_write_text`` are the
    SANCTIONED publishes and deliberately not effects);
  * read effects — ``p.read_text()``, ``open(p)``;
  * append-handle histories — for every handle opened in append mode
    (``f = open(p, "a")``, ``with open(p, "a") as f``,
    ``self._f = open(…)``), the lexical sequence of its ``write``/
    ``flush``/``close`` calls, which JT-DUR-003 checks against the
    journal discipline (one write per record, flushed before the
    handle can be observed).

Interprocedural on two edges, intraprocedural otherwise (the
`dataflow.py` philosophy — catch the local slip the moment it is
written): calls to registry-declared path helpers resolve to their
artifact anywhere in the repo, and a module-local function whose
`return` is a store-rooted join registers itself as a helper for the
rest of its module. A path that crosses any OTHER call boundary is
out of lexical reach; the crash-sim tests own that residue.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from . import const_str, dotted
from . import contracts
from .dataflow import iter_scopes, own_nodes

__all__ = ["analyze", "ModuleFlow", "ScopeFlow"]

ROOT_STORE = "store"
ROOT_CACHE = "cache"

#: Parameter/variable spellings that ARE a store base. Kept
#: deliberately narrow: `store_base` and `spool_dir` are the
#: package-wide conventions (`store.base`/`self.base` as dotted
#: chains below); a run-dir path (`d`, `run_dir`) never qualifies —
#: the registry governs the store ROOT namespace, run dirs are the
#: run's own.
BASE_NAMES = frozenset({"store_base", "spool_dir"})
BASE_DOTTED = frozenset({"store.base", "self.base"})

#: Calls whose result is the compile-cache root.
CACHE_FNS = frozenset({"cache_dir"})


def module_str_consts(tree: ast.Module) -> dict[str, str]:
    """Module-level `NAME = "literal"` string constants (EVENTS_NAME,
    COSTDB_NAME, SPOOL_PREFIX …) — f-string skeletons resolve through
    these. Imported constants stay opaque (their join is skipped, not
    guessed)."""
    out: dict[str, str] = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            s = const_str(n.value)
            if s is not None:
                out[n.targets[0].id] = s
    return out


def _tail_str(node: ast.AST, consts: dict[str, str]) -> str | None:
    """The file-name skeleton of a join's right operand: a literal, a
    module constant, or an f-string whose interpolations become `*`
    (constants referenced inside resolve through `consts`). A skeleton
    with no leading literal (`*…`) is unresolvable — better to skip a
    fully-dynamic name than to misattribute it."""
    s = const_str(node)
    if s is None and isinstance(node, ast.Name):
        s = consts.get(node.id)
    if s is None and isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            c = const_str(v)
            if c is None and isinstance(v, ast.FormattedValue) \
                    and isinstance(v.value, ast.Name):
                c = consts.get(v.value.id)
            parts.append(c if c is not None else "*")
        s = "".join(parts)
    if s is None or not s or s.startswith("*"):
        return None
    return s


@dataclass
class ScopeFlow:
    """One function's (or the module body's) file effects."""

    qualname: str
    #: every resolved `<base>/<literal>` join: (node, tail, root)
    joins: list[tuple[ast.AST, str, str]] = field(default_factory=list)
    #: open() calls: (node, tail|None, mode)
    opens: list[tuple[ast.Call, str | None, str]] \
        = field(default_factory=list)
    #: write_text/write_bytes on a resolved path: (node, tail)
    write_texts: list[tuple[ast.Call, str]] = field(default_factory=list)
    #: read_text on a resolved path: (node, tail)
    read_texts: list[tuple[ast.Call, str]] = field(default_factory=list)
    #: append-mode handles: spelling -> [(line, kind, node, is_nl)]
    #: where kind in write|flush|close and is_nl marks write("\n")
    handles: dict[str, list[tuple[int, str, ast.AST, bool]]] \
        = field(default_factory=dict)
    has_json_loads: bool = False


@dataclass
class ModuleFlow:
    scopes: list[ScopeFlow] = field(default_factory=list)


def _qualnames(tree: ast.Module) -> dict[int, str]:
    """node id -> qualname, from the ONE def walk the lockset engine
    already owns (cfg.iter_defs) — two traversals with their own
    prefixing rules would drift, and the JT-DUR-004 sanctioned-reader
    exemption keys on these strings."""
    from .cfg import iter_defs
    return {id(n): q for q, _cls, n in iter_defs(tree)}


def _call_tail_name(node: ast.Call) -> str | None:
    d = dotted(node.func)
    return d.split(".")[-1] if d else None


def _is_base(node: ast.AST, base_vars: dict[str, str]) -> str | None:
    """ROOT_STORE/ROOT_CACHE when `node` is a store/cache root
    expression, else None. `Path(<base>)` is transparent."""
    if isinstance(node, ast.Name):
        if node.id in BASE_NAMES:
            return ROOT_STORE
        return base_vars.get(node.id)
    d = dotted(node)
    if d in BASE_DOTTED:
        return ROOT_STORE
    if isinstance(node, ast.Call):
        tn = _call_tail_name(node)
        if tn == "Path" and len(node.args) == 1 and not node.keywords:
            return _is_base(node.args[0], base_vars)
        if tn in CACHE_FNS:
            return ROOT_CACHE
    return None


class _Scope:
    """Per-scope resolution state built by `analyze`."""

    def __init__(self, consts: dict[str, str],
                 helpers: dict[str, tuple[str, str]]):
        self.consts = consts
        self.helpers = helpers
        self.base_vars: dict[str, str] = {}       # name -> root kind
        self.path_vars: dict[str, tuple[str, str]] = {}  # -> (tail, root)

    def resolve(self, node: ast.AST) -> tuple[str, str] | None:
        """(tail skeleton, root) for a store/cache-rooted path expr."""
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            root = _is_base(node.left, self.base_vars)
            if root is None:
                return None
            tail = _tail_str(node.right, self.consts)
            if tail is None:
                return None
            return tail, root
        if isinstance(node, ast.Call):
            tn = _call_tail_name(node)
            if tn is not None and tn in self.helpers:
                return self.helpers[tn]
        if isinstance(node, ast.Name):
            return self.path_vars.get(node.id)
        if isinstance(node, ast.Attribute):
            d = dotted(node)
            if d is not None:
                return self.path_vars.get(d)
        return None


def _open_call(node: ast.AST) -> ast.Call | None:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id == "open":
        return node
    return None


def _open_mode(call: ast.Call) -> str | None:
    """The literal mode of an open() call ('r' when omitted), None
    when dynamic."""
    node = call.args[1] if len(call.args) > 1 else None
    if node is None:
        for kw in call.keywords:
            if kw.arg == "mode":
                node = kw.value
    if node is None:
        return "r"
    return const_str(node)


def _registry_helpers() -> dict[str, tuple[str, str]]:
    return {name: (a.patterns[0], a.root)
            for name, a in contracts.PATH_HELPERS.items()}


def _local_helpers(tree: ast.Module, consts: dict[str, str],
                   helpers: dict[str, tuple[str, str]]) -> None:
    """Module-local interprocedural edge: a function whose `return`
    is a store-rooted join acts as a path helper for the rest of its
    module. Registry-declared helpers win on a name collision (their
    patterns are the stable contract)."""
    empty = _Scope(consts, helpers)
    for n in ast.walk(tree):
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or n.name in helpers:
            continue
        for stmt in own_nodes(n):
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                r = empty.resolve(stmt.value)
                if r is not None:
                    helpers[n.name] = r
                    break


def analyze(ctx) -> ModuleFlow:
    """The module's file effects, memoized on the ModuleCtx (all four
    JT-DUR module rules share one pass)."""
    cached = getattr(ctx, "_fileflow", None)
    if cached is not None:
        return cached
    tree = ctx.tree
    consts = module_str_consts(tree)
    helpers = _registry_helpers()
    _local_helpers(tree, consts, helpers)
    quals = _qualnames(tree)
    flow = ModuleFlow()
    for scope in iter_scopes(tree):
        sc = _Scope(consts, helpers)
        out = ScopeFlow(qualname=quals.get(id(scope), ""))
        # two passes so `base = Path(store_base)` then
        # `p = base / NAME` then `open(p, …)` all chain
        for _ in range(2):
            for n in own_nodes(scope):
                if not (isinstance(n, ast.Assign)
                        and len(n.targets) == 1):
                    continue
                t = n.targets[0]
                key = t.id if isinstance(t, ast.Name) else dotted(t)
                if key is None:
                    continue
                root = _is_base(n.value, sc.base_vars)
                if root is not None:
                    sc.base_vars[key] = root
                    continue
                r = sc.resolve(n.value)
                if r is not None:
                    sc.path_vars[key] = r
        for n in own_nodes(scope):
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div):
                r = sc.resolve(n)
                if r is not None:
                    out.joins.append((n, r[0], r[1]))
            elif isinstance(n, ast.Call):
                oc = _open_call(n)
                if oc is not None and n.args:
                    r = sc.resolve(n.args[0])
                    out.opens.append(
                        (n, r[0] if r else None, _open_mode(n) or ""))
                elif isinstance(n.func, ast.Attribute):
                    at = n.func.attr
                    if at in ("write_text", "write_bytes"):
                        r = sc.resolve(n.func.value)
                        if r is not None:
                            out.write_texts.append((n, r[0]))
                    elif at == "read_text":
                        r = sc.resolve(n.func.value)
                        if r is not None:
                            out.read_texts.append((n, r[0]))
                if dotted(n.func) == "json.loads" \
                        or (isinstance(n.func, ast.Name)
                            and n.func.id == "loads"):
                    out.has_json_loads = True
        _track_handles(scope, out)
        flow.scopes.append(out)
    ctx._fileflow = flow
    return flow


def _track_handles(scope: ast.AST, out: ScopeFlow) -> None:
    """Append-mode handle histories for JT-DUR-003: bind handles from
    `with open(p, "a") as f` / `f = open(p, "a")` / `self._f = open`,
    then record each handle's write/flush/close calls in lexical
    order. EVERY open() binding is collected — append or not — so a
    later rebinding of the same name to a non-append handle ends the
    append handle's region instead of donating its writes to it (a
    `with open(p, "a") as f: ...` followed by `with open(q, "w") as
    f: ...` in one function must not misattribute the second f's
    writes)."""
    bindings: list[tuple[int, str, bool]] = []
    for n in own_nodes(scope):
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                c = _open_call(item.context_expr)
                if c is not None and item.optional_vars is not None \
                        and isinstance(item.optional_vars, ast.Name):
                    mode = _open_mode(c)
                    bindings.append(
                        (n.lineno, item.optional_vars.id,
                         mode is not None and "a" in mode))
        elif isinstance(n, ast.Assign) and len(n.targets) == 1:
            c = _open_call(n.value)
            if c is not None:
                t = n.targets[0]
                key = t.id if isinstance(t, ast.Name) else dotted(t)
                if key is not None:
                    mode = _open_mode(c)
                    bindings.append(
                        (n.lineno, key,
                         mode is not None and "a" in mode))
    append_keys = {k for _ln, k, ap in bindings if ap}
    if not append_keys:
        return
    bindings.sort()

    def owned_by_append(key: str, line: int) -> bool:
        """Does the latest binding of `key` at or before `line` hold
        an append handle? Events before any binding stay unowned."""
        owner = None
        for bl, bk, ap in bindings:
            if bk == key and bl <= line:
                owner = ap
        return owner is True

    for n in own_nodes(scope):
        if not (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)):
            continue
        recv = dotted(n.func.value)
        if recv not in append_keys \
                or not owned_by_append(recv, n.lineno):
            continue
        at = n.func.attr
        if at in ("write", "writelines"):
            is_nl = bool(n.args) and const_str(n.args[0]) == "\n"
            out.handles.setdefault(recv, []).append(
                (n.lineno, "write", n, is_nl))
        elif at in ("flush", "close"):
            out.handles.setdefault(recv, []).append(
                (n.lineno, at, n, False))
    for evs in out.handles.values():
        evs.sort(key=lambda e: e[0])
