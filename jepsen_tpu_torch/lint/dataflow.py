"""Intraprocedural dataflow for the tensor-contract rules (JT-TENSOR).

The unit of tracking is a *tag*: which declared encoded-tensor field
(contracts.TENSOR_DTYPES) a local expression refers to. Tags seed from
the places a contracted tensor enters a scope — a parameter named
after the field, `enc.appends`, `arrays["reads"]`, a `np.full` built
into a field-named variable — and propagate through assignment chains
and the dtype-preserving wrappers (`asarray`, `ascontiguousarray`,
`astype`, `reshape`, slicing). The rules then ask one question per
call site: "is this expression a contracted tensor, and does the
operation respect its declared dtype/fill/shape?"

Deliberately intraprocedural: a tag never crosses a call boundary.
That keeps the analysis O(module) and false-positive-shy — the
cross-function contracts are pinned by the runtime parity tests; what
static analysis adds is catching the LOCAL slip (a stray `.astype`, a
wrong fill) the moment it is written.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import const_str, dotted
from . import contracts

__all__ = [
    "resolve_dtype", "module_int_consts", "int_value", "build_tags",
    "tag_of", "iter_scopes",
]

_NP_NAMES = {"np", "numpy", "jnp", "onp"}

#: Wrappers through which a tag survives: f(x, ...) tags like x.
_TAG_TRANSPARENT = {"asarray", "ascontiguousarray", "array",
                    "require"}
#: Methods through which a tag survives: x.m(...) tags like x.
_TAG_METHODS = {"astype", "reshape", "copy", "view", "ravel"}


def resolve_dtype(node: ast.AST | None) -> str | None:
    """'int32' for np.int32 / jnp.int32 / "int32" / np.dtype(np.int32);
    None when not statically resolvable."""
    if node is None:
        return None
    s = const_str(node)
    if s is not None:
        return s
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id in _NP_NAMES:
        return node.attr
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        if d and d.split(".")[-1] == "dtype" and node.args:
            return resolve_dtype(node.args[0])
    return None


def module_int_consts(tree: ast.Module) -> dict[str, int]:
    """Module-level `NAME = <int literal or simple arithmetic>`."""
    out: dict[str, int] = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            v = int_value(n.value, {})
            if v is not None:
                out[n.targets[0].id] = v
    return out


def int_value(node: ast.AST, consts: dict[str, int]) -> int | None:
    """A statically-known int: literal, +/- literal, module constant,
    or a product/shift of those."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = int_value(node.operand, consts)
        return -v if v is not None else None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.BinOp) \
            and isinstance(node.op, (ast.Mult, ast.LShift, ast.Add)):
        lt = int_value(node.left, consts)
        rt = int_value(node.right, consts)
        if lt is None or rt is None:
            return None
        if isinstance(node.op, ast.Mult):
            return lt * rt
        if isinstance(node.op, ast.Add):
            return lt + rt
        return lt << rt
    return None


def _field_from_name(name: str) -> str | None:
    return contracts.field_of(name)


def tag_of(node: ast.AST, tags: dict[str, str]) -> str | None:
    """The declared field `node` refers to under the current tag
    environment, looking through the dtype-preserving wrappers."""
    if isinstance(node, ast.Name):
        return tags.get(node.id) or _field_from_name(node.id)
    if isinstance(node, ast.Attribute):
        # enc.appends / self.reads — the attribute name IS the field
        return _field_from_name(node.attr)
    if isinstance(node, ast.Subscript):
        if const_str(node.slice) is not None:
            # arrays["appends"]
            return _field_from_name(const_str(node.slice))
        return tag_of(node.value, tags)   # x[:n] keeps x's tag
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) \
                    and f.value.id in _NP_NAMES \
                    and f.attr in _TAG_TRANSPARENT and node.args:
                return tag_of(node.args[0], tags)
            if f.attr in _TAG_METHODS:
                return tag_of(f.value, tags)
    return None


def build_tags(scope: ast.AST) -> dict[str, str]:
    """name → declared field, for one function (or module) scope.
    Two passes so one level of `y = x` chaining resolves; parameters
    named after a field (or its registered alias) seed the map."""
    tags: dict[str, str] = {}
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = scope.args
        for p in (a.posonlyargs + a.args + a.kwonlyargs):
            f = _field_from_name(p.arg)
            if f:
                tags[p.arg] = f
    for _ in range(2):
        for n in own_nodes(scope):
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
                continue
            t = n.targets[0]
            if not isinstance(t, ast.Name):
                continue
            f = tag_of(n.value, tags)
            if f is None:
                # a field-named target built from an array ctor
                # (np.full/zeros) adopts its own name's contract
                if isinstance(n.value, ast.Call):
                    d = dotted(n.value.func)
                    if d and d.split(".")[0] in _NP_NAMES:
                        f = _field_from_name(t.id)
            if f is not None:
                tags[t.id] = f
            elif t.id in tags and _field_from_name(t.id) is None:
                # rebound to something un-tagged: drop the stale tag
                del tags[t.id]
    return tags


def iter_scopes(tree: ast.Module) -> Iterator[ast.AST]:
    """Each function in the module plus the module itself; pair with
    `own_nodes` so every node is analyzed exactly once, under its
    nearest enclosing scope's tag environment."""
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n
    yield tree


def own_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """The nodes belonging to `scope` itself — the walk stops at
    nested function (and lambda) boundaries: their bodies are their
    own scopes, with their own bindings. The ONE stop-at-nested-defs
    traversal, shared by the tensor and lock rule families."""
    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            yield child
            yield from walk(child)

    yield from walk(scope)
