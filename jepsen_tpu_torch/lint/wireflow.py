"""JT-WIRE — frame-protocol drift checking for the JTSV wire format.

`serve/protocol.py` declares the frame-kind registry (`FRAME_OPS`):
every `op` either side may put on the wire, its direction, and its
required/optional payload keys. Three parties speak it — the tenant
client, the verdict daemon, and the fleet router that forwards both
directions — and nothing but convention stopped a new frame kind (or
a renamed handler string) from becoming a silently-dropped frame.
These rules prove sender/handler agreement statically, the JT-ABI
discipline applied python↔python:

  * JT-WIRE-001 — an emitted op not declared in FRAME_OPS, a
    declared op its receiving side never handles (c2d → daemon.py,
    d2c → client.py), or a handled op string the registry does not
    declare. The fleet router is EXCLUDED from handler obligations:
    its pump forwards unmatched frames verbatim (that catch-all is
    the router's contract), but its own emissions are still checked.
  * JT-WIRE-002 — an emitted frame literal missing one of its op's
    required keys (retry-after without `queue_depth` is backpressure
    the client cannot obey).
  * JT-WIRE-003 — a duplicated wire constant (the magic bytes or the
    length cap re-spelled outside protocol.py — the constant the
    next refactor forgets to update), or the generated README frame
    table drifting from the registry (`python -m jepsen_tpu_torch.lint --tables`).

Everything is decided on the PARSED registry — the protocol module's
AST via the shared `ProjectCtx.module()` parse, never an import — so
fixture copies of the serve modules check exactly like the live tree
(tests/test_wire_prover.py seeds one drift per rule and pins exactly
the expected finding).

Visibility rules, stated once: a frame is tracked when it is a dict
literal at the send site or a local name built from dict literals
(assign, ``.update({...})``, ``name["k"] = v``); a frame whose base
is opaque (``dict(conn.hello or {})``) contributes its op to the
agreement check but is exempt from required-key proof; a frame whose
op is not a literal is invisible on purpose (the router's forwarded
frames). Emission sites are calls to ``*.send(frame)``,
``send_frame(sock, frame)`` and ``*._submit(frame)``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, ProjectCtx, ProjectRule, dotted
from . import dataflow

__all__ = ["RULES", "WIRE_BEGIN", "WIRE_END",
           "render_wire_table", "render_wire_block"]

_PROTOCOL = "jepsen_tpu_torch/serve/protocol.py"
#: (module rel, handler side it implements: "c2d" means it HANDLES
#: client→daemon ops). The fleet router implements neither side's
#: handler obligations — its pump forwards what it does not consume.
_SPEAKERS = (
    ("jepsen_tpu_torch/serve/client.py", "d2c"),
    ("jepsen_tpu_torch/serve/daemon.py", "c2d"),
    ("jepsen_tpu_torch/serve/fleet.py", None),
)


# ---------------------------------------------------------------------------
# Registry + module scans (shared per ProjectCtx)
# ---------------------------------------------------------------------------

def _const_int(node: ast.AST) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift):
        left = _const_int(node.left)
        right = _const_int(node.right)
        if left is not None and right is not None:
            return left << right
    return None


def _str_tuple(node: ast.AST) -> tuple[str, ...]:
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
    return ()


class _Registry:
    """FRAME_OPS parsed from the protocol module's AST, plus the wire
    constants (magic bytes, frame cap) JT-WIRE-003 guards."""

    def __init__(self, tree: ast.Module):
        self.ops: dict[str, dict] = {}
        self.magic: bytes | None = None
        self.max_frame: int | None = None
        for n in tree.body:
            tgt = None
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                tgt, val = n.targets[0], n.value
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                tgt, val = n.target, n.value
            else:
                continue
            if not isinstance(tgt, ast.Name):
                continue
            if tgt.id == "MAGIC" and isinstance(val, ast.Constant) \
                    and isinstance(val.value, bytes):
                self.magic = val.value
            elif tgt.id == "MAX_FRAME":
                self.max_frame = _const_int(val)
            elif tgt.id == "FRAME_OPS" and isinstance(val, ast.Dict):
                for k, v in zip(val.keys, val.values):
                    if not (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            and isinstance(v, ast.Dict)):
                        continue
                    spec: dict = {"line": k.lineno, "dir": "",
                                  "required": (), "optional": (),
                                  "doc": ""}
                    for fk, fv in zip(v.keys, v.values):
                        if not (isinstance(fk, ast.Constant)
                                and isinstance(fk.value, str)):
                            continue
                        if fk.value in ("dir", "doc") \
                                and isinstance(fv, ast.Constant):
                            spec[fk.value] = fv.value
                        elif fk.value in ("required", "optional"):
                            spec[fk.value] = _str_tuple(fv)
                    self.ops[k.value] = spec


_AMBIG = object()


def _dict_info(d: ast.Dict):
    """(op, keys, open) of a dict literal: `open` when it spreads or
    carries a non-constant key, `op` _AMBIG when the "op" value is
    not a string literal."""
    op = None
    keys: set[str] = set()
    open_ = False
    for k, v in zip(d.keys, d.values):
        if k is None or not (isinstance(k, ast.Constant)
                             and isinstance(k.value, str)):
            open_ = True      # **spread / computed key
            continue
        keys.add(k.value)
        if k.value == "op":
            op = v.value if (isinstance(v, ast.Constant)
                             and isinstance(v.value, str)) else _AMBIG
    return op, keys, open_


def _is_op_fetch(node: ast.AST) -> bool:
    """`X.get("op")` or `X["op"]`."""
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args:
        a = node.args[0]
        return isinstance(a, ast.Constant) and a.value == "op"
    if isinstance(node, ast.Subscript):
        s = node.slice
        return isinstance(s, ast.Constant) and s.value == "op"
    return False


class _ModuleScan:
    """One speaker module: its frame emissions (op, keys or None when
    the base is opaque, line), the op strings its dispatch handles,
    and any re-spelled wire constants."""

    def __init__(self, tree: ast.Module, magic: bytes | None,
                 max_frame: int | None):
        self.emissions: list[tuple[str, frozenset | None, int]] = []
        self.handled: dict[str, int] = {}
        self.alien_consts: list[tuple[str, int]] = []

        scopes = [tree] + [n for n in ast.walk(tree)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        for scope in scopes:
            self._scan_scope(scope)
        for n in ast.walk(tree):
            # handler dispatch: names bound from X.get("op")/X["op"]
            # are collected per module below; constants first
            if isinstance(n, ast.Constant):
                if magic is not None and n.value == magic \
                        and isinstance(n.value, bytes):
                    self.alien_consts.append(("magic bytes", n.lineno))
            elif isinstance(n, ast.BinOp):
                v = _const_int(n)
                if max_frame is not None and v == max_frame:
                    self.alien_consts.append(("frame cap", n.lineno))
        if max_frame is not None:
            for n in ast.walk(tree):
                if isinstance(n, ast.Constant) and not isinstance(
                        n.value, bool) and n.value == max_frame:
                    self.alien_consts.append(("frame cap", n.lineno))
        self._scan_handlers(tree)

    def _scan_scope(self, scope: ast.AST) -> None:
        nodes = list(dataflow.own_nodes(scope))
        frames: dict[str, dict] = {}
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                t = n.targets[0]
                if isinstance(t, ast.Name):
                    ent = frames.setdefault(
                        t.id, {"op": None, "keys": set(),
                               "open": False})
                    if isinstance(n.value, ast.Dict):
                        op, keys, open_ = _dict_info(n.value)
                        if op is not None:
                            ent["op"] = op if ent["op"] in (None, op) \
                                else _AMBIG
                        ent["keys"] |= keys
                        ent["open"] |= open_
                    else:
                        ent["open"] = True
                elif isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and isinstance(t.slice, ast.Constant) \
                        and isinstance(t.slice.value, str):
                    ent = frames.setdefault(
                        t.value.id, {"op": None, "keys": set(),
                                     "open": False})
                    ent["keys"].add(t.slice.value)
                    if t.slice.value == "op":
                        v = n.value
                        op = v.value if (isinstance(v, ast.Constant)
                                         and isinstance(v.value, str)) \
                            else _AMBIG
                        ent["op"] = op if ent["op"] in (None, op) \
                            else _AMBIG
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "update" \
                    and isinstance(n.func.value, ast.Name) \
                    and n.args and isinstance(n.args[0], ast.Dict):
                ent = frames.setdefault(
                    n.func.value.id, {"op": None, "keys": set(),
                                      "open": False})
                op, keys, open_ = _dict_info(n.args[0])
                if op is not None:
                    ent["op"] = op if ent["op"] in (None, op) \
                        else _AMBIG
                ent["keys"] |= keys
                ent["open"] |= open_
        for n in nodes:
            if not isinstance(n, ast.Call):
                continue
            d = dotted(n.func)
            if d is None:
                continue
            if d == "send_frame" or d.endswith(".send_frame"):
                arg = n.args[1] if len(n.args) > 1 else None
            elif d.endswith(".send") or d.endswith("._submit"):
                arg = n.args[0] if n.args else None
            else:
                continue
            if isinstance(arg, ast.Dict):
                op, keys, open_ = _dict_info(arg)
            elif isinstance(arg, ast.Name) and arg.id in frames:
                ent = frames[arg.id]
                op, keys, open_ = ent["op"], ent["keys"], ent["open"]
            else:
                continue   # opaque frame (forwarded/param) — invisible
            if not isinstance(op, str):
                continue   # no literal op — invisible on purpose
            self.emissions.append(
                (op, None if open_ else frozenset(keys), n.lineno))

    def _scan_handlers(self, tree: ast.Module) -> None:
        op_names = {n.targets[0].id for n in ast.walk(tree)
                    if isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and _is_op_fetch(n.value)}
        for n in ast.walk(tree):
            if not isinstance(n, ast.Compare):
                continue
            left_is_op = (isinstance(n.left, ast.Name)
                          and n.left.id in op_names) \
                or _is_op_fetch(n.left)
            if not left_is_op:
                continue
            if not all(isinstance(o, (ast.Eq, ast.NotEq, ast.In,
                                      ast.NotIn)) for o in n.ops):
                continue
            for comp in n.comparators:
                if isinstance(comp, ast.Constant) \
                        and isinstance(comp.value, str):
                    self.handled.setdefault(comp.value, n.lineno)
                elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                    for e in comp.elts:
                        if isinstance(e, ast.Constant) \
                                and isinstance(e.value, str):
                            self.handled.setdefault(e.value, n.lineno)


class _WireState:
    """The whole-protocol view, built once per ProjectCtx run from
    the shared parses and consumed by all three rules."""

    def __init__(self, ctx: ProjectCtx):
        self.protocol_rel = _PROTOCOL
        proto = ctx.module(_PROTOCOL)
        self.present = proto is not None
        self.registry = _Registry(proto.tree) if proto else None
        self.scans: dict[str, _ModuleScan] = {}
        self.sides: dict[str, str | None] = {}
        if self.registry is None:
            return
        for rel, side in _SPEAKERS:
            m = ctx.module(rel)
            if m is None:
                continue    # degraded tree (fixtures) — skip
            self.scans[rel] = _ModuleScan(m.tree, self.registry.magic,
                                          self.registry.max_frame)
            self.sides[rel] = side


def _state(ctx: ProjectCtx) -> _WireState:
    st = getattr(ctx, "_wire_state", None)
    if st is None:
        st = _WireState(ctx)
        ctx._wire_state = st
    return st


# ---------------------------------------------------------------------------
# README frame table
# ---------------------------------------------------------------------------

WIRE_BEGIN = ("<!-- wire-frames:begin "
              "(generated by jepsen_tpu_torch.lint.wireflow) -->")
WIRE_END = "<!-- wire-frames:end (jepsen_tpu_torch.lint.wireflow) -->"

_DIRS = {"c2d": "client → daemon", "d2c": "daemon → client"}


def render_wire_table(registry: _Registry) -> str:
    rows = ["| op | direction | required | optional | notes |",
            "|---|---|---|---|---|"]
    for op, spec in registry.ops.items():
        req = ", ".join(f"`{k}`" for k in spec["required"]) or "—"
        opt = ", ".join(f"`{k}`" for k in spec["optional"]) or "—"
        rows.append(f"| `{op}` | {_DIRS.get(spec['dir'], spec['dir'])}"
                    f" | {req} | {opt} | {spec['doc']} |")
    return "\n".join(rows)


def render_wire_block(registry: _Registry) -> str:
    return f"{WIRE_BEGIN}\n{render_wire_table(registry)}\n{WIRE_END}"


def live_registry(root) -> "_Registry | None":
    """The registry parsed from `root`'s protocol module — the
    `python -m jepsen_tpu_torch.lint --tables` entry point (one renderer, fed the same way
    the drift check feeds itself)."""
    p = root / _PROTOCOL
    if not p.is_file():
        return None
    return _Registry(ast.parse(p.read_text(encoding="utf-8"),
                               filename=str(p)))


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

class FrameAgreement(ProjectRule):
    id = "JT-WIRE-001"
    doc = ("sender/handler agreement with the FRAME_OPS registry: an "
           "emitted op the registry does not declare, a declared op "
           "its receiving side (daemon for c2d, client for d2c) "
           "never handles — a silently-dropped frame — or a handled "
           "op string the registry does not declare")
    hint = ("declare the op (direction, required/optional keys) in "
            "serve/protocol.py FRAME_OPS and handle it on the "
            "receiving side; run `python -m jepsen_tpu_torch.lint --tables` after")

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        st = _state(ctx)
        if not st.present:
            return
        reg = st.registry
        if not reg.ops:
            yield Finding(self.id, st.protocol_rel, 1,
                          "FRAME_OPS registry missing or empty — the "
                          "wire protocol has no source of truth to "
                          "prove senders/handlers against", self.hint)
            return
        handled_by_side: dict[str, dict[str, int]] = {}
        for rel, scan in st.scans.items():
            side = st.sides.get(rel)
            if side is not None:
                handled_by_side[side] = scan.handled
            for op, _keys, line in scan.emissions:
                if op not in reg.ops:
                    yield Finding(
                        self.id, rel, line,
                        f"emits op {op!r} not declared in FRAME_OPS",
                        self.hint)
            for op, line in scan.handled.items():
                if op not in reg.ops:
                    yield Finding(
                        self.id, rel, line,
                        f"handles op {op!r} not declared in "
                        f"FRAME_OPS — dead dispatch or registry "
                        f"drift", self.hint)
        for op, spec in reg.ops.items():
            side = spec["dir"]
            if side not in handled_by_side:
                continue   # degraded tree without the handler module
            if op not in handled_by_side[side]:
                who = "daemon.py" if side == "c2d" else "client.py"
                yield Finding(
                    self.id, st.protocol_rel, spec["line"],
                    f"declared op {op!r} ({_DIRS.get(side, side)}) "
                    f"is never handled by {who} — a frame the "
                    f"receiver silently drops", self.hint)


class RequiredFrameFields(ProjectRule):
    id = "JT-WIRE-002"
    doc = ("an emitted frame literal missing one of its op's "
           "required keys — backpressure without queue_depth, a "
           "verdict without its result — caught at the send site")
    hint = ("carry every FRAME_OPS required key on the frame literal "
            "(or update the registry if the contract changed)")

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        st = _state(ctx)
        if not st.present or not st.registry.ops:
            return
        for rel, scan in st.scans.items():
            for op, keys, line in scan.emissions:
                spec = st.registry.ops.get(op)
                if spec is None or keys is None:
                    continue   # WIRE-001's problem / opaque base
                missing = [k for k in spec["required"]
                           if k not in keys]
                if missing:
                    yield Finding(
                        self.id, rel, line,
                        f"{op!r} frame missing required "
                        f"key(s) {missing} (FRAME_OPS requires "
                        f"{list(spec['required'])})", self.hint)


class WireConstantDrift(ProjectRule):
    id = "JT-WIRE-003"
    doc = ("a wire constant re-spelled outside protocol.py (the "
           "magic bytes or the frame cap duplicated where the next "
           "protocol change forgets it), or the generated README "
           "frame table drifting from the registry")
    hint = ("import MAGIC/MAX_FRAME from serve/protocol.py instead "
            "of re-spelling them; regenerate the README table with "
            "`python -m jepsen_tpu_torch.lint --tables`")

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        st = _state(ctx)
        if not st.present or st.registry is None:
            return
        for rel, scan in st.scans.items():
            for what, line in scan.alien_consts:
                yield Finding(
                    self.id, rel, line,
                    f"wire {what} re-spelled outside protocol.py — "
                    f"a duplicated constant the next protocol bump "
                    f"will miss", self.hint)
        readme = ctx.root / "README.md"
        if not readme.is_file() or not st.registry.ops:
            return   # installed-package / fixture context
        text = readme.read_text(encoding="utf-8")
        if WIRE_BEGIN not in text or WIRE_END not in text:
            yield Finding(
                self.id, "README.md", 1,
                "missing the generated wire-frame table markers — "
                "add them and run `python -m jepsen_tpu_torch.lint --tables`", self.hint)
            return
        start = text.index(WIRE_BEGIN)
        end = text.index(WIRE_END) + len(WIRE_END)
        if text[start:end] != render_wire_block(st.registry):
            line = text[:start].count("\n") + 1
            yield Finding(
                self.id, "README.md", line,
                "wire-frame table drifted from serve/protocol.py "
                "FRAME_OPS — run `python -m jepsen_tpu_torch.lint --tables`", self.hint)


RULES = [FrameAgreement(), RequiredFrameFields(), WireConstantDrift()]
