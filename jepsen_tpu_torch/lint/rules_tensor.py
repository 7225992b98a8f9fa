"""JT-TENSOR — tensor-contract dataflow over the encode→pack→dispatch
path.

The CPU/TPU verdict-parity guarantee rides on a handful of tensor
contracts nothing used to check statically: the encoded arrays'
dtypes (int32 triples/status/process, int64 lean indexes, int32
`d_invoke`/`d_complete` device tensors), pack_batch's fill convention
(-1 dead triples/process, 0 dead index rows), the bucket pad geometry
(txn axis 128, minor axes 8 — `dispatch_pad_plan` == BatchShape.plan
== hist_encode.cc's pad_up), and the donated-arg positions of a
single-device dispatch. Each lives in `lint/contracts.py` ONCE; these
rules run the `dataflow` tag analysis over the files that build or
consume the tensors and flag any operation that disagrees with the
registry.

  JT-TENSOR-001  undeclared dtype cast of a contracted tensor
  JT-TENSOR-002  host materialization on the pack/h2d hot path
                 (subsumes and strengthens the retired JT-JAX-005)
  JT-TENSOR-003  fill-convention / pad-geometry / triple-shape drift
  JT-TENSOR-004  donate_argnums drift from the declared positions
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, dotted
from . import contracts, dataflow

_NP_NAMES = {"np", "numpy", "jnp", "onp"}
#: Host-side numpy spellings only — `jnp.pad` is the ON-DEVICE pad the
#: warm path uses on purpose; flagging it would invert the contract.
_HOST_NP_NAMES = {"np", "numpy", "onp"}

#: Array constructors with (shape, fill?, dtype?) worth checking.
_CTORS_FILL = {"full": (1, 2), "zeros": (None, 1), "ones": (None, 1),
               "empty": (None, 1)}
_CTOR_IMPLICIT_FILL = {"zeros": 0, "ones": 1}

_COPY_FNS = {"copy", "ascontiguousarray", "pad", "array"}
_PAD_FN_NAMES = {"pad_to", "_pad_up", "pad_up"}


def _np_call(n: ast.AST) -> str | None:
    """'full' for np.full(...) / jnp.full(...), else None."""
    if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
            and isinstance(n.func.value, ast.Name) \
            and n.func.value.id in _NP_NAMES:
        return n.func.attr
    return None


def _kw(call: ast.Call, name: str) -> ast.AST | None:
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _dtype_arg(call: ast.Call, pos: int | None) -> ast.AST | None:
    v = _kw(call, "dtype")
    if v is not None:
        return v
    if pos is not None and len(call.args) > pos:
        return call.args[pos]
    return None


def _dataflow_scopes(ctx: ModuleCtx):
    """Where the dataflow rules look: every scope of a declared
    tensor file, or — anywhere else — just the hot-path-named
    functions (pack_*/_h2d/...), which is also what makes the rules
    fixture-testable outside the package tree."""
    if contracts.is_tensor_file(ctx.rel):
        yield from dataflow.iter_scopes(ctx.tree)
        return
    for fn in ast.walk(ctx.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and any(fn.name.startswith(p)
                        for p in contracts.HOT_FN_PREFIXES):
            yield fn


def _scoped(ctx: ModuleCtx) -> list:
    """(scope, tags, own-nodes) per dataflow scope, memoized on the
    ModuleCtx — the tensor rules share one tag build and one
    stop-at-nested-defs walk per scope instead of redoing both per
    rule."""
    cached = getattr(ctx, "_tensor_scopes", None)
    if cached is None:
        cached = [(sc, dataflow.build_tags(sc),
                   list(dataflow.own_nodes(sc)))
                  for sc in _dataflow_scopes(ctx)]
        ctx._tensor_scopes = cached
    return cached


def _target_field(t: ast.AST) -> str | None:
    """The contracted field an assignment target names: `appends = …`,
    `d_invoke[:n] = …`, `out["reads"] = …`."""
    if isinstance(t, ast.Name):
        return contracts.field_of(t.id)
    if isinstance(t, ast.Subscript):
        from . import const_str
        ks = const_str(t.slice)
        if ks is not None:
            return contracts.field_of(ks)
        if isinstance(t.value, ast.Name):
            return contracts.field_of(t.value.id)
    return None


class UndeclaredCast(ModuleRule):
    id = "JT-TENSOR-001"
    doc = ("a dtype cast of a contracted encoded tensor that the "
           "contracts registry does not declare — the device kernels "
           "consume these dtypes verbatim, so a stray cast silently "
           "forks the TPU verdict from the CPU checkers")
    hint = ("keep the declared dtype (lint/contracts.TENSOR_DTYPES), "
            "or register the narrowing in DECLARED_NARROWINGS if both "
            "writers perform it")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for scope, tags, nodes in _scoped(ctx):
            for n in nodes:
                if not isinstance(n, ast.Call):
                    continue
                src = dt = None
                f = n.func
                if isinstance(f, ast.Attribute) and f.attr == "astype" \
                        and n.args:
                    src = dataflow.tag_of(f.value, tags)
                    dt = dataflow.resolve_dtype(n.args[0])
                else:
                    name = _np_call(n)
                    if name in ("asarray", "array",
                                "ascontiguousarray") and n.args:
                        src = dataflow.tag_of(n.args[0], tags)
                        dt = dataflow.resolve_dtype(
                            _dtype_arg(n, 1))
                if src is None or dt is None:
                    continue
                want = contracts.TENSOR_DTYPES[src]
                if dt != want and (src, dt) not in \
                        contracts.DECLARED_NARROWINGS:
                    yield self.finding(
                        ctx, n,
                        f"undeclared cast of `{src}` "
                        f"({want} by contract) to {dt}")


class HostMaterialization(ModuleRule):
    id = "JT-TENSOR-002"
    doc = ("np.copy/ascontiguousarray/pad/array or .tolist() on the "
           "pack/h2d hot path — a host-side materialization between "
           "the store mmap and device_put, exactly what the "
           "dispatch-shaped sidecars exist to remove (subsumes "
           "JT-JAX-005)")
    hint = ("feed device_put the mmap/shm view directly (v2 sidecar "
            "dispatch views), or justify the copy inline with "
            "`# jt-lint: ok JT-TENSOR-002 (reason)`")

    def _hot_scopes(self, ctx: ModuleCtx) -> Iterator[ast.AST]:
        """Per-FUNCTION scopes (so build_tags sees each scope's local
        bindings — a whole-module scope would leave the tag map empty
        exactly in the hot files this rule targets): every scope of a
        hot-path file, or the hot-named functions (plus their nested
        defs) anywhere else."""
        if contracts.is_hot_path_file(ctx.rel):
            yield from dataflow.iter_scopes(ctx.tree)
            return
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(fn.name.startswith(p)
                            for p in contracts.HOT_FN_PREFIXES):
                for n in ast.walk(fn):
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        yield n

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        seen: set[int] = set()
        for scope in self._hot_scopes(ctx):
            tags = dataflow.build_tags(scope)
            for n in dataflow.own_nodes(scope):
                if not isinstance(n, ast.Call) or id(n) in seen:
                    continue
                name = _np_call(n)
                if name in _COPY_FNS \
                        and n.func.value.id in _HOST_NP_NAMES:
                    if name == "array" and not (
                            n.args and dataflow.tag_of(n.args[0],
                                                       tags)):
                        # np.array on small host metadata is fine —
                        # only a contracted tensor is a copy that
                        # matters at bucket scale
                        continue
                    seen.add(id(n))
                    yield self.finding(
                        ctx, n,
                        f"np.{name}() host copy on the pack/h2d "
                        "hot path")
                elif isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "tolist" \
                        and dataflow.tag_of(n.func.value, tags):
                    seen.add(id(n))
                    yield self.finding(
                        ctx, n,
                        "contracted tensor .tolist() on the pack/h2d "
                        "hot path — a full host materialization")


class FillAndGeometryDrift(ModuleRule):
    id = "JT-TENSOR-003"
    doc = ("a contracted tensor built with the wrong fill or dtype, a "
           "pad call with an undeclared multiple, or a triple field "
           "reshaped off its [N,3] layout — the kernels' dead-row "
           "masking and the MXU tile geometry both assume the "
           "registry's values")
    hint = ("fill convention: -1 for triples/process, 0 for index "
            "rows; pad multiples: 128 (txns) / 8 (minor) — see "
            "lint/contracts.py")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        consts = dataflow.module_int_consts(ctx.tree)
        for scope, tags, nodes in _scoped(ctx):
            for n in nodes:
                # pad_to(x, M) / _pad_up(x, M) with an undeclared M
                if isinstance(n, ast.Call):
                    d = dotted(n.func)
                    tail = d.split(".")[-1] if d else ""
                    if tail in _PAD_FN_NAMES and len(n.args) >= 2:
                        m = dataflow.int_value(n.args[1], consts)
                        if m is not None and \
                                m not in contracts.PAD_MULTIPLES:
                            yield self.finding(
                                ctx, n,
                                f"pad multiple {m} is not a declared "
                                f"bucket geometry "
                                f"({sorted(contracts.PAD_MULTIPLES)})")
                    # x.reshape(..., k) off the triple layout
                    if isinstance(n.func, ast.Attribute) \
                            and n.func.attr == "reshape":
                        src = dataflow.tag_of(n.func.value, tags)
                        if src in contracts.TRIPLE_FIELDS:
                            elts = n.args[0].elts \
                                if len(n.args) == 1 and isinstance(
                                    n.args[0], ast.Tuple) else n.args
                            last = dataflow.int_value(elts[-1],
                                                      consts) \
                                if elts else None
                            if last is not None and last != 3:
                                yield self.finding(
                                    ctx, n,
                                    f"`{src}` reshaped with minor "
                                    f"axis {last} (triple fields are "
                                    "[N,3])")
                # field = np.full/zeros/ones(...): dtype + fill
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.value, ast.Call):
                    field = _target_field(n.targets[0])
                    ctor = _np_call(n.value)
                    if field is None or ctor not in _CTORS_FILL:
                        continue
                    fill_pos, dt_pos = _CTORS_FILL[ctor]
                    dt = dataflow.resolve_dtype(
                        _dtype_arg(n.value, dt_pos))
                    want_dt = contracts.TENSOR_DTYPES[field]
                    if dt is not None and dt != want_dt and \
                            (field, dt) not in \
                            contracts.DECLARED_NARROWINGS:
                        yield self.finding(
                            ctx, n.value,
                            f"`{field}` built as {dt} "
                            f"(contract: {want_dt})")
                    fill = _CTOR_IMPLICIT_FILL.get(ctor)
                    if fill_pos is not None:
                        fv = _kw(n.value, "fill_value")
                        if fv is None and \
                                len(n.value.args) > fill_pos:
                            fv = n.value.args[fill_pos]
                        fill = dataflow.int_value(fv, consts) \
                            if fv is not None else None
                    want_fill = contracts.FILL_VALUES.get(field)
                    if fill is not None and want_fill is not None \
                            and fill != want_fill:
                        yield self.finding(
                            ctx, n.value,
                            f"`{field}` filled with {fill} (pack "
                            f"convention: {want_fill})")


class DonateArgnumsDrift(ModuleRule):
    id = "JT-TENSOR-004"
    doc = ("donate_argnums differs from the declared donated-arg "
           "positions (the six packed input tensors) — donating the "
           "wrong buffer hands XLA memory the host still reads")
    hint = (f"donate exactly positions "
            f"{contracts.DONATE_ARGNUMS} (tuple(range(6)))")

    def _positions(self, v: ast.AST) -> tuple[int, ...] | None:
        if isinstance(v, (ast.Tuple, ast.List)):
            out = []
            for e in v.elts:
                i = dataflow.int_value(e, {})
                if i is None:
                    return None
                out.append(i)
            return tuple(out)
        if isinstance(v, ast.Constant) and isinstance(v.value, int):
            return (v.value,)
        if isinstance(v, ast.Call):
            d = dotted(v.func)
            if d and d.split(".")[-1] == "tuple" and v.args \
                    and isinstance(v.args[0], ast.Call):
                r = v.args[0]
                rd = dotted(r.func)
                if rd and rd.split(".")[-1] == "range" \
                        and len(r.args) == 1:
                    nmax = dataflow.int_value(r.args[0], {})
                    if nmax is not None:
                        return tuple(range(nmax))
        return None

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            v = _kw(n, "donate_argnums")
            if v is None:
                continue
            pos = self._positions(v)
            if pos is not None and pos != contracts.DONATE_ARGNUMS:
                yield self.finding(
                    ctx, n,
                    f"donate_argnums={pos} drifts from the declared "
                    f"positions {contracts.DONATE_ARGNUMS}")


RULES = [UndeclaredCast(), HostMaterialization(),
         FillAndGeometryDrift(), DonateArgnumsDrift()]
