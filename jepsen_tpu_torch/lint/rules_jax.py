"""JT-JAX — host-sync / recompile hazards in jitted code.

The paper's verdict-parity guarantee (TPU verdicts identical to the
Elle/Knossos CPU checkers) dies silently the moment a host sync or a
shape-driven recompile slips into a jitted path: `.item()` and
`np.asarray` on a traced value force a device→host transfer per call,
and a Python `if` on a tracer either crashes (ConcretizationError) or
— worse — got hoisted to trace time and bakes one branch into the
compiled kernel. These rules police the hazards lexically: inside
`@jax.jit`-decorated functions everywhere, plus module-wide in the
kernel modules (`checker/elle/kernels.py`, `checker/elle/
pallas_square.py`, `checker/knossos/`), and `block_until_ready`
anywhere outside the sanctioned watchdog wrappers (`parallel/`,
`supervisor.py`).
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, const_str, dotted

#: Modules whose ENTIRE body is treated as kernel code for JT-JAX-001.
_KERNEL_MODULES = ("jepsen_tpu_torch/checker/elle/kernels.py",
                   "jepsen_tpu_torch/checker/elle/closure_square.py")
_KERNEL_PREFIXES = ("jepsen_tpu_torch/checker/knossos/",)

#: Modules sanctioned to call block_until_ready (the watchdog wrappers).
_BUR_ALLOWED = ("jepsen_tpu_torch/parallel/", "jepsen_tpu_torch/supervisor.py")

_NP_NAMES = {"np", "numpy", "onp"}
_NP_MATERIALIZERS = {"array", "asarray", "ascontiguousarray",
                     "frombuffer", "copy"}


def _in_kernel_module(rel: str) -> bool:
    return rel.endswith(_KERNEL_MODULES) \
        or any(p in rel for p in _KERNEL_PREFIXES)


def _is_jit_decorator(dec: ast.AST) -> bool:
    d = dotted(dec)
    if d and (d == "jit" or d.endswith(".jit")):
        return True
    if isinstance(dec, ast.Call):
        # functools.partial(jax.jit, static_argnames=...)
        cd = dotted(dec.func)
        if cd and (cd == "partial" or cd.endswith(".partial")):
            if dec.args:
                ad = dotted(dec.args[0])
                return ad is not None and (ad == "jit"
                                           or ad.endswith(".jit"))
        # jax.jit(..., static_argnames=...) used as a decorator factory
        return cd is not None and (cd == "jit" or cd.endswith(".jit"))
    return False


def _static_names(fn: ast.FunctionDef, dec: ast.AST) -> set[str]:
    """Parameter names declared static on the jit decorator — branching
    on those is legitimate (it recompiles, by design)."""
    out: set[str] = set()
    if not isinstance(dec, ast.Call):
        return out
    argnames = [a.arg for a in (fn.args.posonlyargs + fn.args.args)]
    for kw in dec.keywords:
        if kw.arg == "static_argnames":
            v = kw.value
            elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
            for e in elts:
                s = const_str(e)
                if s:
                    out.add(s)
        elif kw.arg == "static_argnums":
            v = kw.value
            elts = v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]
            for e in elts:
                if isinstance(e, ast.Constant) \
                        and isinstance(e.value, int) \
                        and 0 <= e.value < len(argnames):
                    out.add(argnames[e.value])
    return out


def _jit_functions(tree: ast.AST) -> Iterator[tuple[ast.FunctionDef,
                                                    set[str]]]:
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            if _is_jit_decorator(dec):
                yield node, _static_names(node, dec)
                break


def _jits(ctx) -> list:
    """The module's jitted functions, memoized on the ModuleCtx —
    all three JT-JAX rules share one decorator walk per file."""
    cached = getattr(ctx, "_jax_jits", None)
    if cached is None:
        cached = list(_jit_functions(ctx.tree))
        ctx._jax_jits = cached
    return cached


def _traced_params(fn: ast.FunctionDef, static: set[str]) -> set[str]:
    a = fn.args
    names = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    return names - static - {"self", "cls"}


class ItemHostSync(ModuleRule):
    id = "JT-JAX-001"
    doc = (".item() in a jitted function (or anywhere in a kernel "
           "module) — a per-call device->host sync")
    hint = ("keep the value on device (jnp ops / lax.cond), or move "
            "the readback outside the jitted path")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        def items(tree) -> Iterator[ast.Call]:
            for n in ast.walk(tree):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "item" and not n.args:
                    yield n

        if _in_kernel_module(ctx.rel):
            for n in items(ctx.tree):
                yield self.finding(ctx, n,
                                   ".item() host-sync in a kernel module")
            return
        for fn, _static in _jits(ctx):
            for n in items(fn):
                yield self.finding(
                    ctx, n, f".item() inside jitted `{fn.name}`")


class NumpyOnTraced(ModuleRule):
    id = "JT-JAX-002"
    doc = ("np.array/np.asarray (and friends) inside a jitted "
           "function — materializes the tracer on host, forcing a "
           "sync or a ConcretizationError")
    hint = "use jnp.* inside jit; np belongs outside the traced region"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for fn, _static in _jits(ctx):
            for n in ast.walk(fn):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _NP_MATERIALIZERS \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id in _NP_NAMES:
                    yield self.finding(
                        ctx, n,
                        f"np.{n.func.attr}() inside jitted `{fn.name}`")


class BlockUntilReadyOutsideWatchdog(ModuleRule):
    id = "JT-JAX-003"
    doc = ("block_until_ready outside the sanctioned watchdog "
           "wrappers (parallel/, supervisor.py) — an unbounded, "
           "unattributed device wait")
    hint = ("route the wait through parallel's bounded/attributed "
            "wrappers (watchdog + device-window tracing)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if any(a in ctx.rel for a in _BUR_ALLOWED):
            return
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.Call):
                d = dotted(n.func)
                if (isinstance(n.func, ast.Attribute)
                        and n.func.attr == "block_until_ready") \
                        or (d and d.endswith("block_until_ready")):
                    yield self.finding(ctx, n,
                                       "unsanctioned block_until_ready")


# JT-JAX-005 (host copy on the pack/h2d hot path) was SUBSUMED by
# JT-TENSOR-002 in rules_tensor.py, which runs the same hot-path
# scoping through the tensor dataflow pass (and additionally catches
# np.array of a contracted tensor and .tolist() materializations).
# The id is retired, not renumbered — see MIGRATING.md.


class TracerBranch(ModuleRule):
    id = "JT-JAX-004"
    doc = ("Python if/ternary on a traced parameter inside a jitted "
           "function — ConcretizationError at best, a silently "
           "trace-time-frozen branch at worst")
    hint = ("use lax.cond/jnp.where, or declare the argument in "
            "static_argnames if recompiling per value is intended")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for fn, static in _jits(ctx):
            traced = _traced_params(fn, static)
            if not traced:
                continue
            for n in ast.walk(fn):
                if isinstance(n, (ast.If, ast.IfExp)):
                    used = {x.id for x in ast.walk(n.test)
                            if isinstance(x, ast.Name)}
                    hit = sorted(used & traced)
                    if hit:
                        yield self.finding(
                            ctx, n,
                            f"Python branch on traced {', '.join(hit)} "
                            f"inside jitted `{fn.name}`")


RULES = [ItemHostSync(), NumpyOnTraced(),
         BlockUntilReadyOutsideWatchdog(), TracerBranch()]
