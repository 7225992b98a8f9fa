"""JT-SHM — shared-memory lifecycle.

The zero-copy ingest transport's leak discipline: every
`SharedMemory(create=True)` must be lexically paired with an unlink
path in the same function — the happy path unlinks on materialize, the
failure path sweeps via `unlink_stale` — because a created-but-never-
unlinked segment survives the process and fills /dev/shm until the
host starts failing allocations. The check is a dataflow-lite pass
over the enclosing function: a create with no reachable
`.unlink()`/`unlink_stale()` in that function is a finding.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, dotted


def _is_create_call(n: ast.AST) -> bool:
    if not isinstance(n, ast.Call):
        return False
    d = dotted(n.func)
    if not d or d.split(".")[-1] != "SharedMemory":
        return False
    for kw in n.keywords:
        if kw.arg == "create" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _has_unlink(scope: ast.AST) -> bool:
    for n in ast.walk(scope):
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "unlink":
                return True
            d = dotted(n.func)
            if d and d.split(".")[-1] == "unlink_stale":
                return True
    return False


class ShmCreateWithoutUnlink(ModuleRule):
    id = "JT-SHM-001"
    doc = ("SharedMemory(create=True) with no unlink path in the "
           "enclosing function — a leaked segment outlives the "
           "process and fills /dev/shm")
    hint = ("pair the create with unlink (happy path) and "
            "unlink_stale (exception path) in the same function — "
            "see shm.export's contract")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        # attribute each create to its INNERMOST enclosing function
        # (the worker fn is the ownership scope), falling back to the
        # module for top-level creates
        def visit(scope: ast.AST, creates: list[ast.Call]):
            for child in ast.iter_child_nodes(scope):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner: list[ast.Call] = []
                    visit(child, inner)
                    for c in inner:
                        if not _has_unlink(child):
                            found.append(c)
                else:
                    if _is_create_call(child):
                        creates.append(child)   # type: ignore[arg-type]
                    visit(child, creates)

        found: list[ast.Call] = []
        top: list[ast.Call] = []
        visit(ctx.tree, top)
        for c in top:
            if not _has_unlink(ctx.tree):
                found.append(c)
        for c in found:
            yield self.finding(
                ctx, c, "SharedMemory(create=True) without a lexical "
                        "unlink path")


RULES = [ShmCreateWithoutUnlink()]
