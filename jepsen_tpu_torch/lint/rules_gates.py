"""JT-GATE — the env-gate registry family.

Every `JEPSEN_TPU_*` env var must be declared once in
`jepsen_tpu_torch.gates` and read only through its typed accessors; the
README env-gate table is rendered from the registry and must not
drift; every registered gate must appear in test coverage. This is
the rule family that turns 21 ad-hoc `os.environ` reads into one
audited surface.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from . import (Finding, ModuleCtx, ModuleRule, ProjectCtx, ProjectRule,
               const_str, dotted)

#: The one file where raw environ access to gate names is sanctioned.
_GATES_FILE = "jepsen_tpu_torch/gates.py"

_ACCESSORS = {"get", "get_raw", "export", "unset", "is_set", "gate"}


def _registered() -> set[str]:
    from .. import gates
    return set(gates.GATES)


def _is_environ(node: ast.AST) -> bool:
    d = dotted(node)
    return d is not None and (d == "environ" or d.endswith(".environ"))


def _environs(ctx) -> list:
    """The module's environ accesses, memoized on the ModuleCtx —
    both gate rules share one walk per file."""
    cached = getattr(ctx, "_gate_environs", None)
    if cached is None:
        cached = list(_environ_accesses(ctx.tree))
        ctx._gate_environs = cached
    return cached


def _environ_accesses(tree: ast.AST) -> Iterator[tuple[ast.AST, str | None]]:
    """(node, gate-name literal) for every environ read/write/del whose
    key is a string constant (dynamic keys can't be resolved
    statically and are out of scope)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            d = dotted(node.func)
            if d and (d == "getenv" or d.endswith(".getenv")):
                yield node, const_str(node.args[0]) if node.args else None
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("get", "pop", "setdefault")
                  and _is_environ(node.func.value)):
                yield node, const_str(node.args[0]) if node.args else None
        elif isinstance(node, ast.Subscript) and _is_environ(node.value):
            yield node, const_str(node.slice)
        elif isinstance(node, ast.Compare) and len(node.comparators) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and _is_environ(node.comparators[0]):
            yield node, const_str(node.left)


class RawGateAccess(ModuleRule):
    id = "JT-GATE-001"
    doc = ("raw os.environ/os.getenv access of a JEPSEN_TPU_* name "
           "outside the gates registry")
    hint = ("read/write the gate through jepsen_tpu_torch.gates "
            "(gates.get/export/unset)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        if ctx.rel.endswith(_GATES_FILE):
            return
        for node, name in _environs(ctx):
            if name and name.startswith("JEPSEN_TPU_"):
                yield self.finding(
                    ctx, node,
                    f"raw environ access of gate {name!r}")


class UnregisteredGate(ModuleRule):
    id = "JT-GATE-002"
    doc = ("a JEPSEN_TPU_* name used in an env/gates access that is "
           "not declared in the gates registry (typo, or an "
           "undeclared gate)")
    hint = "declare it in jepsen_tpu_torch/gates.py (name, kind, default, doc)"

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        reg = _registered()
        seen: set[tuple[int, str]] = set()

        def emit(node, name):
            key = (getattr(node, "lineno", 1), name)
            if key not in seen:
                seen.add(key)
                yield self.finding(ctx, node,
                                   f"unregistered gate {name!r}")

        for node, name in _environs(ctx):
            if name and name.startswith("JEPSEN_TPU_") \
                    and name not in reg:
                yield from emit(node, name)
        # gates-accessor calls with an unregistered literal: these
        # raise KeyError at runtime — catch them before they ship.
        # Track how THIS module names the gates module (import aliases
        # like `gates as _gates`) and which accessors it imported bare
        # (`from ..gates import get`), so aliased reads aren't a blind
        # spot.
        aliases = {"gates"}
        bare: set[str] = set()
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.ImportFrom):
                mod = n.module or ""
                if mod == "gates" or mod.endswith(".gates"):
                    bare.update(a.asname or a.name for a in n.names
                                if a.name in _ACCESSORS)
                else:
                    aliases.update(a.asname or a.name for a in n.names
                                   if a.name == "gates")
            elif isinstance(n, ast.Import):
                for a in n.names:
                    if a.name == "gates" or a.name.endswith(".gates"):
                        aliases.add(a.asname or a.name.split(".")[0])
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = const_str(node.args[0]) if node.args else None
            if not (name and name.startswith("JEPSEN_TPU_")
                    and name not in reg):
                continue
            d = dotted(node.func)
            if d and "." in d:
                head, _, tail = d.rpartition(".")
                if tail in _ACCESSORS \
                        and aliases.intersection(head.split(".")):
                    yield from emit(node, name)
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in bare:
                yield from emit(node, name)


class ReadmeTableDrift(ProjectRule):
    id = "JT-GATE-003"
    doc = ("the committed README env-gate table must match the "
           "registry render exactly")
    hint = "regenerate: python -m jepsen_tpu_torch.lint --tables"

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        from .. import gates
        readme = ctx.root / "README.md"
        if not readme.is_file():
            return   # installed-package context: nothing to check
        text = readme.read_text(encoding="utf-8")
        if gates.TABLE_BEGIN not in text or gates.TABLE_END not in text:
            yield Finding(self.id, "README.md", 1,
                          "env-gate table markers missing "
                          f"({gates.TABLE_BEGIN!r})", self.hint)
            return
        start = text.index(gates.TABLE_BEGIN)
        end = text.index(gates.TABLE_END) + len(gates.TABLE_END)
        committed = text[start:end].strip()
        line = text[:start].count("\n") + 1
        if committed != gates.render_env_block().strip():
            yield Finding(self.id, "README.md", line,
                          "env-gate table drifted from the "
                          "gates registry", self.hint)


class GateTestCoverage(ProjectRule):
    id = "JT-GATE-004"
    doc = ("every registered gate must appear by name in the port's "
           "tests (tests/test_torch_*.py) — a gate without a test is "
           "unverified behavior")
    hint = "add a test exercising the gate under tests/test_torch_*.py"

    def check_project(self, ctx: ProjectCtx) -> Iterator[Finding]:
        from .. import gates
        tests = ctx.root / "tests"
        if not tests.is_dir():
            return
        # the port's gates are covered by the port's tests; lint
        # fixture files mention gate names to seed violations — they
        # are not coverage
        blob = "\n".join(
            p.read_text(encoding="utf-8", errors="replace")
            for p in sorted(tests.rglob("test_torch_*.py"))
            if "lint_fixtures" not in p.parts)
        for name in gates.GATES:
            # word-boundary match: JEPSEN_TPU_TRACE must not count as
            # covered just because JEPSEN_TPU_TRACE_MAX_EVENTS is
            if not re.search(re.escape(name) + r"(?![A-Z0-9_])", blob):
                yield Finding(self.id, "tests", 1,
                              f"gate {name} has no test coverage",
                              self.hint)


RULES = [RawGateAccess(), UnregisteredGate(), ReadmeTableDrift(),
         GateTestCoverage()]
