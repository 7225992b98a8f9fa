"""Per-function control-flow graphs with a lockset analysis (JT-LOCK's
engine).

`build_cfg(fn, lock_resolver)` lowers one function body to basic
blocks of pseudo-instructions — plain statements plus explicit
``enter``/``exit`` markers for every ``with``-acquired lock — and
`compute_locksets` runs a forward MUST-analysis over the graph
(IN = ∩ OUT over predecessors, so a lock only counts as held when it
is held on EVERY path). The result maps each statement to the set of
lock ids held when it executes; rules then ask "was the registry's
lock held at this write?" or "which locks were held at this call
site?" without re-deriving control flow.

Lock identity is the caller's business: `lock_resolver(expr)` returns
a stable id ("_MLOCK", "DeviceSlotLedger._lock") for a with-item that
is a lock, or None for ordinary context managers — the analysis never
guesses what is a lock. `with` is also the only acquisition form the
package sanctions (JT-THREAD-002 bans bare `.acquire()`), which is
what lets exceptional exits stay sound: Python releases with-held
locks on ANY exit, and every in-body statement the rules inspect is
lexically inside the with, where the must-set is exact.

The module also builds the module-local call graph (`call_graph`) the
lock-order analysis walks: qualified names resolved for bare local
functions and `self.method` calls — enough to see `f` holding lock A
call `g` that takes lock B two files of indirection away would need
whole-program resolution, but every inversion this repo has actually
shipped lived inside one module.

Beyond locksets, the graphs carry what a path-sensitive ordering
prover (JT-ORD) needs: `CFG.branches` records each lowered `if`'s
branch polarity (cond block → (then-start, else-start)) so a search
can prune one arm of a known guard, `return`/`raise`/`break`/
`continue` are routed THROUGH every enclosing `finally` body (lowered
as copies on the abnormal edge — `compute_locksets` intersects over
duplicate statement occurrences, so the must-sets stay sound), and
`dominators`/`post_dominators` solve the classic block-level dataflow
for "A on every path to B" / "B on every path from A" questions.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Iterator

__all__ = [
    "Block", "CFG", "build_cfg", "compute_locksets",
    "dominators", "post_dominators",
    "iter_defs", "call_graph", "resolve_call",
]

LockResolver = Callable[[ast.AST], "str | None"]


@dataclass
class Block:
    id: int
    #: ("stmt", node) | ("enter", lock_id, node) | ("exit", lock_id, node)
    instrs: list = field(default_factory=list)
    succs: set = field(default_factory=set)


class CFG:
    def __init__(self) -> None:
        self.blocks: dict[int, Block] = {}
        #: cond-block id → (then-start id, else-start id) for every
        #: lowered `if` (each `if` ends its block, so the key is
        #: unambiguous) — the branch polarity guard-aware searches need
        self.branches: dict[int, tuple[int, int]] = {}
        self.entry = self._new().id
        self.exit = self._new().id

    def _new(self) -> Block:
        b = Block(len(self.blocks))
        self.blocks[b.id] = b
        return b

    def edge(self, a: int, b: int) -> None:
        self.blocks[a].succs.add(b)


class _Assembler:
    def __init__(self, resolver: LockResolver):
        self.cfg = CFG()
        self.resolver = resolver
        self.cur = self.cfg._new()
        self.cfg.edge(self.cfg.entry, self.cur.id)
        self.loops: list[tuple[int, int]] = []   # (head, after)
        #: pending finally bodies: (finalbody, len(self.loops) at push)
        self.finallies: list[tuple[list, int]] = []

    def _start(self, *preds: int) -> Block:
        b = self.cfg._new()
        for p in preds:
            self.cfg.edge(p, b.id)
        return b

    def _terminated(self) -> bool:
        return self.cur is None

    def _unwind(self, stop: int) -> None:
        """An abnormal exit (`return`/`raise`/`break`/`continue`) runs
        every enclosing `finally` body down to stack index `stop`
        before leaving — lower COPIES of them (innermost first) into
        the current chain. Each copy is lowered with the stack
        truncated below itself, so a `return` INSIDE a finally body
        unwinds only the finallies outer to it."""
        saved = self.finallies
        try:
            for i in range(len(saved) - 1, stop - 1, -1):
                self.finallies = saved[:i]
                self.stmts(saved[i][0])
                if self._terminated():
                    # the finally body itself returned/raised/broke:
                    # it replaced this exit and already unwound the rest
                    return
        finally:
            self.finallies = saved

    def _loop_finallies(self) -> int:
        """The unwind stop for `break`/`continue`: only finallies
        pushed INSIDE the current loop (push depth >= current loop
        depth) run before the jump; outer ones stay pending."""
        stop = len(self.finallies)
        while stop and self.finallies[stop - 1][1] >= len(self.loops):
            stop -= 1
        return stop

    def stmts(self, body: list[ast.stmt]) -> None:
        for s in body:
            if self._terminated():
                # unreachable code still gets a block so lockset_of
                # answers for every statement
                self.cur = self.cfg._new()
            self.stmt(s)

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.If):
            self.cur.instrs.append(("stmt", s))
            cond = self.cur
            self.cur = self._start(cond.id)
            then_start = self.cur.id
            self.stmts(s.body)
            then_end = self.cur
            self.cur = self._start(cond.id)
            self.cfg.branches[cond.id] = (then_start, self.cur.id)
            self.stmts(s.orelse)
            else_end = self.cur
            join = self.cfg._new()
            for e in (then_end, else_end):
                if e is not None:
                    self.cfg.edge(e.id, join.id)
            self.cur = join
        elif isinstance(s, (ast.While, ast.For, ast.AsyncFor)):
            self.cur.instrs.append(("stmt", s))
            head = self._start(self.cur.id)
            after = self.cfg._new()
            self.cfg.edge(head.id, after.id)   # zero-trip / cond false
            self.loops.append((head.id, after.id))
            self.cur = self._start(head.id)
            self.stmts(s.body)
            if self.cur is not None:
                self.cfg.edge(self.cur.id, head.id)   # back edge
            self.loops.pop()
            if s.orelse:
                self.cur = self._start(after.id)
                self.stmts(s.orelse)
                if self.cur is not None:
                    after = self._start(self.cur.id)
                else:
                    after = self.cfg.blocks[self.cfg._new().id]
            self.cur = after
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            self.cur.instrs.append(("stmt", s))
            locks = []
            for item in s.items:
                lid = self.resolver(item.context_expr)
                if lid is not None:
                    locks.append(lid)
                    self.cur.instrs.append(("enter", lid, s))
            self.stmts(s.body)
            if self.cur is not None:
                for lid in reversed(locks):
                    self.cur.instrs.append(("exit", lid, s))
        elif isinstance(s, ast.Try):
            self.cur.instrs.append(("stmt", s))
            if s.finalbody:
                self.finallies.append((s.finalbody, len(self.loops)))
            entry = self.cur
            self.cur = self._start(entry.id)
            self.stmts(s.body)
            body_end = self.cur
            ends = [body_end] if body_end is not None else []
            for h in s.handlers:
                # conservatively reachable from the try entry (an
                # exception can fire before any body statement runs)
                self.cur = self._start(entry.id)
                if body_end is not None:
                    self.cfg.edge(body_end.id, self.cur.id)
                self.stmts(h.body)
                if self.cur is not None:
                    ends.append(self.cur)
            if s.orelse and body_end is not None:
                self.cur = self._start(body_end.id)
                self.stmts(s.orelse)
                ends = [e for e in ends if e is not body_end]
                if self.cur is not None:
                    ends.append(self.cur)
            join = self.cfg._new()
            for e in ends:
                self.cfg.edge(e.id, join.id)
            self.cur = join
            if s.finalbody:
                self.finallies.pop()
                self.stmts(s.finalbody)
        elif isinstance(s, (ast.Return, ast.Raise)):
            self.cur.instrs.append(("stmt", s))
            self._unwind(0)
            if self.cur is not None:
                self.cfg.edge(self.cur.id, self.cfg.exit)
            self.cur = None
        elif isinstance(s, ast.Break):
            self.cur.instrs.append(("stmt", s))
            self._unwind(self._loop_finallies())
            if self.cur is not None and self.loops:
                self.cfg.edge(self.cur.id, self.loops[-1][1])
            self.cur = None
        elif isinstance(s, ast.Continue):
            self.cur.instrs.append(("stmt", s))
            self._unwind(self._loop_finallies())
            if self.cur is not None and self.loops:
                self.cfg.edge(self.cur.id, self.loops[-1][0])
            self.cur = None
        else:
            # leaf statements — including nested def/class, whose
            # bodies are separate CFGs, not this one's statements
            self.cur.instrs.append(("stmt", s))


def build_cfg(fn: ast.AST, lock_resolver: LockResolver) -> CFG:
    """The CFG of one function body (or a Module treated as a body)."""
    b = _Assembler(lock_resolver)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    b.stmts([s for s in body
             if not isinstance(s, (ast.FunctionDef,
                                   ast.AsyncFunctionDef,
                                   ast.ClassDef))])
    if b.cur is not None:
        b.cfg.edge(b.cur.id, b.cfg.exit)
    return b.cfg


def compute_locksets(cfg: CFG) -> dict[int, frozenset[str]]:
    """id(statement node) → MUST-held lock set. Fixpoint of the
    forward analysis; unreachable blocks start from the empty set."""
    ALL = object()
    out: dict[int, object] = {i: ALL for i in cfg.blocks}
    out[cfg.entry] = frozenset()
    preds: dict[int, list[int]] = {i: [] for i in cfg.blocks}
    for b in cfg.blocks.values():
        for s in b.succs:
            preds[s].append(b.id)
    changed = True
    while changed:
        changed = False
        for bid, b in cfg.blocks.items():
            ins = [out[p] for p in preds[bid] if out[p] is not ALL]
            cur: frozenset[str] = \
                frozenset.intersection(*ins) if ins else frozenset()
            for ins_kind in b.instrs:
                if ins_kind[0] == "enter":
                    cur = cur | {ins_kind[1]}
                elif ins_kind[0] == "exit":
                    cur = cur - {ins_kind[1]}
            if out[bid] is ALL or out[bid] != cur:
                out[bid] = cur
                changed = True

    result: dict[int, frozenset[str]] = {}
    for bid, b in cfg.blocks.items():
        ins2 = [out[p] for p in preds[bid] if out[p] is not ALL]
        cur = frozenset.intersection(*ins2) if ins2 else frozenset()
        for kind in b.instrs:
            if kind[0] == "enter":
                cur = cur | {kind[1]}
            elif kind[0] == "exit":
                cur = cur - {kind[1]}
            else:
                node = kind[1]
                # the lockset when the statement executes: a with
                # statement's own node reports the set INSIDE it
                held = result.get(id(node))
                result[id(node)] = cur if held is None else (cur & held)
    # a with-statement node itself should report its body's set: the
    # enter instr is ("enter", lock_id, with_node)
    for bid, b in cfg.blocks.items():
        for kind in b.instrs:
            if kind[0] == "enter":
                node = kind[2]
                result[id(node)] = result.get(id(node),
                                              frozenset()) | {kind[1]}
    return result


def _dom_solve(ids: set, start: int,
               preds: dict) -> dict[int, frozenset[int]]:
    dom = {i: frozenset(ids) for i in ids}
    dom[start] = frozenset({start})
    changed = True
    while changed:
        changed = False
        for i in ids:
            if i == start:
                continue
            ins = [dom[p] for p in preds[i]]
            new = (frozenset.intersection(*ins)
                   if ins else frozenset(ids)) | {i}
            if new != dom[i]:
                dom[i] = new
                changed = True
    return dom


def dominators(cfg: CFG) -> dict[int, frozenset[int]]:
    """block id → blocks on EVERY entry→block path (reflexive).
    Blocks unreachable from entry report the full set — vacuously
    dominated, which is what path queries want."""
    preds: dict[int, list[int]] = {i: [] for i in cfg.blocks}
    for b in cfg.blocks.values():
        for s in b.succs:
            preds[s].append(b.id)
    return _dom_solve(set(cfg.blocks), cfg.entry, preds)


def post_dominators(cfg: CFG) -> dict[int, frozenset[int]]:
    """block id → blocks on EVERY block→exit path (reflexive): the
    dominance solve on the reversed graph, anchored at cfg.exit."""
    # reversed graph: the predecessors of i are i's forward successors
    preds = {i: list(b.succs) for i, b in cfg.blocks.items()}
    return _dom_solve(set(cfg.blocks), cfg.exit, preds)


# ---------------------------------------------------------------------------
# Module-local call graph
# ---------------------------------------------------------------------------

def iter_defs(tree: ast.Module) -> Iterator[tuple[str, str | None,
                                                  ast.AST]]:
    """(qualname, class name or None, node) for every function in the
    module, including methods and nested defs (qualname `outer.inner`)."""
    def walk(node: ast.AST, prefix: str, cls: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, cls, child
                yield from walk(child, q + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, child.name + ".", child.name)

    yield from walk(tree, "", None)


def resolve_call(call: ast.Call, *, cls: str | None,
                 local_fns: set[str],
                 methods: dict[str, set[str]],
                 enclosing: str = "") -> str | None:
    """The qualname a call resolves to within this module, or None:
    bare local function names, `ClassName(...)` → its `__init__`, and
    `self.method()` / `ClassName.method()` within the module. A call
    on any OTHER receiver stays unresolved on purpose — guessing an
    owner from a bare method name (`.close()`, `.get()`) would wire
    unrelated objects into the lock graph."""
    f = call.func
    if isinstance(f, ast.Name):
        if enclosing:
            nested = f"{enclosing}.{f.id}"
            if nested in local_fns:
                return nested
        if f.id in local_fns:
            return f.id
        if f.id in methods and "__init__" in methods[f.id]:
            return f"{f.id}.__init__"
        return None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.value.id == "self" and cls is not None \
                and f.attr in methods.get(cls, ()):
            return f"{cls}.{f.attr}"
        if f.value.id in methods and f.attr in methods[f.value.id]:
            return f"{f.value.id}.{f.attr}"
    return None


def call_graph(tree: ast.Module) -> dict[str, set[str]]:
    """qualname → set of locally-resolved callee qualnames."""
    defs = list(iter_defs(tree))
    local_fns = {q for q, _c, _n in defs}
    methods: dict[str, set[str]] = {}
    for q, c, _n in defs:
        if c is not None and q.startswith(c + "."):
            methods.setdefault(c, set()).add(q.split(".", 1)[1])
    out: dict[str, set[str]] = {}
    for q, c, node in defs:
        callees: set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                r = resolve_call(n, cls=c, local_fns=local_fns,
                                 methods=methods, enclosing=q)
                if r is not None and r != q:
                    callees.add(r)
        out[q] = callees
    return out
