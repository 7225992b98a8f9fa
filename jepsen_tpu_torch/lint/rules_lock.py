"""JT-LOCK — lockset + thread-spawn analysis of the sweep's thread
graph.

The async sweep is a small fixed thread graph — dispatcher, pack-h2d
producer, watchdog, health sampler, /metrics handlers — sharing a
handful of structures (the donated-slot ledger, the tracer's metric
cells, the health snapshot's seq). The two bug classes earlier
reviews of this code caught BY HAND were exactly lock-discipline drift: a
gauge published outside the lock that ordered its transitions, and a
snapshot writer that two threads could interleave. These rules run
`cfg.build_cfg` + `compute_locksets` (a MUST-hold forward analysis)
over every function and check three properties mechanically:

  JT-LOCK-001  lock-order inversion (A held while taking B and, on
               another path, B held while taking A — including
               through module-local calls) and re-entry of a
               non-reentrant Lock
  JT-LOCK-002  a write to registry-declared shared state
               (contracts.SHARED_STATE) with its guarding lock not
               held on every path
  JT-LOCK-003  a blocking call (sleep / subprocess / device wait /
               Future.result) while ANY lock is held — transitively
               through module-local calls — starving every waiter
  JT-LOCK-004  a Thread-target closure mutating state its spawner
               also mutates, with no thread-safe carrier between
               them (cross-thread mutation of thread-confined state)

Lock identity is construction-based: only names assigned from
`threading.Lock()`/`RLock()` (module globals or `self.<attr>` in
`__init__`/methods) participate, so semaphores, ledger slots and
condition variables never produce noise.
"""

from __future__ import annotations

import ast
from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, dotted
from . import cfg as cfglib
from . import contracts, dataflow

_LOCK_CTORS = {"Lock", "RLock"}

_MUTATORS = {"append", "extend", "insert", "add", "update",
             "setdefault", "pop", "popitem", "remove", "discard",
             "clear"}


class _ModuleLocks:
    """Every lock the module constructs, with stable ids."""

    def __init__(self, tree: ast.Module):
        self.module_locks: set[str] = set()
        self.rlocks: set[str] = set()
        self.class_locks: dict[str, set[str]] = {}
        for n in tree.body:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and self._ctor(n.value):
                name = n.targets[0].id
                self.module_locks.add(name)
                if self._ctor(n.value) == "RLock":
                    self.rlocks.add(name)
        for c in ast.walk(tree):
            if not isinstance(c, ast.ClassDef):
                continue
            for n in ast.walk(c):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Attribute) \
                        and isinstance(n.targets[0].value, ast.Name) \
                        and n.targets[0].value.id == "self" \
                        and self._ctor(n.value):
                    attr = n.targets[0].attr
                    self.class_locks.setdefault(c.name, set()).add(attr)
                    if self._ctor(n.value) == "RLock":
                        self.rlocks.add(f"{c.name}.{attr}")

    @staticmethod
    def _ctor(v: ast.AST) -> str | None:
        if isinstance(v, ast.Call):
            d = dotted(v.func)
            tail = d.split(".")[-1] if d else None
            if tail in _LOCK_CTORS:
                return tail
        return None

    def resolver(self, cls: str | None):
        def resolve(expr: ast.AST) -> str | None:
            if isinstance(expr, ast.Name) \
                    and expr.id in self.module_locks:
                return expr.id
            if isinstance(expr, ast.Attribute) \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self" and cls is not None \
                    and expr.attr in self.class_locks.get(cls, ()):
                return f"{cls}.{expr.attr}"
            return None
        return resolve


class _Analysis:
    """One pass shared by all JT-LOCK rules for a module: per-function
    CFGs + locksets, direct/transitive lock acquisitions, lock-order
    edges, and call sites annotated with the locks held."""

    def __init__(self, ctx: ModuleCtx):
        self.locks = _ModuleLocks(ctx.tree)
        self.defs = list(cfglib.iter_defs(ctx.tree))
        self.graph = cfglib.call_graph(ctx.tree)
        self.locksets: dict[str, dict[int, frozenset[str]]] = {}
        self.direct: dict[str, set[str]] = {}
        self.fn_of: dict[str, ast.AST] = {}
        self.cls_of: dict[str, str | None] = {}
        #: (held, acquired) -> every line the edge was observed at
        self.edges: dict[tuple[str, str], set[int]] = {}
        local_fns = {q for q, _c, _n in self.defs}
        methods: dict[str, set[str]] = {}
        for q, c, _n in self.defs:
            if c is not None and q.startswith(c + "."):
                methods.setdefault(c, set()).add(q.split(".", 1)[1])
        self.call_sites: dict[str, list] = {}
        for q, c, node in self.defs:
            self.fn_of[q] = node
            self.cls_of[q] = c
            res = self.locks.resolver(c)
            g = cfglib.build_cfg(node, res)
            ls = cfglib.compute_locksets(g)
            self.locksets[q] = ls
            acquired: set[str] = set()
            for b in g.blocks.values():
                for ins in b.instrs:
                    if ins[0] == "enter":
                        acquired.add(ins[1])
            self.direct[q] = acquired
            # nested-with acquisition edges from the exact LEXICAL
            # stack (not the CFG post-sets, which cannot distinguish a
            # re-entered lock from the genuinely-held outer instance:
            # `with _a:` inside `with _a:` must record an (a, a) edge)
            self._lexical_with_edges(node, res)
            # call sites with their NEAREST enclosing statement's
            # lockset: the own-nodes walk yields outer statements
            # before inner ones, so the most precise set wins
            site_map: dict[int, tuple[ast.Call, frozenset[str]]] = {}
            for n in cfglib_walk_own(node):
                if not isinstance(n, ast.stmt):
                    continue
                held = self._stmt_lockset(q, n)
                for call in _calls_of(n):
                    site_map[id(call)] = (call, held)
            sites = []
            for call, held in site_map.values():
                callee = cfglib.resolve_call(
                    call, cls=c, local_fns=local_fns,
                    methods=methods, enclosing=q)
                sites.append((call, callee, held))
            sites.sort(key=lambda s: s[0].lineno)
            self.call_sites[q] = sites
        # transitive acquisitions + call-graph lock edges, to fixpoint
        self.trans: dict[str, set[str]] = {
            q: set(v) for q, v in self.direct.items()}
        changed = True
        while changed:
            changed = False
            for q, callees in self.graph.items():
                for cal in callees:
                    extra = self.trans.get(cal, set()) - self.trans[q]
                    if extra:
                        self.trans[q] |= extra
                        changed = True
        for q, sites in self.call_sites.items():
            for call, callee, held in sites:
                if callee is None or not held:
                    continue
                for lid in self.trans.get(callee, ()):
                    for h in held:
                        self.edges.setdefault((h, lid),
                                              set()).add(call.lineno)

    def _lexical_with_edges(self, fn: ast.AST, res) -> None:
        """Record (held, acquired) edges from the exact lexical
        nesting of with statements, maintaining the held stack during
        the walk — this is what lets `with _a:` inside `with _a:`
        produce the (a, a) re-entry edge the CFG post-sets erase."""
        stack: list[str] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                own = 0
                for item in node.items:
                    lid = res(item.context_expr)
                    if lid is None:
                        continue
                    for h in stack:
                        self.edges.setdefault((h, lid),
                                              set()).add(node.lineno)
                    stack.append(lid)
                    own += 1
                for child in ast.iter_child_nodes(node):
                    visit(child)
                if own:
                    del stack[-own:]
                return
            for child in ast.iter_child_nodes(node):
                visit(child)

        for child in ast.iter_child_nodes(fn):
            visit(child)

    def _stmt_lockset(self, q: str, stmt: ast.AST) -> frozenset[str]:
        return self.locksets[q].get(id(stmt), frozenset())

    def stmt_locksets(self, q: str) -> Iterator[tuple[ast.stmt,
                                                      frozenset[str]]]:
        node = self.fn_of[q]
        for n in cfglib_walk_own(node):
            if isinstance(n, ast.stmt):
                yield n, self._stmt_lockset(q, n)


#: Walk a function's own body, not nested defs' (those are their own
#: analysis units) — the shared traversal from the dataflow module.
cfglib_walk_own = dataflow.own_nodes


def _calls_of(stmt: ast.AST) -> Iterator[ast.Call]:
    if isinstance(stmt, ast.stmt):
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                yield n


def _analysis(ctx: ModuleCtx) -> _Analysis:
    a = getattr(ctx, "_lock_analysis", None)
    if a is None:
        a = _Analysis(ctx)
        ctx._lock_analysis = a
    return a


class LockOrderInversion(ModuleRule):
    id = "JT-LOCK-001"
    doc = ("lock-order inversion (lock A held while acquiring B on "
           "one path, B while acquiring A on another — including "
           "through module-local calls), or a non-reentrant Lock "
           "re-acquired while held: both deadlock under the right "
           "interleaving")
    hint = ("pick one global order for the two locks (document it at "
            "the ctor) or collapse them into one; for re-entry, make "
            "the inner path lock-free and have callers hold the lock")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        a = _analysis(ctx)
        seen: set[frozenset[str]] = set()
        for (h, l2), lines in sorted(a.edges.items(),
                                     key=lambda kv: min(kv[1])):
            if h == l2:
                if l2 not in a.locks.rlocks:
                    # every re-entry site is its own deadlock
                    for line in sorted(lines):
                        yield self.finding(
                            ctx, line,
                            f"non-reentrant lock `{h}` may be "
                            "re-acquired while held (self-deadlock)")
                continue
            pair = frozenset((h, l2))
            if pair in seen:
                continue
            if (l2, h) in a.edges:
                seen.add(pair)
                other = min(a.edges[(l2, h)])
                yield self.finding(
                    ctx, min(lines),
                    f"lock-order inversion: `{h}` -> `{l2}` here, "
                    f"`{l2}` -> `{h}` at line {other}")


class UnguardedSharedWrite(ModuleRule):
    id = "JT-LOCK-002"
    doc = ("a write to registry-declared shared state "
           "(contracts.SHARED_STATE) without its guarding lock held "
           "on every path — the exact class earlier reviews of this "
           "code fixed by hand (ledger gauge, health snapshot seq)")
    hint = ("wrap the write in `with <declared lock>:` (__init__ is "
            "exempt — construction is single-threaded)")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        a = _analysis(ctx)
        decl: dict[str, list[tuple[str, str]]] = {}
        for cls, attr, lock in contracts.SHARED_STATE:
            decl.setdefault(cls, []).append((attr, lock))
        for q, c, _node in a.defs:
            if c is None or c not in decl:
                continue
            meth = q.split(".")[-1]
            if meth == "__init__":
                continue
            for stmt, held in a.stmt_locksets(q):
                if not isinstance(stmt, (ast.Assign, ast.AugAssign)):
                    continue
                targets = stmt.targets \
                    if isinstance(stmt, ast.Assign) else [stmt.target]
                for t in targets:
                    base = t
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if not (isinstance(base, ast.Attribute)
                            and isinstance(base.value, ast.Name)
                            and base.value.id == "self"):
                        continue
                    for attr, lock in decl[c]:
                        if base.attr != attr:
                            continue
                        want = f"{c}.{lock}" \
                            if lock in a.locks.class_locks.get(c, ()) \
                            else lock
                        if want not in held:
                            yield self.finding(
                                ctx, stmt,
                                f"`self.{attr}` ({c}) written without "
                                f"`{want}` held (declared in "
                                "contracts.SHARED_STATE)")


def _is_blocking(call: ast.Call) -> str | None:
    """The registry-declared blocking call this is, or None — driven
    entirely by contracts.BLOCKING_* so the declared surface and the
    checked surface cannot drift."""
    d = dotted(call.func)
    if d is None:
        return None
    if d in contracts.BLOCKING_EXACT:
        return d
    if d.startswith(contracts.BLOCKING_PREFIXES):
        return d
    if isinstance(call.func, ast.Attribute) \
            and d.split(".")[-1] in contracts.BLOCKING_METHOD_TAILS:
        return d
    return None


class BlockingCallUnderLock(ModuleRule):
    id = "JT-LOCK-003"
    doc = ("a blocking call (sleep, subprocess, device wait, "
           "Future.result) while a lock is held — directly or through "
           "module-local calls — every other thread touching that "
           "lock stalls for the duration")
    hint = ("move the blocking work outside the critical section "
            "(copy what you need under the lock, block after), or "
            "justify inline with `# jt-lint: ok JT-LOCK-003 (reason)`")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        a = _analysis(ctx)
        # which functions (transitively) perform a blocking call
        blocks_in: dict[str, str] = {}
        for q, _c, node in a.defs:
            for n in cfglib_walk_own(node):
                for call in _calls_of(n):
                    b = _is_blocking(call)
                    if b:
                        blocks_in.setdefault(q, b)
        trans_block: dict[str, str] = dict(blocks_in)
        changed = True
        while changed:
            changed = False
            for q, callees in a.graph.items():
                if q in trans_block:
                    continue
                for cal in callees:
                    if cal in trans_block:
                        trans_block[q] = f"{cal} -> {trans_block[cal]}"
                        changed = True
                        break
        for q, _c, node in a.defs:
            for call, callee, held in a.call_sites[q]:
                if not held:
                    continue
                b = _is_blocking(call)
                if b:
                    yield self.finding(
                        ctx, call,
                        f"blocking `{b}` while holding "
                        f"{sorted(held)}")
                elif callee in trans_block:
                    yield self.finding(
                        ctx, call,
                        f"call to `{callee}` (blocks via "
                        f"{trans_block[callee]}) while holding "
                        f"{sorted(held)}")


class CrossThreadMutation(ModuleRule):
    id = "JT-LOCK-004"
    doc = ("a Thread-target closure mutating state its spawning "
           "function also mutates, with no thread-safe carrier "
           "(Queue/Semaphore/Event/Lock) between them — "
           "thread-confined state crossed the thread boundary")
    hint = ("hand results across on a queue.Queue (the producer "
            "pattern in parallel/), or guard both sides with one "
            "lock")

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for parent in ast.walk(ctx.tree):
            if not isinstance(parent, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            nested = {n.name: n for n in parent.body
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
            if not nested:
                continue
            targets = []
            for n in cfglib_walk_own(parent):
                if isinstance(n, ast.Call):
                    d = dotted(n.func)
                    if d and d.split(".")[-1] == "Thread":
                        for kw in n.keywords:
                            if kw.arg == "target" \
                                    and isinstance(kw.value, ast.Name) \
                                    and kw.value.id in nested:
                                targets.append(nested[kw.value.id])
            if not targets:
                continue
            safe = set()
            for n in cfglib_walk_own(parent):
                if isinstance(n, ast.Assign) \
                        and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and isinstance(n.value, ast.Call):
                    d = dotted(n.value.func)
                    if d and d.split(".")[-1] in \
                            contracts.THREADSAFE_CTORS:
                        safe.add(n.targets[0].id)
            parent_mut = _mutations(parent, exclude=set(nested))
            for th in targets:
                th_mut = _mutations(th, exclude=set())
                shared = (th_mut & parent_mut) - safe
                if shared:
                    yield self.finding(
                        ctx, th,
                        f"thread target `{th.name}` and its spawner "
                        f"both mutate {sorted(shared)} with no "
                        "thread-safe carrier")


def _mutations(fn: ast.AST, exclude: set[str]) -> set[str]:
    """Names a scope mutates in ways visible across threads: container
    method calls, subscript stores, and writes to `nonlocal`s. Plain
    rebinding is NOT a mutation (it creates a local)."""
    out: set[str] = set()
    nonlocals: set[str] = set()

    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)) \
                    and child.name in exclude:
                continue
            yield child
            yield from walk(child)

    for n in walk(fn):
        if isinstance(n, ast.Nonlocal):
            nonlocals.update(n.names)
        elif isinstance(n, ast.Call) \
                and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _MUTATORS \
                and isinstance(n.func.value, ast.Name):
            out.add(n.func.value.id)
        elif isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) \
                else [n.target]
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name):
                    out.add(t.value.id)
                elif isinstance(t, ast.Name) and t.id in nonlocals:
                    out.add(t.id)
    return out


RULES = [LockOrderInversion(), UnguardedSharedWrite(),
         BlockingCallUnderLock(), CrossThreadMutation()]
