"""JT-ORD — path-sensitive happens-before prover for the serve
fleet's ordering protocol.

The multi-daemon verdict service is correct only because of
*ordering*: the journal append happens before the reply frame, the
epoch fence is read between a fold's dispatch and its journal write,
failover bumps the epoch on disk before STONITH before adoption, a
donated device slot is released on every exit path, admission closes
under its condition variable and before the draining flag becomes
observable. Until now those invariants lived in comments and smoke
tests. These rules prove them statically: each contract in
`contracts.ORDER_CONTRACTS` names a function, two (or three) marker
statements, and a path property, and the prover decides it on the
function's CFG (`cfg.py` — `finally` bodies routed on abnormal
exits, branch polarity recorded):

  * ``dominates``      — removal search from the entry: can the
    second marker be reached without passing the first? A singleton
    first-site is fast-pathed through the classic block-level
    `dominators` solve; the removal search is the decider.
  * ``postdominates``  — removal search from each first site toward
    `cfg.exit` (exception edges included), `post_dominators` as the
    fast path.
  * ``between`` / ``never-after`` — the same searches anchored at
    the first marker's sites.
  * ``under-lock``     — `compute_locksets` with a resolver that
    names ANY dotted with-item (`self._cv` included), then a
    MUST-held check at the marker.

A contract whose function or marker no longer matches anything is
itself a finding ("anchor vanished") — a rename cannot silently turn
a proof into a no-op. The mutation harness
(tests/test_order_prover.py) seeds one ordering bug per rule into a
copy of the real serve/fleet modules and pins exactly the expected
finding; the unmutated tree and the live repo are pinned clean.

Soundness notes: guard pruning (`OrderContract.guard`) skips the
false arm of ``if <guard>:`` only when the flag is assigned exactly
once in the function — otherwise the search stays fully
conservative. A statement matching both the kill and the target
marker counts as the kill (no false positive from unknowable
intra-statement order). Frames built outside a ``{op=...}`` marker's
dict literal stay unmatched on purpose: the marker names a specific
emission site.
"""

from __future__ import annotations

import ast
from collections import deque
from fnmatch import fnmatchcase
from typing import Iterator

from . import Finding, ModuleCtx, ModuleRule, dotted
from . import cfg as cfg_mod
from . import contracts

__all__ = ["RULES"]


# ---------------------------------------------------------------------------
# Markers
# ---------------------------------------------------------------------------

def _dotted_loose(node: ast.AST) -> str | None:
    """`a.b.c` with subscript links rendered `[]`: the callee of
    ``ent["journal"].record(...)`` is ``ent[].record``, so a glob can
    anchor on the method without caring which key was indexed."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted_loose(node.value)
        return None if base is None else f"{base}.{node.attr}"
    if isinstance(node, ast.Subscript):
        base = _dotted_loose(node.value)
        return None if base is None else f"{base}[]"
    return None


class _Marker:
    """One parsed ORDER_CONTRACTS marker (syntax in contracts.py)."""

    def __init__(self, spec: str):
        self.spec = spec
        self.op: str | None = None
        if spec.startswith("call:"):
            self.kind = "call"
            body = spec[len("call:"):]
            if body.endswith("}") and "{op=" in body:
                body, _, rest = body.rpartition("{op=")
                self.op = rest[:-1]
            self.glob = body
        elif spec.startswith("set:"):
            self.kind = "set"
            self.name = spec[len("set:"):]
        else:
            raise ValueError(f"bad ORDER_CONTRACTS marker {spec!r}")

    def matches(self, s: ast.stmt) -> bool:
        if self.kind == "set":
            if not isinstance(s, (ast.Assign, ast.AugAssign,
                                  ast.AnnAssign)):
                return False
            targets = s.targets if isinstance(s, ast.Assign) \
                else [s.target]
            for t in targets:
                nm = t.attr if isinstance(t, ast.Attribute) else (
                    t.id if isinstance(t, ast.Name) else None)
                if nm == self.name:
                    return True
            return False
        for h in _header_nodes(s):
            for n in ast.walk(h):
                if isinstance(n, ast.Call):
                    d = _dotted_loose(n.func)
                    if d is not None and fnmatchcase(d, self.glob) \
                            and (self.op is None
                                 or _has_op_literal(n, self.op)):
                        return True
        return False


def _header_nodes(s: ast.stmt) -> list[ast.AST]:
    """What a marker may match on: compound statements expose only
    their HEADER (the test/iter/with-items the block executes at that
    point) — their bodies are separate CFG instructions."""
    if isinstance(s, (ast.If, ast.While)):
        return [s.test]
    if isinstance(s, (ast.For, ast.AsyncFor)):
        return [s.target, s.iter]
    if isinstance(s, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in s.items]
    if isinstance(s, ast.Try):
        return []
    return [s]


def _has_op_literal(call: ast.Call, op: str) -> bool:
    for a in call.args:
        if isinstance(a, ast.Dict):
            for k, v in zip(a.keys, a.values):
                if isinstance(k, ast.Constant) and k.value == "op" \
                        and isinstance(v, ast.Constant) \
                        and v.value == op:
                    return True
    return False


# ---------------------------------------------------------------------------
# Per-function graphs (memoized on the ModuleCtx)
# ---------------------------------------------------------------------------

def _lock_of(expr: ast.AST) -> str | None:
    """Every dotted with-item is a lock id here — under-lock
    contracts name the attribute (`self._cv`) directly, and a
    non-lock context manager spelled as a call (`tr.span(...)`)
    renders None, so nothing is guessed."""
    return dotted(expr)


class _FuncGraph:
    def __init__(self, node: ast.AST):
        self.node = node
        self.cfg = cfg_mod.build_cfg(node, _lock_of)
        self._locksets: dict | None = None
        self._dom: dict | None = None
        self._pdom: dict | None = None
        self._assign_counts: dict[str, int] = {}

    def locksets(self) -> dict:
        if self._locksets is None:
            self._locksets = cfg_mod.compute_locksets(self.cfg)
        return self._locksets

    def dom(self) -> dict:
        if self._dom is None:
            self._dom = cfg_mod.dominators(self.cfg)
        return self._dom

    def pdom(self) -> dict:
        if self._pdom is None:
            self._pdom = cfg_mod.post_dominators(self.cfg)
        return self._pdom

    def prunable_guard(self, name: str) -> bool:
        """Pruning `if <name>:` false arms is sound only when the
        flag has exactly one assignment in the function (it cannot
        change between the guarded acquire and the guarded release)."""
        n = self._assign_counts.get(name)
        if n is None:
            n = 0
            for sub in ast.walk(self.node):
                if isinstance(sub, ast.Assign):
                    tgts = sub.targets
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                    tgts = [sub.target]
                elif isinstance(sub, (ast.For, ast.AsyncFor)):
                    tgts = [sub.target]
                else:
                    continue
                for t in tgts:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name) \
                                and leaf.id == name:
                            n += 1
            self._assign_counts[name] = n
        return n == 1

    def occurrences(self, m: _Marker) -> list[tuple[int, int]]:
        """(block id, instruction index) of every statement the
        marker matches — finally-copy duplicates included."""
        occ = []
        for b in self.cfg.blocks.values():
            for i, ins in enumerate(b.instrs):
                if ins[0] == "stmt" and m.matches(ins[1]):
                    occ.append((b.id, i))
        return occ


def _functions(ctx: ModuleCtx) -> dict[str, ast.AST]:
    funcs = getattr(ctx, "_order_funcs", None)
    if funcs is None:
        funcs = {q: node for q, _c, node in cfg_mod.iter_defs(ctx.tree)}
        ctx._order_funcs = funcs
    return funcs


def _graph(ctx: ModuleCtx, qual: str, node: ast.AST) -> _FuncGraph:
    cache = getattr(ctx, "_order_graphs", None)
    if cache is None:
        cache = {}
        ctx._order_graphs = cache
    g = cache.get(qual)
    if g is None:
        g = _FuncGraph(node)
        cache[qual] = g
    return g


# ---------------------------------------------------------------------------
# The path searches
# ---------------------------------------------------------------------------

def _succs(g: _FuncGraph, bid: int, guard: str) -> list[int]:
    b = g.cfg.blocks[bid]
    if guard and bid in g.cfg.branches and b.instrs:
        last = b.instrs[-1]
        if last[0] == "stmt" and isinstance(last[1], ast.If):
            t = last[1].test
            if isinstance(t, ast.Name) and t.id == guard \
                    and g.prunable_guard(guard):
                _then, els = g.cfg.branches[bid]
                return [s for s in b.succs if s != els]
    return list(b.succs)


def _scan(b, i0: int, kill: _Marker | None, hit: _Marker | None):
    """Walk a block's instructions from i0: ('hit', stmt) when the
    target marker is reached, ('kill', None) when the kill marker
    blocks the path first, ('fall', None) when the block runs off its
    end. A statement matching both counts as the kill."""
    for ins in b.instrs[i0:]:
        if ins[0] != "stmt":
            continue
        s = ins[1]
        if kill is not None and kill.matches(s):
            return ("kill", None)
        if hit is not None and hit.matches(s):
            return ("hit", s)
    return ("fall", None)


def _reach(g: _FuncGraph, starts: list[tuple[int, int]],
           kill: _Marker | None, hit: _Marker | None,
           guard: str = "", to_exit: bool = False):
    """The removal search: from the start positions, can a path reach
    a `hit` site (or `cfg.exit` when `to_exit`) without first passing
    a `kill` site? Returns the witnessing statement (or True for an
    exit reach), else None — None means the contract HOLDS."""
    q: deque[int] = deque()
    seen: set[int] = set()

    def expand(bid: int) -> None:
        for nb in _succs(g, bid, guard):
            if nb not in seen:
                seen.add(nb)
                q.append(nb)

    for bid, i0 in starts:
        st, s = _scan(g.cfg.blocks[bid], i0, kill, hit)
        if st == "hit":
            return s
        if st == "fall":
            expand(bid)
    while q:
        bid = q.popleft()
        if to_exit and bid == g.cfg.exit:
            return True
        st, s = _scan(g.cfg.blocks[bid], 0, kill, hit)
        if st == "hit":
            return s
        if st == "fall":
            expand(bid)
    return None


def _block_dominates(g: _FuncGraph, first: list[tuple[int, int]],
                     second: list[tuple[int, int]]) -> bool:
    """Block-level fast path: a SINGLE first site whose block
    dominates every second site (intra-block order checked when they
    share a block) proves the contract without the removal search.
    Only ever returns a positive proof — the removal search decides
    the rest."""
    blocks = {b for b, _i in first}
    if len(blocks) != 1:
        return False
    fb = next(iter(blocks))
    fi = min(i for b, i in first if b == fb)
    dom = g.dom()
    for sb, si in second:
        if fb not in dom[sb]:
            return False
        if sb == fb and si < fi:
            return False
    return True


def _block_postdominates(g: _FuncGraph, first: list[tuple[int, int]],
                         second: list[tuple[int, int]]) -> bool:
    blocks = {b for b, _i in second}
    if len(blocks) != 1:
        return False
    sb = next(iter(blocks))
    si = max(i for b, i in second if b == sb)
    pdom = g.pdom()
    for fb, fi in first:
        if sb not in pdom[fb]:
            return False
        if fb == sb and si < fi:
            return False
    return True


def _after(occ: list[tuple[int, int]]) -> list[tuple[int, int]]:
    return [(b, i + 1) for b, i in occ]


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

class OrderRule(ModuleRule):
    """One JT-ORD id = every ORDER_CONTRACTS entry carrying it. The
    registry names the file, so a rule only fires on its module (and
    on fixture copies laid out under the same relative path)."""

    def __init__(self, rid: str, doc: str, hint: str):
        self.id = rid
        self.doc = doc
        self.hint = hint

    def check(self, ctx: ModuleCtx) -> Iterator[Finding]:
        for c in contracts.ORDER_CONTRACTS:
            if c.rule != self.id or c.file != ctx.rel:
                continue
            yield from self._check(ctx, c)

    def _check(self, ctx: ModuleCtx,
               c: "contracts.OrderContract") -> Iterator[Finding]:
        fn = _functions(ctx).get(c.func)
        if fn is None:
            yield self.finding(
                ctx, 1,
                f"ORDER_CONTRACTS anchor vanished: function "
                f"{c.func!r} not found — re-anchor the {c.kind} "
                f"contract ({c.doc})")
            return
        g = _graph(ctx, c.func, fn)
        roles = [("first", c.first)]
        if c.mid:
            roles.append(("mid", c.mid))
        if c.second:
            roles.append(("second", c.second))
        occ: dict[str, tuple[_Marker, list]] = {}
        vanished = False
        for role, spec in roles:
            m = _Marker(spec)
            o = g.occurrences(m)
            if not o:
                vanished = True
                yield self.finding(
                    ctx, fn,
                    f"ORDER_CONTRACTS anchor vanished: {role} marker "
                    f"{spec!r} matches nothing in {c.func} — "
                    f"re-anchor the {c.kind} contract")
            occ[role] = (m, o)
        if vanished:
            return

        first_m, first_o = occ["first"]
        if c.kind == "dominates":
            second_m, second_o = occ["second"]
            if _block_dominates(g, first_o, second_o):
                return
            w = _reach(g, [(g.cfg.entry, 0)], first_m, second_m,
                       guard=c.guard)
            if w is not None:
                yield self.finding(
                    ctx, w,
                    f"{c.first!r} does not dominate {c.second!r} in "
                    f"{c.func}: a path reaches this {c.second} site "
                    f"without passing {c.first} — {c.doc}")
        elif c.kind == "postdominates":
            second_m, second_o = occ["second"]
            if _block_postdominates(g, first_o, second_o):
                return
            w = _reach(g, _after(first_o), second_m, None,
                       guard=c.guard, to_exit=True)
            if w is not None:
                yield self.finding(
                    ctx, fn,
                    f"{c.second!r} does not post-dominate "
                    f"{c.first!r} in {c.func}: an exit path leaves "
                    f"{c.first} without passing {c.second} — {c.doc}")
        elif c.kind == "between":
            mid_m, _mid_o = occ["mid"]
            second_m, _second_o = occ["second"]
            w = _reach(g, _after(first_o), mid_m, second_m,
                       guard=c.guard)
            if w is not None:
                yield self.finding(
                    ctx, w,
                    f"{c.mid!r} is not on every {c.first!r} → "
                    f"{c.second!r} path in {c.func}: this "
                    f"{c.second} site is reachable from {c.first} "
                    f"without passing {c.mid} — {c.doc}")
        elif c.kind == "never-after":
            second_m, _second_o = occ["second"]
            w = _reach(g, _after(first_o), None, second_m,
                       guard=c.guard)
            if w is not None:
                yield self.finding(
                    ctx, w,
                    f"{c.second!r} is reachable after {c.first!r} in "
                    f"{c.func} — {c.doc}")
        elif c.kind == "under-lock":
            locks = g.locksets()
            for b, i in first_o:
                s = g.cfg.blocks[b].instrs[i][1]
                held = locks.get(id(s), frozenset())
                if c.lock not in held:
                    yield self.finding(
                        ctx, s,
                        f"{c.first!r} executes without {c.lock!r} "
                        f"MUST-held in {c.func} (held: "
                        f"{sorted(held) or 'nothing'}) — {c.doc}")
        else:
            yield self.finding(
                ctx, fn,
                f"ORDER_CONTRACTS entry has unknown kind {c.kind!r}")


RULES = [
    OrderRule(
        "JT-ORD-001",
        doc=("journal-then-reply: in the daemon's verdict path the "
             "journal append dominates every reply-frame send — an "
             "ack can only name a verdict the journal already holds"),
        hint=("journal the verdict (or explicitly flag journaled: "
              "false on the frame) before any conn.send on the "
              "verdict path")),
    OrderRule(
        "JT-ORD-002",
        doc=("the zombie fence: the epoch-fence read lies between a "
             "fold's dispatch and its journal write on every path, "
             "and the fenced drain path never reaches the journal"),
        hint=("check self._fenced() after dispatch and before "
              "journaling; a fenced fold must drain and drop, never "
              "journal")),
    OrderRule(
        "JT-ORD-003",
        doc=("failover ordering: the epoch bump is durably published "
             "(temp+os.replace) before STONITH, STONITH before "
             "tenant adoption, and never STONITH after adoption"),
        hint=("keep _fail_over's fence → STONITH → adopt+resend "
              "sequence; the fence must hit disk first"),),
    OrderRule(
        "JT-ORD-004",
        doc=("no leaked device slot: DeviceSlots release "
             "post-dominates the donation acquire on every exit "
             "path, exception edges included"),
        hint=("release the donated slot in a finally (or on every "
              "raise path) so a checker crash cannot strand the "
              "slot")),
    OrderRule(
        "JT-ORD-005",
        doc=("drain close ordering: admission closes under its "
             "condition variable, and before the draining flag "
             "becomes observable to the scheduler"),
        hint=("mutate Admission state only under self._cv, and call "
              "admission.close() before _draining.set() in "
              "request_drain")),
]
